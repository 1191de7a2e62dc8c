"""``paddle.v2.data_type`` — counterpart of ``paddle_tpu/v2/data_type.py``:
the port's typed input slots under the reference's names."""

from paddle_tpu_torch.data.input_types import (  # noqa: F401
    InputType,
    dense_vector,
    dense_vector_sequence,
    dense_vector_sub_sequence,
    integer_value,
    integer_value_sequence,
    integer_value_sub_sequence,
    sparse_binary_vector,
    sparse_binary_vector_sequence,
    sparse_float_vector,
    sparse_float_vector_sequence,
)

__all__ = [
    "InputType",
    "dense_vector",
    "dense_vector_sequence",
    "integer_value",
    "integer_value_sequence",
    "integer_value_sub_sequence",
    "dense_vector_sub_sequence",
    "sparse_binary_vector",
    "sparse_binary_vector_sequence",
    "sparse_float_vector",
    "sparse_float_vector_sequence",
]
