"""Typed data slots — the port's own copy of the framework-free
``paddle_tpu/data/input_types.py``: the ONE InputType + constructor set shared by the
``paddle.v2.data_type`` facade and the PyDataProvider2 ``@provider``
protocol (the reference's v2 data types ARE the provider input types:
python/paddle/v2/data_type.py re-exports trainer.PyDataProvider2)."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "InputType",
    "dense_vector",
    "dense_vector_sequence",
    "integer_value",
    "integer_value_sequence",
    "integer_value_sub_sequence",
    "dense_vector_sub_sequence",
    "sparse_binary_vector",
    "sparse_float_vector",
    "sparse_binary_vector_sequence",
    "sparse_float_vector_sequence",
]


@dataclass(frozen=True)
class InputType:
    dim: int
    seq: bool
    kind: str  # 'dense' | 'int' | 'sparse_binary' | 'sparse_float'

    @property
    def feeder_kind(self) -> str:
        if self.kind == "int_nested":
            return "ids_nested"
        if self.kind == "dense_nested":
            return "dense_nested"
        if self.kind == "int":
            return "ids_seq" if self.seq else "int"
        if self.kind == "sparse_binary":
            return "sparse_ids_seq" if self.seq else "sparse_ids"
        if self.kind == "sparse_float":
            return "sparse_pairs_seq" if self.seq else "sparse_pairs"
        return "dense_seq" if self.seq else "dense"


def dense_vector(dim: int) -> InputType:
    return InputType(dim, False, "dense")


def dense_vector_sequence(dim: int) -> InputType:
    return InputType(dim, True, "dense")


def integer_value(value_range: int) -> InputType:
    return InputType(value_range, False, "int")


def integer_value_sequence(value_range: int) -> InputType:
    return InputType(value_range, True, "int")


def integer_value_sub_sequence(value_range: int) -> InputType:
    """Nested sequence of ids (the reference's sub-sequence input type,
    PyDataProvider2 integer_value_sub_sequence)."""
    return InputType(value_range, True, "int_nested")


def dense_vector_sub_sequence(dim: int) -> InputType:
    return InputType(dim, True, "dense_nested")


def sparse_binary_vector(dim: int) -> InputType:
    """Rows are id lists; fed as padded COO (ids, nnz) — the
    reference's sparse_binary_vector bag-of-words input."""
    return InputType(dim, False, "sparse_binary")


def sparse_float_vector(dim: int) -> InputType:
    """Rows are (id, weight) pair lists; fed as padded COO
    (ids, weights, nnz)."""
    return InputType(dim, False, "sparse_float")


def sparse_binary_vector_sequence(dim: int) -> InputType:
    """Rows are sequences of id lists (one bag per timestep); fed as
    (ids [B,T,N], nnz [B,T], lengths [B]) — the reference's
    sparse_binary_vector_sequence (PyDataProvider2.py:75-145)."""
    return InputType(dim, True, "sparse_binary")


def sparse_float_vector_sequence(dim: int) -> InputType:
    """Rows are sequences of (id, weight) pair lists; fed as
    (ids [B,T,N], weights [B,T,N], nnz [B,T], lengths [B])."""
    return InputType(dim, True, "sparse_float")
