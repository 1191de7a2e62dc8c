"""``paddle.v2`` facade of the port — counterpart of ``paddle_tpu/v2``.

The reference's user API is ``import paddle.v2 as paddle``:
``paddle.init(...)``, typed data layers (``paddle.data_type``), activation
objects (``paddle.activation.Softmax()``), ``paddle.layer.*``,
``paddle.parameters.create(cost)``, ``paddle.trainer.SGD(cost, parameters,
update_equation)``, ``paddle.infer``, ``paddle.batch``/``paddle.reader``,
``paddle.dataset``, ``paddle.event`` (python/paddle/v2/: trainer.py:30-175,
parameters.py:192-285, inference.py, reader/, dataset/).  This package
gives them over the port, so a reference user's script runs with its
import changed:

    import paddle_tpu_torch.v2 as paddle

    paddle.init()                      # or paddle.init(["--device=cpu"])
    images = paddle.layer.data("pixel", paddle.data_type.dense_vector(784))
    label = paddle.layer.data("label", paddle.data_type.integer_value(10))
    out = paddle.layer.fc(images, size=10, act=paddle.activation.Softmax())
    cost = paddle.layer.classification_cost(input=out, label=label)
    parameters = paddle.parameters.create(cost)
    opt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9)
    trainer = paddle.trainer.SGD(cost=cost, parameters=parameters,
                                 update_equation=opt)
    trainer.train(paddle.batch(reader, 64), num_passes=5,
                  event_handler=handler)

``parameters.create``, ``trainer.SGD`` and ``infer`` run on
``FLAGS.device``: the card (``cuda``, the default) unless ``init`` was given
``--device=cpu``.
"""

from paddle_tpu_torch.utils.devices import init  # noqa: F401
from paddle_tpu_torch.v2 import activation, attr, data_type, pooling  # noqa: F401
from paddle_tpu_torch.v2 import dataset, event, evaluator, layer, networks, optimizer  # noqa: F401
from paddle_tpu_torch.v2 import parameters, trainer  # noqa: F401
from paddle_tpu_torch.v2 import data_feeder, minibatch, plot, reader, topology  # noqa: F401
from paddle_tpu_torch.v2.inference import infer  # noqa: F401
from paddle_tpu_torch.data.reader import batch  # noqa: F401

__all__ = [
    "init", "activation", "attr", "data_type", "pooling", "dataset",
    "event", "layer", "optimizer", "parameters", "trainer", "infer",
    "batch", "reader",
]
