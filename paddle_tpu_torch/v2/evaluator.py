"""``paddle.v2.evaluator`` — counterpart of ``paddle_tpu/v2/evaluator.py``:
declare metrics against topology layers (the reference's
python/paddle/v2/evaluator.py makes one function per registered
evaluator: classification_error(input=, label=), auc(...), ...).

Each factory returns an ``(evaluator, wire)`` pair: the evaluator is the
metric of ``paddle_tpu_torch.evaluators`` and ``wire`` maps a batch's layer
outputs and feed to its ``batch_stats`` keywords, the pair that
``SGDTrainer.test(evaluators={ev: wire})`` takes:

    ev, wire = paddle.evaluator.classification_error(input=logits, label=lab)
    result = trainer.test(reader, evaluators={ev: wire})
"""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch import evaluators as _E
from paddle_tpu_torch.nn.graph import LayerOutput

__all__ = ["classification_error", "auc", "precision_recall", "rankauc",
           "sum", "column_sum", "chunk", "ctc_error"]


def _grab(layer: LayerOutput):
    name = layer.name

    def get(outs, feed):
        if name in outs:
            return outs[name]
        v = feed[name]
        if isinstance(v, tuple):  # sequence feeds are (values, lengths, ...)
            return v[0]
        return v

    return get


def classification_error(*, input: LayerOutput, label: LayerOutput):
    gi, gl = _grab(input), _grab(label)
    ev = _E.ClassificationError()
    return ev, lambda outs, feed: {"logits": gi(outs, feed),
                                   "labels": gl(outs, feed)}


def auc(*, input: LayerOutput, label: LayerOutput, num_bins: int = 4096):
    gi, gl = _grab(input), _grab(label)
    ev = _E.Auc(num_bins=num_bins)
    return ev, lambda outs, feed: {"prob": gi(outs, feed),
                                   "labels": gl(outs, feed)}


def precision_recall(*, input: LayerOutput, label: LayerOutput,
                     num_classes: int = 2,
                     positive_label: Optional[int] = None):
    gi, gl = _grab(input), _grab(label)
    ev = _E.PrecisionRecall(num_classes=num_classes,
                            positive_label=positive_label)
    return ev, lambda outs, feed: {"logits": gi(outs, feed),
                                   "labels": gl(outs, feed)}


def rankauc(*, input: LayerOutput, label: LayerOutput):
    gi, gl = _grab(input), _grab(label)
    ev = _E.RankAuc()
    return ev, lambda outs, feed: {"score": gi(outs, feed),
                                   "labels": gl(outs, feed)}


def sum(*, input: LayerOutput):  # noqa: A001 - reference uses this name
    gi = _grab(input)
    ev = _E.SumEvaluator()
    return ev, lambda outs, feed: {"value": gi(outs, feed)}


def column_sum(*, input: LayerOutput):
    gi = _grab(input)
    ev = _E.ColumnSumEvaluator()
    return ev, lambda outs, feed: {"value": gi(outs, feed)}


def chunk(*, input: LayerOutput, label: LayerOutput, lengths: LayerOutput):
    gi, gl, gn = _grab(input), _grab(label), _grab(lengths)
    ev = _E.ChunkEvaluator()
    return ev, lambda outs, feed: {"pred_tags": gi(outs, feed),
                                   "label_tags": gl(outs, feed),
                                   "lengths": gn(outs, feed)}


def ctc_error(*, input: LayerOutput, label: LayerOutput,
              in_lengths: LayerOutput, label_lengths: LayerOutput,
              blank=None):
    """``blank`` defaults to ``input.size - 1``, matching ``nn.ctc_cost``'s
    ctc_layer convention (blank-last); pass 0 for warp-ctc models."""
    if blank is None:
        blank = input.size - 1
        if label.size > blank:  # same collision guard as nn.ctc_cost
            raise ValueError(
                f"ctc_error: label vocabulary ({label.size}) reaches the "
                f"defaulted blank index {blank} (= input.size - 1); size "
                f"the logits as num_classes + 1 or pass blank= explicitly "
                f"(0 for warp-ctc models)")
    gi, gl = _grab(input), _grab(label)
    gil, gll = _grab(in_lengths), _grab(label_lengths)
    ev = _E.CTCErrorEvaluator(blank=blank)
    return ev, lambda outs, feed: {"log_probs": gi(outs, feed),
                                   "labels": gl(outs, feed),
                                   "in_lengths": gil(outs, feed),
                                   "label_lengths": gll(outs, feed)}
