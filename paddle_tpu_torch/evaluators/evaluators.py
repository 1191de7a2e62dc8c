"""Evaluators — counterpart of ``paddle_tpu/evaluators/evaluators.py``.

Reference: the registered evaluator types accumulated across batches and
printed per pass (paddle/gserver/evaluators/Evaluator.cpp:995-1046 —
classification_error :46, sum :503, column_sum :584, rankauc, auc :862,
precision_recall, pnpair; ChunkEvaluator.cpp; CTCErrorEvaluator.cpp; the
printer evaluators) driven by Evaluator::start/eval/finish.

Each evaluator's per-batch statistic, ``batch_stats(**kw) -> dict of
tensors``, is torch ops on the tensors it is given (numpy inputs are
taken as CPU tensors), so it runs where the model's outputs are; the
accumulation across batches is a small host-side state machine
(``update(stats)`` / ``result()``).  ``DeviceAccumulator`` keeps an
additive evaluator's running totals on the device and reads them back
once, at ``result()``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.utils.registry import Registry

__all__ = ["EVALUATORS", "Evaluator", "DeviceAccumulator",
           "ClassificationError", "SumEvaluator", "ColumnSumEvaluator", "Auc",
           "RankAuc", "PrecisionRecall", "PnpairEvaluator", "ChunkEvaluator",
           "CTCErrorEvaluator", "SeqClassificationError", "ValuePrinter",
           "GradientPrinter", "MaxIdPrinter", "MaxFramePrinter",
           "SeqTextPrinter", "ClassificationErrorPrinter"]

EVALUATORS: Registry = Registry("evaluator")


def _t(x) -> torch.Tensor:
    """A tensor as given, anything else as a CPU tensor."""
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


class Evaluator:
    name = "evaluator"
    #: True when ``batch_stats`` dicts combine across batches by
    #: elementwise sum — enables ``DeviceAccumulator``.  Printers and
    #: row-collecting evaluators (pnpair) override to False.
    additive = True

    def start(self) -> None:
        raise NotImplementedError

    def batch_stats(self, **kw) -> Dict[str, Any]:
        """Per-batch statistic(s), as tensors where the inputs are."""
        raise NotImplementedError

    def update(self, stats: Dict[str, Any]) -> None:
        raise NotImplementedError

    def result(self) -> float:
        raise NotImplementedError

    def eval_batch(self, **kw) -> None:
        """One batch through the host path: its stats read back now."""
        self.update({k: _np(v) for k, v in self.batch_stats(**kw).items()})


@EVALUATORS.register("classification_error")
class ClassificationError(Evaluator):
    """Top-1 error rate (Evaluator.cpp ClassificationErrorEvaluator)."""

    name = "classification_error"

    def start(self):
        self.err, self.total = 0.0, 0.0

    def batch_stats(self, *, logits, labels, mask=None):
        pred = torch.argmax(_t(logits), dim=-1)
        labels = _t(labels).to(pred.device).reshape(pred.shape)
        wrong = (pred != labels).to(torch.float32)
        if mask is not None:
            mask = _t(mask).to(pred.device)
            wrong = wrong * mask
            return {"err": wrong.sum(), "total": mask.sum()}
        return {"err": wrong.sum(), "total": _f32(float(pred.numel()), pred)}

    def update(self, s):
        self.err += float(s["err"])
        self.total += float(s["total"])

    def result(self):
        return self.err / max(self.total, 1.0)


@EVALUATORS.register("sum")
class SumEvaluator(Evaluator):
    name = "sum"

    def start(self):
        self.sum, self.n = 0.0, 0

    def batch_stats(self, *, value, mask=None):
        value = _t(value)
        if mask is not None:
            value = value * _t(mask).to(value.device)
        return {"sum": value.sum()}

    def update(self, s):
        self.sum += float(s["sum"])
        self.n += 1

    def result(self):
        return self.sum


@EVALUATORS.register("column_sum")
class ColumnSumEvaluator(Evaluator):
    name = "column_sum"

    def start(self):
        self.sum = None
        self.total = 0.0

    def batch_stats(self, *, value):
        value = _t(value)
        return {"col": value.sum(dim=0),
                "n": _f32(float(value.shape[0]), value)}

    def update(self, s):
        col = _np(s["col"])
        self.sum = col if self.sum is None else self.sum + col
        self.total += float(s["n"])

    def result(self):
        if self.sum is None:
            return 0.0
        return float(np.mean(self.sum / max(self.total, 1.0)))


@EVALUATORS.register("auc")
class Auc(Evaluator):
    """ROC AUC via fixed binning (AucEvaluator bins scores to stay
    streaming, Evaluator.cpp:862)."""

    name = "auc"

    def __init__(self, num_bins: int = 4096):
        self.num_bins = num_bins

    def start(self):
        self.pos = np.zeros(self.num_bins)
        self.neg = np.zeros(self.num_bins)

    def batch_stats(self, *, prob, labels):
        """prob: [B] or [B,2] (positive-class prob); labels: [B] in
        {0,1}."""
        prob = _t(prob)
        if prob.ndim == 2:
            prob = prob[:, -1]
        lab = _t(labels).to(prob.device).reshape(prob.shape).to(
            torch.float32)
        idx = torch.clamp((prob * self.num_bins).to(torch.int32), 0,
                          self.num_bins - 1)
        zeros = torch.zeros(self.num_bins, dtype=torch.float32,
                            device=prob.device)
        return {"pos": zeros.index_add(0, idx, lab),
                "neg": zeros.index_add(0, idx, 1.0 - lab)}

    def update(self, s):
        self.pos += _np(s["pos"])
        self.neg += _np(s["neg"])

    def result(self):
        # sum over bins high->low of TPR/FPR trapezoid
        tp = np.cumsum(self.pos[::-1])
        fp = np.cumsum(self.neg[::-1])
        P, N = tp[-1], fp[-1]
        if P == 0 or N == 0:
            return 0.5
        tpr = np.concatenate([[0.0], tp / P])
        fpr = np.concatenate([[0.0], fp / N])
        return float(np.trapezoid(tpr, fpr))


@EVALUATORS.register("rankauc")
class RankAuc(Evaluator):
    """Pairwise ranking AUC on (score, label) lists (RankAucEvaluator)."""

    name = "rankauc"

    def start(self):
        self.concordant, self.pairs = 0.0, 0.0

    def batch_stats(self, *, score, labels):
        s = _t(score).reshape(-1)
        y = _t(labels).to(s.device).reshape(-1).to(torch.float32)
        ds = s[:, None] - s[None, :]
        dy = y[:, None] - y[None, :]
        valid = dy > 0
        conc = ((ds > 0) & valid).to(torch.float32).sum()
        ties = 0.5 * ((ds == 0) & valid).to(torch.float32).sum()
        return {"conc": conc + ties,
                "pairs": valid.to(torch.float32).sum()}

    def update(self, st):
        self.concordant += float(st["conc"])
        self.pairs += float(st["pairs"])

    def result(self):
        return self.concordant / max(self.pairs, 1.0)


@EVALUATORS.register("precision_recall")
class PrecisionRecall(Evaluator):
    """Per-class precision/recall/F1 (PrecisionRecallEvaluator)."""

    name = "precision_recall"

    def __init__(self, num_classes: int = 2,
                 positive_label: Optional[int] = None):
        self.num_classes = num_classes
        self.positive_label = positive_label

    def start(self):
        self.tp = np.zeros(self.num_classes)
        self.fp = np.zeros(self.num_classes)
        self.fn = np.zeros(self.num_classes)

    def batch_stats(self, *, logits, labels):
        pred = torch.argmax(_t(logits), dim=-1).reshape(-1)
        lab = _t(labels).to(pred.device).reshape(-1).long()
        eye = torch.eye(self.num_classes, dtype=torch.float32,
                        device=pred.device)
        oh_p, oh_l = eye[pred], eye[lab]
        tp = (oh_p * oh_l).sum(0)
        return {"tp": tp, "fp": oh_p.sum(0) - tp, "fn": oh_l.sum(0) - tp}

    def update(self, s):
        self.tp += _np(s["tp"])
        self.fp += _np(s["fp"])
        self.fn += _np(s["fn"])

    def result(self):
        prec = self.tp / np.maximum(self.tp + self.fp, 1.0)
        rec = self.tp / np.maximum(self.tp + self.fn, 1.0)
        f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-12)
        if self.positive_label is not None:
            return float(f1[self.positive_label])
        return float(np.mean(f1))

    def detail(self):
        prec = self.tp / np.maximum(self.tp + self.fp, 1.0)
        rec = self.tp / np.maximum(self.tp + self.fn, 1.0)
        return {"precision": prec, "recall": rec}


@EVALUATORS.register("pnpair")
class PnpairEvaluator(Evaluator):
    """Positive/negative pair ratio grouped by query (PnpairEvaluator):
    for each query id, counts concordant score pairs between pos & neg."""

    name = "pnpair"
    additive = False  # collects raw rows; pairs need the full pass

    def start(self):
        self.rows: List[np.ndarray] = []

    def batch_stats(self, *, score, labels, query_id):
        return {"score": _t(score).reshape(-1),
                "labels": _t(labels).reshape(-1),
                "qid": _t(query_id).reshape(-1)}

    def update(self, s):
        self.rows.append(np.stack([
            _np(s["score"]).astype(np.float64),
            _np(s["labels"]).astype(np.float64),
            _np(s["qid"]).astype(np.float64),
        ], 1))

    def result(self):
        if not self.rows:
            return 0.0
        data = np.concatenate(self.rows, 0)
        better = worse = ties = 0.0
        for q in np.unique(data[:, 2]):
            rows = data[data[:, 2] == q]
            for i in range(len(rows)):
                for j in range(len(rows)):
                    if rows[i, 1] > rows[j, 1]:
                        if rows[i, 0] > rows[j, 0]:
                            better += 1
                        elif rows[i, 0] < rows[j, 0]:
                            worse += 1
                        else:
                            ties += 1
        return (better + 0.5 * ties) / max(better + worse + ties, 1.0)


@EVALUATORS.register("seq_classification_error")
class SeqClassificationError(ClassificationError):
    """Sequence-level error: a sequence counts wrong if ANY token is wrong
    (SequenceClassificationErrorEvaluator)."""

    name = "seq_classification_error"

    def batch_stats(self, *, logits, labels, mask):
        pred = torch.argmax(_t(logits), dim=-1)
        wrong_tok = ((pred != _t(labels).to(pred.device)).to(torch.float32)
                     * _t(mask).to(pred.device))
        seq_wrong = (wrong_tok.sum(dim=1) > 0).to(torch.float32)
        return {"err": seq_wrong.sum(),
                "total": _f32(float(pred.shape[0]), pred)}


def _extract_chunks(tags: np.ndarray, scheme: str = "IOB") -> set:
    """Decode chunk spans from an IOB tag sequence: tag 2k = B-type k,
    2k+1 = I-type k, last id = O (the ChunkEvaluator convention)."""
    chunks = set()
    O = int(max(tags.max(initial=0), 0))
    start = ctype = None
    for i, t in enumerate(tags):
        t = int(t)
        if t == O or t < 0:
            if start is not None:
                chunks.add((start, i - 1, ctype))
                start = ctype = None
            continue
        typ, is_inside = t // 2, (t % 2 == 1)
        if not is_inside:  # B- tag
            if start is not None:
                chunks.add((start, i - 1, ctype))
            start, ctype = i, typ
        else:  # I- tag
            if start is None or ctype != typ:
                if start is not None:
                    chunks.add((start, i - 1, ctype))
                start, ctype = i, typ
    if start is not None:
        chunks.add((start, len(tags) - 1, ctype))
    return chunks


@EVALUATORS.register("chunk")
class ChunkEvaluator(Evaluator):
    """Chunking F1 over IOB tag sequences (ChunkEvaluator.cpp), decoded on
    the host."""

    name = "chunk"
    additive = False  # raw tag rows, decoded per batch on host

    def start(self):
        self.correct = self.pred = self.label = 0.0

    def batch_stats(self, *, pred_tags, label_tags, lengths):
        return {"pred_tags": pred_tags, "label_tags": label_tags,
                "lengths": lengths}

    def update(self, s):
        preds = _np(s["pred_tags"])
        labs = _np(s["label_tags"])
        lens = _np(s["lengths"])
        for i in range(preds.shape[0]):
            L = int(lens[i])
            pc = _extract_chunks(preds[i, :L])
            lc = _extract_chunks(labs[i, :L])
            self.correct += len(pc & lc)
            self.pred += len(pc)
            self.label += len(lc)

    def result(self):
        p = self.correct / max(self.pred, 1.0)
        r = self.correct / max(self.label, 1.0)
        return 2 * p * r / max(p + r, 1e-12)


def _edit_distance(a, b) -> int:
    la, lb = len(a), len(b)
    dp = list(range(lb + 1))
    for i in range(1, la + 1):
        prev = dp[0]
        dp[0] = i
        for j in range(1, lb + 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1,
                        prev + (a[i - 1] != b[j - 1]))
            prev = cur
    return dp[lb]


@EVALUATORS.register("ctc_edit_distance")
class CTCErrorEvaluator(Evaluator):
    """Edit-distance error rate after CTC best-path collapse
    (CTCErrorEvaluator.cpp)."""

    name = "ctc_edit_distance"
    additive = False  # raw argmax paths, collapsed per batch on host

    def __init__(self, blank: int = 0):
        self.blank = blank

    def start(self):
        self.dist = self.total = 0.0

    def batch_stats(self, *, log_probs, labels, in_lengths, label_lengths):
        return {"path": torch.argmax(_t(log_probs), dim=-1),
                "labels": labels, "in_lengths": in_lengths,
                "label_lengths": label_lengths}

    def update(self, s):
        paths = _np(s["path"])
        labels = _np(s["labels"])
        in_lens = _np(s["in_lengths"])
        lab_lens = _np(s["label_lengths"])
        for i in range(paths.shape[0]):
            raw = paths[i, : int(in_lens[i])]
            collapsed = []
            prev = None
            for t in raw:
                if t != self.blank and t != prev:
                    collapsed.append(int(t))
                prev = t
            ref = [int(x) for x in labels[i, : int(lab_lens[i])]]
            self.dist += _edit_distance(collapsed, ref)
            self.total += max(len(ref), 1)

    def result(self):
        return self.dist / max(self.total, 1.0)


class _Printer(Evaluator):
    additive = False  # side-effecting: every batch is materialized

    def start(self):
        self.lines: List[str] = []

    def update(self, s):
        self.lines.append(str({k: _np(v) for k, v in s.items()}))

    def result(self):
        return float(len(self.lines))


@EVALUATORS.register("value_printer")
class ValuePrinter(_Printer):
    name = "value_printer"

    def batch_stats(self, *, value):
        return {"value": value}


@EVALUATORS.register("gradient_printer")
class GradientPrinter(_Printer):
    name = "gradient_printer"

    def batch_stats(self, *, grad):
        return {"grad": grad}


@EVALUATORS.register("maxid_printer")
class MaxIdPrinter(_Printer):
    name = "maxid_printer"

    def batch_stats(self, *, logits):
        # int32 ids, as the reference prints them
        return {"maxid": torch.argmax(_t(logits), dim=-1).to(torch.int32)}


@EVALUATORS.register("maxframe_printer")
class MaxFramePrinter(_Printer):
    name = "maxframe_printer"

    def batch_stats(self, *, value):
        norms = torch.linalg.vector_norm(_t(value).float(), dim=-1)
        return {"frame": torch.argmax(norms, dim=-1).to(torch.int32)}


@EVALUATORS.register("seqtext_printer")
class SeqTextPrinter(_Printer):
    """Prints decoded id sequences, optionally mapped through a vocabulary
    — the NMT-generation inspection evaluator (reference:
    trainer_config_helpers/evaluators.py seqtext_printer_evaluator:573)."""

    name = "seqtext_printer"

    def __init__(self, vocab=None, delimiter=" "):
        self.vocab = vocab
        self.delimiter = delimiter

    def batch_stats(self, *, ids):
        return {"ids": ids}

    def _rows(self, ids):
        """[.., L] arrays, ragged python lists and scalars as a list of
        flat id rows (generation output is naturally ragged)."""
        if isinstance(ids, (list, tuple)) and ids and isinstance(
                ids[0], (list, tuple, np.ndarray)):
            return [np.asarray(r).ravel() for r in ids]
        arr = _np(ids)
        if arr.ndim == 0:
            return [arr.reshape(1)]
        if arr.ndim == 1:
            return [arr]
        return list(arr.reshape(-1, arr.shape[-1]))

    def update(self, s):
        for row in self._rows(s["ids"]):
            toks = [str(int(t)) if self.vocab is None
                    else str(self.vocab[int(t)]) for t in row]
            self.lines.append(self.delimiter.join(toks))


@EVALUATORS.register("classification_error_printer")
class ClassificationErrorPrinter(_Printer):
    """Prints the per-sample classification error of each batch
    (reference: evaluators.py classification_error_printer_evaluator:663)."""

    name = "classification_error_printer"

    def batch_stats(self, *, logits, labels):
        pred = torch.argmax(_t(logits), dim=-1)
        lab = _t(labels).to(pred.device).reshape(pred.shape)
        return {"err": (pred != lab).to(torch.float32)}

    def update(self, s):
        self.lines.append(" ".join(f"{v:g}" for v in _np(s["err"]).ravel()))


# ---------------------------------------------------------------------------
# device-side accumulation
# ---------------------------------------------------------------------------


class DeviceAccumulator:
    """Accumulate an additive evaluator's batch stats on the device.

    ``add(**kw)`` computes the batch's stats where its tensors are and adds
    them to the running totals without reading anything back; only
    ``result()`` reads the totals, once.  The reference's evaluators
    accumulate in device memory the same way during GPU eval passes
    (paddle/gserver/evaluators/Evaluator.cpp:46-120)."""

    def __init__(self, evaluator: Evaluator):
        if not evaluator.additive:
            raise ValueError(
                f"evaluator {evaluator.name!r} is not additive; use "
                f"eval_batch")
        self.evaluator = evaluator
        self._acc: Optional[Dict[str, torch.Tensor]] = None

    @torch.no_grad()
    def add(self, **kw) -> None:
        s = self.evaluator.batch_stats(**kw)
        self._acc = (s if self._acc is None
                     else {k: self._acc[k] + s[k] for k in self._acc})

    def result(self) -> float:
        self.evaluator.start()
        if self._acc is not None:
            self.evaluator.update({k: _np(v) for k, v in self._acc.items()})
        return self.evaluator.result()

    def reset(self) -> None:
        self._acc = None
