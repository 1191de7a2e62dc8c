"""The port's evaluators against the JAX package's on the same random
inputs (the cases of tests/test_evaluators.py): every evaluator and
printer of the reference's registry, through the host path
(``eval_batch``) and, for the additive ones, ``DeviceAccumulator``.
Results are counts or ratios of counts, so they are held exactly, except
``sum`` and ``column_sum``: float32 sums taken in another order, held at
rtol 1e-6 (measured on the CPU: 1.0e-8 for ``sum``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.evaluators as J

import paddle_tpu_torch.evaluators as E


def _inputs(seed):
    rs = np.random.RandomState(seed)
    B, T, C = 12, 7, 4
    lengths = rs.randint(1, T + 1, B).astype(np.int32)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float32)
    return {
        "logits": rs.randn(B, C).astype(np.float32),
        "labels": rs.randint(0, C, B),
        "seq_logits": rs.randn(B, T, C).astype(np.float32),
        "seq_labels": rs.randint(0, C, (B, T)),
        "mask": mask, "lengths": lengths,
        "prob": rs.rand(B).astype(np.float32),
        "prob2": rs.rand(B, 2).astype(np.float32),
        "bin": rs.randint(0, 2, B),
        "score": rs.randn(B).astype(np.float32),
        "qid": rs.randint(0, 3, B),
        "value": rs.randn(B, 5).astype(np.float32),
        "tags": rs.randint(0, 5, (B, T)), "tags2": rs.randint(0, 5, (B, T)),
        "log_probs": rs.randn(B, T, C).astype(np.float32),
        "ctc_labels": rs.randint(1, C, (B, 4)),
        "ctc_lens": rs.randint(1, 5, B),
    }


CASES = {
    "classification_error": (lambda m: m.ClassificationError(),
                             lambda x: dict(logits=x["logits"],
                                            labels=x["labels"])),
    "classification_error_masked": (
        lambda m: m.ClassificationError(),
        lambda x: dict(logits=x["seq_logits"], labels=x["seq_labels"],
                       mask=x["mask"])),
    "sum": (lambda m: m.SumEvaluator(), lambda x: dict(value=x["value"])),
    "column_sum": (lambda m: m.ColumnSumEvaluator(),
                   lambda x: dict(value=x["value"])),
    "auc": (lambda m: m.Auc(num_bins=64),
            lambda x: dict(prob=x["prob"], labels=x["bin"])),
    "auc_2col": (lambda m: m.Auc(), lambda x: dict(prob=x["prob2"],
                                                   labels=x["bin"])),
    "rankauc": (lambda m: m.RankAuc(),
                lambda x: dict(score=x["score"], labels=x["bin"])),
    "precision_recall": (lambda m: m.PrecisionRecall(num_classes=4),
                         lambda x: dict(logits=x["logits"],
                                        labels=x["labels"])),
    "precision_recall_pos": (
        lambda m: m.PrecisionRecall(num_classes=4, positive_label=2),
        lambda x: dict(logits=x["logits"], labels=x["labels"])),
    "pnpair": (lambda m: m.PnpairEvaluator(),
               lambda x: dict(score=x["score"], labels=x["bin"],
                              query_id=x["qid"])),
    "chunk": (lambda m: m.ChunkEvaluator(),
              lambda x: dict(pred_tags=x["tags"], label_tags=x["tags2"],
                             lengths=x["lengths"])),
    "ctc_edit_distance": (
        lambda m: m.CTCErrorEvaluator(),
        lambda x: dict(log_probs=x["log_probs"], labels=x["ctc_labels"],
                       in_lengths=x["lengths"],
                       label_lengths=x["ctc_lens"])),
    "seq_classification_error": (
        lambda m: m.SeqClassificationError(),
        lambda x: dict(logits=x["seq_logits"], labels=x["seq_labels"],
                       mask=x["mask"])),
    "value_printer": (lambda m: m.ValuePrinter(),
                      lambda x: dict(value=x["value"])),
    "gradient_printer": (lambda m: m.GradientPrinter(),
                         lambda x: dict(grad=x["value"])),
    "maxid_printer": (lambda m: m.MaxIdPrinter(),
                      lambda x: dict(logits=x["logits"])),
    "maxframe_printer": (lambda m: m.MaxFramePrinter(),
                         lambda x: dict(value=x["seq_logits"])),
    "classification_error_printer": (
        lambda m: m.EVALUATORS.get("classification_error_printer")(),
        lambda x: dict(logits=x["logits"], labels=x["labels"])),
}


def _run(module, case, batches, as_tensor):
    make, kw = CASES[case]
    ev = make(module)
    ev.start()
    for x in batches:
        args = kw(x)
        if as_tensor is not None:
            args = {k: as_tensor(v) for k, v in args.items()}
        ev.eval_batch(**args)
    return ev


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluator_matches_reference(case):
    batches = [_inputs(s) for s in range(3)]
    want = _run(J, case, batches, jnp.asarray)
    got = _run(E, case, batches, torch.as_tensor)
    if case in ("sum", "column_sum"):
        np.testing.assert_allclose(got.result(), want.result(), rtol=1e-6)
    else:
        assert got.result() == want.result()
    if hasattr(want, "lines"):
        assert got.lines == want.lines
    if case.startswith("precision_recall"):
        for k, v in want.detail().items():
            np.testing.assert_array_equal(got.detail()[k], v)


@pytest.mark.parametrize("case", [c for c in sorted(CASES)
                                  if CASES[c][0](E).additive])
def test_device_accumulator_matches_host_path_and_reference(case):
    batches = [_inputs(s) for s in range(4)]
    make, kw = CASES[case]
    acc = E.DeviceAccumulator(make(E))
    jacc = J.DeviceAccumulator(make(J))
    for x in batches:
        acc.add(**{k: torch.as_tensor(v) for k, v in kw(x).items()})
        jacc.add(**{k: jnp.asarray(v) for k, v in kw(x).items()})
    host = _run(E, case, batches, torch.as_tensor).result()
    np.testing.assert_allclose(acc.result(), host, rtol=1e-6)
    np.testing.assert_allclose(acc.result(), jacc.result(), rtol=1e-6)


def test_registry_and_additivity_match_reference():
    assert E.EVALUATORS.names() == J.EVALUATORS.names()
    for name in E.EVALUATORS.names():
        assert E.EVALUATORS.get(name).additive == \
            J.EVALUATORS.get(name).additive, name
    for ev in (E.PnpairEvaluator(), E.ValuePrinter()):
        with pytest.raises(ValueError):
            E.DeviceAccumulator(ev)


def test_seqtext_printer_maps_vocab_and_ragged_rows():
    ev = E.EVALUATORS.get("seqtext_printer")(vocab={0: "<s>", 1: "hi",
                                                    2: "yo"})
    ev.start()
    ev.update(ev.batch_stats(ids=torch.tensor([[0, 1, 2]])))
    ev.update(ev.batch_stats(ids=[[1], [2, 2]]))
    assert ev.lines == ["<s> hi yo", "hi", "yo yo"] and ev.result() == 3.0


def test_device_accumulator_keeps_totals_on_the_tensors_device():
    acc = E.DeviceAccumulator(E.ClassificationError())
    x = _inputs(0)
    acc.add(logits=torch.as_tensor(x["logits"]),
            labels=torch.as_tensor(x["labels"]))
    assert all(torch.is_tensor(v) for v in acc._acc.values())
    acc.reset()
    assert acc._acc is None and acc.result() == 0.0
