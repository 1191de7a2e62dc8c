"""``paddle_tpu_torch.evaluators`` — the evaluators and printers of the
reference's registry (``paddle_tpu/evaluators``), on torch tensors, and
``DeviceAccumulator``."""

from paddle_tpu_torch.evaluators.evaluators import (
    EVALUATORS, Auc, ChunkEvaluator, ClassificationError,
    ClassificationErrorPrinter, ColumnSumEvaluator, CTCErrorEvaluator,
    DeviceAccumulator, Evaluator, GradientPrinter, MaxFramePrinter,
    MaxIdPrinter, PnpairEvaluator, PrecisionRecall, RankAuc,
    SeqClassificationError, SeqTextPrinter, SumEvaluator, ValuePrinter)

__all__ = ["EVALUATORS", "Evaluator", "DeviceAccumulator",
           "ClassificationError", "SumEvaluator", "ColumnSumEvaluator", "Auc",
           "RankAuc", "PrecisionRecall", "PnpairEvaluator", "ChunkEvaluator",
           "CTCErrorEvaluator", "SeqClassificationError", "ValuePrinter",
           "GradientPrinter", "MaxIdPrinter", "MaxFramePrinter",
           "SeqTextPrinter", "ClassificationErrorPrinter"]
