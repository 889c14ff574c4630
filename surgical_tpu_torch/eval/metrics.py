"""Frame, phase and anticipation metrics, shared with the JAX package:
``surgical_tpu/eval/metrics.py`` imports only numpy, so the port uses it as
it is."""

from surgical_tpu.eval.metrics import (  # noqa: F401
    MAETriad,
    confusion_matrix,
    frame_accuracy,
    precision_recall_jaccard,
    video_accuracy,
)
