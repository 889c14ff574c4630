"""Relaxed MICCAI phase evaluation, shared with the JAX package:
``surgical_tpu/eval/relaxed.py`` imports only numpy, so the port uses it as
it is."""

from surgical_tpu.eval.relaxed import RelaxedResult, evaluate_video, evaluate_videos  # noqa: F401
