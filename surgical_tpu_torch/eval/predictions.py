"""Prediction artifact IO — format-compatible with the reference pipeline.

Writes/reads the ``video<NN>-phase.txt`` files consumed by the relaxed
evaluator: one row per 1-fps frame, ``<frame_index*fps>\\t<phase>\\t``
(trans_SV_output.py:304-321 writes a trailing tab before the newline; the
reader accepts both). The port's own copy of
``surgical_tpu/eval/predictions.py``.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def write_phase_txt(path: str, preds: Sequence[int], fps: int = 25) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i, p in enumerate(preds):
            f.write(f"{i * fps}\t{int(p)}\t\n")


def read_phase_txt(path: str) -> np.ndarray:
    """Reads either GT or prediction files (eval_and_vis.py:165-176)."""
    labels = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t")
            labels.append(int(parts[1]) if len(parts) >= 2 else int(parts[0]))
    return np.asarray(labels)


def video_txt_name(video_id: int) -> str:
    return f"video{video_id:02d}-phase.txt"
