"""``video<NN>-phase.txt`` writer and reader, shared with the JAX package:
``surgical_tpu/eval/predictions.py`` imports only numpy, so the port uses it
as it is."""

from surgical_tpu.eval.predictions import (  # noqa: F401
    read_phase_txt,
    video_txt_name,
    write_phase_txt,
)
