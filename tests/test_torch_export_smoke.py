"""chip_smoke.py's deployment-export phase on the CPU at the tiny preset
(64-px frames, B = 8 and 1, a 4-frame stream, one torch thread): the flax
and fused artifacts through ``cli export-serving``, each run in a fresh
process that imports torch and the loader (and ``kernels.ops`` for a fused
one) and no model code, equal to the eager graphs bit for bit; the
three-artifact stream equal to ``OnlineSession`` bit for bit. The card's
timings and launch counts are not taken here."""

import torch

import chip_smoke
from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig


def test_chip_smoke_export_phase_on_cpu(tmp_path):
    torch.set_num_threads(1)
    res = chip_smoke.phase_export(
        str(tmp_path), cfg=BackboneConfig.preset("tiny"),
        head_cfg=HeadConfig(embedding_dim=32, hidden=16), model_flags=["--variant", "tiny"],
        device="cpu", size=64, batch=8, frames=4)
    names = {"flax_b8", "flax_b1", "fused_b8", "fused_b1"}
    assert set(res["bytes"]) == set(res["load_s"]) == names
    assert res["launches"]["flax_b8"] is None and res["launches"]["fused_b8"] is not None
    assert res["ms"] == {} and "ms_per_frame" not in res["stream"]
