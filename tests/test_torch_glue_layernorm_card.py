"""The glue LayerNorm kernel on the card: against its plain version at every
glue LayerNorm shape of MiT-b0 and MiT-b3 extraction (224 px, B = 200 and
B = 1) and at ragged row counts; the route over a whole extraction forward
and over a fused training step; a ``--fused`` serving artifact holding the
op. Every case is marked ``cuda`` and skips without a card; the file imports
no JAX:

    python -m pytest --noconftest tests/test_torch_glue_layernorm_card.py -m cuda

The bound, stated and derived in ``chip_smoke.glue_ln_gap``: one bf16 ulp
of each element plus 2^-16 of the terms that make it (on an H100, 1-31
elements per B = 200 shape past one ulp, where x - mean or the affine
cancels).
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import glue_ln_calls, glue_ln_gap, glue_layernorms
from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig
from surgical_tpu_torch.kernels import mit_block as mb
from surgical_tpu_torch.models import _ops
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.models.mit_train import fused_train_forward
from surgical_tpu_torch.serving.export import (export_feature_extractor, load_artifact,
                                               save_artifact)
from surgical_tpu_torch.train.backbone import freeze_trunk
from surgical_tpu_torch.train.extract import WireForward

VARIANTS = {"b0": BackboneConfig.preset("b0"), "b3": BackboneConfig()}
CASES = [(v, B, n, C) for v, cfg in VARIANTS.items() for B in (200, 1)
         for n, C in sorted(glue_ln_calls(cfg, B % 8 == 0))] + [
    ("ragged", 1, 12345, 320), ("ragged", 1, 7, 64), ("ragged", 1, 1001, 160),
    ("ragged", 1, 333, 40)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU build")


def _inputs(M, C, seed):
    """bf16 rows with their own offsets and spreads, fp32 affine near (1, 0)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, 1)) * 2 + rng.uniform(0.2, 3, (M, 1))
         * rng.standard_normal((M, C)))
    g = 1 + 0.2 * rng.standard_normal(C)
    b = 0.2 * rng.standard_normal(C)
    to = lambda a, dt: torch.from_numpy(a.astype(np.float32)).cuda().to(dt)
    return to(x, torch.bfloat16), to(g, torch.float32), to(b, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("variant, B, n, C", CASES)
def test_kernel_against_plain(variant, B, n, C):
    _needs_card()
    x, g, b = _inputs(B * n, C, seed=B * n + C)
    x = x.reshape(B, n, C)
    before = mb.glue_layer_norm.launches
    got = mb.glue_layer_norm(x, g, b)
    torch.cuda.synchronize()
    assert mb.glue_layer_norm.launches == before + 1
    want = mb.layer_norm(x, g, b)
    assert got.shape == x.shape and got.is_contiguous() and torch.isfinite(got.float()).all()
    beyond_ulp, beyond_bound, worst = glue_ln_gap(got, want, x, g, b)
    assert beyond_bound == 0, (beyond_ulp, worst)
    # the same input gives the same bits
    assert torch.equal(got, mb.glue_layer_norm(x, g, b))


@pytest.mark.cuda
def test_strided_rows_are_read_in_place_or_copied():
    """A row stride of a multiple of 8 (a slice of the last axis of a wider
    tensor) is read in place; another stride, and a last axis that is not
    contiguous, through a copy."""
    _needs_card()
    x, g, b = _inputs(3000, 128, seed=3)
    want = mb.glue_layer_norm(x, g, b)
    wide = torch.zeros(3000, 136, dtype=torch.bfloat16, device="cuda")
    wide[:, 8:] = x
    assert torch.equal(mb.glue_layer_norm(wide[:, 8:], g, b), want)
    odd = torch.zeros(3000, 133, dtype=torch.bfloat16, device="cuda")
    odd[:, 5:] = x
    assert torch.equal(mb.glue_layer_norm(odd[:, 5:], g, b), want)
    assert torch.equal(mb.glue_layer_norm(x.t().contiguous().t(), g, b), want)


def _model(variant, flow=True, seed=21):
    cfg = VARIANTS[variant]
    if not flow:
        cfg = dataclasses.replace(cfg, with_flow=False)
    return MiTEVP(cfg, HeadConfig(), seed=seed, device="cuda")


def _wire(B, size=224, seed=5, flow=True):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8),
           rng.integers(0, 256, (B, size, size, 1), dtype=np.uint8)]
    if flow:
        out.append((rng.standard_normal((B, size, size, 2)) * 2).astype(np.float16))
    return [torch.from_numpy(a).cuda() for a in out]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["b0", "b3"])
@pytest.mark.parametrize("B", [8, 6])
def test_extraction_forward_takes_the_kernel_for_every_glue_layernorm(variant, B):
    _needs_card()
    model = _model(variant)
    serve = WireForward(model, True)
    with torch.no_grad():
        serve(*_wire(B))  # builds the kernel library and the weights' cache
        before, launches = dict(_ops.LAYERNORM_ROUTES), mb.glue_layer_norm.launches
        serve(*_wire(B))
    n = glue_layernorms(model.cfg, B % 8 == 0)
    assert {k: _ops.LAYERNORM_ROUTES[k] - before[k] for k in before} == {"kernel": n,
                                                                          "plain": 0}
    assert mb.glue_layer_norm.launches - launches == n


@pytest.mark.cuda
def test_fused_training_step_keeps_its_autograd_layernorms_plain():
    """Under grad with a frozen trunk every LayerNorm whose input needs a
    gradient (all after the prompts first add in) takes the plain path;
    only the first patch embed's, whose input and affine need none, takes
    the kernel."""
    _needs_card()
    model = _model("b0")
    trainable = freeze_trunk(model)
    img, seg, flow = (a.float() / 255 if a.dtype == torch.uint8 else a.float()
                      for a in _wire(4))
    seg = seg.expand(-1, -1, -1, 3)
    before = dict(_ops.LAYERNORM_ROUTES)
    y, y_ant, _ = fused_train_forward(model, img, seg, flow,
                                      generator=torch.Generator(device="cuda").manual_seed(0))
    (y.float().square().mean() + y_ant.float().square().mean()).backward()
    moved = {k: _ops.LAYERNORM_ROUTES[k] - before[k] for k in before}
    assert moved == {"kernel": 1, "plain": glue_layernorms(model.cfg, False) - 1}
    assert all(p.grad is not None for p in trainable)


@pytest.mark.cuda
def test_fused_artifact_holds_the_op_and_equals_eager(tmp_path):
    _needs_card()
    model, B = _model("b0"), 8
    exported = export_feature_extractor(model, B, use_fused=True)
    save_artifact(str(tmp_path / "fused"), exported)
    fn = load_artifact(str(tmp_path / "fused"))
    targets = [str(n.target) for g in (m.graph for m in fn.exported.graph_module.modules()
                                       if isinstance(m, torch.fx.GraphModule))
               for n in g.nodes if n.op == "call_function"]
    n = glue_layernorms(model.cfg, True)
    assert targets.count("surgical_tpu.glue_layernorm.default") == n
    inputs = _wire(B, seed=9)
    with torch.no_grad():
        want = WireForward(model, True, out_dtype=torch.float32)(*inputs)
    launches = mb.glue_layer_norm.launches
    got = fn(*inputs)
    assert mb.glue_layer_norm.launches - launches == n
    assert torch.equal(got, want)
