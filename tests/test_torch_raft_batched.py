"""RAFT over a batch of frame pairs (``surgical_tpu_torch/models/raft.py``)
on seeded weights (the context encoder's BatchNorm statistics and affine
parameters drawn away from identity), 3 iterations, B = 3 distinct pairs:

- the batched flow function against the benchmark's plain reference
  (``portbench/reference/raft.py``: upstream's CorrBlock with grid_sample,
  one pair at a time), on 64 x 64 frames (an 8 x 8 feature grid, levels
  8 / 4 / 2 / 1), 72 x 88 (an odd 9 x 11 grid, floored to 4 x 5, 2 x 2,
  1 x 1) and 60 x 60 (padded to 64 on the device);
- against B = 1 calls, against the gather lookup in the dense one's place,
  and per sample through both encoders;
- the reference in bf16 in the program's place fails the tolerance (TF32
  does not exist on the CPU; the card's TF32 control is the cell's
  ``calibrate.py`` reading).

Gap: the worst pixel's |flow - flow_ref| (L2 over u, v) over the larger of
|flow_ref| and the median pixel's (the cell's ``flow_gap``). Tolerances,
with the CPU readings: against the reference 1e-4 (2.0e-6 to 1.0e-5: the
tent contraction against grid_sample's normalised coordinates, and
upstream's 2 * (x / 255) - 1 against x / 127.5 - 1, through 3 iterations);
against B = 1 calls and against the gather lookup 1e-5 (2.4e-7 to 8.1e-7);
per sample through the encoders 1e-5 of the largest magnitude (4.4e-7);
the bf16 control reads 0.24 to 1.0. The card case (``-m cuda``, no JAX
here) holds 250-px frames at 20 iterations to 1e-3.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from surgical_tpu_torch.models import raft
from surgical_tpu_torch.models.raft import RAFT, make_flow_fn

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

ITERS, B = 3, 3
TOL_REF, TOL_SAME = 1e-4, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    path = os.path.join(ROOT, "portbench", "reference", "raft.py")
    spec = importlib.util.spec_from_file_location("portbench_reference_raft", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def seeded(seed=0, iters=ITERS, device="cpu"):
    model = RAFT(iters=iters, seed=seed, device=device)
    rng = np.random.default_rng(seed + 100)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                for t, v in ((m.running_mean, 0.1 * rng.standard_normal(c)),
                             (m.running_var, rng.uniform(0.5, 1.5, c)),
                             (m.weight, rng.uniform(0.8, 1.2, c)),
                             (m.bias, 0.1 * rng.standard_normal(c))):
                    t.copy_(torch.from_numpy(v))
    return model


def clip(n, H, W, seed=1):
    """``n`` uint8 frames of one smooth texture moving 2-3 px per frame, and
    fresh noise on top, so that the pairs differ."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.uniform(0, 255, (1, 3, H // 4 + 4, W // 4 + 4)))
    canvas = torch.nn.functional.interpolate(coarse, scale_factor=4, mode="bilinear")[0]
    canvas = canvas.permute(1, 2, 0).numpy()
    frames = [canvas[2 * i:2 * i + H, 3 * i:3 * i + W] + rng.normal(0, 8, (H, W, 3))
              for i in range(n)]
    return np.clip(np.stack(frames), 0, 255).round().astype(np.uint8)


def gap(got, want):
    """The worst pixel's end-point error over max(|want|, the median's)."""
    got, want = (torch.as_tensor(np.asarray(a)).double().reshape(-1, 2) for a in (got, want))
    w = want.norm(dim=-1)
    return float(((got - want).norm(dim=-1) / torch.maximum(w, w.median())).max())


def reference(model, frames, **kw):
    return REF.flows(model.state_dict(), torch.from_numpy(frames[:-1]),
                     torch.from_numpy(frames[1:]), model.iters, **kw).numpy()


SIZES = [(64, 64), (72, 88), (60, 60)]


@pytest.fixture(scope="module")
def runs():
    """Per size: (model, frames [B + 1], the batched flows)."""
    out = {}
    for k, (H, W) in enumerate(SIZES):
        model = seeded(k)
        frames = clip(B + 1, H, W, seed=k + 1)
        out[H, W] = model, frames, make_flow_fn(model)(frames[:-1], frames[1:])
    return out


@pytest.mark.parametrize("size", SIZES)
def test_batched_matches_reference(runs, size):
    model, frames, got = runs[size]
    assert got.shape == (B, *size, 2) and got.dtype == np.float32
    want = reference(model, frames)
    assert np.abs(want).max() > 1e-2
    assert gap(got, want) < TOL_REF


@pytest.mark.parametrize("size", SIZES)
def test_batched_matches_one_pair_calls(runs, size):
    model, frames, got = runs[size]
    fn = make_flow_fn(model)
    one = np.stack([fn(frames[i], frames[i + 1]) for i in range(B)])
    assert one.shape == got.shape
    assert gap(got, one) < TOL_SAME


def test_batched_matches_gather_lookup(runs, monkeypatch):
    model, frames, got = runs[72, 88]
    monkeypatch.setattr(raft, "lookup_pyramid", raft.lookup_pyramid_gather)
    assert gap(got, make_flow_fn(model)(frames[:-1], frames[1:])) < TOL_SAME


def test_bf16_control_fails_the_tolerance(runs):
    model, frames, got = runs[64, 64]
    want = reference(model, frames)
    control = reference(model, frames, dtype=torch.bfloat16)
    assert gap(control, want) > 10 * TOL_REF
    assert gap(got, want) < TOL_REF


def test_lookup_batched_equals_per_sample():
    """The dense lookup and the gather over a batch of pyramids and flows
    against each sample's own lookup, at fractional flows that leave the
    grid."""
    g = torch.Generator().manual_seed(4)
    H, W = 9, 11
    corr = torch.randn(B, H * W, H, W, generator=g)
    flow = torch.randn(B, 2, H, W, generator=g) * 3.7
    pyr = raft.corr_pyramid(corr, 4)
    assert [tuple(p.shape[-2:]) for p in pyr] == [(9, 11), (4, 5), (2, 2), (1, 1)]
    dense = raft.lookup_pyramid(pyr, flow)
    gather = raft.lookup_pyramid_gather(pyr, flow)
    assert dense.shape == (B, 4 * 81, H, W)
    scale = gather.abs().max()
    for i in range(B):
        own = raft.lookup_pyramid([p[i] for p in pyr], flow[i])
        torch.testing.assert_close(dense[i], own, rtol=0, atol=TOL_SAME * scale)
    torch.testing.assert_close(dense, gather, rtol=0, atol=TOL_SAME * scale)
    f1, f2 = torch.randn(2, B, 16, H, W, generator=g)
    batched = raft.all_pairs_correlation(f1, f2)
    for i in range(B):
        torch.testing.assert_close(batched[i], raft.all_pairs_correlation(f1[i], f2[i]),
                                   rtol=0, atol=TOL_SAME * batched.abs().max())


def test_encoders_act_per_sample():
    """Instance norm in the feature encoder and the eval-mode BatchNorm of
    the context encoder: a frame's features do not depend on the batch."""
    model = seeded(5)
    assert not model.cnet.norm1.training
    x = torch.from_numpy(clip(4, 64, 64, seed=9)).float().permute(0, 3, 1, 2) / 127.5 - 1
    with torch.no_grad():
        for enc in (model.fnet, model.cnet):
            whole = enc(x)
            for i in range(len(x)):
                torch.testing.assert_close(whole[i:i + 1], enc(x[i:i + 1]), rtol=0,
                                           atol=TOL_SAME * whole.abs().max())


def test_one_pair_is_a_batch_of_one_and_padding_is_the_hosts():
    """A [H, W, 3] pair is the B = 1 batch bit for bit; uint8 and float32
    frames give the same flow; the device's edge padding of 60-px frames
    equals np.pad's, which the driver applies for a one-pair flow function."""
    model = seeded(6, iters=2)
    frames = clip(2, 60, 60, seed=7)
    fn = make_flow_fn(model)
    one = fn(frames[0], frames[1])
    assert one.shape == (60, 60, 2)
    np.testing.assert_array_equal(one, fn(frames[:1], frames[1:])[0])
    np.testing.assert_array_equal(one, fn(*(f.astype(np.float32) for f in frames)))
    padded = [np.pad(f, ((0, 4), (0, 4), (0, 0)), mode="edge").astype(np.float32) for f in frames]
    np.testing.assert_array_equal(one, fn(*padded)[:60, :60])
    with torch.no_grad():
        a, b = (torch.from_numpy(f) / 127.5 - 1.0 for f in padded)
        np.testing.assert_array_equal(model(a, b).numpy(), model(a[None], b[None])[0].numpy())


def test_counts_batches_pairs_iterations():
    model = seeded(7, iters=2)
    frames = clip(4, 64, 64, seed=8)
    before = dict(raft.COUNTS)
    make_flow_fn(model)(frames[:-1], frames[1:])
    assert raft.COUNTS["batches"] - before["batches"] == 1
    assert raft.COUNTS["pairs"] - before["pairs"] == 3
    assert raft.COUNTS["iterations"] - before["iterations"] == 2
    assert raft.COUNTS["largest_batch"] >= 3


@pytest.mark.cuda
def test_card_batch_matches_reference_and_one_pair_calls():
    """On the card at the cell's shapes, 4 pairs: 250-px frames padded to 256
    on the card, 20 iterations, fp32 with TF32 off: the batch against the
    reference (one pair at a time) and against B = 1 calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = seeded(11, iters=20, device="cuda")
    frames = clip(5, 250, 250, seed=12)
    fn = make_flow_fn(model)
    got = fn(frames[:-1], frames[1:])
    want = REF.flows({k: v for k, v in model.state_dict().items()},
                     torch.from_numpy(frames[:-1]).cuda(), torch.from_numpy(frames[1:]).cuda(),
                     20).cpu().numpy()
    one = np.stack([fn(frames[i], frames[i + 1]) for i in range(4)])
    assert np.isfinite(got).all() and gap(got, want) < 1e-3, gap(got, want)
    assert gap(got, one) < 1e-3, gap(got, one)


def test_forward_autotunes_and_restores_the_flags():
    """Inside the forward cuDNN's benchmark mode is on and TF32 is off for
    every convolution; the caller's flags come back after it."""
    model = seeded(8, iters=1)
    seen = []
    model.update_block.encoder.conv.register_forward_pre_hook(lambda *_: seen.append((
        torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
        torch.backends.cuda.matmul.allow_tf32)))
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    make_flow_fn(model)(*clip(2, 64, 64, seed=10))
    assert seen == [(True, False, False)]
    assert (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == flags
