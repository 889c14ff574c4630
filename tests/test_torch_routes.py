"""Two routing rules of the port, held to the JAX package, and the guard that
keeps its kernels out of autograd.

- ``_build.refuse_grad``: a MiT kernel wrapper raises when grad mode is on
  and an argument requires grad (its output would carry no gradient). On
  the CPU the wrappers run their differentiable plain versions and are not
  guarded; one case per guarded wrapper runs on a card (marker ``cuda``).
  The selective scan is not guarded: it has a backward kernel behind an
  autograd function, so under grad it returns an output with a
  ``grad_fn`` on either device, and on a card its backward launches the
  kernel (marker ``cuda``).
- Stage 4's route: JAX runs the whole-stage kernel only at a batch that is
  a multiple of 8 (surgical_tpu/models/mit_fused.py:198) and the per-block
  path, whose prompt GELU is exact erf, otherwise. The port's
  ``fused_forward`` at B = 6 is held to JAX's at B = 6, and a spy shows the
  per-block route. JAX's extraction pads a ragged tail to ``batch_size``,
  so the tail runs the stage route: the port's ``extract_features`` on 14
  frames at batch 8 is held to JAX's on the same frames, with the stage
  route taken on both batches.

Stated bounds: those of test_torch_mit_fused.py::test_fused_forward_matches_jax
(correlation > 0.999, median relative error < 2e-2) and of
test_torch_slice.py for the extracted features (correlation > 0.999).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.train import extract as jax_extract
from surgical_tpu_torch.kernels import _build
from surgical_tpu_torch.kernels import mit_block as mb
from surgical_tpu_torch.kernels import selective_scan as ss
from surgical_tpu_torch.models import mit_fused
from surgical_tpu_torch.models.convert import load_evp_params
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.train.extract import extract_features, make_raw_feature_fn
from test_torch_mit_fused import CFG, HEAD, jax_fused_interpret
from test_torch_mit_train import seeded_variables

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

ODD_B = 6                    # not a multiple of _FUSE_BT[4] = 8
FRAMES, BATCH = 14, 8        # a full batch and a ragged tail of 6
C4 = CFG.embed_dims[3]


# -- the guard ------------------------------------------------------------------

@pytest.mark.parametrize("requires_grad, grad_mode, raises", [
    (True, True, True), (True, False, False), (False, True, False)])
def test_refuse_grad(requires_grad, grad_mode, raises):
    t = torch.zeros(3, requires_grad=requires_grad)
    with torch.set_grad_enabled(grad_mode):
        if raises:
            with pytest.raises(RuntimeError, match="wrapper_x: the CUDA kernel has no backward"):
                _build.refuse_grad("wrapper_x", None, torch.ones(2), t)
        else:
            _build.refuse_grad("wrapper_x", None, torch.ones(2), t)


GUARDED = ("block_train_attn_backward", "block_train_forward", "block_train_mlp_backward",
           "fused_mit_block", "fused_mit_block_packed2", "fused_mit_stage")


def _guarded_calls(dev):
    """{name: thunk} of every guarded wrapper on small valid inputs, one of
    which requires grad."""
    rng = np.random.default_rng(0)
    bf = lambda *s: torch.from_numpy(0.1 * rng.standard_normal(s).astype(np.float32)).to(
        dev, torch.bfloat16)
    B, side, C, heads, hidden, Nkv = 2, 8, 64, 1, 256, 4
    w = {"wq": bf(C, C), "bq": bf(C), "wo": bf(C, C), "bo": bf(C), "ln1_scale": bf(C),
         "ln1_bias": bf(C), "ln2_scale": bf(C), "ln2_bias": bf(C), "w1": bf(C, hidden),
         "b1": bf(hidden), "wdw": bf(9, hidden), "bdw": bf(hidden), "w2": bf(hidden, C),
         "b2": bf(C)}
    sw = {key: t.reshape(1, 1, -1) if t.dim() == 1 else t[None]
          for key, t in w.items() if not key.startswith("ln")}
    sw.update(ln1=torch.stack([w["ln1_scale"], w["ln1_bias"]])[None],
              ln2=torch.stack([w["ln2_scale"], w["ln2_bias"]])[None],
              wkv=bf(1, C, 2 * C), bkv=bf(1, 1, 2 * C))
    sw = {key: t.contiguous() for key, t in sw.items()}
    x = bf(B, side * side, C).requires_grad_()
    k, v, m = bf(B, Nkv, C), bf(B, Nkv, C), torch.ones(B, device=dev)
    kw = dict(heads=heads, H=side, W=side)
    return {
        "fused_mit_block": lambda: mb.fused_mit_block(x, k, v, w, **kw),
        "fused_mit_block_packed2": lambda: mb.fused_mit_block_packed2(
            x, k, v, mb.pack_weights2(w), H=side, W=side),
        "fused_mit_stage": lambda: mb.fused_mit_stage(x, None, sw, **kw, sr=1),
        "block_train_forward": lambda: mb.block_train_forward(x, x, k, v, w, m, m, **kw),
        "block_train_mlp_backward": lambda: mb.block_train_mlp_backward(
            x, x, w, H=side, W=side),
        "block_train_attn_backward": lambda: mb.block_train_attn_backward(
            x, k, v, x, m, w, heads=heads),
    }


def _scan_call(dev):
    """The selective scan on small valid inputs, x requiring grad."""
    rng = np.random.default_rng(0)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    x = f32(1, 16, 8).requires_grad_()
    return x, ss.selective_scan(x, f32(1, 16, 8).abs(), -f32(8, 64).abs(), f32(1, 16, 64),
                                f32(1, 16, 64), f32(8))


def test_guarded_calls_cover_the_wrappers():
    """The CUDA cases below cover every guarded wrapper, and on the CPU each
    runs its plain version with grad (nothing to refuse there); the scan,
    not guarded, returns an output that requires grad."""
    calls = _guarded_calls("cpu")
    assert sorted(calls) == list(GUARDED)
    _, out = _scan_call("cpu")
    assert out.requires_grad and out.grad_fn is not None


@pytest.mark.cuda
@pytest.mark.parametrize("name", GUARDED)
def test_wrappers_refuse_grad_on_the_card(name):
    """Each guarded wrapper, given a CUDA input that requires grad under
    grad mode, raises before it launches; under no_grad it runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the guard sits on the wrappers' CUDA branch")
    call = _guarded_calls("cuda")[name]
    with pytest.raises(RuntimeError, match="has no backward"):
        call()
    with torch.no_grad():
        call()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_scan_backward_launches_its_kernel_on_the_card():
    """Under grad on the card the scan returns an output with a grad_fn, and
    its backward launches the backward kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan's backward kernel runs only there")
    ss.reset_launches()
    x, y = _scan_call("cuda")
    assert y.grad_fn is not None and ss.selective_scan.launches == 1
    y.sum().backward()
    torch.cuda.synchronize()
    assert ss.selective_scan_backward.launches == 1 and torch.isfinite(x.grad).all()


# -- stage 4's route ------------------------------------------------------------------

@pytest.fixture(scope="module")
def evp():
    variables = seeded_variables(CFG, HEAD, 5)
    rng = np.random.default_rng(5)
    img, seg, flow = (rng.standard_normal((ODD_B, CFG.img_size, CFG.img_size, c)
                                          ).astype(np.float32) for c in (3, 3, 2))
    model = MiTEVP(CFG, HEAD, device="cpu")
    load_evp_params(model, variables["params"], variables["batch_stats"])
    return variables, model, img, seg, flow


@pytest.fixture
def spy(monkeypatch):
    """Counts of the port's stage-kernel calls and of its block-kernel calls
    at stage 4's width."""
    calls = {"stage": 0, "block4": 0}
    stage, block = mit_fused.fused_mit_stage, mit_fused.fused_mit_block

    def spy_stage(*a, **k):
        calls["stage"] += 1
        return stage(*a, **k)

    def spy_block(x, *a, **k):
        calls["block4"] += x.shape[-1] == C4
        return block(x, *a, **k)

    monkeypatch.setattr(mit_fused, "fused_mit_stage", spy_stage)
    monkeypatch.setattr(mit_fused, "fused_mit_block", spy_block)
    return calls


def test_odd_batch_runs_stage4_block_by_block_like_jax(evp, spy):
    variables, model, img, seg, flow = evp
    want = np.asarray(jax_fused_interpret(variables, img, seg, flow), np.float32)
    got = mit_fused.fused_forward(model, torch.from_numpy(img), torch.from_numpy(seg),
                                  torch.from_numpy(flow)).numpy()
    assert spy == {"stage": 0, "block4": CFG.depths[3]}
    assert got.shape == want.shape == (ODD_B, HEAD.embedding_dim)
    assert np.isfinite(got).all()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-2)
    assert corr > 0.999, corr
    assert np.median(rel) < 2e-2, np.median(rel)


def test_ragged_extraction_tail_takes_the_stage_route_like_jax(evp, spy):
    variables, model, *_ = evp
    rng = np.random.default_rng(4)
    S = CFG.img_size
    img = rng.integers(0, 256, (FRAMES, S, S, 3), dtype=np.uint8)
    seg = rng.integers(0, 256, (FRAMES, S, S, 1), dtype=np.uint8)
    flow = rng.standard_normal((FRAMES, S, S, 2)).astype(np.float16)
    batches = [(img[i:i + BATCH], seg[i:i + BATCH], flow[i:i + BATCH])
               for i in range(0, FRAMES, BATCH)]
    assert [b[0].shape[0] for b in batches] == [BATCH, FRAMES - BATCH]

    got, stats = extract_features(make_raw_feature_fn(model), iter(batches), FRAMES,
                                  HEAD.embedding_dim, BATCH)
    assert stats["frames"] == FRAMES
    assert spy == {"stage": 2, "block4": 0}

    dequant = jax_extract.wire_dequant()

    def jax_fn(i, s, f):
        assert i.shape[0] == BATCH  # JAX pads the tail
        i, s = dequant(jnp.asarray(i), jnp.asarray(s))
        out = jax_fused_interpret(variables, i, s, jnp.asarray(f, jnp.bfloat16))
        return out.astype(jnp.float16)

    want, _ = jax_extract.extract_features(jax_fn, iter(batches), FRAMES, HEAD.embedding_dim,
                                           BATCH)
    assert got.shape == want.shape == (FRAMES, HEAD.embedding_dim)
    assert np.isfinite(got).all()
    for rows in (slice(0, BATCH), slice(BATCH, FRAMES)):
        corr = np.corrcoef(got[rows].ravel(), np.asarray(want[rows], np.float32).ravel())[0, 1]
        assert corr > 0.999, (rows, corr)
