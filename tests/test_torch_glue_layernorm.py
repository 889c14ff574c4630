"""The graph glue's LayerNorm route (``models/_ops.py::layernorm``), its
custom op (``surgical_tpu::glue_layernorm``), the wrapper's refusals and the
kernel's launch plan, on the CPU (no JAX).

- On the CPU, and wherever a gradient is needed, the route is the plain
  ``layer_norm``, bit for bit, gradients included.
- On CUDA tensors the route is decided from the call's inputs alone: a
  bf16 x whose result needs no gradient takes the op. Fake CUDA tensors
  (``FakeTensorMode``) show the choice here; the op's fake implementation
  stands in for the kernel.
- The kernel's numbers, and the route over whole forwards, are held on the
  card by ``tests/test_torch_glue_layernorm_card.py``.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from chip_smoke import glue_ln_calls, glue_layernorms
from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig
from surgical_tpu_torch.kernels import mit_block as mb
from surgical_tpu_torch.kernels import ops
from surgical_tpu_torch.models import _ops, mit_fused
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.utils.trace import counters

WIDTHS = (8, 16, 24, 32, 64, 128, 160, 256, 320, 512)  # the presets' and the tiny ones


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(C, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    norm = torch.nn.LayerNorm(C, eps=1e-6)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(C, generator=g))
        norm.bias.copy_(0.1 * torch.randn(C, generator=g))
    return norm.to(device)


def _x(shape, dtype=torch.bfloat16, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (0.5 + 2 * torch.randn(shape, generator=g)).to(dtype)


def _routes():
    return dict(_ops.LAYERNORM_ROUTES)


def _moved(before):
    return {k: _ops.LAYERNORM_ROUTES[k] - before[k] for k in before}


@pytest.mark.parametrize("shape, dtype", [((2, 49, C), torch.bfloat16) for C in WIDTHS]
                         + [((3, 7, 64), torch.float32), ((5, 320), torch.bfloat16)])
def test_cpu_route_is_layer_norm_bit_for_bit(shape, dtype):
    x, norm = _x(shape, dtype), _norm(shape[-1])
    before = _routes()
    got = _ops.layernorm(x, norm)
    assert _moved(before) == {"kernel": 0, "plain": 1}
    assert torch.equal(got, mb.layer_norm(x, norm.weight, norm.bias))
    assert got.dtype == dtype


def test_cpu_route_under_grad_differentiates_as_layer_norm():
    x = _x((2, 16, 64)).requires_grad_(True)
    norm = _norm(64)
    before = _routes()
    got = _ops.layernorm(x, norm)
    assert _moved(before) == {"kernel": 0, "plain": 1}
    assert got.grad_fn is not None
    grads = torch.autograd.grad(got.float().square().sum(), (x, norm.weight, norm.bias))
    x2 = x.detach().clone().requires_grad_(True)
    w2, b2 = (p.detach().clone().requires_grad_(True) for p in (norm.weight, norm.bias))
    want = mb.layer_norm(x2, w2, b2)
    assert torch.equal(got, want)
    for a, b in zip(grads, torch.autograd.grad(want.float().square().sum(), (x2, w2, b2))):
        assert torch.equal(a, b)


# (grad mode, x requires grad, affine requires grad, dtype, non-unit last stride) -> route
CUDA_CASES = {
    "no_grad": ((False, False, False, torch.bfloat16, False), "kernel"),
    "grad_mode_nothing_requires": ((True, False, False, torch.bfloat16, False), "kernel"),
    "no_grad_everything_requires": ((False, True, True, torch.bfloat16, False), "kernel"),
    "strided_rows": ((False, False, False, torch.bfloat16, True), "kernel"),
    "x_requires_grad": ((True, True, False, torch.bfloat16, False), "plain"),
    "affine_requires_grad": ((True, False, True, torch.bfloat16, False), "plain"),
    "fp32": ((False, False, False, torch.float32, False), "plain"),
}


@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_cuda_route_follows_the_inputs(case, monkeypatch):
    """Fake CUDA tensors: the route reads grad mode, requires_grad, the dtype,
    the device and the width, and nothing else; rows of any strides go to
    the op as they are (its launch makes the one copy a layout needs). The
    plain path is a stand-in here (autograd over fake CUDA tensors aborts a
    CPU build); the CPU cases above hold its numbers."""
    (grad, x_rg, w_rg, dtype, strided), route = CUDA_CASES[case]
    monkeypatch.setattr(_ops, "layer_norm", lambda x, w, b: torch.empty_like(x))
    with FakeTensorMode(allow_non_fake_inputs=True):
        if strided:
            x = torch.empty(2, 64, 7, dtype=dtype, device="cuda").transpose(1, 2)
        else:
            x = torch.empty(2, 7, 64, dtype=dtype, device="cuda")
        x.requires_grad_(x_rg)
        norm = torch.nn.LayerNorm(64, eps=1e-6, device="cuda").requires_grad_(w_rg)
        before = _routes()
        with torch.set_grad_enabled(grad):
            got = _ops.layernorm(x, norm)
        moved = _moved(before)
    assert moved == {"kernel": int(route == "kernel"), "plain": int(route == "plain")}
    assert (got.shape, got.dtype, got.device.type) == ((2, 7, 64), dtype, "cuda")
    if route == "kernel":
        assert got.is_contiguous() and got.grad_fn is None


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fake_implementation_is_bf16_empty_like(device):
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty(3, 5, 160, dtype=torch.bfloat16, device=device)
        w, b = (torch.empty(160, device=device) for _ in range(2))
        y = ops.glue_layernorm(x, w, b)
        assert type(y).__name__ == "FakeTensor"
    assert (y.shape, y.dtype, y.device.type, y.is_contiguous()) == (x.shape, torch.bfloat16,
                                                                     device, True)


def test_op_cpu_implementation_and_opcheck():
    x, norm = _x((4, 9, 32)), _norm(32)
    w, b = norm.weight.detach(), norm.bias.detach()
    before = mb.glue_layer_norm.launches
    assert torch.equal(mb.glue_layer_norm(x, w, b), mb.layer_norm(x, w, b))
    assert mb.glue_layer_norm.launches == before  # the plain version launches nothing
    torch.library.opcheck(ops.glue_layernorm, (x, w, b))


REFUSALS = {
    "cpu_tensor_on_the_kernel_entry": (lambda: mb.glue_layernorm_cuda(
        _x((2, 64)), torch.ones(64), torch.zeros(64)), "CUDA tensors"),
    "width_above_512": (lambda: mb.glue_layer_norm(
        _x((2, 520)), torch.ones(520), torch.zeros(520)), "up to 512"),
    "width_not_a_multiple_of_8": (lambda: mb.glue_layer_norm(
        _x((2, 12)), torch.ones(12), torch.zeros(12)), "multiple of 8"),
    "fp32_input": (lambda: mb.glue_layer_norm(
        _x((2, 64), torch.float32), torch.ones(64), torch.zeros(64)), "bf16"),
    "fp16_input": (lambda: mb.glue_layernorm_cuda(
        _x((2, 64), torch.float16), torch.ones(64), torch.zeros(64)), "bf16"),
    "bf16_affine": (lambda: mb.glue_layer_norm(
        _x((2, 64)), torch.ones(64, dtype=torch.bfloat16), torch.zeros(64)), "fp32 scale"),
    "affine_of_another_width": (lambda: mb.glue_layer_norm(
        _x((2, 64)), torch.ones(64), torch.zeros(32)), "fp32 bias"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses(case):
    call, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        call()


# C -> whether the kernel takes it: a multiple of 8 from 8 to LN_MAX_C
FITS = {4: False, 8: True, 12: False, 32: True, 100: False, 160: True, 320: True, 504: True,
        512: True, 520: False, 1024: False}


@pytest.mark.parametrize("C", list(FITS))
def test_kernel_width_contract(C):
    assert mb.glue_layer_norm_fits(C) is FITS[C]


@pytest.mark.parametrize("C", [C for C, fits in FITS.items() if not fits])
def test_cuda_route_keeps_widths_the_kernel_refuses_plain(C, monkeypatch):
    """A bf16 CUDA call needing no gradient, at a width the kernel does not
    take, keeps the plain ``layer_norm`` (stubbed, as above) and raises
    nothing."""
    calls = []
    monkeypatch.setattr(_ops, "layer_norm",
                        lambda x, w, b: calls.append(x.shape) or torch.empty_like(x))
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        x = torch.empty(2, 7, C, dtype=torch.bfloat16, device="cuda")
        before = _routes()
        got = _ops.layernorm(x, torch.nn.LayerNorm(C, eps=1e-6, device="cuda"))
        moved = _moved(before)
    assert moved == {"kernel": 0, "plain": 1} and calls == [(2, 7, C)]
    assert (got.shape, got.dtype) == ((2, 7, C), torch.bfloat16)


def test_counters_show_both_routes():
    x, norm = _x((2, 4, 32)), _norm(32)
    before = counters()["launches"]
    _ops.layernorm(x, norm)
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        _ops.layernorm(torch.empty(2, 4, 32, dtype=torch.bfloat16, device="cuda"),
                       torch.nn.LayerNorm(32, device="cuda"))
    after = counters()["launches"]
    assert {k: after[k] - before[k] for k in ("layernorm_route_kernel",
                                              "layernorm_route_plain")} == {
        "layernorm_route_kernel": 1, "layernorm_route_plain": 1}
    assert after["glue_layernorm"] == before["glue_layernorm"]  # fake: no launch


@pytest.mark.parametrize("B", [8, 6])
def test_fused_forward_counts_every_glue_layernorm(B, monkeypatch):
    """On the CPU every LayerNorm of ``fused_forward`` takes the plain route,
    at the (tokens, C) and as many times as ``glue_ln_calls`` counts (the
    card test and the smoke hold the same count on the kernel)."""
    S = 64
    cfg = BackboneConfig.preset("tiny", img_size=S, depths=(2, 1, 2, 1))
    model = MiTEVP(cfg, HeadConfig(embedding_dim=16, hidden=8), seed=0, device="cpu")
    g = torch.Generator().manual_seed(3)
    frames = [torch.rand(B, S, S, c, generator=g) for c in (3, 3, 2)]
    seen = {}

    def plain(x, w, b):
        seen[tuple(x.shape[1:])] = seen.get(tuple(x.shape[1:]), 0) + 1
        return mb.layer_norm(x, w, b)

    monkeypatch.setattr(_ops, "layer_norm", plain)
    before = _routes()
    mit_fused.fused_forward(model, *frames)
    want = glue_ln_calls(cfg, B % 8 == 0)
    assert seen == want
    assert _moved(before) == {"kernel": 0, "plain": glue_layernorms(cfg, B % 8 == 0)}


@pytest.mark.parametrize("variant, stage4_kernel, want", [
    ("b3", True, 64), ("b3", False, 67), ("b0", True, 26), ("b0", False, 28)])
def test_glue_layernorms_at_the_presets(variant, stage4_kernel, want):
    """The counts the card holds: 8 patch embeds, 25 LN1 + 25 SR (b3) or 6 +
    6 (b0) outside the stage kernel, 4 stage norms, 2 cross-attentions; the
    prompt cascade's widths (C / 4: 8 to 128) all multiples of 8."""
    cfg = BackboneConfig() if variant == "b3" else BackboneConfig.preset("b0")
    calls = glue_ln_calls(cfg, stage4_kernel)
    assert glue_layernorms(cfg, stage4_kernel) == want
    assert all(mb.glue_layer_norm_fits(C) for _, C in calls)
