"""The port's selective scan and causal Mamba against the JAX package's, and
the port's copies of the JAX package's numpy exporters.

Stated bounds: the plain scan, and the plain mirror of the kernel's chunked
form, within 1e-5 of ``selective_scan_ref`` and of ``selective_scan_pallas``
in interpret mode (fp32, same recurrence, other summation order over N and
other rounding of the chunk compositions); the port's ``CausalMambaModel`` within 1e-4 of the
JAX model under the same weights (fp32; JAX runs ``selective_scan_xla``, an
associative scan, the port a sequential loop).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.core.config import MambaConfig, MSTCNConfig, RefinerConfig
from surgical_tpu.kernels.selective_scan import selective_scan_pallas, selective_scan_ref
from surgical_tpu.models import convert as jax_convert
from surgical_tpu.models.mamba import CausalMambaModel as JaxMamba
from surgical_tpu.models.mstcn import MultiStageTCN as JaxMSTCN
from surgical_tpu.models.transsv import RefinementTransformer as JaxRefiner
from surgical_tpu_torch.core import config as port_config
from surgical_tpu_torch.kernels.selective_scan import (MAX_CHUNKS, SUB_CHUNK, scan_chunk,
                                                       selective_scan, selective_scan_plain)
from surgical_tpu_torch.models import convert
from surgical_tpu_torch.models.mamba import CausalMambaModel

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

TINY = dict(layers=2, d_model=16, d_state=8, f_dim=32)
ATOL_SCAN, ATOL_MODEL = 1e-5, 1e-4


def _scan_inputs(T, D=16, N=8, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    dt = np.log1p(np.exp(f(T, D) - 2.0)).astype(np.float32)  # softplus: positive steps
    A = -np.exp(0.5 * f(D, N)).astype(np.float32)
    return f(T, D), dt, A, f(T, N), f(T, N), f(D)


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("T", [1, 63, 200])
def test_selective_scan_plain_matches_jax(T, oracle):
    x, dt, A, B, C, D = _scan_inputs(T)
    if oracle == "ref":
        want = np.asarray(selective_scan_ref(x, dt, A, B, C, D))
    else:
        want = np.asarray(selective_scan_pallas(x, dt, A, B, C, D, chunk=64, interpret=True))
    t = lambda a: torch.from_numpy(a)
    got = selective_scan_plain(t(x)[None], t(dt)[None], t(A), t(B)[None], t(C)[None], t(D))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=ATOL_SCAN)


def selective_scan_chunked_plain(x, dt, A, B, C, D, chunk):
    """The CUDA kernel's three steps in plain PyTorch, fp32, for the tests:
    per chunk of ``chunk`` steps, (i) the scan from zero to its end state S_c
    with its decay Lambda_c = prod_t exp(dt_t A) (every chunk but the last);
    (ii) the carry-in h_in(c + 1) = Lambda_c h_in(c) + S_c, folded in chunk
    order from h_in(0) = 0; (iii) the chunk rerun from h_in(c), giving y."""
    T = x.shape[1]
    a = torch.exp(dt[..., None] * A)  # [Bt, T, D, N]
    b = (dt * x)[..., None] * B[:, :, None, :]
    starts = list(range(0, T, chunk))
    pairs = []
    for t0 in starts[:-1]:  # (i)
        h, lam = torch.zeros_like(a[:, 0]), torch.ones_like(a[:, 0])
        for t in range(t0, t0 + chunk):
            h, lam = a[:, t] * h + b[:, t], lam * a[:, t]
        pairs.append((lam, h))
    ys = []
    for c, t0 in enumerate(starts):
        h = torch.zeros_like(a[:, 0])
        for lam, end in pairs[:c]:  # (ii)
            h = lam * h + end
        for t in range(t0, min(T, t0 + chunk)):  # (iii)
            h = a[:, t] * h + b[:, t]
            ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    return torch.stack(ys, 1) + D * x


def test_scan_chunk_cuts_time_into_few_chunks():
    """The kernel's chunk length: a multiple of the sub-chunk, at least two
    of them, at most MAX_CHUNKS chunks per video, the shortest such."""
    assert (scan_chunk(1), scan_chunk(200), scan_chunk(2000), scan_chunk(6000)) == (64, 64, 64, 192)
    for T in (1, 63, 64, 65, 777, 2048, 2049, 6000, 100_000):
        L = scan_chunk(T)
        assert L % SUB_CHUNK == 0 and L >= 2 * SUB_CHUNK and -(-T // L) <= MAX_CHUNKS
        assert L == 2 * SUB_CHUNK or -(-T // (L - SUB_CHUNK)) > MAX_CHUNKS


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("Bt", [1, 3])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 197])  # 1, L - 1, L, L + 1, 3L + 5 at L = 64
def test_selective_scan_chunked_plain_matches_jax(T, Bt, oracle):
    """The kernel's chunked form (chunk scan_chunk(T) = 64: one chunk, one
    chunk and one step, four chunks with a ragged last) against JAX's
    oracles, video by video."""
    ins = [_scan_inputs(T, seed=s) for s in range(Bt)]
    A, D = ins[0][2], ins[0][5]
    want = []
    for x, dt, _, B, C, _ in ins:
        if oracle == "ref":
            want.append(np.asarray(selective_scan_ref(x, dt, A, B, C, D)))
        else:
            want.append(np.asarray(selective_scan_pallas(x, dt, A, B, C, D, chunk=64,
                                                         interpret=True)))
    stack = lambda i: torch.from_numpy(np.stack([v[i] for v in ins]))
    got = selective_scan_chunked_plain(stack(0), stack(1), torch.from_numpy(A), stack(3), stack(4),
                                       torch.from_numpy(D), scan_chunk(T))
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=0, atol=ATOL_SCAN)


def test_selective_scan_wrapper_on_cpu_is_plain_and_batched():
    """CPU tensors take the plain version; videos of a batch are independent."""
    ins = [_scan_inputs(40, seed=s) for s in (1, 2)]
    stack = lambda i: torch.from_numpy(np.stack([v[i] for v in ins]))
    x, dt, B, C = stack(0), stack(1), stack(3), stack(4)
    A, D = torch.from_numpy(ins[0][2]), torch.from_numpy(ins[0][5])
    got = selective_scan(x, dt, A, B, C, D)
    for b in range(2):
        alone = selective_scan_plain(x[b:b + 1], dt[b:b + 1], A, B[b:b + 1], C[b:b + 1], D)
        torch.testing.assert_close(got[b:b + 1], alone, rtol=0, atol=0)
    assert selective_scan.launches == 0


def test_selective_scan_wrapper_has_no_fallback():
    """A tensor on neither the CPU nor a card gets no plain version."""
    x = torch.empty(1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        selective_scan(x, x, torch.empty(16, 8, device="meta"), torch.empty(1, 4, 8, device="meta"),
                       torch.empty(1, 4, 8, device="meta"), torch.empty(16, device="meta"))


def _jax_and_port_mamba(seed=0):
    cfg = MambaConfig(**TINY)
    params = JaxMamba(cfg).init(jax.random.key(seed), jnp.zeros((1, 8, cfg.f_dim)))["params"]
    params = jax.tree.map(np.asarray, params)
    model = CausalMambaModel(port_config.MambaConfig(**TINY), device="cpu")
    convert.load_mamba_params(model, params)
    return cfg, params, model


def test_mamba_matches_jax():
    cfg, params, model = _jax_and_port_mamba()
    x = np.random.default_rng(3).standard_normal((2, 50, cfg.f_dim)).astype(np.float32)
    want = np.asarray(JaxMamba(cfg).apply({"params": params}, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 2, 50, cfg.out_features)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_MODEL)


def test_mamba_is_causal():
    """Frames after t change nothing at or before t."""
    *_, model = _jax_and_port_mamba(seed=1)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 40, 32)).astype(np.float32))
    y = x.clone()
    y[:, 25:] += 1.0
    with torch.no_grad():
        a, b = model(x), model(y)
    torch.testing.assert_close(a[:, :, :25], b[:, :, :25], rtol=0, atol=0)
    assert (a[:, :, 25:] - b[:, :, 25:]).abs().max() > 1e-3


def test_mamba_state_dict_names_are_the_reference_layout():
    cfg, params, model = _jax_and_port_mamba()
    sd = convert.export_mamba_state_dict(params, cfg.layers)
    port = model.state_dict()
    assert sorted(port) == sorted(sd)
    for k, v in sd.items():
        assert tuple(port[k].shape) == v.shape, k


def test_exporters_are_byte_copies_of_jax():
    """The port's copied exporters give exactly the JAX package's state dicts."""
    mcfg = MambaConfig(**TINY)
    tcfg = MSTCNConfig(stages=2, layers=3, f_maps=8, f_dim=24)
    rcfg = RefinerConfig(f_maps=8, f_dim=24, n_layers=2)
    key = jax.random.key(5)
    cases = [
        ("mamba", JaxMamba(mcfg).init(key, jnp.zeros((1, 8, mcfg.f_dim)))["params"],
         (mcfg.layers,)),
        ("mstcn", JaxMSTCN(tcfg).init(key, jnp.zeros((1, 8, tcfg.f_dim)))["params"],
         (tcfg.stages, tcfg.layers)),
        ("refiner", JaxRefiner(rcfg).init(key, jnp.zeros((8, 14)),
                                          jnp.zeros((8, rcfg.f_dim)))["params"],
         (rcfg.n_layers,)),
    ]
    for name, params, args in cases:
        params = jax.tree.map(np.asarray, params)
        want = getattr(jax_convert, f"export_{name}_state_dict")(params, *args)
        got = getattr(convert, f"export_{name}_state_dict")(params, *args)
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


def test_port_config_equals_jax_config():
    """Same dataclasses, fields and defaults in the port's copy."""
    from surgical_tpu.core import config as jax_config

    for name in ("MSTCNConfig", "MambaConfig", "RefinerConfig", "BackboneConfig",
                 "HeadConfig", "TrainConfig", "PipelineConfig"):
        a, b = getattr(jax_config, name)(), getattr(port_config, name)()
        assert jax_config.to_json(a) == port_config.to_json(b), name
    for name in ("PHASE_NAMES", "CHOLEC80_MEAN", "CHOLEC80_STD", "CHOLEC80_CLASS_WEIGHTS"):
        assert getattr(jax_config, name) == getattr(port_config, name), name
    assert port_config.MambaConfig().d_inner == 128
    assert port_config.MambaConfig().resolved_dt_rank == 4
