"""The port's ``parallel/`` (mesh helpers and sequence parallelism) on the
CPU over gloo ranks, against the JAX package's single-device models.

The JAX side runs ``model.apply`` (jitted) in this process on the weights
of a seeded port model, carried by the JAX package's importers (no flax
init); the port runs in ranks spawned by ``parallel/dryrun.py::spawn`` (one
spawn of four ranks for every case, two-rank cases on subgroups of two),
which import no JAX.
Bounds are JAX's own (``tests/test_sequence_parallel.py``): MS-TCN 1e-5
(exact halos, fp32 summation order), Mamba 2e-4 and 5e-4 for the long
decay (the closed-form chunk composition in fp32), the generic input halo
1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.core.config import MambaConfig as JaxMambaConfig
from surgical_tpu.core.config import MSTCNConfig as JaxMSTCNConfig
from surgical_tpu.models.mamba import CausalMambaModel as JaxMamba
from surgical_tpu.models import convert as jconvert
from surgical_tpu.models.mstcn import MultiStageTCN as JaxMSTCN
from surgical_tpu.parallel import mesh as jmesh
from surgical_tpu.parallel import sequence as jseq
from surgical_tpu_torch.core import config as pconfig
from surgical_tpu_torch.models.mamba import CausalMambaModel
from surgical_tpu_torch.models.mstcn import MultiStageTCN
from surgical_tpu_torch.parallel import dryrun, mesh, sequence

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

RANKS = 4
# (JAX config, T, ranks, input scale, bound) of tests/test_sequence_parallel.py's cases,
# with T cut to the rank counts here: the two-rank MS-TCN's halos fit in a chunk; the
# four-rank one's last layer (2 x 2^5 = 64 frames) spans two 32-frame chunks
MSTCN_CASES = {
    "two_ranks": (JaxMSTCNConfig(stages=2, layers=5, f_maps=16, f_dim=64), 256, 2, 1.0, 1e-5),
    "four_ranks_multihop": (JaxMSTCNConfig(stages=2, layers=6, f_maps=8, f_dim=32), 128, 4,
                            1.0, 1e-5),
}
MAMBA_CASES = {
    "four_ranks": (JaxMambaConfig(layers=2, d_model=16, f_dim=24, d_state=8, d_conv=4,
                                  dropout=0.0), 256, 4, 1.0, 2e-4),
    "long_decay": (JaxMambaConfig(layers=1, d_model=8, f_dim=8, d_state=4, d_conv=2,
                                  dropout=0.0), 1024, 4, 2.0, 5e-4),
    # the dry runs' Mamba leg (__graft_entry__.py:192, parallel/dryrun.py::dryrun_legs)
    "dryrun": (JaxMambaConfig(layers=1, d_model=16, f_dim=32, d_state=8, out_features=7,
                              dropout=0.0), 32 * RANKS, 4, 0.1, 2e-4),
}
SEQ_T, SEQ_D, SEQ_HALO = 256, 16, 5


def _port_config(jcfg):
    return getattr(pconfig, type(jcfg).__name__)(**dataclasses.asdict(jcfg))


def _jax_case(kind, jcfg, T, scale, seed):
    """(port state dict, input [T, f_dim], JAX single-device output on the
    same weights)."""
    x = (np.random.default_rng(seed).standard_normal((T, jcfg.f_dim)) * scale).astype(np.float32)
    if kind == "mstcn":
        model = MultiStageTCN(_port_config(jcfg), seed=seed, device="cpu")
        jm = JaxMSTCN(jcfg)
        params = jconvert.import_mstcn_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()}, jcfg.stages, jcfg.layers)
    else:
        model = CausalMambaModel(_port_config(jcfg), seed=seed, device="cpu")
        jm = JaxMamba(jcfg, backend="xla")
        params = jconvert.import_mamba_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()}, jcfg.layers)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x[None])))
    return model.state_dict(), x, want[:, 0] if kind == "mstcn" else want[0, 0]


@pytest.fixture(scope="module")
def spawned():
    """One spawn of four gloo ranks running every case; returns {case:
    (rank-0 result, JAX output)} and the four ranks' raw results."""
    legs, wants = [], {}
    for i, (name, (jcfg, T, ranks, scale, _)) in enumerate(
            [*(("mstcn_" + k, v) for k, v in MSTCN_CASES.items()),
             *(("mamba_" + k, v) for k, v in MAMBA_CASES.items())]):
        kind = name.split("_")[0]
        sd, x, want = _jax_case(kind, jcfg, T, scale, seed=i)
        wants[name] = want
        legs.append((dryrun.temporal_leg, dict(kind=kind, cfg=_port_config(jcfg), T=T,
                                               state_dict=sd, x=x,
                                               group_size=None if ranks == RANKS else ranks)))
    rng = np.random.default_rng(9)
    a, b = (rng.standard_normal((SEQ_T, SEQ_D)).astype(np.float32) for _ in range(2))
    legs.append((dryrun.seq_infer_leg, dict(a=a, b=b, halo=SEQ_HALO)))

    def causal_fn(inp):  # tests/test_sequence_parallel.py's function
        x, y = inp
        s = x + 2.0 * y
        w = jnp.stack([jnp.pad(s, ((k, 0), (0, 0)))[: s.shape[0]] for k in range(SEQ_HALO + 1)])
        return jnp.mean(w, axis=0)[None]

    wants["seq"] = np.asarray(causal_fn((jnp.asarray(a), jnp.asarray(b))))
    ranks = dryrun.spawn(dryrun.run_legs, RANKS, legs, device="cpu")
    return {name: (res, wants[name]) for name, res in zip(wants, ranks[0])}, ranks


def test_left_context_matches_jax():
    for stages, layers in ((1, 8), (2, 8), (2, 4), (3, 10)):
        assert sequence.mstcn_left_context(stages, layers) == jseq.mstcn_left_context(stages,
                                                                                      layers)


@pytest.mark.parametrize("n,multiple", [(0, 8), (1, 8), (8, 8), (13, 4), (200, 3)])
def test_pad_to_multiple_matches_jax(n, multiple):
    assert mesh.pad_to_multiple(n, multiple) == jmesh.pad_to_multiple(n, multiple)


@pytest.mark.parametrize("n,target", [(5, 8), (8, 8)])
def test_pad_batch_matches_jax(n, target):
    rng = np.random.default_rng(n)
    batch = (rng.integers(0, 255, (n, 4, 4, 3), dtype=np.uint8),
             rng.standard_normal((n, 2)).astype(np.float16))
    want, want_mask = jmesh.pad_batch(batch, target)
    got, got_mask = mesh.pad_batch(batch, target)
    np.testing.assert_array_equal(got_mask, want_mask)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    # tensors pad as tensors, None stays
    tgot, _ = mesh.pad_batch((torch.from_numpy(batch[0]), None), target)
    assert tgot[1] is None
    np.testing.assert_array_equal(tgot[0].numpy(), np.asarray(want[0]))


def test_helpers_without_a_group_are_the_identity():
    x = torch.arange(12.0).reshape(6, 2)
    assert mesh.rank_world() == (0, 1)
    assert mesh.all_reduce(x) is x and mesh.all_gather(x) is x
    assert mesh.all_reduce_autograd(x) is x
    assert mesh.shard_range(6) == slice(0, 6)
    assert mesh.shard_batch((x, None))[0] is not None
    torch.testing.assert_close(mesh.shard_batch((x, None))[0], x)
    # one rank: the left context is the causal zero padding
    torch.testing.assert_close(sequence._gather_left(x, 3), torch.zeros(3, 2))
    torch.testing.assert_close(sequence._gather_left(x, 9), torch.zeros(9, 2))


def test_sp_refuses_what_jax_refuses():
    model = MultiStageTCN(pconfig.MSTCNConfig(stages=1, layers=2, f_maps=4, f_dim=4,
                                              causal=False), device="cpu")
    with pytest.raises(ValueError, match="causal"):
        sequence.sp_mstcn_infer(model, torch.zeros(8, 4))


@pytest.mark.parametrize("case", sorted(MSTCN_CASES))
def test_sp_mstcn_matches_jax(spawned, case):
    res, want = spawned[0]["mstcn_" + case]
    jcfg, T, ranks, _, bound = MSTCN_CASES[case]
    assert res["ranks"] == ranks
    if case == "four_ranks_multihop":
        assert 2 * 2 ** (jcfg.layers - 1) > T // ranks  # the last layer's halo spans chunks
    assert res["out"].shape == want.shape
    np.testing.assert_allclose(res["out"], want, rtol=bound, atol=bound)
    np.testing.assert_allclose(res["ref"], want, rtol=bound, atol=bound)


@pytest.mark.parametrize("case", sorted(MAMBA_CASES))
def test_sp_mamba_matches_jax(spawned, case):
    res, want = spawned[0]["mamba_" + case]
    *_, bound = MAMBA_CASES[case]
    assert res["out"].shape == want.shape and np.isfinite(res["out"]).all()
    np.testing.assert_allclose(res["out"], want, rtol=bound, atol=bound)
    # the plain scan on the CPU: no kernel launched
    assert res["scan_launches"] == 0


def test_dryrun_mamba_leg_is_the_jax_dry_runs():
    """The port's dry run runs its Mamba leg at the JAX dry run's config
    (d_state 8, not a kernel width), T and input scale; the spawned case
    above holds that leg to JAX's model.apply."""
    leg = next(kw for fn, kw in dryrun.dryrun_legs(RANKS, "cpu")
               if fn is dryrun.temporal_leg and kw["kind"] == "mamba")
    jcfg, T, _, scale, _ = MAMBA_CASES["dryrun"]
    assert leg["cfg"] == _port_config(jcfg) and leg["cfg"].d_state == 8
    assert (leg["T"], leg["scale"]) == (T, scale)


def test_sequence_parallel_infer_tuple(spawned):
    res, want = spawned[0]["seq"]
    np.testing.assert_allclose(res["out"], want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(res["ref"], want, rtol=1e-6, atol=1e-6)


def test_every_rank_holds_the_whole_output(spawned):
    """Each rank returns its seconds; rank 0 alone computes the one-rank
    reference, and the two-rank case ran on a subgroup of two."""
    _, ranks = spawned
    assert len(ranks) == RANKS
    assert all(r[0]["ranks"] == 2 for r in ranks) and all(r[1]["ranks"] == 4 for r in ranks)
    assert all("out" not in r[0] for r in ranks[1:])
