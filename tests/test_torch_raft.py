"""The port's RAFT (``surgical_tpu_torch/models/raft.py``) against the JAX
package's (``surgical_tpu/models/raft.py``) piece by piece and whole, at
fp32 (``jax_default_matmul_precision="highest"``, tests/conftest.py), on
64x64 frames: an 8x8 feature grid whose pyramid has all four levels
(8, 4, 2, 1). The weights are the port's seeded ones with BatchNorm
statistics drawn away from identity, carried to JAX through the JAX
importer. Plus the weight converters and the upstream key layout.

Stated bounds, fp32 on both sides (CPU readings in brackets):
correlation, pyramid, bilinear sampling and convex upsampling 1e-5 (0,
1.2e-7, 0, 9.5e-7); the dense lookup against both JAX lookups and the
port's gather 1e-5 (4.8e-7); the whole forward at 3 iterations against JAX
1e-5 of the flow's largest magnitude (4.4e-7 of it), and against the torch
oracle of tests/test_convert_raft.py on the same state dict 1e-5 (4.1e-6:
its lookup is upstream's grid_sample, other arithmetic for the same
samples).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.models import raft as jraft
from surgical_tpu.models.convert import import_raft_state_dict
from surgical_tpu_torch.models import raft as traft
from surgical_tpu_torch.models.convert import export_raft_state_dict, load_raft_params
from test_convert_raft import TRaft

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

S, ITERS = 64, 3
TOL = 1e-5


def _seeded_raft(seed=0):
    """Port RAFT on the CPU with the cnet's BatchNorm statistics and affine
    parameters drawn away from identity."""
    model = traft.RAFT(iters=ITERS, seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 100)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.standard_normal(c)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
                m.weight.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, c)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.standard_normal(c)))
    return model


def _numpy_sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def model_and_params():
    model = _seeded_raft()
    return model, import_raft_state_dict(_numpy_sd(model))


def _frames(seed=1, size=S):
    rng = np.random.default_rng(seed)
    img1 = rng.uniform(-1, 1, (size, size, 3)).astype(np.float32)
    img2 = np.clip(0.7 * np.roll(img1, 2, axis=1) + 0.3 * rng.uniform(-1, 1, (size, size, 3)),
                   -1, 1).astype(np.float32)
    return img1, img2


def _chw(a):  # [H, W, C] numpy -> [C, H, W] torch
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 0)))


def _hwc(t):  # [C, H, W] torch -> [H, W, C] numpy
    return np.moveaxis(t.numpy(), 0, -1)


def test_correlation_matches_jax(rng):
    f1, f2 = (rng.standard_normal((8, 8, 32)).astype(np.float32) for _ in range(2))
    want = np.asarray(jraft.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2)))
    got = traft.all_pairs_correlation(_chw(f1), _chw(f2)).numpy()
    assert got.shape == want.shape == (64, 8, 8)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("grid,levels,sides", [
    ((8, 8), 4, [(8, 8), (4, 4), (2, 2), (1, 1)]),
    ((2, 2), 4, [(2, 2), (1, 1)]),          # stops once a side is below 2
    ((4, 6), 2, [(4, 6), (2, 3)]),
])
def test_pyramid_matches_jax(rng, grid, levels, sides):
    corr = rng.standard_normal((grid[0] * grid[1], *grid)).astype(np.float32)
    want = jraft.corr_pyramid(jnp.asarray(corr), levels)
    got = traft.corr_pyramid(torch.from_numpy(corr), levels)
    assert [tuple(g.shape[1:]) for g in got] == [tuple(w.shape[1:]) for w in want] == sides
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_pyramid_odd_side_floors_as_upstream(rng):
    """An odd level side (6x10 -> 3x5 -> 1x2): upstream's
    avg_pool2d(·, 2, stride=2) drops the last odd row and column; JAX's
    reshape does not run there. Held to 2x2 block means of the cropped
    level, in numpy."""
    corr = rng.standard_normal((60, 6, 10)).astype(np.float32)
    got = traft.corr_pyramid(torch.from_numpy(corr), 3)
    assert [tuple(g.shape[1:]) for g in got] == [(6, 10), (3, 5), (1, 2)]
    want = corr
    for g in got[1:]:
        h, w = want.shape[1] // 2, want.shape[2] // 2
        want = want[:, :2 * h, :2 * w].reshape(-1, h, 2, w, 2).mean(axis=(2, 4))
        np.testing.assert_allclose(g.numpy(), want, rtol=TOL, atol=TOL)


def test_bilinear_sample_matches_jax(rng):
    img = rng.standard_normal((6, 7)).astype(np.float32)
    coords = (rng.uniform(-2, 9, (5, 4, 2))).astype(np.float32)
    want = np.asarray(jraft.bilinear_sample(jnp.asarray(img), jnp.asarray(coords)))
    got = traft.bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("grid,levels", [((8, 8), 4), ((12, 16), 3)])
@pytest.mark.parametrize("scale", [0.0, 0.5, 3.7, 30.0])
def test_lookup_matches_jax_dense_and_gather(rng, grid, levels, scale):
    """Fractional flows, windows that leave the grid, a non-square grid; the
    window's channel order (x offset outer) included."""
    H, W = grid
    corr = rng.standard_normal((H * W, H, W)).astype(np.float32)
    flow = (rng.standard_normal((H, W, 2)) * scale).astype(np.float32)
    jpyr = jraft.corr_pyramid(jnp.asarray(corr), levels)
    want_dense = np.asarray(jax.jit(jraft.lookup_pyramid)(jpyr, jnp.asarray(flow)))
    want_gather = np.asarray(jax.jit(jraft.lookup_pyramid_gather)(jpyr, jnp.asarray(flow)))
    pyr = traft.corr_pyramid(torch.from_numpy(corr), levels)
    got = _hwc(traft.lookup_pyramid(pyr, _chw(flow)))
    got_gather = _hwc(traft.lookup_pyramid_gather(pyr, _chw(flow)))
    assert got.shape == want_dense.shape == (H, W, levels * 81)
    np.testing.assert_allclose(got, want_dense, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_gather, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_gather, want_gather, rtol=TOL, atol=TOL)


def test_convex_upsample_matches_jax(rng):
    flow = rng.standard_normal((4, 5, 2)).astype(np.float32)
    mask = rng.standard_normal((4, 5, 576)).astype(np.float32)
    want = np.asarray(jraft.convex_upsample(jnp.asarray(flow), jnp.asarray(mask)))
    got = traft.convex_upsample(_chw(flow)[None], _chw(mask)[None])[0]
    assert got.shape == (2, 32, 40)
    np.testing.assert_allclose(_hwc(got), want, rtol=TOL, atol=TOL)


def test_forward_matches_jax(model_and_params):
    model, params = model_and_params
    img1, img2 = _frames()
    want = np.asarray(jax.jit(jraft.RAFT(iters=ITERS).apply)({"params": params}, img1, img2))
    got = model(torch.from_numpy(img1), torch.from_numpy(img2)).numpy()
    assert got.shape == want.shape == (S, S, 2)
    assert np.isfinite(got).all() and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def test_forward_matches_torch_oracle(model_and_params):
    """The upstream-layout oracle of tests/test_convert_raft.py, loaded
    strictly from the port's state dict, on 128-px frames: its
    grid_sample lookup (upstream's) divides by the level's side - 1, so its
    smallest level must be 2 wide, where the port's 1x1 level is fine."""
    model, _ = model_and_params
    oracle = TRaft()
    oracle.load_state_dict(model.state_dict(), strict=True)
    oracle.eval()
    img1, img2 = _frames(size=2 * S)
    with torch.no_grad():
        want = oracle(_chw(img1)[None], _chw(img2)[None], iters=ITERS)[0]
    got = model(torch.from_numpy(img1), torch.from_numpy(img2))
    np.testing.assert_allclose(got.numpy(), _hwc(want), rtol=TOL, atol=TOL)


def test_state_dict_keys_are_the_upstream_oracles():
    assert set(traft.RAFT(device="cpu").state_dict()) == set(TRaft().state_dict())


def test_loads_upstream_dict_with_norm3_twins():
    """Upstream registers each strided unit's downsample norm as ``norm3``
    too, so its state dict holds both names: the port takes it strictly and
    refuses twins that differ."""
    sd = TRaft().state_dict()
    twins = {k.replace("downsample.1.", "norm3."): v.clone() for k, v in sd.items()
             if ".downsample.1." in k}
    assert twins  # the cnet's strided units
    model = traft.RAFT(device="cpu")
    model.load_state_dict({**sd, **twins}, strict=True)
    for k, v in sd.items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    key = next(iter(twins))
    with pytest.raises(ValueError, match="one module"):
        model.load_state_dict({**sd, **twins, key: twins[key] + 1}, strict=True)


def test_export_is_the_inverse_of_jax_import():
    """import_raft_state_dict(export_raft_state_dict(p)) == p leaf for leaf,
    p a flax tree of RAFT's structure filled with seeded values."""
    shapes = jax.eval_shape(jraft.RAFT(iters=1).init, jax.random.key(0),
                            jnp.zeros((S, S, 3)), jnp.zeros((S, S, 3)))["params"]
    leaves, tree = jax.tree.flatten(shapes)
    rng = np.random.default_rng(3)
    p = jax.tree.unflatten(tree, [rng.standard_normal(x.shape).astype(np.float32)
                                  for x in leaves])
    back = import_raft_state_dict(export_raft_state_dict(p))
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_load_raft_params_round_trip(model_and_params):
    model, params = model_and_params
    other = traft.RAFT(seed=5, device="cpu")
    load_raft_params(other, params)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(other.state_dict()[k], v, rtol=0, atol=0)


def test_inference_only_and_shape_checks():
    model = traft.RAFT(iters=1, device="cpu")
    with pytest.raises(RuntimeError, match="inference-only"):
        model.train()
    with pytest.raises(ValueError, match="multiples of 8"):
        model(torch.zeros(60, 64, 3), torch.zeros(60, 64, 3))
    assert not model.training and not model.cnet.norm1.training


def test_tf32_flags_restored():
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    with traft.fp32_precision():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
