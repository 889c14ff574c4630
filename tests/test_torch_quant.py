"""The port's int8 weights (``surgical_tpu_torch/serving/quant.py``) and the
int8 extraction path (``make_raw_feature_fn(weight_quant="int8")``) on the
CPU, held to the JAX package's ``serving/quant.py`` and ``train/extract.py``
at the config of tests/test_quant.py (64-px frames, B = 4), one torch
thread. The JAX weights come from a seeded port model through the JAX
importer (tests/test_torch_mit_graph.py's ``jax_variables``).

Stated bounds:
- the quantized weights leaf for leaf: JAX's int8 and dequantized trees,
  carried into the port's layout by ``export_evp_state_dict``, equal the
  port's int8 and dequantized state dicts bit for bit (the joint
  cross-attention ``in_proj_weight`` [3C, C] against JAX's three kernels);
  64 quantized port tensors against JAX's 68 leaves;
- ``quantization_error`` equals JAX's per mapped tensor (exactly; for
  ``in_proj_weight``, JAX's three errors combined over their joint maximum,
  rel 1e-6);
- int8 extraction on the flax graph (bf16) against JAX's int8 extraction
  (flax graph, compute dtype bf16): rel L2 <= 2e-2, the bf16 graph bound of
  tests/test_torch_mit_graph.py; against the port's fp path, JAX's own gates
  (median relative feature delta < 0.2, correlation > 0.95);
- int8 extraction equals the fp path on a model whose weights were set to
  the dequantized values, bit for bit, on both graphs (the glue rounds every
  weight to bf16, and a bf16 weight is the fp32 one's rounding), while the
  held tensors stay int8;
- chip_smoke.py's int8 phase at this size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.core.config import BackboneConfig, HeadConfig
from surgical_tpu.models.mit_evp import MiTEVP as JaxMiTEVP
from surgical_tpu.parallel import mesh as meshlib
from surgical_tpu.serving import quant as jquant
from surgical_tpu.train.extract import make_raw_feature_fn as jax_feature_fn
from surgical_tpu_torch.models.convert import export_evp_state_dict
from surgical_tpu_torch.serving.quant import (dequantize_state, quantization_error,
                                              quantize_state)
from surgical_tpu_torch.train.extract import make_raw_feature_fn
from test_torch_mit_graph import jax_variables, port_model, rel_l2

# tests/test_quant.py:72-78
CFG = BackboneConfig(variant="tiny", embed_dims=(16, 32, 40, 64), num_heads=(1, 2, 4, 8),
                     depths=(1, 1, 1, 1), sr_ratios=(8, 4, 2, 1), qkv_bias=True,
                     drop_path_rate=0.0, img_size=64)
HEAD = HeadConfig(embedding_dim=64, hidden=32)
B, S = 4, 64
JAX_BOUND = 2e-2
MEDIAN_REL, CORR = 0.2, 0.95


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    variables = jax_variables(CFG, HEAD, seed=3)
    model = port_model(CFG, HEAD, variables)
    rng = np.random.default_rng(0)
    wire = (rng.integers(0, 255, (B, S, S, 3)).astype(np.uint8),
            rng.integers(0, 255, (B, S, S, 1)).astype(np.uint8),
            rng.standard_normal((B, S, S, 2)).astype(np.float16))
    return variables, model, wire


def _f32(sd):
    return {k: np.asarray(v).astype(np.float32) for k, v in sd.items()}


def _port_names(variables):
    """{port state-dict name: [JAX keystr, ...]} of the quantizable leaves,
    read by carrying each leaf's index through ``export_evp_state_dict``."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(variables)
    keys, marked = [], []
    for path, leaf in leaves:
        if jquant._is_quantizable(path, leaf):
            keys.append(jax.tree_util.keystr(path))
            marked.append(np.full(leaf.shape, len(keys), np.float32))  # index + 1
        else:
            marked.append(np.zeros(np.shape(leaf), np.float32))
    tree = jax.tree_util.tree_unflatten(treedef, marked)
    sd = export_evp_state_dict(tree["params"], tree["batch_stats"])
    out = {}
    for name, a in sd.items():
        ids = [int(i) for i in np.unique(np.asarray(a)) if i > 0]
        if ids:
            out[name] = [keys[i - 1] for i in sorted(ids)]
    return out, keys


def test_quantized_weights_match_jax_leaf_for_leaf(setup):
    variables, model, _ = setup
    q, scales = quantize_state(model.state_dict())
    deq = dequantize_state(q, scales)
    jq, jscales = jquant.quantize_tree(variables)
    jdeq = jquant.dequantize_tree(jq, jscales, jnp.bfloat16)
    names, jkeys = _port_names(variables)
    assert len(scales) == 64 and len(jscales) == len(jkeys) == 68
    assert set(names) == set(scales) and sorted(sum(names.values(), [])) == sorted(jkeys)
    assert sum(len(v) == 3 for v in names.values()) == 2  # the two in_proj_weight
    want_q = export_evp_state_dict(jq["params"], jq["batch_stats"])
    want_deq = _f32(export_evp_state_dict(jdeq["params"], jdeq["batch_stats"]))
    assert set(want_deq) == set(deq)
    for name in deq:
        if name in scales:
            assert q[name].dtype == torch.int8 and deq[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(q[name].numpy(), np.asarray(want_q[name]), name)
        else:
            assert deq[name] is model.state_dict()[name] or torch.equal(
                deq[name], model.state_dict()[name])
        np.testing.assert_array_equal(deq[name].float().numpy(), want_deq[name], name)


def test_quantization_error_matches_jax(setup):
    variables, model, _ = setup
    errs = quantization_error(model.state_dict())
    jerrs = jquant.quantization_error(variables)
    names, _ = _port_names(variables)
    flat = {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(variables)[0]}
    assert set(errs) == set(names)
    for name, keys in names.items():
        if len(keys) == 1:
            assert errs[name] == jerrs[keys[0]], name
        else:
            denoms = [np.abs(flat[k]).max() + 1e-12 for k in keys]
            joint = max(jerrs[k] * d for k, d in zip(keys, denoms)) / max(denoms)
            np.testing.assert_allclose(errs[name], joint, rtol=1e-6, err_msg=name)
    assert max(errs.values()) < 0.01


def test_int8_extraction_matches_jax_and_stays_near_fp(setup):
    variables, model, wire = setup
    q8 = make_raw_feature_fn(model, d2h_dtype=torch.float32, use_fused=False,
                             weight_quant="int8")
    fp = make_raw_feature_fn(model, d2h_dtype=torch.float32, use_fused=False)
    got, ref = q8(*wire).numpy(), fp(*wire).numpy()
    jmodel = JaxMiTEVP(CFG, HEAD, compute_dtype=jnp.bfloat16)
    want = np.asarray(jax_feature_fn(jmodel, variables, mesh=meshlib.make_mesh(1),
                                     use_fused=False, d2h_dtype=jnp.float32,
                                     weight_quant="int8")(*wire), np.float32)
    assert got.shape == want.shape == (B, HEAD.embedding_dim)
    assert rel_l2(got, want) <= JAX_BOUND, rel_l2(got, want)
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-2)
    assert np.median(rel) < MEDIAN_REL, np.median(rel)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > CORR
    assert not np.array_equal(got, ref)


@pytest.mark.parametrize("use_fused", [True, False])
def test_int8_equals_fp_on_the_dequantized_weights(setup, use_fused):
    _, model, wire = setup
    q8 = make_raw_feature_fn(model, d2h_dtype=torch.float32, use_fused=use_fused,
                             weight_quant="int8")
    q, scales = q8.held
    assert len(q) == 64 and all(t.dtype == torch.int8 for t in q.values())
    assert all(s.dtype == torch.float32 for s in scales.values())
    q_state, s_state = quantize_state(model.state_dict())
    deq = dequantize_state(q_state, s_state)
    ref_model = port_model(CFG, HEAD, setup[0])
    ref_model.load_state_dict({k: v.float() if k in s_state else v for k, v in deq.items()})
    want = make_raw_feature_fn(ref_model, d2h_dtype=torch.float32, use_fused=use_fused)(*wire)
    torch.testing.assert_close(q8(*wire), want, rtol=0, atol=0)
    # the fp path on the original weights is unchanged by an int8 dispatch
    fp = make_raw_feature_fn(model, d2h_dtype=torch.float32, use_fused=use_fused)
    torch.testing.assert_close(fp(*wire), make_raw_feature_fn(
        port_model(CFG, HEAD, setup[0]), d2h_dtype=torch.float32, use_fused=use_fused)(*wire),
        rtol=0, atol=0)


def test_unknown_weight_quant_raises(setup):
    with pytest.raises(ValueError, match="unknown weight_quant"):
        make_raw_feature_fn(setup[1], weight_quant="int4")


def test_chip_smoke_int8_phase_on_cpu():
    """chip_smoke.py's int8 phase, sized down to the tiny preset on the CPU:
    the same checks as on the card, without its timings and launch counts."""
    import chip_smoke

    res = chip_smoke.phase_int8(cfg=BackboneConfig.preset("tiny"), head_cfg=HeadConfig(
        embedding_dim=32, hidden=16), device="cpu", size=S, batch=8, n_batches=2)
    assert res["quantized_tensors"] == 64 and res["frames"] == 16
    assert res["bytes_int8"] < res["bytes_bf16"] and "fps" not in res
    assert res["feature_corr"] > CORR
