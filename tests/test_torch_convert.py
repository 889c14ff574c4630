"""Weights between the JAX package and the port: the MiT-EVP state dict
round-trips through the JAX importer and the port's exporter unchanged, and
JAX-initialized MS-TCN / refiner weights load into the port strictly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.core.config import BackboneConfig, HeadConfig, MSTCNConfig, RefinerConfig
from surgical_tpu.models.convert import import_evp_state_dict
from surgical_tpu.models.mstcn import MultiStageTCN as JaxMSTCN
from surgical_tpu.models.transsv import RefinementTransformer as JaxRefiner
from surgical_tpu_torch.models import convert
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.models.mstcn import MultiStageTCN
from surgical_tpu_torch.models.transsv import RefinementTransformer

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

CFG = BackboneConfig(variant="tiny", embed_dims=(16, 32, 40, 64), num_heads=(1, 2, 4, 8),
                     depths=(2, 1, 2, 1), drop_path_rate=0.0, img_size=64)
HEAD = HeadConfig(embedding_dim=32, hidden=16)


def test_evp_state_dict_round_trip():
    model = MiTEVP(CFG, HEAD, seed=3, device="cpu")
    with torch.no_grad():  # non-trivial BN statistics
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.uniform_(0.5, 1.5)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, batch_stats = import_evp_state_dict(sd, CFG.depths)
    back = convert.export_evp_state_dict(params, batch_stats)
    assert sorted(back) == sorted(sd)
    for key, val in sd.items():
        assert back[key].shape == val.shape, key
        np.testing.assert_array_equal(back[key], val, err_msg=key)
    model.load_state_dict(convert.to_torch(back), strict=True)


def test_unsupported_prompt_config_raises():
    """Every prompt input type, adaptor mode and tuning subset, with and
    without flow and qkv bias: the port's state dict imports into exactly
    the JAX model's parameter and BatchNorm trees (keys and shapes, against
    ``jax.eval_shape`` of a flax init), exports back unchanged and loads
    strictly; the fused graphs still raise on what their kernels do not
    compute."""
    from test_torch_mit_graph import VARIANTS, _drop_none, tiny

    from surgical_tpu.models.mit_evp import MiTEVP as JaxMiTEVP
    from surgical_tpu_torch.models.mit_fused import fused_forward

    head = HeadConfig(embedding_dim=32, hidden=16)
    shapes = lambda tree: jax.tree.map(lambda a: tuple(np.shape(a)), tree)
    for name, kw in VARIANTS.items():
        cfg = tiny(**kw)
        model = MiTEVP(cfg, head, seed=3, device="cpu")
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        params, batch_stats = import_evp_state_dict(sd, cfg.depths)
        params = _drop_none(params)  # the JAX importer's reading of a missing bias
        z = jnp.zeros((1, cfg.img_size, cfg.img_size, 3))
        flow = jnp.zeros((1, cfg.img_size, cfg.img_size, 2)) if cfg.with_flow else None
        want = jax.eval_shape(JaxMiTEVP(cfg, head).init, jax.random.key(0), z, z, flow)
        assert shapes(params) == shapes(want["params"]), name
        assert shapes(batch_stats) == shapes(want.get("batch_stats", {})), name
        back = convert.export_evp_state_dict(params, batch_stats)
        assert sorted(back) == sorted(sd), name
        for key, val in sd.items():
            np.testing.assert_array_equal(back[key], val, err_msg=f"{name} {key}")
        model.load_state_dict(convert.to_torch(back), strict=True)
        if name not in ("gaussian", "gaussian_flow"):
            with pytest.raises(NotImplementedError, match="fused graphs compute the default"):
                fused_forward(model, torch.zeros(1, 64, 64, 3), torch.zeros(1, 64, 64, 3), None)


def test_mstcn_loads_jax_weights_strictly():
    cfg = MSTCNConfig(stages=3, layers=4, f_maps=8, f_dim=24)
    params = JaxMSTCN(cfg).init(jax.random.key(0), jnp.zeros((1, 8, cfg.f_dim)))["params"]
    model = MultiStageTCN(cfg, device="cpu")
    convert.load_mstcn_params(model, jax.tree.map(np.asarray, params))
    want = np.asarray(params["stage_1"]["layer_2"]["conv_dilated"]["kernel"]).transpose(2, 1, 0)
    got = model.stages[0].layers[2].conv_dilated.weight.detach().numpy()
    np.testing.assert_array_equal(got, want)


def test_refiner_loads_jax_weights_strictly():
    cfg = RefinerConfig(f_maps=8, f_dim=24, n_layers=2)
    params = JaxRefiner(cfg).init(jax.random.key(1), jnp.zeros((8, cfg.out_features)),
                                  jnp.zeros((8, cfg.f_dim)))["params"]
    model = RefinementTransformer(cfg, device="cpu")
    convert.load_refiner_params(model, jax.tree.map(np.asarray, params))
    want = np.asarray(params["transformer"]["dec_1"]["cross_attn"]["w_q"]["kernel"]).T
    np.testing.assert_array_equal(
        model.transformer.decoder.layers[1].dec_enc_attn.W_Q.weight.detach().numpy(), want)
