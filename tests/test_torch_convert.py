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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MiTEVP(BackboneConfig(input_type="srm"), device="cpu")


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
