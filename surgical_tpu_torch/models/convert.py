"""Weights between the JAX package and the port.

The port keeps the reference's state-dict key names, so a JAX parameter tree
becomes a port state dict through the numpy exporters below, copied from
``surgical_tpu/models/convert.py`` (the port imports nothing of the JAX
package): ``export_mstcn_state_dict``, ``export_refiner_state_dict`` and
``export_mamba_state_dict``. The MiT-EVP backbone has only an importer
there; ``export_evp_state_dict`` here is its inverse. The ``load_*_params``
functions load JAX weights into a port module with ``strict=True``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _put_dense(sd, key, p):
    sd[f"{key}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[f"{key}.bias"] = np.asarray(p["bias"])


def _put_conv(sd, key, p):
    # flax [kh, kw, in, out] -> torch [out, in, kh, kw] (depthwise: in = 1)
    sd[f"{key}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        sd[f"{key}.bias"] = np.asarray(p["bias"])


def _put_ln(sd, key, p):
    sd[f"{key}.weight"] = np.asarray(p["scale"])
    sd[f"{key}.bias"] = np.asarray(p["bias"])


def _put_bn(sd, key, p, stats):
    _put_ln(sd, key, p)
    sd[f"{key}.running_mean"] = np.asarray(stats["mean"])
    sd[f"{key}.running_var"] = np.asarray(stats["var"])
    sd[f"{key}.num_batches_tracked"] = np.asarray(0, np.int64)


def export_evp_state_dict(params: Mapping, batch_stats: Mapping) -> dict:
    """JAX ``MiTEVP`` (params, batch_stats) of numpy arrays -> the reference
    key state dict that the port's ``MiTEVP.load_state_dict`` takes: the
    inverse of ``surgical_tpu.models.convert.import_evp_state_dict``."""
    sd: dict = {}
    for s in range(1, 5):
        _put_conv(sd, f"patch_embed{s}.proj", params[f"patch_embed{s}"]["proj"])
        _put_ln(sd, f"patch_embed{s}.norm", params[f"patch_embed{s}"]["norm"])
        d = 0
        while f"block{s}_{d}" in params:
            b, pre = params[f"block{s}_{d}"], f"block{s}.{d}"
            _put_ln(sd, f"{pre}.norm1", b["norm1"])
            for name in ("q", "kv", "proj"):
                _put_dense(sd, f"{pre}.attn.{name}", b["attn"][name])
            if "sr" in b["attn"]:
                _put_conv(sd, f"{pre}.attn.sr", b["attn"]["sr"])
                _put_ln(sd, f"{pre}.attn.norm", b["attn"]["norm"])
            _put_ln(sd, f"{pre}.norm2", b["norm2"])
            _put_dense(sd, f"{pre}.mlp.fc1", b["mlp"]["fc1"])
            _put_conv(sd, f"{pre}.mlp.dwconv.dwconv", b["mlp"]["dwconv"]["dwconv"])
            _put_dense(sd, f"{pre}.mlp.fc2", b["mlp"]["fc2"])
            d += 1
        _put_ln(sd, f"norm{s}", params[f"norm{s}"])

    P = "prompt_generator"
    for key, p in params[P].items():
        if key.startswith("handcrafted_generator"):
            _put_conv(sd, f"{P}.{key}.proj", p["proj"])
            _put_ln(sd, f"{P}.{key}.norm", p["norm"])
        elif key.startswith("lightweight_mlp"):
            _put_dense(sd, f"{P}.{key}.0", p)
        else:  # embedding_generator{s}, shared_mlp{s}
            _put_dense(sd, f"{P}.{key}", p)

    fe, fs = params["flow_encoder"], batch_stats["flow_encoder"]
    for i in (1, 2, 3, 4):
        _put_conv(sd, f"flow_encoder.conv{i}", fe[f"conv{i}"])
        _put_bn(sd, f"flow_encoder.bn{i}", fe[f"bn{i}"], fs[f"bn{i}"])

    for name in ("cross_attn_s3", "cross_attn_s4"):
        p = params[name]
        qkv = [p[f"{n}_proj"] for n in "qkv"]
        sd[f"{name}.cross_attn.in_proj_weight"] = np.concatenate(
            [np.asarray(x["kernel"]).T for x in qkv])
        sd[f"{name}.cross_attn.in_proj_bias"] = np.concatenate(
            [np.asarray(x["bias"]) for x in qkv])
        _put_dense(sd, f"{name}.cross_attn.out_proj", p["out_proj"])
        _put_ln(sd, f"{name}.norm", p["norm"])

    hp = params["head"]
    for i in (1, 2, 3, 4):
        _put_dense(sd, f"head.linear_c{i}.proj", hp[f"linear_c{i}"])
    _put_conv(sd, "head.linear_fuse.conv", hp["linear_fuse"])
    _put_bn(sd, "head.linear_fuse.bn", hp["fuse_bn"], batch_stats["head"]["fuse_bn"])
    for name in ("fc", "fc_ant"):
        _put_dense(sd, f"head.{name}.0", hp[f"{name}_1"])
        _put_dense(sd, f"head.{name}.2", hp[f"{name}_2"])
    return sd


def export_mstcn_state_dict(params: Mapping, stages: int, layers: int) -> dict:
    """MultiStageTCN params -> torch MultiStageModel_S layout (round-trip)."""
    sd = {}

    def put_conv1x1(key, p):
        sd[f"{key}.weight"] = np.asarray(p["kernel"]).T[:, :, None]
        sd[f"{key}.bias"] = np.asarray(p["bias"])

    def put_stage(prefix, p):
        put_conv1x1(f"{prefix}.conv_1x1", p["in_proj"])
        put_conv1x1(f"{prefix}.conv_out_classes", p["out_proj"])
        for i in range(layers):
            lp = p[f"layer_{i}"]
            sd[f"{prefix}.layers.{i}.conv_dilated.weight"] = (
                np.asarray(lp["conv_dilated"]["kernel"]).transpose(2, 1, 0)
            )
            sd[f"{prefix}.layers.{i}.conv_dilated.bias"] = np.asarray(lp["conv_dilated"]["bias"])
            put_conv1x1(f"{prefix}.layers.{i}.conv_1x1", lp["conv_1x1"])

    put_stage("stage1_phase", params["stage_0"])
    for s in range(1, stages):
        put_stage(f"stages.{s - 1}", params[f"stage_{s}"])
    return sd


def export_refiner_state_dict(params: Mapping, n_layers: int = 1) -> dict:
    """RefinementTransformer params -> the reference ``Transformer`` wrapper
    layout (inverse of import_refiner_state_dict; LN/bias state that has no
    torch slot — inline LayerNorms, FFN biases — must be identity/zero and is
    asserted so a lossy export cannot pass silently)."""
    sd = {"fc.weight": np.asarray(params["fc"]["kernel"]).T}

    def put_attn(pre, p):
        sd[f"{pre}.W_Q.weight"] = np.asarray(p["w_q"]["kernel"]).T
        sd[f"{pre}.W_K.weight"] = np.asarray(p["w_k"]["kernel"]).T
        sd[f"{pre}.W_V.weight"] = np.asarray(p["w_v"]["kernel"]).T
        sd[f"{pre}.fc.weight"] = np.asarray(p["w_o"]["kernel"]).T
        assert np.allclose(p["ln"]["scale"], 1.0) and np.allclose(p["ln"]["bias"], 0.0), \
            f"{pre}: non-identity LayerNorm has no slot in the torch layout"

    def put_ffn(pre, p):
        sd[f"{pre}.fc.0.weight"] = np.asarray(p["fc1"]["kernel"]).T
        sd[f"{pre}.fc.2.weight"] = np.asarray(p["fc2"]["kernel"]).T
        assert np.allclose(p["fc1"]["bias"], 0.0) and np.allclose(p["fc2"]["bias"], 0.0), \
            f"{pre}: nonzero FFN bias has no slot in the torch layout"
        assert np.allclose(p["ln"]["scale"], 1.0) and np.allclose(p["ln"]["bias"], 0.0), \
            f"{pre}: non-identity LayerNorm has no slot in the torch layout"

    t = params["transformer"]
    for i in range(n_layers):
        put_attn(f"transformer.encoder.layers.{i}.enc_self_attn", t[f"enc_{i}"]["self_attn"])
        put_ffn(f"transformer.encoder.layers.{i}.pos_ffn", t[f"enc_{i}"]["ffn"])
        put_attn(f"transformer.decoder.layers.{i}.dec_self_attn", t[f"dec_{i}"]["self_attn"])
        put_attn(f"transformer.decoder.layers.{i}.dec_enc_attn", t[f"dec_{i}"]["cross_attn"])
        put_ffn(f"transformer.decoder.layers.{i}.pos_ffn", t[f"dec_{i}"]["ffn"])
    return sd


def export_mamba_state_dict(params: Mapping, layers: int) -> dict:
    """CausalMambaModel params -> reference torch layout (round-trip)."""
    sd = {
        "in_proj.weight": np.asarray(params["in_proj"]["kernel"]).T,
        "in_proj.bias": np.asarray(params["in_proj"]["bias"]),
        "norm.weight": np.asarray(params["norm"]["scale"]),
        "norm.bias": np.asarray(params["norm"]["bias"]),
        "head.weight": np.asarray(params["head"]["kernel"]).T,
        "head.bias": np.asarray(params["head"]["bias"]),
    }
    for i in range(layers):
        p = params[f"block_{i}"]
        pre = f"blocks.{i}"
        sd[f"{pre}.in_proj.weight"] = np.asarray(p["in_proj"]["kernel"]).T
        sd[f"{pre}.conv1d.weight"] = np.asarray(p["conv1d"]["kernel"]).transpose(2, 1, 0)
        sd[f"{pre}.conv1d.bias"] = np.asarray(p["conv1d"]["bias"])
        sd[f"{pre}.x_proj.weight"] = np.asarray(p["x_proj"]["kernel"]).T
        sd[f"{pre}.dt_proj.weight"] = np.asarray(p["dt_proj"]["kernel"]).T
        sd[f"{pre}.dt_proj.bias"] = np.asarray(p["dt_proj"]["bias"])
        sd[f"{pre}.A_log"] = np.asarray(p["A_log"])
        sd[f"{pre}.D"] = np.asarray(p["D"])
        sd[f"{pre}.out_proj.weight"] = np.asarray(p["out_proj"]["kernel"]).T
    return sd


def to_torch(sd: Mapping) -> dict:
    """numpy state dict -> torch tensors (copies, contiguous)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def load_evp_params(model, params: Mapping, batch_stats: Mapping) -> None:
    """Load JAX ``MiTEVP`` weights into a port ``MiTEVP`` (strict)."""
    model.load_state_dict(to_torch(export_evp_state_dict(params, batch_stats)), strict=True)


def load_torch_pth(path: str) -> dict:
    """A reference ``.pth`` state dict (a ``{"state_dict": ...}`` wrapper
    unwrapped, DataParallel ``module.`` prefixes stripped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.removeprefix("module."): v for k, v in sd.items()}


_TRUNK = ("patch_embed", "block", "norm")


def load_mit_trunk(model, sd: Mapping) -> list[str]:
    """Load the trunk keys of an ImageNet SegFormer ``mit_b*.pth``
    (``patch_embed{s}``, ``block{s}``, ``norm{s}``) into a port ``MiTEVP``
    by key name; every other key (the ImageNet head) is dropped and the
    prompt generator, flow encoder, fusions and head keep their init: the
    reference's strict=False partial load (train_evp.py:365-375). Raises on
    a trunk key the model lacks or whose shape differs. Returns the loaded
    keys."""
    own = model.state_dict()
    trunk = {k: v for k, v in sd.items() if k.split(".")[0].rstrip("1234") in _TRUNK}
    for k, v in trunk.items():
        if k not in own or tuple(own[k].shape) != tuple(v.shape):
            raise KeyError(f"trunk key {k} {tuple(v.shape)} does not fit the model "
                           f"({tuple(own[k].shape) if k in own else 'absent'})")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in trunk.items()}, strict=False)
    return sorted(trunk)


def load_mstcn_params(model, params: Mapping) -> None:
    """Load JAX ``MultiStageTCN`` params into a port ``MultiStageTCN``."""
    cfg = model.cfg
    sd = export_mstcn_state_dict(params, cfg.stages, cfg.layers)
    model.load_state_dict(to_torch(sd), strict=True)


def load_refiner_params(model, params: Mapping) -> None:
    """Load JAX ``RefinementTransformer`` params into the port's."""
    sd = export_refiner_state_dict(params, model.cfg.n_layers)
    model.load_state_dict(to_torch(sd), strict=True)


def load_mamba_params(model, params: Mapping) -> None:
    """Load JAX ``CausalMambaModel`` params into the port's."""
    sd = export_mamba_state_dict(params, model.cfg.layers)
    model.load_state_dict(to_torch(sd), strict=True)
