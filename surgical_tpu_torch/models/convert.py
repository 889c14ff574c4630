"""Weights between the JAX package and the port.

The port keeps the reference's state-dict key names, so a JAX parameter tree
becomes a port state dict through the numpy exporters below, copied from
``surgical_tpu/models/convert.py`` (the port imports nothing of the JAX
package): ``export_mstcn_state_dict``, ``export_refiner_state_dict`` and
``export_mamba_state_dict``. The MiT-EVP backbone and RAFT have only
importers there; ``export_evp_state_dict`` and ``export_raft_state_dict``
here are their inverses. ``export_dual_tower_mstcn_state_dict`` and
``export_adaptor_state_dict`` carry two JAX classes that have no importer
(``DualTowerMSTCN``, ``Adaptor``); ``HiddenFeatureMSTCN`` shares
``MultiStageTCN``'s parameter tree, so ``export_mstcn_state_dict`` carries
it. The ``load_*_params`` functions load
JAX weights into a port module with ``strict=True``. ``refiner_state_dict``
carries every parameter of a JAX refiner, its LayerNorms and FFN biases
included, which the reference-layout exporter refuses unless they are at
their init (``load_trained_refiner_params``).
``infer_mstcn_dims`` and ``infer_refiner_dims`` are copies of the JAX
module's, which read a reference checkpoint's model dims off its state dict.
"""

from __future__ import annotations

import logging
from typing import Mapping

import numpy as np
import torch

logger = logging.getLogger(__name__)


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
    inverse of ``surgical_tpu.models.convert.import_evp_state_dict``, for
    every ``BackboneConfig``: the prompt generator's modules of any input
    type, adaptor mode and tuning subset (``bimask_pos_embed`` transposed
    to [3, H, W]), no flow encoder or cross-attention without flow, linears
    without bias."""
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
    for key, p in params.get(P, {}).items():
        if key == "bimask_pos_embed":  # flax [H, W, 3] -> the reference's [3, H, W]
            sd[f"{P}.{key}"] = np.asarray(p).transpose(2, 0, 1)
        elif key.startswith("handcrafted_generator"):
            _put_conv(sd, f"{P}.{key}.proj", p["proj"])
            _put_ln(sd, f"{P}.{key}.norm", p["norm"])
        elif key.startswith("lightweight_mlp"):
            _put_dense(sd, f"{P}.{key}.0", p)
        elif key.startswith(("fully_shared_mlp", "fully_unshared_mlp")):
            # flax {name}_0 / {name}_1 -> torch Sequential {name}.0 / {name}.2
            base, layer = key.rsplit("_", 1)
            _put_dense(sd, f"{P}.{base}.{2 * int(layer)}", p)
        else:  # embedding_generator{s}, shared_mlp{s}
            _put_dense(sd, f"{P}.{key}", p)

    if "flow_encoder" in params:
        fe, fs = params["flow_encoder"], batch_stats["flow_encoder"]
        for i in (1, 2, 3, 4):
            _put_conv(sd, f"flow_encoder.conv{i}", fe[f"conv{i}"])
            _put_bn(sd, f"flow_encoder.bn{i}", fe[f"bn{i}"], fs[f"bn{i}"])

    for name in ("cross_attn_s3", "cross_attn_s4"):
        if name not in params:
            continue
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


def export_dual_tower_mstcn_state_dict(params: Mapping, stages: int, layers: int) -> dict:
    """JAX ``DualTowerMSTCN`` params -> the reference ``MultiStageModel``
    layout (mstcn.py:14-72) without its unused ``stage1_phase_ant``:
    ``stage1_phase``, ``stages_phase.{s}``, ``stages_phase_ant.{s}``."""
    sd = {}
    for tower in ("stages_phase", "stages_phase_ant"):
        sub = {"stage_0": params["stage1_phase"],
               **{f"stage_{s + 1}": params[f"{tower}_{s}"] for s in range(stages - 1)}}
        for k, v in export_mstcn_state_dict(sub, stages, layers).items():
            sd[f"{tower}.{k.removeprefix('stages.')}" if k.startswith("stages.") else k] = v
    return sd


def export_adaptor_state_dict(params: Mapping) -> dict:
    """JAX ``Adaptor`` params -> the reference ``Adaptor`` layout
    (adapter_transformer.py:241-288): ``lightweight_mlp``, ``shared_mlp``."""
    sd = {}
    for name in ("lightweight_mlp", "shared_mlp"):
        _put_dense(sd, name, params[name])
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


def refiner_state_dict(params: Mapping, n_layers: int = 1) -> dict:
    """JAX ``RefinementTransformer`` params -> the port refiner's state dict,
    every parameter: the reference-layout keys of ``export_refiner_state_dict``
    plus each attention block's and FFN's ``layernorm.weight`` / ``.bias``
    (the key JAX's importer reads) and the FFN's ``fc.0.bias`` /
    ``fc.2.bias``, at whatever values JAX's training left them."""
    sd = {"fc.weight": np.asarray(params["fc"]["kernel"]).T}

    def put_ln(pre, p):
        sd[f"{pre}.layernorm.weight"] = np.asarray(p["ln"]["scale"])
        sd[f"{pre}.layernorm.bias"] = np.asarray(p["ln"]["bias"])

    def put_attn(pre, p):
        for ours, theirs in (("W_Q", "w_q"), ("W_K", "w_k"), ("W_V", "w_v"), ("fc", "w_o")):
            sd[f"{pre}.{ours}.weight"] = np.asarray(p[theirs]["kernel"]).T
        put_ln(pre, p)

    def put_ffn(pre, p):
        _put_dense(sd, f"{pre}.fc.0", p["fc1"])
        _put_dense(sd, f"{pre}.fc.2", p["fc2"])
        put_ln(pre, p)

    t = params["transformer"]
    for i in range(n_layers):
        enc, dec = f"transformer.encoder.layers.{i}", f"transformer.decoder.layers.{i}"
        put_attn(f"{enc}.enc_self_attn", t[f"enc_{i}"]["self_attn"])
        put_ffn(f"{enc}.pos_ffn", t[f"enc_{i}"]["ffn"])
        put_attn(f"{dec}.dec_self_attn", t[f"dec_{i}"]["self_attn"])
        put_attn(f"{dec}.dec_enc_attn", t[f"dec_{i}"]["cross_attn"])
        put_ffn(f"{dec}.pos_ffn", t[f"dec_{i}"]["ffn"])
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


def _put_raft_encoder(sd, enc, p, batch_norm: bool):
    """BasicEncoder: conv1, three 2-unit residual layers, conv2; BatchNorm
    (``FrozenBatchNorm``'s scale / bias / mean / var) only in ``cnet``, the
    instance norms of ``fnet`` have no state."""
    _put_conv(sd, f"{enc}.conv1", p["conv1"])
    _put_conv(sd, f"{enc}.conv2", p["conv2"])
    if batch_norm:
        _put_bn(sd, f"{enc}.norm1", p["norm1"], p["norm1"])
    for L in (1, 2, 3):
        for b in (0, 1):
            u, pre = p[f"layer{L}_{b}"], f"{enc}.layer{L}.{b}"
            _put_conv(sd, f"{pre}.conv1", u["conv1"])
            _put_conv(sd, f"{pre}.conv2", u["conv2"])
            if batch_norm:
                _put_bn(sd, f"{pre}.norm1", u["norm1"], u["norm1"])
                _put_bn(sd, f"{pre}.norm2", u["norm2"], u["norm2"])
            if "downsample" in u:
                _put_conv(sd, f"{pre}.downsample.0", u["downsample"])
                if batch_norm:
                    _put_bn(sd, f"{pre}.downsample.1", u["norm3"], u["norm3"])


def export_raft_state_dict(params: Mapping) -> dict:
    """JAX ``RAFT`` params (the bare tree) -> the upstream ``raft-things``
    key state dict that the port's ``RAFT.load_state_dict`` takes: the
    inverse of ``surgical_tpu.models.convert.import_raft_state_dict``
    (flax conv kernels [kh, kw, in, out] to [out, in, kh, kw];
    ``FrozenBatchNorm`` to ``weight`` / ``bias`` / ``running_mean`` /
    ``running_var`` + ``num_batches_tracked``)."""
    sd: dict = {}
    _put_raft_encoder(sd, "fnet", params["fnet"], batch_norm=False)
    _put_raft_encoder(sd, "cnet", params["cnet"], batch_norm=True)
    ub, pre = params["update_block"], "update_block"
    for k in ("convc1", "convc2", "convf1", "convf2", "conv"):
        _put_conv(sd, f"{pre}.encoder.{k}", ub["encoder"][k])
    for g in "zrq":
        for suffix, i in (("h", 1), ("v", 2)):
            _put_conv(sd, f"{pre}.gru.conv{g}{i}", ub["gru"][f"conv{g}_{suffix}"])
    _put_conv(sd, f"{pre}.flow_head.conv1", ub["flow_head1"])
    _put_conv(sd, f"{pre}.flow_head.conv2", ub["flow_head2"])
    _put_conv(sd, f"{pre}.mask.0", ub["mask1"])
    _put_conv(sd, f"{pre}.mask.2", ub["mask2"])
    return sd


def to_torch(sd: Mapping) -> dict:
    """numpy state dict -> torch tensors (copies, contiguous)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def load_evp_params(model, params: Mapping, batch_stats: Mapping) -> None:
    """Load JAX ``MiTEVP`` weights into a port ``MiTEVP`` (strict)."""
    model.load_state_dict(to_torch(export_evp_state_dict(params, batch_stats)), strict=True)


def load_raft_params(model, params: Mapping) -> None:
    """Load JAX ``RAFT`` params (the bare tree) into a port ``RAFT``."""
    model.load_state_dict(to_torch(export_raft_state_dict(params)), strict=True)


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


def load_dual_tower_mstcn(model, sd: Mapping) -> list[str]:
    """Load a reference ``MultiStageModel`` state dict into a port
    ``DualTowerMSTCN`` (strict on every other key). Its ``stage1_phase_ant.*``
    keys belong to a stage the reference never calls and the port does not
    build: they are dropped, named in a log line, and returned."""
    dropped = sorted(k for k in sd if k.startswith("stage1_phase_ant."))
    if dropped:
        logger.info("DualTowerMSTCN: dropped %d keys of the unused stage1_phase_ant: %s",
                    len(dropped), ", ".join(dropped))
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()
                           if k not in dropped}, strict=True)
    return dropped


def load_refiner_params(model, params: Mapping) -> None:
    """Load JAX ``RefinementTransformer`` params into the port's through the
    reference layout (``export_refiner_state_dict``), which asserts that the
    LayerNorms are identity and the FFN biases zero: JAX's init.
    ``load_trained_refiner_params`` takes any params."""
    sd = export_refiner_state_dict(params, model.cfg.n_layers)
    model.load_state_dict(to_torch(sd), strict=True)


def load_trained_refiner_params(model, params: Mapping) -> None:
    """Load JAX ``RefinementTransformer`` params into the port's, every
    parameter as it is (``refiner_state_dict``): a refiner that JAX's
    ``train-refiner`` has trained."""
    model.load_state_dict(to_torch(refiner_state_dict(params, model.cfg.n_layers)), strict=True)


def load_mamba_params(model, params: Mapping) -> None:
    """Load JAX ``CausalMambaModel`` params into the port's."""
    sd = export_mamba_state_dict(params, model.cfg.layers)
    model.load_state_dict(to_torch(sd), strict=True)


def infer_mstcn_dims(sd: Mapping[str, np.ndarray]) -> dict:
    """Model dims of a reference ``MultiStageModel_S`` checkpoint, read off
    the state dict itself so ``reference-parity`` needs no dim flags
    (trans_SV_output.py:196-201 hardcodes stages=2 layers=8 f_maps=32
    f_dim=2048; training used f_maps=64, tecno.py:105)."""
    layers = sum(1 for k in sd if k.startswith("stage1_phase.layers.")
                 and k.endswith(".conv_dilated.weight"))
    stages = 1 + len({k.split(".")[1] for k in sd if k.startswith("stages.")})
    f_maps, f_dim, _ = np.asarray(sd["stage1_phase.conv_1x1.weight"]).shape
    out_features = np.asarray(sd["stage1_phase.conv_out_classes.weight"]).shape[0]
    return {"stages": stages, "layers": layers, "f_maps": int(f_maps),
            "f_dim": int(f_dim), "out_features": int(out_features)}


def infer_refiner_dims(sd: Mapping[str, np.ndarray]) -> dict:
    """Model dims of a reference refiner checkpoint (``Transformer`` wrapper,
    trans_SV_output.py:205-211). Uses the reference invariant
    ``d_k = min(64, d_ff)`` (adapter_transformer.py:315) to split the fused
    W_Q width into n_heads."""
    n_layers = len({k.split(".")[3] for k in sd
                    if k.startswith("transformer.encoder.layers.")})
    d_ff, d_model = np.asarray(
        sd["transformer.encoder.layers.0.pos_ffn.fc.0.weight"]).shape
    out_features, f_dim = np.asarray(sd["fc.weight"]).shape
    d_k = min(64, int(d_ff))
    wq = np.asarray(sd["transformer.encoder.layers.0.enc_self_attn.W_Q.weight"])
    assert wq.shape[0] % d_k == 0, (wq.shape, d_k)
    return {"n_layers": int(n_layers), "f_maps": int(d_ff), "f_dim": int(f_dim),
            "out_features": int(out_features), "n_heads": int(wq.shape[0] // d_k)}
