"""Deployment export: the serving graph as a self-contained ``torch.export``
artifact, loadable without the model code.

Port of ``surgical_tpu/serving/export.py``. The whole serving computation
(the wire-format dequant and normalization, then the frozen MiT-EVP forward
with its weights in the program) exports to one blob that a process with
``torch`` alone can run:

    ep = export_feature_extractor(model, batch_size=128)
    save_artifact("serving/", ep, meta={"variant": "b3"})
    ...
    fn = load_artifact("serving/")          # imports no model code
    feats = fn(img_u8, seg_u8, flow_f16)    # [B, 2048]

With ``export_online_temporal`` and ``export_online_refiner`` the streaming
MS-TCN or Mamba step and the refiner step export the same way, so frame-in /
phase-out serving runs as three model-code-free artifacts.

By default the portable flax graph is exported (plain PyTorch). With
``use_fused=True`` the fused serving graph is, with the hand-written Hopper
kernels inside it as the custom ops of ``kernels/ops.py``: such an artifact
needs that module at load time (``load_artifact`` imports it when the
manifest says so) and runs on the card it was exported for, as JAX's
Mosaic-bound artifact runs only on its TPU generation. An artifact is bound
to the device it was exported on; the loader refuses one whose device is
absent and never moves it elsewhere.

This module imports only ``torch`` when it is imported; the export functions
import the model code they need.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

_BLOB = "serving_graph.pt2"
_MANIFEST = "manifest.json"
_OPS_NAMESPACE = "surgical_tpu"


def _export(module, args):
    """``torch.export.export`` without the example inputs in the program:
    they are zeros of the call's shapes, and a saved artifact would carry
    them (80 MB at B = 200, 224 px)."""
    exported = torch.export.export(module, tuple(args))
    exported.example_inputs = None
    return exported


def export_feature_extractor(model, batch_size: int, *, size: int = 224,
                             with_flow: Optional[bool] = None, features: bool = True,
                             use_fused: bool = False, d2h_dtype=torch.float32):
    """Export the wire-format serving forward of a port ``MiTEVP`` with its
    weights in the program.

    Inputs of the exported program: uint8 image [B, S, S, 3], uint8 segmap
    [B, S, S, 1], float16 flow [B, S, S, 2] (omitted when there is no flow).
    Output: [B, E] features in ``d2h_dtype`` (``features=True``, the
    extraction contract) or (phase logits, anticipation logits).
    ``use_fused``: the fused serving graph on the kernels' custom ops, whose
    kernel-layout weights the program holds, laid out once here; else the
    flax graph at bf16. Runs on the model's device.

    ``with_flow`` defaults to ``model.cfg.with_flow``; a value that
    contradicts it raises: a flow model exported without the flow input
    would skip the flow cross-attention."""
    from surgical_tpu_torch.train.extract import WireForward

    cfg_flow = bool(model.cfg.with_flow)
    if with_flow is None:
        with_flow = cfg_flow
    elif bool(with_flow) != cfg_flow:
        raise ValueError(
            f"with_flow={with_flow} contradicts model.cfg.with_flow={cfg_flow}: the exported "
            "graph would not match the weights (rebuild the model with the intended "
            "with_flow instead)")
    serve = WireForward(model, use_fused, features=features, out_dtype=d2h_dtype,
                        hold_kernel_weights=True)
    device = next(model.parameters()).device
    B, S = batch_size, size
    args = [torch.zeros(B, S, S, 3, dtype=torch.uint8, device=device),
            torch.zeros(B, S, S, 1, dtype=torch.uint8, device=device)]
    if with_flow:
        args.append(torch.zeros(B, S, S, 2, dtype=torch.float16, device=device))
    return _export(serve, args)


class _TemporalStep(torch.nn.Module):
    """fn(*state leaves, feat) -> (*new state leaves, logits) over an
    ``OnlineMSTCN`` / ``OnlineMamba``."""

    def __init__(self, online):
        super().__init__()
        from torch.utils._pytree import tree_flatten

        self.model, self.online = online.model, online
        self.spec = tree_flatten(online.init_state())[1]

    def forward(self, *args):
        from torch.utils._pytree import tree_leaves, tree_unflatten

        state, logits = self.online.step(tree_unflatten(list(args[:-1]), self.spec), args[-1])
        return (*tree_leaves(state), logits)


class _RefinerStep(torch.nn.Module):
    def __init__(self, online):
        super().__init__()
        self.model, self.online = online.model, online

    def forward(self, buf, g_t, lfb_t):
        return self.online.step(buf, g_t, lfb_t)


def export_online_temporal(online, feat_dim: int):
    """Export a streaming temporal step (``serving/online.py``'s
    ``OnlineMSTCN`` or ``OnlineMamba``): fn(*state leaves, feat [feat_dim]
    fp32) -> (*new state leaves, logits), the state's leaves in the order of
    ``torch.utils._pytree.tree_leaves(online.init_state())``, whose zeros
    are the initial state."""
    from torch.utils._pytree import tree_leaves

    state0 = tree_leaves(online.init_state())
    feat = torch.zeros(feat_dim, dtype=torch.float32, device=state0[0].device)
    return _export(_TemporalStep(online), (*state0, feat))


def export_online_refiner(online):
    """Export the streaming refiner step (``serving/online.py``'s
    ``OnlineRefiner``): fn(buffer, g_t, lfb_t) -> (buffer', refined). The
    feature width comes from the refiner's config."""
    buf0 = online.init_state()
    dev = buf0.device
    args = (buf0, torch.zeros(online.cfg.out_features, device=dev),
            torch.zeros(online.cfg.f_dim, device=dev))
    return _export(_RefinerStep(online), args)


def _aval(v) -> str:
    """A tensor's type in JAX's aval form: ``uint8[2,64,64,3]``."""
    return f"{str(v.dtype).removeprefix('torch.')}[{','.join(map(str, v.shape))}]"


def _graphs(exported):
    """Every FX graph of the program, the subgraphs of higher-order ops
    (a ``torch.no_grad`` region becomes one) included."""
    return [m.graph for m in exported.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule)]


def _describe(exported) -> dict:
    """The manifest's description of a program: its platform (the device of
    its inputs), input and output types, and whether it calls this
    package's custom ops."""
    sig = exported.graph_signature
    nodes = {n.name: n for n in exported.graph.nodes}
    ins = [nodes[name].meta["val"] for name in sig.user_inputs]
    out_node = next(n for n in exported.graph.nodes if n.op == "output")
    outs = [a.meta["val"] for a in out_node.args[0][-len(sig.user_outputs):]]
    holds_ops = any(n.op == "call_function" and str(n.target).startswith(f"{_OPS_NAMESPACE}.")
                    for g in _graphs(exported) for n in g.nodes)
    return {"platforms": sorted({v.device.type for v in ins}),
            "in_avals": [_aval(v) for v in ins], "out_avals": [_aval(v) for v in outs],
            "surgical_tpu_ops": holds_ops}


def save_artifact(directory: str, exported, meta: Optional[dict] = None) -> None:
    """Write ``serving_graph.pt2`` (``torch.export.save``) and
    ``manifest.json`` (JAX's keys: platforms, in_avals, out_avals, bytes;
    the torch version; whether the graph calls ``surgical_tpu::`` ops; then
    ``meta``)."""
    os.makedirs(directory, exist_ok=True)
    blob = os.path.join(directory, _BLOB)
    torch.export.save(exported, blob)
    manifest = {**_describe(exported), "bytes": os.path.getsize(blob),
                "torch": torch.__version__, **(meta or {})}
    with open(os.path.join(directory, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def load_artifact(directory: str):
    """Load a saved artifact; returns fn(*inputs) -> outputs on the
    artifact's device. Inputs may be numpy arrays or tensors, moved to that
    device; the program runs under ``torch.inference_mode()``. Needs only
    ``torch``, and ``surgical_tpu_torch.kernels.ops`` for a graph that
    calls its ops (imported here when the manifest says so). Raises when the
    artifact's device is absent from this process."""
    with open(os.path.join(directory, _MANIFEST)) as f:
        manifest = json.load(f)
    for platform in manifest["platforms"]:
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{directory}: the artifact runs on cuda, and this process has "
                               "no CUDA device (an artifact is not moved to another device)")
        if platform not in ("cpu", "cuda"):
            raise RuntimeError(f"{directory}: the artifact runs on {platform!r}, which this "
                               "loader does not serve")
    if manifest["surgical_tpu_ops"]:
        import surgical_tpu_torch.kernels.ops  # noqa: F401  (registers the ops)
    exported = torch.export.load(os.path.join(directory, _BLOB))
    program = exported.module()
    device = torch.device(manifest["platforms"][0])

    @torch.inference_mode()
    def fn(*args):
        return program(*(torch.as_tensor(a).to(device) for a in args))

    fn.manifest, fn.exported = manifest, exported
    return fn
