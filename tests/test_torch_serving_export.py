"""The port's deployment export (``surgical_tpu_torch/serving/export.py``, the
serving kernels as custom ops in ``kernels/ops.py``, ``cli export-serving``)
on the CPU at the tiny preset on 64-px wire frames, one torch thread.

Stated bounds:
- each artifact's outputs equal the eager path it was exported from bit for
  bit: the flax graph at bf16 (``WireForward``, as extraction runs it),
  features and ``--logits``, flow on and off; the fused graph at B = 8 (the
  ops' CPU implementations, stage 4 on the stage op); the streaming MS-TCN,
  Mamba and refiner steps over 8 frames, state threaded through;
- the flax artifact against the JAX package's ``MiTEVP.apply`` at bf16 on the
  same weights (JAX's from a seeded port model through the JAX importer, as
  in tests/test_torch_mit_graph.py) at tests/test_serving_export.py's
  rtol = atol = 2e-2;
- the step artifacts against JAX's ``_step_impl`` (jitted) on the same
  weights (carried by the JAX importers) at rtol = atol = 1e-5;
- a fresh process loads a flax artifact with ``torch`` alone: no module of
  ``surgical_tpu_torch.models``, ``surgical_tpu_torch.kernels`` or JAX is
  imported by the load and the call;
- ``load_artifact`` refuses an artifact whose platform is absent;
- ``torch.library.opcheck`` passes for the three ops' CPU implementations;
- ``cli export-serving --device cpu``: the manifest's meta keys are those of
  the JAX CLI's (read from its source: running the JAX verb takes a flax
  init, ~60 s here), the artifact equals the eager graph on the
  ``--pretrained-evp`` weights, and a ``--work`` without a checkpoint exits.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surgical_tpu.core.config import (BackboneConfig, HeadConfig, MambaConfig, MSTCNConfig,
                                      RefinerConfig)
from surgical_tpu.models.convert import (import_mamba_state_dict, import_mstcn_state_dict,
                                         import_refiner_state_dict)
from surgical_tpu.models.mamba import CausalMambaModel as JaxMamba
from surgical_tpu.models.mit_evp import MiTEVP as JaxMiTEVP
from surgical_tpu.models.mstcn import MultiStageTCN as JaxMSTCN
from surgical_tpu.models.transsv import RefinementTransformer as JaxRefiner
from surgical_tpu.serving import online as jonline
from surgical_tpu_torch import cli
from surgical_tpu_torch.kernels import mit_block as mb
from surgical_tpu_torch.kernels import ops
from surgical_tpu_torch.models.mamba import CausalMambaModel
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.models.mstcn import MultiStageTCN
from surgical_tpu_torch.models.transsv import RefinementTransformer
from surgical_tpu_torch.serving.export import (export_feature_extractor, export_online_refiner,
                                               export_online_temporal, load_artifact,
                                               save_artifact)
from surgical_tpu_torch.serving.online import OnlineMamba, OnlineMSTCN, OnlineRefiner
from surgical_tpu_torch.train.extract import WireForward
from test_torch_mit_graph import jax_variables, port_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, B, FUSED_B, FRAMES = 64, 2, 8, 8
HEAD = HeadConfig(embedding_dim=32, hidden=16)
JAX_TOL = 2e-2
STEP_TOL = 1e-5
MSTCN = MSTCNConfig(stages=2, layers=3, f_maps=8, f_dim=12)
MAMBA = MambaConfig(layers=2, d_model=8, f_dim=12, d_state=4, d_conv=3, dropout=0.0)
REFINER = RefinerConfig(f_maps=8, f_dim=16, len_q=4)


def cfg(with_flow):
    return BackboneConfig.preset("tiny", img_size=S, with_flow=with_flow)


def wire(batch, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (batch, S, S, 3), dtype=np.uint8),
            rng.integers(0, 256, (batch, S, S, 1), dtype=np.uint8),
            rng.standard_normal((batch, S, S, 2)).astype(np.float16))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def evp():
    """{with_flow: (JAX variables, port model)} on the same weights."""
    out = {}
    for flow in (True, False):
        variables = jax_variables(cfg(flow), HEAD, seed=1)
        out[flow] = (variables, port_model(cfg(flow), HEAD, variables))
    return out


@pytest.fixture(scope="module")
def flax_artifact(evp, tmp_path_factory):
    """A flax artifact of the flow model, features at B = 2, and its eager
    output on its inputs."""
    _, model = evp[True]
    d = str(tmp_path_factory.mktemp("flax") / "art")
    save_artifact(d, export_feature_extractor(model, B, size=S), meta={"variant": "tiny"})
    inputs = wire(B, seed=2)
    return d, inputs, _eager(model, False, True, inputs)


def _round_trip(tmp_path, name, exported, meta=None):
    save_artifact(str(tmp_path / name), exported, meta)
    return load_artifact(str(tmp_path / name))


def _eager(model, use_fused, features, inputs):
    with torch.no_grad():
        out = WireForward(model, use_fused, features=features, out_dtype=torch.float32)(
            *(None if a is None else torch.from_numpy(a) for a in inputs))
    return (out,) if features else out


def _jax_apply(variables, with_flow, inputs, features):
    """JAX's flax graph at bf16 on the wire inputs, dequantized as
    tests/test_serving_export.py does."""
    from surgical_tpu.core.config import CHOLEC80_MEAN, CHOLEC80_STD

    img, seg, flow = inputs
    mean = (np.asarray(CHOLEC80_MEAN) * 255.0).astype(np.float32)
    std = (np.asarray(CHOLEC80_STD) * 255.0).astype(np.float32)
    imgf = jnp.asarray((img.astype(np.float32) - mean) / std).astype(jnp.bfloat16)
    segf = jnp.broadcast_to(jnp.asarray((seg.astype(np.float32) - mean) / std
                                        ).astype(jnp.bfloat16), imgf.shape)
    flowf = None if flow is None else jnp.asarray(flow).astype(jnp.bfloat16)
    model = JaxMiTEVP(cfg(with_flow), HEAD, compute_dtype=jnp.bfloat16)
    out = jax.jit(lambda v, i, s, f: model.apply(v, i, s, f, return_features=features))(
        variables, imgf, segf, flowf)
    return tuple(np.asarray(o, np.float32) for o in ((out,) if features else out))


@pytest.mark.parametrize("with_flow,features", [(True, True), (False, False), (True, False),
                                               (False, True)])
def test_flax_artifact_equals_eager(evp, flax_artifact, tmp_path, with_flow, features):
    """Bit for bit against the eager graph; against JAX's flax graph for
    features with flow and logits without (tests/test_serving_export.py's
    two cases)."""
    variables, model = evp[with_flow]
    if (with_flow, features) == (True, True):
        d, inputs, want = flax_artifact
        fn = load_artifact(d)
    else:
        inputs = wire(B, seed=3)
        if not with_flow:
            inputs = inputs[:2] + (None,)
        fn = _round_trip(tmp_path, "art", export_feature_extractor(
            model, B, size=S, features=features), meta={"variant": "tiny"})
        d, want = str(tmp_path / "art"), _eager(model, False, features, inputs)
    got = fn(*(a for a in inputs if a is not None))
    got = (got,) if features else got
    assert len(got) == len(want) == (1 if features else 2)
    for g, w in zip(got, want):
        assert not g.requires_grad and g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if with_flow == features:
        for g, w in zip(got, _jax_apply(variables, with_flow, inputs, features)):
            np.testing.assert_allclose(g.numpy(), w, rtol=JAX_TOL, atol=JAX_TOL)
    m = fn.manifest
    assert m["platforms"] == ["cpu"] and m["variant"] == "tiny" and not m["surgical_tpu_ops"]
    assert m["in_avals"][:2] == [f"uint8[{B},{S},{S},3]", f"uint8[{B},{S},{S},1]"]
    assert len(m["in_avals"]) == (3 if with_flow else 2)
    assert m["out_avals"] == ([f"float32[{B},32]"] if features else [f"float32[{B},7]"] * 2)
    assert m["bytes"] == os.path.getsize(os.path.join(d, "serving_graph.pt2"))


def test_with_flow_must_agree_with_the_model(evp):
    with pytest.raises(ValueError, match="contradicts model.cfg.with_flow"):
        export_feature_extractor(evp[True][1], B, size=S, with_flow=False)


def test_fused_artifact_runs_the_ops_and_equals_eager(evp, tmp_path):
    """B = 8 takes stage 4's whole-stage route: the program holds the block
    and stage ops and its kernel-layout weights, and equals eager
    ``fused_forward`` bit for bit."""
    _, model = evp[True]
    inputs = wire(FUSED_B, seed=4)
    fn = _round_trip(tmp_path, "fused", export_feature_extractor(
        model, FUSED_B, size=S, use_fused=True))
    assert fn.manifest["surgical_tpu_ops"]
    targets = [str(n.target) for g in (m.graph for m in fn.exported.graph_module.modules()
                                       if isinstance(m, torch.fx.GraphModule))
               for n in g.nodes if n.op == "call_function"]
    blocks = sum(cfg(True).depths[:3])
    assert targets.count("surgical_tpu.mit_block_forward.default") == blocks
    assert targets.count("surgical_tpu.mit_stage_forward.default") == 1
    weights = [k for k in fn.exported.state_dict if k.startswith("kernel_weight")]
    assert weights and all(fn.exported.state_dict[k].dtype in (torch.bfloat16, torch.float32)
                           for k in weights)
    mb.reset_launches()
    got = fn(*inputs)
    torch.testing.assert_close(got, _eager(model, True, True, inputs)[0], rtol=0, atol=0)
    assert mb.fused_mit_block.launches == mb.fused_mit_stage.launches == 0  # CPU: no kernel


def _jax_temporal(kind, port):
    sd = {n: v.numpy() for n, v in port.state_dict().items()}
    if kind == "mstcn":
        return jonline.OnlineMSTCN(JaxMSTCN(MSTCN), import_mstcn_state_dict(
            sd, MSTCN.stages, MSTCN.layers))
    return jonline.OnlineMamba(JaxMamba(MAMBA), import_mamba_state_dict(sd, MAMBA.layers))


@pytest.mark.parametrize("kind", ["mstcn", "mamba"])
def test_temporal_step_artifact_equals_eager_and_matches_jax(tmp_path, kind):
    from torch.utils._pytree import tree_leaves

    port = (MultiStageTCN(MSTCN, seed=1, device="cpu") if kind == "mstcn"
            else CausalMambaModel(MAMBA, seed=2, device="cpu"))
    online = (OnlineMSTCN if kind == "mstcn" else OnlineMamba)(port)
    fn = _round_trip(tmp_path, kind, export_online_temporal(online, MSTCN.f_dim),
                     meta={"model": kind})
    jon = _jax_temporal(kind, port)
    jstep = jax.jit(jon._step_impl)
    rng = np.random.default_rng(5)
    flat, state, jstate = tree_leaves(online.init_state()), online.init_state(), jon.init_state()
    assert fn.manifest["in_avals"][-1] == f"float32[{MSTCN.f_dim}]"
    for _ in range(FRAMES):
        x = rng.standard_normal(MSTCN.f_dim).astype(np.float32)
        out = fn(*flat, x)
        flat, logits = list(out[:-1]), out[-1]
        state, want = online.step(state, torch.from_numpy(x))
        torch.testing.assert_close(logits, want, rtol=0, atol=0)
        for a, b in zip(flat, tree_leaves(state)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        jstate, jlogits = jstep(jstate, jnp.asarray(x))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=STEP_TOL,
                                   atol=STEP_TOL)


def test_refiner_step_artifact_equals_eager_and_matches_jax(tmp_path):
    port = RefinementTransformer(REFINER, seed=3, device="cpu")
    online = OnlineRefiner(port)
    fn = _round_trip(tmp_path, "refiner", export_online_refiner(online))
    sd = {n: v.numpy() for n, v in port.state_dict().items()}
    jon = jonline.OnlineRefiner(JaxRefiner(REFINER), import_refiner_state_dict(
        sd, REFINER.n_layers))
    jstep = jax.jit(jon._step_impl)
    rng = np.random.default_rng(7)
    buf, state, jbuf = online.init_state(), online.init_state(), jon.init_state()
    for _ in range(FRAMES):
        g = rng.standard_normal(REFINER.out_features).astype(np.float32)
        lfb = rng.standard_normal(REFINER.f_dim).astype(np.float32)
        buf, refined = fn(buf, g, lfb)
        state, want = online.step(state, torch.from_numpy(g), torch.from_numpy(lfb))
        torch.testing.assert_close(refined, want, rtol=0, atol=0)
        torch.testing.assert_close(buf, state, rtol=0, atol=0)
        jbuf, jref = jstep(jbuf, jnp.asarray(g), jnp.asarray(lfb))
        np.testing.assert_allclose(refined.numpy(), np.asarray(jref), rtol=STEP_TOL,
                                   atol=STEP_TOL)


_LOADER = """
import json, sys
import numpy as np
before = set(sys.modules)
from surgical_tpu_torch.serving.export import load_artifact
fn = load_artifact(sys.argv[1])
out = fn(*(np.load(p) for p in sys.argv[2:]))
np.save(sys.argv[1] + "/out.npy", out.numpy())
new = sorted(set(sys.modules) - before)
print(json.dumps({"new": new, "models": [m for m in sys.modules
                                         if m.startswith("surgical_tpu_torch.models")]}))
"""


def test_flax_artifact_loads_in_a_process_with_torch_alone(flax_artifact, tmp_path):
    art, inputs, want = flax_artifact
    shutil.copytree(art, tmp_path / "art")
    paths = []
    for i, a in enumerate(inputs):
        paths.append(str(tmp_path / f"in{i}.npy"))
        np.save(paths[-1], a)
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _LOADER, str(tmp_path / "art"), *paths],
                          capture_output=True, text=True, env=env, cwd=str(tmp_path),
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["models"] == []
    bad = [m for m in report["new"] if m.split(".")[0] in ("jax", "flax", "surgical_tpu")
           or m.startswith(("surgical_tpu_torch.models", "surgical_tpu_torch.kernels",
                            "surgical_tpu_torch.train"))]
    assert not bad and "surgical_tpu_torch.serving.export" in report["new"], report["new"]
    np.testing.assert_array_equal(np.load(str(tmp_path / "art" / "out.npy")), want[0].numpy())


@pytest.mark.parametrize("platform", ["cuda", "tpu"])
def test_load_refuses_an_absent_platform(flax_artifact, tmp_path, monkeypatch, platform):
    d = tmp_path / "art"
    shutil.copytree(flax_artifact[0], d)
    m = json.loads((d / "manifest.json").read_text())
    (d / "manifest.json").write_text(json.dumps({**m, "platforms": [platform]}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=f"runs on '?{platform}"):
        load_artifact(str(d))


def _op_cases():
    rng = np.random.default_rng(8)
    f = lambda *s: torch.from_numpy(0.1 * rng.standard_normal(s).astype(np.float32)).to(
        torch.bfloat16)
    Bb, side, C, hidden, Nkv = 2, 8, 64, 256, 4
    w = {"ln1_scale": f(C), "ln1_bias": f(C), "wq": f(C, C), "bq": f(C), "wo": f(C, C),
         "bo": f(C), "ln2_scale": f(C), "ln2_bias": f(C), "w1": f(C, hidden), "b1": f(hidden),
         "wdw": f(9, hidden), "bdw": f(hidden), "w2": f(hidden, C), "b2": f(C)}
    x, k, v = f(Bb, side * side, C), f(Bb, Nkv, C), f(Bb, Nkv, C)
    D, sr, Cb, C4 = 2, 2, 16, 32
    sw = {"ln1": f(D, 2, C), "wkv": f(D, C, 2 * C), "bkv": f(D, 1, 2 * C), "wq": f(D, C, C),
          "bq": f(D, 1, C), "wo": f(D, C, C), "bo": f(D, 1, C), "ln2": f(D, 2, C),
          "w1": f(D, C, hidden), "b1": f(D, 1, hidden), "wdw": f(D, 9, hidden),
          "bdw": f(D, 1, hidden), "w2": f(D, hidden, C), "b2": f(D, 1, C),
          "srw": f(D, sr * sr * C, C), "srb": f(D, 1, C), "lnkv": f(D, 2, C),
          "sharedw": f(C4, C), "sharedb": f(1, C), "lww": f(D, Cb, C4), "lwb": f(D, 1, C4)}
    base = f(Bb, side * side, Cb)
    packed = mb.pack_weights2(w)
    return {
        "mit_block_forward": (
            ops.mit_block_forward, (x, k, v, ops.as_list(w, ops.BLOCK_KEYS), 1, side, side),
            lambda: mb.fused_mit_block_plain(x, k, v, w, heads=1, H=side, W=side)),
        "mit_block_packed2_forward": (
            ops.mit_block_packed2_forward,
            (x, k, v, ops.as_list(packed, ops.PACKED2_KEYS), side, side, 2),
            lambda: mb.fused_mit_block_packed2_plain(x, k, v, packed, H=side, W=side,
                                                     row_chunks=2)),
        "mit_stage_forward": (
            ops.mit_stage_forward, (x, base, ops.as_list(sw, ops.stage_keys(sr, True)), 1,
                                    side, side, sr),
            lambda: mb.fused_mit_stage_plain(x, base, sw, heads=1, H=side, W=side, sr=sr)),
        "mit_stage_forward_plain_prompt": (
            ops.mit_stage_forward, (x, None, ops.as_list(sw, ops.stage_keys(1, False)), 1,
                                    side, side, 1),
            lambda: mb.fused_mit_stage_plain(x, None, sw, heads=1, H=side, W=side, sr=1)),
    }


@pytest.mark.parametrize("name", ["mit_block_forward", "mit_block_packed2_forward",
                                  "mit_stage_forward", "mit_stage_forward_plain_prompt"])
def test_ops_pass_opcheck_and_run_the_plain_versions_on_the_cpu(name):
    op, args, plain = _op_cases()[name]
    torch.library.opcheck(op, args)
    torch.testing.assert_close(op(*args), plain(), rtol=0, atol=0)


def _jax_cli_meta_keys():
    """The keys of the ``meta=`` dict that the JAX CLI's export-serving
    passes to ``save_artifact`` (surgical_tpu/cli.py)."""
    tree = ast.parse(open(os.path.join(REPO, "surgical_tpu", "cli.py")).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "cmd_export_serving")
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "save_artifact")
    meta = next(k.value for k in call.keywords if k.arg == "meta")
    return {k.value for k in meta.keys}


def test_cli_export_serving(tmp_path, capsys):
    model = MiTEVP(cfg(True), HEAD, seed=9, device="cpu")
    pth = str(tmp_path / "evp.pth")
    torch.save(model.state_dict(), pth)
    out = str(tmp_path / "art")
    flags = ["--variant", "tiny", "--batch-size", str(B), "--size", str(S), "--device", "cpu"]
    assert cli.main(["export-serving", "--out", out, "--pretrained-evp", pth, *flags]) == 0
    assert "wrote serving artifact" in capsys.readouterr().out
    fn = load_artifact(out)
    own = {"platforms", "in_avals", "out_avals", "bytes", "torch", "surgical_tpu_ops"}
    assert set(fn.manifest) - own == _jax_cli_meta_keys()
    assert fn.manifest["checkpoint_step"] is None and fn.manifest["pretrained_evp"] == pth
    assert (fn.manifest["output"], fn.manifest["fused"]) == ("features", False)
    inputs = wire(B, seed=10)
    # the CLI builds the tiny preset at its own img_size; the graph reads the
    # frames' size
    ref = MiTEVP(BackboneConfig.preset("tiny"), HEAD, device="cpu")
    ref.load_state_dict(torch.load(pth))
    torch.testing.assert_close(fn(*inputs), _eager(ref, False, True, inputs)[0], rtol=0,
                               atol=0)
    with pytest.raises(SystemExit, match="no backbone checkpoint"):
        cli.main(["export-serving", "--out", str(tmp_path / "art2"), "--work",
                  str(tmp_path / "empty_work"), *flags])
    assert cli.main(["export-serving", "--out", str(tmp_path / "art3"), "--logits",
                     "--fused", "--no-flow", *flags]) == 0
    assert "RANDOM init" in capsys.readouterr().err
    m = json.loads(open(os.path.join(tmp_path, "art3", "manifest.json")).read())
    assert (m["output"], m["fused"], m["with_flow"], m["surgical_tpu_ops"]) == (
        "logits", True, False, True)
    shutil.rmtree(tmp_path / "art3")
