"""Jamba as the temporal model (``models/jamba.py``, ``serving/online.py::
OnlineJamba``, ``cli.py --model jamba``) against the benchmark's plain
reference (``portbench/reference/jamba.py``), on the CPU at a tiny size: a
hidden width of 64, 4 layers of which layer 1 is attention (4 query heads,
1 key/value head of width 16), Mamba mixers at d_state 16, d_inner 128,
dt_rank 4, T 300. Weights are drawn as the benchmark draws them
(``traffic/hybrid_video.py::build_temporal``: norm scales about 1, S4D A_log,
mamba_ssm's dt bias). No JAX: the JAX package has no Jamba.

Gap: ``compare.row_gap`` (the cell's ``output_gap``: the worst frame's L2
distance over the larger of its own norm and the median frame's).
Tolerances, with the CPU readings over three seeds: fp32 against the
reference 1e-5 (4.2e-7 to 8.3e-7: summation orders, the scan kernel's plain
version against the reference's step-by-step loop); the bf16 model against
the fp32 reference on the same bf16 weights 0.03 (0.0061 to 0.0088), which the
reference with fp8 products fails (0.081 to 0.19); the streaming steps
against the whole-video forward in fp32 1e-5 (~1e-6).

Also: the mixer with its dt, B, C norms against the reference mixer;
``CausalMambaModel`` and ``OnlineMamba``'s block step bit for bit against
copies of their code before the norms existed; ``OnlineJamba`` over two
videos with a reset equal to the forward, refusing a frame past its
capacity (directly and in a session); the counters; ``train-temporal
--model jamba``, ``train-refiner``, ``predict`` and ``predict --online``
through ``cli.main``, the CLI's Jamba configuration held at the tiny size;
the benchmark's configuration and cell.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from surgical_tpu_torch import cli
from surgical_tpu_torch.core.config import JambaConfig, MambaConfig
from surgical_tpu_torch.kernels import selective_scan as scan_kernel
from surgical_tpu_torch.models import jamba as jamba_model
from surgical_tpu_torch.models.jamba import JambaTemporalModel
from surgical_tpu_torch.models.mamba import CausalMambaModel, MambaBlock, causal_depthwise_conv
from surgical_tpu_torch.serving.online import OnlineJamba, OnlineMamba
from surgical_tpu_torch.serving.temporal_graph import TemporalGraph
from surgical_tpu_torch.utils.trace import counters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "portbench")
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

from harness import compare, core, files, program  # noqa: E402
from reference import jamba as ref  # noqa: E402
from reference.temporal import selective_scan as ref_scan  # noqa: E402
from traffic import hybrid_video  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread per test process: xdist workers share the CPUs

F_DIM, T = 32, 300
TINY = dict(hidden_size=64, num_hidden_layers=4, intermediate_size=96, num_attention_heads=4,
            num_key_value_heads=1, attn_layer_offset=1, attn_layer_period=4, mamba_d_state=16,
            mamba_dt_rank=4, f_dim=F_DIM, out_features=14)
TOL_FP32, TOL_BF16, TOL_STEP = 1e-5, 0.03, 1e-5
SEEDS = (1, 2**40 + 3, 77)
CELL, CONFIG = "jamba2-3b.video", "mit-b3-evp-jamba2-3b"


def tiny_config(dtype="float32") -> dict:
    """The benchmark's configuration with the temporal model at the tiny
    size."""
    c = copy.deepcopy(files.config(CONFIG))
    c["temporal"]["config"].update(TINY, dtype=dtype)
    c["dtype"]["temporal"] = dtype
    c["refiner"]["config"].update(f_dim=F_DIM, f_maps=16)
    return c


def seeded(seed, dtype="float32"):
    """(model, its state dict, the configuration dict) at the tiny size."""
    c = tiny_config(dtype)
    model, sd = hybrid_video.build_temporal(c, seed, torch.device("cpu"))
    return model, sd, c["temporal"]["config"]


def feats(seed, n=T, videos=2):
    g = torch.Generator().manual_seed(seed + 1)
    return torch.randn(videos, n, F_DIM, generator=g).abs() * 0.5


def gap(got, want):
    return compare.row_gap(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]))


def test_tiny_schedule():
    cfg = JambaConfig(**TINY)
    assert cfg.layer_types == ("mamba", "attention", "mamba", "mamba")
    assert JambaConfig().layer_types == tuple("attention" if i in (7, 21) else "mamba"
                                              for i in range(28))
    assert cfg.mamba().d_inner == 128 and cfg.head_dim == 16


@pytest.mark.parametrize("seed", SEEDS)
def test_forward_matches_reference_fp32(seed):
    model, sd, cfg = seeded(seed)
    x = feats(seed)
    with torch.no_grad():
        got = model(x)
    assert got.shape == (1, 2, T, 14) and got.dtype == torch.float32
    assert gap(got[0], ref.forward(sd, cfg, x, ref_scan)) < TOL_FP32


@pytest.mark.parametrize("seed", SEEDS)
def test_forward_bf16_within_tolerance_fp8_control_outside(seed):
    model, sd, cfg = seeded(seed, "bfloat16")
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    x = feats(seed)
    with torch.no_grad():
        got = model(x)[0]
        want = ref.forward(sd, cfg, x, ref_scan)
        control = ref.forward(sd, cfg, x, ref_scan, quant=compare.fp8)
    assert gap(got, want) < TOL_BF16
    assert gap(control, want) > TOL_BF16


def test_mixer_with_norms_matches_reference():
    model, sd, cfg = seeded(5)
    block = model.layers[0].mamba
    assert block.ssm_norms and isinstance(block, MambaBlock)
    u = torch.randn(2, 64, 64, generator=torch.Generator().manual_seed(6))
    sub = {k[len("layers.0."):]: v for k, v in sd.items() if k.startswith("layers.0.")}
    with torch.no_grad():
        got = block(u)
        want = ref.mamba_mixer(u, sub, "mamba.", cfg, ref_scan)
    assert gap(got, want) < TOL_FP32
    # the norms act: without them the mixer is another function
    no_norms = MambaBlock(JambaConfig(**TINY).mamba())
    no_norms.load_state_dict({k: v for k, v in block.state_dict().items()
                              if "layernorm" not in k})
    with torch.no_grad():
        assert gap(no_norms(u), want) > 100 * TOL_FP32


# -- the Mamba model without the norms: the code before them, copied ------------

def _block_forward_before(block, u):
    x, z = block.in_proj(u).chunk(2, dim=-1)
    x = F.silu(causal_depthwise_conv(x, block.conv1d.weight, block.conv1d.bias))
    cfg = block.cfg
    dt, B, C = block.x_proj(x).split([cfg.resolved_dt_rank, cfg.d_state, cfg.d_state], dim=-1)
    dt = F.softplus(block.dt_proj(dt))
    A = -torch.exp(block.A_log.float())
    f32 = lambda t: t.float().contiguous()
    y = scan_kernel.selective_scan(f32(x), f32(dt), A.contiguous(), f32(B), f32(C),
                                   f32(block.D)).to(u.dtype)
    return block.out_proj(y * F.silu(z))


def _block_step_before(block, state, u):
    conv_buf, h = state
    x, z = block.in_proj(u).chunk(2, dim=-1)
    window = torch.cat([conv_buf, x[None]])
    k = block.conv1d.weight[:, 0, :].t()
    xc = F.silu((window * k).sum(0) + block.conv1d.bias)
    cfg = block.cfg
    dt, B, C = block.x_proj(xc).split([cfg.resolved_dt_rank, cfg.d_state, cfg.d_state], dim=-1)
    dt = F.softplus(block.dt_proj(dt))
    A = -torch.exp(block.A_log.float())
    xc32, dt32 = xc.float(), dt.float()
    a = torch.exp(dt32[:, None] * A)
    b = (dt32 * xc32)[:, None] * B.float()[None, :]
    h = a * h + b
    y = h @ C.float() + block.D.float() * xc32
    y = y.to(u.dtype) * F.silu(z)
    return (window[1:], h), block.out_proj(y)


def test_causal_mamba_bit_for_bit_without_norms():
    cfg = MambaConfig(f_dim=F_DIM, d_model=32, d_state=16, layers=3)
    model = CausalMambaModel(cfg, seed=3, device="cpu")
    assert not any("layernorm" in k for k in model.state_dict())
    assert all(not b.ssm_norms for b in model.blocks)
    x = feats(3, n=40, videos=2)
    with torch.no_grad():
        h = model.in_proj(x)
        for block in model.blocks:
            got = block(h)
            assert torch.equal(got, _block_forward_before(block, h))
            h = h + got
        online = OnlineMamba(model)
        state = online.init_state()
        u = model.in_proj(x[0, 0])
        for block, st in zip(model.blocks, state):
            (w1, h1), y1 = OnlineMamba._block_step(block, st, u)
            (w2, h2), y2 = _block_step_before(block, st, u)
            assert torch.equal(y1, y2) and torch.equal(w1, w2) and torch.equal(h1, h2)


# -- streaming ------------------------------------------------------------------

def test_online_jamba_two_videos_with_reset_equal_forward():
    model, _, _ = seeded(9)
    x = feats(9, n=40, videos=2)[:, : 40]
    lengths = (40, 23)
    online = OnlineJamba(model, capacity=48)
    leg = TemporalGraph(online)  # the session's leg: eager on the CPU
    state = online.init_state()
    for v, n in enumerate(lengths):
        if v:
            state = online.init_state()  # a reset
        with torch.no_grad():
            want = model(x[v:v + 1, :n])[0, 0]
        outs = []
        for t in range(n):
            state, _, out = leg(state, None, x[v, t])
            outs.append(out)
        assert gap(torch.stack(outs), want) < TOL_STEP
        assert int(state[1]) == n
        assert gap(online.run(x[v, :n]), want) < TOL_STEP


def test_online_jamba_kv_cache_layout():
    model, _, _ = seeded(4)
    online = OnlineJamba(model, capacity=16)
    layers, pos = online.init_state()
    kinds = JambaConfig(**TINY).layer_types
    for kind, st in zip(kinds, layers):
        if kind == "attention":
            assert [tuple(t.shape) for t in st] == [(16, 16), (16, 16)]
        else:
            assert [tuple(t.shape) for t in st] == [(3, 128), (128, 16)]
            assert st[1].dtype == torch.float32
    assert pos.dtype == torch.int64 and pos.dim() == 0
    # every shape stays as it was: a graph captures the step
    x = feats(4, n=3, videos=1)[0]
    state = (layers, pos)
    shapes = [t.shape for t in pytree.tree_leaves(state)]
    for f in x:
        state, _ = online.step(state, f)
    assert [t.shape for t in pytree.tree_leaves(state)] == shapes


def test_step_past_capacity_raises():
    model, _, _ = seeded(2)
    online = OnlineJamba(model, capacity=8)
    with pytest.raises(ValueError, match="capacity of 8 frames"):
        online.run(feats(2, n=9, videos=1)[0])
    online.run(feats(2, n=8, videos=1)[0])


def test_session_refuses_a_frame_past_capacity():
    from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig
    from surgical_tpu_torch.models.mit_evp import MiTEVP
    from surgical_tpu_torch.serving.online import OnlineSession

    model, _, _ = seeded(2)
    backbone = MiTEVP(BackboneConfig.preset("tiny", img_size=64, depths=(1, 1, 1, 1)),
                      HeadConfig(embedding_dim=F_DIM, hidden=8), seed=0, device="cpu")
    session = OnlineSession(backbone, OnlineJamba(model, capacity=3))
    f = feats(2, n=4, videos=1)[0]
    for t in range(3):
        session.advance(f[t])
    with pytest.raises(ValueError, match="capacity of 3 frames"):
        session.advance(f[3])
    session.reset()
    session.advance(f[3])


def test_counters():
    model, _, _ = seeded(2)
    before = counters()["jamba"]
    with torch.no_grad():
        model(feats(2, n=10, videos=2))
    OnlineJamba(model, capacity=20).run(feats(2, n=7, videos=1)[0])
    after = counters()["jamba"]
    assert after["forwards"] - before["forwards"] == 1
    assert after["frames"] - before["frames"] == 20
    assert after["steps"] - before["steps"] == 7
    assert after["kv_capacity"] == 20 and after["kv_high_water"] >= 7


def test_spans_per_layer():
    model, _, _ = seeded(2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(feats(2, n=5, videos=1))
            OnlineJamba(model, capacity=8).step(OnlineJamba(model, capacity=8).init_state(),
                                                feats(2, n=1, videos=1)[0, 0])
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    # per pass: 3 Mamba mixers, 1 attention, 4 MLPs
    assert names.count("stt:jamba.mamba") == 6
    assert names.count("stt:jamba.attention") == 2
    assert names.count("stt:jamba.mlp") == 8


# -- the CLI ---------------------------------------------------------------------

def _work(root, seed=0):
    """A work dir with index/ and lfb/ for train (videos of 40, 64, 50
    frames), val (48) and test (56, 30), Cholec80 label rows (as
    tests/test_torch_temporal_train.py's)."""
    from surgical_tpu_torch.data.feature_store import FeatureStore

    rng = np.random.default_rng(seed)
    for split, lengths, ids in (("train", (40, 64, 50), (1, 2, 3)), ("val", (48,), (41,)),
                                ("test", (56, 30), (42, 43))):
        n = sum(lengths)
        phase = np.concatenate([np.sort(rng.integers(0, 7, L)) for L in lengths])
        labels = np.concatenate([phase[:, None], rng.integers(0, 2, (n, 7)),
                                 rng.uniform(0, 1, (n, 7))], 1).astype(np.float32)
        idx = os.path.join(root, "index")
        os.makedirs(idx, exist_ok=True)
        np.save(os.path.join(idx, f"{split}_labels.npy"), labels)
        np.save(os.path.join(idx, f"{split}_num_each.npy"), np.asarray(lengths))
        np.save(os.path.join(idx, f"{split}_video_ids.npy"), np.asarray(ids, np.int64))
        feats = (rng.standard_normal((n, F_DIM)) * 0.1 + phase[:, None] * 0.1).astype(np.float32)
        FeatureStore.create(os.path.join(root, "lfb", split), feats, lengths)
    return root


def _tiny_jamba_cli(monkeypatch):
    """``cli``'s Jamba configuration at the tiny size, in fp32."""
    part = cli._temporal_part

    def tiny(kind, which):
        got = part(kind, which)
        if (kind, which) == ("jamba", "config"):
            return lambda **kw: got(**{**TINY, "dtype": "float32", **kw})
        return got

    monkeypatch.setattr(cli, "_temporal_part", tiny)


def test_cli_jamba_train_refiner_predict(tmp_path, monkeypatch):
    _tiny_jamba_cli(monkeypatch)
    w = _work(str(tmp_path / "w"))
    base = ["--model", "jamba", "--device", "cpu", "--lr", "1e-4", "--epochs", "1"]
    assert cli.main(["train-temporal", "--work", w, *base]) == 0
    from surgical_tpu_torch.core.checkpoint import CheckpointStore
    man = CheckpointStore(os.path.join(w, "ckpt", "temporal")).manifest(0)
    assert man["config"] == {"model": "jamba"}
    assert cli.main(["train-refiner", "--work", w, *base]) == 0
    outs = {}
    for online in (False, True):
        args = ["predict", "--work", w, "--split", "test", "--model", "jamba", "--device", "cpu"]
        assert cli.main(args + (["--online"] if online else [])) == 0
        d = os.path.join(w, "output", "Test")
        assert sorted(os.listdir(d)) == ["video42-phase.txt", "video43-phase.txt"]
        outs[online] = {f: open(os.path.join(d, f)).read() for f in os.listdir(d)}
    assert outs[False] == outs[True]


def test_cli_temporal_kinds_are_one_table(monkeypatch):
    assert sorted(cli.TEMPORAL_KINDS) == ["jamba", "mamba", "mstcn"]
    assert cli._temporal_part("jamba", "model") is JambaTemporalModel
    assert cli._temporal_part("jamba", "config") is JambaConfig
    assert cli._temporal_part("jamba", "online") is OnlineJamba
    _tiny_jamba_cli(monkeypatch)
    model = cli._temporal_model("jamba", "cpu", F_DIM)
    assert model.cfg == JambaConfig(**dict(TINY, dtype="float32"))


# -- the benchmark's configuration and cell ---------------------------------------

def test_configuration_file_builds_on_meta():
    """The configuration's temporal part is AI21-Jamba2-3B's published
    config.json, and builds through the constructor ``program.temporal``
    calls, on the meta device."""
    c = files.config(CONFIG)
    spec = c["temporal"]
    for k, v in spec["config"].items():
        if k in c and k != "dtype":  # the top-level dtype is the harness's, per model
            assert c[k] == v, k
    assert c["num_experts"] == 1 and c["reduced"] == []
    with torch.device("meta"):
        model = files.resolve(spec["constructor"])(program.make_config(spec), device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert 2.86e9 < n < 2.87e9
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    keys = set(model.state_dict())
    assert {"layers.7.self_attn.q_proj.weight", "layers.21.self_attn.k_proj.weight",
            "layers.0.mamba.dt_layernorm.weight", "layers.27.feed_forward.down_proj.weight",
            "final_layernorm.weight"} <= keys
    assert model.layers[7].self_attn.k_proj.weight.shape == (128, 2560)
    assert model.layers[0].mamba.A_log.shape == (5120, 16)
    assert files.resolve(spec["online"]) is OnlineJamba


def test_benchmark_entries():
    bench = files.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    w = files.workload(CELL)
    assert w["why"] == cells[CELL]["why"] and len(w["why"]) <= 200
    assert w["config"] == cells[CELL]["config"] and cells[CELL]["chips"] == 1
    mod = files.traffic(w["traffic"]["kind"])
    for fn in ("setup", "unit", "end_to_end", "counts", "least_s", "release", "check"):
        assert callable(getattr(mod, fn))
    assert w["traffic"]["video_lengths"] == files.workload("b0-mamba.video")["traffic"][
        "video_lengths"]
    picked = {m["name"] for m in files.per_layer_metrics(bench, CELL, ["video_ms_p95"])}
    assert picked == {"hybrid.mamba_ms", "hybrid.attention_ms", "hybrid.mlp_ms",
                      "video.scan_roofline", "video.ops_per_video", "video.mfu", "video.idle",
                      "video.temporal_ms", "video.refiner_ms"}
    for m in picked:
        assert callable(files.metric_reader(m))


def test_cell_runs_at_tiny_size():
    """The cell's set-up, window and check on the CPU, the temporal model
    at the tiny size: correct, the FLOPs counted per video length, the
    control reading far above the program."""
    w = copy.deepcopy(files.workload(CELL))
    w["traffic"].update(video_lengths=[20, 33, 47], check_videos=2)
    w["trace_units"] = 0
    readings = {}
    for control in (False, True):
        ctx = core.Context(2**33 + 5, torch.device("cpu"), tiny_config(), w, control=control)
        res = core.run_cell(ctx, 0.0, 0.0, max_units=4)
        readings[control] = res["checks"][0][1]
        assert set(res["metrics"]) == {"video_ms_p95", "setup_s"}
    assert readings[False] < TOL_FP32 < 100 * TOL_FP32 < readings[True]
