"""The streaming session's feature leg as CUDA graphs of the glue between
the MiT kernel calls (``serving/feature_graph.py``).

On the CPU (tier 1):

- the session stays eager there: ``counters()["feature_graph"]`` counts
  every frame as eager and no capture or replay;
- the leg's key (``FeatureGraph.key``: the frame's layout and
  ``core/state.py::state_key`` of the backbone, ``mit_fused.routes()``)
  changes on an in-place parameter write, a replaced parameter, an
  in-place buffer write, a frame without flow, a frame of another size and
  the packed2 route set, and not on ``reset``;
- ``record`` (the capture pass) with a stand-in for ``torch.cuda.CUDAGraph``
  that captures nothing, so the operations run: it cuts the leg at each
  kernel entry and at each span boundary that follows issued operations,
  calls the kernels through the entries and gives the eager leg's features
  bit for bit; the flax graph is one segment; the entries come back after
  the pass, also after an error, and other threads reach the entries of
  before while it runs.

On the card (``cuda``; the file imports no JAX: ``python -m pytest
--noconftest tests/test_torch_session_graph.py -m cuda``):

- over 64 frames with a ``reset`` halfway, the graphed session's features
  and outputs equal an eager session's bit for bit, at b0 and b3, B = 1,
  with flow and without (the eager session: ``WireForward`` at batch 1 and
  the same temporal steps);
- ``load_state_dict`` of new weights in place makes one new capture and the
  new weights' eager features;
- the block kernel's ``.launches``, and a wrapper set on the entry after
  the capture, advance by the frame's 8 kernel calls on every replay;
- extraction (``make_raw_feature_fn``, ``extract_features``) over host
  batches of 24, the last ragged, staged in pinned memory and replayed,
  equals the eager forward bit for bit at b0 and b3, with one capture;
- the allocator's reserved bytes stay put over 500 replayed frames;
- under ``torch.profiler`` each replayed frame's ``session.features`` holds
  ``mit.prompts`` and ``mit.stage1`` .. ``4``.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from surgical_tpu_torch.core.config import (BackboneConfig, HeadConfig, MambaConfig,
                                            MSTCNConfig, RefinerConfig)
from surgical_tpu_torch.kernels import mit_block as mb
from surgical_tpu_torch.models import mit_fused
from surgical_tpu_torch.models.mamba import CausalMambaModel
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.models.mstcn import MultiStageTCN
from surgical_tpu_torch.models.transsv import RefinementTransformer
from surgical_tpu_torch.serving import feature_graph as fg
from surgical_tpu_torch.serving.online import (OnlineMamba, OnlineMSTCN, OnlineRefiner,
                                               OnlineSession)
from surgical_tpu_torch.parallel import mesh
from surgical_tpu_torch.train.extract import WireForward, extract_features, make_raw_feature_fn
from surgical_tpu_torch.utils.trace import counters

S, E = 64, 16
TINY = BackboneConfig.preset("tiny", img_size=S, depths=(2, 2, 2, 2))
HEAD = HeadConfig(embedding_dim=E, hidden=8)
MAMBA = MambaConfig(f_dim=E, d_model=16, d_state=8, layers=2)
REFINER = RefinerConfig(f_maps=8, f_dim=E, len_q=4)
STAGES = tuple(f"mit.stage{s}" for s in range(1, 5))


def wire(n, size=S, seed=0, flow=True):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            rng.integers(0, 256, (n, size, size, 1), dtype=np.uint8),
            (rng.standard_normal((n, size, size, 2)) * 2).astype(np.float16) if flow else None)


def one(frames, t):
    """Frame t as the session hands it to the leg: a batch axis of 1."""
    return tuple(None if a is None else a[t:t + 1] for a in frames)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_session(cfg=TINY, seed=0):
    backbone = MiTEVP(cfg, HEAD, seed=seed, device="cpu")
    return OnlineSession(backbone, OnlineMamba(CausalMambaModel(MAMBA, seed=1, device="cpu")),
                         OnlineRefiner(RefinementTransformer(REFINER, seed=2, device="cpu")))


def test_cpu_session_stays_eager():
    session = cpu_session()
    frames = wire(3, seed=1)
    before = counters()["feature_graph"]
    feats = [session.features(*(a[t] for a in frames)) for t in range(3)]
    session.step(*(a[0] for a in frames))
    after = counters()["feature_graph"]
    assert {k: after[k] - before[k] for k in after} == {"captures": 0, "replays": 0, "eager": 4}
    assert session._features.segments == 0
    serve = WireForward(session._features.model, True)
    for t, f in enumerate(feats):
        want = serve(*(torch.from_numpy(a) for a in one(frames, t)))
        assert torch.equal(f, want[0].float())


def _param_inplace(model):
    with torch.no_grad():
        model.patch_embed1.proj.weight.add_(1.0)


def _param_replaced(model):
    w = model.block1[0].attn.q.weight
    model.block1[0].attn.q.weight = torch.nn.Parameter(w.detach().clone())


def _buffer_inplace(model):
    model.flow_encoder.bn1.running_mean.fill_(0.5)


def _load_state_dict(model):
    model.load_state_dict(MiTEVP(TINY, HEAD, seed=7, device="cpu").state_dict())


CHANGES = {"param_inplace": _param_inplace, "param_replaced": _param_replaced,
           "buffer_inplace": _buffer_inplace, "load_state_dict": _load_state_dict}


@pytest.mark.parametrize("change", [*CHANGES, "no_flow", "other_size", "route"])
def test_graph_key_changes(change, monkeypatch):
    model = MiTEVP(TINY, HEAD, seed=0, device="cpu")
    leg = fg.FeatureGraph(WireForward(model, True), model)
    frame = tuple(None if a is None else torch.from_numpy(a) for a in one(wire(1), 0))
    key = leg.key(frame)
    assert leg.key(frame) == key
    if change == "no_flow":
        frame = frame[:2] + (None,)
    elif change == "other_size":
        frame = tuple(torch.from_numpy(a) for a in one(wire(1, size=S + 32), 0))
    elif change == "route":
        monkeypatch.setattr(mit_fused, "_ROUTE_PACKED2", True)
    else:
        CHANGES[change](model)
    assert leg.key(frame) != key


def test_graph_key_kept_by_reset():
    session = cpu_session()
    frames = wire(2, seed=2)
    frame = tuple(torch.from_numpy(a) for a in one(frames, 0))
    key = session._features.key(frame)
    session.step(*(a[0] for a in frames))
    session.reset()
    assert session._features.key(frame) == key


class StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: captures nothing,
    so the operations of a segment run as they are issued. Its
    ``capture_begin`` issues a fill, as the real one does when it registers
    the generator's state, which must not count as the leg's."""

    ended = 0

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        torch.empty(2).fill_(0.0)

    def capture_end(self):
        StubGraph.ended += 1


@pytest.fixture
def stub_graphs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StubGraph)
    StubGraph.ended = 0


def expected_steps(depths):
    """The step kinds and names of one fused pass at B = 1: the dequantization,
    the prompts, per stage a segment before each block's kernel and one for
    the stage's norm, then flow, cross-attentions and head."""
    G, K = fg._GRAPH, fg._KERNEL
    steps = [(G,), (fg._ENTER, "mit.prompts"), (G,), (fg._EXIT,)]
    for s, d in zip(STAGES, depths):
        steps += [(fg._ENTER, s)] + [(G,), (K, "fused_mit_block")] * d + [(G,), (fg._EXIT,)]
    return steps + [(G,)]


def _kinds(steps):
    return [s[:2] if s[0] in (fg._KERNEL, fg._ENTER) else s[:1] for s in steps]


@pytest.mark.parametrize("flow", [True, False])
def test_record_cuts_at_kernels_and_spans(stub_graphs, flow):
    cfg = TINY if flow else BackboneConfig.preset("tiny", img_size=S, depths=(2, 2, 2, 2),
                                                  with_flow=False)
    model = MiTEVP(cfg, HEAD, seed=3, device="cpu")
    serve = WireForward(model, True)
    inputs = tuple(None if a is None else torch.from_numpy(a)
                   for a in one(wire(1, seed=4, flow=flow), 0))
    entries = {n: getattr(mit_fused, n) for n in (*fg.ENTRIES, "span")}
    before = mb.fused_mit_block.launches
    with torch.no_grad():
        want = serve(*inputs)
        steps, got = fg.record(serve, inputs, pool=None)
    assert _kinds(steps) == expected_steps(cfg.depths)
    assert StubGraph.ended == 15  # every segment, none empty
    assert torch.equal(got, want)
    assert {n: getattr(mit_fused, n) for n in entries} == entries
    kernels = [s for s in steps if s[0] == fg._KERNEL]
    for _, name, args, kwargs, out in kernels:  # what a replay calls the entry with
        assert kwargs.keys() == {"heads", "H", "W"} and out.shape == args[0].shape
    assert mb.fused_mit_block.launches == before  # the CPU's plain version counts nothing


def test_record_flax_graph_is_one_segment(stub_graphs):
    model = MiTEVP(TINY, HEAD, seed=3, device="cpu")
    serve = WireForward(model, False)
    inputs = tuple(torch.from_numpy(a) for a in one(wire(1, seed=5), 0))
    with torch.no_grad():
        steps, got = fg.record(serve, inputs, pool=None)
        assert torch.equal(got, serve(*inputs))
    assert _kinds(steps) == [(fg._GRAPH,)]


def test_record_restores_entries_after_an_error(stub_graphs):
    entries = {n: getattr(mit_fused, n) for n in (*fg.ENTRIES, "span")}

    def broken(*inputs):
        x = inputs[0] + 1
        with mit_fused.span("mit.prompts"):
            raise ValueError("in the leg")
        return x

    with pytest.raises(ValueError, match="in the leg"):
        fg.record(broken, (torch.zeros(2),), pool=None)
    assert StubGraph.ended == 2  # the segment before the span, and the one it left open
    assert {n: getattr(mit_fused, n) for n in entries} == entries


def test_rebinding_is_this_threads(stub_graphs):
    seen = {}

    def leg(x):
        def other():
            seen["other"] = mit_fused.span("mit.prompts")
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        seen["mine"] = mit_fused.span("mit.prompts")
        with seen["mine"]:
            return x * 2

    steps, out = fg.record(leg, (torch.ones(2),), pool=None)
    assert torch.equal(out, torch.full((2,), 2.0))
    assert seen["other"] is entries_span()  # the shared null context of utils/trace.py
    assert seen["mine"] is not seen["other"]
    assert _kinds(steps) == [(fg._ENTER, "mit.prompts"), (fg._GRAPH,), (fg._EXIT,)]


def entries_span():
    return mit_fused.span("anything")


# ------------------------------------------------------------------ card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the MiT kernels and CUDA graphs have no "
                    "CPU build")


CARD = {"b0": (BackboneConfig.preset("b0"), 15, 8),
        "b3": (BackboneConfig(), 35, 28)}


def card_models(variant, flow, seed=11):
    cfg, segments, kernels = CARD[variant]
    if not flow:
        cfg = dataclasses.replace(cfg, with_flow=False)
    backbone = MiTEVP(cfg, HeadConfig(), seed=seed, device="cuda")
    if variant == "b0":
        temporal = CausalMambaModel(MambaConfig(f_dim=2048), seed=seed + 1, device="cuda")
        online = lambda: (OnlineMamba(temporal), None)
    else:
        temporal = MultiStageTCN(MSTCNConfig(f_dim=2048), seed=seed + 1, device="cuda")
        refiner = RefinementTransformer(RefinerConfig(f_dim=2048), seed=seed + 2,
                                        device="cuda")
        online = lambda: (OnlineMSTCN(temporal), OnlineRefiner(refiner))
    return backbone, online, segments, kernels


def eager_features(backbone):
    """The serving forward run eagerly over host or card arrays."""
    serve = WireForward(backbone, True)

    @torch.no_grad()
    def run(*frame):
        return serve(*(None if a is None else torch.as_tensor(a).cuda() for a in frame))

    return run


def card_frames(n, flow, on_card, seed=12):
    frames = wire(n, size=224, seed=seed, flow=flow)
    if on_card:  # as the benchmark feeds them; else host arrays, as the CLI does
        frames = tuple(None if a is None else torch.from_numpy(a).cuda() for a in frames)
    return frames


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["b0", "b3"])
@pytest.mark.parametrize("flow", [True, False])
def test_graphed_session_equals_eager(variant, flow):
    _needs_card()
    n = 64
    backbone, online, segments, _ = card_models(variant, flow)
    frames = card_frames(n, flow, on_card=variant == "b0")
    graphed, eager = OnlineSession(backbone, *online()), OnlineSession(backbone, *online())
    feature_fn = eager_features(backbone)
    before = counters()["feature_graph"]
    for t in range(n):
        if t == n // 2:
            graphed.reset()
            eager.reset()
        frame = tuple(None if a is None else a[t] for a in frames)
        got = graphed.features(*frame)
        out = graphed.advance(got).cpu().numpy()
        want = feature_fn(*one(frames, t))[0].float()
        assert torch.equal(got, want), (variant, flow, t)
        np.testing.assert_array_equal(out, eager.advance(want).cpu().numpy())
    after = counters()["feature_graph"]
    assert {k: after[k] - before[k] for k in after} == {"captures": 1, "replays": n - 1,
                                                        "eager": 1}
    assert graphed._features.segments == segments


@pytest.mark.cuda
def test_load_state_dict_recaptures():
    _needs_card()
    backbone, online, _, _ = card_models("b0", True)
    frames = card_frames(4, True, on_card=True)
    session = OnlineSession(backbone, *online())
    feature_fn = eager_features(backbone)
    frame = lambda t: tuple(a[t] for a in frames)
    for t in range(2):
        session.features(*frame(t))
    before = counters()["feature_graph"]
    backbone.load_state_dict(MiTEVP(backbone.cfg, HeadConfig(), seed=99,
                                    device="cuda").state_dict())
    for t in range(2, 4):
        got = session.features(*frame(t))
        assert torch.equal(got, feature_fn(*one(frames, t))[0].float())
    after = counters()["feature_graph"]
    assert {k: after[k] - before[k] for k in after} == {"captures": 1, "replays": 1, "eager": 1}


@pytest.mark.cuda
def test_every_replay_calls_the_kernels_through_their_entries(monkeypatch):
    _needs_card()
    backbone, online, _, kernels = card_models("b0", True)
    frames = card_frames(6, True, on_card=True)
    session = OnlineSession(backbone, *online())
    session.features(*(a[0] for a in frames))  # the capture
    entry, calls = mit_fused.fused_mit_block, []

    def wrapped(*args, **kwargs):  # as a benchmark's tracer wraps the entry
        calls.append(args[0].shape)
        return entry(*args, **kwargs)

    monkeypatch.setattr(mit_fused, "fused_mit_block", wrapped)
    for t in range(1, 6):
        launches = mb.fused_mit_block.launches
        session.features(*(a[t] for a in frames))
        assert mb.fused_mit_block.launches - launches == kernels
        assert len(calls) == t * kernels


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["b0", "b3"])
def test_extraction_replays_bit_for_bit(variant):
    _needs_card()
    backbone = card_models(variant, True)[0]
    B, n = 24, 4 * 24 + 10
    frames = wire(n, size=224, seed=5)
    batches = [tuple(a[i:i + B] for a in frames) for i in range(0, n, B)]
    fn, eager = make_raw_feature_fn(backbone), eager_features(backbone)
    before = counters()["extract_graph"]
    got, _ = extract_features(fn, batches, n, 2048, B)
    after = counters()["extract_graph"]
    want = torch.cat([eager(*mesh.pad_batch(b, B)[0])[:len(b[0])] for b in batches])
    np.testing.assert_array_equal(got, want.float().cpu().numpy())
    assert {k: after[k] - before[k] for k in after} == {"captures": 1,
                                                        "replays": len(batches) - 1,
                                                        "eager": 1}
    # stage 4 on the whole-stage kernel at B = 24: fewer cuts than a streamed frame's
    assert fn.graph.segments == {"b0": 14, "b3": 33}[variant]


@pytest.mark.cuda
def test_reserved_bytes_steady_over_500_replays():
    _needs_card()
    backbone, online, _, _ = card_models("b0", True)
    frames = card_frames(8, True, on_card=True)
    session = OnlineSession(backbone, *online())
    for t in range(8):
        session.step(*(a[t] for a in frames))
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    for t in range(500):
        session.step(*(a[t % 8] for a in frames))
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() == reserved


@pytest.mark.cuda
def test_spans_fire_around_replays():
    _needs_card()
    backbone, online, _, _ = card_models("b0", True)
    frames = card_frames(4, True, on_card=True)
    session = OnlineSession(backbone, *online())
    session.features(*(a[0] for a in frames))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for t in range(1, 4):
            session.features(*(a[t] for a in frames))
        torch.cuda.synchronize()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("stt:")
             and e.device_type() == torch.autograd.DeviceType.CPU]  # not their device copies
    legs = [s for s in spans if s[0] == "stt:session.features"]
    assert len(legs) == 3
    for _, a, b in legs:
        inner = [n for n, s, t in spans if a <= s and t <= b and n != "stt:session.features"]
        assert sorted(inner) == sorted(["stt:mit.prompts", *(f"stt:{s}" for s in STAGES)])
