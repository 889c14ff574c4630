"""The streaming session's temporal leg as CUDA graphs with static state
buffers (``serving/temporal_graph.py``).

On the CPU (tier 1):

- the session's ``advance`` stays eager there: ``counters()["temporal_graph"]``
  counts every frame as eager, and the outputs are the eager steps';
- the key changes on an in-place write and on a replaced parameter of the
  temporal model and of the refiner, on ``load_state_dict`` into either, on
  a state of another shape, a feature of another dtype and TF32 matmuls,
  and not on ``reset``;
- ``record`` (the capture pass) with a stand-in for ``torch.cuda.CUDAGraph``
  that captures nothing, so the operations run: over 16 frames with a
  ``reset`` between, it writes the new state into the static buffers and
  gives the eager steps' logits and states bit for bit, for Mamba + refiner,
  MS-TCN + refiner, Mamba alone and Jamba + refiner (its K/V caches written
  in place in the static buffers, its frame count among them);
- ``serving/graphs.py::GraphedLeg`` on a toy leg of one linear layer on a
  stand-in card: eager on the CPU; on the card the static buffers made
  before the side stream, one capture, replays, and on a key change a new
  capture after the old graphs are gone; the eager output recorded on the
  replays' stream; the counts of exactly that, the leg's own;
- the whole graphed leg on a stand-in card: a ``CUDAGraph`` whose capture
  runs and records the operations and whose replay runs them again into the
  tensors the capture gave (as a graph replays into its addresses), and
  stand-in streams. Over 16 frames with a ``reset`` halfway and a state
  assigned from outside, the session equals the eager steps bit for bit;
  one capture, the rest replays; the state stays in the same buffers; a
  returned tensor is not changed by the next frame; ``load_state_dict``
  makes one new capture and the new weights' outputs.

On the card (``cuda``; the file imports no JAX: ``python -m pytest
--noconftest tests/test_torch_temporal_graph.py -m cuda``):

- over 64 frames of b0 features with a ``reset`` halfway, the graphed
  session's outputs and states equal the eager steps' bit for bit, with
  Mamba and with MS-TCN, with and without the refiner; the replays count
  every frame but the capture's;
- ``load_state_dict`` of new temporal weights makes one new capture and the
  new weights' outputs;
- the allocator's reserved bytes stay put over 500 replayed frames;
- under ``torch.profiler`` each replayed frame fires ``session.temporal``
  and ``session.refiner``;
- the tensor ``advance`` returned for one frame is not changed by the next.
"""

import contextlib
import weakref

import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from surgical_tpu_torch.core.config import (BackboneConfig, HeadConfig, JambaConfig,
                                            MambaConfig, MSTCNConfig, RefinerConfig)
from surgical_tpu_torch.models.jamba import JambaTemporalModel
from surgical_tpu_torch.models.mamba import CausalMambaModel
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.models.mstcn import MultiStageTCN
from surgical_tpu_torch.models.transsv import RefinementTransformer
from surgical_tpu_torch.core.state import state_key
from surgical_tpu_torch.serving import temporal_graph as tg
from surgical_tpu_torch.serving.graphs import GraphedLeg, layout
from surgical_tpu_torch.serving.online import (OnlineJamba, OnlineMamba, OnlineMSTCN,
                                               OnlineRefiner, OnlineSession)
from surgical_tpu_torch.utils.trace import counters

S, E = 64, 16
TINY = BackboneConfig.preset("tiny", img_size=S, depths=(1, 1, 1, 1))
HEAD = HeadConfig(embedding_dim=E, hidden=8)
MAMBA = MambaConfig(f_dim=E, d_model=16, d_state=8, layers=2)
MSTCN = MSTCNConfig(stages=2, layers=3, f_maps=8, f_dim=E)
REFINER = RefinerConfig(f_maps=8, f_dim=E, len_q=4)
JAMBA = JambaConfig(hidden_size=32, num_hidden_layers=3, intermediate_size=48,
                    num_attention_heads=4, num_key_value_heads=1, attn_layer_offset=1,
                    attn_layer_period=3, mamba_d_state=8, mamba_dt_rank=2, f_dim=E,
                    dtype="float32")
KINDS = ("mamba_refiner", "mstcn_refiner", "mamba", "jamba_refiner")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def legs(kind, seed=1, device="cpu"):
    """(temporal, refiner or None) of ``kind``, seeded: tiny on the CPU, at
    the default widths on the card (f_dim 2048)."""
    tiny = device == "cpu"
    if kind.startswith("jamba"):  # the CPU's size only: tests/test_torch_jamba_card.py
        temporal = OnlineJamba(JambaTemporalModel(JAMBA, seed=seed, device=device), capacity=32)
    elif kind.startswith("mamba"):
        temporal = OnlineMamba(CausalMambaModel(MAMBA if tiny else MambaConfig(), seed=seed,
                                                device=device))
    else:
        temporal = OnlineMSTCN(MultiStageTCN(MSTCN if tiny else MSTCNConfig(), seed=seed,
                                             device=device))
    if not kind.endswith("refiner"):
        return temporal, None
    return temporal, OnlineRefiner(RefinementTransformer(REFINER if tiny else RefinerConfig(),
                                                         seed=seed + 1, device=device))


def cpu_session(kind):
    backbone = MiTEVP(TINY, HEAD, seed=0, device="cpu")
    return OnlineSession(backbone, *legs(kind))


def feats(n, seed=3):
    return torch.randn(n, E, generator=torch.Generator().manual_seed(seed)) * 0.5


class Eager:
    """The eager steps, as the session ran them before the graphs."""

    def __init__(self, temporal, refiner):
        self.temporal, self.refiner = temporal, refiner
        self.reset()

    def reset(self):
        self.state = self.temporal.init_state()
        self.refiner_state = self.refiner.init_state() if self.refiner else None

    def advance(self, feat):
        self.state, self.refiner_state, out = tg.eager_leg(
            self.temporal, self.refiner, self.state, self.refiner_state, feat)
        return out


def state_leaves(state, refiner_state):
    return pytree.tree_leaves(state) + ([] if refiner_state is None else [refiner_state])


def assert_same_state(session, eager):
    got = state_leaves(session.state, session.refiner_state)
    want = state_leaves(eager.state, eager.refiner_state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def delta(before):
    after = counters()["temporal_graph"]
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("kind", KINDS)
def test_cpu_advance_stays_eager(kind):
    session = cpu_session(kind)
    eager = Eager(session.temporal, session.refiner)
    before = counters()["temporal_graph"]
    for t, f in enumerate(feats(5)):
        if t == 3:
            session.reset()
            eager.reset()
        assert torch.equal(session.advance(f), eager.advance(f))
        assert_same_state(session, eager)
    assert delta(before) == {"captures": 0, "replays": 0, "eager": 5}
    assert session._temporal_leg.captured is None


def _param_inplace(model):
    with torch.no_grad():
        next(model.parameters()).add_(1.0)


def _param_replaced(model):
    name, p = next(model.named_parameters())
    *path, leaf = name.split(".")
    owner = model
    for part in path:
        owner = getattr(owner, part)
    setattr(owner, leaf, torch.nn.Parameter(p.detach().clone()))


def _load_state_dict(model):
    model.load_state_dict(type(model)(model.cfg, seed=7, device="cpu").state_dict())


CHANGES = {"param_inplace": _param_inplace, "param_replaced": _param_replaced,
           "load_state_dict": _load_state_dict}


def _key(session, feat):
    return session._temporal_leg.key(session.state, session.refiner_state, feat)


@pytest.mark.parametrize("change", [*(f"{m}.{c}" for m in ("temporal", "refiner")
                                      for c in CHANGES), "state_shape", "feat_dtype", "tf32"])
def test_key_changes(monkeypatch, change):
    session = cpu_session("mamba_refiner")
    feat = feats(1)[0]
    key = _key(session, feat)
    assert _key(session, feat) == key
    if change == "state_shape":
        session.refiner_state = torch.zeros(REFINER.len_q + 1, REFINER.out_features)
    elif change == "feat_dtype":
        feat = feat.double()
    elif change == "tf32":
        monkeypatch.setattr(torch, "get_float32_matmul_precision", lambda: "high")
    else:
        part, what = change.split(".")
        CHANGES[what](getattr(session, part).model)
    assert _key(session, feat) != key


def test_key_kept_by_reset():
    session = cpu_session("mstcn_refiner")
    feat = feats(1)[0]
    key = _key(session, feat)
    session.advance(feat)
    session.reset()
    assert _key(session, feat) == key


class StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: captures nothing,
    so the operations of a capture run as they are issued."""

    ended = 0

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"

    def capture_end(self):
        StubGraph.ended += 1


@pytest.mark.parametrize("kind", KINDS)
def test_record_writes_the_new_state(monkeypatch, kind):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", StubGraph)
    StubGraph.ended = 0
    temporal, refiner = legs(kind)
    eager = Eager(temporal, refiner)
    static = pytree.tree_map(torch.empty_like, temporal.init_state())
    static_refiner = refiner.init_state() if refiner else None
    leaves = state_leaves(static, static_refiner)
    ptrs = [a.data_ptr() for a in leaves]
    static_feat = torch.empty(E)

    def zero():  # what the session's reset amounts to: its initial state, copied in
        tg._write(pytree.tree_leaves(static), pytree.tree_leaves(temporal.init_state()))
        if refiner:
            static_refiner.zero_()

    zero()
    with torch.no_grad():
        for t, f in enumerate(feats(16)):
            if t == 8:
                zero()
                eager.reset()
            static_feat.copy_(f)
            graphs, out = tg.record(temporal, refiner, static_feat, static, static_refiner,
                                    pool=None)
            assert torch.equal(out, eager.advance(f)), (kind, t)
            for a, b in zip(leaves, state_leaves(eager.state, eager.refiner_state), strict=True):
                assert torch.equal(a, b), (kind, t)
    assert [a.data_ptr() for a in leaves] == ptrs
    assert len(graphs) == (2 if refiner else 1)
    assert StubGraph.ended == 16 * len(graphs)


class _Recorder(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:  # a view aliases a tensor the replay writes into
            self.ops.append((func, args, kwargs or {}, out))
        return out


class ReplayGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: the capture runs
    the operations and records them; a replay runs them again on the same
    tensors and writes each result into the tensor the capture gave, as a
    graph replays into the addresses it captured."""

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        self.ops = []
        self._mode = _Recorder(self.ops)
        self._mode.__enter__()

    def capture_end(self):
        self._mode.__exit__(None, None, None)

    def replay(self):
        for func, args, kwargs, out in self.ops:
            res = func(*args, **kwargs)
            for o, r in zip(pytree.tree_leaves(out), pytree.tree_leaves(res)):
                if isinstance(o, torch.Tensor) and o is not r:
                    o.copy_(r.view(o.shape))  # matmul's squeeze_ reshaped o after its mm


class _Stream:
    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def stand_in_card(monkeypatch):
    """``torch.cuda``'s graphs and streams stood in for on the CPU; a
    session's temporal leg made to take the card's path with
    ``on_card(session)``."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", ReplayGraph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None, raising=False)

    def on_card(session):
        session._temporal_leg.device = torch.device("cuda")
        return session
    return on_card


class ToyLeg(GraphedLeg):
    """One linear layer as a graphed leg: its static input from ``buffers``,
    one graph per capture; the hooks log their calls."""

    def __init__(self, model, log):
        super().__init__(torch.device("cpu"))
        self.model, self.log, self.made = model, log, []

    def key(self, x):
        return layout(x), state_key(self.model)

    def eager(self, x):
        self.log.append("eager")
        return self.model(x)

    def buffers(self, x):
        self.log.append("buffers")
        return torch.empty_like(x)

    def capture(self, pool, buffers, x):
        gone = self.captured is None and all(r() is None for r in self.made)
        self.log.append(("capture", gone))
        out = self.model(x)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        y = self.model(buffers)
        graph.capture_end()
        self.made.append(weakref.ref(graph))
        return out, (graph, buffers, y)

    def replay(self, x):
        graph, static, y = self.captured
        static.copy_(x)
        graph.replay()
        return y.clone()


def test_graphed_leg_captures_replays_and_recaptures(stand_in_card, monkeypatch):
    log = []
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: log.append("side") or _Stream())
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, s: log.append(("record_stream", self.shape)), raising=False)
    model = torch.nn.Linear(E, 3)
    leg, xs = ToyLeg(model, log), feats(6, seed=6)
    temporal_counts = dict(tg.COUNTS)
    with torch.no_grad():
        assert torch.equal(leg(xs[0]), model(xs[0]))
        assert log == ["eager"] and leg.captured is None
        leg.device = torch.device("cuda")
        for t in range(1, 4):
            assert torch.equal(leg(xs[t]), model(xs[t])), t
        assert ToyLeg.COUNTS == {"captures": 1, "replays": 2, "eager": 2}
        assert log == ["eager", "buffers", "side", ("capture", True),
                       ("record_stream", torch.Size([3]))]
        model.weight.add_(1.0)  # a key change
        for t in range(4, 6):
            assert torch.equal(leg(xs[t]), model(xs[t])), t
    assert log[5:] == ["buffers", "side", ("capture", True), ("record_stream", torch.Size([3]))]
    assert ToyLeg.COUNTS == {"captures": 2, "replays": 3, "eager": 3}
    assert tg.COUNTS == temporal_counts and tg.COUNTS is tg.TemporalGraph.COUNTS


@pytest.mark.parametrize("kind", KINDS)
def test_replayed_session_equals_eager(stand_in_card, kind):
    session = stand_in_card(cpu_session(kind))
    eager = Eager(session.temporal, session.refiner)
    before = counters()["temporal_graph"]
    outs, ptrs = [], None
    for t, f in enumerate(feats(16, seed=4)):
        if t == 8:
            session.reset()
            eager.reset()
        if t == 12:  # a state from outside is copied into the static buffers
            eager.advance(f * 2)
            session.state = pytree.tree_map(torch.clone, eager.state)
            session.refiner_state = (None if eager.refiner_state is None
                                     else eager.refiner_state.clone())
        out = session.advance(f)
        want = eager.advance(f)
        assert torch.equal(out, want), (kind, t)
        assert_same_state(session, eager)
        outs.append((out, want.clone()))
        leaves = [a.data_ptr() for a in state_leaves(session.state, session.refiner_state)]
        assert ptrs is None or leaves == ptrs  # updated in place, after the capture's frame
        ptrs = leaves
    assert delta(before) == {"captures": 1, "replays": 15, "eager": 1}
    assert len(session._temporal_leg.captured.graphs) == (1 if kind == "mamba" else 2)
    for out, want in outs:  # each frame's tensor is the caller's
        assert torch.equal(out, want)


@pytest.mark.parametrize("part", ["temporal", "refiner"])
def test_load_state_dict_recaptures(stand_in_card, part):
    session = stand_in_card(cpu_session("mamba_refiner"))
    eager = Eager(session.temporal, session.refiner)
    f = feats(6, seed=5)
    for t in range(3):
        assert torch.equal(session.advance(f[t]), eager.advance(f[t]))
    before = counters()["temporal_graph"]
    _load_state_dict(getattr(session, part).model)
    for t in range(3, 6):
        assert torch.equal(session.advance(f[t]), eager.advance(f[t]))
        assert_same_state(session, eager)
    assert delta(before) == {"captures": 1, "replays": 2, "eager": 1}


# ------------------------------------------------------------------ card


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU build")


def card_session(kind, seed=21):
    backbone = MiTEVP(BackboneConfig.preset("b0"), HeadConfig(), seed=seed, device="cuda")
    return OnlineSession(backbone, *legs(kind, seed=seed + 1, device="cuda"))


def card_feats(session, n, seed=22):
    """b0 features of n seeded 224-px wire frames, through the session's
    graphed feature leg."""
    g = torch.Generator().manual_seed(seed)
    wire = lambda *shape: torch.randint(0, 256, shape, generator=g, dtype=torch.uint8).cuda()
    out = []
    for _ in range(n):
        flow = (torch.randn(224, 224, 2, generator=g) * 2).half().cuda()
        out.append(session.features(wire(224, 224, 3), wire(224, 224, 1), flow))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mamba_refiner", "mamba", "mstcn_refiner", "mstcn"])
def test_graphed_session_equals_eager(kind):
    _needs_card()
    n = 64
    session = card_session(kind)
    eager = Eager(session.temporal, session.refiner)
    fs = card_feats(session, n)
    before = counters()["temporal_graph"]
    for t, f in enumerate(fs):
        if t == n // 2:
            session.reset()
            eager.reset()
        got = session.advance(f)
        want = eager.advance(f)
        assert torch.equal(got, want), (kind, t)
        assert_same_state(session, eager)
    assert delta(before) == {"captures": 1, "replays": n - 1, "eager": 1}


@pytest.mark.cuda
def test_card_load_state_dict_recaptures():
    _needs_card()
    session = card_session("mamba_refiner")
    eager = Eager(session.temporal, session.refiner)
    fs = card_feats(session, 6)
    for f in fs[:3]:
        assert torch.equal(session.advance(f), eager.advance(f))
    before = counters()["temporal_graph"]
    new = CausalMambaModel(MambaConfig(f_dim=2048), seed=99, device="cuda")
    session.temporal.model.load_state_dict(new.state_dict())
    for f in fs[3:]:
        assert torch.equal(session.advance(f), eager.advance(f))
    assert delta(before) == {"captures": 1, "replays": 2, "eager": 1}
    fresh = Eager(OnlineMamba(new), session.refiner)  # the new weights from a clean state
    session.reset()
    for f in fs:
        assert torch.equal(session.advance(f), fresh.advance(f))


@pytest.mark.cuda
def test_reserved_bytes_steady_over_500_replays():
    _needs_card()
    session = card_session("mamba_refiner")
    fs = card_feats(session, 8)
    for f in fs:
        session.advance(f).cpu()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    for t in range(500):
        if t % 100 == 0:
            session.reset()
        session.advance(fs[t % 8]).cpu()
    torch.cuda.synchronize()
    assert torch.cuda.memory_reserved() == reserved


@pytest.mark.cuda
def test_spans_fire_around_replays():
    _needs_card()
    session = card_session("mamba_refiner")
    fs = card_feats(session, 4)
    session.advance(fs[0])
    before = counters()["temporal_graph"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for f in fs[1:]:
            session.advance(f)
        torch.cuda.synchronize()
    assert delta(before)["replays"] == 3
    spans = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                   if e.name() in ("stt:session.temporal", "stt:session.refiner")
                   and e.device_type() == torch.autograd.DeviceType.CPU)
    assert [n for _, n in spans] == ["stt:session.temporal", "stt:session.refiner"] * 3
    assert any(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


@pytest.mark.cuda
def test_returned_tensor_is_the_callers():
    _needs_card()
    session = card_session("mstcn_refiner")
    fs = card_feats(session, 3)
    session.advance(fs[0])
    first = session.advance(fs[1])
    kept = first.clone()
    second = session.advance(fs[2])
    torch.cuda.synchronize()
    assert torch.equal(first, kept)
    assert not torch.equal(second, kept)
