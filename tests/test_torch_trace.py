"""The program's spans and counters (``surgical_tpu_torch/utils/trace.py``)
on the CPU at a tiny size:

- with no profiler active, extraction, the session, a training step and
  ``predict_video`` make no ``record_function`` call;
- under ``torch.profiler`` the same calls give exactly the named ``stt:``
  spans, nested as the hot paths nest them, and the same outputs bit for
  bit as without it;
- the garbage collector's hook counts a collection and, under a profiler,
  leaves its span;
- an exported serving graph holds no profiler op.
"""

import gc
from collections import Counter

import numpy as np
import pytest
import torch

from surgical_tpu_torch.core.config import (BackboneConfig, HeadConfig, MambaConfig,
                                            OptimConfig, RefinerConfig, TrainConfig)
from surgical_tpu_torch.data.transforms import AugConfig
from surgical_tpu_torch.models.mamba import CausalMambaModel
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.models.transsv import RefinementTransformer
from surgical_tpu_torch.serving.export import export_feature_extractor
from surgical_tpu_torch.serving.online import OnlineMamba, OnlineRefiner, OnlineSession
from surgical_tpu_torch.train.backbone import BackboneTrainer
from surgical_tpu_torch.train.extract import extract_features, make_raw_feature_fn
from surgical_tpu_torch.train.refiner import predict_video
from surgical_tpu_torch.utils import trace

S, E, B = 64, 16, 2
CFG = BackboneConfig.preset("tiny", img_size=S)
HEAD = HeadConfig(embedding_dim=E, hidden=8)
MAMBA = MambaConfig(f_dim=E, d_model=16, d_state=8, layers=2)
REFINER = RefinerConfig(f_maps=8, f_dim=E, len_q=4)
STAGES = [f"stt:mit.stage{s}" for s in range(1, 5)]
CALLS = ("extract", "session", "train", "predict")


def wire(n, size=S, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            rng.integers(0, 256, (n, size, size, 1), dtype=np.uint8),
            (rng.standard_normal((n, size, size, 2)) * 2).astype(np.float16))


def backbone(seed=0):
    return MiTEVP(CFG, HEAD, seed=seed, device="cpu")


def run_extract():
    batches = [wire(B, seed=1), wire(1, seed=2)]  # a ragged tail, padded
    feats, _ = extract_features(make_raw_feature_fn(backbone()), batches, B + 1, E, B)
    return [torch.from_numpy(feats)]


def run_session():
    session = OnlineSession(backbone(), OnlineMamba(CausalMambaModel(MAMBA, seed=1,
                                                                     device="cpu")),
                            OnlineRefiner(RefinementTransformer(REFINER, seed=2, device="cpu")))
    img, seg, flow = wire(2, seed=3)
    return [torch.from_numpy(session.step(img[i], seg[i], flow[i])) for i in range(2)]


def run_train(steps=2):
    model = backbone()
    trainer = BackboneTrainer(model, TrainConfig(optim=OptimConfig(
        name="sgd", lr=1e-3, weight_decay=0.0, grad_clip_norm=None)),
        AugConfig(resize=72, crop=S, degrees=5.0))
    trainer.init()
    img, seg, flow = wire(B, size=72, seed=4)
    labels, ant = np.array([0, 3]), np.full((B, HEAD.num_phases), 2.0, np.float32)
    losses = [trainer.train_step(img, seg, flow, labels, ant, step=s)["loss"]
              for s in range(steps)]
    return losses + [p.detach().clone() for p in model.parameters() if p.requires_grad]


def run_predict():
    lfb = torch.from_numpy(np.random.default_rng(5).random((33, E), dtype=np.float32))
    return [predict_video(CausalMambaModel(MAMBA, seed=1, device="cpu"),
                          RefinementTransformer(REFINER, seed=2, device="cpu"), lfb)]


RUNS = {"extract": run_extract, "session": run_session, "train": run_train,
        "predict": run_predict}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def profiled(fn):
    """(fn's outputs, [(name, start ns, end ns)] of its stt: spans, the
    collector's left out)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(trace.PREFIX) and not name.startswith("stt:gc."):
            spans.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    return out, sorted(spans, key=lambda s: s[1])


def inside(spans, outer, name):
    """The spans called ``name`` inside the span ``outer``."""
    return [s for s in spans if s[0] == name and outer[1] <= s[1] and s[2] <= outer[2]]


@pytest.mark.parametrize("call", CALLS)
def test_no_profiler_no_record_function(monkeypatch, call):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    RUNS[call]()
    with trace.span("anything") as got:
        assert got is None


@pytest.mark.parametrize("call", CALLS)
def test_profiled_outputs_equal_unprofiled(call):
    plain = RUNS[call]()
    traced, _ = profiled(RUNS[call])
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_extract_spans():
    _, spans = profiled(run_extract)
    names = Counter(s[0] for s in spans)
    assert names == Counter({"stt:extract.h2d": 2, "stt:extract.forward": 2,
                             "stt:extract.drain": 2, "stt:mit.prompts": 2,
                             **{s: 2 for s in STAGES}})
    for fwd in (s for s in spans if s[0] == "stt:extract.forward"):
        assert len(inside(spans, fwd, "stt:mit.prompts")) == 1
        assert all(len(inside(spans, fwd, s)) == 1 for s in STAGES)


def test_session_spans():
    _, spans = profiled(run_session)
    names = Counter(s[0] for s in spans)
    per_frame = {"stt:session.features": 1, "stt:session.temporal": 1,
                 "stt:session.refiner": 1, "stt:mit.prompts": 1, **{s: 1 for s in STAGES}}
    assert names == Counter({k: 2 * v for k, v in per_frame.items()})
    for feat in (s for s in spans if s[0] == "stt:session.features"):
        assert len(inside(spans, feat, "stt:mit.prompts")) == 1
        assert all(len(inside(spans, feat, s)) == 1 for s in STAGES)


def test_train_spans():
    _, spans = profiled(lambda: run_train(steps=3))
    phases = ["stt:train.input", "stt:train.forward", "stt:train.backward", "stt:train.update"]
    assert Counter(s[0] for s in spans) == Counter({p: 3 for p in phases})
    assert [s[0] for s in spans] == phases * 3  # in step order, none nested in another
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


def test_predict_spans():
    _, spans = profiled(run_predict)
    assert [s[0] for s in spans] == ["stt:predict.temporal", "stt:predict.refiner"]


def test_gc_counted_and_spanned():
    before = trace.counters()["gc"]["gen2"]
    gc.collect()
    after = trace.counters()["gc"]["gen2"]
    assert after["collections"] == before["collections"] + 1
    assert after["pause_ms"] > before["pause_ms"] and after["max_pause_ms"] > 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gc.collect()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("stt:gc.gen2") == 1


def test_counters_snapshot():
    c = trace.counters()
    assert set(c) == {"gc", "launches", "feature_graph"}  # no card here: no allocator counters
    assert set(c["gc"]) == {"gen0", "gen1", "gen2"}
    assert set(c["feature_graph"]) == {"captures", "replays", "eager"}
    assert {"mit_block_forward", "mit_stage_forward", "selective_scan",
            "selective_scan_backward"} <= set(c["launches"])


def test_exported_serving_graph_holds_no_profiler_op():
    exported = export_feature_extractor(backbone(), B, size=S, use_fused=True)
    targets = [str(n.target) for g in (m.graph for m in exported.graph_module.modules()
                                       if isinstance(m, torch.fx.GraphModule))
               for n in g.nodes if n.op == "call_function"]
    assert "surgical_tpu.mit_block_forward.default" in targets  # the fused graph's kernels
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
