"""Whole runs of each cell at tiny size on the CPU: the run is correct as
committed, its control is not, and neither is a run with the timed path
broken underneath (a state left unchanged, half the batch left out with
the mean taken over the rest, an answer altered where it is produced).
The harness's look for a card is skipped; the rest of a run is driven as
``run.py`` drives it."""

import pytest
import torch

import tiny


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_tiny_run_is_correct(cell):
    r = tiny.run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] == r["units"] == 3
    assert set(r["metrics"]) >= {"setup_s"} and len(r["metrics"]) == 2


@pytest.mark.parametrize("cell", ["b3-mstcn.extract", "b3-mstcn.train", "b0-mamba.stream"])
def test_control_reads_apart(cell):
    """The reference one precision lower (fp8 products) in the program's
    place reads at least three times the program on some number (the TF32
    control of the fp32 temporal cell needs the card)."""
    sound = {n: v for n, v, _ in tiny.run(cell)["checks"]}
    control = {n: v for n, v, _ in tiny.run(cell, control=True)["checks"]}
    assert max(control[n] / max(sound[n], 1e-30) for n in sound) >= 3.0, (sound, control)


def _patch(monkeypatch, spec, make):
    mod, _, attr = spec.partition(":")
    target = __import__(mod, fromlist=[attr])
    owner = target
    *path, last = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    monkeypatch.setattr(owner, last, make(getattr(owner, last)))


def _features_fault(kind):
    def make(orig):
        def factory(model, *a, **k):
            fn = orig(model, *a, **k)

            def broken(*args):
                out = fn(*args).clone()
                B = out.shape[0]
                if kind == "altered":
                    out[-1] *= 1.5
                else:
                    out[B // 2:] = out[:B // 2].mean(0)
                return out
            return broken
        return factory
    return make


@pytest.mark.parametrize("kind", ["altered", "half"])
def test_extract_fault_is_caught(monkeypatch, kind):
    _patch(monkeypatch, "surgical_tpu_torch.train.extract:make_raw_feature_fn",
           _features_fault(kind))
    assert not tiny.run("b3-mstcn.extract")["correct"]


def test_train_state_unchanged_is_caught(monkeypatch):
    def make(orig):
        def unchanged(self, *args, **kwargs):
            out, _ = self.loss_and_grad(*args[:5], kwargs.get("epoch", 0), kwargs.get("step", 0),
                                        kwargs.get("aug_params"), kwargs.get("masks"))
            return out
        return unchanged
    _patch(monkeypatch, "surgical_tpu_torch.train.backbone:BackboneTrainer.train_step", make)
    r = tiny.run("b3-mstcn.train")
    assert not r["correct"], r["checks"]


def test_train_half_batch_is_caught(monkeypatch):
    """Half of each batch left out, the loss scaled as a mean over the rest."""
    def make_step(orig):
        def half(self, img, seg, flow, labels, ant, epoch=0, step=0, aug_params=None,
                 masks=None):
            h = len(labels) // 2
            aug = type(aug_params)(*(t[:h] for t in aug_params))
            m = {"droppath": [(a[:h], b[:h]) for a, b in masks["droppath"]],
                 "dropout": masks["dropout"][:h]}
            return orig(self, img[:h], seg[:h], flow[:h], labels[:h], ant[:h], epoch, step, aug, m)
        return half

    def make_loss(orig):
        def doubled(*args):
            return tuple(2 * t for t in orig(*args))
        return doubled
    _patch(monkeypatch, "surgical_tpu_torch.train.backbone:BackboneTrainer.train_step", make_step)
    _patch(monkeypatch, "surgical_tpu_torch.train.backbone:backbone_loss", make_loss)
    r = tiny.run("b3-mstcn.train")
    assert not r["correct"], r["checks"]


def test_stream_altered_answer_is_caught(monkeypatch):
    def make(orig):
        def advance(self, feat):
            out = orig(self, feat)
            return out * 1.5 if self.frame_idx == 2 else out
        return advance
    _patch(monkeypatch, "surgical_tpu_torch.serving.online:OnlineSession.advance", make)
    assert not tiny.run("b0-mamba.stream")["correct"]


def test_video_altered_answer_is_caught(monkeypatch):
    def make(orig):
        def predict(temporal, refiner, lfb):
            out = orig(temporal, refiner, lfb).clone()
            out[-1] *= 1.5
            return out
        return predict
    _patch(monkeypatch, "surgical_tpu_torch.train.refiner:predict_video", make)
    assert not tiny.run("b0-mamba.video")["correct"]


def test_same_seed_same_inputs():
    """A seed gives the same inputs, weights and outputs twice."""
    a = tiny.run("b0-mamba.video")
    b = tiny.run("b0-mamba.video")
    assert a["checks"] == b["checks"]
    assert torch.equal(torch.tensor([c[1] for c in a["checks"]]),
                       torch.tensor([c[1] for c in b["checks"]]))


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_traced_run_reads_mfu_from_the_untraced_rest(cell):
    """A traced run profiles its first units, runs at least one more
    untraced, and its ``mfu`` reader reads that rest."""
    from harness import core, files

    ctx = tiny.context(cell, trace=True)
    ctx.workload["trace_units"] = 2
    bench = files.benchmark()
    e2e = [m["name"] for m in files.end_to_end_metrics(bench, cell)]
    r = core.run_cell(ctx, 0.0, 0.0, per_layer=files.per_layer_metrics(bench, cell, e2e),
                      max_units=1)
    assert r["units"] == 3 and r["correct"], r["checks"]
    mfu = [n for n in r["metrics"] if n.endswith(".mfu")]
    assert len(mfu) == 1 and 0 < r["metrics"][mfu[0]]["value"] < 100
    assert r["dilation"] > 0 and not ctx.tracing
