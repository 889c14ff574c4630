"""The backbone trainer's step as CUDA graphs (``train/train_graph.py``).

On the CPU (tier 1):

- ``train_step`` stays eager there, equals ``eager_step`` bit for bit and
  counts each step as eager in ``counters()["train_graph"]``;
- the masks the input stage draws equal, bit for bit, those
  ``graph_forward`` and ``fused_train_forward`` draw from the same
  generator, and each forward gives the same outputs from either;
- the key changes on each thing the graphs bake in (the batch's shapes and
  dtypes, flow or none, masks given or drawn and their shapes,
  ``use_fused``, the compute dtype, the augmentation's configuration, a
  group's hyperparameter, the optimizer's class, a trunk tensor written or
  replaced, a trained tensor or the optimizer's state replaced) and on
  nothing else: not on a step's in-place update of the trained leaves, the
  BatchNorm statistics and the momentum, nor on (epoch, step), the
  augmentation parameters or the masks' values;
- the whole graphed step on a stand-in card: a ``CUDAGraph`` whose capture
  records the operations and then undoes their writes (a capture does not
  execute), and whose replay runs them again into the tensors the capture
  gave, with stand-in streams. Over 6 steps, with both graphs, with flow
  and without, masks given and drawn, the graphed trainer's losses,
  gradients, momentum buffers, parameters and BatchNorm statistics equal an
  eager trainer's bit for bit; one capture, the rest replays. ``set_lr``,
  ``load_state_dict`` and a batch of another size capture again; Adam's
  update stays eager after the two replays.

On the card (``cuda``; the file imports no JAX: ``python -m pytest
--noconftest tests/test_torch_train_graph.py -m cuda``), at b0 widths with
one block per stage, 8 frames of 250-px wire frames cropped to 224:

- eight graphed steps against eight eager steps on a trainer of the same
  seed, with ``use_fused`` true and false, with flow and without, masks
  given and drawn: losses, gradients, momentum buffers, parameters and
  BatchNorm statistics. The fused path bit for bit; the flax path bit for
  bit where a second eager run is (on an H100 it always was), and
  otherwise within the two eager runs' difference;
- ``set_lr``, ``load_state_dict`` and a batch of another size between steps
  capture again and give the eager steps' numbers; Adam's update stays
  eager and gives them too.
"""

import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from surgical_tpu_torch.core.config import BackboneConfig, HeadConfig, OptimConfig, TrainConfig
from surgical_tpu_torch.data.transforms import AugConfig, draw_params
from surgical_tpu_torch.models.mit_evp import MiTEVP
from surgical_tpu_torch.models.mit_train import draw_masks, fused_train_forward
from surgical_tpu_torch.train import train_graph
from surgical_tpu_torch.train.backbone import BackboneTrainer
from surgical_tpu_torch.train.optim import set_lr
from surgical_tpu_torch.utils.trace import counters

TINY = BackboneConfig.preset("tiny", drop_path_rate=0.1, img_size=64)
HEAD = HeadConfig(embedding_dim=64, hidden=32, dropout=0.1)
AUG = AugConfig(resize=72, crop=64)
B = 2
SGD = OptimConfig(name="sgd", lr=0.05, weight_decay=0.0, grad_clip_norm=None)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trainer(use_fused=False, optim=SGD, cfg=TINY, head=HEAD, aug=AUG, device="cpu",
            dtype=torch.float32, seed=0):
    t = BackboneTrainer(MiTEVP(cfg, head, seed=seed, device=device),
                        TrainConfig(optim=optim), aug, use_fused=use_fused, compute_dtype=dtype)
    t.init()
    return t


def wire(n, seed=0, b=B, size=72, flow=True):
    """n wire batches (img_u8, seg_u8, flow_f16 or None, labels, ant)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
             rng.integers(0, 256, (b, size, size, 1), dtype=np.uint8),
             rng.standard_normal((b, size, size, 2)).astype(np.float16) if flow else None,
             rng.integers(0, 7, b).astype(np.int32),
             rng.uniform(0, 1, (b, 7)).astype(np.float32)) for _ in range(n)]


def given_masks(t, b, seed):
    """A set of masks drawn from a generator of the test's own."""
    m = t.model
    return draw_masks(m.cfg, m.head_cfg, b, torch.Generator(t.device).manual_seed(seed))


def delta(before):
    after = counters()["train_graph"]
    return {k: after[k] - before[k] for k in after}


def state(t):
    """Everything a step writes: parameters, BatchNorm statistics,
    gradients, momentum buffers (by parameter name)."""
    named = dict(t.model.named_parameters())
    out = {f"sd.{k}": v for k, v in t.model.state_dict().items()}
    out.update({f"grad.{k}": p.grad for k, p in named.items() if p.grad is not None})
    out.update({f"opt.{k}.{s}": v for k, p in named.items()
                for s, v in t.optimizer.state.get(p, {}).items() if isinstance(v, torch.Tensor)})
    return out


def assert_same(got, want):
    """Equal keys, each tensor equal bit for bit."""
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# -- CPU: the eager path --------------------------------------------------------

@pytest.mark.parametrize("use_fused", [False, True])
def test_cpu_step_stays_eager(use_fused):
    graphed, eager = trainer(use_fused), trainer(use_fused)
    before = counters()["train_graph"]
    for s, batch in enumerate(wire(3)):
        got = graphed.train_step(*batch, step=s)
        want = eager.eager_step(*batch, step=s)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert delta(before) == {"captures": 0, "replays": 0, "eager": 3}
    assert counters()["train_graph"] == train_graph.COUNTS
    assert graphed.graph.captured is None
    assert_same(state(graphed), state(eager))


@pytest.mark.parametrize("use_fused", [False, True])
def test_input_stage_draws_the_forwards_masks(use_fused):
    t = trainer(use_fused)
    batch = wire(1)[0]
    img, seg, flow, labels, ant, masks = t._input(*batch, 3, 5, draw=True)
    want = draw_masks(TINY, HEAD, B, t._generator(3, 5, "droppath"))
    got_leaves, spec = pytree.tree_flatten(masks)
    want_leaves, want_spec = pytree.tree_flatten(want)
    assert spec == want_spec
    assert all(torch.equal(a, b) for a, b in zip(got_leaves, want_leaves))
    # and the forward gives the same outputs from them as from its own draw
    with torch.no_grad():
        if use_fused:
            run = lambda **kw: fused_train_forward(t.model, img, seg, flow, dtype=t.dtype, **kw)
        else:
            run = lambda **kw: t.model.graph_forward(img, seg, flow, train=True, dtype=t.dtype,
                                                     **kw)
        from_input = run(masks=masks)
        from_forward = run(generator=t._generator(3, 5, "droppath"))
    for a, b in zip(pytree.tree_leaves(from_input), pytree.tree_leaves(from_forward)):
        assert torch.equal(a, b)


def test_input_stage_keeps_given_masks():
    t = trainer()
    given = given_masks(t, B, 7)
    *_, masks = t._input(*wire(1)[0], draw=True, masks=given)
    assert masks is given


# -- CPU: the key -----------------------------------------------------------------

def _args(batch, masks=None, epoch=0, step=0, aug=None):
    return (*batch, epoch, step, aug, masks)


CHANGES = ["batch", "wire_dtype", "no_flow", "masks_given", "masks_shape", "use_fused", "dtype",
           "aug_cfg", "lr", "momentum", "optimizer", "trunk_written", "trunk_replaced",
           "trained_replaced", "buffer_replaced", "opt_state_replaced"]


@pytest.mark.parametrize("change", CHANGES)
def test_key_changes(change):
    t = trainer()
    batch = wire(2)
    t.train_step(*batch[0])  # makes the momentum buffers
    args = _args(batch[1])
    key = t.graph.key(*args)
    assert t.graph.key(*args) == key
    m = t.model
    if change == "batch":
        args = _args(wire(1, b=B + 1)[0])
    elif change == "wire_dtype":
        args = _args((batch[1][0], batch[1][1], batch[1][2].astype(np.float32), *batch[1][3:]))
    elif change == "no_flow":
        args = _args((*batch[1][:2], None, *batch[1][3:]))
    elif change == "masks_given":
        args = _args(batch[1], given_masks(t, B, 1))
    elif change == "masks_shape":
        key = t.graph.key(*_args(batch[1], given_masks(t, B, 1)))
        args = _args(batch[1], given_masks(t, B + 1, 1))
    elif change == "use_fused":
        t.use_fused = True
    elif change == "dtype":
        t.dtype = torch.bfloat16
    elif change == "aug_cfg":
        t.aug_cfg = dataclasses.replace(AUG, crop=56)
    elif change == "lr":
        set_lr(t.optimizer, 0.01)
    elif change == "momentum":
        t.optimizer.param_groups[0]["momentum"] = 0.5
    elif change == "optimizer":
        t.optimizer = type("SGD2", (torch.optim.SGD,), {})(t.optimizer.param_groups, lr=0.05)
    elif change == "trunk_written":
        m.load_state_dict(m.state_dict())
    elif change == "trunk_replaced":
        m.block1[0].attn.q.weight = torch.nn.Parameter(m.block1[0].attn.q.weight.detach().clone(),
                                                       requires_grad=False)
    elif change == "trained_replaced":
        m.head.fc[0].weight.data = m.head.fc[0].weight.data.clone()
    elif change == "buffer_replaced":
        m.head.linear_fuse.bn.running_mean = m.head.linear_fuse.bn.running_mean.clone()
    elif change == "opt_state_replaced":  # as from a checkpoint: new tensors
        t.optimizer.load_state_dict(copy.deepcopy(t.optimizer.state_dict()))
    assert t.graph.key(*args) != key


def test_key_kept_by_a_step():
    t = trainer()
    batch = wire(4)
    t.train_step(*batch[0], step=0)
    key = t.graph.key(*_args(batch[1]))
    versions = [p._version for p in t.model.parameters() if p.requires_grad]
    for s in (1, 2):
        t.train_step(*batch[s], epoch=1, step=s)
    assert [p._version for p in t.model.parameters() if p.requires_grad] != versions
    assert t.graph.key(*_args(batch[3], epoch=4, step=9)) == key
    aug = draw_params(torch.Generator().manual_seed(0), AUG, B)
    assert t.graph.key(*_args(batch[1], aug=aug)) == key
    assert (t.graph.key(*_args(batch[1], given_masks(t, B, 1)))
            == t.graph.key(*_args(batch[2], given_masks(t, B, 2))))


# -- CPU: the graphed step on a stand-in card -----------------------------------

class _Recorder(TorchDispatchMode):
    """Records every operation that is not a view, and before an operation
    writes a tensor for the first time keeps a copy of it."""

    def __init__(self, ops, saved):
        super().__init__()
        self.ops, self.saved = ops, saved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            value = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in value if isinstance(value, (list, tuple)) else [value]:
                if isinstance(t, torch.Tensor) and id(t) not in self.saved:
                    self.saved[id(t)] = (t, t.clone())
        out = func(*args, **kwargs)
        if not func.is_view:  # a view aliases a tensor the replay writes into
            self.ops.append((func, args, kwargs, out))
        return out


class ReplayGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: the capture runs
    the operations, records them and then undoes every write they made to a
    tensor (a capture executes nothing); a replay runs them again on the
    same tensors and writes each result into the tensor the capture gave,
    as a graph replays into the addresses it captured."""

    modes = []

    def capture_begin(self, pool=None, capture_error_mode="global"):
        ReplayGraph.modes.append(capture_error_mode)
        self.ops, self._saved = [], {}
        self._mode = _Recorder(self.ops, self._saved)
        self._mode.__enter__()

    def capture_end(self):
        self._mode.__exit__(None, None, None)
        with torch.no_grad():
            for t, kept in self._saved.values():
                t.copy_(kept)
        self._saved = None

    def replay(self):
        with torch.no_grad():
            for func, args, kwargs, out in self.ops:
                res = func(*args, **kwargs)
                for o, r in zip(pytree.tree_leaves(out), pytree.tree_leaves(res)):
                    if isinstance(o, torch.Tensor) and o is not r:
                        o.copy_(r.view(o.shape))


class _Stream:
    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def stand_in_card(monkeypatch):
    """``torch.cuda``'s graphs and streams stood in for on the CPU; a
    trainer made to take the card's path with ``on_card(trainer)``."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", ReplayGraph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None, raising=False)
    ReplayGraph.modes = []

    def on_card(t):
        t.graph.device = torch.device("cuda")
        return t
    return on_card


def run_both(graphed, eager, batches, masks=None, after=None):
    """Each batch through the graphed and the eager trainer: the outputs
    equal bit for bit, each step; ``after(s)`` runs between steps on both."""
    for s, batch in enumerate(batches):
        m = None if masks is None else masks[s]
        got = graphed.train_step(*batch, 0, s, None, m)
        want = eager.eager_step(*batch, 0, s, None, m)
        for k in want:
            assert torch.equal(got[k], want[k]), (s, k)
        if after is not None:
            after(s)


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("flow", [True, False])
@pytest.mark.parametrize("given", [False, True])
def test_graphed_steps_equal_eager(stand_in_card, use_fused, flow, given):
    graphed, eager = stand_in_card(trainer(use_fused)), trainer(use_fused)
    batches = wire(6, flow=flow)
    masks = [given_masks(eager, B, 10 + s) for s in range(6)] if given else None
    before = counters()["train_graph"]
    outs = []
    for s, batch in enumerate(batches):
        m = None if masks is None else masks[s]
        got = graphed.train_step(*batch, 0, s, None, m)
        want = {k: v.clone() for k, v in eager.eager_step(*batch, 0, s, None, m).items()}
        outs.append((got, want))
        assert_same(state(graphed), state(eager))
    for s, (got, want) in enumerate(outs):  # each step's numbers stay the caller's
        for k in want:
            assert torch.equal(got[k], want[k]), (s, k)
    assert delta(before) == {"captures": 1, "replays": 5, "eager": 1}
    assert set(ReplayGraph.modes) == {"global"} and len(ReplayGraph.modes) == 3
    c = graphed.graph.captured
    assert c.update is not None
    assert all(p.grad is g for p, g in c.grads)
    assert len(c.grads) == sum(p.grad is not None for p in eager.model.parameters())


def test_set_lr_and_load_state_dict_capture_again(stand_in_card):
    graphed, eager = stand_in_card(trainer()), trainer()
    donor = trainer(seed=5)
    batches = wire(7, seed=3)
    before = counters()["train_graph"]

    def after(s):
        if s == 1:
            set_lr(graphed.optimizer, 0.02)
            set_lr(eager.optimizer, 0.02)
        if s == 3:
            for t in (graphed, eager):
                t.model.load_state_dict(donor.model.state_dict())
                t.optimizer.load_state_dict(copy.deepcopy(t.optimizer.state_dict()))
    run_both(graphed, eager, batches, after=after)
    assert_same(state(graphed), state(eager))
    assert delta(before) == {"captures": 3, "replays": 4, "eager": 3}


def test_eager_grads_between_replays(stand_in_card):
    """An eager ``loss_and_grad`` and a ``zero_grad`` between replayed steps
    (as a check of the gradients does) leave the next replays' numbers and
    ``.grad`` tensors the eager trainer's."""
    graphed, eager = stand_in_card(trainer()), trainer()
    batches = wire(6, seed=11)
    before = counters()["train_graph"]

    def after(s):
        if s == 2:
            for t in (graphed, eager):
                t.loss_and_grad(*batches[5], step=9)
                t.model.zero_grad(set_to_none=True)
    run_both(graphed, eager, batches[:5], after=after)
    assert_same(state(graphed), state(eager))
    assert delta(before) == {"captures": 1, "replays": 4, "eager": 1}


def test_another_batch_size_captures_again(stand_in_card):
    graphed, eager = stand_in_card(trainer()), trainer()
    batches = wire(2, seed=4) + wire(2, seed=5, b=B + 1) + wire(2, seed=6)
    before = counters()["train_graph"]
    run_both(graphed, eager, batches)
    assert_same(state(graphed), state(eager))
    assert delta(before) == {"captures": 3, "replays": 3, "eager": 3}


def test_adam_update_stays_eager(stand_in_card):
    adam = OptimConfig(name="adam", lr=1e-3, weight_decay=0.0, grad_clip_norm=None)
    graphed, eager = stand_in_card(trainer(optim=adam)), trainer(optim=adam)
    before = counters()["train_graph"]
    run_both(graphed, eager, wire(4, seed=7))
    assert_same(state(graphed), state(eager))
    assert delta(before) == {"captures": 1, "replays": 3, "eager": 1}
    assert graphed.graph.captured.update is None and len(ReplayGraph.modes) == 2


def test_clip_hook_is_captured(stand_in_card):
    clip = dataclasses.replace(SGD, grad_clip_norm=0.5)
    graphed, eager = stand_in_card(trainer(optim=clip)), trainer(optim=clip)
    run_both(graphed, eager, wire(4, seed=8))
    assert_same(state(graphed), state(eager))
    assert graphed.graph.captured.update is not None


def test_block_dropout_without_masks_stays_eager(stand_in_card):
    cfg = dataclasses.replace(TINY, drop_rate=0.1)
    graphed, eager = stand_in_card(trainer(cfg=cfg)), trainer(cfg=cfg)
    before = counters()["train_graph"]
    run_both(graphed, eager, wire(2, seed=9))
    assert delta(before) == {"captures": 0, "replays": 0, "eager": 2}


# -- the card -----------------------------------------------------------------------

# The flax path's backward may sum with atomics (the head's upsampling, the
# convolutions' weight gradients), so two eager runs of the same steps need
# not agree in the last bits; on an H100 they were equal bit for bit at
# these shapes and at b3 with batch 88. Where a second eager run equals the
# first, the graphed run is held to it bit for bit; where it does not, to
# within that tensor's difference between the two eager runs.
CARD_CFG = BackboneConfig.preset("b0", depths=(1, 1, 1, 1))
CARD_HEAD = HeadConfig(embedding_dim=256, hidden=128)
CARD_AUG = AugConfig(resize=250, crop=224)
CARD_B = 8


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU build")


def card_trainer(use_fused, optim=SGD, seed=21):
    return trainer(use_fused, optim, cfg=CARD_CFG, head=CARD_HEAD, aug=CARD_AUG, device="cuda",
                   dtype=torch.bfloat16, seed=seed)


def card_batches(n, seed=22, b=CARD_B, flow=True):
    return wire(n, seed=seed, b=b, size=250, flow=flow)


def card_run(t, batches, masks=None, graphed=True, after=None):
    """Each step's outputs and, after the last, the trainer's state."""
    outs = []
    for s, batch in enumerate(batches):
        m = None if masks is None else masks[s]
        step = t.train_step if graphed else t.eager_step
        outs.append({k: v.clone() for k, v in step(*batch, 0, s, None, m).items()})
        if after is not None:
            after(t, s)
    torch.cuda.synchronize()
    return outs, {k: v.clone() for k, v in state(t).items()}


def card_compare(use_fused, got, want, again):
    """The graphed run against the eager run: the fused path bit for bit,
    the flax path bit for bit where the second eager run is, else within
    the two eager runs' difference."""
    (go, gs), (wo, ws), (ao, as_) = got, want, again
    pairs = [(f"{s}.{k}", a[k], b[k], c[k]) for s, (a, b, c) in enumerate(zip(go, wo, ao))
             for k in b] + [(k, gs[k], ws[k], as_[k]) for k in ws]
    for name, g, w, a in pairs:
        if use_fused or torch.equal(a, w):
            assert torch.equal(g, w), name
        else:
            gap = lambda x: float((x.double() - w.double()).abs().max())
            assert gap(g) <= gap(a), name


@pytest.mark.cuda
@pytest.mark.parametrize("use_fused", [True, False])
@pytest.mark.parametrize("flow", [True, False])
@pytest.mark.parametrize("given", [True, False])
def test_card_graphed_steps_equal_eager(use_fused, flow, given):
    _needs_card()
    batches = card_batches(8, flow=flow)
    ref = card_trainer(use_fused)
    masks = [given_masks(ref, CARD_B, 30 + s) for s in range(8)] if given else None
    before = counters()["train_graph"]
    got = card_run(card_trainer(use_fused), batches, masks)
    assert delta(before) == {"captures": 1, "replays": 7, "eager": 1}
    want = card_run(ref, batches, masks, graphed=False)
    again = card_run(card_trainer(use_fused), batches, masks, graphed=False)
    card_compare(use_fused, got, want, again)


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["set_lr", "load_state_dict", "batch_size", "adam"])
def test_card_changes_capture_again(change):
    _needs_card()
    use_fused = True
    batches = card_batches(6, seed=23)
    optim = SGD
    donor = card_trainer(use_fused, seed=40)
    if change == "batch_size":
        batches = batches[:3] + card_batches(3, seed=24, b=CARD_B // 2)
    if change == "adam":
        optim = OptimConfig(name="adam", lr=1e-3, weight_decay=0.0, grad_clip_norm=None)

    def after(t, s):
        if s != 2:
            return
        if change == "set_lr":
            set_lr(t.optimizer, 0.02)
        elif change == "load_state_dict":
            t.model.load_state_dict(donor.model.state_dict())

    before = counters()["train_graph"]
    got = card_run(card_trainer(use_fused, optim), batches, after=after)
    captures = 1 if change == "adam" else 2
    assert delta(before) == {"captures": captures, "replays": 6 - captures,
                             "eager": captures}
    want = card_run(card_trainer(use_fused, optim), batches, graphed=False, after=after)
    card_compare(use_fused, got, want, want)
