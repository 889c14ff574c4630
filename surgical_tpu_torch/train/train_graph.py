"""The backbone trainer's step as CUDA graphs of its forward, backward and
update on static batch buffers.

Eagerly, a b3 step at batch 88 issues 6500-8250 device operations through
Python and the autograd engine, and the card waits on the host for most of
the step. ``TrainGraph`` runs ``BackboneTrainer.train_step`` as a
``serving/graphs.py::GraphedLeg``:

- the input stage stays eager (``stt:train.input``): the wire batch's copies
  to the card, its dequantization and augmentation, the targets, and the
  DropPath and dropout masks, drawn there when none are given from the
  generator and in the order the forward draws them (the same bits); the
  batch is then copied into the static buffers;
- the first step of a key runs eagerly on the side stream (which also makes
  SGD's momentum buffers, so that the captured update takes the path of
  every later step) and is then captured, into one pool, as three graphs:
  the forward and the loss, ``loss.backward()`` (whose ``.grad`` tensors stay
  the parameters' and are overwritten by each replay; the eager step's
  gradients are copied into them), and the optimizer step with the
  BatchNorm statistics' write. A capture does not execute, so no step is
  applied twice;
- a step of the same key is replayed, each graph under the span that holds
  its eager work (``train.forward``, ``train.backward``, ``train.update``);
  an optimizer whose step cannot be captured as built (anything but SGD,
  with or without the clip hook: Adam without ``capturable`` refuses
  capture) steps eagerly in ``train.update`` after the two replays. The
  loss, ce, reg and correct are returned as copies.

The key holds what the graphs bake in: the wire batch's shapes and dtypes,
flow or none, masks given (their tree, shapes and dtypes) or drawn, the
augmentation's configuration, ``use_fused`` and the compute dtype, the
optimizer's class and each group's hyperparameters (``lr`` is a Python
float in the update), ``core/state.py::state_key`` of the trunk (the fused
path bakes its re-laid-out kernel weights) and the addresses, not the
versions, of the trained modules' parameters and buffers, of the groups'
parameters and of the optimizer's state, which every step writes in
place.

The leg engages on a card; a model with block dropout (``drop_rate`` > 0)
and no injected ``masks["drop"]`` steps eagerly, since the flax graph draws
those masks inside the forward. ``loss_and_grad`` (and so
``parallel/dryrun.py``'s batch-sharded step) is always eager.
``COUNTS`` (``utils/trace.py::counters()["train_graph"]``): captures,
replayed steps, eager steps.
"""

from __future__ import annotations

from collections import namedtuple

import torch
from torch.utils import _pytree as pytree

from surgical_tpu_torch.core.state import addresses, state_key
from surgical_tpu_torch.serving.graphs import GraphedLeg, layout
from surgical_tpu_torch.utils.trace import span


def copy_leaves(dst, src) -> None:
    """Copy the tensor leaves of ``src`` into those of ``dst`` (the same
    tree), one ``torch._foreach_copy_`` per dtype: the fast path copies one
    dtype per call, so a b3 batch's 57 masks take two calls."""
    groups = {}
    for d, s in zip(pytree.tree_leaves(dst), pytree.tree_leaves(src), strict=True):
        if isinstance(d, torch.Tensor):
            ds, ss = groups.setdefault(d.dtype, ([], []))
            ds.append(d)
            ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def graph_of(pool, work):
    """``work()`` captured into a new graph of the memory pool ``pool``:
    (graph, what work returned). Global mode, as PyTorch's whole-network
    capture: the autograd engine issues the backward from its own thread."""
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(pool=pool, capture_error_mode="global")
    try:
        return graph, work()
    finally:
        graph.capture_end()


_Captured = namedtuple("_Captured", "forward backward update static out stats grads")


class TrainGraph(GraphedLeg):
    """``trainer.train_step`` (a ``BackboneTrainer``) as a graphed leg over
    its arguments (img_u8, seg_u8, flow_f16, labels, ant, epoch, step,
    aug_params, masks)."""

    GRAD = True

    def __init__(self, trainer):
        super().__init__(trainer.device)
        self.trainer = trainer

    def engages(self, *args) -> bool:
        *_, masks = args
        return (self.trainer.model.cfg.drop_rate == 0.0
                or (masks is not None and masks.get("drop") is not None))

    def key(self, img_u8, seg_u8, flow_f16, labels, ant, epoch, step, aug_params,
            masks) -> tuple:
        from surgical_tpu_torch.train.backbone import is_trainable

        t = self.trainer
        trunk, trained = [], []
        for name, child in t.model.named_children():
            (trained if is_trainable(name) else trunk).append(child)
        given = None
        if masks is not None:
            leaves, spec = pytree.tree_flatten(masks)
            given = (spec, layout(*leaves))
        opt = t.optimizer
        groups = tuple((tuple((k, v) for k, v in g.items() if k != "params"),
                        tuple(p.data_ptr() for p in g["params"]),
                        tuple(s.data_ptr() for p in g["params"]
                              for s in opt.state.get(p, {}).values()
                              if isinstance(s, torch.Tensor)))
                       for g in opt.param_groups)
        return (layout(img_u8, seg_u8, flow_f16, labels, ant), given, t.aug_cfg, t.use_fused,
                t.dtype, type(opt), groups, state_key(*trunk), addresses(*trained))

    def eager(self, *args):
        return self.trainer.eager_step(*args)

    def capture(self, pool, buffers, *args):
        t = self.trainer
        batch = t._input(*args, draw=True)
        loss, out, stats = t._forward(*batch)
        t._backward(loss)
        t._update(stats)
        params = [p for g in t.optimizer.param_groups for p in g["params"]]
        eager_grads = [p.grad for p in params]
        dev = batch[0].device
        static = pytree.tree_map_only(torch.Tensor, lambda a: torch.empty_strided(
            a.size(), a.stride(), dtype=a.dtype, device=dev), batch)
        copy_leaves(static, batch)
        forward, (loss, outputs, stats) = graph_of(pool, lambda: t._forward(*static))
        backward, _ = graph_of(pool, lambda: t._backward(loss))
        update = None  # an optimizer other than SGD steps eagerly
        if type(t.optimizer) is torch.optim.SGD:
            update, _ = graph_of(pool, lambda: t._update(stats))
        grads = [(p, p.grad) for p in params if p.grad is not None]
        for p, g in zip(params, eager_grads):  # the captured ones hold nothing yet
            if g is not None:
                p.grad.copy_(g)
        return out, _Captured(forward, backward, update, static, outputs, stats, grads)

    def replay(self, *args):
        t, c = self.trainer, self.captured
        t._input(*args, draw=True, into=c.static)
        with span("train.forward"):
            c.forward.replay()
        with span("train.backward"):
            c.backward.replay()
            for p, g in c.grads:
                if p.grad is not g:
                    p.grad = g
        if c.update is None:
            t._update(c.stats)
        else:
            with span("train.update"):
                c.update.replay()
        return {k: v.clone() for k, v in c.out.items()}


COUNTS = TrainGraph.COUNTS
