"""When state derived from a module's tensors is stale: the kernels' weight
layouts (``models/mit_fused.py``, ``models/mit_train.py``) and the live
session's and the backbone trainer's CUDA graphs (``serving/graphs.py``,
``train/train_graph.py``) are rebuilt once any tensor they were built from
is replaced, moved or written in place (``load_state_dict`` writes in
place), and only then.
"""

from __future__ import annotations


def tensors(*modules) -> list:
    """Every parameter and buffer slot of the module trees ``modules`` (a None
    module is skipped; an empty slot gives None), in one walk of the trees'
    dicts, which is ~6x faster than ``parameters()`` and ``buffers()``: the
    session takes a key every frame."""
    found, stack = [], list(modules)
    while stack:
        m = stack.pop()
        if m is not None:
            found += m._parameters.values()
            found += m._buffers.values()
            stack += m._modules.values()
    return found


def state_key(*modules) -> tuple:
    """The address and in-place version of every parameter and buffer of the
    module trees ``modules``."""
    return tuple((t.data_ptr(), t._version) for t in tensors(*modules) if t is not None)


def addresses(*modules) -> tuple:
    """The address of every parameter and buffer of ``modules``: the key of
    tensors that a graph reads where they lie, whatever is written into them
    (the trainable parameters and BatchNorm statistics of a training step)."""
    return tuple(t.data_ptr() for t in tensors(*modules) if t is not None)


def cached(owner, slot: str, key, build):
    """``build()``, kept in ``owner.__dict__[slot]`` beside ``key`` and built
    anew when called with another key."""
    kept = owner.__dict__.get(slot)
    if kept is None or kept[0] != key:
        kept = owner.__dict__[slot] = (key, build())
    return kept[1]
