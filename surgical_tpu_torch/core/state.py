"""When state derived from a module's tensors is stale: the kernels' weight
layouts (``models/mit_fused.py``, ``models/mit_train.py``) and the live
session's CUDA graphs (``serving/graphs.py``) are rebuilt once any tensor
they were built from is replaced, moved or written in place
(``load_state_dict`` writes in place), and only then.
"""

from __future__ import annotations


def state_key(*modules) -> tuple:
    """The address and in-place version of every parameter and buffer of the
    module trees ``modules`` (None is skipped). One walk of the trees'
    dicts, which is ~6x faster than ``parameters()`` and ``buffers()``: the
    session takes the key every frame."""
    tensors, stack = [], list(modules)
    while stack:
        m = stack.pop()
        if m is not None:
            tensors += m._parameters.values()
            tensors += m._buffers.values()
            stack += m._modules.values()
    return tuple((t.data_ptr(), t._version) for t in tensors if t is not None)


def cached(owner, slot: str, key, build):
    """``build()``, kept in ``owner.__dict__[slot]`` beside ``key`` and built
    anew when called with another key."""
    kept = owner.__dict__.get(slot)
    if kept is None or kept[0] != key:
        kept = owner.__dict__[slot] = (key, build())
    return kept[1]
