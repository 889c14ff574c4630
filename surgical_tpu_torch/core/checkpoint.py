"""Checkpoint store with metadata manifests.

Port of ``surgical_tpu/core/checkpoint.py`` on ``torch.save`` /
``torch.load(weights_only=True)``. The manifest is the JAX store's:
``step_XXXXXXXX.manifest.json`` with the keys ``step``, ``metrics``,
``config``, ``extra`` and ``has_aux``, so ``steps``, ``latest_step`` and
``best_step(metric, mode)`` answer the same queries over either store's
manifests. A step's weights are a state dict in ``step_XXXXXXXX.pt``: a
module's parameters and buffers (a backbone's BatchNorm running statistics
among them). Training state that continues a run (an optimizer's
``state_dict``) goes to ``step_XXXXXXXX.aux.pt``, any nesting of dicts and
lists over tensors and numbers.

The JAX store's orbax directories are not read: orbax is JAX's own format.
Weights enter this store as state dicts in the reference's key names: a
reference ``.pth``, a port module's ``state_dict()``, or a JAX parameter tree
through the ``export_*_state_dict`` functions of ``models/convert.py``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch

from surgical_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device


class CheckpointStore:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    # -- paths -------------------------------------------------------------
    def _path(self, step: int, suffix: str) -> str:
        return os.path.join(self.directory, f"step_{step:08d}{suffix}")

    # -- api ---------------------------------------------------------------
    def save(
        self,
        step: int,
        state_dict: Mapping,
        metrics: dict | None = None,
        config: dict | None = None,
        extra: dict | None = None,
        aux: Mapping | None = None,
    ) -> None:
        """Save ``state_dict`` (tensors or numpy arrays, kept on the CPU) and
        the manifest; ``aux`` holds what continues training but is not
        needed to use the model (e.g. ``{"optimizer": opt.state_dict()}``)."""
        torch.save(_cpu_tensors(state_dict), self._path(step, ".pt"))
        if aux is not None:
            torch.save(_cpu_tree(aux), self._path(step, ".aux.pt"))
        manifest = {
            "step": step,
            "metrics": _jsonable(metrics or {}),
            "config": _jsonable(config or {}),
            "extra": _jsonable(extra or {}),
            "has_aux": aux is not None,
        }
        with open(self._path(step, ".manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name.endswith(".manifest.json"):
                out.append(int(name[len("step_") : -len(".manifest.json")]))
        return sorted(out)

    def manifest(self, step: int) -> dict:
        with open(self._path(step, ".manifest.json")) as f:
            return json.load(f)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def best_step(self, metric: str, mode: str = "max") -> int | None:
        best, best_val = None, None
        for step in self.steps():
            val = self.manifest(step)["metrics"].get(metric)
            if val is None:
                continue
            if (
                best_val is None
                or (mode == "max" and val > best_val)
                or (mode == "min" and val < best_val)
            ):
                best, best_val = step, val
        return best

    def restore(self, step: int, model: torch.nn.Module, device=DEFAULT_DEVICE):
        """Load step ``step`` into ``model`` (``strict=True``), move it to
        ``device`` and return it."""
        device = resolve_device(device)
        sd = torch.load(self._path(step, ".pt"), map_location="cpu", weights_only=True)
        model.load_state_dict(sd, strict=True)
        return model.to(device)

    def has_aux(self, step: int) -> bool:
        return os.path.exists(self._path(step, ".aux.pt"))

    def restore_aux(self, step: int):
        """The ``aux`` saved with ``step``, its tensors on the CPU (an
        optimizer's ``load_state_dict`` moves them to its parameters')."""
        return torch.load(self._path(step, ".aux.pt"), map_location="cpu", weights_only=True)


def _cpu_tensors(sd: Mapping) -> dict:
    as_tensor = lambda v: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
    return {k: as_tensor(v).detach().cpu().contiguous() for k, v in sd.items()}


def _cpu_tree(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, Mapping):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_tree(v) for v in tree)
    return tree


def _jsonable(tree: Any) -> Any:
    def conv(x):
        if isinstance(x, (np.floating, np.integer)):
            return x.item()
        if isinstance(x, (np.ndarray, torch.Tensor)):
            return x.tolist()
        return x

    if isinstance(tree, dict):
        return {k: _jsonable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jsonable(v) for v in tree]
    return conv(tree)
