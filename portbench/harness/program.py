"""The system under test, built from a configuration file.

The configuration names the program's constructors and configuration
classes as data (``"package.module:Name"``); this module builds them on the
meta device, gives them the seeded weights on the card (``weights.build``)
and keeps the benchmark's copy of those weights for the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import files, weights


def make_config(spec: dict, key: str = "config", cls_key: str = "config_class"):
    cls = files.resolve(spec[cls_key])
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in spec[key].items()})


def backbone(config: dict, seed: int, device):
    """(MiTEVP, state dict) of the configuration's backbone and head."""
    spec = config["backbone"]
    args = (make_config(spec), make_config(spec, "head", "head_class"))
    return weights.build(files.resolve(spec["constructor"]), args, seed, "backbone", device)


def temporal(config: dict, seed: int, device):
    spec = config["temporal"]
    return weights.build(files.resolve(spec["constructor"]), (make_config(spec),), seed,
                         "temporal", device)


def refiner(config: dict, seed: int, device):
    spec = config["refiner"]
    return weights.build(files.resolve(spec["constructor"]), (make_config(spec),), seed,
                         "refiner", device)


def host_rng(seed: int, purpose: int) -> np.random.Generator:
    """The benchmark's host-side draws (orders, samples) from the run's seed."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
                                  purpose])
