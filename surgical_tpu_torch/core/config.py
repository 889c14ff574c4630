"""Configuration dataclasses and Cholec80 constants, shared with the JAX
package: ``surgical_tpu/core/config.py`` imports only the standard library,
so the port uses it as it is."""

from surgical_tpu.core.config import (  # noqa: F401
    CHOLEC80_CLASS_WEIGHTS,
    CHOLEC80_MEAN,
    CHOLEC80_STD,
    PHASE_NAMES,
    BackboneConfig,
    HeadConfig,
    MSTCNConfig,
    RefinerConfig,
    TrainConfig,
)
