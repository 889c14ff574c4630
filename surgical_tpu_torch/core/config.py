"""Typed configuration tree.

The port's own copy of ``surgical_tpu/core/config.py`` (same classes, fields
and defaults): the port imports nothing of the JAX package.

The reference spreads configuration across three mechanisms — argparse flags
(`train_evp.py:25-46`), module-level constants (`tecno.py:93-111`) and
hyperparameters hardcoded inside model classes (`mix_transformer_evp.py:277-289`,
`adapter_transformer.py:20`). Here everything lives in one dataclass tree that
is JSON-serializable (for checkpoint manifests) and hashable where needed (so
configs can be static args to jitted functions).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple

# Cholec80 channel statistics used by every reference transform stack
# (train_evp.py:152,162; generate_evp_LFB.py:222).
CHOLEC80_MEAN = (0.41757566, 0.26098573, 0.25888634)
CHOLEC80_STD = (0.21938758, 0.1983, 0.19342837)

# Class re-weighting for the phase CE loss (tecno.py:124-130).
CHOLEC80_CLASS_WEIGHTS = (
    1.6411019141231247,
    0.19090963801041133,
    1.0,
    0.2502662616859295,
    1.9176363911137977,
    0.9840248158200853,
    2.174635818337618,
)

PHASE_NAMES = (
    "Preparation",
    "CalotTriangleDissection",
    "ClippingCutting",
    "GallbladderDissection",
    "GallbladderPackaging",
    "CleaningCoagulation",
    "GallbladderRetraction",
)


@dataclass(frozen=True)
class MSTCNConfig:
    """Multi-stage dilated causal TCN (reference mstcn.py:94-214).

    Training uses ``f_maps=64`` (tecno.py:105); the shipped inference
    checkpoint uses ``f_maps=32`` (trans_SV_output.py:144).
    """

    stages: int = 2
    layers: int = 8
    f_maps: int = 64
    f_dim: int = 2048
    out_features: int = 14  # 7 phase logits + 7 anticipation regressions
    causal: bool = True
    dropout: float = 0.5  # torch nn.Dropout() default (mstcn.py:206)


@dataclass(frozen=True)
class MambaConfig:
    """Causal Mamba drop-in for the MS-TCN (reference mstcn.py:282-343)."""

    layers: int = 8
    d_model: int = 64  # == mstcn f_maps
    f_dim: int = 2048
    out_features: int = 14
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    dropout: float = 0.1
    dt_rank: int | None = None  # default ceil(d_model / 16)

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank if self.dt_rank is not None else -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model


@dataclass(frozen=True)
class JambaConfig:
    """Hybrid Mamba-1 / attention temporal model in the field names of HF
    ``JambaConfig``; the defaults are AI21-Jamba2-3B's published
    ``config.json`` (28 layers, hidden 2560, attention on layers 7 and 21,
    20 query heads and 1 key/value head of width 128, SwiGLU 8192, Mamba-1
    d_state 16, expand 2, dt_rank 160, one expert: no MoE). The token
    embedding is a projection of the ``f_dim`` features and the LM head the
    ``out_features`` outputs. ``dtype`` is the parameters' and activations'
    (the published weights are bf16); "float32" for the CPU tests."""

    hidden_size: int = 2560
    num_hidden_layers: int = 28
    intermediate_size: int = 8192
    num_attention_heads: int = 20
    num_key_value_heads: int = 1
    attn_layer_offset: int = 7
    attn_layer_period: int = 14
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 160
    rms_norm_eps: float = 1e-6
    f_dim: int = 2048
    out_features: int = 14
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def layer_types(self) -> Tuple[str, ...]:
        """HF ``JambaConfig.layers_block_type``: attention where
        ``i % attn_layer_period == attn_layer_offset``, else Mamba."""
        return tuple("attention" if i % self.attn_layer_period == self.attn_layer_offset
                     else "mamba" for i in range(self.num_hidden_layers))

    def mamba(self) -> MambaConfig:
        """The Mamba mixers' block configuration. The published
        ``mamba_conv_bias`` (true) and ``mamba_proj_bias`` (false) are
        ``MambaBlock``'s fixed layout: a bias on the conv, none on the in/out
        projections."""
        return MambaConfig(layers=0, d_model=self.hidden_size, f_dim=self.f_dim,
                           out_features=self.out_features, d_state=self.mamba_d_state,
                           d_conv=self.mamba_d_conv, expand=self.mamba_expand, dropout=0.0,
                           dt_rank=self.mamba_dt_rank)


@dataclass(frozen=True)
class RefinerConfig:
    """Trans-SVNet-style refinement transformer
    (reference adapter_transformer.py:290-352; missing transformer2_3_1
    reconstructed from its call contract, see models/transsv.py)."""

    f_maps: int = 64  # d_ff; 32 at inference (trans_SV_output.py:144)
    f_dim: int = 2048
    out_features: int = 14  # d_model
    len_q: int = 30  # causal sliding window (adapter_transformer.py:20)
    n_layers: int = 1
    n_heads: int = 4

    @property
    def d_k(self) -> int:
        # attn dim decoupled from f_maps (adapter_transformer.py:315)
        return min(64, self.f_maps)


@dataclass(frozen=True)
class BackboneConfig:
    """Prompted SegFormer MiT-EVP backbone
    (reference mix_transformer_evp.py:218-449,893-944)."""

    variant: str = "b3"
    img_size: int = 224
    in_chans: int = 3
    embed_dims: Tuple[int, ...] = (64, 128, 320, 512)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    mlp_ratios: Tuple[int, ...] = (4, 4, 4, 4)
    depths: Tuple[int, ...] = (3, 4, 18, 3)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    qkv_bias: bool = True
    drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    # EVP prompt configuration (mix_transformer_evp.py:278-289)
    prompt_scale_factor: int = 4
    tuning_stage: str = "1234"
    input_type: str = "gaussian"  # gaussian | srm | fft | all | bimask | raw
    prompt_type: str = "highpass"  # for input_type='fft'
    freq_nums: float = 0.25
    handcrafted_tune: bool = True
    embedding_tune: bool = True
    adaptor: str = "adaptor"
    # optical-flow fusion (mix_transformer_evp.py:291-298)
    with_flow: bool = True
    flow_heads: int = 8

    @staticmethod
    def preset(variant: str, **overrides: Any) -> "BackboneConfig":
        if variant == "tiny":
            # CI/smoke preset: full architecture at minimal width
            base = dict(
                variant="tiny", embed_dims=(8, 16, 24, 32),
                num_heads=(1, 2, 4, 8), depths=(1, 1, 1, 1),
                drop_path_rate=0.0,
            )
            return BackboneConfig(**{**base, **overrides})
        depths = {
            "b0": (2, 2, 2, 2),
            "b1": (2, 2, 2, 2),
            "b2": (3, 4, 6, 3),
            "b3": (3, 4, 18, 3),
            "b4": (3, 8, 27, 3),
            "b5": (3, 6, 40, 3),
        }[variant]
        dims = (32, 64, 160, 256) if variant == "b0" else (64, 128, 320, 512)
        # overrides win over the preset's depths/embed_dims (e.g. cli
        # --depths for non-preset checkpoints) instead of TypeError-ing
        base = dict(variant=variant, embed_dims=dims, depths=depths)
        return BackboneConfig(**{**base, **overrides})


@dataclass(frozen=True)
class HeadConfig:
    """SegFormer pooled head with dual outputs (reference segformer_head.py:46-179)."""

    embedding_dim: int = 2048
    hidden: int = 512
    num_phases: int = 7
    dropout: float = 0.1


@dataclass(frozen=True)
class DataConfig:
    root: str = "data/cholec80"
    num_videos: int = 80
    fps_subsample: int = 25  # 25 fps -> 1 fps (get_path_labels.py)
    horizon_minutes: float = 5.0
    num_phases: int = 7
    img_size: int = 224
    resize_size: int = 250
    mean: Tuple[float, ...] = CHOLEC80_MEAN
    std: Tuple[float, ...] = CHOLEC80_STD
    # stage-1 split: 32 train / 8 val / 40 test; stage-2: 40 / - / 40
    # (get_path_labels.py:196-219; val ⊂ test by construction)
    train_videos_stage1: int = 32
    val_videos: int = 8
    test_videos: int = 40
    train_videos_stage2: int = 40


@dataclass(frozen=True)
class OptimConfig:
    name: str = "adamw"
    lr: float = 1e-4
    weight_decay: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    grad_clip_norm: float | None = 1.0
    # ReduceLROnPlateau equivalent (tecno.py:171-177)
    plateau_mode: str = "max"
    plateau_factor: float = 0.5
    plateau_patience: int = 3
    plateau_min_lr: float = 1e-6


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 42
    max_epochs: int = 100
    min_epochs: int = 4
    batch_size: int = 1
    horizon: float = 5.0
    class_weights: Tuple[float, ...] = CHOLEC80_CLASS_WEIGHTS
    optim: OptimConfig = field(default_factory=OptimConfig)
    # temporal sequence bucketing: pad whole-video T to the next bucket to
    # avoid an XLA recompile per video length (SURVEY §5 long-context)
    bucket_sizes: Tuple[int, ...] = (512, 1024, 2048, 4096, 6144, 8192)


@dataclass(frozen=True)
class MeshConfig:
    """1-D data-parallel mesh (the reference's only real multi-device axis —
    torch DataParallel at generate_evp_LFB.py:431 — made real here)."""

    data_axis: str = "data"
    num_devices: int | None = None  # None = all visible devices


@dataclass(frozen=True)
class PipelineConfig:
    """Whole-pipeline config: one tree replacing the six reference scripts'
    scattered constants."""

    data: DataConfig = field(default_factory=DataConfig)
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    mstcn: MSTCNConfig = field(default_factory=MSTCNConfig)
    mamba: MambaConfig = field(default_factory=MambaConfig)
    refiner: RefinerConfig = field(default_factory=RefinerConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def to_json(cfg: Any) -> str:
    return json.dumps(to_dict(cfg), indent=2, sort_keys=True)


def _from_dict(cls: type, payload: dict) -> Any:
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in payload:
            continue
        val = payload[f.name]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            val = _from_dict(f.type, val)
        elif isinstance(val, list):
            val = tuple(val)
        elif isinstance(val, dict):
            # nested dataclass referenced by string annotation
            sub = _NESTED.get((cls.__name__, f.name))
            if sub is not None:
                val = _from_dict(sub, val)
        kwargs[f.name] = val
    return cls(**kwargs)


_NESTED = {
    ("TrainConfig", "optim"): OptimConfig,
    ("PipelineConfig", "data"): DataConfig,
    ("PipelineConfig", "backbone"): BackboneConfig,
    ("PipelineConfig", "head"): HeadConfig,
    ("PipelineConfig", "mstcn"): MSTCNConfig,
    ("PipelineConfig", "mamba"): MambaConfig,
    ("PipelineConfig", "refiner"): RefinerConfig,
    ("PipelineConfig", "train"): TrainConfig,
    ("PipelineConfig", "mesh"): MeshConfig,
}


def from_json(cls: type, payload: str) -> Any:
    return _from_dict(cls, json.loads(payload))
