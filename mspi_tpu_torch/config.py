"""Configuration for the ported slices: the dataclass fields the MViTv2-S
and VideoSwin-S audio-visual inference and training paths read.

Counterpart of `mspi_tpu/config.py` (same field names and defaults, so a
dict of overrides means the same thing to both packages). `mvitv2s`
encodes configs/MVITv2_S_16x4.yaml, `videoswins` the mmaction
swin_small_patch244_window877_kinetics400_1k backbone.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

MOTION_ENCODERS = ("mvitv2s", "videoswins")

# Channel dims and temporal lengths of the [v1..v4] feature pyramid for a
# 16-frame clip, and whether each lateral decoder layer applies a
# temporal-stride conv.
MOTION_ENCODER_EMBEDS = {"mvitv2s": (96, 192, 384, 768), "videoswins": (96, 192, 384, 768)}
MOTION_ENCODER_TDIMS = {"mvitv2s": (8, 8, 8, 8), "videoswins": (8, 8, 8, 8)}
LATERAL_BOOL = {"mvitv2s": (True, True, True, True), "videoswins": (True, True, True, True)}


@dataclass
class DataConfig:
    root: str = "./AuViDataset"
    num_frames: int = 16
    use_sound: bool = True
    resolution: Tuple[int, int] = (224, 384)


@dataclass
class TrainConfig:
    batch_size: int = 2
    gamma: float = 1.0  # weight of the SimSiam AV-alignment loss
    seed: int = 2023


@dataclass
class SolverConfig:
    lr: float = 1e-4
    max_epoch: int = 120
    weight_decay: float = 0.0
    monitored_epochs: Tuple[int, ...] = (60, 80, 100, 120)


@dataclass
class MViTConfig:
    """MViTv2-S 16x4 (configs/MVITv2_S_16x4.yaml): conv pooling, decomposed
    spatial + temporal rel-pos bias and residual pooling always on."""

    depth: int = 16
    num_heads: int = 1
    embed_dim: int = 96
    patch_kernel: Tuple[int, int, int] = (3, 7, 7)
    patch_stride: Tuple[int, int, int] = (2, 4, 4)
    patch_padding: Tuple[int, int, int] = (1, 3, 3)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    dim_mul: Tuple[Tuple[int, float], ...] = ((1, 2.0), (3, 2.0), (14, 2.0))
    head_mul: Tuple[Tuple[int, float], ...] = ((1, 2.0), (3, 2.0), (14, 2.0))
    pool_kvq_kernel: Tuple[int, int, int] = (3, 3, 3)
    pool_kv_stride_adaptive: Tuple[int, int, int] = (1, 8, 8)
    pool_q_stride: Tuple[Tuple[int, int, int, int], ...] = (
        (0, 1, 1, 1), (1, 1, 2, 2), (2, 1, 1, 1), (3, 1, 2, 2),
        (4, 1, 1, 1), (5, 1, 1, 1), (6, 1, 1, 1), (7, 1, 1, 1),
        (8, 1, 1, 1), (9, 1, 1, 1), (10, 1, 1, 1), (11, 1, 1, 1),
        (12, 1, 1, 1), (13, 1, 1, 1), (14, 1, 2, 2), (15, 1, 1, 1),
    )
    # feature-pyramid tap points
    out_indices: Tuple[int, int, int, int] = (0, 2, 13, 15)


@dataclass
class VideoSwinConfig:
    """VideoSwin-S (swin_small_patch244_window877_kinetics400_1k). The
    patch embed has no norm, as the JAX backbone builds it."""

    patch_size: Tuple[int, int, int] = (2, 4, 4)
    embed_dim: int = 96
    depths: Tuple[int, int, int, int] = (2, 2, 18, 2)
    num_heads: Tuple[int, int, int, int] = (3, 6, 12, 24)
    window_size: Tuple[int, int, int] = (8, 7, 7)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True


@dataclass
class ModelConfig:
    motion_encoder: str = "mvitv2s"
    de_embed_dim: int = 192
    aud_embed_dim: int = 512
    sync_num_blocks: int = 3
    sync_num_heads: int = 4
    simsiam_hidden: int = 2048
    # Released torch checkpoints, loaded when present.
    motion_encoder_weight: str = ""
    audio_encoder_weight: str = ""
    image_saliency_encoder_weight: str = ""
    mvit: MViTConfig = field(default_factory=MViTConfig)
    videoswin: VideoSwinConfig = field(default_factory=VideoSwinConfig)

    @property
    def embed_dims(self) -> Tuple[int, int, int, int]:
        return MOTION_ENCODER_EMBEDS[self.motion_encoder]

    @property
    def lateral_bool(self) -> Tuple[bool, bool, bool, bool]:
        return LATERAL_BOOL[self.motion_encoder]

    @property
    def lateral_stride(self) -> Tuple[int, int, int, int]:
        return (2, 2, 2, 2)

    @property
    def pyramid_tdims(self) -> Tuple[int, int, int, int]:
        return MOTION_ENCODER_TDIMS[self.motion_encoder]


@dataclass
class MSPIConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)

    def num_vis_tokens(self) -> int:
        """Tokens entering SyncBlock: T4 * H/32 * W/32 (672 for MViTv2-S and
        VideoSwin-S at 16x224x384)."""
        h, w = self.data.resolution
        t4 = max(1, self.model.pyramid_tdims[3] * self.data.num_frames // 16)
        return t4 * (h // 32) * (w // 32)


def _merge_into_dataclass(obj: Any, overrides: Dict[str, Any]) -> Any:
    """Overlay a dict onto a dataclass tree (case-insensitive keys; unknown
    keys are ignored, as in the JAX package)."""
    if not dataclasses.is_dataclass(obj):
        return overrides
    names = {f.name.lower(): f.name for f in dataclasses.fields(obj)}
    updates = {}
    for key, value in overrides.items():
        name = names.get(key.lower())
        if name is None:
            continue
        current = getattr(obj, name)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            updates[name] = _merge_into_dataclass(current, value)
        else:
            if isinstance(current, tuple) and isinstance(value, list):
                value = tuple(tuple(v) if isinstance(v, list) else v for v in value)
            updates[name] = value
    return dataclasses.replace(obj, **updates)


def get_config(motion_encoder: str = "mvitv2s",
               overrides: Optional[Dict[str, Any]] = None) -> MSPIConfig:
    """The full config for a motion encoder, with optional dict overrides."""
    if motion_encoder not in MOTION_ENCODERS:
        raise NotImplementedError(
            f"motion encoder {motion_encoder!r} not yet ported "
            f"(ported: {MOTION_ENCODERS})")
    cfg = MSPIConfig()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             motion_encoder=motion_encoder))
    if overrides:
        cfg = _merge_into_dataclass(cfg, overrides)
    return cfg
