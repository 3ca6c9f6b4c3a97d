"""Configuration for the ported slices: the dataclass fields the audio-visual
inference and training paths of the seven motion encoders read (MViTv2-S,
VideoSwin-S, UniFormer-B, S3D, X3D-L, SlowFast 4x16 R50 and MorphMLP-S),
and the serving options of `ModelConfig`.

Counterpart of `mspi_tpu/config.py` (same field names and defaults, so a
dict of overrides means the same thing to both packages). `mvitv2s`
encodes configs/MVITv2_S_16x4.yaml, `videoswins` the mmaction
swin_small_patch244_window877_kinetics400_1k backbone, `uniformerb`
configs/uniformer_b16x4_k400.yaml, `s3d` the S3D_features_only backbone
(kylemin/S3D as TASED-Net uses it), `x3dl` configs/X3D_L.yaml,
`slowfast4x16` configs/SLOWFAST_4x16_R50.yaml and `morphmlps`
configs/K400_MLP_S16x4.yaml (which runs only where (H/32)(W/32) is a
multiple of 49, e.g. at 224x224, not at the default 224x384).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

MOTION_ENCODERS = ("morphmlps", "mvitv2s", "s3d", "slowfast4x16", "uniformerb", "videoswins",
                   "x3dl")

# Channel dims and temporal lengths of the [v1..v4] feature pyramid for a
# 16-frame clip, and whether each lateral decoder layer applies a
# temporal-stride conv.
MOTION_ENCODER_EMBEDS = {"morphmlps": (112, 224, 392, 784), "mvitv2s": (96, 192, 384, 768),
                         "s3d": (192, 480, 832, 1024), "slowfast4x16": (320, 640, 1280, 2048),
                         "uniformerb": (64, 128, 320, 512), "videoswins": (96, 192, 384, 768),
                         "x3dl": (24, 48, 96, 192)}
MOTION_ENCODER_TDIMS = {"morphmlps": (8, 8, 8, 8), "mvitv2s": (8, 8, 8, 8), "s3d": (8, 8, 4, 4),
                        "slowfast4x16": (4, 4, 4, 4), "uniformerb": (8, 8, 8, 8),
                        "videoswins": (8, 8, 8, 8), "x3dl": (16, 16, 16, 16)}
LATERAL_BOOL = {"morphmlps": (True, True, True, True), "mvitv2s": (True, True, True, True),
                "s3d": (True, True, False, False), "slowfast4x16": (False, False, False, False),
                "uniformerb": (True, True, True, True), "videoswins": (True, True, True, True),
                "x3dl": (True, True, True, True)}
# The widths of each backbone's LN+MLP blocks, which quant="int8" sends to
# row 12 where C >= 256 (S3D, X3D, SlowFast and MorphMLP have none: only
# their SyncBlock's 512 goes there; MorphMLP's block MLPs are plain)
LN_MLP_WIDTHS = {"morphmlps": (), "mvitv2s": (96, 192, 384, 768), "s3d": (),
                 "slowfast4x16": (), "uniformerb": (320, 512),
                 "videoswins": (96, 192, 384, 768), "x3dl": ()}


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
class S3DConfig:
    pool_stride: int = 1  # cfg.MODEL.S3D.POOL_STRIDE


@dataclass
class X3DConfig:
    """X3D-L (configs/X3D_L.yaml)."""

    width_factor: float = 2.0
    depth_factor: float = 5.0
    bottleneck_factor: float = 2.25
    dim_c1: int = 12
    dim_c5: int = 2048


@dataclass
class SlowFastConfig:
    """SlowFast 4x16 R50 (configs/SLOWFAST_4x16_R50.yaml)."""

    alpha: int = 4
    beta_inv: int = 8
    fusion_conv_channel_ratio: int = 2
    fusion_kernel_sz: int = 5
    depth: int = 50
    width_per_group: int = 64
    num_groups: int = 1
    num_block_temp_kernel: Tuple[Tuple[int, int], ...] = ((3, 3), (4, 4), (6, 6), (3, 3))
    spatial_strides: Tuple[Tuple[int, int], ...] = ((1, 1), (2, 2), (2, 2), (2, 2))


@dataclass
class MorphMLPConfig:
    """MorphMLP-S 16x4 (configs/K400_MLP_S16x4.yaml)."""

    layers: Tuple[int, int, int, int] = (3, 4, 9, 3)
    segment_dim: Tuple[int, int, int, int] = (14, 28, 28, 49)
    mlp_ratios: Tuple[int, int, int, int] = (3, 3, 3, 3)
    embed_dims: Tuple[int, int, int, int] = (112, 224, 392, 784)
    t_stride: int = 4
    qkv_bias: bool = True


@dataclass
class UniFormerConfig:
    """UniFormer-B 16x4 (configs/uniformer_b16x4_k400.yaml): CBlocks in
    stages 1-2, joint space-time SABlocks in stages 3-4 (SplitSABlocks,
    divided attention, with split=True)."""

    embed_dim: Tuple[int, int, int, int] = (64, 128, 320, 512)
    depth: Tuple[int, int, int, int] = (5, 8, 20, 7)
    head_dim: int = 64
    mlp_ratio: float = 4.0
    split: bool = False


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
    uniformer: UniFormerConfig = field(default_factory=UniFormerConfig)
    s3d: S3DConfig = field(default_factory=S3DConfig)
    x3d: X3DConfig = field(default_factory=X3DConfig)
    slowfast: SlowFastConfig = field(default_factory=SlowFastConfig)
    morph: MorphMLPConfig = field(default_factory=MorphMLPConfig)
    # Serving options, off by default (the JAX package reads them from the
    # environment; the port reads nothing there).
    # "int8": the LN+MLP of every backbone and SyncBlock block with C >= 256
    # runs int8 weights x per-row int8 activations at inference, as
    # MSPI_QUANT=int8 does (mspi_tpu/ops/pallas/__init__.py).
    quant: str = ""
    # The ConvNeXt prior's blocks emit shortcut + gamma * mlp(LN(x)) from one
    # kernel, as MSPI_PRIOR_FOLD_RES=1 does (mspi_tpu/models/convnext.py).
    prior_fold_res: bool = False
    # The prior's stem and downsample LayerNorms run the standalone LayerNorm
    # kernel, as MSPI_PRIOR_LN_T=1 does.
    prior_ln_t: bool = False
    # MViT layout options (mspi_tpu/models/mvit.py, MultiScaleAttention and
    # HeadPool), inference and training alike unless stated:
    # attn_relk=False folds the rel-pos bias into augmented lanes,
    # q_aug = [q*scale | rel] and k_aug = [k | E], and runs the bias-free
    # attention kernel on them, as MSPI_ATTN_RELK=0 does.
    attn_relk: bool = True
    # attn_packed=True keeps the blocks with more than one head token-major
    # at inference: depthwise pools over all heads' lanes, the rel projections
    # packed, and the packed rel-pos attention kernel with the residual add
    # (MSPI_POOL_FAT=1 with MSPI_ATTN_PACKED=1; training stays head-major, as
    # under MSPI_POOL_PACKED_TRAIN=0). It needs the rel-pos kernel: with
    # attn_relk=False the augmented-lane attention runs instead, as the JAX
    # package's condition makes it.
    attn_packed: bool = False
    # dwconv=True runs every stride-1 pool (pool_q of the blocks without a q
    # stride, pool_k/pool_v of blocks 14-15) through the depthwise conv3d
    # kernel on channels-last tokens, as MSPI_DWCONV=1 does.
    dwconv: bool = False
    # remat=True recomputes each MViT MultiScaleBlock and VideoSwin block's
    # forward in the backward pass (torch.utils.checkpoint) in training, as
    # the JAX package's ModelConfig.remat runs nn.remat per block; the other
    # backbones accept it and ignore it.
    remat: bool = False

    def __post_init__(self):
        if self.quant not in ("", "int8"):
            raise ValueError(f"quant {self.quant!r}: expected '' or 'int8'")
        if self.quant == "int8":
            from mspi_tpu_torch.ops.kernels.ln_mlp import INT8_C, QUANT_MIN_C

            missing = [c for c in LN_MLP_WIDTHS.get(self.motion_encoder, ())
                       if c >= QUANT_MIN_C and c not in INT8_C]
            if missing:
                raise ValueError(
                    f"quant 'int8' with {self.motion_encoder}: row 12 (ln_mlp_int8) has no "
                    f"C = {missing[0]} form (compiled for INT8_C = {INT8_C}, "
                    f"mspi_tpu_torch/ops/kernels/ln_mlp.py), and the backbone's LN+MLP blocks "
                    f"at C = {missing[0]} would run it")
        for name in ("attn_relk", "attn_packed", "dwconv", "remat"):
            value = getattr(self, name)
            if value not in (True, False):  # a string such as "0" would read as on
                raise ValueError(f"{name} {value!r}: expected a bool")
            setattr(self, name, bool(value))

    @property
    def embed_dims(self) -> Tuple[int, int, int, int]:
        return MOTION_ENCODER_EMBEDS[self.motion_encoder]

    @property
    def lateral_bool(self) -> Tuple[bool, bool, bool, bool]:
        return LATERAL_BOOL[self.motion_encoder]

    @property
    def lateral_stride(self) -> Tuple[int, int, int, int]:
        return (4, 4, 4, 4) if self.motion_encoder == "x3dl" else (2, 2, 2, 2)

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
        """Tokens entering SyncBlock: T4 * H/32 * W/32 (672 for MViTv2-S,
        VideoSwin-S and UniFormer-B at 16x224x384; 336 for S3D, which halves
        T twice, stride-2 stem conv_t and stage-3 pool, to 4, and for
        SlowFast, whose slow pathway keeps T = 4; 1344 for X3D-L, which
        keeps T = 16; 392 for MorphMLP-S at 16x224x224)."""
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
