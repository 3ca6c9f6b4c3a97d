"""The MSPI fusion model: cross-modal transformer + FPN decoder + readout.

Counterpart of `mspi_tpu/models/fusion.py` (reference model/model_utils.py:
`AudioVisualSaliencyModel` :388-574, `VisualSaliencyModel` :576-702 and
their building blocks). Activations are channels-last ([B,T,H,W,C] video,
[B,F,T,C] audio). Module names are the reference's torch names, so
`mspi_tpu.convert.convert_state_dict(model.state_dict())` gives the JAX
package's variables and a released checkpoint loads with `load_state_dict`.

Kernels on this path: SyncBlock attention runs K4 (`self_attention`); the
SyncBlock and decoder ConvNextBlock3d MLPs run K2 (`ln_mlp`); the MViT
backbone brings K1 and K2, the VideoSwin backbone the window-attention
kernel and K2, and the ConvNeXt prior K3's call site.

The models serve inference (eval mode, BatchNorm on running statistics) and
training (train mode: BatchNorm on batch statistics, MViT drop-path). The
frozen encoders `audnet` and `image_encoder` (`FROZEN`) always run in eval
mode under `torch.no_grad()`, so nothing flows back through them and K3's
call site needs no backward. The models are built on the CPU, drawn from an
explicit `torch.Generator`, then moved to `device` and `dtype` (the
parameter dtype: fp32 for training, with bf16 compute under autocast, or
bf16 for inference; the log-density output and the loss are fp32).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from mspi_tpu_torch.config import MSPIConfig
from mspi_tpu_torch.models.audio_resnet import AudioResNet18
from mspi_tpu_torch.models.convnext import ConvNeXtBlock2d, ConvNeXtTinyFeatures, Mlp2d
from mspi_tpu_torch.models.mvit import MultiScaleAttention
from mspi_tpu_torch.models.registry import build_backbone
from mspi_tpu_torch.models.s3d import BasicConv3d, SepConv3d
from mspi_tpu_torch.models.videoswin import WindowAttention3D
from mspi_tpu_torch.ops import layers
from mspi_tpu_torch.ops.kernels.ln_mlp import ln_mlp
from mspi_tpu_torch.ops.kernels.pooled_attention import self_attention
from mspi_tpu_torch.ops.layers import (BatchNorm, Conv2d, Conv3d, MaxPool, Upsample,
                                       adaptive_avg_pool, max_pool, normalize_frames)


def sinusoid_encoding_table(n_position: int, d_hid: int) -> torch.Tensor:
    """Fixed sin-cos position table [1, n_position, d_hid]."""
    position = np.arange(n_position)[:, None]
    hid = np.arange(d_hid)[None, :]
    angle = position / np.power(10000, 2 * (hid // 2) / d_hid)
    table = np.zeros_like(angle)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.from_numpy(table[None].astype(np.float32))


class Mlp(nn.Module):
    """ViT MLP (fc1 -> GELU -> fc2); applied through the K2 kernel."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Attention(nn.Module):
    """Multi-head self-attention with a bias-free fused qkv linear."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        C = x.shape[-1]
        # q and kv straight out of the split weight: packed [B,N,C] and
        # [B,N,2C], the layout the K4 kernel reads
        q = nn.functional.linear(x, self.qkv.weight[:C])
        kv = nn.functional.linear(x, self.qkv.weight[C:])
        return self.proj(self_attention(q, kv, self.num_heads))


class Block(nn.Module):
    """Pre-norm ViT block (LayerScale off, no drop-path)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = (x + self.attn(self.norm1(x))).contiguous()
        return x + ln_mlp(x, self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight,
                          self.mlp.fc1.bias, self.mlp.fc2.weight, self.mlp.fc2.bias,
                          self.norm2.eps)


class SyncBlock(nn.Module):
    """Project + norm both token streams, add fixed sinusoid positions, run
    joint ViT blocks over the concatenation."""

    def __init__(self, num_blocks: int = 3, num_vis_tokens: int = 672,
                 num_aud_tokens: int = 36, vis_in_embed: int = 768, embed_dim: int = 512,
                 num_heads: int = 4):
        super().__init__()
        self.vis_proj = nn.Linear(vis_in_embed, 512)
        self.vis_norm = nn.LayerNorm(512)
        self.aud_norm = nn.LayerNorm(512)
        self.blocks = nn.Sequential(*[Block(embed_dim, num_heads) for _ in range(num_blocks)])
        self.register_buffer("vis_pos_embed", sinusoid_encoding_table(num_vis_tokens, 512),
                             persistent=False)
        self.register_buffer("aud_pos_embed", sinusoid_encoding_table(num_aud_tokens, 512),
                             persistent=False)

    def forward(self, vis_fea, aud_fea):
        B = vis_fea.shape[0]
        vis = self.vis_norm(self.vis_proj(vis_fea.reshape(B, -1, vis_fea.shape[-1])))
        aud = self.aud_norm(aud_fea.reshape(B, -1, aud_fea.shape[-1]))
        vis = vis + self.vis_pos_embed.to(vis.dtype)
        aud = aud + self.aud_pos_embed.to(aud.dtype)
        return self.blocks(torch.cat([vis, aud], dim=1))


def simsiam_d(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """D(p, z) = -mean cos(p, z), each norm clamped at 1e-8, in fp32."""
    p, z = p.float(), z.detach().float()
    pn = p.norm(dim=-1).clamp_min(1e-8)
    zn = z.norm(dim=-1).clamp_min(1e-8)
    return -((p * z).sum(dim=-1) / (pn * zn)).mean()


class LayerNorm3d(nn.Module):
    """LayerNorm over the channels of a channels-last 5-D map."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        return self.norm(x)


class ConvNextBlock3d(nn.Module):
    """Factorised 3-D ConvNeXt block: depthwise (7,1,1) then (1,7,7), then
    LN + 1x1x1 MLP with GELU through the K2 kernel, plus residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv_t = Conv3d(dim, dim, (7, 1, 1), padding=(3, 0, 0), groups=dim)
        self.dwconv_s = Conv3d(dim, dim, (1, 7, 7), padding=(0, 3, 3), groups=dim)
        self.norm = LayerNorm3d(dim)
        self.pwconv1 = Conv3d(dim, 4 * dim, 1)
        self.pwconv2 = Conv3d(4 * dim, dim, 1)

    def forward(self, x):
        d = x.shape[-1]
        y = self.dwconv_s(self.dwconv_t(x)).contiguous()
        norm = self.norm.norm
        y = ln_mlp(y, norm.weight, norm.bias, self.pwconv1.weight.view(4 * d, d),
                   self.pwconv1.bias, self.pwconv2.weight.view(d, 4 * d), self.pwconv2.bias,
                   norm.eps)
        return x + y


class SA(nn.Module):
    """Saliency-prior gating: mask conv -> sigmoid -> x*mask + x."""

    def __init__(self, in_embed_dim: int = 512, k: int = 2):
        super().__init__()
        d = in_embed_dim
        self.conv_mask = nn.Sequential(
            BasicConv3d(d, d // 16, 3, 1, 1),
            Upsample((1, k, k)),
            Conv3d(d // 16, 1, (1, 3, 3), padding=(0, 1, 1)),
            nn.Sigmoid(),
        )

    def forward(self, x, mask):
        return x * self.conv_mask(mask) + x


class Inception(nn.Module):
    """3-D Inception over the fused prior features: 192+208+48+64 = 512 ch."""

    def __init__(self, embed_dim: int = 416):
        super().__init__()
        d = embed_dim
        self.branch0 = nn.Sequential(BasicConv3d(d, 192, 1, 1))
        self.branch1 = nn.Sequential(BasicConv3d(d, 96, 1, 1), SepConv3d(96, 208, 3, 1, 1))
        self.branch2 = nn.Sequential(BasicConv3d(d, 16, 1, 1), SepConv3d(16, 48, 3, 1, 1))
        self.branch3 = nn.Sequential(MaxPool((3, 3, 3), 1, 1), BasicConv3d(d, 64, 1, 1))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], dim=-1)


class Adapter(nn.Module):
    """Per-frame prior features -> a 3-D mask volume: temporal max-pool to
    T/stride frames, upsample the 1/32 map to 1/16, concat, Inception."""

    def __init__(self, embed_dim: int = 416, num_frames: int = 16, stride: int = 4):
        super().__init__()
        self.num_frames, self.stride = num_frames, stride
        self.conv = Inception(embed_dim)
        self.up = Upsample((1, 2, 2))

    def forward(self, feats):
        o3, o2 = feats  # [(b t), h, w, c]: 96 ch at 1/16, 320 ch at 1/32
        t, s = self.num_frames, self.stride

        def to_video(o):
            return o.reshape(o.shape[0] // t, t, *o.shape[1:])

        o3 = max_pool(to_video(o3), (s, 1, 1), (s, 1, 1))
        o2 = max_pool(to_video(o2), (s, 1, 1), (s, 1, 1))
        return self.conv(torch.cat([o3, self.up(o2)], dim=-1))


class StaticSaliencyModelConvNext(nn.Module):
    """Frozen ConvNeXt-T image-saliency encoder + smooth heads:
    (96 ch at 1/16, 320 ch at 1/32)."""

    def __init__(self):
        super().__init__()
        self.encoder = ConvNeXtTinyFeatures()
        self.smooth_0 = nn.Sequential(Conv2d(768, 320, 3, 1, 1), BatchNorm(320), nn.ReLU())
        self.smooth_1 = nn.Sequential(Conv2d(384, 96, 3, 1, 1), BatchNorm(96), nn.ReLU())

    def forward(self, x):
        _, _, o1, o0 = self.encoder(x)
        return self.smooth_1(o1), self.smooth_0(o0)


def _projector(in_dim: int, hidden: int) -> nn.Sequential:
    """3-layer SimSiam projector."""
    return nn.Sequential(
        nn.Linear(in_dim, hidden), nn.LayerNorm(hidden), nn.ReLU(),
        nn.Linear(hidden, hidden), nn.LayerNorm(hidden), nn.ReLU(),
        nn.Linear(hidden, hidden), nn.LayerNorm(hidden))


def _predictor(hidden: int) -> nn.Sequential:
    """2-layer SimSiam predictor."""
    return nn.Sequential(nn.Linear(hidden, 512), nn.LayerNorm(512), nn.ReLU(),
                         nn.Linear(512, hidden))


def _latlayer(in_dim: int, de_dim: int, temporal: bool, stride: int) -> nn.Sequential:
    """Lateral decoder layer: 1x1x1 embed, optional temporal-stride conv,
    factorised ConvNeXt block."""
    mods = [Conv3d(in_dim, de_dim, 1)]
    if temporal:
        mods.append(Conv3d(de_dim, de_dim, (stride, 1, 1), (stride, 1, 1), bias=False))
    mods.append(ConvNextBlock3d(de_dim))
    return nn.Sequential(*mods)


class Readout(nn.Sequential):
    """Readout head: the 4*de pyramid -> a 1-channel map at full resolution
    and T=1. Children keep the reference's indices; the stride-4 temporal
    conv (8) runs before the (1,4,4) spatial upsample (7), as in the JAX
    package: both are linear over disjoint axes, so the map is the same and
    the conv reads 16x fewer positions."""

    ORDER = (0, 1, 2, 3, 4, 5, 6, 8, 7, 9, 10, 11, 12)

    def __init__(self, de_dim: int):
        super().__init__(
            Conv3d(de_dim * 4, de_dim, 1),
            Conv3d(de_dim, de_dim, 3, 1, 1),
            BatchNorm(de_dim), nn.ReLU(),
            Conv3d(de_dim, 64, (1, 3, 3), 1, (0, 1, 1)),
            BatchNorm(64), nn.ReLU(),
            Upsample((1, 4, 4)),
            Conv3d(64, 32, (4, 1, 1), (4, 1, 1), 0),
            nn.ReLU(),
            Conv3d(32, 32, (1, 3, 3), 1, (0, 1, 1)),
            nn.ReLU(),
            Conv3d(32, 1, (1, 3, 3), 1, (0, 1, 1)),
        )

    def forward(self, x):
        for i in self.ORDER:
            x = self[i](x)
        return x


def _init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Draw every parameter from `gen` with the JAX package's initialisers:
    torch's default for convs and linears, xavier for the fusion
    transformer, truncated normal(0.02) for ConvNeXt, the rel-pos tables and
    the window-attention bias tables,
    zero biases where the JAX module asks for them."""
    layers.init_default(model, gen)
    for m in model.modules():
        if isinstance(m, (Mlp, Attention)):
            for lin in m.children():
                layers.xavier_uniform_(lin.weight, gen)
                if lin.bias is not None:
                    nn.init.zeros_(lin.bias)
        elif isinstance(m, SyncBlock):
            layers.xavier_uniform_(m.vis_proj.weight, gen)
            nn.init.zeros_(m.vis_proj.bias)
        elif isinstance(m, ConvNextBlock3d):
            for conv in (m.dwconv_t, m.dwconv_s, m.pwconv1, m.pwconv2):
                layers.trunc_normal_(conv.weight, 0.02, gen)
                nn.init.zeros_(conv.bias)
        elif isinstance(m, (ConvNeXtBlock2d, Mlp2d)):
            for lin in m.children():
                if isinstance(lin, (nn.Linear, nn.Conv2d)):
                    layers.trunc_normal_(lin.weight, 0.02, gen)
        elif isinstance(m, ConvNeXtTinyFeatures):
            layers.trunc_normal_(m.stem[0].weight, 0.02, gen)
            for i in (1, 2, 3):
                layers.trunc_normal_(getattr(m, f"stages_{i}").downsample[1].weight, 0.02, gen)
        elif isinstance(m, MultiScaleAttention):
            for t in (m.rel_pos_h, m.rel_pos_w, m.rel_pos_t):
                layers.trunc_normal_(t, 0.02, gen)
        elif isinstance(m, WindowAttention3D):
            layers.trunc_normal_(m.relative_position_bias_table, 0.02, gen)
        elif isinstance(m, Readout):
            layers.trunc_normal_(m[12].weight, 1.0 / math.sqrt(m[12].weight[0].numel()), gen)
            nn.init.zeros_(m[12].bias)


FROZEN = ("audnet", "image_encoder")  # the JAX package's FROZEN_TOPLEVEL (train/engine.py)


def _finish(model: nn.Module, generator: Optional[torch.Generator], device, dtype):
    _init_weights(model, generator if generator is not None
                  else torch.Generator().manual_seed(0))
    model.to(device=device, dtype=dtype)
    model.eval()


class _SaliencyDecoder(nn.Module):
    """The shared prior + decoder of both saliency models."""

    def train(self, mode: bool = True):
        """Train or eval mode for the trainable parts; the frozen encoders
        stay in eval mode."""
        super().train(mode)
        for name in FROZEN:
            if hasattr(self, name):
                getattr(self, name).eval()
        return self

    def _build_decoder(self, cfg: MSPIConfig, lat3_in: int):
        mc = cfg.model
        dims, de = mc.embed_dims, mc.de_embed_dim
        lb, ls = mc.lateral_bool, mc.lateral_stride
        self.latlayer_0 = _latlayer(dims[0], de, lb[0], ls[0])
        self.latlayer_1 = _latlayer(dims[1], de, lb[1], ls[1])
        self.latlayer_2 = _latlayer(dims[2], de, lb[2], ls[2])
        self.latlayer_3 = _latlayer(lat3_in, de, lb[3], ls[3])
        self.upsample = Upsample((1, 2, 2))
        self.upsample_4 = Upsample((1, 4, 4))
        self.upsample_8 = Upsample((1, 8, 8))
        self.readout = Readout(de)
        self.adapter = Adapter(num_frames=cfg.data.num_frames,
                               stride=cfg.data.num_frames // 4)
        self.sa_0 = SA(512, k=4)
        self.sa_1 = SA(512, k=2)
        self.sa_2 = SA(512, k=1)

    def _masks(self, x):
        B, T, H, W, C = x.shape
        with torch.no_grad():
            feats = self.image_encoder(x.reshape(B * T, H, W, C))
        return self.adapter(feats)

    def _decode(self, v1, v2, v3, v4, masks) -> torch.Tensor:
        s3 = self.latlayer_3(v4)
        s0 = self.latlayer_0(v1)
        s1 = self.latlayer_1(v2)
        s2 = self.latlayer_2(v3)
        s2 = self.sa_2(s2, masks) + self.upsample(s3)
        s1 = self.sa_1(s1, masks) + self.upsample(s2) + self.upsample_4(s3)
        s0 = (self.sa_0(s0, masks) + self.upsample(s1) + self.upsample_4(s2)
              + self.upsample_8(s3))
        out = self.readout(torch.cat([s0, self.upsample(s1), self.upsample_4(s2),
                                      self.upsample_8(s3)], dim=-1))
        out = out[:, 0, :, :, 0].float()
        return out - torch.logsumexp(out, dim=(1, 2), keepdim=True)


class AudioVisualSaliencyModel(_SaliencyDecoder):
    """The full MSPI net.

    forward(clips [B,T,H,W,3] uint8 or normalised float, audios [B,F,Tw,1])
    -> (log-saliency map [B,H,W] fp32, SimSiam AV loss scalar fp32).
    """

    def __init__(self, cfg: MSPIConfig, *, device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        mc = cfg.model
        dims, aud, hidden = mc.embed_dims, mc.aud_embed_dim, mc.simsiam_hidden
        self.audnet = AudioResNet18()
        self.image_encoder = StaticSaliencyModelConvNext()
        self.visnet = build_backbone(cfg)
        self.aud_vis_sync_block = SyncBlock(
            num_blocks=mc.sync_num_blocks, num_vis_tokens=cfg.num_vis_tokens(),
            vis_in_embed=dims[-1], embed_dim=aud, num_heads=mc.sync_num_heads)
        self.vis_projector = _projector(aud, hidden)
        self.mlp_vis = _predictor(hidden)
        self.aud_projector = _projector(aud, hidden)
        self.mlp_aud = _predictor(hidden)
        self._build_decoder(cfg, dims[3] + aud)
        _finish(self, generator, device, dtype)

    def forward_encoder(self, clips, audios):
        with torch.no_grad():
            aud_features = self.audnet(audios)
        v1, v2, v3, v4 = self.visnet(clips)
        B, t, h, w, _ = v4.shape
        ha = aud_features.shape[1]
        x = self.aud_vis_sync_block(v4, aud_features)
        n_vis = t * h * w
        vis_fea = x[:, :n_vis].reshape(B, t, h, w, -1)
        aud_fea = x[:, n_vis:].reshape(B, ha, -1, x.shape[-1])
        vis_emb = self.vis_projector(adaptive_avg_pool(vis_fea, 3).reshape(B, -1))
        aud_emb = self.aud_projector(adaptive_avg_pool(aud_fea, 2).reshape(B, -1))
        loss_va = (simsiam_d(self.mlp_vis(vis_emb), aud_emb)
                   + simsiam_d(self.mlp_aud(aud_emb), vis_emb)) * 0.5
        return v1, v2, v3, v4, vis_fea, loss_va

    def forward(self, clips, audios) -> Tuple[torch.Tensor, torch.Tensor]:
        x = normalize_frames(clips, self.dtype)
        masks = self._masks(x)
        v1, v2, v3, v4, vis_sync, loss_av = self.forward_encoder(x, audios.to(self.dtype))
        v4 = torch.cat([v4, vis_sync], dim=-1)
        return self._decode(v1, v2, v3, v4, masks), loss_av


class VisualSaliencyModel(_SaliencyDecoder):
    """Video-only twin: no audio net, SyncBlock or SimSiam heads; latlayer_3
    takes v4 alone. forward(clips) -> (log-saliency map, 0.0)."""

    def __init__(self, cfg: MSPIConfig, *, device=None, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.image_encoder = StaticSaliencyModelConvNext()
        self.visnet = build_backbone(cfg)
        self._build_decoder(cfg, cfg.model.embed_dims[3])
        _finish(self, generator, device, dtype)

    def forward(self, clips):
        x = normalize_frames(clips, self.dtype)
        masks = self._masks(x)
        v1, v2, v3, v4 = self.visnet(x)
        return self._decode(v1, v2, v3, v4, masks), 0.0
