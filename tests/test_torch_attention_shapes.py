"""`chip_smoke.py`'s attention shape tables against the port's own models.

The chip run times K1 (`attention_rel`) at `MVIT_BLOCKS` and the window
kernel (row 15) at `SWIN_SHAPES`, each shape weighted by its blocks, and
reports the sums as per-forward times. This test records the calls that the
MViTv2-S and VideoSwin-S backbones make in one forward at 16x224x384 and
asserts that the tables list exactly those calls with those multiplicities:
K1's (heads, Nq, pooled key grid), the window kernel's (windows per clip,
heads, C, mask or not) with the mask's window count, and the shift masks'
(padded grid, window, shift); and `MVIT_WIDE`, the K1 calls whose rel
width passes 48 at 256x448. The forwards run on the meta device (shapes
only), where the kernel functions are routed to their plain versions.
"""

from __future__ import annotations

from collections import Counter

import pytest
import torch

import chip_smoke
from mspi_tpu_torch.config import get_config
from mspi_tpu_torch.models import mvit, videoswin
from mspi_tpu_torch.models.registry import build_backbone
from mspi_tpu_torch.ops import kernels
from tests.torch_port_utils import cpu_share

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share


@pytest.fixture
def meta_plain(monkeypatch):
    """Kernel functions on meta tensors run their plain versions."""
    dispatch = kernels.dispatch_device

    def on_meta(*tensors):
        return False if tensors[0].device.type == "meta" else dispatch(*tensors)
    monkeypatch.setattr(kernels, "dispatch_device", on_meta)


def _forward(encoder: str, res=chip_smoke.RES) -> None:
    with torch.device("meta"):
        cfg = get_config(encoder, overrides={"data": {"resolution": tuple(res)}})
        backbone = build_backbone(cfg).eval()
        clip = torch.empty(1, 16, *res, 3)
    with torch.no_grad():
        feats = backbone(clip)
    h, w = res
    assert [tuple(f.shape[1:4]) for f in feats] == [(8, h // s, w // s) for s in (4, 8, 16, 32)]


def test_mvit_attention_rel_shapes(meta_plain, monkeypatch):
    calls = Counter()
    kernel = mvit.attention_rel

    def spy(q, k, v, rel, k_shape, scale):
        assert q.shape[-1] == chip_smoke.MVIT_D
        calls[(q.shape[1], q.shape[2], tuple(k_shape))] += 1
        return kernel(q, k, v, rel, k_shape, scale)
    monkeypatch.setattr(mvit, "attention_rel", spy)
    _forward("mvitv2s")
    want = Counter({(heads, nq, k_shape): blocks
                    for _, blocks, heads, nq, k_shape in chip_smoke.MVIT_BLOCKS})
    assert calls == want
    assert sum(calls.values()) == chip_smoke.PER_FORWARD["mvitv2s"]["attention_rel"]


def test_mvit_wide_rel_shapes(meta_plain, monkeypatch):
    """MVIT_WIDE lists the K1 calls whose rel width passes 48, as MViTv2-S
    makes them at the training CLI's --resolution 256 448."""
    calls = Counter()
    kernel = mvit.attention_rel

    def spy(q, k, v, rel, k_shape, scale):
        assert rel.shape[-1] == sum(k_shape)
        if sum(k_shape) > 48:
            calls[(q.shape[1], q.shape[2], tuple(k_shape))] += 1
        return kernel(q, k, v, rel, k_shape, scale)
    monkeypatch.setattr(mvit, "attention_rel", spy)
    _forward("mvitv2s", chip_smoke.MVIT_WIDE_RES)
    assert calls == Counter({(heads, nq, k_shape): 1
                             for _, _, heads, nq, k_shape in chip_smoke.MVIT_WIDE})


def test_videoswin_window_attention_shapes(meta_plain, monkeypatch):
    calls, masks = Counter(), Counter()
    kernel, make_mask = videoswin.window_attention, videoswin._attn_mask

    def spy(qkv, bias, mask, num_heads, num_windows=1):
        assert qkv.shape[1] == chip_smoke.SWIN_N
        assert qkv.shape[2] // 3 // num_heads == chip_smoke.SWIN_D
        if mask is not None:
            assert mask.shape[0] == num_windows == qkv.shape[0]  # batch 1: one clip
        calls[(qkv.shape[0], num_heads, qkv.shape[2] // 3, mask is not None)] += 1
        return kernel(qkv, bias, mask, num_heads, num_windows)

    def mask_spy(Dp, Hp, Wp, window_size, shift_size):
        masks[((Dp, Hp, Wp), tuple(window_size), tuple(shift_size))] += 1
        return make_mask(Dp, Hp, Wp, window_size, shift_size)
    monkeypatch.setattr(videoswin, "window_attention", spy)
    monkeypatch.setattr(videoswin, "_attn_mask", mask_spy)
    _forward("videoswins")
    want = Counter({(nw, heads, C, grid is not None): blocks
                    for _, blocks, nw, heads, C, grid, _ in chip_smoke.SWIN_SHAPES})
    assert calls == want
    assert sum(calls.values()) == chip_smoke.PER_FORWARD["videoswins"]["window_attention"]
    # one mask per stage, built from the table's padded grid and shift
    assert masks == Counter({(grid, (8, 7, 7), shift): 1
                             for *_, grid, shift in chip_smoke.SWIN_SHAPES if grid is not None})
