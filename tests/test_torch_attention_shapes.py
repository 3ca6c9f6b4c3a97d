"""`chip_smoke.py`'s attention shape tables against the port's own models.

The chip run times K1 (`attention_rel`) at `MVIT_BLOCKS` and the window
kernel (row 15) at `SWIN_SHAPES`, each shape weighted by its blocks, and
reports the sums as per-forward times. This test records the calls that the
MViTv2-S and VideoSwin-S backbones make in one forward at 16x224x384 and
asserts that the tables list exactly those calls with those multiplicities:
K1's (heads, Nq, pooled key grid), the window kernel's (windows per clip,
heads, C, mask or not) with the mask's window count, and the shift masks'
(padded grid, window, shift); `MVIT_WIDE` and `MVIT_R66`, the K1 calls
whose rel width passes 48 at 256x448 and 64 at 288x640; row 6's
augmented widths under attn_relk=False at those three resolutions, each
with a compiled form, the wide ones those two tables, and the widest
calls past Da 256, which take the wide form; row 18's `DWCONV_SHAPES` with
the bf16 kernel's tile at every pool shape of 224x384, 256x448 and
288x640; and UniFormer-B's K4 and K2 calls (`UNI_SELF_SHAPES`,
`UNI_LN_MLP_SHAPES`), each with a compiled form. The forwards run on the
meta device (shapes only), where the kernel functions are routed to their
plain versions.
"""

from __future__ import annotations

import math
from collections import Counter

import pytest
import torch

import chip_smoke
from mspi_tpu_torch.config import get_config
from mspi_tpu_torch.models import mvit, videoswin
from mspi_tpu_torch.models.registry import build_backbone
from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels import dwconv, pooled_attention
from tests.torch_port_utils import cpu_share

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share


@pytest.fixture
def meta_plain(monkeypatch):
    """Kernel functions on meta tensors run their plain versions."""
    dispatch = kernels.dispatch_device

    def on_meta(*tensors):
        return False if tensors[0].device.type == "meta" else dispatch(*tensors)
    monkeypatch.setattr(kernels, "dispatch_device", on_meta)


def _forward(encoder: str, res=chip_smoke.RES, model=None) -> None:
    with torch.device("meta"):
        cfg = get_config(encoder, overrides={"data": {"resolution": tuple(res)},
                                             "model": model or {}})
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


def test_mvit_r66_rel_shapes(meta_plain, monkeypatch):
    """MVIT_R66 lists the K1 calls whose rel width passes 64 (the bf16
    backward's WMMA form), as MViTv2-S makes them at --resolution 288 640."""
    calls = Counter()
    kernel = mvit.attention_rel

    def spy(q, k, v, rel, k_shape, scale):
        if sum(k_shape) > 64:
            calls[(q.shape[1], q.shape[2], tuple(k_shape))] += 1
        return kernel(q, k, v, rel, k_shape, scale)
    monkeypatch.setattr(mvit, "attention_rel", spy)
    _forward("mvitv2s", chip_smoke.MVIT_R66_RES)
    assert calls == Counter({(heads, nq, k_shape): 1
                             for _, _, heads, nq, k_shape in chip_smoke.MVIT_R66})
    assert all(sum(k_shape) == 66 for *_, k_shape in chip_smoke.MVIT_R66)


# the relk0 widths' tables of `chip_smoke.py` by resolution: (table, the Da
# of its calls, what it lists: "wide" the calls past Da 144 with their
# counts, "every" each distinct call, "some" calls past Da 176)
RELK0_TABLES = {chip_smoke.MVIT_WIDE_RES: (chip_smoke.MVIT_WIDE, {148}, "wide"),
                chip_smoke.MVIT_R66_RES: (chip_smoke.MVIT_R66, {162}, "wide"),
                chip_smoke.MVIT_SMALL_RES: (chip_smoke.MVIT_SMALL, {109, 114}, "every"),
                chip_smoke.MVIT_R84_RES: (chip_smoke.MVIT_R84, {180}, "some"),
                chip_smoke.MVIT_R88_RES: (chip_smoke.MVIT_R88, {184}, "some")}


@pytest.mark.parametrize("res", [chip_smoke.RES, chip_smoke.MVIT_WIDE_RES, chip_smoke.MVIT_R66_RES,
                                 chip_smoke.MVIT_SMALL_RES, (96, 160), chip_smoke.MVIT_R84_RES,
                                 chip_smoke.MVIT_R88_RES], ids=lambda r: f"{r[0]}x{r[1]}")
def test_mvit_relk0_aug_widths(meta_plain, monkeypatch, res):
    """Row 6's calls under attn_relk=False (the augmented lanes, Da = 96 +
    R): every block's Da has a compiled form (`aug_form`, the forward's and
    the backward's) at 224x384, at the training CLI's 256x448 and 288x640,
    at the README's 64x96 and at 96x160 (Da 112 and 120), 448x768 and
    512x768. At 224x384 they are MVIT_BLOCKS (Da 123 or 142); the wide
    calls, past Da 144, are MVIT_WIDE's (Da 148) and MVIT_R66's (Da 162);
    MVIT_SMALL lists every distinct call of 64x96 (Da 109 and 114); the
    calls past Da 176 take 180 at 448x768 and 184 at 512x768 and include
    MVIT_R84's and MVIT_R88's: the tables `chip_smoke.py` checks rows 6
    and 7 at."""
    calls = Counter()
    kernel = mvit.attention

    def spy(q_aug, k_aug, v):
        assert q_aug.shape[-1] == k_aug.shape[-1] and v.shape[-1] == chip_smoke.MVIT_D
        calls[(q_aug.shape[1], q_aug.shape[2], k_aug.shape[2], q_aug.shape[-1])] += 1
        return kernel(q_aug, k_aug, v)
    monkeypatch.setattr(mvit, "attention", spy)
    _forward("mvitv2s", res, {"attn_relk": False})
    assert sum(calls.values()) == chip_smoke.PER_FORWARD["mvitv2s+relk0"]["attention"]
    for (_, _, _, da) in calls:
        dk = pooled_attention.aug_form(da)
        assert pooled_attention.aug_fwd_form(da)[0] == pooled_attention.aug_bwd_form(da)[0] == dk

    def table(shapes):
        return Counter({(heads, nq, math.prod(ks), chip_smoke.MVIT_D + sum(ks)): blocks or 1
                        for _, blocks, heads, nq, ks in shapes})
    das = {da for *_, da in calls}
    if tuple(res) == chip_smoke.RES:
        assert calls == table(chip_smoke.MVIT_BLOCKS) and das == {123, 142}
    elif tuple(res) == (96, 160):
        assert das == {112, 120}
    else:
        shapes, want, lists = RELK0_TABLES[tuple(res)]
        listed = table(shapes)
        if lists == "every":
            assert set(calls) == set(listed) and das == want
        elif lists == "wide":
            assert Counter({key: n for key, n in calls.items() if key[3] > 144}) == listed
            assert {da for da in das if da > 144} == want
        else:
            assert {da for da in das if da > 176} == want
            assert all(key in calls for key in listed) and {k[3] for k in listed} == want


# the widest relk0 calls of MViTv2-S by resolution: Da = 96 + 8 + H/16 + W/16
# and the form it takes (256 the widest compile-time one; past it the wide
# form, Da rounded up to a multiple of 64)
WIDEST_RELK0 = {(1024, 1408): (256, 256), (1024, 1440): (258, 320), (1536, 1920): (320, 320)}


@pytest.mark.parametrize("res", list(WIDEST_RELK0), ids=lambda r: f"{r[0]}x{r[1]}")
def test_mvit_relk0_widest_resolution(meta_plain, monkeypatch, res):
    """Every relk0 call has a form at any resolution: up to 1024x1408 (Da
    256) a compile-time one, past it (1024x1440: Da 258; 1536x1920: Da 320)
    the wide form, whose score width, a multiple of 64, the forward and the
    backward share, and whose backward splits dq's and dk's columns over
    blocks of 128."""
    das = set()
    kernel = mvit.attention

    def spy(q_aug, k_aug, v):
        das.add(q_aug.shape[-1])
        return kernel(q_aug, k_aug, v)
    monkeypatch.setattr(mvit, "attention", spy)
    _forward("mvitv2s", res, {"attn_relk": False})
    widest, form = WIDEST_RELK0[tuple(res)]
    assert max(das) == widest and pooled_attention.aug_form(widest) == form
    for da in das:
        dk = pooled_attention.aug_form(da)
        assert dk >= da and pooled_attention.aug_fwd_form(da)[0] == dk
        assert pooled_attention.aug_bwd_form(da)[0] == dk
        assert pooled_attention.aug_is_wide(da) == (da > pooled_attention.AUG_FORMS[-1])
        if pooled_attention.aug_is_wide(da):
            assert dk % pooled_attention.AUG_CHUNK == 0 and dk - da < pooled_attention.AUG_CHUNK
            assert pooled_attention.aug_bwd_form(da)[3:] == (-(-dk // 128),) * 2


def test_uniformer_kernel_shapes(meta_plain, monkeypatch):
    """UniFormer-B's K4 and K2 calls in one forward at 16x224x384 are
    `chip_smoke.py`'s UNI_SELF_SHAPES and UNI_LN_MLP_SHAPES with their
    multiplicities (stage 3: 20 blocks, N 2688, C 320, 5 heads of 64; stage
    4: 7 blocks, N 672, C 512, 8 heads), and each has a compiled form: K4 and
    its backward at head dim 64, K2 and row 9 at C = 320 and 512."""
    from mspi_tpu_torch.models import uniformer
    from mspi_tpu_torch.ops.kernels import ln_mlp as K2

    k4, k2 = Counter(), Counter()
    attn, mlp = uniformer.self_attention, K2.ln_mlp

    def attn_spy(q, kv, num_heads):
        k4[(q.shape[1], q.shape[2], num_heads)] += 1
        return attn(q, kv, num_heads)

    def mlp_spy(x, g, b, w1, b1, w2, b2, eps):
        k2[(x.numel() // x.shape[-1], x.shape[-1], eps)] += 1
        return mlp(x, g, b, w1, b1, w2, b2, eps)
    monkeypatch.setattr(uniformer, "self_attention", attn_spy)
    monkeypatch.setattr(K2, "ln_mlp", mlp_spy)
    _forward("uniformerb")
    assert k4 == Counter({(n, c, heads): blocks
                          for _, blocks, n, c, heads in chip_smoke.UNI_SELF_SHAPES})
    assert k2 == Counter({(n, c, eps): blocks
                          for _, n, c, eps, blocks in chip_smoke.UNI_LN_MLP_SHAPES})
    assert sum(k4.values()) + 3 == chip_smoke.PER_FORWARD["uniformerb"]["self_attention"]
    assert sum(k2.values()) + 3 + 4 == chip_smoke.PER_FORWARD["uniformerb"]["ln_mlp"]
    for _, c, heads in k4:
        assert c // heads in pooled_attention.SUPPORTED_D
        assert pooled_attention.self_bwd_form(c // heads) == "kv_registers"
    for _, c, _ in k2:
        rows, cn, parts, _ = K2.sm90_form(c)
        assert cn * parts == c and K2.bwd_sm90_form(c)[1] >= 3
    assert K2.sm90_form(320)[1:3] == (160, 2)


@pytest.mark.parametrize("res", [chip_smoke.RES, chip_smoke.MVIT_WIDE_RES,
                                 chip_smoke.MVIT_R66_RES], ids=lambda r: f"{r[0]}x{r[1]}")
def test_dwconv3d_tiles_at_cli_shapes(meta_plain, monkeypatch, res):
    """Row 18's calls under `dwconv`, per head and on the packed layout
    (`attn_packed`): at 224x384 they are DWCONV_SHAPES (and the packed
    blk4-13 shape), the three larger stage grids fitted by the bf16
    kernel's tile without a padded pixel; at every resolution the tile is
    one that pads least, and the T split at batch 1, 2 and 8 gives at least
    2.5 chunks per SM of the H100 or chunks of one t."""
    calls = Counter()
    kernel = mvit.dwconv3d

    def spy(x, w):
        calls[tuple(x.shape[:4]), x.shape[4]] += 1
        return kernel(x, w)
    monkeypatch.setattr(mvit, "dwconv3d", spy)
    _forward("mvitv2s", res, {"dwconv": True})
    per_head = Counter(calls)
    calls.clear()
    _forward("mvitv2s", res, {"dwconv": True, "attn_packed": True})
    packed = calls - per_head
    if tuple(res) == chip_smoke.RES:
        assert per_head == Counter({((heads, *thw), chip_smoke.MVIT_D): pools
                                    for _, pools, heads, thw in chip_smoke.DWCONV_SHAPES})
        assert ((1, 8, 14, 24), 4 * chip_smoke.MVIT_D) in packed
        assert sum(per_head.values()) == chip_smoke.PER_FORWARD["mvitv2s+layout"]["dwconv3d"]

    def padded(tile, H, W):
        return -(-H // tile[0]) * tile[0] * -(-W // tile[1]) * tile[1]
    for (N, T, H, W), C in per_head + packed:
        tile = dwconv.dwconv3d_tile(H, W)
        assert dwconv.dwconv3d_kernel_tile(torch.bfloat16, H, W, C, True) == tile
        assert dwconv.dwconv3d_kernel_tile(torch.float32, H, W, C, True) == -1
        assert dwconv.dwconv3d_kernel_tile(torch.bfloat16, H, W, C, False) == -1
        area = padded(dwconv.DWCONV3D_TILES[tile], H, W)
        assert area == min(padded(t, H, W) for t in dwconv.DWCONV3D_TILES)
        if tuple(res) == chip_smoke.RES and (H, W) != (7, 12):
            assert area == H * W
        th, tw = dwconv.DWCONV3D_TILES[tile]
        for batch in (1, 2, 8):  # the T split on the H100's 132 SMs
            chunk = dwconv.dwconv3d_chunk(batch * N, T, H, W, C, 132)
            units = -(-C // 32) * batch * N * area // (th * tw)
            assert 1 <= chunk <= T
            assert chunk == 1 or 2 * units * -(-T // chunk) >= 5 * 132
    assert dwconv.dwconv3d_kernel_tile(torch.bfloat16, 14, 24, 20, True) == -1  # C % 8


def test_dwconv3d_chunks_at_mvit_pools():
    """Row 18's T split at MViTv2-S's 17 pools on the H100 (132 SMs): the
    chunks that measured fastest per pool, by forward (batch 8) and dx
    (batch 2)."""
    want = {chip_smoke.BATCH: (8, 8, 4, 8, 4), chip_smoke.TRAIN_BATCH: (4, 2, 1, 2, 1)}
    for batch, chunks in want.items():
        got = tuple(dwconv.dwconv3d_chunk(batch * heads, *thw, chip_smoke.MVIT_D, 132)
                    for _, _, heads, thw in chip_smoke.DWCONV_SHAPES)
        assert got == chunks, (batch, got)


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
