"""Launch forms of the bf16 wgmma LN+MLP body, the bf16 K4 backward, row 6
and row 7 head-major at every augmented width, row 12 and row 11, and
`chip_smoke.py`'s K2/K3 shape tables against the port's own models.

`ln_mlp.sm90_form` and `pooled_attention.self_bwd_form` mirror the choices
that `csrc/ln_mlp_sm90.cuh` (`Form<C>`) and `csrc/self_attention_bwd_sm90.cu`
make at launch; the tests hold them to the register and shared-memory
budgets those choices rest on. The chip run times K2 at `LN_MLP_SHAPES` and
K3 at `PRIOR_SHAPES`, each shape weighted by its blocks, and reports the
sums as per-forward times: the shape tests record the K2 and K3 calls of one
MViTv2-S and one VideoSwin-S AudioVisualSaliencyModel forward at 16x224x384
on the meta device (shapes only; the kernel functions run their plain
versions there) and assert that the tables list exactly those calls with
those multiplicities.
"""

from __future__ import annotations

from collections import Counter

import pytest
import torch

import chip_smoke
from mspi_tpu_torch.models import convnext, fusion
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
from mspi_tpu_torch.ops import kernels
from mspi_tpu_torch.ops.kernels import layernorm as LN
from mspi_tpu_torch.ops.kernels import ln_mlp as K2
from mspi_tpu_torch.ops.kernels import pooled_attention as PA
from tests.torch_port_utils import cpu_share

pytestmark = pytest.mark.usefixtures("cpu_share")  # xdist: the worker's CPU share

SMEM_LIMIT = 232448  # a block's shared memory on the H100
CONSUMER_REGS = {2: 240, 1: 255}  # a consumer's registers by consumer warpgroups


@pytest.mark.parametrize("C", K2.SUPPORTED_C)
def test_ln_mlp_sm90_form(C):
    """The wgmma body's form at every compiled width: 64-row consumer
    warpgroups (two per block up to C = 512), y's columns whole up to C =
    192, else in parts of 192 or 256 (wgmma's widest N); y [64, CN], u [64,
    64] (two of them where pipelined) and h's fragments fit a consumer's
    registers with room to spare, and the z tile, two W2 slots and at least
    two W1 slots fit the block's shared memory."""
    rows, cn, parts, pipelined = K2.sm90_form(C)
    assert rows in (64, 128) and cn * parts == C and cn % 8 == 0 and cn <= 256
    assert cn == C if C <= 192 else cn < C
    assert pipelined == (cn == C)
    consumers = rows // 64
    assert cn // 2 + 32 * (2 if pipelined else 1) + 16 <= CONSUMER_REGS[consumers] - 48
    z = -(-C // 64) * rows * 128
    assert z + 2 * cn * 128 + 2 * 64 * 128 + 1024 + 256 <= SMEM_LIMIT
    if consumers == 1:  # 128 rows would not fit
        assert 2 * z + 2 * cn * 128 + 2 * 64 * 128 + 1024 > SMEM_LIMIT
    with pytest.raises(ValueError):
        K2.sm90_form(C + 32)


@pytest.mark.parametrize("D", PA.SUPPORTED_D)
def test_self_bwd_form(D):
    """The bf16 K4 backward's dk/dv pass at its three head dims: K and V A
    fragments (D / 2 registers each) stay beside dk and dv (D each) only
    while the four stay well under the 255-register cap (D = 64 and 96); at
    D = 128 they come from shared memory. An uncompiled head dim is
    refused."""
    form = PA.self_bwd_form(D)
    assert form == ("kv_registers" if 2 * D + D <= 300 else "kv_shared")
    assert PA.self_bwd_form(128) == "kv_shared"
    assert PA.self_bwd_form(64) == "kv_registers"  # UniFormer-B's heads
    with pytest.raises(ValueError):
        PA.self_bwd_form(80)


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_self_bwd_segments(batch):
    """The bf16 K4 backward's dk/dv segments at the SyncBlock shape (N 708, 4
    heads) on the H100's 132 SMs: no other count up to the cap gives fewer
    waves x query tiles per block, and at the training batch it is 2 (one
    full wave of 192 blocks)."""
    bh, sms, tiles = 4 * batch, 132, -(-708 // PA.BWD_TILE)
    seg = PA.self_bwd_segments(708, bh, sms)
    slots = PA.SELF_BWD_BLOCKS_PER_SM * sms

    def cost(s):
        return -(-tiles * bh * s // slots) * -(-tiles // s)
    assert 1 <= seg <= PA.SELF_BWD_MAX_SEGMENTS
    assert all(cost(seg) < cost(s) or (cost(seg) == cost(s) and seg <= s)
               for s in range(1, PA.SELF_BWD_MAX_SEGMENTS + 1))
    if batch == chip_smoke.TRAIN_BATCH:
        assert seg == 2


@pytest.fixture
def k2_calls(monkeypatch):
    """Counters of the K2 calls (rows per clip, C, eps) and K3 calls (rows
    per clip, C) that one forward of the model makes on the meta device."""
    dispatch = kernels.dispatch_device
    monkeypatch.setattr(kernels, "dispatch_device",
                        lambda *t: False if t[0].device.type == "meta" else dispatch(*t))
    calls = {"k2": Counter(), "prior": Counter()}

    def spy(kind, fn):
        def call(x, g, b, w1, b1, w2, b2, eps=1e-6):
            C = x.shape[-1]
            calls[kind][(x.numel() // C, C) + ((eps,) if kind == "k2" else ())] += 1
            return fn(x, g, b, w1, b1, w2, b2, eps)
        return call
    monkeypatch.setattr(K2, "ln_mlp", spy("k2", K2.ln_mlp))  # ln_mlp_block's
    monkeypatch.setattr(fusion, "ln_mlp", spy("k2", fusion.ln_mlp))
    monkeypatch.setattr(convnext, "ln_mlp_prior", spy("prior", convnext.ln_mlp_prior))

    def forward(encoder):
        with torch.device("meta"):
            model = AudioVisualSaliencyModel(chip_smoke.model_config(encoder), device="meta",
                                             dtype=torch.bfloat16)
            clips = torch.empty(1, 16, *chip_smoke.RES, 3)
            audios = torch.empty(1, *chip_smoke.SPECTRO, 1)
        with torch.no_grad():
            model(clips, audios)
        return calls
    return forward


def _prior_want():
    return Counter({(16 * tokens, C): blocks for _, tokens, C, blocks in chip_smoke.PRIOR_SHAPES})


def test_mvit_ln_mlp_shapes(k2_calls):
    calls = k2_calls("mvitv2s")
    want = Counter({(tokens, C, eps): blocks
                    for _, tokens, C, eps, blocks, _ in chip_smoke.LN_MLP_SHAPES})
    assert calls["k2"] == want
    assert sum(want.values()) == chip_smoke.PER_FORWARD["mvitv2s"]["ln_mlp"]
    assert calls["prior"] == _prior_want()
    assert sum(_prior_want().values()) == chip_smoke.PER_FORWARD["mvitv2s"]["ln_mlp_prior"]


def test_videoswin_ln_mlp_shapes(k2_calls):
    """VideoSwin-S's backbone blocks take eps 1e-5; the SyncBlock and decoder
    calls are the MViTv2-S model's."""
    calls = k2_calls("videoswins")
    assert {eps for *_, eps in calls["k2"]} == {1e-5}
    got = Counter()
    for (tokens, C, _), n in calls["k2"].items():
        got[(tokens, C)] += n
    want = Counter({(tokens, C): blocks
                    for _, tokens, C, _, _, blocks in chip_smoke.LN_MLP_SHAPES})
    assert got == want
    assert sum(want.values()) == chip_smoke.PER_FORWARD["videoswins"]["ln_mlp"]
    assert calls["prior"] == _prior_want()


@pytest.mark.parametrize("C", K2.SUPPORTED_C)
def test_ln_mlp_bwd_sm90_form(C):
    """The bf16 K2 backward's row pass at every compiled width: two 64-row
    consumer warpgroups up to C = 384, one above, where 128-row z and dy
    tiles would not fit beside the weight ring; the tiles, a ring of as
    many slots as fit (at most 16, at least 3) and the pass's static shared
    memory fit the block's. u and dh
    (32 fp32 registers each) sit well under the 168-register cap of three
    warpgroups, and dz (C / 2 registers a thread) is not held beside them."""
    rows, slots, smem = K2.bwd_sm90_form(C)
    static = 2 * (rows // 64) * 4 * 64 * 4 + 128
    assert rows == (128 if C <= 384 else 64) and 3 <= slots <= 16
    assert smem == 2 * -(-C // 64) * rows * 128 + slots * 64 * 128 + 1024
    assert smem + static <= SMEM_LIMIT
    assert slots == 16 or smem + static + 64 * 128 > SMEM_LIMIT
    if C <= 192:  # two chunks' W1 and W2 boxes: the consumers may drift a chunk apart
        assert slots >= 2 * 2 * -(-C // 64)
    if rows == 64:
        assert 2 * -(-C // 64) * 128 * 128 + 3 * 64 * 128 + 1024 + 2 * static > SMEM_LIMIT
    assert 2 * 32 + 48 <= 65536 // (128 * (rows // 64 + 1)) - 48
    assert 2 * 32 + C // 2 > 65536 // 384 - 48 or C <= 96
    with pytest.raises(ValueError):
        K2.bwd_sm90_form(C + 32)


@pytest.mark.parametrize("label,tokens,C", [(s[0], s[1], s[2]) for s in chip_smoke.LN_MLP_SHAPES])
def test_ln_mlp_bwd_segments(label, tokens, C):
    """The bf16 weight products' row segments at each K2 shape at batch 2 on
    132 SMs: whole 64-row tiles each, no more segments than tiles, and
    enough blocks over dW1's 64 x 128 output tiles for two waves of 2 blocks
    per SM, unless every segment is already one tile. The row pass's hidden
    parts: a run of whole 64-unit chunks each, and no other count gives
    fewer waves x (chunks per block + 1), so the row tiles of a stage with
    few rows (stage 3: 42 tiles of 128) are spread over the SMs by parts."""
    M, H, sms = 2 * tokens, 4 * C, 132
    rows, n_h = K2.bwd_sm90_form(C)[0], H // 64
    parts = K2.bwd_parts(M, C, sms)
    tiles_rows = -(-M // rows)
    cost = lambda p: -(-tiles_rows * p // sms) * (-(-n_h // p) + 1)  # noqa: E731
    assert 1 <= parts <= n_h and all(cost(parts) <= cost(p) for p in range(1, n_h + 1))
    if tiles_rows < sms // 2:
        assert tiles_rows * parts > sms // 2
    bf16 = kernels.DTYPE_CODES[torch.bfloat16]
    seg = K2.bwd_segments(bf16, M, C, H, sms)
    tiles = -(-M // 64)
    out_tiles = -(-H // 64) * -(-C // 128)
    assert 1 <= seg <= tiles
    per = -(-(-(-M // seg)) // 64) * 64
    assert (seg - 1) * per < M  # no empty segment
    assert out_tiles * seg >= 2 * sms or seg == tiles
    assert K2.bwd_segments(kernels.DTYPE_CODES[torch.float32], M, C, H, sms) <= -(-M // 256)


# every form's edges, MViTv2-S's relk0 widths (109 and 114 at 64x96, 123 and
# 142 at 224x384, 148 at 256x448, 162 at 288x640, 180 at 448x768, 184 at
# 512x768), the widest compile-time one and the wide form's (Da 258 at
# 1024x1440, 320 at 1536x1920, 400 at 2048x2688, and 1000); below 97 (no
# MViT call) the 128-lane form
AUG_WIDTHS = [1, 96, 97, 109, 112, 113, 114, 123, 128, 129, 142, 144, 145, 148, 162, 176, 177,
              180, 184, 192, 193, 256]
AUG_WIDE = [257, 258, 320, 321, 400, 1000]


def _aug_dk(Da):
    return next(dk for dk in (128, 144, 176, 192, 256) if Da <= dk)


def _blocks_per_sm(smem):
    return 228 * 1024 // (smem + 1024)


@pytest.mark.parametrize("Da", AUG_WIDTHS)
def test_aug_bwd_form(Da):
    """The bf16 row 7 head-major backward at the augmented widths: Da lanes
    zero-filled to 128 (from Da 97), 144, the wide forms' 176, 192 or 256
    (whole 16-lane k-steps, an odd count's last one alone). Both passes'
    shared memory fits two blocks per SM up to 176 (the wide dq pass holds
    its q rows too); at 192 the dk/dv pass and at 256 both passes take one.
    Above 176 two blocks split dk's columns, at 256 also dq's, so that
    each accumulator stays within the registers of its 176-lane form. No
    width is refused but Da < 1."""
    dk, dq_smem, dkv_smem, dq_split, dkv_split = PA.aug_bwd_form(Da)
    assert dk == _aug_dk(Da) == PA.aug_form(Da) and dk >= Da and dk % 16 == 0
    assert not PA.aug_is_wide(Da)
    assert dkv_smem > dq_smem
    assert (_blocks_per_sm(dq_smem) >= 2) == (dk <= 192) and _blocks_per_sm(dq_smem) >= 1
    assert (_blocks_per_sm(dkv_smem) >= 2) == (dk <= 176) and _blocks_per_sm(dkv_smem) >= 1
    assert (dq_split, dkv_split) == ((2 if dk > 192 else 1), (2 if dk > 176 else 1))
    assert dk // dq_split <= 192 and dk // dkv_split <= 176  # the accumulators' columns
    with pytest.raises(ValueError, match="at least one"):
        PA.aug_bwd_form(0)


@pytest.mark.parametrize("Da", AUG_WIDE)
def test_aug_wide_form(Da):
    """Past Da 256, rows 6 and 7 take the wide form: the score width Da
    rounded up to a multiple of 64 (257 and 258 -> 320, 321 -> 384, 400 -> 448,
    1000 -> 1024), shared by the forward and the backward; shared memory
    does not grow with Da (the forward's ring of q and k chunks and V tiles
    fits 3 blocks per SM, each backward pass's 2), and dq's and dk's
    columns split over ceil(DK / 128) blocks, so that no accumulator
    passes the 128 columns of a split."""
    dk = PA.aug_form(Da)
    assert PA.aug_is_wide(Da) and dk % PA.AUG_CHUNK == 0 and 0 <= dk - Da < PA.AUG_CHUNK
    assert dk == {257: 320, 258: 320, 320: 320, 321: 384, 400: 448, 1000: 1024}[Da]
    fdk, fwd_smem, q_rows = PA.aug_fwd_form(Da)
    assert fdk == dk and q_rows and fwd_smem == PA.aug_fwd_form(257)[1]
    assert _blocks_per_sm(fwd_smem) >= 3
    bdk, dq_smem, dkv_smem, dq_split, dkv_split = PA.aug_bwd_form(Da)
    assert bdk == dk and (dq_smem, dkv_smem) == PA.aug_bwd_form(257)[1:3]
    assert min(_blocks_per_sm(dq_smem), _blocks_per_sm(dkv_smem)) >= 2
    assert dq_split == dkv_split == -(-dk // PA.AUG_SPLIT) and dk / dq_split <= PA.AUG_SPLIT


@pytest.mark.parametrize("Da", AUG_WIDTHS)
def test_aug_fwd_form(Da):
    """The bf16 row 6 forward's form: the backward's score width, and its
    2-slot ring of K [64][DK + 8] and V [64][104] tiles fits 3 blocks of 4
    warps per SM up to DK = 176 (the register cap of 168 that its
    `__launch_bounds__` asks for, with Q's fragments in registers); at 192
    and 256 the block's q rows [64][DK + 8] join the ring in shared memory,
    2 and 1 blocks per SM; past the widest form the wide one
    (`test_aug_wide_form`)."""
    dk, smem, q_rows = PA.aug_fwd_form(Da)
    assert dk == PA.aug_form(Da) == PA.aug_bwd_form(Da)[0]
    assert q_rows == (dk > 176)
    assert smem == 2 * 2 * 64 * (dk + 8 + 96 + 8) + (2 * 64 * (dk + 8) if q_rows else 0)
    assert min(3, _blocks_per_sm(smem)) == {192: 2, 256: 1}.get(dk, 3)
    assert PA.aug_fwd_form(257)[0] == 320


@pytest.mark.parametrize("C", [96, *K2.INT8_C])
def test_int8_sm90_form(C):
    """Row 12's wgmma form: up to C = 512 two consumer warpgroups share 64
    rows (each half of the hidden units and of y's columns), at C = 768
    128-row blocks with y in column parts; a consumer's s32 accumulator
    (CN / 2 registers) beside u's 32 stays under its 240 with room for the
    rest, shared memory within the block's 227 KiB. C = 96 is the int8
    lab's width (`lab.mlp_int8w`): three consumers, each owning 64 of 192
    rows and all 96 columns (the parts form, one part) and its own h code
    tile, its z codes and W1 boxes of 64 units 128 k wide (zero-filled past
    k = 96), 12 W1 slots, the y accumulator's 48 registers beside u's 32
    within a consumer's 160. C = 320 (UniFormer-B's stage 3) is a shared
    form whose consumers take 160 columns each, its z codes in three 128-k
    boxes, 6 W1 slots. Other widths refuse."""
    rows, cn, parts, slots, smem = K2.int8_sm90_form(C)
    with pytest.raises(ValueError):
        K2.int8_sm90_form(C + 32)
    if C == 96:
        assert (rows, cn, parts, slots) == (192, 96, 1, 12)
        fixed = 192 * 128 + 2 * C * 128 + 3 * 64 * 128 + 1024  # z, W2, h codes, alignment
        assert smem == fixed + slots * 64 * 128 and smem + 1280 <= SMEM_LIMIT
        assert cn // 2 + 32 <= 160 - 64
        return
    consumers = 2 if rows == 64 else 1  # consumers per row: the column split
    # C = 320: 160 columns a consumer, one s8 wgmma n160 (N % 32 == 0)
    assert cn * consumers * parts == C and cn % (32 if C == 320 else 64) == 0
    assert 3 <= slots <= 12
    assert (rows, parts) == ((64, 1) if C <= 512 else (128, 3))
    assert cn // 2 + 32 <= CONSUMER_REGS[2] - 64
    assert smem + 1280 <= SMEM_LIMIT
    if C == 320:
        assert (cn, slots, smem) == (160, 6, 3 * 64 * 128 + 2 * 320 * 128 + 2 * 64 * 128
                                     + 1024 + 6 * 128 * 128)
    assert 4 * C % K2.INT8_HC == 0  # H = 4C: whole W2 slots of 128 hidden units


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("C", LN.LAYERNORM_C)
def test_layernorm_form(C, dtype):
    """Row 11's form at every compiled width: a row on a power-of-two group
    of C / 24 lanes (4, 8, 16, 32), 24 channels a lane in whole 16-byte
    loads (3 in bf16, 6 in fp32), 32 / lanes rows a warp step; the bytes in
    flight at the blocks per SM its `__launch_bounds__` asks for (2 of 256
    threads), the loads of 2 steps ahead in bf16 and 1 in fp32, reach 32
    KB. An input at a 2-byte offset
    (a view into a larger tensor) is not 16-byte aligned and takes the
    scalar form, one element a load."""
    lanes, loads, rows = LN.layernorm_form(C, dtype, aligned=True)
    size = torch.empty((), dtype=dtype).element_size()
    assert lanes * 24 == C and lanes & (lanes - 1) == 0 and lanes <= 32
    assert rows * lanes == 32 and loads * 16 == 24 * size
    depth = 2 if dtype == torch.bfloat16 else 1
    assert 2 * 256 * depth * loads * 16 >= 32 * 1024
    base = torch.zeros(4 * C + 8, dtype=dtype)
    x = base[1:1 + 4 * C].view(4, C)  # one element into the buffer
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert LN.layernorm_form(C, dtype, aligned=x.data_ptr() % 16 == 0) == (lanes, 24, rows)
    with pytest.raises(ValueError):
        LN.layernorm_form(C + 32, dtype, aligned=True)
