"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels,backward,...]

Runs the port's phases in order, one line each, and exits non-zero on the
first failure (there is no CPU path):

1. device: the card's name and `nvidia-smi` name and power limit;
2. build: compiles every kernel in mspi_tpu_torch/csrc with nvcc (sm_90a),
   one process per source;
3. kernels: each forward kernel against its plain PyTorch version at the
   inference shapes (batch 8) of the MViTv2-S and VideoSwin-S models, in
   fp32 and bf16, with CUDA-event times of both and of the library call
   that computes the same function; K4 also at the training shape (batch
   2) with the row log-sum-exp that its backward reads; K2 at its nine
   shapes and K3 at the prior's four, each weighted by its blocks per
   forward, and their bf16 runs (the wgmma body) twice, bit-identical; the
   serving options' kernels, row 12 at its three shapes weighted by its
   blocks per MViTv2-S serving forward (logged per VideoSwin-S int8
   forward too), each bf16 run twice and bit-identical, its flipped codes
   printed, and (checked only) on rows whose hidden pre-activations all lie
   below zero, where its second pass runs again; row 11 at the prior's four
   LayerNorm shapes per serving forward, and (checked only) at each width
   on M = 1000 and 63 rows and on x at an element's offset into its buffer
   (not 16-byte aligned: its scalar form), each bf16 run twice,
   bit-identical;
4. main path: `predict_video` of the bf16 MViTv2-S AudioVisualSaliencyModel
   at 224x384 (seeded random weights) on 31 synthetic frames and a 16 kHz
   waveform; checks the maps and each kernel's launch count;
5. parity: one window in fp32 on the card (kernels) against the CPU (plain
   versions), by the correlation of the log-density maps;
6. backward: each backward kernel against its plain version at the
   training shapes (batch 2) of both models, fp32 and bf16, with times;
   the bf16 K1 backward (row 5), window backward (row 16) and K4 backward
   (row 7's K4 part, at D = 128 and, checked only, D = 96) run twice at
   each of their shapes and must give bit-identical gradients; row 5 also
   at the rel widths of 256x448 (R = 52) and 288x640 (R = 66, its wide
   form), checked and timed beside SDPA, out of the sums;
7. training path: `make_train_step` on the MViTv2-S model at 224x384,
   batch 2, bf16 compute with fp32 weights, STEPS steps on synthetic
   batches; checks finite loss and gradient norm, trainable weights moved,
   frozen weights and statistics bit-identical, and the launch counts;
8. training parity: one fp32 step on the card against the same step on the
   CPU (plain versions) from the same weights, batch and drop-path draws:
   loss, each aux value and the cosine of the gradient vectors;
9-12. swin_main, swin_parity, swin_training, swin_train_parity: phases 4,
   5, 7 and 8 on the VideoSwin-S model;
13. int8_main: phase 4 on the MViTv2-S model with the serving options
   (quant="int8", prior_fold_res, prior_ln_t), whose path runs the int8
   LN+MLP, residual-folded prior MLP and LayerNorm kernels; the int8 and
   float bf16 forwards timed in turns, and how many int8 codes the bf16
   model's weights change against the fp32 weights';
14. int8_parity: that model in fp32 on the card against the CPU's plain
   versions (CC), and against the card's float model (the cost of int8);
15. swin_int8_main: phase 4 on the VideoSwin-S model with quant="int8";
16. layout_kernels: the kernels of MViT's layout options against their
   plain versions, fp32 and bf16, at batch 8: the augmented-lane attention
   (row 6) at the 16 blocks' shapes and (batch 2, checked only) at the
   relk0 widths off 224x384 (`AUG_CHECKS`): Da 148 and 162 of 256x448 and
   288x640, 109 and 114 of 64x96, 180 of 448x768, 184 of 512x768 and the
   widest form's 256, each bf16 run twice, bit-identical; the packed rel-pos
   attention (row 8,
   with the residual) at blocks 1-15 and at the rel width 52 of 256x448
   (checked only), the depthwise conv3d (row 18) at the 17 stride-1 pools
   (and, checked only, on the packed layout and at ragged shapes, each
   bf16 tile, a part channel group and C off the 8-channel vector); times
   summed per forward (each shape weighted by its blocks);
17. layout_backward: at batch 2, row 7's head-major backward of row 6 at
   the 16 blocks and (checked only) at `AUG_CHECKS`, row 8's backward
   (K1's after a layout change, its bf16 run twice, bit-identical) at
   blocks 1-15 and at R = 52 and 66, and row 18's dx beside grouped
   `F.conv3d` on the flipped taps;
18. layout_main: phase 4 on MViTv2-S with attn_packed and dwconv (row 8 in
   blocks 1-15, K1 in block 0, row 18 in the 17 stride-1 pools), timed in
   turns against the default model;
19. layout_parity: that model in fp32, card against the CPU (CC) and
   against the card's default model;
20. relk0_training, relk0_train_parity: phases 7 and 8 on MViTv2-S with
   attn_relk=False and dwconv (rows 6, 7 and 18 with its dx);
   relk0_small_parity: phase 8 so at --resolution 64 96 (rows 6 and 7 at
   Da 109 and 114);
21. mlp_kernels: the fused MLP without LayerNorm (row 13) against its plain
   version at K2's nine shapes (batch 8, bf16 twice, bit-identical), its
   backward (row 14) at batch 2,
   fp32 and bf16; then its path: one `maybe_fused_mlp` forward and
   backward through the port's MViT `Mlp` (C 96), exactly one launch of
   each;
22. lab: the three kernel labs (`mspi_tpu_torch.tools.bench_dwconv`,
   `bench_lnmlp`, `bench_int8`) in this process at their default shapes:
   rows 19, 20 (five bodies) and 21 (GEMM in bf16 and int8, the bf16 and
   int8 MLP bodies), each held against its plain version and timed beside
   its library call; the labs' launches are this phase's path. Before
   them the bf16 GEMM is held against its plain version at two non-square
   shapes (one with K % 64 == 32, a half last k tile), the int8 GEMM
   exactly at three with K % 128 == 64 (a half last box), in both tile
   heights, and at 4096^3, and row 19 in fp32 and bf16 at four ragged shapes
   (H and W off both its tile widths; C = 40, a part channel group, and C
   = 1, off the 16-byte vector), and the eight LN+MLP lab bodies (row 20's
   six and row 21's `mlp_bf16` on K2's wgmma body, `mlp_int8w` on row 12's,
   in their lab variants) at ragged row counts (M = 1000 and 63, C 96, H
   384), each run twice and bit-identical, `mlp_int8w` with an all-zero
   row; then at M = 1000 the six row-20 bodies and `mlp_bf16` at K2's
   other widths (192, 384, 512, 768), `mlp_int8w` at row 12's widths
   (H = 4C) and at all five of its widths with H = 320 (H % 128 == 64).

23. uni_main, uni_parity, uni_training: phases 4, 5 and 7 on the
   UniFormer-B model (K4 at head dim 64 in its 27 stage 3-4 blocks, K2 at C
   = 320 and 512, and their backwards); uni_train_parity: phase 8 so at
   --resolution 64 96; s3d_main, s3d_parity: phases 4 and 5 on the S3D
   model (its backbone plain; K4 and K2 in the SyncBlock and decoder).
   Their kernels are checked in phases 3, 6, 16 and 17: K4 and its backward
   at UniFormer-B's two shapes (head dim 64), K2 and row 9 at its C = 320
   (and 512) shapes, each with the model's per-forward or per-step sums
   logged; rows 6 and 7 at Da 258, 320 and 400, the wide form, on short
   token counts (`MVIT_DA_WIDE`, in `AUG_CHECKS`).
24. spectrogram: `data.audio.spectrogram_torch` (`torch.stft` on the card)
   against the host `stft_power` on the synthetic waveform's 31 windows;
25. vis_main: phase 4 on the MViTv2-S `VisualSaliencyModel` (clips alone:
   K1, K2 and K3, no K4 and no spectrogram);
26. remat_training: phase 7 on MViTv2-S with `remat` (each block's forward
   kernels again in its recompute), its peak memory beside phase 7's (it
   must be lower; phase 7 must have run); then one bf16 step's gradients
   with remat against the same step without it, within
   `REMAT_SPREAD_FACTOR` times the spread of three runs of that step
   without remat (cuDNN's conv backward is not bit-deterministic), and a
   control, the step through a checkpoint that does not restore the
   drop-path generators, outside that limit;
27. x3d_main, x3d_parity, x3d_training: phases 4, 5 and 7 on the X3D-L
   model (its backbone plain, the channelwise convs grouped `F.conv3d`; K4
   and K2 in the SyncBlock's 1380 tokens, K2 in the decoder).
28. sf_main, sf_parity, sf_training: phases 4, 5 and 7 on the SlowFast
   4x16 R50 model (its backbone plain; K4 and K2 in the SyncBlock's 372
   tokens, K2 in the decoder); in training stage s5's fast pathway, which
   feeds nothing, gets zero gradients, so exactly its parameters stay
   unchanged (`UNCHANGED`) and every other trainable tensor moves;
   morph_main, morph_parity, morph_training: phases 4, 5 and 7 on the
   MorphMLP-S model at 224x224 (the resolution at which its segments
   divide; its backbone plain, K4 and K2 in the SyncBlock's 428 tokens).
29. uni_int8_main, uni_int8_parity: phases 13 and 14 on the UniFormer-B
   model with quant="int8" (row 12 in its 27 stage 3-4 SABlocks, C = 320
   and 512, and the SyncBlock's 3; K2 in the decoder). Phase 3 checks row 12
   at UniFormer-B's three shapes (C = 320 its own form) and on rows with
   every u < 0 at C = 320, with the sums per UniFormer-B int8 forward.
30. ddp_training: `make_ddp_train_step` on an NCCL group of world size 1:
   one fp32 flagship step (drop-path off) against three runs of
   `make_train_step`, all under torch's deterministic algorithms (the
   gradients and the parameter updates by relative L2, and each metric,
   within `DDP_SPREAD_FACTOR` times the plain runs' spread: bit-equal
   where they are, the grad norm within 1e-6 relative besides; exactly one
   all-reduce), then 6 bf16 steps of each in
   turns, their steps/s;
31. cls_training: the video-classification path: for the mvitv2s
   classifier `run_classification_training` (2 steps and 2 eval batches on
   a synthetic Kinetics frame tree in a temporary directory, 16x224x224,
   batch 4, bf16; K1 and K2 forward, rows 5 and 9), then 4 steps of
   `make_cls_train_step`, steps/s and peak memory; cls_parity: one fp32
   classifier step card against CPU (logits, loss, gradient cosine);
   cls_uni_training: 4 steps of the uniformerb classifier (K4 and row 7,
   K2 and row 9 in its 27 SABlocks).
32. ssl_training: `run_net --task ssl`'s step, a ContrastiveNet on the
   MViTv2-S trunk at 16x224x224, 2 clips per view, bf16, SSL_STEPS steps of
   each objective (moco with a 4096-entry queue, swav with 300 prototypes):
   the momentum tree against its EMA, the queue pointer and keys, the
   prototypes' norms, steps/s; K1 and K2 per trunk forward (the momentum
   net's too), rows 5 and 9 per online forward; ssl_parity: one fp32 MoCo
   step card against CPU (loss, gradient cosine, the queue's new keys);
33. masked_training: `run_net --task masked`'s step, MaskedMViT with the
   HOG target (token grid 8x14x14) on MViTv2-S, batch 2, bf16, three AdamW
   steps on fresh masks, steps/s and peak memory; masked_parity: one fp32
   step card against CPU on the same mask (loss, gradient cosine, the HOG
   targets);
34. rev_training: ReversibleMViTFeatures (MViTv2-S, depth 16), batch 2,
   fp32: one forward, then `reversible_sequence` over stage 3's ten
   reversible blocks against plain autograd through them (every gradient,
   peak memory, which must be lower), K1 and row 5 counted inside the
   custom backward.
35. det_training: AVA detection, `VideoDetector` on the MViTv2-S trunk
   (the ROI head on tap 2) at 16x224x224, batch 2, 16 boxes a clip, from
   the port's `AvaDataset` over a synthetic AVA tree in a temporary
   directory: 5 bf16 AdamW steps (finite losses; the trunk's blocks 14-15,
   which feed nothing, moved by the weight decay alone), then
   `run_ava_eval` (mAP in [0, 1]); K1 and K2 per forward, rows 5 and 9 in
   the 14 blocks a backward reaches; det_parity: the detector in fp32 at
   64x96, card against CPU (eval probabilities, one step's loss and
   gradient cosine);
36. demo_main: `tools.demo_net.main` (s3d, bf16, batch 4) on 24 synthetic
   JPEG frames at 224x384: 9 heatmap PNGs, each map equal to the direct
   forward's; K2, K3 and K4 per forward;
37. gradcam_main: `tools.visualize.main --model mvitv2s` at 16x224x224:
   8 CAM frames in [0, 1]; K1 and K2 once each in the 16 blocks.

Each path (4, 7, 9, 11, 13, 15, 18, 20, 21, 22, 23, 25-37) sets the
launch counts to 0 just before it and reads them just after; the kernels'
record sums them. Each phase logs its time on the host clock.
The last two lines are the kernels' JSON record and the device JSON record.
`--phases` runs a subset (2 always runs; the records then cover only what
ran and no device record is printed).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = {
    # name: (source, TPU kernel it replaces)
    "attention_rel": ("mspi_tpu_torch/csrc/attention_rel.cu",
                      "mspi_tpu/ops/pallas/pooled_attention.py:622"),
    # K2, K3, rows 10 and 13 in bf16 (timed); fp32 runs ln_mlp.cuh's FMA body
    "ln_mlp": ("mspi_tpu_torch/csrc/ln_mlp_sm90.cuh", "mspi_tpu/ops/pallas/mlp.py:495"),
    "ln_mlp_prior": ("mspi_tpu_torch/csrc/ln_mlp_sm90.cuh", "mspi_tpu/ops/pallas/mlp.py:751"),
    "self_attention": ("mspi_tpu_torch/csrc/self_attention.cu",
                       "mspi_tpu/ops/pallas/pooled_attention.py:761"),
    # bf16 (timed); fp32 runs attention_bwd.cu's FMA passes
    "attention_rel_bwd": ("mspi_tpu_torch/csrc/attention_rel_bwd_sm90.cu",
                          "mspi_tpu/ops/pallas/pooled_attention.py:385"),
    # entered in attention_bwd.cu: K4's part in bf16 in self_attention_bwd_sm90.cu,
    # row 7 head-major in bf16 in attention_aug_bwd_sm90.cu; fp32 its FMA passes
    "attention_bwd": ("mspi_tpu_torch/csrc/attention_bwd.cu",
                      "mspi_tpu/ops/pallas/pooled_attention.py:172"),
    # rows 9 and 14 in bf16 (timed); fp32 runs ln_mlp_bwd.cu's FMA passes
    "ln_mlp_bwd": ("mspi_tpu_torch/csrc/ln_mlp_bwd_sm90.cuh", "mspi_tpu/ops/pallas/mlp.py:445"),
    "window_attention": ("mspi_tpu_torch/csrc/window_attention.cu",
                         "mspi_tpu/ops/pallas/attention.py:423"),
    # rows 16 (:233, stages 1-2) and 17 (:332, stages 3-4): one kernel here
    # (bf16; fp32 runs attention_bwd.cu's FMA passes)
    "window_attention_bwd": ("mspi_tpu_torch/csrc/window_attention_bwd.cu",
                             "mspi_tpu/ops/pallas/attention.py:233"),
    "ln_mlp_int8": ("mspi_tpu_torch/csrc/ln_mlp_int8.cu", "mspi_tpu/ops/pallas/mlp.py:985"),
    "ln_mlp_prior_res": ("mspi_tpu_torch/csrc/ln_mlp_sm90.cuh",
                         "mspi_tpu/ops/pallas/mlp.py:778"),
    "layernorm_tokens": ("mspi_tpu_torch/csrc/layernorm.cu", "mspi_tpu/ops/pallas/mlp.py:880"),
    # row 6 in bf16 (timed): flash_attention_sm90.cuh's body with DK != DV,
    # entered in attention.cu; fp32 runs flash_attention.cuh's FMA body
    "attention": ("mspi_tpu_torch/csrc/flash_attention_sm90.cuh",
                  "mspi_tpu/ops/pallas/pooled_attention.py:782"),
    "attention_rel_packed": ("mspi_tpu_torch/csrc/attention_rel.cu",
                             "mspi_tpu/ops/pallas/pooled_attention.py:593"),
    "dwconv3d": ("mspi_tpu_torch/csrc/dwconv.cu", "mspi_tpu/ops/pallas/dwconv.py:160"),
    "mlp": ("mspi_tpu_torch/csrc/ln_mlp_sm90.cuh", "mspi_tpu/ops/pallas/mlp.py:280"),
    "mlp_bwd": ("mspi_tpu_torch/csrc/ln_mlp_bwd_sm90.cuh", "mspi_tpu/ops/pallas/mlp.py:232"),
    "dwconv2d": ("mspi_tpu_torch/csrc/dwconv2d.cu", "tools/bench_dwconv.py:81"),
    # row 20: tools/bench_lnmlp.py::_call (:61) with each of its bodies, K2's
    # bf16 body in variants (entered in lnmlp_lab.cu)
    "lab_matmul": ("mspi_tpu_torch/csrc/ln_mlp_sm90.cuh", "tools/bench_lnmlp.py:78"),
    "lab_matmul_gelu": ("mspi_tpu_torch/csrc/ln_mlp_sm90.cuh", "tools/bench_lnmlp.py:86"),
    "lab_ln_matmul": ("mspi_tpu_torch/csrc/ln_mlp_sm90.cuh", "tools/bench_lnmlp.py:96"),
    "lab_pipe2": ("mspi_tpu_torch/csrc/ln_mlp_sm90.cuh", "tools/bench_lnmlp.py:107"),
    "lab_pipe4": ("mspi_tpu_torch/csrc/ln_mlp_sm90.cuh", "tools/bench_lnmlp.py:107"),
    "lab_mxu_stats": ("mspi_tpu_torch/csrc/ln_mlp_sm90.cuh", "tools/bench_lnmlp.py:134"),
    # row 21: tools/bench_int8.py::_gemm and _mlp_call (:98) with its two bodies
    "gemm_bf16": ("mspi_tpu_torch/csrc/gemm_lab.cu", "tools/bench_int8.py:53"),
    "gemm_int8": ("mspi_tpu_torch/csrc/gemm_lab.cu", "tools/bench_int8.py:53"),
    "mlp_bf16": ("mspi_tpu_torch/csrc/ln_mlp_sm90.cuh", "tools/bench_int8.py:67"),
    "mlp_int8w": ("mspi_tpu_torch/csrc/ln_mlp_int8.cu", "tools/bench_int8.py:83"),
}
LAB_KERNELS = ("dwconv2d", "lab_matmul", "lab_matmul_gelu", "lab_ln_matmul", "lab_pipe2",
               "lab_pipe4", "lab_mxu_stats", "gemm_bf16", "gemm_int8", "mlp_bf16", "mlp_int8w")
SERVING = {"quant": "int8", "prior_fold_res": True, "prior_ln_t": True}
LAYOUT = {"attn_packed": True, "dwconv": True}
RELK0 = {"attn_relk": False, "dwconv": True}
# launches per forward of each model (ln_mlp: backbone blocks + 3 SyncBlock
# + 4 decoder blocks; ln_mlp_prior: the ConvNeXt prior's 18 blocks). With
# quant="int8" the blocks with C >= 256 (MViT 3-15, Swin stages 3-4, the 3
# SyncBlock blocks) run ln_mlp_int8; prior_fold_res moves the prior's 18
# blocks to ln_mlp_prior_res, prior_ln_t its stem + 3 downsample norms to
# layernorm_tokens.
PER_FORWARD = {
    "mvitv2s": {"attention_rel": 16, "ln_mlp": 23, "ln_mlp_prior": 18, "self_attention": 3},
    # UniFormer-B: K4 and K2 in its 27 stage 3-4 blocks + the SyncBlock's
    # (and the decoder's K2); S3D: its backbone has no kernel
    "uniformerb": {"self_attention": 27 + 3, "ln_mlp": 27 + 3 + 4, "ln_mlp_prior": 18},
    "s3d": {"self_attention": 3, "ln_mlp": 3 + 4, "ln_mlp_prior": 18},
    "x3dl": {"self_attention": 3, "ln_mlp": 3 + 4, "ln_mlp_prior": 18},
    "slowfast4x16": {"self_attention": 3, "ln_mlp": 3 + 4, "ln_mlp_prior": 18},
    "morphmlps": {"self_attention": 3, "ln_mlp": 3 + 4, "ln_mlp_prior": 18},
    # the visual-only model: no SyncBlock (K4 and its 3 K2 blocks)
    "mvitv2s+visual": {"attention_rel": 16, "ln_mlp": 16 + 4, "ln_mlp_prior": 18},
    "videoswins": {"window_attention": 24, "ln_mlp": 31, "ln_mlp_prior": 18,
                   "self_attention": 3},
    "mvitv2s+serving": {"attention_rel": 16, "ln_mlp": 7, "ln_mlp_int8": 16,
                        "ln_mlp_prior_res": 18, "layernorm_tokens": 4, "self_attention": 3},
    "videoswins+int8": {"window_attention": 24, "ln_mlp": 8, "ln_mlp_int8": 23,
                        "ln_mlp_prior": 18, "self_attention": 3},
    # UniFormer-B int8: its 27 stage 3-4 SABlocks (C 320 and 512) and the 3
    # SyncBlock blocks on row 12, the decoder's 4 on K2
    "uniformerb+int8": {"self_attention": 27 + 3, "ln_mlp_int8": 27 + 3, "ln_mlp": 4,
                        "ln_mlp_prior": 18},
    # attn_packed: blocks 1-15 (more than one head) run row 8, block 0 K1;
    # dwconv: the 17 stride-1 pools (pool_q of the 13 blocks without a q
    # stride, pool_k / pool_v of blocks 14-15) run row 18
    "mvitv2s+layout": {"attention_rel_packed": 15, "attention_rel": 1, "dwconv3d": 17,
                       "ln_mlp": 23, "ln_mlp_prior": 18, "self_attention": 3},
    # attn_relk=False: every block runs row 6
    "mvitv2s+relk0": {"attention": 16, "dwconv3d": 17, "ln_mlp": 23, "ln_mlp_prior": 18,
                      "self_attention": 3},
}
# launches per training step
PER_STEP = {
    "mvitv2s": {**PER_FORWARD["mvitv2s"], "attention_rel_bwd": 16, "ln_mlp_bwd": 23,
                "attention_bwd": 3},
    "videoswins": {**PER_FORWARD["videoswins"], "window_attention_bwd": 24, "ln_mlp_bwd": 31,
                   "attention_bwd": 3},
    "uniformerb": {**PER_FORWARD["uniformerb"], "attention_bwd": 27 + 3,
                   "ln_mlp_bwd": 27 + 3 + 4},
    "x3dl": {**PER_FORWARD["x3dl"], "attention_bwd": 3, "ln_mlp_bwd": 3 + 4},
    "slowfast4x16": {**PER_FORWARD["slowfast4x16"], "attention_bwd": 3, "ln_mlp_bwd": 3 + 4},
    "morphmlps": {**PER_FORWARD["morphmlps"], "attention_bwd": 3, "ln_mlp_bwd": 3 + 4},
    # remat: each of the 16 blocks' K1 and K2 again in its recompute
    "mvitv2s+remat": {"attention_rel": 16 + 16, "ln_mlp": 23 + 16, "ln_mlp_prior": 18,
                      "self_attention": 3, "attention_rel_bwd": 16, "ln_mlp_bwd": 23,
                      "attention_bwd": 3},
    # row 7 head-major for the 16 blocks + K4's 3; row 18's dx per pool
    "mvitv2s+relk0": {**PER_FORWARD["mvitv2s+relk0"], "attention_bwd": 16 + 3,
                      "dwconv3d": 17 + 17, "ln_mlp_bwd": 23},
}
MORPH_RES = (224, 224)  # MorphMLP-S runs where (H/32)(W/32) is a multiple of 49
# phase -> (path kind, PER_FORWARD key: the encoder and its options[, input
# resolution, RES unless given])
PATH_PHASES = {
    "main": ("main", "mvitv2s"), "parity": ("parity", "mvitv2s"),
    "training": ("training", "mvitv2s"), "train_parity": ("train_parity", "mvitv2s"),
    "swin_main": ("main", "videoswins"), "swin_parity": ("parity", "videoswins"),
    "swin_training": ("training", "videoswins"),
    "swin_train_parity": ("train_parity", "videoswins"),
    "int8_main": ("main", "mvitv2s+serving"),
    "int8_parity": ("options_parity", "mvitv2s+serving"),
    "swin_int8_main": ("main", "videoswins+int8"),
    "layout_main": ("main", "mvitv2s+layout"),
    "layout_parity": ("options_parity", "mvitv2s+layout"),
    "relk0_training": ("training", "mvitv2s+relk0"),
    "relk0_train_parity": ("train_parity", "mvitv2s+relk0"),
    # the same at --resolution 64 96 (rows 6 and 7 at Da 109 and 114)
    "relk0_small_parity": ("train_parity", "mvitv2s+relk0", (64, 96)),
    "uni_main": ("main", "uniformerb"), "uni_parity": ("parity", "uniformerb"),
    "uni_training": ("training", "uniformerb"),
    "uni_train_parity": ("train_parity", "uniformerb", (64, 96)),
    "s3d_main": ("main", "s3d"), "s3d_parity": ("parity", "s3d"),
    "uni_int8_main": ("main", "uniformerb+int8"),
    "uni_int8_parity": ("options_parity", "uniformerb+int8"),
    "ddp_training": ("ddp_training", "mvitv2s"),
    "cls_training": ("cls_training", "mvitv2s"), "cls_parity": ("cls_parity", "mvitv2s"),
    "cls_uni_training": ("cls_training", "uniformerb"),
    "ssl_training": ("ssl_training", None), "ssl_parity": ("ssl_parity", None),
    "masked_training": ("masked_training", None), "masked_parity": ("masked_parity", None),
    "rev_training": ("rev_training", None),
    "det_training": ("det_training", None), "det_parity": ("det_parity", None),
    "demo_main": ("demo_main", None), "gradcam_main": ("gradcam_main", None),
    "spectrogram": ("spectrogram", None),
    "vis_main": ("main", "mvitv2s+visual"),
    "remat_training": ("remat_training", "mvitv2s+remat"),
    "x3d_main": ("main", "x3dl"), "x3d_parity": ("parity", "x3dl"),
    "x3d_training": ("training", "x3dl"),
    "sf_main": ("main", "slowfast4x16"), "sf_parity": ("parity", "slowfast4x16"),
    "sf_training": ("training", "slowfast4x16"),
    "morph_main": ("main", "morphmlps", MORPH_RES),
    "morph_parity": ("parity", "morphmlps", MORPH_RES),
    "morph_training": ("training", "morphmlps", MORPH_RES),
}
# the trainable tensors a training step leaves as they were: SlowFast's
# stage s5 fast pathway feeds nothing (only the slow pathway is a pyramid
# level), so its parameters get zero gradients, which AdamW at weight decay
# 0 turns into no update, as optax does
UNCHANGED = {"slowfast4x16": "visnet.s5.pathway1_"}
OPTIONS = {"mvitv2s+serving": SERVING, "videoswins+int8": {"quant": "int8"},
           "uniformerb+int8": {"quant": "int8"},
           "mvitv2s+layout": LAYOUT, "mvitv2s+relk0": RELK0,
           "mvitv2s+remat": {"remat": True}}
PHASES = ("kernels", "main", "parity", "backward", "training", "train_parity", "swin_main",
          "swin_parity", "swin_training", "swin_train_parity", "int8_main", "int8_parity",
          "swin_int8_main", "layout_kernels", "layout_backward", "layout_main",
          "layout_parity", "relk0_training", "relk0_train_parity", "relk0_small_parity",
          "mlp_kernels", "lab", "uni_main", "uni_parity", "uni_training", "uni_train_parity",
          "s3d_main", "s3d_parity", "spectrogram", "vis_main", "remat_training", "x3d_main",
          "x3d_parity", "x3d_training", "sf_main", "sf_parity", "sf_training", "morph_main",
          "morph_parity", "morph_training", "uni_int8_main", "uni_int8_parity", "ddp_training",
          "cls_training", "cls_parity", "cls_uni_training", "ssl_training", "ssl_parity",
          "masked_training", "masked_parity", "rev_training", "det_training", "det_parity",
          "demo_main", "gradcam_main")
BATCH = 8
TRAIN_BATCH = 2
STEPS = 5
RES = (224, 384)
SPECTRO = (257, 111)
N_FRAMES, FPS, SAMPLE_RATE = 31, 30.0, 16000
# published H100 SXM peaks (dense): bf16 tensor cores, fp32 outside them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_INT8_OPS = 1979e12  # int8 tensor cores
HBM_BYTES_PER_S = 3.35e12
# remat's bf16 gradients may sit this many times the plain runs' spread off
# them: in 72 M values the run-to-run distances concentrate, so the remat
# step's distance to a plain run lands at the spread itself, a little under
# or over it (0.91-1.02 x in five readings on an H100 80GB HBM3 at 700 W,
# PERF.md); a recompute with fresh drop-path masks, the phase's control,
# lands 136 x the spread off there (0.502 relative L2)
REMAT_SPREAD_FACTOR = 1.5
# ddp_training's limit: the DDP step's fp32 gradients, parameter updates and
# metrics may lie from a plain step's by this times the three plain runs'
# largest pairwise distance (so exactly where those agree). torch has no
# deterministic backward for max_pool3d and linear upsampling, so the
# plain runs differ: the DDP step sat 1.014 x (gradients, relative L2
# 2.58e-7) and 1.051 x (updates, 2.31e-4) their spread in one reading
# (H100 80GB HBM3, 700 W, PERF.md) and 1.010 x / 0.948 x against three
# plain runs in a second; its forward metrics bit-equal in both
DDP_SPREAD_FACTOR = 1.5


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, warmup: int = 2, reps: int = 5) -> float:
    """Median CUDA-event time of fn() in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tolerance(dtype: torch.dtype, ref: torch.Tensor, floor: float = 1.0) -> float:
    """fp32: 1e-4 relative to the output scale (only the summation order
    differs). bf16: three bf16 steps (2^-8 each) relative to the output
    scale -- inputs, the rounded intermediates and the output are bf16,
    the reference is fp32 on the same bf16-rounded inputs. The scale is
    max|ref|, at least `floor`."""
    scale = max(floor, ref.abs().max().item())
    return (1e-4 if dtype == torch.float32 else 3 * 2.0 ** -8) * scale


def new_record() -> dict:
    return {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "bound_by": None, "library_ms": None, "_bytes_ms": 0.0, "_ops_ms": 0.0}


def add_bound(rec, dtype, n_bytes: float, flops: float, peak: float = None,
              weight: float = 1.0) -> None:
    """The least time of the work on the card: the larger of its bytes (each
    input read once, each output written once) over HBM's rate and its
    operations over the peak of their type (by default the dtype's matrix
    peak). Recorded for the bf16 runs, whose times the record sums, with
    the shape's weight."""
    if dtype != torch.bfloat16 or not weight:
        return
    t_bytes = weight * n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = weight * flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    rec["bound_ms"] += max(t_bytes, t_ops)
    rec["_bytes_ms"] += t_bytes
    rec["_ops_ms"] += t_ops
    rec["bound_by"] = "bytes" if rec["_bytes_ms"] > rec["_ops_ms"] else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def record(records, name, label, dtype, errs_tols, ms, plain_ms, library_ms=None,
           weight: float = 1.0):
    """Log one check and fold it into the kernel's record: the error always,
    the bf16 times times `weight` (the shape's launches per forward or
    step; 0 for a check whose times stay out of the sums)."""
    err = max(e for e, _ in errs_tols)
    ok = all(math.isfinite(e) and e <= t for e, t in errs_tols)
    # each output against its own tolerance (0: exact)
    worst = max(e / t if t else (0.0 if e == 0 else math.inf) for e, t in errs_tols)
    lib = "" if library_ms is None else f" library {library_ms:.3f} ms"
    times = "" if weight == 1 else f" (x{weight:g} in the sums)"
    log("kernels", f"{name} {label} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                   f"(worst err/tol {worst:.3f}) "
                   f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms{lib}{times} "
                   f"{'ok' if ok else 'FAIL'}")
    rec = records[name]
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["_last"] = (ms, plain_ms, library_ms)  # for sums of another model (`ModelSums`)
    if dtype == torch.bfloat16 and weight:
        rec["ms"] += weight * ms
        rec["plain_ms"] += weight * plain_ms
        if library_ms is not None:
            rec["library_ms"] = (rec["library_ms"] or 0.0) + weight * library_ms
    if not ok:
        raise AssertionError(f"{name} {label} {dtype}: error {err} above tolerance")


def check_kernel(records, name, label, kernel_fn, plain_fn, inputs, dtype, library_fn=None,
                 compare=None, weight: float = 1.0, repeatable: bool = False):
    """Run one forward kernel at one shape against its plain version; record
    the error and the times. By default the plain version runs in fp32 on
    the same dtype-rounded inputs, held to `tolerance`; `compare(out, xs)`
    replaces that with its own (error, tolerance) pairs. `repeatable`: a
    second bf16 run must give a bit-identical output."""
    xs = [t.to(dtype) if t.is_floating_point() else t for t in inputs]
    out = kernel_fn(*xs)
    torch.cuda.synchronize()
    if repeatable and dtype == torch.bfloat16:
        check_repeatable(name, label, lambda: (kernel_fn(*xs),), (out,))
    if compare is None:
        ref = plain_fn(*(t.float() if t.is_floating_point() else t for t in xs))
        errs = [((out.float() - ref).abs().max().item(), tolerance(dtype, ref))]
    else:
        errs = compare(out, xs)
    ms = time_ms(lambda: kernel_fn(*xs))
    plain_ms = time_ms(lambda: plain_fn(*xs))
    lib_ms = None
    if library_fn is not None and dtype == torch.bfloat16:
        with torch.no_grad():
            lib_ms = time_ms(library_fn(*xs))
    record(records, name, label, dtype, errs, ms, plain_ms, lib_ms, weight)
    return xs, out


class ModelSums:
    """bf16 times of one kernel at another model's shapes (UniFormer-B's),
    summed per forward or step outside the record, whose sums are MViTv2-S's:
    kernel, plain, library and bound, each shape weighted by its blocks."""

    def __init__(self, what: str):
        self.what, self.t = what, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                                   "bound_ms": 0.0}

    def add(self, rec, weight: float, n_bytes: float, flops: float,
            peak: float = PEAK_FLOPS[torch.bfloat16]) -> None:
        ms, plain_ms, lib_ms = rec["_last"]
        self.t["ms"] += weight * ms
        self.t["plain_ms"] += weight * plain_ms
        self.t["library_ms"] += weight * (lib_ms or 0.0)
        self.t["bound_ms"] += weight * max(n_bytes / HBM_BYTES_PER_S, flops / peak) * 1e3

    def log(self, name: str) -> None:
        t = self.t
        log("kernels", f"{name} per {self.what}: kernel {t['ms']:.3f} ms, plain "
                       f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms, bound "
                       f"{t['bound_ms']:.3f} ms ({t['bound_ms'] / t['ms']:.1%} of it)")


def randn_on(gen):
    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()
    return randn


def added_randn():
    return randn_on(torch.Generator().manual_seed(99))


def mlp_inputs(randn, M, C):
    H = 4 * C
    return [randn(M, C), 1 + randn(C, scale=0.1), randn(C, scale=0.1),
            randn(H, C, scale=C ** -0.5), randn(H, scale=0.1),
            randn(C, H, scale=H ** -0.5), randn(C, scale=0.1)]


def compare_with_lse(heads, dtype):
    """K4's (out, lse) against its plain version and the scores' row
    log-sum-exp, each to its own tolerance: a `check_kernel` compare."""
    from mspi_tpu_torch.ops.kernels.pooled_attention import self_attention_reference

    def compare(out_lse, xs):
        out, lse = out_lse
        q, kv = (t.float() for t in xs)
        ref, ref_lse = self_attention_reference(q, kv, heads), self_attention_lse(q, kv, heads)
        return [((out.float() - ref).abs().max().item(), tolerance(dtype, ref)),
                ((lse - ref_lse).abs().max().item(), tolerance(dtype, ref_lse))]
    return compare


def self_attention_lse(q, kv, heads):
    """The row log-sum-exp [B * heads, N] of K4's scaled scores, in fp32."""
    B, N, C = q.shape
    D = C // heads
    qh, kh = (t.reshape(B, N, heads, D).transpose(1, 2) for t in (q, kv[..., :C]))
    return torch.logsumexp(qh @ kh.transpose(-1, -2) * D ** -0.5, dim=-1).reshape(B * heads, N)


def rel_mask(rel, k_shape):
    """rel E^T: the bias as the dense float mask a library call takes."""
    from mspi_tpu_torch.ops.kernels.pooled_attention import key_expansion

    E = torch.from_numpy(key_expansion(k_shape)).to(rel.device, rel.dtype)
    return rel @ E.T


def heads_major(t, heads):
    B, N, C = t.shape
    return t.reshape(B, N, heads, C // heads).transpose(1, 2).contiguous()


def sdpa(q, k, v, mask=None, scale=None):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


# MViTv2-S's 16 blocks at 224x384 per clip as unique shapes: label, blocks
# of the shape, heads, Nq and the pooled key grid (Nk = kt*kh*kw, R =
# kt+kh+kw; D = 96): K1's shapes, and rows 6 and 8's; each shape's times
# count once per block (blocks 4-13 share one shape)
MVIT_BLOCKS = (("blk0", 1, 1, 43008, (8, 7, 12)), ("blk1", 1, 2, 10752, (8, 14, 24)),
               ("blk2", 1, 2, 10752, (8, 7, 12)), ("blk3", 1, 4, 2688, (8, 14, 24)),
               ("blk4-13", 10, 4, 2688, (8, 7, 12)), ("blk14", 1, 8, 672, (8, 14, 24)),
               ("blk15", 1, 8, 672, (8, 7, 12)))
# The blocks whose rel width R = kt+kh+kw passes 48 at the training CLI's
# `--resolution 256 448` (keys pooled to (8, 16, 28): R = 52), in the same
# form; checked against the plain versions, times out of the sums (0 blocks)
MVIT_WIDE_RES = (256, 448)
MVIT_WIDE = (("blk1@256x448", 0, 2, 14336, (8, 16, 28)), ("blk3@256x448", 0, 4, 3584, (8, 16, 28)),
             ("blk14@256x448", 0, 8, 896, (8, 16, 28)))
# The blocks whose rel width passes 64 at `--resolution 288 640` (keys pooled
# to (8, 18, 40): R = 66), where the bf16 K1 backward runs its wide form
# (`pooled_attention.rel_bwd_form`); backward checks only, times out of the
# sums (0 blocks)
MVIT_R66_RES = (288, 640)
MVIT_R66 = (("blk1@288x640", 0, 2, 23040, (8, 18, 40)), ("blk3@288x640", 0, 4, 5760, (8, 18, 40)),
            ("blk14@288x640", 0, 8, 1440, (8, 18, 40)))
# Row 6's and row 7's relk0 widths (Da = 96 + R) off 224x384, in the same
# form, checked against the plain versions at batch 2 with times out of the
# sums (0 blocks): every distinct call of `--resolution 64 96` (Da 109 and
# 114, the 128-lane form below Da 113); the Da 180 calls of 448x768 and the
# Da 184 call of 512x768 (the 192-lane form, q rows in shared memory, its
# backward's column splits), blk1 and, at 512x768, blk3 left out to keep
# the plain versions' fp32 [B, H, Nq, Nk] scores small; and one call at the
# widest compiled Da, 256 (R = 160), on a key grid of no model, with Nq and
# Nk off the 64-row tiles
MVIT_SMALL_RES = (64, 96)
MVIT_SMALL = (("blk0@64x96", 0, 1, 3072, (8, 2, 3)), ("blk1@64x96", 0, 2, 768, (8, 4, 6)),
              ("blk2@64x96", 0, 2, 768, (8, 2, 3)), ("blk3@64x96", 0, 4, 192, (8, 4, 6)),
              ("blk4-13@64x96", 0, 4, 192, (8, 2, 3)), ("blk14@64x96", 0, 8, 48, (8, 4, 6)),
              ("blk15@64x96", 0, 8, 48, (8, 2, 3)))
MVIT_R84_RES = (448, 768)
MVIT_R84 = (("blk3@448x768", 0, 4, 10752, (8, 28, 48)),
            ("blk14@448x768", 0, 8, 2688, (8, 28, 48)))
MVIT_R88_RES = (512, 768)
MVIT_R88 = (("blk14@512x768", 0, 8, 3072, (8, 32, 48)),)
MVIT_DA256 = (("Da 256", 0, 2, 1000, (4, 15, 141)),)
# Past Da 256 the wide form (score lanes in chunks of 64): the widths of
# MViTv2-S's widest calls at --resolution 1024 1440 (Da 258), 1536 1920 (320)
# and 2048 2688 (400), on key grids of no model with their R and short
# token counts (those resolutions' own calls have 10^4-10^5 queries and keys,
# whose fp32 plain versions would take minutes); Nq and Nk off the 64-row
# tiles
MVIT_DA_WIDE = (("wide R 162", 0, 2, 1000, (1, 1, 160)), ("wide R 224", 0, 2, 700, (2, 2, 220)),
                ("wide R 304", 0, 2, 500, (3, 1, 300)))
AUG_CHECKS = (MVIT_WIDE + MVIT_R66 + MVIT_SMALL + MVIT_R84 + MVIT_R88 + MVIT_DA256
              + MVIT_DA_WIDE)
# K2 shapes per clip: label, tokens, C, eps, and the blocks of the shape in
# one MViTv2-S and one VideoSwin-S forward (the backbone's stages, the 3
# SyncBlock blocks, the decoder's 4 blocks); VideoSwin-S's backbone blocks
# take eps 1e-5, every other call the row's eps
LN_MLP_SHAPES = (("mvit-s1", 43008, 96, 1e-6, 1, 2), ("mvit-s2", 10752, 192, 1e-6, 2, 2),
                 ("mvit-s3", 2688, 384, 1e-6, 11, 18), ("mvit-s4", 672, 768, 1e-6, 2, 2),
                 ("sync", 708, 512, 1e-5, 3, 3), ("decoder0", 21504, 192, 1e-5, 1, 1),
                 ("decoder1", 5376, 192, 1e-5, 1, 1), ("decoder2", 1344, 192, 1e-5, 1, 1),
                 ("decoder3", 336, 192, 1e-5, 1, 1))


# UniFormer-B per clip at 16x224x384: K4 (label, blocks, N, C, heads; head
# dim 64) in stages 3 and 4, and K2 (label, tokens, C, eps, blocks) in the
# same blocks; its SyncBlock and decoder calls are LN_MLP_SHAPES' and K4's
# sync shape
UNI_SELF_SHAPES = (("uni-s3", 20, 2688, 320, 5), ("uni-s4", 7, 672, 512, 8))
UNI_LN_MLP_SHAPES = (("uni-s3", 2688, 320, 1e-6, 20), ("uni-s4", 672, 512, 1e-6, 7))


# VideoSwin-S window attention per clip (N = 8*7*7 = 392, D = 32) at the
# 24 blocks (depths 2, 2, 18, 2; the odd blocks shifted) as the eight
# (stage, shifted) variants: label, blocks of the variant, windows per clip,
# heads, C, and the shift mask's padded grid and shift (None: unshifted, no
# mask). At 16x224x384 the stages see (8, 56, 96), (8, 28, 48), (8, 14, 24)
# and (8, 7, 12) tokens: W pads to a multiple of 7, and where D or H fits in
# one window (`get_window_size`) the window is clamped and its shift is 0.
SWIN_SHAPES = (("s1", 1, 112, 3, 96, None, None),
               ("s1-shift", 1, 112, 3, 96, (8, 56, 98), (0, 3, 3)),
               ("s2", 1, 28, 6, 192, None, None),
               ("s2-shift", 1, 28, 6, 192, (8, 28, 49), (0, 3, 3)),
               ("s3", 9, 8, 12, 384, None, None),
               ("s3-shift", 9, 8, 12, 384, (8, 14, 28), (0, 3, 3)),
               ("s4", 1, 2, 24, 768, None, None),
               ("s4-shift", 1, 2, 24, 768, (8, 7, 14), (0, 0, 3)))
SWIN_N, SWIN_D = 392, 32


def window_inputs(randn, batch, nw, heads, C, grid, shift):
    """[qkv, bias] (+ the stage's real shift mask) for `batch` clips."""
    from mspi_tpu_torch.models.videoswin import _attn_mask

    inputs = [randn(batch * nw, SWIN_N, 3 * C), randn(heads, SWIN_N, SWIN_N, scale=0.5)]
    if grid is not None:
        mask = torch.from_numpy(_attn_mask(*grid, (8, 7, 7), shift)).cuda()
        if mask.shape[0] != nw:
            raise AssertionError(f"mask of {mask.shape[0]} windows, expected {nw}")
        inputs.append(mask)
    return inputs


def window_library_operands(qkv, bias, mask, heads, nw):
    """q, k, v and the float mask (bias + shift mask) for one SDPA call: the
    windows of a clip folded into the head axis, [B_/nW, nW*H, N, D], so the
    mask [1, nW*H, N, N] broadcasts over the clips."""
    from mspi_tpu_torch.ops.kernels.window_attention import _split

    B = qkv.shape[0]
    q, k, v = (t.reshape(B // nw, nw * heads, SWIN_N, SWIN_D).contiguous()
               for t in _split(qkv, heads))
    m = bias[None] if mask is None else bias[None] + mask[:, None]
    return q, k, v, m.reshape(1, nw * heads, SWIN_N, SWIN_N).contiguous()


def phase_kernels(records) -> None:
    from mspi_tpu_torch.ops.kernels.ln_mlp import ln_mlp, ln_mlp_prior, ln_mlp_reference
    from mspi_tpu_torch.ops.kernels.pooled_attention import (
        _self_attention_fwd, attention_rel, attention_rel_reference, self_attention,
        self_attention_reference)

    randn = randn_on(torch.Generator().manual_seed(1))
    for label, blocks, heads, nq, k_shape in MVIT_BLOCKS + MVIT_WIDE:
        nk, r = math.prod(k_shape), sum(k_shape)
        inputs = [randn(BATCH, heads, nq, 96), randn(BATCH, heads, nk, 96),
                  randn(BATCH, heads, nk, 96), randn(BATCH, heads, nq, r)]
        for dtype in (torch.float32, torch.bfloat16):
            def library(q, k, v, rel, ks=k_shape):
                mask = rel_mask(rel, ks)
                return lambda: sdpa(q, k, v, mask, 96 ** -0.5)
            xs, out = check_kernel(
                records, "attention_rel", label,
                lambda q, k, v, rel, ks=k_shape: attention_rel(q, k, v, rel, ks, 96 ** -0.5),
                lambda q, k, v, rel, ks=k_shape: attention_rel_reference(
                    q, k, v, rel, ks, 96 ** -0.5),
                inputs, dtype, library, weight=blocks)
            add_bound(records["attention_rel"], dtype, nbytes(*xs, out),
                      4.0 * BATCH * heads * nq * nk * 96, weight=blocks)
        del inputs, xs, out
    # K2 per MViTv2-S forward (each shape weighted by its blocks); the
    # VideoSwin-S weights give that model's sum, logged beside it
    swin = {"ms": 0.0, "bound_ms": 0.0}
    added = added_randn()
    for label, tokens, C, eps, blocks, swin_blocks in LN_MLP_SHAPES:
        inputs = mlp_inputs(added if label in ADDED_SHAPES else randn, BATCH * tokens, C)
        for dtype in (torch.float32, torch.bfloat16):
            mvit_ms, mvit_bound = records["ln_mlp"]["ms"], records["ln_mlp"]["bound_ms"]
            xs, out = check_kernel(records, "ln_mlp", label, lambda *a, e=eps: ln_mlp(*a, e),
                                   lambda *a, e=eps: ln_mlp_reference(*a, e), inputs, dtype,
                                   weight=blocks, repeatable=True)
            add_bound(records["ln_mlp"], dtype, nbytes(*xs, out), 4.0 * BATCH * tokens * C * 4 * C,
                      weight=blocks)
            for key, mvit in (("ms", mvit_ms), ("bound_ms", mvit_bound)):
                swin[key] += (records["ln_mlp"][key] - mvit) * swin_blocks / blocks
        del inputs, xs, out
    log("kernels", f"ln_mlp per VideoSwin-S forward (its blocks' weights): kernel "
                   f"{swin['ms']:.3f} ms, bound {swin['bound_ms']:.3f} ms")
    # K2 at UniFormer-B's 27 blocks (C = 320: two column parts of 160), bf16
    # twice and bit-identical, summed per UniFormer-B forward
    uni = ModelSums("UniFormer-B forward (batch 8, its 27 blocks)")
    uni_randn = randn_on(torch.Generator().manual_seed(52))
    for label, tokens, C, eps, blocks in UNI_LN_MLP_SHAPES:
        inputs = mlp_inputs(uni_randn, BATCH * tokens, C)
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(records, "ln_mlp", label, lambda *a, e=eps: ln_mlp(*a, e),
                                   lambda *a, e=eps: ln_mlp_reference(*a, e), inputs, dtype,
                                   weight=0, repeatable=True)
            if dtype == torch.bfloat16:
                uni.add(records["ln_mlp"], blocks, nbytes(*xs, out),
                        4.0 * BATCH * tokens * C * 4 * C)
        del inputs, xs, out
    uni.log("ln_mlp")
    # K3's call site: the prior's four stages, 16 frames per clip, per forward
    for label, tokens, C, blocks in PRIOR_SHAPES:
        inputs = mlp_inputs(randn, BATCH * 16 * tokens, C)
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(records, "ln_mlp_prior", label,
                                   lambda *a: ln_mlp_prior(*a, 1e-6),
                                   lambda *a: ln_mlp_reference(*a, 1e-6), inputs, dtype,
                                   weight=blocks, repeatable=True)
            add_bound(records["ln_mlp_prior"], dtype, nbytes(*xs, out),
                      4.0 * BATCH * 16 * tokens * C * 4 * C, weight=blocks)
        del inputs, xs, out
    # K4: SyncBlock, N = 672 + 36
    inputs = [randn(BATCH, 708, 512), randn(BATCH, 708, 1024)]
    for dtype in (torch.float32, torch.bfloat16):
        def library(q, kv):
            qh, kh, vh = (heads_major(t, 4) for t in (q, kv[..., :512], kv[..., 512:]))
            return lambda: sdpa(qh, kh, vh)
        xs, out = check_kernel(records, "self_attention", "sync",
                               lambda q, kv: self_attention(q, kv, 4),
                               lambda q, kv: self_attention_reference(q, kv, 4), inputs, dtype,
                               library)
        add_bound(records["self_attention"], dtype, nbytes(*xs, out),
                  4.0 * BATCH * 4 * 708 * 708 * 128)
    # K4 at the training shape, with the lse (natural log, fp32) that row 7's
    # backward reads; the times stay out of the sums
    inputs = [randn(TRAIN_BATCH, 708, 512), randn(TRAIN_BATCH, 708, 1024)]
    for dtype in (torch.float32, torch.bfloat16):
        check_kernel(records, "self_attention", "sync-train-lse",
                     lambda q, kv: _self_attention_fwd(q, kv, 4, with_lse=True),
                     lambda q, kv: self_attention_reference(q, kv, 4), inputs, dtype,
                     compare=compare_with_lse(4, dtype), weight=0)
    # K4 at head dim 64: UniFormer-B's stages 3 and 4 at batch 8 (summed per
    # UniFormer-B forward, out of the record's sums), and stage 3 at the
    # training batch with the lse (checked only)
    uni = ModelSums("UniFormer-B forward (batch 8, its 27 blocks)")
    uni_randn = randn_on(torch.Generator().manual_seed(51))
    for label, blocks, N, C, heads in UNI_SELF_SHAPES:
        inputs = [uni_randn(BATCH, N, C), uni_randn(BATCH, N, 2 * C)]
        for dtype in (torch.float32, torch.bfloat16):
            def library(q, kv, h=heads, c=C):
                qh, kh, vh = (heads_major(t, h) for t in (q, kv[..., :c], kv[..., c:]))
                return lambda: sdpa(qh, kh, vh)
            xs, out = check_kernel(records, "self_attention", label,
                                   lambda q, kv, h=heads: self_attention(q, kv, h),
                                   lambda q, kv, h=heads: self_attention_reference(q, kv, h),
                                   inputs, dtype, library, weight=0)
            if dtype == torch.bfloat16:
                uni.add(records["self_attention"], blocks, nbytes(*xs, out),
                        4.0 * BATCH * heads * N * N * (C // heads))
        del inputs, xs, out
    uni.log("self_attention")
    inputs = [uni_randn(TRAIN_BATCH, 2688, 320), uni_randn(TRAIN_BATCH, 2688, 640)]
    for dtype in (torch.float32, torch.bfloat16):
        check_kernel(records, "self_attention", "uni-s3-train-lse",
                     lambda q, kv: _self_attention_fwd(q, kv, 5, with_lse=True),
                     lambda q, kv: self_attention_reference(q, kv, 5), inputs, dtype,
                     compare=compare_with_lse(5, dtype), weight=0)
    del inputs
    # row 15: the eight VideoSwin variants, shifted blocks with their mask
    from mspi_tpu_torch.ops.kernels.window_attention import (window_attention,
                                                             window_attention_reference)

    for label, blocks, nw, heads, C, grid, shift in SWIN_SHAPES:
        inputs = window_inputs(randn, BATCH, nw, heads, C, grid, shift)
        n = nw if grid is not None else 1
        for dtype in (torch.float32, torch.bfloat16):
            def library(qkv, bias, *mask, h=heads, w=n):
                q, k, v, m = window_library_operands(qkv, bias, mask[0] if mask else None, h, w)
                return lambda: sdpa(q, k, v, m, SWIN_D ** -0.5)
            xs, out = check_kernel(
                records, "window_attention", label,
                lambda qkv, bias, *m, h=heads, w=n: window_attention(
                    qkv, bias, m[0] if m else None, h, w),
                lambda qkv, bias, *m, h=heads, w=n: window_attention_reference(
                    qkv, bias, m[0] if m else None, h, w),
                inputs, dtype, library, weight=blocks)
            add_bound(records["window_attention"], dtype, nbytes(*xs, out),
                      4.0 * BATCH * nw * heads * SWIN_N * SWIN_N * SWIN_D, weight=blocks)
        del inputs, xs, out
    serving_kernels(records, randn)


# Row 12 shapes per clip (MViTv2-S; VideoSwin-S's stage 3 and 4 have the
# same token counts): label, tokens, C
# Row 12 per clip: label, tokens, C and the blocks of the shape in one
# MViTv2-S serving forward (stage 3's 11 blocks, stage 4's 2, the 3 SyncBlock
# blocks) and one VideoSwin-S int8 forward (stage 3's 18 at the same grid)
INT8_SHAPES = (("s3", 2688, 384, 11, 18), ("s4", 672, 768, 2, 2), ("sync", 708, 512, 3, 3))
# row 12 per UniFormer-B int8 forward at batch 8: label, tokens, C, blocks
# (stage 3's C = 320 form, stage 4 and the SyncBlock at C = 512)
UNI_INT8_SHAPES = (("uni-s3", 2688, 320, 20), ("uni-s4", 672, 512, 7), ("uni-sync", 708, 512, 3))
# Checks added after a phase's shapes were first timed draw their inputs
# from a generator of their own (`added_randn`), so that every check before
# them in the phase keeps the inputs it had
ADDED_SHAPES = ("decoder1", "decoder2", "decoder3", "sync-d96")
# The prior's stages per frame (16 frames per clip): label, tokens, C and
# the stage's blocks (ConvNeXt-T's depths 3, 3, 9, 3)
PRIOR_SHAPES = (("prior-s0", 5376, 96, 3), ("prior-s1", 1344, 192, 3),
                ("prior-s2", 336, 384, 9), ("prior-s3", 84, 768, 3))
# Row 11 call sites per frame: stem.1 and stages_{1,2,3}.downsample.0
LN_SHAPES = (("stem", 5376, 96), ("ds1", 5376, 96), ("ds2", 1344, 192), ("ds3", 336, 384))


def int8_errors(out, ref):
    """Row 12's tolerance: RMS error <= 1e-3 of the output's RMS and max abs
    error <= 0.02 x max|ref|. Kernel and plain version compute the same
    int8 codes, except where the LayerNorm sums or the square root round
    across a code's boundary: one code flips on rare elements."""
    d = (out.double() - ref.double())
    rms = ref.double().pow(2).mean().sqrt().item()
    flips = (d.abs() > 1e-3 * rms).sum().item()
    log("kernels", f"  int8: {flips} of {d.numel()} outputs off by more than 1e-3 x RMS "
                   f"(a flipped code)")
    return [(d.pow(2).mean().sqrt().item(), 1e-3 * rms),
            (d.abs().max().item(), 0.02 * ref.abs().max().item())]


def serving_kernels(records, randn) -> None:
    """Rows 10, 11 and 12 at the serving path's shapes, fp32 and bf16."""
    import torch.nn.functional as F

    from mspi_tpu_torch.ops.kernels import ln_mlp as K2
    from mspi_tpu_torch.ops.kernels.layernorm import (LAYERNORM_C, layernorm_tokens,
                                                      layernorm_tokens_reference)

    swin = {"ms": 0.0, "bound_ms": 0.0}  # the sums per VideoSwin-S int8 forward
    for label, tokens, C, blocks, swin_blocks in INT8_SHAPES:
        M, H = BATCH * tokens, 4 * C
        g, b, w1, b1, w2, b2 = (t.float() for t in mlp_inputs(randn, 1, C)[1:])
        w1q, s1 = K2.quantize_weight(w1)
        w2q, s2 = K2.quantize_weight(w2)
        ops = (g, b, w1q, s1, b1, w2q, s2, b2)
        x32 = randn(M, C)
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(
                records, "ln_mlp_int8", label, lambda x: K2.ln_mlp_int8(x, *ops, 1e-6),
                lambda x: K2.ln_mlp_int8_reference(x, *ops, 1e-6), [x32], dtype,
                compare=lambda out, xs: int8_errors(
                    out, K2.ln_mlp_int8_reference(xs[0], *ops, 1e-6)),
                weight=blocks, repeatable=True)
            n_bytes, n_ops = nbytes(*xs, out, *ops), 4.0 * M * C * H
            add_bound(records["ln_mlp_int8"], dtype, n_bytes, n_ops, PEAK_INT8_OPS,
                      weight=blocks)
            if dtype == torch.bfloat16:
                swin["ms"] += swin_blocks * time_ms(lambda: K2.ln_mlp_int8(xs[0], *ops, 1e-6))
                swin["bound_ms"] += swin_blocks * max(n_bytes / HBM_BYTES_PER_S,
                                                      n_ops / PEAK_INT8_OPS) * 1e3
        del x32, xs, out
    log("kernels", f"ln_mlp_int8 per VideoSwin-S int8 forward (18 s3, 2 s4, 3 sync; bf16): "
                   f"kernel {swin['ms']:.3f} ms bound {swin['bound_ms']:.4f} ms; per MViTv2-S "
                   f"serving forward (11, 2, 3): the record's sums")
    # row 12 at UniFormer-B's shapes (C = 320 its own form), fp32 and bf16,
    # bf16 twice and bit-identical, summed per UniFormer-B int8 forward
    # outside the record (whose sums are MViTv2-S's)
    uni = ModelSums("UniFormer-B int8 forward (batch 8: 20 s3 at C 320, 7 s4, 3 sync)")
    uni_randn = randn_on(torch.Generator().manual_seed(53))
    for label, tokens, C, blocks in UNI_INT8_SHAPES:
        M, H = BATCH * tokens, 4 * C
        g, b, w1, b1, w2, b2 = (t.float() for t in mlp_inputs(uni_randn, 1, C)[1:])
        w1q, s1 = K2.quantize_weight(w1)
        w2q, s2 = K2.quantize_weight(w2)
        ops = (g, b, w1q, s1, b1, w2q, s2, b2)
        x32 = uni_randn(M, C)
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(
                records, "ln_mlp_int8", label, lambda x: K2.ln_mlp_int8(x, *ops, 1e-6),
                lambda x: K2.ln_mlp_int8_reference(x, *ops, 1e-6), [x32], dtype,
                compare=lambda out, xs: int8_errors(
                    out, K2.ln_mlp_int8_reference(xs[0], *ops, 1e-6)),
                weight=0, repeatable=True)
            if dtype == torch.bfloat16:
                n_bytes, n_ops = nbytes(*xs, out, *ops), 4.0 * M * C * H
                uni.add(records["ln_mlp_int8"], blocks, n_bytes, n_ops, PEAK_INT8_OPS)
                ms = records["ln_mlp_int8"]["_last"][0]
                bound = max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_INT8_OPS) * 1e3
                by = "bytes" if n_bytes / HBM_BYTES_PER_S > n_ops / PEAK_INT8_OPS else "operations"
                log("kernels", f"ln_mlp_int8 {label} bf16 M {M} C {C}: bound {bound:.4f} ms "
                               f"({by}), {bound / ms:.1%} of the kernel's time")
        del x32, xs, out
    uni.log("ln_mlp_int8")
    # rows whose hidden pre-activations all lie below zero, where a row's
    # largest u does not give its max |h|: the kernel's second pass 2 (at
    # each form; checked only)
    rnd = added_randn()
    for C in (384, 768, 320):
        g, b, w1, b1, w2, b2 = (t.float() for t in mlp_inputs(rnd, 1, C)[1:])
        w1q, s1 = K2.quantize_weight(0.25 * w1)
        w2q, s2 = K2.quantize_weight(w2)
        ops = (g, b, w1q, s1, b1 - 1.5, w2q, s2, b2)
        for dtype in (torch.float32, torch.bfloat16):
            check_kernel(records, "ln_mlp_int8", f"C {C} u < 0", lambda x: K2.ln_mlp_int8(
                x, *ops, 1e-6), lambda x: K2.ln_mlp_int8_reference(x, *ops, 1e-6),
                [rnd(BATCH * 64, C)], dtype, compare=lambda out, xs: int8_errors(
                    out, K2.ln_mlp_int8_reference(xs[0], *ops, 1e-6)),
                weight=0, repeatable=True)
    for label, tokens, C, blocks in PRIOR_SHAPES:
        M = BATCH * 16 * tokens
        inputs = mlp_inputs(randn, M, C)
        inputs[1:1] = [randn(M, C), 0.2 + randn(C, scale=0.05)]  # shortcut, gamma
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(records, "ln_mlp_prior_res", label,
                                   lambda *a: K2.ln_mlp_prior_res(*a, 1e-6),
                                   lambda *a: K2.ln_mlp_prior_res_reference(*a, 1e-6),
                                   inputs, dtype, weight=blocks, repeatable=True)
            add_bound(records["ln_mlp_prior_res"], dtype, nbytes(*xs, out),
                      4.0 * M * C * 4 * C, weight=blocks)
        del inputs, xs, out
    for label, tokens, C in LN_SHAPES:
        M = BATCH * 16 * tokens
        inputs = [randn(M, C) + 0.5, 1 + randn(C, scale=0.1), randn(C, scale=0.1)]
        for dtype in (torch.float32, torch.bfloat16):
            def library(x, g, b, c=C):
                return lambda: F.layer_norm(x, (c,), g, b, 1e-6)
            xs, out = check_kernel(records, "layernorm_tokens", label,
                                   lambda x, g, b: layernorm_tokens(x, g, b, 1e-6),
                                   lambda x, g, b: layernorm_tokens_reference(x, g, b, 1e-6),
                                   inputs, dtype, library)
            add_bound(records["layernorm_tokens"], dtype, nbytes(*xs, out), 8.0 * M * C,
                      PEAK_FLOPS[torch.float32])
        del inputs, xs, out
    # row 11 off the serving shapes (checked only): M = 1000 and 63 (off the
    # warp steps of every width; 63 rows fill no block) and x at an
    # element's offset into its buffer (2 bytes in bf16: the scalar form),
    # at each compiled width
    rnd = added_randn()

    def at_offset(x):
        buf = torch.empty(x.numel() + 8, device=x.device, dtype=x.dtype)
        view = buf[1:1 + x.numel()].view(x.shape)
        view.copy_(x)
        return view
    for C in LAYERNORM_C:
        for label, M, shift in ((f"C {C} M 1000", 1000, False), (f"C {C} M 63", 63, False),
                                (f"C {C} M 517 at an offset", 517, True)):
            inputs = [rnd(M, C) + 0.5, 1 + rnd(C, scale=0.1), rnd(C, scale=0.1)]
            prep = at_offset if shift else (lambda x: x)
            for dtype in (torch.float32, torch.bfloat16):
                check_kernel(records, "layernorm_tokens", label,
                             lambda x, g, b: layernorm_tokens(prep(x), g, b, 1e-6),
                             lambda x, g, b: layernorm_tokens_reference(x, g, b, 1e-6), inputs,
                             dtype, weight=0, repeatable=True)


def compare_grads(names, got, want, dtype):
    """Per-gradient (error, tolerance) pairs, each against its own scale
    max|ref| with no floor, so a sub-unit gradient is held to its own size;
    logs each gradient's error and scale."""
    out, parts = [], []
    for name, g, w in zip(names, got, want):
        w = w.float()
        err, scale = (g.float() - w).abs().max().item(), w.abs().max().item()
        out.append((err, tolerance(dtype, w, floor=0.0)))
        parts.append(f"{name} {err:.1e}/{scale:.1e}")
    log("kernels", f"  {str(dtype)[6:]} err/scale: " + " ".join(parts))
    return out


def split_kv(grads, C):
    """(dq, dkv) -> (dq, dk, dv): the two lanes of dkv have their own scales."""
    dq, dkv = grads
    return dq, dkv[..., :C], dkv[..., C:]


def check_repeatable(name, label, bwd, got) -> None:
    """One writer per element and a fixed summation order: a second run of
    the bf16 backward gives bit-identical gradients."""
    again = bwd()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    log("kernels", f"  {name} {label} bf16: a second run "
                   f"{'bit-identical' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError(f"{name} {label}: two runs differ")


def library_grad(fn, inputs, dout):
    """fwd + bwd of one library call on leaf copies of `inputs`."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]

    def run():
        torch.autograd.grad(fn(*leaves), leaves, dout)
    return run


def phase_backward(records) -> None:
    import torch.nn.functional as F

    from mspi_tpu_torch.ops.kernels import ln_mlp as K2
    from mspi_tpu_torch.ops.kernels import pooled_attention as PA

    randn = randn_on(torch.Generator().manual_seed(11))
    B = TRAIN_BATCH
    rec = records["attention_rel_bwd"]
    for label, blocks, heads, nq, k_shape in MVIT_BLOCKS + MVIT_WIDE + MVIT_R66:
        nk, r = math.prod(k_shape), sum(k_shape)
        scale = 96 ** -0.5
        inputs = [randn(B, heads, nq, 96), randn(B, heads, nk, 96), randn(B, heads, nk, 96),
                  randn(B, heads, nq, r), randn(B, heads, nq, 96)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, rel, dout = (t.to(dtype) for t in inputs)
            out, lse = PA._attention_rel_fwd(q, k, v, rel, k_shape, scale, with_lse=True)
            bwd = lambda: PA.attention_rel_backward(q, k, v, rel, out, lse, k_shape, scale, dout)
            got = bwd()
            torch.cuda.synchronize()
            want = PA.attention_rel_backward_reference(*(t.float() for t in (q, k, v, rel)),
                                                       k_shape, scale, dout.float())
            errs = compare_grads(("dq", "dk", "dv", "drel"), got, want, dtype)
            if dtype == torch.bfloat16:
                check_repeatable("attention_rel_bwd", label, bwd, got)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: PA.attention_rel_backward_reference(
                q, k, v, rel, k_shape, scale, dout))
            lib_ms = None
            if dtype == torch.bfloat16:
                mask = rel_mask(rel, k_shape)
                lib_ms = time_ms(library_grad(lambda *a: sdpa(*a, scale), (q, k, v, mask), dout))
                del mask
            record(records, "attention_rel_bwd", label, dtype, errs, ms, plain_ms, lib_ms,
                   weight=blocks)
            add_bound(rec, dtype, nbytes(q, k, v, rel, out, lse, dout, *got),
                      10.0 * B * heads * nq * nk * 96, weight=blocks)
            del got, want, out, lse
    # the bias-free backward (row 7's K4 part) at the SyncBlock shape: N = 672
    # + 36, C 512, 4 heads (D = 128); and at D = 96 (C 384, no model caller:
    # checked, out of the sums)
    N, heads = 708, 4
    added = added_randn()
    for label, C, weight in (("sync", 512, 1), ("sync-d96", 384, 0)):
        rn = added if label in ADDED_SHAPES else randn
        inputs = [rn(B, N, C), rn(B, N, 2 * C), rn(B, N, C)]
        for dtype in (torch.float32, torch.bfloat16):
            q, kv, dout = (t.to(dtype) for t in inputs)
            out, lse = PA._self_attention_fwd(q, kv, heads, with_lse=True)
            bwd = lambda: PA.self_attention_backward(q, kv, out, lse, heads, dout)
            got = bwd()
            torch.cuda.synchronize()
            want = PA.self_attention_backward_reference(q.float(), kv.float(), heads,
                                                        dout.float())
            errs = compare_grads(("dq", "dk", "dv"), split_kv(got, C), split_kv(want, C), dtype)
            if dtype == torch.bfloat16:
                check_repeatable("attention_bwd", label, bwd, got)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: PA.self_attention_backward_reference(q, kv, heads, dout))
            lib_ms = None
            if dtype == torch.bfloat16:
                qh, kh, vh, doh = (heads_major(t, heads) for t in
                                   (q, kv[..., :C], kv[..., C:], dout))
                lib_ms = time_ms(library_grad(sdpa, (qh, kh, vh), doh))
            record(records, "attention_bwd", label, dtype, errs, ms, plain_ms, lib_ms,
                   weight=weight)
            add_bound(records["attention_bwd"], dtype, nbytes(q, kv, out, lse, dout, *got),
                      10.0 * B * heads * N * N * (C // heads), weight=weight)
            del got, want, out, lse
    # the K4 backward at head dim 64: UniFormer-B's stages 3 and 4 at batch 2,
    # summed per UniFormer-B step (out of the record's sums); the library
    # time is SDPA's forward + backward
    uni = ModelSums("UniFormer-B step (batch 2, its 27 blocks)")
    uni_randn = randn_on(torch.Generator().manual_seed(53))
    for label, blocks, N, C, heads in UNI_SELF_SHAPES:
        inputs = [uni_randn(B, N, C), uni_randn(B, N, 2 * C), uni_randn(B, N, C)]
        for dtype in (torch.float32, torch.bfloat16):
            q, kv, dout = (t.to(dtype) for t in inputs)
            out, lse = PA._self_attention_fwd(q, kv, heads, with_lse=True)
            bwd = lambda: PA.self_attention_backward(q, kv, out, lse, heads, dout)
            got = bwd()
            torch.cuda.synchronize()
            want = PA.self_attention_backward_reference(q.float(), kv.float(), heads,
                                                        dout.float())
            errs = compare_grads(("dq", "dk", "dv"), split_kv(got, C), split_kv(want, C), dtype)
            del want
            if dtype == torch.bfloat16:
                check_repeatable("attention_bwd", label, bwd, got)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: PA.self_attention_backward_reference(q, kv, heads, dout))
            lib_ms = None
            if dtype == torch.bfloat16:
                qh, kh, vh, doh = (heads_major(t, heads) for t in
                                   (q, kv[..., :C], kv[..., C:], dout))
                lib_ms = time_ms(library_grad(sdpa, (qh, kh, vh), doh))
                del qh, kh, vh, doh
            record(records, "attention_bwd", label, dtype, errs, ms, plain_ms, lib_ms, weight=0)
            if dtype == torch.bfloat16:
                uni.add(records["attention_bwd"], blocks, nbytes(q, kv, out, lse, dout, *got),
                        10.0 * B * heads * N * N * (C // heads))
            del got, out, lse
    uni.log("attention_bwd (K4's part)")
    # row 9 at UniFormer-B's 27 blocks (C = 320 and 512), per UniFormer-B step
    uni = ModelSums("UniFormer-B step (batch 2, its 27 blocks)")
    for label, tokens, C, eps, blocks in UNI_LN_MLP_SHAPES:
        M = B * tokens
        inputs = mlp_inputs(uni_randn, M, C) + [uni_randn(M, C)]
        for dtype in (torch.float32, torch.bfloat16):
            xs = [t.to(dtype) for t in inputs]
            bwd = lambda: K2.ln_mlp_backward(*xs[:7], eps, xs[7])
            got = bwd()
            torch.cuda.synchronize()
            want = K2.ln_mlp_backward_reference(*(t.float() for t in xs[:7]), eps,
                                                xs[7].float())
            errs = compare_grads(("dx", "dg", "db", "dw1", "db1", "dw2", "db2"), got, want,
                                 dtype)
            if dtype == torch.bfloat16:
                check_repeatable("ln_mlp_bwd", label, bwd, got)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: K2.ln_mlp_backward_reference(*xs[:7], eps, xs[7]))
            lib_ms = None
            if dtype == torch.bfloat16:  # the unfused chain, fwd + bwd (no single call)
                lib_ms = time_ms(library_grad(
                    lambda x, g, b, w1, b1, w2, b2: F.linear(F.gelu(F.linear(
                        F.layer_norm(x, (C,), g, b, eps), w1, b1)), w2, b2), xs[:7], xs[7]))
            record(records, "ln_mlp_bwd", label, dtype, errs, ms, plain_ms, lib_ms, weight=0)
            if dtype == torch.bfloat16:
                uni.add(records["ln_mlp_bwd"], blocks, nbytes(*xs, *got), 10.0 * M * C * 4 * C)
            del got, want
    uni.log("ln_mlp_bwd (the unfused chain as library)")
    # row 9 at K2's nine shapes, each weighted by its MViTv2-S blocks (per
    # training step at batch 2); VideoSwin-S's weighting logged beside it, and
    # the unfused chain F.layer_norm -> F.linear -> F.gelu -> F.linear
    # (forward + autograd backward; no one PyTorch call computes the
    # function, so it is no library time)
    swin = {"kernel": 0.0, "chain": 0.0, "bound": 0.0}
    for label, tokens, C, eps, mvit_blocks, swin_blocks in LN_MLP_SHAPES:
        M = B * tokens
        rn = added if label in ADDED_SHAPES else randn
        inputs = mlp_inputs(rn, M, C) + [rn(M, C)]
        for dtype in (torch.float32, torch.bfloat16):
            xs = [t.to(dtype) for t in inputs]
            bwd = lambda: K2.ln_mlp_backward(*xs[:7], eps, xs[7])
            got = bwd()
            torch.cuda.synchronize()
            want = K2.ln_mlp_backward_reference(*(t.float() for t in xs[:7]), eps,
                                                xs[7].float())
            errs = compare_grads(("dx", "dg", "db", "dw1", "db1", "dw2", "db2"), got, want,
                                 dtype)
            if dtype == torch.bfloat16:
                check_repeatable("ln_mlp_bwd", label, bwd, got)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: K2.ln_mlp_backward_reference(*xs[:7], eps, xs[7]))
            record(records, "ln_mlp_bwd", label, dtype, errs, ms, plain_ms, weight=mvit_blocks)
            flops = 10.0 * M * C * 4 * C
            add_bound(records["ln_mlp_bwd"], dtype, nbytes(*xs, *got), flops, weight=mvit_blocks)
            if dtype == torch.bfloat16:
                chain_ms = time_ms(library_grad(
                    lambda x, g, b, w1, b1, w2, b2: F.linear(F.gelu(F.linear(
                        F.layer_norm(x, (C,), g, b, eps), w1, b1)), w2, b2), xs[:7], xs[7]))
                bound = max(nbytes(*xs, *got) / HBM_BYTES_PER_S,
                            flops / PEAK_FLOPS[dtype]) * 1e3
                for key, v in (("kernel", ms), ("chain", chain_ms), ("bound", bound)):
                    swin[key] += swin_blocks * v
                share = flops / (ms * 1e-3) / PEAK_FLOPS[dtype]
                log("kernels", f"  ln_mlp_bwd {label} bf16: unfused chain (fwd + bwd) "
                               f"{chain_ms:.3f} ms; kernel {share:.1%} of the bf16 peak")
            del got, want
    rec = records["ln_mlp_bwd"]
    log("kernels", f"ln_mlp_bwd per MViTv2-S step (batch 2): kernel {rec['ms']:.3f} ms, bound "
                   f"{rec['bound_ms']:.3f} ms; per VideoSwin-S step: kernel {swin['kernel']:.3f} "
                   f"ms, unfused chain {swin['chain']:.3f} ms, bound {swin['bound']:.3f} ms")
    # rows 16/17: the window backward at the eight VideoSwin variants
    from mspi_tpu_torch.ops.kernels import window_attention as WA

    for label, blocks, nw, heads, C, grid, shift in SWIN_SHAPES:
        inputs = window_inputs(randn, B, nw, heads, C, grid, shift)
        dout32 = randn(B * nw, SWIN_N, C)
        n = nw if grid is not None else 1
        for dtype in (torch.float32, torch.bfloat16):
            qkv, bias = (t.to(dtype) for t in inputs[:2])
            mask = inputs[2].to(dtype) if grid is not None else None
            dout = dout32.to(dtype)
            out, lse = WA._window_attention_fwd(qkv, bias, mask, heads, n, with_lse=True)
            bwd = lambda: WA.window_attention_backward(qkv, bias, mask, out, lse, heads, n, dout)
            got = bwd()
            torch.cuda.synchronize()
            want = WA.window_attention_backward_reference(
                qkv.float(), bias.float(), None if mask is None else mask.float(), heads, n,
                dout.float())

            def parts(g):  # dq, dk, dv lanes and dbias, each to its own scale
                dqkv, dbias = g
                return dqkv[..., :C], dqkv[..., C:2 * C], dqkv[..., 2 * C:], dbias
            errs = compare_grads(("dq", "dk", "dv", "dbias"), parts(got), parts(want), dtype)
            if dtype == torch.bfloat16:
                check_repeatable("window_attention_bwd", label, bwd, got)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: WA.window_attention_backward_reference(
                qkv, bias, mask, heads, n, dout))
            lib_ms = None
            if dtype == torch.bfloat16:
                q, k, v, m = window_library_operands(qkv, bias, mask, heads, n)
                doh = dout.reshape(B * nw, SWIN_N, heads, SWIN_D).transpose(1, 2).reshape(
                    q.shape).contiguous()
                lib_ms = time_ms(library_grad(lambda *a: sdpa(*a, SWIN_D ** -0.5),
                                              (q, k, v, m), doh))
                del q, k, v, m, doh
            record(records, "window_attention_bwd", label, dtype, errs, ms, plain_ms, lib_ms,
                   weight=blocks)
            add_bound(records["window_attention_bwd"], dtype,
                      nbytes(qkv, bias, *(() if mask is None else (mask,)), out, lse, dout,
                             *got),
                      10.0 * B * nw * heads * SWIN_N * SWIN_N * SWIN_D, weight=blocks)
            del got, want, out, lse


# its 17 stride-1 pools per clip: label, pools of the shape, heads, (T, H, W)
DWCONV_SHAPES = (("blk0-q", 1, 1, (8, 56, 96)), ("blk2-q", 1, 2, (8, 28, 48)),
                 ("blk4-13-q", 10, 4, (8, 14, 24)), ("blk14-kv", 2, 8, (8, 14, 24)),
                 ("blk15-qkv", 3, 8, (8, 7, 12)))
MVIT_D = 96
# Row 18 off the stage grids of 224x384, [N, T, H, W, C]: the stage grids of
# 288x640 (tiles 8 x 16, 8 x 16, 8 x 16, 14 x 12 by `dwconv.dwconv3d_tile`),
# each bf16 tile ragged in H and W, a part channel group (C = 40), T = 1 and
# 3, and C = 20 (off the 8-channel vector: the fp32-slab kernel in bf16)
DWCONV3D_RAGGED = (("288x640-s1", (2, 8, 72, 160, 96)), ("288x640-s2", (2, 8, 36, 80, 96)),
                   ("288x640-s3", (2, 8, 18, 40, 96)), ("288x640-s4", (2, 8, 9, 20, 96)),
                   ("8x16 ragged", (2, 8, 15, 25, 40)), ("14x12 ragged", (1, 5, 22, 19, 96)),
                   ("14x12 ragged T 3", (2, 3, 11, 25, 96)),
                   ("8x16 ragged T 1", (2, 1, 15, 19, 64)),
                   ("C 20", (1, 4, 11, 19, 20)))


def conv3d_library(x, w):
    """Grouped F.conv3d (stride 1, SAME) on the NCDHW-contiguous copy of
    channels-last x [N, T, H, W, C], made here: row 18's library call."""
    import torch.nn.functional as F

    x_ncdhw = x.permute(0, 4, 1, 2, 3).contiguous()
    return lambda: F.conv3d(x_ncdhw, w, None, 1, 1, 1, x.shape[-1])


def aug_inputs(randn, batch, heads, nq, k_shape):
    """q_aug [.., Nq, 96+R] (q*scale lanes, then rel lanes), k_aug (k, then
    the 0/1 expansion E of the key grid) and v [.., Nk, 96], as the model
    builds them."""
    from mspi_tpu_torch.ops.kernels.pooled_attention import key_expansion

    nk, r = math.prod(k_shape), sum(k_shape)
    E = torch.from_numpy(key_expansion(k_shape)).cuda()
    q_aug = torch.cat([randn(batch, heads, nq, MVIT_D, scale=MVIT_D ** -0.5),
                       randn(batch, heads, nq, r)], -1)
    k_aug = torch.cat([randn(batch, heads, nk, MVIT_D), E.expand(batch, heads, nk, r)], -1)
    return [q_aug, k_aug, randn(batch, heads, nk, MVIT_D)]


def packed_inputs(randn, batch, heads, nq, k_shape):
    """q, k, v [.., N, heads*96] and rel [.., Nq, heads*R], token-major."""
    nk, r, C = math.prod(k_shape), sum(k_shape), heads * MVIT_D
    return [randn(batch, nq, C), randn(batch, nk, C), randn(batch, nk, C),
            randn(batch, nq, heads * r)]


def phase_layout_kernels(records) -> None:
    """Rows 6, 8 and 18 at the MViTv2-S shapes, batch 8, fp32 and bf16; the
    bf16 times (kernel, plain, library, bound) summed per forward. Row 8 is
    also checked at the R = 52 shapes of 256x448 (`MVIT_WIDE`, rel rows in
    shared memory), row 18 on the packed layout and off its tiles
    (`DWCONV3D_RAGGED`), out of the sums."""
    from mspi_tpu_torch.ops.kernels import dwconv as DW
    from mspi_tpu_torch.ops.kernels import pooled_attention as PA

    randn = randn_on(torch.Generator().manual_seed(21))
    # row 6 at the 16 blocks (batch 8, in the sums), then at the augmented
    # widths of 256x448 (Da 148), 288x640 (Da 162), 64x96 (Da 109, 114),
    # 448x768 (Da 180), 512x768 (Da 184) and the widest, 256 (`AUG_CHECKS`;
    # batch 2, checked only); each bf16 run twice, bit-identical
    shapes = [(BATCH, *shape) for shape in MVIT_BLOCKS]
    shapes += [(TRAIN_BATCH, *shape) for shape in AUG_CHECKS]
    for batch, label, blocks, heads, nq, k_shape in shapes:
        nk, r = math.prod(k_shape), sum(k_shape)
        inputs = aug_inputs(randn if blocks else added_randn(), batch, heads, nq, k_shape)
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(
                records, "attention", f"{label} Da {MVIT_D + r}", PA.attention,
                PA.attention_reference, inputs, dtype,
                lambda q, k, v: (lambda: sdpa(q, k, v, scale=1.0)), weight=blocks,
                repeatable=True)
            add_bound(records["attention"], dtype, nbytes(*xs, out),
                      2.0 * batch * heads * nq * nk * (MVIT_D + r + MVIT_D), weight=blocks)
        del inputs, xs, out
    # the blocks with heads > 1, and the R = 52 shapes (checked only)
    for label, blocks, heads, nq, k_shape in MVIT_BLOCKS[1:] + MVIT_WIDE:
        nk = math.prod(k_shape)
        inputs = packed_inputs(randn, BATCH, heads, nq, k_shape)
        scale = MVIT_D ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            def library(q, k, v, rel, ks=k_shape, h=heads):
                qh, kh, vh, rh = (heads_major(t, h) for t in (q, k, v, rel))
                mask = rel_mask(rh, ks)
                return lambda: sdpa(qh, kh, vh, mask, scale) + qh
            xs, out = check_kernel(
                records, "attention_rel_packed", label,
                lambda q, k, v, rel, ks=k_shape, h=heads: PA.attention_rel_packed(
                    q, k, v, rel, ks, h, scale, True),
                lambda q, k, v, rel, ks=k_shape, h=heads: PA.attention_rel_packed_reference(
                    q, k, v, rel, ks, h, scale, True),
                inputs, dtype, library, weight=blocks)
            add_bound(records["attention_rel_packed"], dtype, nbytes(*xs, out),
                      4.0 * BATCH * heads * nq * nk * MVIT_D, weight=blocks)
        del inputs, xs, out
    # row 18 per head as the pools run it, once on the packed layout (all
    # heads' lanes, the kernel tiled over the heads), then off its tiles
    # (checked only)
    shapes = [(label, n, BATCH * heads, thw, MVIT_D) for label, n, heads, thw in DWCONV_SHAPES]
    shapes.append(("blk4-13-q packed", 0, BATCH, (8, 14, 24), 4 * MVIT_D))
    shapes += [(f"{label} [{N},{T},{H},{W},{C}]", 0, N, (T, H, W), C)
               for label, (N, T, H, W, C) in DWCONV3D_RAGGED]
    for label, pools, N, thw, C in shapes:
        inputs = [randn(N, *thw, C), randn(C, 1, 3, 3, 3, scale=0.2)]
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(records, "dwconv3d", label, DW.dwconv3d,
                                   DW.dwconv3d_reference, inputs, dtype, conv3d_library,
                                   weight=pools)
            add_bound(records["dwconv3d"], dtype, nbytes(*xs, out), 2.0 * 27 * out.numel(),
                      PEAK_FLOPS[torch.float32], weight=pools)
        del inputs, xs, out


def phase_layout_backward(records) -> None:
    """Row 7 head-major (row 6's backward) at the 16 blocks, row 8's
    backward at blocks 1-15 and row 18's dx at the 17 pools, batch 2, fp32
    and bf16. Row 7's bf16 times sum per training step into attention_bwd;
    row 8's backward (K1's kernel after a layout change; not on a chip
    path) and row 18's dx are checked and logged only."""
    from mspi_tpu_torch.ops.kernels import dwconv as DW
    from mspi_tpu_torch.ops.kernels import pooled_attention as PA

    randn = randn_on(torch.Generator().manual_seed(31))
    B = TRAIN_BATCH
    # the 16 blocks (in the sums), then the augmented widths off 224x384
    # (`AUG_CHECKS`: Da 148, 162, 109, 114, 180, 184 and 256; checked only)
    for label, blocks, heads, nq, k_shape in MVIT_BLOCKS + AUG_CHECKS:
        nk, r = math.prod(k_shape), sum(k_shape)
        rnd = randn if blocks else added_randn()
        inputs = aug_inputs(rnd, B, heads, nq, k_shape) + [rnd(B, heads, nq, MVIT_D)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = (t.to(dtype) for t in inputs)
            out, lse = PA._attention_fwd(q, k, v, with_lse=True)
            bwd = lambda: PA.attention_backward(q, k, v, out, lse, dout)
            got = bwd()
            torch.cuda.synchronize()
            want = PA.attention_backward_reference(q.float(), k.float(), v.float(),
                                                   dout.float())
            errs = compare_grads(("dq", "dk", "dv"), got, want, dtype)
            if dtype == torch.bfloat16:
                check_repeatable("attention_bwd", f"{label} Da {MVIT_D + r}", bwd, got)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: PA.attention_backward_reference(q, k, v, dout))
            lib_ms = None
            if dtype == torch.bfloat16:
                lib_ms = time_ms(library_grad(lambda *a: sdpa(*a, scale=1.0), (q, k, v), dout))
            record(records, "attention_bwd", f"{label} Da {MVIT_D + r}", dtype, errs, ms,
                   plain_ms, lib_ms, weight=blocks)
            add_bound(records["attention_bwd"], dtype, nbytes(q, k, v, out, lse, dout, *got),
                      2.0 * B * heads * nq * nk * (3 * (MVIT_D + r) + 2 * MVIT_D),
                      weight=blocks)
            del got, want, out, lse
    for label, blocks, heads, nq, k_shape in MVIT_BLOCKS[1:] + MVIT_WIDE + MVIT_R66:
        scale = MVIT_D ** -0.5
        inputs = packed_inputs(randn, B, heads, nq, k_shape) + [randn(B, nq, heads * MVIT_D)]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, rel, dout = (t.to(dtype) for t in inputs)
            o, lse = PA._attention_rel_packed_fwd(q, k, v, rel, k_shape, heads, scale, False,
                                                  with_lse=True)
            bwd = lambda: PA.attention_rel_packed_backward(q, k, v, rel, o, lse, k_shape, heads,
                                                           scale, True, dout)
            got = bwd()
            torch.cuda.synchronize()
            want = PA.attention_rel_packed_backward_reference(
                *(t.float() for t in (q, k, v, rel)), k_shape, heads, scale, True, dout.float())
            errs = compare_grads(("dq", "dk", "dv", "drel"), got, want, dtype)
            if dtype == torch.bfloat16:
                check_repeatable("attention_rel_bwd", f"packed {label}", bwd, got)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: PA.attention_rel_packed_backward_reference(
                q, k, v, rel, k_shape, heads, scale, True, dout))
            record(records, "attention_rel_bwd", f"packed {label}", dtype, errs, ms, plain_ms,
                   weight=0)
            del got, want, o, lse
    for label, pools, heads, thw in DWCONV_SHAPES:
        C, N = MVIT_D, B * heads
        inputs = [randn(N, *thw, C), randn(C, 1, 3, 3, 3, scale=0.2), randn(N, *thw, C)]
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dy = (t.to(dtype) for t in inputs)
            dx_fn = lambda: DW._dwconv3d_fwd(dy, w.flip(2, 3, 4).contiguous())
            dx = dx_fn()
            torch.cuda.synchronize()
            want = DW.dwconv3d_backward_reference(x.float(), w.float(), dy.float())[0]
            errs = compare_grads(("dx",), (dx,), (want,), dtype)
            ms = time_ms(dx_fn)
            plain_ms = time_ms(lambda: DW.dwconv3d_reference(dy, w.flip(2, 3, 4)))
            lib_ms = None
            if dtype == torch.bfloat16:  # grouped conv3d of dy with the flipped taps
                with torch.no_grad():
                    lib_ms = time_ms(conv3d_library(dy, w.flip(2, 3, 4).contiguous()))
            record(records, "dwconv3d", f"dx {label}", dtype, errs, ms, plain_ms, lib_ms,
                   weight=0)
            del dx, want


def phase_mlp_kernels(records) -> dict:
    """Rows 13 and 14 against their plain versions at K2's shapes (forward
    batch 8, backward batch 2), fp32 and bf16; then the path: one
    `maybe_fused_mlp` forward and backward of the port's MViT `Mlp` (C 96,
    fp32) at stage 1's tokens, batch 2, with exactly one launch of each."""
    import torch.nn.functional as F

    from mspi_tpu_torch.models.mvit import Mlp
    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.ops.kernels import ln_mlp as K2

    randn = randn_on(torch.Generator().manual_seed(41))
    added = added_randn()
    for label, tokens, C, *_ in LN_MLP_SHAPES:
        M = BATCH * tokens
        x, _, _, w1, b1, w2, b2 = mlp_inputs(added if label in ADDED_SHAPES else randn, M, C)
        for dtype in (torch.float32, torch.bfloat16):
            xs, out = check_kernel(records, "mlp", label, K2.fused_mlp, K2.mlp_reference,
                                   [x, w1, b1, w2, b2], dtype, repeatable=True)
            add_bound(records["mlp"], dtype, nbytes(*xs, out), 4.0 * M * C * 4 * C)
        del x, xs, out
    for label, tokens, C, *_ in LN_MLP_SHAPES:
        M = TRAIN_BATCH * tokens
        rn = added if label in ADDED_SHAPES else randn
        x, _, _, w1, b1, w2, b2 = mlp_inputs(rn, M, C)
        inputs = [x, w1, b1, w2, b2, rn(M, C)]
        for dtype in (torch.float32, torch.bfloat16):
            xs = [t.to(dtype) for t in inputs]
            bwd = lambda: K2.mlp_backward(*xs)
            got = bwd()
            torch.cuda.synchronize()
            want = K2.mlp_backward_reference(*(t.float() for t in xs))
            errs = compare_grads(("dx", "dw1", "db1", "dw2", "db2"), got, want, dtype)
            if dtype == torch.bfloat16:
                check_repeatable("mlp_bwd", label, bwd, got)
            ms = time_ms(bwd)
            plain_ms = time_ms(lambda: K2.mlp_backward_reference(*xs))
            record(records, "mlp_bwd", label, dtype, errs, ms, plain_ms)
            add_bound(records["mlp_bwd"], dtype, nbytes(*xs, *got), 10.0 * M * C * 4 * C)
            del got, want

    torch.manual_seed(0)
    mlp = Mlp(96, 384, 96).cuda()
    x = torch.randn(TRAIN_BATCH, 43008, 96, generator=torch.Generator().manual_seed(42)).cuda()
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(43)).cuda()
    x.requires_grad_(True)
    kernels.reset_launch_counts()
    y = K2.maybe_fused_mlp(mlp, x)
    y.backward(dy)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    want_counts = {name: int(name in ("mlp", "mlp_bwd")) for name in KERNELS}
    if counts != want_counts:
        raise AssertionError(f"maybe_fused_mlp launches {counts}, expected one mlp, one mlp_bwd")
    grads = [x.grad] + [p.grad for p in mlp.parameters()]
    ref = mlp.fc2(F.gelu(mlp.fc1(x.detach())))
    err = (y - ref).abs().max().item()
    if not (err <= tolerance(torch.float32, ref) and all(torch.isfinite(g).all() for g in grads)):
        raise AssertionError(f"maybe_fused_mlp: error {err} or non-finite gradients")
    log("mlp_kernels", f"maybe_fused_mlp on Mlp(96, 384) fp32 [{TRAIN_BATCH}, 43008, 96]: "
                       f"forward + backward, launches mlp 1 mlp_bwd 1, max_abs_err {err:.3e}, "
                       f"gradients finite")
    return counts


# row 19's ragged shapes [N, H, W, C]: H and W off its tiles (8 x 16 at W =
# 41 and 19, 8 x 32 with H off 8 at W = 64 and 32; the lab's stages fill
# whole 4 x 8 warp tiles), each tile width with a part channel group (C =
# 40) and C = 1
DWCONV2D_RAGGED = ((2, 13, 41, 40), (3, 9, 19, 1), (2, 13, 64, 40), (1, 11, 32, 1))


LAB_RAGGED_M = (1000, 63)  # off the bf16 bodies' 128-row and the int8 body's 192-row tiles


def check_lab_mlp_ragged(records) -> None:
    """Row 20's six bodies and row 21's two MLP bodies at C 96, H 384 on
    ragged row counts, checked only: the bf16 bodies within 3 x 2^-8 of the
    output scale, `mlp_int8w` within row 12's int8 tolerance with one row
    all zeros (its amax at the 1e-6 floor, its outputs zero); each run twice,
    bit-identical."""
    from mspi_tpu_torch.ops.kernels import lab

    randn = randn_on(torch.Generator().manual_seed(15))
    for M in LAB_RAGGED_M:
        xs = mlp_inputs(randn, M, lab.LAB_C)
        for v in lab.LAB_VARIANTS:
            check_kernel(records, f"lab_{v}", f"M={M}",
                         lambda *a, v=v: lab.ln_mlp_lab(*a, v),
                         lambda *a, v=v: lab.ln_mlp_lab_reference(*a, v), xs, torch.bfloat16,
                         weight=0, repeatable=True)
        check_kernel(records, "mlp_bf16", f"M={M}", lab.mlp_bf16, lab.mlp_bf16_reference,
                     [xs[0], xs[3], xs[5]], torch.bfloat16, weight=0, repeatable=True)
        x = xs[0].bfloat16()
        x[M // 2] = 0
        (w1q, s1), (w2q, s2) = (lab.quantize_weight_lab(w) for w in (xs[3], xs[5]))
        ops = (x, w1q, s1, w2q, s2)
        out = lab.mlp_int8w(*ops)
        torch.cuda.synchronize()
        check_repeatable("mlp_int8w", f"M={M}", lambda: (lab.mlp_int8w(*ops),), (out,))
        if out[M // 2].abs().max().item() != 0:
            raise AssertionError(f"mlp_int8w M={M}: the all-zero row's output is not zero")
        record(records, "mlp_int8w", f"M={M} (row {M // 2} all zeros)", torch.bfloat16,
               int8_errors(out, lab.mlp_int8w_reference(*ops)),
               time_ms(lambda: lab.mlp_int8w(*ops)),
               time_ms(lambda: lab.mlp_int8w_reference(*ops)), weight=0)
        del xs, x, ops, out


def check_lab_widths(records) -> None:
    """The labs' MLP bodies off C = 96, checked only, at M = 1000: row 20's
    six and `mlp_bf16` at each of K2's other widths (H = 4C), `mlp_int8w`
    at row 12's widths with H = 4C, and at every width it is compiled for
    with H = 320 (H % 128 == 64: the last step's units against a
    zero-filled W2 box; in the forms whose two consumers share rows, the
    second consumer's units of that step lie past H); each run twice,
    bit-identical."""
    from mspi_tpu_torch.ops.kernels import lab

    randn, M = randn_on(torch.Generator().manual_seed(17)), 1000
    for C in lab.LAB_WIDTHS[1:]:
        xs = mlp_inputs(randn, M, C)
        for v in lab.LAB_VARIANTS:
            check_kernel(records, f"lab_{v}", f"C={C} M={M}",
                         lambda *a, v=v: lab.ln_mlp_lab(*a, v),
                         lambda *a, v=v: lab.ln_mlp_lab_reference(*a, v), xs, torch.bfloat16,
                         weight=0, repeatable=True)
        check_kernel(records, "mlp_bf16", f"C={C} M={M}", lab.mlp_bf16, lab.mlp_bf16_reference,
                     [xs[0], xs[3], xs[5]], torch.bfloat16, weight=0, repeatable=True)
    for C, H in ([(C, 4 * C) for C in lab.INT8_LAB_WIDTHS[1:]]
                 + [(C, 320) for C in lab.INT8_LAB_WIDTHS]):
        x, w1, w2 = randn(M, C), randn(H, C, scale=C ** -0.5), randn(C, H, scale=H ** -0.5)
        (w1q, s1), (w2q, s2) = lab.quantize_weight_lab(w1), lab.quantize_weight_lab(w2)
        ops = (w1q, s1, w2q, s2)
        check_kernel(records, "mlp_int8w", f"C={C} H={H} M={M}",
                     lambda x: lab.mlp_int8w(x, *ops), lambda x: lab.mlp_int8w_reference(x, *ops),
                     [x], torch.bfloat16, weight=0, repeatable=True,
                     compare=lambda out, xs: int8_errors(out, lab.mlp_int8w_reference(xs[0], *ops)))


def phase_lab(records) -> dict:
    """The three kernel labs' `main` in this process at their default shapes
    (MSPI_LAB_ITERS repeats, 20 unless set); each kernel variant is held
    against its plain version inside the lab, and its times and bound fold
    into its record. The labs' launches are this phase's path."""
    import os

    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.ops.kernels.dwconv import dwconv2d, dwconv2d_reference
    from mspi_tpu_torch.ops.kernels.lab import gemm, gemm_reference
    from mspi_tpu_torch.tools import bench_dwconv, bench_int8, bench_lnmlp

    # the bf16 GEMM off the lab's square: 3 k tiles, and 2.5 (K % 64 == 32)
    randn = randn_on(torch.Generator().manual_seed(3))
    for M, K, N in ((256, 192, 384), (384, 160, 640)):
        check_kernel(records, "gemm_bf16", f"{M}x{K}x{N}", gemm, gemm_reference,
                     [randn(M, K), randn(K, N)], torch.bfloat16, weight=0)
    # the int8 GEMM exactly, wrap-around included: 1.5 and 2.5 k boxes of 128
    # (K % 128 == 64) in 64-row tiles, 2.5 in 128-row tiles (144 of them),
    # and 4096^3 (128-row tiles)
    gen8 = torch.Generator().manual_seed(4)

    def exact(out, xs):
        return [((out.int() - gemm_reference(*xs).int()).abs().max().item(), 0.0)]
    for M, K, N in ((256, 192, 384), (384, 320, 640), (2048, 320, 1152), (4096, 4096, 4096)):
        a, b = (torch.randint(-127, 128, shape, generator=gen8, dtype=torch.int8).cuda()
                for shape in ((M, K), (K, N)))
        check_kernel(records, "gemm_int8", f"{M}x{K}x{N}", gemm, gemm_reference, [a, b],
                     torch.int8, compare=exact, weight=0)
    # row 19 off its tiles: a part channel group (C = 40) by the 16-byte
    # copies, and C = 1 by the element loads
    for N, H, W, C in DWCONV2D_RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            check_kernel(records, "dwconv2d", f"[{N},{H},{W},{C}]", dwconv2d,
                         dwconv2d_reference,
                         [randn(N, H, W, C), randn(7, 7, C, scale=0.1), randn(C, scale=0.1)],
                         dtype, weight=0)
    check_lab_mlp_ragged(records)
    check_lab_widths(records)
    os.environ.setdefault("MSPI_LAB_ITERS", "20")
    kernels.reset_launch_counts()
    results = []
    for lab in (bench_dwconv, bench_lnmlp, bench_int8):
        log("lab", f"python -m {lab.__name__}")
        results += lab.main([])
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    for r in results:
        if r.kernel is None:
            continue
        rec = records[r.kernel]
        rec["max_abs_err"] = max(rec["max_abs_err"], r.max_abs_err)
        rec["ms"] += r.ms
        rec["plain_ms"] += r.plain_ms
        if r.library_ms is not None:
            rec["library_ms"] = (rec["library_ms"] or 0.0) + r.library_ms
        rec["bound_ms"] += r.bound_ms
        rec["bound_by"] = r.bound_by
    missing = [name for name in LAB_KERNELS if not counts[name]]
    if missing:
        raise AssertionError(f"lab kernels not launched: {missing}")
    log("lab", f"launches {counts}")
    return counts


def synthetic_video(seed: int, res=RES):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (N_FRAMES, *res, 3), dtype=np.uint8)
    t = np.arange(int(2.5 * SAMPLE_RATE)) / SAMPLE_RATE
    audio = (0.3 * np.sin(2 * np.pi * 440 * t) * np.sin(2 * np.pi * 0.7 * t)
             + 0.05 * rng.standard_normal(t.size)).astype(np.float32)
    return frames, audio


def model_config(key: str, res=RES):
    """The config of a PER_FORWARD key: a motion encoder, + its options, at
    input resolution `res`."""
    from mspi_tpu_torch.config import get_config

    return get_config(key.split("+")[0], {"model": OPTIONS.get(key, {}),
                                          "data": {"resolution": tuple(res)}})


def build_model(key: str, device: str, dtype: torch.dtype, res=RES):
    """The AV model of a PER_FORWARD key, or the visual-only one for
    '+visual', at input resolution res."""
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel, VisualSaliencyModel

    cls = VisualSaliencyModel if key.endswith("+visual") else AudioVisualSaliencyModel
    return cls(model_config(key, res), device=device, dtype=dtype,
               generator=torch.Generator().manual_seed(0))


def phase_main_path(tag: str, key: str, res=RES) -> dict:
    from mspi_tpu_torch.inference import predict_video, sliding_window_jobs
    from mspi_tpu_torch.ops import kernels

    model = build_model(key, "cuda", torch.bfloat16, res)
    frames, audio = synthetic_video(0, res)
    n_windows = len(sliding_window_jobs(N_FRAMES, 16))
    forwards = -(-n_windows // BATCH)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    maps = predict_video(model, frames, audio, FPS, window_batch=BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    log(tag, f"{key} predict_video: {n_windows} windows in {forwards} forwards of "
             f"{BATCH}, {wall:.2f} s wall (first call), launches {counts}")

    if maps.shape != (N_FRAMES, 480, 640) or maps.dtype != np.uint8:
        raise AssertionError(f"maps {maps.shape} {maps.dtype}, expected "
                             f"({N_FRAMES}, 480, 640) uint8")
    flat = maps.reshape(N_FRAMES, -1)
    if not ((flat.min(axis=1) == 0).all() and (flat.max(axis=1) == 255).all()):
        raise AssertionError("a map is constant or not min-max normalised "
                             "(non-finite log-density)")
    for name in KERNELS:
        want = forwards * PER_FORWARD[key].get(name, 0)
        if counts[name] != want:
            raise AssertionError(f"{name}: {counts[name]} launches, expected {want}")

    clips = torch.from_numpy(np.stack([frames[i:i + 16] for i in range(BATCH)])).cuda()
    auds = torch.randn(BATCH, 257, 111, 1, generator=torch.Generator().manual_seed(2)).cuda()
    inputs = (clips,) if key.endswith("+visual") else (clips, auds)
    with torch.no_grad():
        out, loss = model(*inputs)
        if not (torch.isfinite(out).all() and torch.isfinite(torch.as_tensor(loss))):
            raise AssertionError("non-finite model output")
        ms = time_ms(lambda: model(*inputs), warmup=1, reps=3)
    log(tag, f"{key} forward bf16 batch {BATCH} {res[0]}x{res[1]}: {ms:.1f} ms = "
             f"{BATCH * 1000 / ms:.2f} clips/s (CUDA events, median of 3); "
             f"map {N_FRAMES} x 480 x 640 uint8 ok")
    if key in OPTIONS:
        compare_with_float(tag, key, model, clips, auds)
    del model
    torch.cuda.empty_cache()
    return counts


def compare_with_float(tag: str, key: str, model, clips, auds) -> None:
    """The options' model against the float bf16 model of the same seed:
    forwards timed in turns (float, options, options, float), and how many
    int8 codes the bf16-rounded weights give otherwise than the fp32
    weights the models are drawn from."""
    from mspi_tpu_torch.ops.kernels.ln_mlp import quantize_weight

    flt = build_model(key.split("+")[0], "cuda", torch.bfloat16)
    with torch.no_grad():
        times = [time_ms(lambda m=m: m(clips, auds), warmup=1, reps=5)
                 for m in (flt, model, model, flt)]
    del flt
    log(tag, f"{key} vs float, bf16 batch {BATCH}, in turns: float {times[0]:.1f} / "
             f"{times[3]:.1f} ms, options {times[1]:.1f} / {times[2]:.1f} ms = "
             f"{BATCH * 1000 / statistics.mean(times[:4:3]):.2f} vs "
             f"{BATCH * 1000 / statistics.mean(times[1:3]):.2f} clips/s (CUDA events, "
             f"medians of 5)")
    if OPTIONS[key].get("quant") != "int8":
        return
    ref = build_model(key, "cpu", torch.float32)
    ref_mods = dict(ref.named_modules())
    differ = total = 0
    for name, m in model.named_modules():
        if hasattr(m, "int8_w1q"):
            for q, w in ((m.int8_w1q, ref_mods[name].fc1.weight),
                         (m.int8_w2q, ref_mods[name].fc2.weight)):
                differ += (q.cpu() != quantize_weight(w)[0]).sum().item()
                total += q.numel()
    log(tag, f"int8 codes of the bf16 model's weights: {differ} of {total} "
             f"({100.0 * differ / total:.3f}%) differ from the fp32 weights' codes")


def phase_options_parity(tag: str, key: str) -> None:
    """The options' model in fp32: card against the CPU's plain versions
    (CC >= 0.9999), and card against the card's model without the options
    (int8: CC >= 0.99, the cost of int8, recorded; the layout options
    compute the same function: CC >= 0.9999)."""
    frames, _ = synthetic_video(3)
    clip = torch.from_numpy(frames[None, :16].copy())
    aud = torch.randn(1, 257, 111, 1, generator=torch.Generator().manual_seed(4))
    outs = {}
    for name, k, device in (("card", key, "cuda"), ("cpu", key, "cpu"),
                            ("card float", key.split("+")[0], "cuda")):
        model = build_model(k, device, torch.float32)
        t0 = time.perf_counter()
        with torch.no_grad():
            out, _ = model(clip.to(device), aud.to(device))
        outs[name] = out.cpu().double().flatten()
        log(tag, f"{k} fp32 forward on {device}: {time.perf_counter() - t0:.1f} s")
        del model
    float_need = 0.99 if OPTIONS[key].get("quant") == "int8" else 0.9999
    for other, need in (("cpu", 0.9999), ("card float", float_need)):
        a, b = outs["card"], outs[other]
        cc = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
        log(tag, f"{key} log-density {RES[0]}x{RES[1]} card vs {other}: CC {cc:.8f} "
                 f"(need >= {need}), max abs diff {(a - b).abs().max().item():.3e}")
        if not cc >= need:
            raise AssertionError(f"card vs {other}: CC {cc} below {need}")


def phase_parity(tag: str, encoder: str, res=RES) -> None:
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel

    cfg = model_config(encoder, res)
    frames, _ = synthetic_video(3, res)
    clip = torch.from_numpy(frames[None, :16].copy())
    aud = torch.randn(1, 257, 111, 1, generator=torch.Generator().manual_seed(4))
    outs = []
    for device in ("cuda", "cpu"):
        model = AudioVisualSaliencyModel(cfg, device=device, dtype=torch.float32,
                                         generator=torch.Generator().manual_seed(0))
        t0 = time.perf_counter()
        with torch.no_grad():
            out, _ = model(clip.to(device), aud.to(device))
        outs.append(out.cpu().double())
        log(tag, f"{encoder} fp32 forward on {device}: {time.perf_counter() - t0:.1f} s")
        del model
    a, b = (o.flatten() for o in outs)
    cc = torch.corrcoef(torch.stack([a, b]))[0, 1].item()
    diff = (a - b).abs().max().item()
    log(tag, f"{encoder} log-density {res[0]}x{res[1]} card vs CPU: CC {cc:.8f} "
             f"(need >= 0.9999), max abs diff {diff:.3e}")
    if not cc >= 0.9999:
        raise AssertionError(f"end-to-end CC {cc} below 0.9999")


def _frozen_snapshot(model):
    from mspi_tpu_torch.train.engine import FROZEN_TOPLEVEL

    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.split(".", 1)[0] in FROZEN_TOPLEVEL}


PEAK_GIB = {}  # PER_STEP key -> peak device memory of its training phase


def phase_training(tag: str, encoder: str, res=RES) -> dict:
    """`encoder`: a PER_STEP key, a motion encoder and its options; at input
    resolution res. Every trainable tensor must move, but those whose names
    start with UNCHANGED[encoder], which must all stay as they were."""
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.train import engine
    from mspi_tpu_torch.train.synthetic import make_batch

    cfg = model_config(encoder, res)
    model = AudioVisualSaliencyModel(cfg, device="cuda", dtype=torch.float32,
                                     generator=torch.Generator().manual_seed(0))
    state = engine.create_train_state(cfg, model)
    step = engine.make_train_step(cfg.train.gamma, compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    batches = [engine.to_device(make_batch(rng, TRAIN_BATCH, 16, res, SPECTRO), "cuda")
               for _ in range(STEPS)]
    frozen = _frozen_snapshot(model)
    before = [p.detach().clone() for p in engine.trainable_parameters(state)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    history, walls = [], []
    for batch in batches:
        t0 = time.perf_counter()
        history.append(step(state, batch, cfg.solver.lr))  # ends in a sync
        walls.append(time.perf_counter() - t0)
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    PEAK_GIB[encoder] = peak
    steady = statistics.median(walls[1:])
    log(tag, f"{encoder} {STEPS} steps bf16 batch {TRAIN_BATCH} {res[0]}x{res[1]}: first "
             f"{walls[0]:.2f} s, then median {steady * 1e3:.1f} ms = "
             f"{1 / steady:.3f} steps/s = {TRAIN_BATCH / steady:.2f} clips/s (host clock "
             f"around synced steps); peak memory {peak:.2f} GiB")
    for i, m in enumerate(history):
        log(tag, f"step {i}: " + " ".join(f"{k} {v:.5f}" for k, v in m.items()))
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in history):
        raise AssertionError("non-finite loss or gradient norm")
    for name in KERNELS:
        want = STEPS * PER_STEP[encoder].get(name, 0)
        if counts[name] != want:
            raise AssertionError(f"{name}: {counts[name]} launches in training, expected {want}")
    still = [n for n, a, p in zip(state.param_names, before, engine.trainable_parameters(state))
             if torch.equal(a, p)]
    prefix = UNCHANGED.get(encoder)
    expected = [n for n in state.param_names if prefix and n.startswith(prefix)]
    log(tag, f"launches {counts}; {len(before) - len(still)} of {len(before)} trainable "
             f"tensors moved; unchanged {len(still)}: {still} (expected {len(expected)}"
             f"{f', every one under {prefix}' if prefix else ''})")
    if still != expected:
        raise AssertionError(f"unchanged trainable tensors {still[:5]}, expected {expected[:5]} "
                             f"({len(still)} against {len(expected)})")
    after = _frozen_snapshot(model)
    changed = [k for k in frozen if not torch.equal(frozen[k], after[k])]
    if changed:
        raise AssertionError(f"frozen tensors changed: {changed[:5]}")
    log(tag, f"{len(frozen)} frozen tensors bit-identical")
    del model, state, batches
    torch.cuda.empty_cache()
    return counts


def phase_train_parity(tag: str, encoder: str, res=RES) -> None:
    """`encoder`: a motion encoder, + its options; at input resolution res."""
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
    from mspi_tpu_torch.train import engine
    from mspi_tpu_torch.train.synthetic import make_batch

    cfg = model_config(encoder, res)
    batch = make_batch(np.random.default_rng(6), TRAIN_BATCH, 16, res, SPECTRO)
    results = []
    for device in ("cuda", "cpu"):
        model = AudioVisualSaliencyModel(cfg, device=device, dtype=torch.float32,
                                         generator=torch.Generator().manual_seed(0))
        state = engine.create_train_state(cfg, model, seed=9)
        step = engine.make_train_step(cfg.train.gamma)
        t0 = time.perf_counter()
        metrics = step(state, engine.to_device(batch, device), cfg.solver.lr)
        grads = torch.cat([p.grad.detach().double().flatten().cpu()
                           for p in engine.trainable_parameters(state)])
        log(tag, f"{encoder} fp32 step on {device}: {time.perf_counter() - t0:.1f} s; "
                 + " ".join(f"{k} {v:.6f}" for k, v in metrics.items()))
        results.append((metrics, grads))
        del model, state
    (m_gpu, g_gpu), (m_cpu, g_cpu) = results
    cos = (g_gpu @ g_cpu / (g_gpu.norm() * g_cpu.norm())).item()
    diffs = {k: abs(m_gpu[k] - m_cpu[k]) for k in m_cpu}
    log(tag, f"{encoder} {res[0]}x{res[1]} card vs CPU: gradient cosine {cos:.8f} "
             f"(need >= 0.9999); |diff| " + " ".join(f"{k} {v:.2e}" for k, v in diffs.items()))
    if not cos >= 0.9999:
        raise AssertionError(f"gradient cosine {cos} below 0.9999")
    for k in ("loss", "kl", "cc", "sim", "loss_va"):
        if not diffs[k] <= 1e-3 * max(1.0, abs(m_cpu[k])):
            raise AssertionError(f"{k}: card {m_gpu[k]} vs CPU {m_cpu[k]}")


def _named_grads(model) -> dict:
    return {n: p.grad.detach().double().flatten().cpu() for n, p in model.named_parameters()
            if p.grad is not None}


def _cosine(a: dict, b: dict) -> float:
    x, y = torch.cat([a[n] for n in a]), torch.cat([b[n] for n in a])
    return (x @ y / (x.norm() * y.norm())).item()


def _flat(tensors: dict) -> torch.Tensor:
    return torch.cat([t.detach().flatten().double().cpu() for t in tensors.values()])


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm()).item()


def _times(err: float, spread: float) -> str:
    return f"{err / spread:.3f}" if spread else ("0" if err == 0 else "inf")


def phase_ddp_training(tag: str, key: str) -> dict:
    """`make_ddp_train_step` on an NCCL group of world size 1 (one card),
    the flagship at 224x384, batch 2: one fp32 step (TF32 off, drop-path
    off in both models) against three runs of `make_train_step` from the
    same weights and batch, all under torch's deterministic algorithms
    (cuDNN's deterministic convolutions among them). The DDP step's
    gradients and parameter updates after AdamW (each by relative L2, so a
    gradient off by a constant factor shows though Adam's update hides it)
    and each metric may lie from every plain run's by DDP_SPREAD_FACTOR
    times the plain runs' largest pairwise distance: bit-equal wherever
    the plain runs agree bit for bit (their forward metrics do), but the
    grad norm, which the DDP step sums from the squares of the per-tensor
    norms and the plain step takes as the norm of those norms, within
    1e-6 of itself besides (one fp32 ulp is 6e-8-1.2e-7 of it). Its one
    all-reduce counted. Then bf16 steps of both in turns
    (plain, DDP, DDP, plain; with drop-path), their steps/s; the path's
    launches are those bf16 steps'."""
    import warnings

    import torch.distributed as dist

    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.ops.layers import DropPath
    from mspi_tpu_torch.parallel import create_mesh, free_port
    from mspi_tpu_torch.train import engine
    from mspi_tpu_torch.train.synthetic import make_batch

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = create_mesh((1, 1), "cuda")
        cfg = model_config(key)
        lr = cfg.solver.lr
        batch = engine.to_device(make_batch(np.random.default_rng(8), TRAIN_BATCH, 16, RES,
                                            SPECTRO), "cuda")
        calls = []
        all_reduce = dist.all_reduce

        def counting(*args, **kwargs):
            calls.append(1)
            return all_reduce(*args, **kwargs)

        def build(drop_path: bool):
            model = AudioVisualSaliencyModel(cfg, device="cuda", dtype=torch.float32,
                                             generator=torch.Generator().manual_seed(0))
            if not drop_path:
                for m in model.modules():
                    if isinstance(m, DropPath):
                        m.rate = 0.0
            return model, engine.create_train_state(cfg, model, seed=9)

        runs = {}
        cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for kind in ("plain", "ddp", "plain2", "plain3"):
                    model, state = build(False)
                    before = _flat({n: p.clone() for n, p in model.named_parameters()})
                    step = (engine.make_ddp_train_step(cfg.train.gamma, mesh) if kind == "ddp"
                            else engine.make_train_step(cfg.train.gamma))
                    dist.all_reduce = counting
                    metrics = step(state, batch, lr)
                    dist.all_reduce = all_reduce
                    runs[kind] = (metrics, _flat(_named_grads(model)),
                                  _flat(dict(model.named_parameters())) - before)
                    del model, state
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
        nondeterministic = sorted({str(w.message).split(" does not")[0] for w in caught
                                   if "deterministic" in str(w.message)})
        ddp = runs.pop("ddp")
        plain = list(runs.values())
        pairs = [(a, b) for i, a in enumerate(plain) for b in plain[i + 1:]]
        g_spread = max(_rel(a[1], b[1]) for a, b in pairs)
        u_spread = max(_rel(a[2], b[2]) for a, b in pairs)
        g_err = max(_rel(ddp[1], p[1]) for p in plain)
        u_err = max(_rel(ddp[2], p[2]) for p in plain)
        m_spread = {k: max(abs(a[0][k] - b[0][k]) for a, b in pairs) for k in ddp[0]}
        m_err = {k: max(abs(ddp[0][k] - p[0][k]) for p in plain) for k in ddp[0]}
        differ = int((ddp[1] != plain[0][1]).sum()), int((ddp[2] != plain[0][2]).sum())
        f = DDP_SPREAD_FACTOR
        log(tag, f"{key} fp32 step under deterministic algorithms, DDP (NCCL, world 1) vs 3 "
                 f"plain runs: all_reduce calls {len(calls)} (need 1); gradients relative L2 "
                 f"{g_err:.3e} (the plain runs' spread {g_spread:.3e}, "
                 f"{_times(g_err, g_spread)} x; "
                 f"{differ[0]} of {ddp[1].numel()} values differ from the first run), "
                 f"parameter updates {u_err:.3e} (spread {u_spread:.3e}, "
                 f"{_times(u_err, u_spread)} x; {differ[1]} values differ); "
                 f"need <= {f} x spread; "
                 f"metrics |diff| (spread) "
                 + " ".join(f"{k} {m_err[k]:.2e} ({m_spread[k]:.2e})" for k in m_err)
                 + f"; ops without a deterministic backward: {nondeterministic or 'none'}")
        if len(calls) != 1:
            raise AssertionError(f"the DDP step issued {len(calls)} all-reduces")
        if not (g_err <= f * g_spread and u_err <= f * u_spread):
            raise AssertionError(f"the DDP step differs from the plain step (gradients "
                                 f"{g_err}, updates {u_err}) beyond {f} x the plain runs' "
                                 f"spread ({g_spread}, {u_spread})")
        for k in m_err:  # the grad norm: the DDP step's sum of squares rounds otherwise
            slack = 1e-6 * abs(plain[0][0][k]) if k == "grad_norm" else 0.0
            if not m_err[k] <= f * m_spread[k] + slack:
                raise AssertionError(f"{k}: DDP {ddp[0][k]} vs plain {plain[0][0][k]}, "
                                     f"beyond {f} x the plain runs' spread {m_spread[k]}")

        steppers = {"plain": engine.make_train_step(cfg.train.gamma,
                                                     compute_dtype=torch.bfloat16),
                    "ddp": engine.make_ddp_train_step(cfg.train.gamma, mesh,
                                                      compute_dtype=torch.bfloat16)}
        states = {k: build(True)[1] for k in steppers}
        for k in steppers:  # first steps: the kernels' and allocator's warm-up
            steppers[k](states[k], batch, lr)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        walls = {k: [] for k in steppers}
        for k in ("plain", "ddp", "ddp", "plain"):
            for _ in range(3):
                t0 = time.perf_counter()
                steppers[k](states[k], batch, lr)  # ends in a sync
                walls[k].append(time.perf_counter() - t0)
        counts = dict(kernels.launches)
        rate = {k: 1.0 / statistics.median(v) for k, v in walls.items()}
        log(tag, f"{key} bf16 batch {TRAIN_BATCH} {RES[0]}x{RES[1]}, in turns (plain, DDP, "
                 f"DDP, plain; 6 steps each): plain {rate['plain']:.3f} steps/s, DDP "
                 f"{rate['ddp']:.3f} steps/s (DDP's step time "
                 f"{rate['plain'] / rate['ddp'] - 1:+.1%} against plain's; host clock around "
                 f"synced steps)")
        for name in KERNELS:
            want = 12 * PER_STEP[key].get(name, 0)
            if counts[name] != want:
                raise AssertionError(f"{name}: {counts[name]} launches, expected {want}")
        del states
        torch.cuda.empty_cache()
        return counts
    finally:
        dist.destroy_process_group()


# the classifiers' launches per forward and per backward (no SyncBlock, no
# decoder): MViTv2-S's 16 blocks, UniFormer-B's 27 SABlocks
CLS_FWD = {"mvitv2s": {"attention_rel": 16, "ln_mlp": 16},
           "uniformerb": {"self_attention": 27, "ln_mlp": 27}}
CLS_BWD = {"mvitv2s": {"attention_rel_bwd": 16, "ln_mlp_bwd": 16},
           "uniformerb": {"attention_bwd": 27, "ln_mlp_bwd": 27}}
CLS_CLIP = (16, 224, 224)
CLS_BATCH = 4
CLS_VIDEOS, CLS_FRAMES = 8, 40  # the synthetic Kinetics tree: 2 steps, 2 eval batches


def _cls_counts(name: str, steps: int, evals: int) -> dict:
    return {k: steps * (CLS_FWD[name].get(k, 0) + CLS_BWD[name].get(k, 0))
            + evals * CLS_FWD[name].get(k, 0) for k in KERNELS}


def _cls_model(name: str, device: str):
    from mspi_tpu_torch.models.video_zoo import build_classifier

    torch.manual_seed(0)
    return build_classifier(name, 400).to(device)


def _cls_batch(seed: int, batch: int, device: str):
    g = torch.Generator().manual_seed(seed)
    return {"clips": torch.randn(batch, *CLS_CLIP, 3, generator=g).to(device),
            "labels": torch.randint(400, (batch,), generator=g).to(device)}


def _sgd(params):
    from mspi_tpu_torch.train.optim import construct_optimizer

    return construct_optimizer(params, "sgd", base_lr=0.1, weight_decay=1e-4,
                               zero_wd_1d_param=False)


def phase_cls_training(tag: str, name: str) -> dict:
    """The video-classification path on the card: for mvitv2s,
    `run_classification_training` (the trainer of `python -m
    mspi_tpu_torch.run_net`) for one epoch of 2 steps and one evaluation of
    2 batches on a synthetic Kinetics frame tree written to a temporary
    directory (16x224x224 clips, batch 4, bf16, SGD with nesterov); then
    (both classifiers) 4 bf16 steps of `make_cls_train_step` on device
    batches of 4, their steps/s and peak memory. The launches: the
    classifier's kernels per step and per evaluation forward."""
    import functools
    import tempfile

    from PIL import Image

    from mspi_tpu_torch import run_net
    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.train.classification import (create_cls_state, make_cls_train_step,
                                                     run_classification_training)
    from mspi_tpu_torch.train.optim import lr_cosine

    kernels.reset_launch_counts()
    steps, evals = 0, 0
    if name == "mvitv2s":
        with tempfile.TemporaryDirectory() as root:
            rng = np.random.default_rng(7)
            lines = []
            for i in range(CLS_VIDEOS):
                d = f"{root}/vid{i}"
                os.makedirs(d)
                for f in range(CLS_FRAMES):
                    Image.fromarray(rng.integers(0, 256, (256, 320, 3), dtype=np.uint8)).save(
                        f"{d}/{f:05d}.jpg")
                lines.append(f"{d} {i % 4}")
            for split in ("train", "val"):
                with open(f"{root}/{split}.csv", "w") as fh:
                    fh.write("\n".join(lines) + "\n")
            messages = []
            t0 = time.perf_counter()
            _, history = run_classification_training(
                _cls_model(name, "cuda"), _sgd,
                functools.partial(run_net.make_dataset, root, 2), epochs=1,
                batch_size=CLS_BATCH, lr_policy=lr_cosine(0.1, 1e-6, 1), base_t=CLS_CLIP[0],
                base_crop=CLS_CLIP[1], label_smoothing=0.1, num_classes=400,
                log=messages.append, device="cuda", compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps, evals = CLS_VIDEOS // CLS_BATCH, CLS_VIDEOS // CLS_BATCH
        (h,) = history
        log(tag, f"{name} run_classification_training, 1 epoch on {CLS_VIDEOS} videos "
                 f"({steps} steps of {CLS_BATCH} at {CLS_CLIP}, bf16) and {evals} eval "
                 f"batches: {wall:.1f} s wall with the JPEG decode; {h}")
        if not (math.isfinite(h["loss"]) and "val_top1_err" in h):
            raise AssertionError(f"classification history {h}")
    model = _cls_model(name, "cuda")
    state = create_cls_state(model, _sgd)
    step = make_cls_train_step(label_smoothing=0.1, compute_dtype=torch.bfloat16)
    batch = _cls_batch(1, CLS_BATCH, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        loss, logits = step(state, batch, 0.01)  # the loss's read syncs
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
    steps += 4
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(walls[1:])
    log(tag, f"{name} classifier 4 steps bf16 batch {CLS_BATCH} {CLS_CLIP}: first "
             f"{walls[0]:.2f} s, then median {steady * 1e3:.1f} ms = {1 / steady:.3f} steps/s "
             f"= {CLS_BATCH / steady:.2f} clips/s (host clock around synced steps); peak "
             f"memory {peak:.2f} GiB; losses {[round(v, 4) for v in losses]}; launches {counts}")
    if not (all(math.isfinite(v) for v in losses) and logits.shape == (CLS_BATCH, 400)):
        raise AssertionError("non-finite classifier loss or wrong logits")
    want = _cls_counts(name, steps, evals)
    for k in KERNELS:
        if counts[k] != want[k]:
            raise AssertionError(f"{k}: {counts[k]} launches, expected {want[k]}")
    del model, state
    torch.cuda.empty_cache()
    return counts


def phase_cls_parity(tag: str, name: str) -> None:
    """One fp32 classification step (label smoothing 0.1, SGD with nesterov,
    batch 1, 16x224x224; the same generator seed, so the same drop-path and
    dropout masks) on the card against the CPU: the logits (max |diff| over
    max |logit| <= 1e-3), the loss (1e-3) and the gradients' cosine (need
    >= 0.9999)."""
    from mspi_tpu_torch.train.classification import create_cls_state, make_cls_train_step

    batch = _cls_batch(2, 1, "cpu")
    out = {}
    for device in ("cuda", "cpu"):
        model = _cls_model(name, device)
        state = create_cls_state(model, _sgd, seed=3)
        t0 = time.perf_counter()
        loss, logits = make_cls_train_step(label_smoothing=0.1)(
            state, {k: v.to(device) for k, v in batch.items()}, 0.1)
        out[device] = (loss, logits.cpu().double(), _named_grads(model))
        log(tag, f"{name} classifier fp32 step on {device}: {time.perf_counter() - t0:.1f} s, "
                 f"loss {loss:.6f}")
        del model, state
    (l_g, z_g, g_g), (l_c, z_c, g_c) = out["cuda"], out["cpu"]
    cos = _cosine(g_g, g_c)
    zerr = ((z_g - z_c).abs().max() / z_c.abs().max()).item()
    log(tag, f"{name} classifier card vs CPU: logits max |diff| {zerr:.2e} of their max, loss "
             f"|diff| {abs(l_g - l_c):.2e}, gradient cosine {cos:.8f}")
    if not (zerr <= 1e-3 and abs(l_g - l_c) <= 1e-3 and cos >= 0.9999):
        raise AssertionError("the classifier's card step differs from the CPU's")


def phase_spectrogram(tag: str, _) -> None:
    """spectrogram_torch on the card against the host stft_power, on the
    windows predict_video cuts from the synthetic waveform (len_snippet
    32): max error over each window's largest power, need <= 1e-4."""
    from mspi_tpu_torch.data.audio import spectrogram_torch, stft_power
    from mspi_tpu_torch.inference import sliding_window_jobs

    _, audio = synthetic_video(0)
    worst, shapes = 0.0, set()
    for s, _, _ in sliding_window_jobs(N_FRAMES, 16):
        start = int(np.round(s / FPS * SAMPLE_RATE))
        clip = audio[start:int(np.round((s + 33) / FPS * SAMPLE_RATE))]
        got = spectrogram_torch(torch.from_numpy(clip).cuda()).cpu().numpy()
        want = stft_power(clip)
        if got.shape != want.shape:
            raise AssertionError(f"spectrogram {got.shape}, host {want.shape}")
        shapes.add(got.shape)
        worst = max(worst, float(np.abs(got - want).max() / np.abs(want).max()))
    log(tag, f"spectrogram_torch (torch.stft on the card) vs host stft_power, "
             f"{len(sliding_window_jobs(N_FRAMES, 16))} windows {sorted(shapes)}: "
             f"max err / max power {worst:.3e} (need <= 1e-4)")
    if not worst <= 1e-4:
        raise AssertionError(f"spectrogram_torch off the host stft_power: {worst}")


def _step_grads(cfg, model, snapshot, batch, compute_dtype):
    """One step of `model` from the weights `snapshot`, the TrainState's
    seed 9: its gradients as one fp32 vector on the card."""
    from mspi_tpu_torch.train import engine

    model.load_state_dict(snapshot)
    state = engine.create_train_state(cfg, model, seed=9)
    engine.make_train_step(cfg.train.gamma, compute_dtype=compute_dtype)(state, batch,
                                                                         cfg.solver.lr)
    return torch.cat([p.grad.detach().float().flatten()
                      for p in engine.trainable_parameters(state)])


def phase_remat_training(tag: str, key: str) -> dict:
    """Phase 7 with remat; its peak memory against phase 7's, which must
    have run before it. Then one bf16 step's gradients with remat against
    three runs of the same step without it: within REMAT_SPREAD_FACTOR
    times the spread of those runs. A control holds the limit to its
    purpose: the same step through a checkpoint that does not restore the
    DropPath generators (its recompute draws fresh masks) must fall
    outside it."""
    from mspi_tpu_torch.models import mvit
    from mspi_tpu_torch.train import engine
    from mspi_tpu_torch.train.synthetic import make_batch

    counts = phase_training(tag, key)
    plain_key = key.split("+")[0]
    if plain_key not in PEAK_GIB:
        raise AssertionError("remat_training compares its peak memory with phase "
                             "training's: run training before it")
    log(tag, f"peak memory with remat {PEAK_GIB[key]:.2f} GiB, without "
             f"{PEAK_GIB[plain_key]:.2f} GiB (phase training, same batch and steps)")
    if not PEAK_GIB[key] < PEAK_GIB[plain_key]:
        raise AssertionError("remat did not lower the training step's peak memory")

    batch = engine.to_device(make_batch(np.random.default_rng(6), TRAIN_BATCH, 16, RES,
                                        SPECTRO), "cuda")
    plain = build_model(plain_key, "cuda", torch.float32)
    snapshot = {k: v.clone() for k, v in plain.state_dict().items()}
    runs = [_step_grads(model_config(plain_key), plain, snapshot, batch, torch.bfloat16)
            for _ in range(3)]
    del plain
    remat = build_model(key, "cuda", torch.float32)
    got = _step_grads(model_config(key), remat, snapshot, batch, torch.bfloat16)

    def bare_checkpoint(block, *args):
        return torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)

    restoring, mvit.checkpoint_block = mvit.checkpoint_block, bare_checkpoint
    try:
        bare = _step_grads(model_config(key), remat, snapshot, batch, torch.bfloat16)
    finally:
        mvit.checkpoint_block = restoring
    del remat

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    spread = max(rel(runs[i], runs[j]) for i, j in ((0, 1), (0, 2), (1, 2)))
    err = max(rel(got, r) for r in runs)
    control = min(rel(bare, r) for r in runs)
    limit = REMAT_SPREAD_FACTOR * spread + 1e-7
    log(tag, f"{key} bf16 step gradients ({got.numel()} values) vs without remat: "
             f"max relative L2 {err:.3e} over the 3 runs; their spread {spread:.3e}; "
             f"need <= {REMAT_SPREAD_FACTOR} x spread + 1e-7 = {limit:.3e}; control "
             f"(checkpoint without the generators' restore) min {control:.3e}, "
             f"need > {limit:.3e}")
    if not err <= limit:
        raise AssertionError(f"remat gradients off by {err}, spread {spread}")
    if not control > limit:
        raise AssertionError(f"the control without the generators' restore is {control} "
                             f"off, inside the limit {limit}: the check cannot see the fault")
    torch.cuda.empty_cache()
    return counts


# Entries the register-resident bodies must hold (mangled-name fragments):
# row 8's forward (kRelBiasRes = 3) in both rel forms, K4's (kNoBias = 0,
# D = 128), row 6's (kNoBias, score width 128, 144, 176, 192 or 256, value
# width 96),
# the bf16 window backward's three passes, the bf16 K1 backward's two
# passes in its three rel widths (RS = 2, 3, 4) and its wide form (R > 64),
# row 19 in both dtypes and tile widths, row 18's bf16 ring kernel in its
# two tiles (warp outputs OH x OW), row 21's wgmma GEMMs (int8 at 64 and
# 128 rows per block), the bf16 K4 backward's two passes at D = 96 and 128,
# the wgmma LN+MLP body at every C as K2 (LN), row 10 (LN, RES) and row 13,
# row 7 head-major's two bf16 passes at the five score widths (DK = 128,
# 144 and the wide 176, 192 and 256), the labs' MLP bodies at their widths,
# row 11's two forms, row 12's s8 wgmma body at its four widths in both
# x dtypes, and the bf16 K2 backward's row pass at every C as row 9 (LN)
# and row 14, and its wgmma products (dz = du W1; the weight gradients A^T
# B)
SM90_ENTRIES = ("flash_attention_sm90_kernelILi96ELi3ELi3ELi96E",
                "flash_attention_sm90_kernelILi96ELi0ELi3ELi96E",
                "flash_attention_sm90_kernelILi128ELi0ELi0ELi128E",
                # K4 at head dim 64 (UniFormer-B) and its backward's passes;
                # rows 6 and 7's wide form (Da > 256)
                "flash_attention_sm90_kernelILi64ELi0ELi0ELi64E",
                *(f"self_bwd_{p}_sm90_kernelILi64E" for p in ("dq", "dkv")),
                "flash_attention_aug_wide_sm90_kernelILi96E",
                "aug_bwd_dq_wide_sm90_kernel", "aug_bwd_dkv_wide_sm90_kernel",
                *(f"flash_attention_sm90_kernelILi{dk}ELi0ELi0ELi96E"
                  for dk in (128, 144, 176, 192, 256)),
                "window_bwd_dq_sm90_kernel",
                "window_bwd_dkv_sm90_kernel", "window_bwd_dbias_sm90_kernel",
                *(f"rel_bwd_{p}_sm90_kernelILi96ELi{rs}E" for p in ("dq", "dkv")
                  for rs in (2, 3, 4)),
                "rel_bwd_dq_wide_sm90_kernelILi96E", "rel_bwd_dkv_wide_sm90_kernelILi96E",
                *(f"dwconv2d_sm90_kernelI{t}Li{tw}E" for t in ("f", "13__nv_bfloat16")
                  for tw in (16, 32)),
                *(f"dwconv3d_sm90_kernelILi{oh}ELi{ow}E" for oh, ow in ((4, 8), (7, 6))),
                "gemm_bf16_sm90_kernel", "gemm_s8_sm90_kernelILi1E", "gemm_s8_sm90_kernelILi2E",
                *(f"self_bwd_{p}_sm90_kernelILi{d}E" for p in ("dq", "dkv") for d in (96, 128)),
                *(f"ln_mlp_sm90_kernelILi{c}ELi{ln}ELb1ELb1ELb{res}ELi0EE"
                  for c in (96, 192, 320, 384, 512, 768)
                  for ln, res in ((1, 0), (1, 1), (0, 0))),
                # the labs' bodies at K2's widths: <LN, GELU, BIAS, RES, PIPE>
                # of matmul, ln_matmul, pipe2, pipe4 (4 and 6 slices at C =
                # 96 and 192, pipe2's schedule above), mxu_stats and mlp_bf16
                # (matmul_gelu is row 13's)
                *(f"ln_mlp_sm90_kernelILi{c}ELi{ln}ELb{gelu}ELb{bias}ELb0ELi{pipe}EE"
                  for c in (96, 192, 384, 512, 768)
                  for ln, gelu, bias, pipe in ((0, 0, 1, 0), (2, 0, 1, 0), (2, 1, 1, 0),
                                               (2, 1, 1, {96: 4, 192: 6}.get(c, 0)),
                                               (3, 1, 1, 0), (0, 0, 0, 0))),
                # mlp_int8w
                *(f"ln_mlp_int8_sm90_kernelI13__nv_bfloat16Li{c}ELb1EE"
                  for c in (96, 256, 384, 512, 768)),
                *(f"aug_bwd_{p}_sm90_kernelILi{dk}E" for p in ("dq", "dkv")
                  for dk in (128, 144, 176, 192, 256)),
                # row 11 in both storage types, 16-byte and scalar forms
                *(f"layernorm_sm90_kernelI{t}Li{c}ELb{vec}EE" for t in ("f", "13__nv_bfloat16")
                  for c in (96, 192, 384, 768) for vec in (1, 0)),
                *(f"ln_mlp_int8_sm90_kernelI{t}Li{c}E" for t in ("f", "13__nv_bfloat16")
                  for c in (256, 384, 512, 768)),
                *(f"ln_mlp_bwd_rows_sm90_kernelILi{c}ELb{ln}E"
                  for c in (96, 192, 320, 384, 512, 768) for ln in (1, 0)),
                "wgemm_f32_sm90_kernelILb0E", "wgemm_f32_sm90_kernelILb1E")


# bodies that the sm90 ones replaced, by ptxas entry: none may be built again
RETIRED = {"flash_attention_tc_kernel": "WMMA flash body (row 6 runs the sm90 body)",
           "ln_mlp_tc_kernel": "WMMA LN+MLP (the labs run K2's wgmma body)",
           "mlp_int8_lab_kernel": "mma.sync int8 lab body (mlp_int8w runs row 12's)"}


# the self-supervised and masked paths: MViTv2-S at 16x224x224, its 16
# blocks' K1 and K2 per trunk forward, rows 5 and 9 per backward
SSL_CLIP = (16, 224, 224)
SSL_BATCH = 2  # clips per view
SSL_STEPS = 3  # per objective
# trunk forwards of one step: (online, momentum); the backward runs once per
# online forward
SSL_FORWARDS = {"moco": (1, 1), "byol": (2, 2), "simclr": (2, 0), "swav": (2, 0)}
MASK_GRID = (8, 14, 14)  # the HOG target's token grid at 16x224x224
MASKED_STEPS = 3
HOG_TOL = 1e-5  # fp32 HOG targets (unit-norm cells), card vs CPU


def _trunk_counts(forwards: int, backwards: int) -> dict:
    return {k: forwards * CLS_FWD["mvitv2s"].get(k, 0) + backwards * CLS_BWD["mvitv2s"].get(k, 0)
            for k in KERNELS}


def _ssl_model(objective: str, device: str):
    """The ContrastiveNet of `run_net --task ssl --model mvitv2s`, built on
    the CPU from seed 0 (so every device gets the same weights)."""
    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.models.registry import build_backbone
    from mspi_tpu_torch.train.ssl import ContrastiveNet

    cfg = get_config("mvitv2s")
    torch.manual_seed(0)
    return ContrastiveNet(build_backbone(cfg), dim_in=cfg.model.embed_dims[-1],
                          use_predictor=objective in ("moco", "byol"),
                          num_prototypes=300 if objective == "swav" else 0).to(device)


def _views(seed: int, batch: int, device: str) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(batch, *SSL_CLIP, 3, generator=g).to(device)
            for k in ("clips1", "clips2")}


def phase_ssl_training(tag: str, _) -> dict:
    """`run_net --task ssl`'s step on the card: for each objective a
    ContrastiveNet on the mvitv2s trunk (dim_in 768; moco with its 4096-entry
    queue, swav with 300 prototypes), SSL_STEPS bf16 steps of SSL_BATCH clips
    per view with SGD; after the last step the momentum tree must equal m t
    + (1 - m) o (t before the step, o the updated online tensors), the queue
    pointer must have advanced by the batch over unit-norm keys, and the
    prototypes must have unit norm. The launches: K1 and K2 per trunk
    forward (the momentum net's too), rows 5 and 9 per online forward."""
    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.train.ssl import OBJECTIVES, create_ssl_state, make_ssl_train_step

    batch = _views(21, SSL_BATCH, "cuda")
    mom = 0.99
    want = {k: 0 for k in KERNELS}
    kernels.reset_launch_counts()
    for objective in OBJECTIVES:
        state = create_ssl_state(_ssl_model(objective, "cuda"), _sgd,
                                 queue_size=4096 if objective == "moco" else 0)
        step = make_ssl_train_step(objective, compute_dtype=torch.bfloat16)
        walls, losses = [], []
        for _ in range(SSL_STEPS):
            target = [p.detach().clone() for p in state.momentum_model.parameters()]
            ptr = state.queue_ptr
            t0 = time.perf_counter()
            losses.append(step(state, batch, 0.01, mom))  # the loss's read syncs
            walls.append(time.perf_counter() - t0)
        online, model = list(state.model.parameters()), state.model
        checks = []
        if objective in ("moco", "byol"):
            err = max((m - (mom * t + (1.0 - mom) * o)).abs().max().item()
                      for t, m, o in zip(target, state.momentum_model.parameters(), online))
            checks.append(f"momentum tree vs m t + (1 - m) o: max |diff| {err:.2e}")
            if err != 0.0:
                raise AssertionError(f"{objective}: the momentum tree is {err} off its EMA")
        if objective == "moco":
            rows = state.queue[ptr:ptr + SSL_BATCH].norm(dim=-1)
            checks.append(f"queue pointer {ptr} -> {state.queue_ptr}, new keys' norms "
                          f"{[round(v, 6) for v in rows.tolist()]}")
            if state.queue_ptr != (ptr + SSL_BATCH) % 4096 or (rows - 1).abs().max() > 1e-5:
                raise AssertionError("the MoCo queue did not take the batch's unit keys")
        if objective == "swav":
            norms = model.prototypes.norm(dim=-1)
            checks.append(f"prototype norms {norms.min().item():.7f}..{norms.max().item():.7f}")
            if (norms - 1).abs().max() > 1e-5:
                raise AssertionError("the SwAV prototypes left the unit sphere")
        steady = statistics.median(walls[1:])
        log(tag, f"{objective}: {SSL_STEPS} steps bf16 batch {SSL_BATCH} per view {SSL_CLIP}: "
                 f"first {walls[0]:.2f} s, then median {steady * 1e3:.1f} ms = "
                 f"{1 / steady:.3f} steps/s (host clock around synced steps); losses "
                 f"{[round(v, 4) for v in losses]}; " + "; ".join(checks))
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{objective}: non-finite loss")
        on, mo = SSL_FORWARDS[objective]
        for k, v in _trunk_counts(SSL_STEPS * (on + mo), SSL_STEPS * on).items():
            want[k] += v
        del state, model, online, target
        torch.cuda.empty_cache()
    counts = dict(kernels.launches)
    log(tag, f"launches {counts}")
    for k in KERNELS:
        if counts[k] != want[k]:
            raise AssertionError(f"{k}: {counts[k]} launches, expected {want[k]}")
    return counts


def phase_ssl_parity(tag: str, _) -> None:
    """One fp32 MoCo step (TF32 off; one clip per view, the same weights,
    queue and drop-path seed) on the card against the CPU: the loss (1e-3),
    the gradients' cosine (need >= 0.9999) and the keys the queue took
    (max |diff| <= 1e-4, unit vectors)."""
    from mspi_tpu_torch.train.ssl import create_ssl_state, make_ssl_train_step

    batch = _views(22, 1, "cpu")
    out = {}
    for device in ("cuda", "cpu"):
        state = create_ssl_state(_ssl_model("moco", device), _sgd, queue_size=4096, seed=3)
        t0 = time.perf_counter()
        loss = make_ssl_train_step("moco")(state, {k: v.to(device) for k, v in batch.items()},
                                           0.01, 0.99)
        out[device] = (loss, _named_grads(state.model), state.queue[:1].cpu().double())
        log(tag, f"moco fp32 step on {device}: {time.perf_counter() - t0:.1f} s, loss {loss:.6f}")
        del state
    (l_g, g_g, q_g), (l_c, g_c, q_c) = out["cuda"], out["cpu"]
    cos, qerr = _cosine(g_g, g_c), (q_g - q_c).abs().max().item()
    log(tag, f"moco card vs CPU: loss |diff| {abs(l_g - l_c):.2e}, gradient cosine {cos:.8f}, "
             f"queue keys max |diff| {qerr:.2e}")
    if not (abs(l_g - l_c) <= 1e-3 * max(1.0, abs(l_c)) and cos >= 0.9999 and qerr <= 1e-4):
        raise AssertionError("the MoCo step on the card differs from the CPU's")


def _masked_model(device: str):
    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.models.masked import MaskedMViT

    torch.manual_seed(0)
    return MaskedMViT(get_config("mvitv2s").model.mvit, target="hog").to(device)


def _adamw(model):
    from mspi_tpu_torch.train.optim import construct_optimizer

    return construct_optimizer(list(model.named_parameters()), "adamw", base_lr=1e-4,
                               weight_decay=0.05, zero_wd_1d_param=False)


def phase_masked_training(tag: str, _) -> dict:
    """`run_net --task masked`'s step on the card: MaskedMViT (HOG target,
    token grid MASK_GRID) on MViTv2-S, MASKED_STEPS bf16 AdamW steps of
    SSL_BATCH clips at 16x224x224, each on a fresh 40% mask drawn on the
    card; finite losses, steps/s, peak memory, and K1 / K2 per forward and
    rows 5 / 9 per backward."""
    from mspi_tpu_torch.models.masked import random_patch_mask
    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.run_net import masked_train_step

    model = _masked_model("cuda")
    opt = _adamw(model)
    clips = _views(23, SSL_BATCH, "cuda")["clips1"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, losses, fracs = [], [], []
    for _ in range(MASKED_STEPS):
        t0 = time.perf_counter()
        mask = random_patch_mask(gen, SSL_BATCH, MASK_GRID)
        losses.append(masked_train_step(model, opt, clips, mask, False,
                                        compute_dtype=torch.bfloat16))  # the read syncs
        walls.append(time.perf_counter() - t0)
        fracs.append(mask.float().mean().item())
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(walls[1:])
    log(tag, f"MaskedMViT hog {MASKED_STEPS} steps bf16 batch {SSL_BATCH} {SSL_CLIP}: first "
             f"{walls[0]:.2f} s, then median {steady * 1e3:.1f} ms = {1 / steady:.3f} steps/s "
             f"(host clock around synced steps); peak memory {peak:.2f} GiB; losses "
             f"{[round(v, 5) for v in losses]}; masked share {fracs}; launches {counts}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite masked loss")
    want = _trunk_counts(MASKED_STEPS, MASKED_STEPS)
    for k in KERNELS:
        if counts[k] != want[k]:
            raise AssertionError(f"{k}: {counts[k]} launches, expected {want[k]}")
    del model, opt
    torch.cuda.empty_cache()
    return counts


def phase_masked_parity(tag: str, _) -> None:
    """One fp32 MaskFeat step (HOG target, TF32 off, one clip) on the card
    against the CPU on the same mask: the loss (1e-3 relative), the
    gradients' cosine (need >= 0.9999) and the HOG targets (max |diff| <=
    HOG_TOL)."""
    from mspi_tpu_torch.models.masked import hog_targets, random_patch_mask
    from mspi_tpu_torch.run_net import masked_train_step

    clips = _views(24, 1, "cpu")["clips1"]
    mask = random_patch_mask(torch.Generator().manual_seed(4), 1, MASK_GRID)
    out = {}
    for device in ("cuda", "cpu"):
        model = _masked_model(device)
        t0 = time.perf_counter()
        loss = masked_train_step(model, _adamw(model), clips.to(device), mask.to(device), False)
        out[device] = (loss, _named_grads(model), hog_targets(clips.to(device)).cpu())
        log(tag, f"masked fp32 step on {device}: {time.perf_counter() - t0:.1f} s, "
                 f"loss {loss:.6f}")
        del model
    (l_g, g_g, h_g), (l_c, g_c, h_c) = out["cuda"], out["cpu"]
    cos = _cosine(g_g, g_c)
    herr = (h_g - h_c).abs()
    log(tag, f"masked card vs CPU: loss |diff| {abs(l_g - l_c):.2e}, gradient cosine "
             f"{cos:.8f}; HOG targets max |diff| {herr.max().item():.2e}, "
             f"{int((herr > 1e-4).sum())} of {herr.numel()} off by more than 1e-4")
    if not (abs(l_g - l_c) <= 1e-3 * max(1.0, abs(l_c)) and cos >= 0.9999):
        raise AssertionError("the masked step on the card differs from the CPU's")
    if not herr.max().item() <= HOG_TOL:
        raise AssertionError("the HOG targets on the card differ from the CPU's")


REV_TOL = 1e-3  # relative L2 of each gradient, fp32, reversible vs plain


def phase_rev_training(tag: str, _) -> dict:
    """ReversibleMViTFeatures on the mvitv2s config (depth 16), batch 2 at
    16x224x224, fp32 (TF32 off): one forward (K1 in each of the 16 blocks,
    output [2, 1536]); then over its longest span of reversible blocks
    (stage 3, 10 blocks at C 384), from the forward's activations there,
    the loss mean(y1^2) + mean(y2) / 2 through `reversible_sequence` and
    through plain autograd: every gradient (inputs and the span's
    parameters) within REV_TOL of its norm in L2 (or, for norm_k's bias,
    whose gradient is 0 in exact arithmetic, within 1e-6 of the largest
    gradient's norm) and the peak memory of the
    reversible run below the plain one's; inside the custom backward K1
    recomputes each block's F and row 5 differentiates it."""
    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.models.reversible_mvit import ReversibleMViTFeatures, reversible_sequence
    from mspi_tpu_torch.ops import kernels

    torch.manual_seed(0)
    model = ReversibleMViTFeatures(get_config("mvitv2s").model.mvit).cuda()
    clips = _views(25, SSL_BATCH, "cuda")["clips1"]
    kernels.reset_launch_counts()
    with torch.no_grad():
        feats = model(clips)
        x, thw = model.patch_embed(clips)
        runs, start = [], 0
        for i, kind in enumerate(model.kinds + ("end",)):
            if kind != "rev":
                runs.append((start, i))
                start = i + 1
        lo, hi = max(runs, key=lambda r: r[1] - r[0])
        x1 = x2 = x
        for blk, kind in zip(model.blocks[:lo], model.kinds[:lo]):
            x1, x2, *rest = blk(x1, x2, thw)
            thw = rest[0] if rest else thw
    log(tag, f"forward {tuple(feats.shape)}, finite {bool(torch.isfinite(feats).all())}; "
             f"longest reversible span blocks {lo}-{hi - 1} at {tuple(x1.shape)} thw {thw}")
    if feats.shape != (SSL_BATCH, 1536) or not torch.isfinite(feats).all():
        raise AssertionError("the reversible encoder's output is wrong")
    span = list(model.blocks[lo:hi])
    params = {f"blocks.{lo + j}.{name}": p for j, blk in enumerate(span)
              for name, p in blk.named_parameters()}

    def run(reversible: bool):
        a, b = (t.detach().clone().requires_grad_(True) for t in (x1, x2))
        for p in params.values():
            p.grad = None
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = dict(kernels.launches)
        if reversible:
            y1, y2 = reversible_sequence(span, a, b, thw)
        else:
            y1, y2 = a, b
            for blk in span:
                y1, y2 = blk(y1, y2, thw)
        fwd = {k: kernels.launches[k] - before[k] for k in KERNELS}
        loss = (y1 ** 2).mean() + y2.mean() * 0.5
        mid = dict(kernels.launches)
        loss.backward()
        torch.cuda.synchronize()
        bwd = {k: kernels.launches[k] - mid[k] for k in KERNELS}
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        grads = {"x1": a.grad, "x2": b.grad, **{k: p.grad for k, p in params.items()}}
        return loss.item(), {k: v.detach().double().flatten().cpu() for k, v in grads.items()}, \
            peak, fwd, bwd

    l_p, g_p, peak_p, fwd_p, bwd_p = run(False)
    l_r, g_r, peak_r, fwd_r, bwd_r = run(True)
    # a gradient that is 0 in exact arithmetic (norm_k's bias: q.b shifts every
    # score of a row alike, which the softmax drops) is rounding noise on both
    # sides, measured against 1e-6 of the largest gradient's norm
    floor = 1e-6 * max(g.norm().item() for g in g_p.values())
    # each gradient's distance over its limit, REV_TOL of its norm or the floor
    over = {k: (g_r[k] - g_p[k]).norm().item() / max(REV_TOL * g_p[k].norm().item(), floor)
            for k in g_p}
    worst = max(over, key=over.get)
    rel = max(((g_r[k] - g_p[k]).norm() / g_p[k].norm()).item() for k in g_p
              if g_p[k].norm().item() > floor)
    n = hi - lo
    log(tag, f"span of {n} blocks, batch {SSL_BATCH}, fp32: loss plain {l_p:.7f} reversible "
             f"{l_r:.7f}; gradients' relative L2 max {rel:.2e} (above the floor), the "
             f"largest share of its limit {over[worst]:.3f} ({worst}), cosine "
             f"{_cosine(g_r, g_p):.9f}; peak memory above the inputs plain {peak_p:.1f} MiB, "
             f"reversible {peak_r:.1f} MiB ({peak_r / peak_p:.3f} x); launches plain forward "
             f"{_nonzero(fwd_p)} backward {_nonzero(bwd_p)}, reversible forward "
             f"{_nonzero(fwd_r)} backward {_nonzero(bwd_r)}")
    if not (abs(l_r - l_p) <= 1e-5 * abs(l_p) and over[worst] <= 1.0):
        raise AssertionError("reversible gradients differ from plain autograd's")
    if not peak_r < peak_p:
        raise AssertionError("the reversible span's peak memory is not below plain autograd's")
    want_bwd = {k: n if k in ("attention_rel", "attention_rel_bwd") else 0 for k in KERNELS}
    if fwd_r != {k: n if k == "attention_rel" else 0 for k in KERNELS} or bwd_r != want_bwd:
        raise AssertionError("the custom backward did not run K1 and row 5 once per block")
    counts = dict(kernels.launches)
    want = {k: 0 for k in KERNELS}
    want["attention_rel"] = 16 + lo + 3 * n
    want["attention_rel_bwd"] = 2 * n
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")
    del model, span, params
    torch.cuda.empty_cache()
    return counts


# AVA detection: VideoDetector on the MViTv2-S trunk, the ROI head on tap 2
# (block 13's output, stride 16, 384 channels), batches from AvaDataset over
# a synthetic AVA tree. Blocks 14-15 feed nothing: their forward runs (K1
# and K2 in all 16 blocks) but autograd skips their backward (rows 5 and 9
# in blocks 0-13)
DET_CLIP = (16, 224, 224)
DET_BATCH, DET_STEPS, DET_MAX_BOXES, DET_CLASSES, DET_POOL = 2, 5, 16, 80, 7
DET_FWD = {"attention_rel": 16, "ln_mlp": 16}
DET_BWD = {"attention_rel_bwd": 14, "ln_mlp_bwd": 14}
DET_PARITY_RES = (64, 96)
DEMO_FRAMES, DEMO_BATCH = 24, 4  # 9 clips of 16 frames: 3 forwards of the s3d model
GRADCAM_CLIP = (16, 224, 224)
CARD = "card not read"  # nvidia-smi's name and power limit, set by main, on each figure's line


def _det_counts(steps: int, evals: int) -> dict:
    return {k: steps * (DET_FWD.get(k, 0) + DET_BWD.get(k, 0)) + evals * DET_FWD.get(k, 0)
            for k in KERNELS}


def _detector(device: str):
    """The VideoDetector of the flagship's MViTv2-S trunk (seed 0), 80
    classes, pool 7, head dropout 0.5."""
    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.models.registry import build_backbone
    from mspi_tpu_torch.train.detection import VideoDetector

    cfg = get_config("mvitv2s")
    torch.manual_seed(0)
    return VideoDetector(build_backbone(cfg), dim_in=cfg.model.embed_dims[2],
                         num_classes=DET_CLASSES, pool_size=DET_POOL).to(device)


def _ava_tree(root: str, size=(240, 320), boxes_per_frame: int = 6) -> dict:
    """tests/test_ava_pipeline.py's synthetic AVA tree at `size`: 2 videos
    of 150 JPEG frames, frame lists, and `boxes_per_frame` GT boxes (1-3
    labels each) at seconds 902 and 904 of vidA and 904 of vidB."""
    import cv2

    rng = np.random.default_rng(9)
    lines = ["original_vido_id video_id frame_id path labels\n"]
    gt = []
    for vi, vid in enumerate(("vidA", "vidB")):
        os.makedirs(f"{root}/frames/{vid}")
        for i in range(150):
            path = f"{vid}/{vid}_{i:06d}.jpg"
            cv2.imwrite(f"{root}/frames/{path}",
                        rng.integers(0, 256, (*size, 3), dtype=np.uint8))
            lines.append(f'{vid} {vi} {i} {path} ""\n')
        for sec in ((902, 904) if vid == "vidA" else (904,)):
            for _ in range(boxes_per_frame):
                x0, y0 = rng.uniform(0.0, 0.6, 2)
                x1, y1 = x0 + rng.uniform(0.1, 0.4), y0 + rng.uniform(0.1, 0.4)
                for label in rng.choice(np.arange(1, 81), rng.integers(1, 4), replace=False):
                    gt.append(f"{vid},{sec},{x0:.3f},{y0:.3f},{x1:.3f},{y1:.3f},{label}\n")
    os.makedirs(f"{root}/frame_lists")
    os.makedirs(f"{root}/annotations")
    for split in ("train", "val"):
        with open(f"{root}/frame_lists/{split}.csv", "w") as fh:
            fh.write("".join(lines))
    with open(f"{root}/annotations/gt.csv", "w") as fh:
        fh.write("".join(gt))
    return dict(frame_list_dir=f"{root}/frame_lists", frame_dir=f"{root}/frames",
                annotation_dir=f"{root}/annotations")


def _det_batches(ds, n: int, device: str):
    """n batches of DET_BATCH samples, cycling over the dataset, as tensors
    on `device`."""
    out = []
    for b in range(n):
        items = [ds[(b * DET_BATCH + i) % len(ds)] for i in range(DET_BATCH)]
        out.append({k: torch.from_numpy(np.stack([it[k] for it in items])).to(device)
                    for k in items[0]})
    return out


def phase_det_training(tag: str, _) -> dict:
    """AVA detection on the card: `VideoDetector` on the MViTv2-S trunk at
    full width and depth (`_detector`), DET_STEPS bf16 AdamW steps (weight
    decay 0.05) of DET_BATCH clips at DET_CLIP with DET_MAX_BOXES padded
    boxes, the batches from the port's `AvaDataset` over a synthetic AVA
    tree in a temporary directory (train split: scale jitter, crop, flip);
    the losses finite, and blocks 14-15, which feed nothing, moved by the
    weight decay alone; then `run_ava_eval` (bf16) on the dataset's three
    keyframes, its mAP in [0, 1]. The launches: K1 and K2 per forward
    (DET_FWD), rows 5 and 9 per backward (DET_BWD)."""
    import tempfile

    from mspi_tpu_torch.data.ava import AvaDataset
    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.train.detection import (create_det_state, make_det_eval_step,
                                                make_det_train_step, run_ava_eval)

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ds = AvaDataset(split="train", train_lists=("train.csv",),
                        train_gt_box_lists=("gt.csv",), num_frames=DET_CLIP[0],
                        crop_size=DET_CLIP[1], max_boxes=DET_MAX_BOXES,
                        num_classes=DET_CLASSES, **_ava_tree(root))
        batches = _det_batches(ds, DET_STEPS, "cuda")
        eval_batches = _det_batches(ds, -(-len(ds) // DET_BATCH), "cuda")
        log(tag, f"AvaDataset: {len(ds)} keyframes, {DET_STEPS + len(eval_batches)} batches "
                 f"decoded in {time.perf_counter() - t0:.1f} s; real boxes per batch "
                 f"{[int(b['box_mask'].sum()) for b in batches]}")
    model = _detector("cuda")
    unused = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith(("trunk.blocks.14.", "trunk.blocks.15."))}
    state = create_det_state(model, lambda p: torch.optim.AdamW(
        [t for _, t in p], lr=1e-4, weight_decay=0.05))
    step = make_det_train_step(compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    walls, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(step(state, batch, 1e-4))  # the loss's read syncs
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    stats = run_ava_eval(state, make_det_eval_step(torch.bfloat16), eval_batches,
                         num_classes=DET_CLASSES)
    eval_wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(walls[1:])
    decayed = {n: bool(torch.allclose(p, unused[n] * (1 - 1e-4 * 0.05) ** DET_STEPS,
                                      rtol=1e-6, atol=1e-9))
               for n, p in model.named_parameters() if n in unused}
    log(tag, f"VideoDetector mvitv2s {DET_STEPS} steps bf16 batch {DET_BATCH} {DET_CLIP}, "
             f"{DET_MAX_BOXES} boxes a clip: first {walls[0]:.2f} s, then median "
             f"{steady * 1e3:.1f} ms = {1 / steady:.3f} steps/s (host clock around synced "
             f"steps); peak memory {peak:.2f} GiB; losses {[round(v, 5) for v in losses]}; "
             f"run_ava_eval over {len(eval_batches)} batches {eval_wall:.2f} s: {stats}; "
             f"blocks 14-15 moved by the decay alone: {sum(decayed.values())} of "
             f"{len(decayed)} tensors; launches {counts}; {CARD}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("non-finite detection loss")
    if not (0.0 <= stats["mAP"] <= 1.0 and stats["num_classes_evaluated"] > 0):
        raise AssertionError(f"AVA eval {stats}")
    if not all(decayed.values()):
        raise AssertionError("the unused blocks 14-15 did not take AdamW's weight decay alone")
    want = _det_counts(DET_STEPS, len(eval_batches))
    for k in KERNELS:
        if counts[k] != want[k]:
            raise AssertionError(f"{k}: {counts[k]} launches, expected {want[k]}")
    del model, state
    torch.cuda.empty_cache()
    return counts


def phase_det_parity(tag: str, _) -> None:
    """The detector (`_detector`, head dropout drawn from the same seed)
    at DET_PARITY_RES in fp32 (TF32 off), card against CPU on one batch of
    2 clips with 16 boxes each (4 real): the eval probabilities (max |diff|
    <= 1e-4), then one AdamW step's loss (1e-4 relative) and gradients'
    cosine (need >= 0.9999)."""
    from mspi_tpu_torch.train.detection import (create_det_state, make_det_eval_step,
                                                make_det_train_step)

    g = torch.Generator().manual_seed(31)
    h, w = DET_PARITY_RES
    boxes = torch.zeros(DET_BATCH, DET_MAX_BOXES, 4)
    xy = torch.rand(DET_BATCH, 4, 2, generator=g) * torch.tensor([w * 0.6, h * 0.6])
    wh = torch.rand(DET_BATCH, 4, 2, generator=g) * torch.tensor([w * 0.4, h * 0.4]) + 4
    boxes[:, :4] = torch.cat([xy, xy + wh], -1)
    mask = torch.zeros(DET_BATCH, DET_MAX_BOXES, dtype=torch.bool)
    mask[:, :4] = True
    batch = {"clips": torch.randn(DET_BATCH, DET_CLIP[0], h, w, 3, generator=g),
             "boxes": boxes, "box_mask": mask,
             "labels": (torch.rand(DET_BATCH, DET_MAX_BOXES, DET_CLASSES, generator=g) < 0.05)
             .int() * mask[..., None]}
    out = {}
    for device in ("cuda", "cpu"):
        state = create_det_state(_detector(device), lambda p: torch.optim.AdamW(
            [t for _, t in p], lr=1e-4, weight_decay=0.05), seed=3)
        b = {k: v.to(device) for k, v in batch.items()}
        t0 = time.perf_counter()
        probs = make_det_eval_step()(state, b).cpu().double()
        loss = make_det_train_step()(state, b, 1e-4)
        out[device] = (probs, loss, _named_grads(state.model))
        log(tag, f"detector fp32 at {h}x{w} on {device}: eval + step "
                 f"{time.perf_counter() - t0:.1f} s, loss {loss:.6f}; {CARD}")
        del state
    (p_g, l_g, g_g), (p_c, l_c, g_c) = out["cuda"], out["cpu"]
    perr, cos = (p_g - p_c).abs().max().item(), _cosine(g_g, g_c)
    log(tag, f"detector card vs CPU: probabilities max |diff| {perr:.2e}, loss |diff| "
             f"{abs(l_g - l_c):.2e}, gradient cosine {cos:.8f}")
    if not (perr <= 1e-4 and abs(l_g - l_c) <= 1e-4 * abs(l_c) and cos >= 0.9999):
        raise AssertionError("the detector on the card differs from the CPU's")


def _write_jpegs(root: str, n: int, size, seed: int) -> None:
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    base = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
    for i in range(n):  # a drifting image, so that the clips differ
        cv2.imwrite(f"{root}/img_{i + 1:05d}.jpg", np.roll(base, 3 * i, axis=1))


def phase_demo_main(tag: str, _) -> dict:
    """`python -m mspi_tpu_torch.tools.demo_net`'s main on the card:
    DEMO_FRAMES synthetic JPEG frames at the s3d config's 224x384,
    `--batch DEMO_BATCH --bf16`, silent audio: one `sal_{idx:05d}.png` per
    16-frame clip (9), and every map the AsyncDemo pipeline wrote equal to
    the port's direct bf16 forward of the same clip (the same weights, seed
    0, in the same batches). The launches: K2, K3 and K4 per forward of the
    s3d model (PER_FORWARD["s3d"])."""
    import tempfile

    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.tools import demo_net
    from mspi_tpu_torch.utils.demo import FrameDirSource

    maps = []
    build = demo_net.build_predictor

    def recording(*args, **kwargs):  # keeps each map the pipeline predicts
        model, predict = build(*args, **kwargs)

        def predict_and_keep(clips):
            out = predict(clips)
            maps.extend(out)
            return out
        return model, predict_and_keep

    with tempfile.TemporaryDirectory() as root:
        _write_jpegs(f"{root}/frames", DEMO_FRAMES, RES, 12)
        demo_net.build_predictor = recording
        try:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            demo_net.main(["--frames", f"{root}/frames", "--out", f"{root}/out", "--batch",
                           str(DEMO_BATCH), "--bf16"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(kernels.launches)
        finally:
            demo_net.build_predictor = build
        written = sorted(os.listdir(f"{root}/out"))
        source = FrameDirSource(f"{root}/frames", 16, RES)
        clips = np.stack([c for _, c in source])
        idxs = [i for i, _ in source]
    n = DEMO_FRAMES - 16 + 1
    forwards = -(-n // DEMO_BATCH)
    _, predict = build(get_config("s3d"), DEMO_BATCH, torch.device("cuda"), torch.bfloat16)
    direct = np.concatenate([predict(clips[i:i + DEMO_BATCH])
                             for i in range(0, n, DEMO_BATCH)])
    err = max(float(np.abs(a - b).max()) for a, b in zip(maps, direct))
    log(tag, f"demo_net.main s3d bf16 on {DEMO_FRAMES} frames at {RES[0]}x{RES[1]}, batch "
             f"{DEMO_BATCH}: {n} maps in {forwards} forwards, {wall:.2f} s wall with the model "
             f"build and JPEG decode; files {written[0]}..{written[-1]} ({len(written)}); the "
             f"pipeline's maps against the direct bf16 forward: max |diff| {err:.3e}; "
             f"launches {counts}; {CARD}")
    if written != [f"sal_{i:05d}.png" for i in idxs] or len(written) != n:
        raise AssertionError(f"demo wrote {written}")
    if len(maps) != n or err != 0.0 or not np.isfinite(direct).all():
        raise AssertionError("the demo's maps differ from the direct forward's")
    for k in KERNELS:
        want = forwards * PER_FORWARD["s3d"].get(k, 0)
        if counts[k] != want:
            raise AssertionError(f"{k}: {counts[k]} launches, expected {want}")
    torch.cuda.empty_cache()
    return counts


def phase_gradcam_main(tag: str, _) -> dict:
    """`python -m mspi_tpu_torch.tools.visualize --model mvitv2s`'s main on
    the card: 16 synthetic JPEG frames at 224x224, the MViTv2-S classifier
    (400 classes, seed 0) in fp32, Grad-CAM of the last level (the head
    differentiated alone): 8 CAM frames [8, 7, 7], finite, in [0, 1], and
    8 PNG files. The launches: K1 and K2 in the trunk's 16 blocks, once."""
    import tempfile

    from mspi_tpu_torch.ops import kernels
    from mspi_tpu_torch.tools import visualize

    with tempfile.TemporaryDirectory() as root:
        _write_jpegs(f"{root}/frames", GRADCAM_CLIP[0], GRADCAM_CLIP[1:], 13)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        cams, scores = visualize.main(["--model", "mvitv2s", "--frames", f"{root}/frames",
                                       "--out", f"{root}/cams", "--num_frames",
                                       str(GRADCAM_CLIP[0]), "--crop_size",
                                       str(GRADCAM_CLIP[1])])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)
        written = sorted(os.listdir(f"{root}/cams"))
    log(tag, f"visualize.main mvitv2s fp32 {GRADCAM_CLIP}: CAMs {cams.shape} in "
             f"[{cams.min():.4f}, {cams.max():.4f}], {len(written)} files, {wall:.2f} s wall "
             f"with the model build; launches {counts}; {CARD}")
    if cams.shape != (8, 7, 7) or not np.isfinite(cams).all() or cams.min() < 0 \
            or cams.max() > 1 or len(written) != 8 or not np.isfinite(scores).all():
        raise AssertionError("Grad-CAM output is wrong")
    for k in KERNELS:
        want = DET_FWD.get(k, 0)
        if counts[k] != want:
            raise AssertionError(f"{k}: {counts[k]} launches, expected {want}")
    torch.cuda.empty_cache()
    return counts


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def check_ptxas() -> None:
    """The register-resident bodies (the sm90 flash forward of K1, K4, rows
    8 and 15, the bf16 window, K1 and K4 backwards' passes, rows 18 and 19,
    the wgmma GEMMs and the wgmma LN+MLP): each instantiation's registers
    and spills as ptxas
    reported them; a spill fails the run, and so does a missing entry of
    SM90_ENTRIES or any instantiation of a retired body (`RETIRED`)."""
    from mspi_tpu_torch.ops import kernels

    report = kernels.ptxas_report("sm90_kernel")
    missing = [e for e in SM90_ENTRIES if not any(e in name for name in report)]
    if missing:
        raise AssertionError(f"no ptxas entry for {missing}")
    for entry, (regs, st, ld) in sorted(report.items()):
        log("build", f"ptxas {entry}: {regs} registers, spill stores {st} B, loads {ld} B")
    spills = [entry for entry, (_, st, ld) in report.items() if st or ld]
    if spills:
        raise AssertionError(f"{sorted(spills)} spill registers")
    for key, what in RETIRED.items():
        found = sorted(kernels.ptxas_report(key))
        if found:
            raise AssertionError(f"the retired {what} is instantiated: {found}")


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {PHASES}")
    args = parser.parse_args()
    t_start = time.perf_counter()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this test "
                         "needs an NVIDIA GPU")
    from mspi_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log("device", f"{kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)
    global CARD
    CARD = smi

    seconds = kernels.build()
    kernels.lib()
    log("build", f"nvcc sm_90a build of {len(list(kernels.CSRC_DIR.glob('*.cu')))} sources "
                 f"in {seconds:.1f} s -> {kernels.LIB_PATH.name}")
    check_ptxas()

    records = {name: new_record() for name in KERNELS}
    counts = {name: 0 for name in KERNELS}
    runners = {"main": phase_main_path, "parity": phase_parity, "training": phase_training,
               "train_parity": phase_train_parity, "options_parity": phase_options_parity,
               "spectrogram": phase_spectrogram, "remat_training": phase_remat_training,
               "ddp_training": phase_ddp_training, "cls_training": phase_cls_training,
               "cls_parity": phase_cls_parity, "ssl_training": phase_ssl_training,
               "ssl_parity": phase_ssl_parity, "masked_training": phase_masked_training,
               "masked_parity": phase_masked_parity, "rev_training": phase_rev_training,
               "det_training": phase_det_training, "det_parity": phase_det_parity,
               "demo_main": phase_demo_main, "gradcam_main": phase_gradcam_main}
    kernel_phases = {"kernels": phase_kernels, "backward": phase_backward,
                     "layout_kernels": phase_layout_kernels,
                     "layout_backward": phase_layout_backward}
    kernel_paths = {"mlp_kernels": phase_mlp_kernels, "lab": phase_lab}  # checks, then a path
    for phase in PHASES:
        if phase not in phases:
            continue
        t_phase = time.perf_counter()
        if phase in kernel_phases:
            kernel_phases[phase](records)
        elif phase in kernel_paths:
            path_counts = kernel_paths[phase](records)
            counts = {k: counts[k] + path_counts[k] for k in KERNELS}
        else:
            path_kind, encoder, *res = PATH_PHASES[phase]
            path_counts = runners[path_kind](phase, encoder, *res)
            if path_counts is not None:  # a path: its launches count
                counts = {k: counts[k] + path_counts[k] for k in KERNELS}
        log(phase, f"phase took {time.perf_counter() - t_phase:.1f} s (host clock)")

    log("total", f"{time.perf_counter() - t_start:.1f} s since start, the build included")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name],
         **{k: v for k, v in records[name].items() if not k.startswith("_")}}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    if phases != set(PHASES):
        raise SystemExit(f"chip_smoke: ran only {sorted(phases)}; no device record")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
