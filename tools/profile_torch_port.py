"""Device-time breakdown of one forward, or one training step, of the
PyTorch/CUDA port on a GPU.

    python tools/profile_torch_port.py \
        [--motion_encoder mvitv2s|videoswins|uniformerb|s3d|x3dl|slowfast4x16|morphmlps] \
        [--batch 8] [--dtype bf16] [--steps 2] [--train [--remat]] [--table PATH] \
        [--quant int8] [--prior_fold_res] [--prior_ln_t] \
        [--no_attn_relk] [--attn_packed] [--dwconv]

Builds the AudioVisualSaliencyModel (MViTv2-S by default, or VideoSwin-S,
UniFormer-B, S3D, X3D-L, SlowFast 4x16 R50 or MorphMLP-S; 16x224x384, and
224x224 for MorphMLP-S, the resolution at which it runs; seeded random
weights) on cuda, warms up,
then traces `--steps`
forwards with
torch.profiler. With `--train` it traces `make_train_step` instead (fp32
weights, bf16 autocast compute with `--dtype bf16`) on a synthetic batch.
Prints the card's name and power limit, the wall time per forward or step
(CUDA events), the summed device-kernel time, the idle share of the device,
and the kernels grouped by family (the port's own kernels by name,
cuDNN/cuBLAS, elementwise, other), largest first. With `--table`, the full
key_averages table is written to PATH. With `--train` it also splits each
step's host wall time from the profiler's CPU events (each step inside a
`profile_train_step` range): the forward's dispatch (from the step's start
to its first autograd event), autograd's backward dispatch (the first to
the last `autograd::engine::evaluate_function` event), the optimizer
(`Optimizer.zero_grad`, `aten::_foreach_norm`, `Optimizer.step`, each
event's own span) and the rest (the metrics' read-back, which waits for
the device, and everything else), per step. `--quant int8`, `--prior_fold_res`
and `--prior_ln_t` build the model with the serving options (inference
only); their kernels (rows 12, 10 and 11) are families of their own.
`--no_attn_relk`, `--attn_packed` (inference only) and `--dwconv` build
MViTv2-S with the layout options; their kernels (rows 6, 8 and 18) are
families of their own too. `--remat` recomputes each MViT / VideoSwin block
in the backward pass (`ModelConfig.remat`). PyTorch's own depthwise conv3d
(`conv_depthwise3d`, which the channelwise and depthwise 3-D convs of
UniFormer-B and X3D-L reach) is a family of its own.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mspi_tpu_torch.config import get_config  # noqa: E402
from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel  # noqa: E402
from mspi_tpu_torch.train import engine  # noqa: E402
from mspi_tpu_torch.train.synthetic import make_batch  # noqa: E402

# The flash forwards by bias mode (0 none, 1 rel, 2 dense, 3 rel with the
# residual epilogue); row 6 is the bias-free kernel whose value width (96)
# differs from its score width. Template arguments: flash_attention_kernel
# (fp32) <DK, DV, BIAS>, flash_attention_sm90_kernel (bf16) <D, RK, BIAS, DV>.
FLASH_MODES = {0: "K4 self_attention", 1: "K1 attention_rel", 2: "window attention (row 15)",
               3: "row 8 attention_rel_packed"}
FLASH_ROW6 = "row 6 attention (augmented lanes)"
# The port's other kernels: a name matches when it holds every key. The
# bf16 LN+MLP body's arguments are C, LN and RES (row 10: RES true).
PORT_FAMILIES = (
    ("window attention backward (rows 16/17)", ("window_",)),
    ("window attention backward (rows 16/17)", ("attn_bwd", "2>(")),
    ("K1/K4/row 6 attention backward", ("attn_bwd",)),
    ("K1/K4/row 6 attention backward", ("rel_bwd_",)),
    ("K1/K4/row 6 attention backward", ("self_bwd_",)),
    ("K1/K4/row 6 attention backward", ("aug_bwd_",)),
    ("row 6/7 pad copy of q_aug, k_aug", ("aug_pad_",)),
    (FLASH_ROW6, ("flash_attention_aug_wide",)),  # the wide form (Da > 256)
    ("K2 ln_mlp backward", ("ln_mlp_bwd",)),
    ("K2 ln_mlp backward", ("lnbwd::",)),
    ("K2 ln_mlp backward", ("atb_kernel",)),
    ("K2 ln_mlp backward", ("sum_segments",)),
    ("K2 ln_mlp backward", ("colsum_kernel",)),
    ("row 18 dwconv3d", ("dwconv3d",)),
    ("row 12 ln_mlp_int8", ("ln_mlp_int8",)),
    ("row 10 ln_mlp_prior_res (folded K2)", ("ln_mlp", "true>(")),
    ("K2/K3 ln_mlp", ("ln_mlp",)),
    ("row 11 layernorm_tokens", ("layernorm_sm90_kernel",)),
)
# Everything else: a name matches when it holds any key.
FAMILIES = (
    ("depthwise conv3d (PyTorch)", ("conv_depthwise3d",)),
    ("conv (cuDNN)", ("conv", "cudnn", "implicit", "xmma", "sm90_xmma", "dgrad", "fprop")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "nvjet")),
    ("layer/batch norm", ("norm",)),
    ("upsample/pool", ("upsample", "pool", "interp")),
    ("copy/layout", ("copy", "cat", "transpose", "permute", "contiguous")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "softmax", "gelu")),
)


# Ranges that the profiler also lays on the device timeline: the step's own
# range and the optimizer's, which span its kernels without being one
ANNOTATIONS = ("profile_train_step", "Optimizer.")


def flash_family(name: str):
    """The flash forward's family by its template arguments, or None."""
    m = re.search(r"flash_attention_(sm90_)?kernel<([-0-9, ]+)>", name)
    if m is None:
        return None
    args = [int(a) for a in m.group(2).split(",")]
    d, dv, bias = (args[0], args[3], args[2]) if m.group(1) else args
    return FLASH_ROW6 if bias == 0 and d != dv else FLASH_MODES.get(bias, "other")


def family(name: str) -> str:
    fam = flash_family(name)
    if fam is not None:
        return fam
    low = name.lower().replace(" ", "")
    for fam, keys in PORT_FAMILIES:
        if all(k.lower() in low for k in keys):
            return fam
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def host_split(prof, steps: int) -> None:
    """Each profiled training step's host wall time by phase (see the module
    docstring), averaged over the steps, in ms."""
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "profile_train_step")
    optimizer = ("Optimizer.zero_grad", "aten::_foreach_norm", "Optimizer.step")
    split = defaultdict(float)
    for t0, t1 in spans:
        inside = [e for e in events if t0 <= e.time_range.start and e.time_range.end <= t1]
        bwd = [e for e in inside if e.name.startswith("autograd::engine::evaluate_function")]
        b0 = min((e.time_range.start for e in bwd), default=t1)
        b1 = max((e.time_range.end for e in bwd), default=t1)
        opt = [e for e in inside if e.name.startswith(optimizer)]
        before = sum(e.time_range.end - e.time_range.start for e in opt if e.time_range.end <= b0)
        after = sum(e.time_range.end - e.time_range.start for e in opt if e.time_range.start >= b1)
        split["wall"] += t1 - t0
        split["forward dispatch"] += b0 - t0 - before
        split["autograd backward dispatch"] += b1 - b0
        split["optimizer"] += before + after
        split["rest"] += t1 - b1 - after
    n = max(len(spans), 1)
    print(f"host split per step over {len(spans)} profiled steps (of {steps}): " + "; ".join(
        f"{k} {v / n / 1000:.2f} ms" for k, v in split.items()))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--motion_encoder", default="mvitv2s",
                   choices=("mvitv2s", "videoswins", "uniformerb", "s3d", "x3dl",
                            "slowfast4x16", "morphmlps"))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--train", action="store_true", help="profile training steps")
    p.add_argument("--table", default="", help="write the full key_averages table here")
    p.add_argument("--quant", default="", choices=("", "int8"))
    p.add_argument("--prior_fold_res", action="store_true")
    p.add_argument("--prior_ln_t", action="store_true")
    p.add_argument("--no_attn_relk", action="store_true")
    p.add_argument("--attn_packed", action="store_true")
    p.add_argument("--dwconv", action="store_true")
    p.add_argument("--remat", action="store_true")
    args = p.parse_args()
    if args.train and (args.quant or args.prior_fold_res or args.prior_ln_t
                       or args.attn_packed):
        raise SystemExit("the serving options and attn_packed are inference only")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    cfg = get_config(args.motion_encoder, {"model": {
        "quant": args.quant, "prior_fold_res": args.prior_fold_res,
        "prior_ln_t": args.prior_ln_t, "attn_relk": not args.no_attn_relk,
        "attn_packed": args.attn_packed, "dwconv": args.dwconv, "remat": args.remat},
        **({"data": {"resolution": (224, 224)}} if args.motion_encoder == "morphmlps" else {})})
    model = AudioVisualSaliencyModel(cfg, device="cuda",
                                     dtype=torch.float32 if args.train else dtype,
                                     generator=torch.Generator().manual_seed(0))
    if args.train:
        import numpy as np

        state = engine.create_train_state(cfg, model)
        step = engine.make_train_step(cfg.train.gamma,
                                      compute_dtype=dtype if args.dtype == "bf16" else None)
        batch = engine.to_device(make_batch(np.random.default_rng(1), args.batch, 16,
                                            cfg.data.resolution, (257, 111)), "cuda")

        def run():
            with torch.profiler.record_function("profile_train_step"):
                step(state, batch, cfg.solver.lr)
    else:
        gen = torch.Generator().manual_seed(1)
        clips = torch.randint(0, 256, (args.batch, 16, *cfg.data.resolution, 3),
                              generator=gen, dtype=torch.uint8).cuda()
        auds = torch.randn(args.batch, 257, 111, 1, generator=gen).cuda()

        def run():
            with torch.no_grad():
                model(clips, auds)

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for _ in range(args.steps):
            run()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / args.steps

    by_family = defaultdict(float)
    device_ms = 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = evt.self_cuda_time_total
        if (t <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.key.startswith(ANNOTATIONS)):  # ranges on the device, not kernels
            continue
        ms = t / 1000.0 / args.steps
        device_ms += ms
        by_family[family(evt.key)] += ms
    what = "train step" if args.train else "forward"
    print(f"{args.motion_encoder} batch {args.batch} {args.dtype}: wall {wall_ms:.1f} ms/{what} "
          f"({args.batch * 1000 / wall_ms:.2f} clips/s), device kernels "
          f"{device_ms:.1f} ms/{what}, device idle share "
          f"{max(0.0, 1 - device_ms / wall_ms):.1%}")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:38s} {ms:8.2f} ms  {ms / max(device_ms, 1e-9):6.1%}")
    if args.train:
        host_split(prof, args.steps)
    if args.table:
        Path(args.table).parent.mkdir(parents=True, exist_ok=True)
        Path(args.table).write_text(
            prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=80))


if __name__ == "__main__":
    main()
