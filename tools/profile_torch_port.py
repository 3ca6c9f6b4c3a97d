"""Device-time breakdown of one forward, or one training step, of the
PyTorch/CUDA port on a GPU.

    python tools/profile_torch_port.py [--motion_encoder mvitv2s|videoswins] \
        [--batch 8] [--dtype bf16] [--steps 2] [--train] [--table PATH]

Builds the AudioVisualSaliencyModel (MViTv2-S by default, or VideoSwin-S;
16x224x384, seeded random weights) on cuda, warms up, then traces `--steps`
forwards with
torch.profiler. With `--train` it traces `make_train_step` instead (fp32
weights, bf16 autocast compute with `--dtype bf16`) on a synthetic batch.
Prints the card's name and power limit, the wall time per forward or step
(CUDA events), the summed device-kernel time, the idle share of the device,
and the kernels grouped by family (the port's own kernels by name,
cuDNN/cuBLAS, elementwise, other), largest first. With `--table`, the full
key_averages table is written to PATH.
"""

from __future__ import annotations

import argparse
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

# The port's kernels: a name matches when it holds every key. The flash
# kernels' last template argument is the bias mode (0 none, 1 rel, 2 dense).
PORT_FAMILIES = (
    ("window attention backward (rows 16/17)", ("window_",)),
    ("window attention backward (rows 16/17)", ("attn_bwd", "2>(")),
    ("K1/K4 attention backward", ("attn_bwd",)),
    ("K2 ln_mlp backward", ("ln_mlp_bwd",)),
    ("K2 ln_mlp backward", ("atb_kernel",)),
    ("K2 ln_mlp backward", ("sum_segments",)),
    ("window attention (row 15)", ("flash_attention", "2>(")),
    ("K1 attention_rel", ("flash_attention", "1>(")),
    ("K4 self_attention", ("flash_attention", "0>(")),
    ("K2/K3 ln_mlp", ("ln_mlp",)),
)
# Everything else: a name matches when it holds any key.
FAMILIES = (
    ("conv (cuDNN)", ("conv", "cudnn", "implicit", "xmma", "sm90_xmma", "dgrad", "fprop")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "nvjet")),
    ("layer/batch norm", ("norm",)),
    ("upsample/pool", ("upsample", "pool", "interp")),
    ("copy/layout", ("copy", "cat", "transpose", "permute", "contiguous")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "softmax", "gelu")),
)


def family(name: str) -> str:
    low = name.lower().replace(" ", "")
    for fam, keys in PORT_FAMILIES:
        if all(k.lower() in low for k in keys):
            return fam
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--motion_encoder", default="mvitv2s", choices=("mvitv2s", "videoswins"))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--train", action="store_true", help="profile training steps")
    p.add_argument("--table", default="", help="write the full key_averages table here")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    cfg = get_config(args.motion_encoder)
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
        if t <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
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
    if args.table:
        Path(args.table).parent.mkdir(parents=True, exist_ok=True)
        Path(args.table).write_text(
            prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=80))


if __name__ == "__main__":
    main()
