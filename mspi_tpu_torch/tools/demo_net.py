"""Saliency demo over a frame directory: counterpart of the repository's
`tools/demo_net.py` (reference SlowFast tools/demo_net.py:21-96 and
visualization/demo_loader.py), the asynchronous read -> predict -> write
pipeline of `mspi_tpu_torch.utils.demo`. Sources are frame directories;
each prediction is written as a heatmap PNG `sal_{idx:05d}.png` (idx: the
clip's last frame), optionally blended onto the frame.

    python -m mspi_tpu_torch.tools.demo_net --frames ./video_frames/AVAD/v1 \
        --out ./demo_out [--weight ckpt.pth] [--motion_encoder s3d] [--blend] \
        [--bf16] [--device cpu]

The model is `--motion_encoder`'s AudioVisualSaliencyModel (S3D by default,
at its config's 224x384) fed silent audio (a spectrogram of 0.02), as the
JAX tool feeds it, with weights drawn from seed 0 unless `--weight` gives a
state dict, which is merged non-strictly (`inference.load_weights`). It
runs on the CUDA card unless `--device cpu` is given, in fp32 as the JAX
tool at its default dtype, or with bf16 parameters under `--bf16`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

SPECTRO = (257, 111)  # the spectrogram's (frequency, time) shape, DataConfig's in the JAX package


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", required=True, help="directory of JPEG frames")
    p.add_argument("--out", required=True)
    p.add_argument("--weight", default="")
    p.add_argument("--motion_encoder", default="s3d")
    p.add_argument("--clip_size", default=16, type=int)
    p.add_argument("--stride", default=1, type=int)
    p.add_argument("--batch", default=4, type=int)
    p.add_argument("--blend", action="store_true", help="overlay the heatmap on the frame")
    p.add_argument("--bf16", action="store_true", help="bfloat16 parameters and compute")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def build_predictor(cfg, batch: int, device, dtype, weight: str = ""):
    """(model, predict): the saliency model on `device` in `dtype`, and
    predict(uint8 clips [B,T,H,W,3]) -> the log-density maps [B,H,W] as
    fp32 numpy, on silent audio, in eval mode."""
    from mspi_tpu_torch.inference import load_weights
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel

    model = AudioVisualSaliencyModel(cfg, device=device, dtype=dtype,
                                     generator=torch.Generator().manual_seed(0)).eval()
    if weight:
        load_weights(model, weight)
    silent = torch.full((batch, *SPECTRO, 1), 0.02, device=device)

    @torch.no_grad()
    def predict(clips_u8: np.ndarray) -> np.ndarray:
        clips = torch.from_numpy(np.ascontiguousarray(clips_u8)).to(device)
        out, _ = model(clips, silent[:clips.shape[0]])
        return out.float().cpu().numpy()

    return model, predict


def main(argv=None) -> None:
    args = parse_args(argv)
    import cv2

    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.utils.demo import AsyncDemo, FrameDirSource

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    cfg = get_config(args.motion_encoder)
    h, w = cfg.data.resolution
    _, predict = build_predictor(cfg, args.batch, device,
                                 torch.bfloat16 if args.bf16 else torch.float32, args.weight)
    source = FrameDirSource(args.frames, args.clip_size, (h, w), args.stride)
    os.makedirs(args.out, exist_ok=True)

    def write_fn(idx, pred):
        sal = np.exp(pred)
        sal = (sal - sal.min()) / max(sal.max() - sal.min(), 1e-12)
        heat = cv2.applyColorMap((sal * 255).astype(np.uint8), cv2.COLORMAP_JET)
        if args.blend:
            frame = cv2.cvtColor(source.frames[idx], cv2.COLOR_RGB2BGR)
            heat = cv2.addWeighted(frame, 0.5, heat, 0.5, 0)
        cv2.imwrite(os.path.join(args.out, f"sal_{idx:05d}.png"), heat)

    AsyncDemo(predict, write_fn, batch_size=args.batch).run(iter(source))
    print(f"wrote demo frames to {args.out}")


if __name__ == "__main__":
    main()
