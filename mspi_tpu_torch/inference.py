"""Saliency inference on video: per-frame uint8 maps, and the CLI that
writes them as PNGs for a dataset split.

Counterpart of the repository root's `inference.py` (reference
inference.py:94-192): sorted frames per video, sliding 16-frame windows
(stride 1), the first len-1 frames predicted from the temporally flipped
clip and flipped audio, then an 11x11 Gaussian blur -> exp -> resize to
640x480 -> per-map min-max -> uint8. Windows run `window_batch` at a time.

`predict_video` is the pure entry point (arrays in, maps out); `main` wraps
it with file I/O:

    python -m mspi_tpu_torch.inference --path_data ./AuViDataset --dataset AVAD \
        --split 2 --save_path ./output [--motion_encoder videoswins] \
        [--weight port_state_dict.pt] [--bf16]
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mspi_tpu_torch.data.audio import get_audio_spectrogram

Job = Tuple[int, bool, int]


def sliding_window_jobs(n_frames: int, len_temporal: int) -> List[Job]:
    """[(window_start, flipped, output_frame_idx)] in the reference's order,
    including the temporal-flip windows for the first len-1 frames."""
    jobs = []
    for i in range(len_temporal - 1, n_frames):
        s = i - len_temporal + 1
        jobs.append((s, False, i))
        if i < 2 * len_temporal - 2:
            jobs.append((s, True, s))
    return jobs


def make_device_post(img_size=(640, 480)) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batched post-processing on the maps' device: the cv2 pipeline
    (11x11 Gaussian with sigma 2.0 and reflect-101 borders, exp, half-pixel
    bilinear resize to img_size (w, h), per-map min-max, round to uint8).

    The maps are log-densities: mean about -11 with a dynamic range of about
    0.03, below one bf16 step at that offset and near TF32's resolution. So
    the blur runs on mean-centred maps, as 11 shifted fp32 multiply-adds per
    axis: no matmul or convolution, which the card could run in TF32."""
    sigma = 0.3 * ((11 - 1) * 0.5 - 1) + 0.8
    xk = np.arange(11, dtype=np.float64) - 5
    k1 = np.exp(-0.5 * (xk / sigma) ** 2)
    taps = (k1 / k1.sum()).astype(np.float32).tolist()

    def post(pred: torch.Tensor) -> torch.Tensor:
        B, hh, ww = pred.shape
        pred = pred.float()
        mean = pred.mean(dim=(1, 2), keepdim=True)
        p = F.pad((pred - mean)[:, None], (5, 5, 5, 5), mode="reflect")[:, 0]
        p = sum(t * p[:, i:i + hh, :] for i, t in enumerate(taps))
        p = sum(t * p[:, :, i:i + ww] for i, t in enumerate(taps))
        p = torch.exp(p + mean)
        p = F.interpolate(p[:, None], size=(img_size[1], img_size[0]), mode="bilinear",
                          align_corners=False)[:, 0]
        mn = p.amin(dim=(1, 2), keepdim=True)
        mx = p.amax(dim=(1, 2), keepdim=True)
        return torch.round((p - mn) / (mx - mn) * 255).to(torch.uint8)

    return post


@torch.no_grad()
def predict_video(model, frames_u8: np.ndarray, audio_16k: Optional[np.ndarray],
                  fps: float, window_batch: int = 8, len_temporal: int = 16,
                  audio_len_snippet: int = 32,
                  img_size: Tuple[int, int] = (640, 480)) -> np.ndarray:
    """Saliency maps for every frame of one video.

    frames_u8 [N, H, W, 3] uint8 at the model's resolution; audio_16k the
    whole 16 kHz mono waveform (None: no sound, the constant spectrogram);
    the audio windows are `audio_len_snippet` frames long (32, the reference
    inference's default). Returns uint8 [N, img_size[1], img_size[0]].
    Needs N >= 2 * len_temporal - 1."""
    n = len(frames_u8)
    if n < 2 * len_temporal - 1:
        raise ValueError(f"{n} frames; sliding windows need {2 * len_temporal - 1}")
    device = next(model.parameters()).device
    post = make_device_post(img_size)
    jobs = sliding_window_jobs(n, len_temporal)
    out = np.zeros((n, img_size[1], img_size[0]), np.uint8)
    for b0 in range(0, len(jobs), window_batch):
        chunk = jobs[b0:b0 + window_batch]
        clips, auds = [], []
        for s, flipped, _ in chunk:
            clip = frames_u8[s:s + len_temporal]
            clips.append(clip[::-1] if flipped else clip)
            auds.append(get_audio_spectrogram(None, s, fps, len_snippet=audio_len_snippet,
                                              flip=flipped, audio_cache=audio_16k))
        pad = window_batch - len(chunk)  # keep every forward at one batch size
        clips += [clips[-1]] * pad
        auds += [auds[-1]] * pad
        clips_t = torch.from_numpy(np.ascontiguousarray(np.stack(clips))).to(device)
        auds_t = torch.from_numpy(np.stack(auds)[..., None]).to(device)
        pred, _ = model(clips_t, auds_t)
        maps = post(pred).cpu().numpy()
        for (_, _, idx), m in zip(chunk, maps):
            out[idx] = m
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--motion_encoder", default="mvitv2s", type=str,
                   help="backbone of the model (mvitv2s or videoswins)")
    p.add_argument("--weight", default="", type=str,
                   help="torch state_dict of the port (e.g. via "
                        "mspi_tpu_torch.convert); random seeded weights if empty")
    p.add_argument("--save_path", default="./output", type=str)
    p.add_argument("--split", default=2, type=int)
    p.add_argument("--path_data", default="./AuViDataset", type=str)
    p.add_argument("--dataset", default="AVAD", type=str)
    p.add_argument("--clip_size", default=16, type=int)
    p.add_argument("--window_batch", default=8, type=int)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--audio_len_snippet", default=32, type=int)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from PIL import Image

    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.data.audio import load_audio_mono_16k
    from mspi_tpu_torch.data.datasets import read_fold_list
    from mspi_tpu_torch.data.video import load_frame
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel

    if not torch.cuda.is_available():
        raise RuntimeError("the port's inference runs on a CUDA device")
    cfg = get_config(args.motion_encoder)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = AudioVisualSaliencyModel(cfg, device="cuda", dtype=dtype)
    if args.weight:
        model.load_state_dict(torch.load(args.weight, map_location="cuda"))
    h, w = cfg.data.resolution
    names, videos_fps, _ = read_fold_list(args.path_data, args.dataset, "test", args.split)
    for vname in names:
        print("Processing: " + vname, flush=True)
        audio = load_audio_mono_16k(os.path.join(args.path_data, "video_audio", args.dataset,
                                                 vname, vname + ".wav"))
        paths = sorted(
            glob.glob(os.path.join(args.path_data, "video_frames", args.dataset, vname,
                                   "*.jpg")),
            key=lambda x: int(os.path.basename(x).split(".")[0].split("_")[1]))
        if len(paths) < 2 * args.clip_size - 1:
            print("More frames are needed")
            continue
        frames = np.stack([load_frame(p, (h, w)) for p in paths])
        maps = predict_video(model, frames, audio, videos_fps[vname],
                             window_batch=args.window_batch, len_temporal=args.clip_size,
                             audio_len_snippet=args.audio_len_snippet)
        out_dir = os.path.join(args.save_path, vname)
        os.makedirs(out_dir, exist_ok=True)
        for p, m in zip(paths, maps):
            stem = os.path.splitext(os.path.basename(p))[0]
            Image.fromarray(m).save(os.path.join(out_dir, stem + ".png"))


if __name__ == "__main__":
    main()
