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
        --split 2 --save_path ./output \
        [--motion_encoder videoswins|uniformerb|s3d|x3dl|slowfast4x16] \
        [--weight port_state_dict.pt] [--bf16] [--use_sound ''] [--no-device_post] \
        [--native_loader] [--device cpu] \
        [--quant int8] [--prior_fold_res] [--prior_ln_t] \
        [--no_attn_relk] [--attn_packed] [--dwconv]

The CLI serves 224x384, as the JAX CLI does (neither has `--resolution`):
`--motion_encoder morphmlps` is taken, and its forward raises a ValueError
there, since MorphMLP-S needs (H/32)(W/32) to be a multiple of 49 (224x224);
`predict_video` serves it on frames at such a resolution.

`main` writes each map under its frame's own name (`<save_path>/<video>/
img_00001.jpg`) through `cv2.imwrite`, which encodes it by that name's
extension, as the JAX CLI writes it. `--use_sound` is parsed with
`type=bool` as the JAX CLI parses it: any non-empty string, `False`
included, keeps the sound on, and only `--use_sound ''` serves the
visual-only model. `--no-device_post` runs the post-processing per map
with cv2 on the host (`blur_exp_resize`) after one copy of the batch's maps
from the device, instead of on the device.

`--quant`, `--prior_fold_res` and `--prior_ln_t` are the serving options of
`ModelConfig` (the JAX package's MSPI_QUANT=int8, MSPI_PRIOR_FOLD_RES=1 and
MSPI_PRIOR_LN_T=1): int8 LN+MLP for the blocks with C >= 256 (refused
for uniformerb, whose C = 320 blocks row 12 has no form for), and the
ConvNeXt prior's residual-folded MLP and LayerNorm kernels. The last three
are MViT's layout options (MSPI_ATTN_RELK=0, MSPI_POOL_FAT=1 with
MSPI_ATTN_PACKED=1, MSPI_DWCONV=1): attention on augmented q/k lanes,
token-major packed attention, and the depthwise conv3d kernel for the
stride-1 pools. All are off by default.
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


def blur_exp_resize(pred_map: np.ndarray, img_size=(640, 480)) -> np.ndarray:
    """The host post-processing of one map with cv2 (`--no-device_post`):
    11x11 Gaussian blur, exp, bilinear resize to img_size (w, h), min-max,
    round to uint8."""
    import cv2

    pred_map = cv2.GaussianBlur(pred_map, (11, 11), 0)
    pred_map = np.exp(pred_map)
    pred_map = cv2.resize(pred_map, img_size)
    pred_map = (pred_map - pred_map.min()) / (pred_map.max() - pred_map.min())
    return np.round(pred_map * 255).astype(np.uint8)


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
                  img_size: Tuple[int, int] = (640, 480),
                  device_post: bool = True) -> np.ndarray:
    """Saliency maps for every frame of one video.

    frames_u8 [N, H, W, 3] uint8 at the model's resolution; audio_16k the
    whole 16 kHz mono waveform (None: no sound, the constant spectrogram);
    the audio windows are `audio_len_snippet` frames long (32, the reference
    inference's default). A `VisualSaliencyModel` is called on the clips
    alone: no spectrogram is computed. device_post=False copies each
    batch's log-density maps to the host once and post-processes them there
    with cv2 (`blur_exp_resize`). Returns uint8 [N, img_size[1],
    img_size[0]]. Needs N >= 2 * len_temporal - 1."""
    from mspi_tpu_torch.models.fusion import VisualSaliencyModel

    n = len(frames_u8)
    if n < 2 * len_temporal - 1:
        raise ValueError(f"{n} frames; sliding windows need {2 * len_temporal - 1}")
    device = next(model.parameters()).device
    use_sound = not isinstance(model, VisualSaliencyModel)
    post = make_device_post(img_size) if device_post else None
    jobs = sliding_window_jobs(n, len_temporal)
    out = np.zeros((n, img_size[1], img_size[0]), np.uint8)
    for b0 in range(0, len(jobs), window_batch):
        chunk = jobs[b0:b0 + window_batch]
        clips = []
        for s, flipped, _ in chunk:
            clip = frames_u8[s:s + len_temporal]
            clips.append(clip[::-1] if flipped else clip)
        clips += [clips[-1]] * (window_batch - len(chunk))  # one batch size for every forward
        clips_t = torch.from_numpy(np.ascontiguousarray(np.stack(clips))).to(device)
        if use_sound:
            auds = [get_audio_spectrogram(None, s, fps, len_snippet=audio_len_snippet,
                                          flip=flipped, audio_cache=audio_16k)
                    for s, flipped, _ in chunk]
            auds += [auds[-1]] * (window_batch - len(chunk))
            pred, _ = model(clips_t, torch.from_numpy(np.stack(auds)[..., None]).to(device))
        else:
            pred, _ = model(clips_t)
        if device_post:
            maps = post(pred).cpu().numpy()
        else:
            maps = [blur_exp_resize(m, img_size) for m in pred.float().cpu().numpy()]
        for (_, _, idx), m in zip(chunk, maps):
            out[idx] = m
    return out


def write_maps(out_dir: str, frame_paths: List[str], maps: np.ndarray) -> None:
    """Each map under its frame's basename in out_dir, encoded as
    `cv2.imwrite` encodes that name (JPEG for `.jpg`), as the JAX CLI writes
    them."""
    import cv2

    for path, m in zip(frame_paths, maps):
        target = os.path.join(out_dir, os.path.basename(path))
        if not cv2.imwrite(target, m):
            raise OSError(f"cv2.imwrite could not write {target}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--motion_encoder", default="mvitv2s", type=str,
                   help="backbone of the model (mvitv2s, videoswins, uniformerb, s3d, x3dl, "
                        "slowfast4x16 or morphmlps)")
    p.add_argument("--weight", default="", type=str,
                   help="torch state_dict of the port (e.g. via "
                        "mspi_tpu_torch.convert); random seeded weights if empty")
    p.add_argument("--save_path", default="./output", type=str)
    p.add_argument("--split", default=2, type=int)
    p.add_argument("--path_data", default="./AuViDataset", type=str)
    p.add_argument("--dataset", default="AVAD", type=str)
    p.add_argument("--clip_size", default=16, type=int)
    # type=bool as the JAX CLI: only the empty string turns it off
    p.add_argument("--use_sound", default=True, type=bool,
                   help="audio-visual model; --use_sound '' serves the visual-only model")
    p.add_argument("--window_batch", default=8, type=int)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--device_post", default=True, action=argparse.BooleanOptionalAction,
                   help="blur/exp/resize/min-max on the device, batched (default); "
                        "--no-device_post runs them per map with cv2 on the host")
    p.add_argument("--audio_len_snippet", default=32, type=int)
    p.add_argument("--native_loader", action="store_true",
                   help="decode and resize frames with the C++ loader (native/mspi_loader.cc)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--quant", default="", choices=("", "int8"),
                   help="int8: int8 LN+MLP in the blocks with C >= 256")
    p.add_argument("--prior_fold_res", action="store_true",
                   help="the prior's blocks fold the residual sum into the MLP kernel")
    p.add_argument("--prior_ln_t", action="store_true",
                   help="the prior's stem and downsample LayerNorms run the LayerNorm kernel")
    p.add_argument("--no_attn_relk", action="store_true",
                   help="MViT attention on augmented q/k lanes instead of the rel-pos kernel")
    p.add_argument("--attn_packed", action="store_true",
                   help="MViT blocks with several heads stay token-major at inference "
                        "(packed pools and the packed rel-pos attention kernel)")
    p.add_argument("--dwconv", action="store_true",
                   help="MViT's stride-1 pools run the depthwise conv3d kernel")
    return p.parse_args(argv)


def config_from_args(args):
    """The model config the CLI's arguments ask for."""
    from mspi_tpu_torch.config import get_config

    return get_config(args.motion_encoder, {"model": {
        "quant": args.quant, "prior_fold_res": args.prior_fold_res,
        "prior_ln_t": args.prior_ln_t, "attn_relk": not args.no_attn_relk, "attn_packed": args.attn_packed,
        "dwconv": args.dwconv}})


def load_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load `--weight` into the model as the JAX CLI does: the state dict
    out of the reference's checkpoint containers (`model_state`,
    `state_dict`, or a training checkpoint's `model`), merged with
    strict=False, so keys the model lacks are ignored; it prints how many
    were, and how many of the model's tensors it left at init."""
    from mspi_tpu_torch.train.checkpoints import load_non_strict, load_torch_checkpoint

    load_non_strict(model, load_torch_checkpoint(path))
    return model


def main(argv=None):
    args = parse_args(argv)
    from mspi_tpu_torch.data.audio import load_audio_mono_16k
    from mspi_tpu_torch.data.datasets import read_fold_list
    from mspi_tpu_torch.data.video import load_frame
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel, VisualSaliencyModel

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    cfg = config_from_args(args)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model_cls = AudioVisualSaliencyModel if args.use_sound else VisualSaliencyModel
    model = model_cls(cfg, device=device, dtype=dtype)
    if args.weight:
        load_weights(model, args.weight)
    h, w = cfg.data.resolution
    names, videos_fps, _ = read_fold_list(args.path_data, args.dataset, "test", args.split)
    print(names)
    for vname in names:
        print("Processing: " + vname, flush=True)
        paths = sorted(
            glob.glob(os.path.join(args.path_data, "video_frames", args.dataset, vname,
                                   "*.jpg")),
            key=lambda x: int(os.path.basename(x).split(".")[0].split("_")[1]))
        out_dir = os.path.join(args.save_path, vname)
        os.makedirs(out_dir, exist_ok=True)
        if len(paths) < 2 * args.clip_size - 1:
            print("More frames are needed")
            continue
        audio = (load_audio_mono_16k(os.path.join(args.path_data, "video_audio", args.dataset,
                                                  vname, vname + ".wav"))
                 if args.use_sound else None)
        frames = np.stack([load_frame(p, (h, w), native=args.native_loader) for p in paths])
        maps = predict_video(model, frames, audio, videos_fps[vname],
                             window_batch=args.window_batch, len_temporal=args.clip_size,
                             audio_len_snippet=args.audio_len_snippet,
                             device_post=args.device_post)
        write_maps(out_dir, paths, maps)


if __name__ == "__main__":
    main()
