"""Grad-CAM of a zoo classifier's decision: counterpart of the repository's
`tools/visualize.py` (reference SlowFast visualization/gradcam_utils.py,
driven through tensorboard_vis.py).

    python -m mspi_tpu_torch.tools.visualize --model x3dl --frames <frame_dir> \
        --out ./cams [--tap -1] [--device cpu]

The first `--num_frames` frames of the directory, resized to `--crop_size`
squared and ImageNet-normalised, go through the classifier
(`models.video_zoo.build_classifier`, weights drawn from seed 0); the CAM
of pyramid level `--tap` (`utils.visualization.grad_cam`) is written per
frame of that level as `cam_{t:03d}.png`, blended onto the input frame it
covers. SlowFast's and X3D's heads take a list of levels, MViT's head the
last level itself, as the JAX tool calls them. It runs on the CUDA card
unless `--device cpu` is given, in fp32 as the JAX tool.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="x3dl", choices=["slowfast4x16", "x3dl", "mvitv2s"])
    p.add_argument("--frames", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--num_frames", default=16, type=int)
    p.add_argument("--crop_size", default=224, type=int)
    p.add_argument("--tap", default=-1, type=int,
                   help="pyramid level for the CAM (default: last)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Returns (the CAMs [T', H', W'] of the clip, the class scores [C])."""
    args = parse_args(argv)
    import cv2
    from PIL import Image

    from mspi_tpu_torch.data.video import normalize_frames
    from mspi_tpu_torch.models.video_zoo import build_classifier
    from mspi_tpu_torch.utils.visualization import grad_cam

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    torch.manual_seed(0)
    model = build_classifier(args.model).to(device).eval()
    files = sorted(os.listdir(args.frames))[: args.num_frames]
    frames = np.stack([
        np.asarray(Image.open(os.path.join(args.frames, f)).convert("RGB")
                   .resize((args.crop_size, args.crop_size)), dtype=np.uint8)
        for f in files])
    clips = torch.from_numpy(normalize_frames(frames)[None]).to(device)

    def head_apply(feats):
        return model.head([feats[-1]] if args.model != "mvitv2s" else feats[-1])

    cams, scores = grad_cam(model.backbone, head_apply, clips, tap=args.tap)
    cams, scores = cams[0].float().cpu().numpy(), scores[0].float().cpu().numpy()
    os.makedirs(args.out, exist_ok=True)
    for t in range(cams.shape[0]):
        cam = cv2.resize(cams[t], (args.crop_size, args.crop_size))
        heat = cv2.applyColorMap((cam * 255).astype(np.uint8), cv2.COLORMAP_JET)
        src_t = min(int(t * len(frames) / cams.shape[0]), len(frames) - 1)
        frame = cv2.cvtColor(frames[src_t], cv2.COLOR_RGB2BGR)
        cv2.imwrite(os.path.join(args.out, f"cam_{t:03d}.png"),
                    cv2.addWeighted(frame, 0.5, heat, 0.5, 0))
    print(f"predicted class {int(np.argmax(scores))}; "
          f"wrote {cams.shape[0]} CAM frames to {args.out}")
    return cams, scores


if __name__ == "__main__":
    main()
