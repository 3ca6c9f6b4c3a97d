"""Offline saliency evaluation over saved prediction maps: the port's
counterpart of the repository root's `evaluate.py`.

KLD / CC / SIM / NSS / AUC-Judd / shuffled AUC / IG of a directory of
predicted maps (as `python -m mspi_tpu_torch.inference` writes them) against
the dataset's eye maps and `.mat` fixations, averaged over the frames that
have a non-empty ground truth, printed as one JSON line:

    python -m mspi_tpu_torch.evaluate --pred_path ./output --path_data ./AuViDataset \
        --dataset AVAD --split 2 [--metrics kld cc sim nss aucj sauc ig] \
        [--baseline_map center.png] [--device cpu]

The arguments, the skip rules, the `np.random.default_rng(2023)` draws and
their order (AUC-Judd's jitter, the shuffled AUC's pick and permutations)
are the JAX CLI's. The map metrics run on the port's `train/metrics.py` in
float32, the precision the JAX CLI computes them in, on the card unless
`--device cpu` asks for the CPU; the AUCs are host numpy, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

METRICS = ("kld", "cc", "sim", "nss", "aucj", "sauc", "ig")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pred_path", required=True)
    p.add_argument("--path_data", required=True)
    p.add_argument("--dataset", default="AVAD")
    p.add_argument("--split", default=1, type=int)
    p.add_argument("--metrics", nargs="+", default=["kld", "cc", "sim", "nss", "aucj"],
                   choices=METRICS)
    p.add_argument("--baseline_map", default=None, help="center-prior map path for IG")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def evaluate(args) -> dict:
    """The metrics' means over the evaluated frames, and `frames`."""
    import cv2
    import torch

    from mspi_tpu_torch.data.datasets import read_fold_list
    from mspi_tpu_torch.data.video import load_fixation
    from mspi_tpu_torch.train import metrics as M

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

    def t32(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a[None]).to(device, torch.float32)

    names, _, _ = read_fold_list(args.path_data, args.dataset, "test", args.split)
    rng = np.random.default_rng(2023)
    sums = {m: 0.0 for m in args.metrics}
    count = 0
    other_map_pool = []
    for vname in names:
        pred_dir = os.path.join(args.pred_path, vname)
        if not os.path.isdir(pred_dir):
            print(f"[eval] missing predictions for {vname}, skipping")
            continue
        annt = os.path.join(args.path_data, "annotations", args.dataset, vname)
        for fname in sorted(os.listdir(pred_dir)):
            idx = int(fname.split(".")[0].split("_")[1])
            gt_path = os.path.join(annt, "maps", "eyeMap_%05d.jpg" % idx)
            if not os.path.exists(gt_path):
                continue
            pred = cv2.imread(os.path.join(pred_dir, fname), 0)
            gt = cv2.imread(gt_path, 0)
            if pred is None or gt is None or gt.max() == 0:
                continue
            pred = cv2.resize(pred.astype(np.float64), (gt.shape[1], gt.shape[0]))
            pred = pred / max(pred.max(), 1e-12)
            gtf = gt.astype(np.float64) / 255.0
            p1, g1 = t32(pred), t32(gtf)
            if "kld" in sums:
                sums["kld"] += float(M.kldiv(p1, g1))
            if "cc" in sums:
                sums["cc"] += float(M.cc(p1, g1))
            if "sim" in sums:
                sums["sim"] += float(M.similarity(p1, g1))

            fix = None
            fix_path = os.path.join(annt, "fixMap_%05d.mat" % idx)
            if os.path.exists(fix_path):
                fix = load_fixation(fix_path, row=gt.shape[0], col=gt.shape[1])
            if fix is not None and fix.any():
                if "nss" in sums:
                    sums["nss"] += float(M.nss(p1, t32(fix)))
                if "aucj" in sums:
                    sums["aucj"] += M.auc_judd(pred, fix, rng=rng)
                if "sauc" in sums:
                    if other_map_pool:
                        other = other_map_pool[int(rng.integers(len(other_map_pool)))]
                        sums["sauc"] += M.auc_shuff(pred[None], fix[None], other[None], rng=rng)
                    if len(other_map_pool) < 64:
                        other_map_pool.append(fix)
            if "ig" in sums and args.baseline_map:
                base = cv2.imread(args.baseline_map, 0).astype(np.float64)
                base = cv2.resize(base, (gt.shape[1], gt.shape[0])) / 255.0
                sums["ig"] += float(M.ig(p1, g1, t32(base)))
            count += 1
    result = {m: s / max(count, 1) for m, s in sums.items()}
    result["frames"] = count
    return result


def main(argv=None) -> None:
    print(json.dumps(evaluate(parse_args(argv))))


if __name__ == "__main__":
    main()
