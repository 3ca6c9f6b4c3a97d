"""The generic video-classification entry point of the port: counterpart of
the repository's `tools/run_net.py` (reference SlowFast tools/run_net.py
with train_net.py and test_net.py).

    python -m mspi_tpu_torch.run_net --model slowfast4x16 --data_dir ./k400_frames \
        --mode train --epochs 10 --batch_size 8 [--device cpu]

The same arguments but three that nothing of it reads (`--ssl_objective`
and `--masked_target` of the tasks not ported, and `--num_workers`, which
the JAX CLI parses and does not read either), and the same JSON lines on
standard output: one
{"log": ...} per trainer message, then {"train": {...}} per epoch and
{"val": {"epoch", "top1_err"}} where it evaluated; `--mode test` prints the
multi-view ensemble's {"top1_acc", "top5_acc"}. Any of the 12 zoo
classifiers (`models.video_zoo.build_classifier`) on a Kinetics-style frame
tree (`data.kinetics.KineticsFrames`: `train.csv` / `val.csv` / `test.csv`
of "frame_dir label" lines). It runs on one CUDA device unless `--device
cpu` is given; `--data_parallel N` starts N ranks (one per GPU with NCCL,
gloo ranks on the CPU) through the single-collective DDP step, rank 0
printing. It computes in fp32, as the JAX CLI at its default dtype
(`run_classification_training`'s compute_dtype takes bf16). `--task ssl`
and `--task masked` are not ported yet and say so.
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np
import torch

NOT_PORTED = {"ssl": "the contrastive trainer (models/contrastive.py, train/ssl.py)",
              "masked": "the MaskFeat trainer (models/masked.py)"}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="slowfast4x16",
                   help="any zoo classifier name (build_classifier) for classification")
    p.add_argument("--task", default="classification",
                   choices=["classification", "ssl", "masked"])
    p.add_argument("--data_dir", required=True)
    p.add_argument("--mode", default="train", choices=["train", "test"])
    p.add_argument("--num_classes", default=400, type=int)
    p.add_argument("--epochs", default=10, type=int)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--base_lr", default=0.1, type=float)
    p.add_argument("--optimizer", default="sgd")
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--warmup_epochs", default=0.0, type=float)
    p.add_argument("--num_frames", default=16, type=int)
    p.add_argument("--sampling_rate", default=4, type=int)
    p.add_argument("--crop_size", default=224, type=int)
    p.add_argument("--num_ensemble_views", default=10, type=int)
    p.add_argument("--num_spatial_crops", default=3, type=int)
    p.add_argument("--label_smoothing", default=0.0, type=float)
    p.add_argument("--mixup_alpha", default=0.0, type=float)
    p.add_argument("--cutmix_alpha", default=0.0, type=float)
    p.add_argument("--multigrid", action="store_true")
    p.add_argument("--precise_bn_batches", default=0, type=int)
    p.add_argument("--ckpt_dir", default="")
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--tb_dir", default="")
    p.add_argument("--data_parallel", default=1, type=int,
                   help="ranks over which the batch is split (the DDP all-reduce)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def collate(samples):
    from mspi_tpu_torch.data.video import normalize_frames

    return {"clips": normalize_frames(np.stack([s.clip for s in samples])),
            "labels": np.array([s.label for s in samples]),
            "indices": np.array([s.index for s in samples])}


def batches(dataset, batch_size, shuffle, rng):
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for b in range(len(dataset) // batch_size):
        idxs = order[b * batch_size:(b + 1) * batch_size]
        yield collate([dataset[int(i)] for i in idxs])


class DictView:
    """KineticsSample -> the {'clips', 'labels'} dict the trainer reads."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        s = self.ds[i]
        return {"clips": s.clip, "labels": s.label}


def make_dataset(data_dir, sampling_rate, split, num_frames, crop_size):
    from mspi_tpu_torch.data.kinetics import KineticsFrames

    return DictView(KineticsFrames(data_dir, split, num_frames, sampling_rate, crop_size))


def _optimizer(args):
    from mspi_tpu_torch.train.optim import construct_optimizer

    return functools.partial(construct_optimizer, optimizing_method=args.optimizer,
                             base_lr=args.base_lr, weight_decay=args.weight_decay,
                             zero_wd_1d_param=False)


def train(args, mesh=None) -> None:
    """The classification task's training run, on one device or as one
    rank of the mesh."""
    from mspi_tpu_torch.models.video_zoo import build_classifier
    from mspi_tpu_torch.train.classification import run_classification_training
    from mspi_tpu_torch.train.optim import lr_cosine

    device = mesh.device if mesh is not None else torch.device(args.device)
    rank0 = mesh is None or mesh.rank == 0
    torch.manual_seed(0)  # the same initial weights on every rank
    model = build_classifier(args.model, args.num_classes).to(device)
    emit = (lambda obj: print(json.dumps(obj), flush=True)) if rank0 else (lambda obj: None)
    state, history = run_classification_training(
        model, _optimizer(args),
        functools.partial(make_dataset, args.data_dir, args.sampling_rate),
        epochs=args.epochs, batch_size=args.batch_size,
        lr_policy=lr_cosine(args.base_lr, 1e-6, args.epochs, args.warmup_epochs),
        base_t=args.num_frames, base_crop=args.crop_size,
        label_smoothing=args.label_smoothing, mixup_alpha=args.mixup_alpha,
        cutmix_alpha=args.cutmix_alpha, num_classes=args.num_classes,
        multigrid=args.multigrid, precise_bn_batches=args.precise_bn_batches,
        ckpt_dir=args.ckpt_dir or None, auto_resume=args.auto_resume,
        tb_dir=args.tb_dir or None, mesh=mesh, log=lambda s: emit({"log": str(s)}),
        device=device)
    for h in history:
        emit({"train": h})
        if "val_top1_err" in h:
            emit({"val": {"epoch": h["epoch"], "top1_err": h["val_top1_err"]}})


def _train_rank(mesh, args) -> None:
    train(args, mesh)


def test(args) -> dict:
    """--mode test: the multi-view ensemble of a freshly built classifier
    (as the JAX CLI, which loads no weights) on test.csv."""
    from mspi_tpu_torch.data.kinetics import KineticsFrames
    from mspi_tpu_torch.models.video_zoo import build_classifier
    from mspi_tpu_torch.train.classification import (create_cls_state, make_cls_eval_step,
                                                     perform_test)

    device = torch.device(args.device)
    torch.manual_seed(0)
    state = create_cls_state(build_classifier(args.model, args.num_classes).to(device),
                             _optimizer(args))
    test_ds = KineticsFrames(args.data_dir, "test", args.num_frames, args.sampling_rate,
                             args.crop_size, num_ensemble_views=args.num_ensemble_views,
                             num_spatial_crops=args.num_spatial_crops)
    stats = perform_test(state, make_cls_eval_step(),
                         batches(test_ds, args.batch_size, False, np.random.default_rng(0)),
                         len(test_ds.items), args.num_ensemble_views * args.num_spatial_crops,
                         args.num_classes, device)
    print(json.dumps(stats), flush=True)
    return stats


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.task in NOT_PORTED:
        raise SystemExit(f"--task {args.task}: {NOT_PORTED[args.task]} is not ported to "
                         f"mspi_tpu_torch yet; the JAX CLI (tools/run_net.py) runs it")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    if args.mode == "test":
        test(args)
    elif args.data_parallel > 1:
        from mspi_tpu_torch import run_net  # by its import name: see train/__main__.py
        from mspi_tpu_torch.parallel import launch

        launch(run_net._train_rank, args.data_parallel, 1, args.device, args)
    else:
        train(args)


if __name__ == "__main__":
    main()
