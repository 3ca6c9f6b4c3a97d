"""The generic video entry point of the port: counterpart of the
repository's `tools/run_net.py` (reference SlowFast tools/run_net.py with
train_net.py and test_net.py), with its three tasks.

    python -m mspi_tpu_torch.run_net --model slowfast4x16 --data_dir ./k400_frames \
        --mode train --epochs 10 --batch_size 8 [--device cpu]
    python -m mspi_tpu_torch.run_net --task ssl --ssl_objective moco --model mvitv2s ...
    python -m mspi_tpu_torch.run_net --task masked --masked_target hog ...

The same arguments but one that nothing of it reads (`--num_workers`, which
the JAX CLI parses and does not read either), and the same JSON lines on
standard output. All tasks read a Kinetics-style frame tree
(`data.kinetics.KineticsFrames`: `train.csv` / `val.csv` / `test.csv` of
"frame_dir label" lines) and run on one CUDA device unless `--device cpu`
is given, in fp32 as the JAX CLI at its default dtype.

- classification (the default): any of the 12 zoo classifiers
  (`models.video_zoo.build_classifier`); one {"log": ...} per trainer
  message, then {"train": {...}} per epoch and {"val": {"epoch",
  "top1_err"}} where it evaluated; `--mode test` prints the multi-view
  ensemble's {"top1_acc", "top5_acc"}. `--data_parallel N` starts N ranks
  (one per GPU with NCCL, gloo ranks on the CPU) through the
  single-collective DDP step, rank 0 printing
  (`run_classification_training`'s compute_dtype takes bf16);
- ssl: contrastive pretraining (`train.ssl`) of a `ContrastiveNet` on the
  `--model` backbone (`models.registry.build_backbone`): two views of each
  clip, the `--ssl_objective` step (a 4096-entry queue for moco, 300
  prototypes for swav), the cosine LR policy per iteration and the momentum
  annealed per epoch; {"ssl": {"epoch", "objective", "loss"}} per epoch;
- masked: MaskFeat pretraining (`models.masked.MaskedMViT` on MViTv2-S,
  whatever `--model` says, as the JAX CLI) with the `--masked_target` (hog
  or pixel), a fresh 40% patch mask per batch, optax's AdamW at `--base_lr`
  with the model in eval mode (as the JAX step runs it with train=False);
  {"masked": {"epoch", "target", "loss"}} per epoch.

The tasks ssl and masked, as in the JAX CLI, read neither `--mode` nor
`--data_parallel`.
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np
import torch

def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="slowfast4x16",
                   help="any zoo classifier name (build_classifier) for classification; an "
                        "AVSP backbone name for ssl")
    p.add_argument("--task", default="classification",
                   choices=["classification", "ssl", "masked"])
    p.add_argument("--ssl_objective", default="moco",
                   choices=["moco", "simclr", "byol", "swav"])
    p.add_argument("--masked_target", default="hog", choices=["hog", "pixel"])
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


def _clips(ds, idxs, device) -> torch.Tensor:
    from mspi_tpu_torch.data.video import normalize_frames

    clips = normalize_frames(np.stack([ds[int(i)].clip for i in idxs]))
    return torch.from_numpy(clips).to(device)


def run_ssl(args) -> None:
    """Contrastive pretraining (the reference ContrastiveModel inside
    train_net.py) on Kinetics frame dirs: two stochastic views per clip,
    the objective's step, the momentum annealed by cosine per epoch."""
    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.data.kinetics import KineticsFrames
    from mspi_tpu_torch.models.registry import build_backbone
    from mspi_tpu_torch.train.optim import lr_cosine
    from mspi_tpu_torch.train.ssl import (ContrastiveNet, create_ssl_state, make_ssl_train_step,
                                          momentum_anneal_cosine)

    device = torch.device(args.device)
    cfg = get_config(args.model)
    torch.manual_seed(0)
    model = ContrastiveNet(build_backbone(cfg), dim_in=cfg.model.embed_dims[-1],
                           use_predictor=args.ssl_objective in ("moco", "byol"),
                           num_prototypes=300 if args.ssl_objective == "swav" else 0).to(device)
    state = create_ssl_state(model, _optimizer(args),
                             queue_size=4096 if args.ssl_objective == "moco" else 0)
    step_fn = make_ssl_train_step(args.ssl_objective)
    policy = lr_cosine(args.base_lr, 1e-6, args.epochs, args.warmup_epochs)
    ds = KineticsFrames(args.data_dir, "train", args.num_frames, args.sampling_rate,
                        args.crop_size)
    rng = np.random.default_rng(0)
    n_batches = len(ds) // args.batch_size
    for epoch in range(args.epochs):
        losses = []
        order = np.arange(len(ds))
        rng.shuffle(order)
        for i in range(n_batches):
            idxs = order[i * args.batch_size:(i + 1) * args.batch_size]
            batch = {"clips1": _clips(ds, idxs, device), "clips2": _clips(ds, idxs, device)}
            lr = policy(epoch + i / max(n_batches, 1))
            mom = momentum_anneal_cosine(0.994, epoch, args.epochs)
            losses.append(step_fn(state, batch, lr, mom))
        print(json.dumps({"ssl": {"epoch": epoch, "objective": args.ssl_objective,
                                  "loss": float(np.mean(losses))}}), flush=True)


def masked_train_step(model, optimizer, clips, mask, normalize_target: bool,
                      compute_dtype=None) -> float:
    """One MaskFeat step, as the JAX CLI's: the model in eval mode (its
    `train=False`), the masked-prediction loss, the optimizer's update."""
    from mspi_tpu_torch.models.masked import masked_prediction_loss

    model.eval()
    optimizer.zero_grad(set_to_none=True)
    with torch.autocast(clips.device.type, dtype=compute_dtype or torch.float32,
                        enabled=compute_dtype is not None):
        pred, target, m = model(clips, mask)
        loss = masked_prediction_loss(pred, target, m, normalize_target=normalize_target)
    loss.backward()
    optimizer.step()
    return float(loss.detach())


def run_masked(args) -> None:
    """MaskFeat pretraining (the reference MaskMViT task): a random
    space-time token mask per batch, HOG (or normalised-pixel) regression on
    the masked tokens."""
    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.data.kinetics import KineticsFrames
    from mspi_tpu_torch.models.masked import MaskedMViT, random_patch_mask
    from mspi_tpu_torch.train.optim import construct_optimizer

    device = torch.device(args.device)
    cfg = get_config("mvitv2s")
    torch.manual_seed(0)
    model = MaskedMViT(cfg.model.mvit, target=args.masked_target).to(device)
    stride = model.hog_stride if args.masked_target == "hog" else 4
    grid = (args.num_frames // 2, args.crop_size // stride, args.crop_size // stride)
    optimizer = construct_optimizer(list(model.named_parameters()), "adamw",
                                    base_lr=args.base_lr, weight_decay=args.weight_decay,
                                    zero_wd_1d_param=False)
    ds = KineticsFrames(args.data_dir, "train", args.num_frames, args.sampling_rate,
                        args.crop_size)
    mask_gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    for epoch in range(args.epochs):
        losses = []
        order = np.arange(len(ds))
        rng.shuffle(order)
        for b in range(len(ds) // args.batch_size):
            idxs = order[b * args.batch_size:(b + 1) * args.batch_size]
            mask = random_patch_mask(mask_gen, len(idxs), grid).to(device)
            losses.append(masked_train_step(model, optimizer, _clips(ds, idxs, device), mask,
                                            args.masked_target == "pixel"))
        print(json.dumps({"masked": {"epoch": epoch, "target": args.masked_target,
                                     "loss": float(np.mean(losses))}}), flush=True)


def main(argv=None) -> None:
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    if args.task == "ssl":
        run_ssl(args)
    elif args.task == "masked":
        run_masked(args)
    elif args.mode == "test":
        test(args)
    elif args.data_parallel > 1:
        from mspi_tpu_torch import run_net  # by its import name: see train/__main__.py
        from mspi_tpu_torch.parallel import launch

        launch(run_net._train_rank, args.data_parallel, 1, args.device, args)
    else:
        train(args)


if __name__ == "__main__":
    main()
