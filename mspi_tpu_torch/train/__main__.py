"""Training CLI of the port: counterpart of the repository's `train.py`.

    python -m mspi_tpu_torch.train --data_root ./AuViDataset --split 1 [--bf16] \
        [--motion_encoder mvitv2s|videoswins|uniformerb|s3d|x3dl|slowfast4x16|morphmlps] \
        [--remat] [--resolution H W] \
        [--native_loader] [--no_attn_relk] [--dwconv] [--attn_packed]

The same arguments, seed (2023), 6-dataset mixture, frozen encoders,
AdamW (lr 1e-4, weight decay 0), step LR schedule, validation at the
monitored epochs, JSONL logs, periodic `ckpt_{epoch}` checkpoints and
auto-resume; a non-finite loss stops the run with "Loss is NaN.". It runs
on one CUDA device unless `--device cpu` is given. `--dp` / `--tp` are the
JAX CLI's mesh: dp = `--dp` or the devices // tp, then gcd(dp, batch); with
dp * tp > 1 the CLI starts dp * tp ranks itself (one per GPU with NCCL, or
gloo ranks with `--device cpu`, where `--dp` defaults to 1), through the
single-collective DDP step (`engine.make_ddp_train_step`), the SyncBlock
split over tp ranks (`parallel.shard_sync_block`). Every rank draws the
same seeded order of samples and batches, and decodes only its data
index's rows of each batch (`parallel.data_rows`); the random windows are
drawn where a sample is decoded. Rank 0 writes the logs and the
checkpoints, in the one-device form (the split tensors gathered), so a
checkpoint resumes under any mesh. dp = tp = 1 runs the one-device path,
with no process group. With MSPI_COORDINATOR (host:port),
MSPI_NUM_PROCESSES and MSPI_PROCESS_ID set, as for the JAX CLI
(`parallel.maybe_init_distributed`), the processes are started outside,
one per device, and each joins their group as one rank of a mesh of the
whole world. `--remat` recomputes each
MViT and VideoSwin block's forward in the backward pass
(`ModelConfig.remat`; the other backbones ignore it). MorphMLP-S trains
only where (H/32)(W/32) is a multiple of 49: `--motion_encoder morphmlps
--resolution 224 224`. `--native_loader`
decodes frames with the C++ loader (the JAX package's
MSPI_NATIVE_LOADER=1). The MViT
layout options of `ModelConfig` (`--no_attn_relk`, `--dwconv`, and
`--attn_packed`, which changes only inference, the validation passes) are
the JAX package's MSPI_ATTN_RELK=0, MSPI_DWCONV=1 and MSPI_POOL_FAT=1 with
MSPI_ATTN_PACKED=1.
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import time
from collections import defaultdict

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--session_name", default="s1_mspi_torch_epoch120_batch2_16_224_384")
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--split", default=1, type=int)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--dataset", default="sound", type=str)
    p.add_argument("--weights", type=str, default="")
    p.add_argument("--log_dir", type=str, default="./training_logs")
    p.add_argument("--save_ckpt", default=True, type=bool)
    p.add_argument("--save_ckpt_freq", default=10, type=int)
    p.add_argument("--gamma", default=1.0, type=float)
    p.add_argument("--motion_encoder", default="mvitv2s", type=str,
                   help="backbone of the model (mvitv2s, videoswins, uniformerb, s3d, x3dl, "
                        "slowfast4x16 or morphmlps)")
    p.add_argument("--data_root", default="./AuViDataset", type=str)
    p.add_argument("--batch_size", default=None, type=int)
    p.add_argument("--epochs", default=None, type=int)
    p.add_argument("--dp", default=None, type=int, help="data-parallel mesh size")
    p.add_argument("--tp", default=1, type=int, help="tensor-parallel mesh size")
    p.add_argument("--auto_resume", default=True, type=bool)
    p.add_argument("--resolution", default=None, nargs=2, type=int,
                   help="override (H W), e.g. for smoke runs")
    p.add_argument("--monitored_epochs", default=None, nargs="+", type=int)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (parameters and optimizer stay fp32)")
    p.add_argument("--remat", action="store_true",
                   help="recompute MViT / VideoSwin blocks in the backward pass "
                        "(activation memory)")
    p.add_argument("--native_loader", action="store_true",
                   help="decode and resize frames with the C++ loader (native/mspi_loader.cc)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--no_attn_relk", action="store_true",
                   help="MViT attention on augmented q/k lanes instead of the rel-pos kernel")
    p.add_argument("--attn_packed", action="store_true",
                   help="MViT blocks with several heads stay token-major at inference "
                        "(packed pools and the packed rel-pos attention kernel)")
    p.add_argument("--dwconv", action="store_true",
                   help="MViT's stride-1 pools run the depthwise conv3d kernel")
    return p.parse_args(argv)


def config_from_args(args):
    """The config the CLI's arguments ask for."""
    from mspi_tpu_torch.config import get_config

    return get_config(args.motion_encoder, overrides={
        "data": {"root": args.data_root,
                 **({"resolution": tuple(args.resolution)} if args.resolution else {})},
        "model": {"attn_relk": not args.no_attn_relk, "attn_packed": args.attn_packed,
                  "dwconv": args.dwconv, "remat": args.remat},
        "train": {"gamma": args.gamma,
                  **({"batch_size": args.batch_size} if args.batch_size else {})},
        "solver": {**({"max_epoch": args.epochs} if args.epochs else {}),
                   **({"monitored_epochs": tuple(args.monitored_epochs)}
                      if args.monitored_epochs else {})},
    })


def _mean(rows):
    sums = defaultdict(float)
    for row in rows:
        for k, v in row.items():
            sums[k] += v
    return {k: v / max(1, len(rows)) for k, v in sums.items()}


def mesh_shape(dp, tp: int, n_dev: int, batch_size: int):
    """(dp, tp) as the JAX CLI sizes its mesh (train.py:136-141): dp is
    --dp or the devices // tp, then shrunk to divide the global batch."""
    dp = dp or (n_dev // tp)
    return math.gcd(dp, batch_size) or 1, tp


def main(argv=None) -> None:
    from mspi_tpu_torch.parallel import backend_for, launch, maybe_init_distributed

    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to train on the CPU")
    cfg = config_from_args(args)
    log_dir = os.path.join(args.log_dir, time.strftime(args.session_name + "_%Y%m%d-%H%M%S"))
    if maybe_init_distributed(backend_for(args.device)):
        return _run_joined(args, cfg, log_dir)
    n_dev = (torch.cuda.device_count() if torch.device(args.device).type == "cuda"
             else (args.dp or 1) * args.tp)
    dp, tp = mesh_shape(args.dp, args.tp, n_dev, cfg.train.batch_size)
    if dp * tp == 1:
        return run(args, cfg, log_dir)
    # the ranks unpickle _run_rank by this module's import name: run as
    # `python -m`, it is __main__, which spawn does not import again
    from mspi_tpu_torch.train import __main__ as cli

    launch(cli._run_rank, dp, tp, args.device, args, cfg, log_dir)


def _run_rank(mesh, args, cfg, log_dir: str) -> None:
    run(args, cfg, log_dir, mesh)


def _run_joined(args, cfg, log_dir: str) -> None:
    """This process as one rank of the group `maybe_init_distributed`
    joined: the mesh spans the world, each rank on the card of its rank
    modulo the host's cards, and the logs under rank 0's directory."""
    import torch.distributed as dist

    from mspi_tpu_torch.parallel import create_mesh

    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        dp, tp = mesh_shape(args.dp, args.tp, world, cfg.train.batch_size)
        if dp * tp != world:
            raise SystemExit(f"mesh dp {dp} x tp {tp} does not cover the {world} processes "
                             f"(dp divides the batch {cfg.train.batch_size})")
        device = torch.device(args.device)
        if device.type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        dirs = [log_dir]
        dist.broadcast_object_list(dirs, src=0)
        run(args, cfg, dirs[0], create_mesh((dp, tp), device))
    finally:
        dist.destroy_process_group()


def run(args, cfg, log_dir: str, mesh=None) -> None:
    """The training run on one device (mesh None) or as one rank of the
    mesh."""
    from mspi_tpu_torch.data.datasets import build_training_datasets
    from mspi_tpu_torch.data.loader import DataLoader
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel, VisualSaliencyModel
    from mspi_tpu_torch.parallel import data_rows, replicated, shard_sync_block
    from mspi_tpu_torch.train import checkpoints as ckpt_lib
    from mspi_tpu_torch.train.engine import (create_train_state, make_ddp_train_step,
                                             make_eval_step, make_train_step,
                                             step_lr_schedule, to_device)

    device = mesh.device if mesh is not None else torch.device(args.device)
    rank = mesh.rank if mesh is not None else 0
    use_sound = cfg.data.use_sound and args.dataset == "sound"
    seed = cfg.train.seed
    np.random.seed(seed)
    torch.manual_seed(seed)
    compute_dtype = torch.bfloat16 if args.bf16 else None

    checkpoint_dir = os.path.join(log_dir, "checkpoints")
    log_path = os.path.join(log_dir, "log")
    os.makedirs(checkpoint_dir, exist_ok=True)
    os.makedirs(log_path, exist_ok=True)

    dataset_train, dataset_val = build_training_datasets(
        cfg.data.root, args.split, cfg.data.num_frames, use_sound, cfg.data.resolution,
        seed=seed, native=args.native_loader)
    loader_train = DataLoader(dataset_train, cfg.train.batch_size, shuffle=True, drop_last=True,
                              num_workers=args.num_workers, seed=seed,
                              rows=data_rows(cfg.train.batch_size, mesh))
    loader_val = DataLoader(dataset_val, 1, num_workers=args.num_workers)

    model_cls = AudioVisualSaliencyModel if use_sound else VisualSaliencyModel
    model = model_cls(cfg, device=device, dtype=torch.float32,
                      generator=torch.Generator().manual_seed(seed))
    ckpt_lib.load_pretrained_encoders(cfg, model)
    if args.weights:
        model.load_state_dict(ckpt_lib.load_torch_checkpoint(args.weights), strict=False)
    if mesh is not None:  # every replica starts from rank 0's weights
        replicated(model.state_dict().values(), mesh)
        shard_sync_block(model, mesh)
    state = create_train_state(cfg, model)

    start_epoch = args.start_epoch
    if args.auto_resume:
        latest = ckpt_lib.latest_checkpoint(checkpoint_dir)
        if latest:
            state, start_epoch = ckpt_lib.restore_checkpoint(latest, state, mesh)
            print(f"Auto-resumed from {latest} at epoch {start_epoch}")

    if mesh is None:
        train_step = make_train_step(args.gamma, use_sound=use_sound,
                                     compute_dtype=compute_dtype)
    else:
        train_step = make_ddp_train_step(args.gamma, mesh, use_sound=use_sound,
                                         compute_dtype=compute_dtype)
    eval_step = make_eval_step(use_sound=use_sound, compute_dtype=compute_dtype)
    lr_by_epoch = step_lr_schedule(cfg.solver.lr, cfg.solver.max_epoch)
    n_parameters = sum(p.numel() for p in model.parameters() if p.requires_grad)
    if rank == 0:
        mesh_note = f", mesh dp {mesh.dp} tp {mesh.tp}" if mesh is not None else ""
        print(f"trainable parameters: {n_parameters / 1e6:.2f}M on {device}{mesh_note}")

    start_time = time.time()
    for epoch in range(start_epoch, cfg.solver.max_epoch):
        lr = lr_by_epoch[epoch]
        rows = []
        for i, batch in enumerate(loader_train):
            metrics = train_step(state, to_device(batch, device), lr)
            if not math.isfinite(metrics["loss"]):
                raise RuntimeError("Loss is NaN.")
            rows.append(dict(metrics, lr=lr))
            if i % 10 == 0 and rank == 0:
                print(f"Epoch: [{epoch}] [{i}/{len(loader_train)}] "
                      + " ".join(f"{k} {v:.4f}" for k, v in metrics.items()), flush=True)
        state.epoch = epoch + 1
        if args.save_ckpt and ((epoch + 1) % args.save_ckpt_freq == 0
                               or epoch + 1 == cfg.solver.max_epoch):
            ckpt_lib.save_checkpoint(checkpoint_dir, state, epoch + 1, mesh)
        log_stats = {f"train_{k}": v for k, v in _mean(rows).items()}
        if epoch + 1 in set(cfg.solver.monitored_epochs):
            val = [eval_step(state, to_device(batch, device))[1] for batch in loader_val]
            log_stats.update({f"val_{k}": v for k, v in _mean(val).items()})
        log_stats.update(epoch=epoch, n_parameters=n_parameters)
        if rank == 0:
            with open(os.path.join(log_path, "log.txt"), "a") as f:
                f.write(json.dumps(log_stats) + "\n")
    if rank == 0:
        print(f"Training time {datetime.timedelta(seconds=int(time.time() - start_time))}")


if __name__ == "__main__":
    main()
