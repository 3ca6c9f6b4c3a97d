"""One rank of the port's multi-process training tests (gloo on the CPU).

    python -m tests.torch_dist_worker step IO_DIR RANK WORLD PORT DP TP
    python -m tests.torch_dist_worker cls IO_DIR RANK WORLD PORT DP

step: reads IO_DIR/in.pt (the model's overrides and state dict, the global
batch, the LR), joins a gloo group over tcp://localhost:PORT, builds the
(DP, TP) mesh and the port's AV model (the weights loaded on data rank 0
and broadcast to the other replicas by `parallel.replicated`), splits its
SyncBlock over TP, takes its shard of the batch and runs one
`make_ddp_train_step` with the tests' fixed drop-path masks, counting the
step's `all_reduce` calls. Then it saves a checkpoint of the mesh
(`save_checkpoint`) and resumes a fresh split model from it. Rank 0 writes
IO_DIR/out.pt: the metrics, the gradients and the state dict after the
step (the split tensors gathered), the count, the checkpoint's path and
whether the resumed state equals the saved one on every rank.

cls: `run_classification_training` of `ToyClassifier` on `ToyClips` over
DP data ranks, 2 epochs at batch 4; rank 0 writes IO_DIR/cls_out.pt, the
history. `cls_history` runs the same without a mesh. Imports no JAX.
"""

import sys

import torch
import torch.distributed as dist


def fixed_drop_path(self, x):
    """The tests' drop-path: in train mode, blocks with rate > 0.1 drop
    sample 1, every kept sample scaled by 1 / (1 - rate)."""
    if not self.training or self.rate == 0.0:
        return x
    mask = torch.tensor([not (b == 1 and self.rate > 0.1) for b in range(x.shape[0])])
    mask = mask.view(-1, *([1] * (x.dim() - 1)))
    return torch.where(mask, x / (1.0 - self.rate), torch.zeros_like(x))


class ToyClassifier(torch.nn.Module):
    """A linear classifier on the clip's mean colour, with the zoo's
    contract: logits in training, the softmax at eval."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(3, 4)

    def forward(self, clips, generator=None):
        logits = self.fc(clips.mean(dim=(1, 2, 3)))
        return logits if self.training else torch.softmax(logits, -1)


class ToyClips:
    """12 clips [2, 4, 4, 3] of uint8 made from their index, label i % 4,
    counting the samples it decodes."""

    def __init__(self):
        self.loaded = 0

    def __len__(self):
        return 12

    def __getitem__(self, i):
        import numpy as np

        self.loaded += 1
        clip = np.random.default_rng(i).integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
        return {"clips": clip, "labels": i % 4}


def cls_history(mesh=None):
    """(history, train samples decoded) of 2 epochs of SGD at batch 4."""
    from mspi_tpu_torch.train import classification, optim

    torch.manual_seed(0)
    datasets = []

    def make_dataset(split, num_frames, crop):
        datasets.append((split, ToyClips()))
        return datasets[-1][1]

    _, history = classification.run_classification_training(
        ToyClassifier(), lambda p: optim.construct_optimizer(p, "sgd", 0.1), make_dataset,
        epochs=2, batch_size=4, lr_policy=lambda e: 0.1, base_t=2, base_crop=4, mesh=mesh,
        log=lambda s: None)
    return history, sum(ds.loaded for split, ds in datasets if split == "train")


def cls_main(io_dir: str, rank: int, world: int, port: int, dp: int) -> None:
    from mspi_tpu_torch.parallel import create_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    history, loaded = cls_history(create_mesh((dp, 1), "cpu"))
    if rank == 0:
        torch.save({"history": history, "loaded": loaded}, f"{io_dir}/cls_out.pt")
    dist.destroy_process_group()


def main(io_dir: str, rank: int, world: int, port: int, dp: int, tp: int) -> None:
    from mspi_tpu_torch.config import get_config
    from mspi_tpu_torch.models.fusion import AudioVisualSaliencyModel
    from mspi_tpu_torch.ops import layers
    from mspi_tpu_torch.parallel import batch_shard, create_mesh, replicated, shard_sync_block
    from mspi_tpu_torch.parallel.tensor_parallel import gather_sync_block
    from mspi_tpu_torch.train import checkpoints, engine

    torch.set_num_threads(1)
    layers.DropPath.forward = fixed_drop_path
    blob = torch.load(f"{io_dir}/in.pt", weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    mesh = create_mesh((dp, tp), "cpu")
    cfg = get_config("mvitv2s", blob["overrides"])
    model = AudioVisualSaliencyModel(cfg, device="cpu")
    if mesh.data_rank == 0:  # the other replicas take these weights from `replicated`
        model.load_state_dict(blob["state_dict"])
    replicated(model.state_dict().values(), mesh)
    shard_sync_block(model, mesh)
    state = engine.create_train_state(cfg, model)
    step = engine.make_ddp_train_step(1.0, mesh)
    batch = batch_shard(blob["batch"], mesh)

    calls = []
    all_reduce = dist.all_reduce

    def counting(*args, **kwargs):
        calls.append(1)
        return all_reduce(*args, **kwargs)
    dist.all_reduce = counting
    metrics = step(state, batch, blob["lr"])
    dist.all_reduce = all_reduce

    params = dict(model.named_parameters())
    grads = gather_sync_block(model, mesh, {n: params[n].grad for n in state.param_names})
    states = gather_sync_block(model, mesh)

    # the checkpoint round trip: rank 0 writes the whole tensors, every rank
    # resumes its part of them into a fresh split model
    path = checkpoints.save_checkpoint(io_dir, state, 1, mesh)
    dist.barrier()
    fresh = AudioVisualSaliencyModel(cfg, device="cpu")
    shard_sync_block(fresh, mesh)
    resumed, _ = checkpoints.restore_checkpoint(f"{io_dir}/ckpt_1", engine.create_train_state(
        cfg, fresh), mesh)
    same = all(torch.equal(v, fresh.state_dict()[k]) for k, v in model.state_dict().items())
    moments = state.optimizer.state_dict()["state"]
    for i, st in resumed.optimizer.state_dict()["state"].items():
        same &= all(torch.equal(v, moments[i][k]) for k, v in st.items())
    same = torch.tensor(float(same))
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    if rank == 0:
        torch.save({"metrics": metrics, "grads": grads, "state_dict": states,
                    "all_reduce": len(calls), "ckpt": path, "resumed": bool(same)},
                   f"{io_dir}/out.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    entry = {"step": main, "cls": cls_main}[sys.argv[1]]
    entry(sys.argv[2], *map(int, sys.argv[3:]))
