"""Tensor parallelism of the fusion SyncBlock: counterpart of the JAX
package's `param_shardings` rules (`mspi_tpu/parallel/mesh.py:53-82`).

Megatron-style over the mesh's model group, on the SyncBlock's blocks only
(the conv towers, the backbone and the decoder stay replicated, as in the
JAX rules):

- attention: `qkv` split by output column, head by head, so each rank runs
  K4 on heads / tp heads; `proj` split by input row, its partial outputs
  summed by one all-reduce, the bias added once after it;
- MLP: `fc1` split by output column and `fc2` by input row, so each rank's
  K2 runs its LayerNorm (replicated) and H / tp hidden units with b2 = 0;
  one all-reduce sums the partial outputs and b2 is added after it. The
  kernel's hidden chunk is 64 units, so H / tp % 64 != 0 raises.

Autograd: `copy_to_model` (identity forward, all-reduce of the gradient)
stands before each split product, `reduce_from_model` (all-reduce forward,
identity backward) after it. K2's fused LayerNorm sees the residual stream
itself, so x, gamma and beta enter it through `copy_to_model`: their
gradients from each rank's hidden units are summed. Every replicated
parameter then gets the same gradient on every rank of the model group.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mspi_tpu_torch.ops.kernels.ln_mlp import SM90_HC, ln_mlp
from mspi_tpu_torch.ops.kernels.pooled_attention import self_attention
from mspi_tpu_torch.parallel.mesh import Mesh

# the parameters split over the model axis, by their name in a fusion Block:
# dim 0 (output columns of a Linear's [out, in] weight) or 1 (input rows)
SPLIT = {"attn.qkv.weight": 0, "attn.proj.weight": 1, "mlp.fc1.weight": 0,
         "mlp.fc1.bias": 0, "mlp.fc2.weight": 1}


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous()
        dist.all_reduce(dy, group=ctx.group)
        return dy, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return _ReduceFromModel.apply(x, group)


def _shard(t: torch.Tensor, dim: int, rank: int, tp: int, qkv: bool = False) -> torch.Tensor:
    """Rank `rank`'s part of t along dim; the qkv weight [3C, C] in each of
    its q, k and v thirds (so the shard is again [q | k | v])."""
    if qkv:
        return torch.cat([_shard(part, dim, rank, tp) for part in t.chunk(3, dim)], dim)
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).clone()


class TensorParallelBlock(nn.Module):
    """A fusion `Block` with its attention and MLP split over the model
    group; its parameters keep the Block's names at their shard's shape."""

    def __init__(self, block: nn.Module, mesh: Mesh):
        super().__init__()
        tp, r = mesh.tp, mesh.model_rank
        heads, hidden = block.attn.num_heads, block.mlp.fc1.out_features
        if heads % tp:
            raise ValueError(f"tp = {tp} does not divide the SyncBlock's {heads} heads")
        if hidden % (tp * SM90_HC):
            raise ValueError(f"tp = {tp}: H / tp = {hidden / tp:g} hidden units per rank, and "
                             f"K2 (ln_mlp) takes H % {SM90_HC} == 0")
        self.group, self.heads = mesh.model_group, heads // tp
        # the Block's order, so the parameters (and an optimizer's state
        # over them) come in a one-device model's order
        self.norm1, self.attn = block.norm1, block.attn
        self.norm2, self.mlp = block.norm2, block.mlp
        with torch.no_grad():
            for name, dim in SPLIT.items():
                mod_name, pname = name.rsplit(".", 1)
                mod = self.get_submodule(mod_name)
                shard = _shard(getattr(mod, pname), dim, r, tp, qkv=name == "attn.qkv.weight")
                setattr(mod, pname, nn.Parameter(shard))
                getattr(mod, pname).tp_sharded = True

    def forward(self, x):
        C = x.shape[-1]
        h = copy_to_model(self.norm1(x), self.group)
        w = self.attn.qkv.weight
        c = w.shape[0] // 3
        a = self_attention(F.linear(h, w[:c]), F.linear(h, w[c:]), self.heads)
        a = reduce_from_model(F.linear(a, self.attn.proj.weight), self.group)
        x = (x + a + self.attn.proj.bias).contiguous()
        g = self.group
        y = ln_mlp(copy_to_model(x, g), copy_to_model(self.norm2.weight, g),
                   copy_to_model(self.norm2.bias, g), self.mlp.fc1.weight, self.mlp.fc1.bias,
                   self.mlp.fc2.weight, torch.zeros(C, dtype=x.dtype, device=x.device),
                   self.norm2.eps)
        return x + reduce_from_model(y, g) + self.mlp.fc2.bias


def shard_sync_block(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Split every block of the model's SyncBlock over the mesh's model
    axis, in place (tp = 1: unchanged). Build the model with the same seed
    on every rank first: each rank keeps its part of the same weights."""
    if mesh.tp == 1:
        return model
    blocks = model.aud_vis_sync_block.blocks
    for i, block in enumerate(blocks):
        blocks[i] = TensorParallelBlock(block, mesh)
    return model


def _split_dim(name: str):
    """(dim, is qkv) of a split parameter by its name in the model."""
    suffix = name.split(".blocks.", 1)[1].split(".", 1)[1]
    return SPLIT[suffix], suffix == "attn.qkv.weight"


def split_whole(model: nn.Module, mesh: Mesh, tensors: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """The inverse of `gather_sync_block`: whole tensors by name (a
    one-device run's state dict, say) with the split parameters' cut to this
    model rank's part."""
    params = dict(model.named_parameters())
    out = {}
    for name, t in tensors.items():
        if getattr(params.get(name), "tp_sharded", False):
            dim, qkv = _split_dim(name)
            t = _shard(t, dim, mesh.model_rank, mesh.tp, qkv)
        out[name] = t
    return out


def gather_sync_block(model: nn.Module, mesh: Mesh,
                      tensors: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """`tensors` (by default the model's state dict; or, say, its
    parameters' gradients by name) with the split parameters' parts
    gathered over the model group into whole tensors. Every rank of the
    group calls it."""
    tensors = model.state_dict() if tensors is None else tensors
    params = dict(model.named_parameters())
    out = {}
    for name, t in tensors.items():
        if not getattr(params.get(name), "tp_sharded", False):
            out[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(mesh.tp)]
        dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
        dim, qkv = _split_dim(name)
        if qkv:  # each rank's [q | k | v]
            out[name] = torch.cat([torch.cat([q.chunk(3, dim)[j] for q in parts], dim)
                                   for j in range(3)], dim)
        else:
            out[name] = torch.cat(parts, dim)
    return out
