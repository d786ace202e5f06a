"""Data parallelism, FSDP and tensor-parallel serving over torch.distributed.

Counterpart of vivid_tpu/core/sharding.py, in PyTorch's idiom: the JAX
package lays a mesh over its devices and lets GSPMD place the collectives;
here each process drives one card and the collectives are explicit.

  * Data parallelism: every rank holds the whole state and its share of
    the global batch; after the backward pass `all_reduce_gradients`
    averages the gradients in a few flat buckets (a parameter the loss did
    not reach contributes zeros on every rank, so every rank sends the same
    buckets).
  * FSDP (ZeRO-3), `fsdp_shard`: `fully_shard` (FSDP2) on every U-Net
    `Block`, then on the root, over a one-dimensional mesh of all ranks.
    Each parameter, Adam moment and EMA copy is then a DTensor sharded on
    dim 0 (rows of a weight stay whole, which forced weight normalisation
    needs). FSDP2 refuses 0-dim parameters, so the gains stay replicated,
    outside it, and get the data-parallel average. `full_tensor` /
    `full_state_dict` gather shards into whole tensors (snapshots,
    checkpoints, the consistency fingerprint): a collective, on every rank;
    `load_full` copies a whole tensor into a rank's shard.
  * Tensor parallelism (`tensor_parallel`, evaluation only): Megatron-style
    within groups of `tp` consecutive ranks (`tp_groups`). In a block's
    residual branch `conv_res0` and `emb_linear` keep this rank's output
    channels and `conv_res1` the matching input channels; in its attention
    branch `attn_qkv` / `x_attn_kv` keep the rows of this rank's heads,
    `epipolar_mixing` their columns, and `attn_proj` their input columns.
    One all-reduce (fp32) after each branch sums the partial products. Every
    weight is normalised whole and then sliced (`nn/mp.py` `MPConv`): a
    slice of a weight's input channels has another norm. A block whose head
    count or channel count `tp` does not divide runs whole on every rank,
    as the JAX package leaves such dims unsharded.
"""

from dataclasses import dataclass
from typing import List

import torch
from torch.distributed.tensor import DTensor

BUCKET_ELEMENTS = 1 << 26   # values in one gradient all-reduce (256 MB of fp32)


def is_sharded(t) -> bool:
    return isinstance(t, DTensor)


def local(t):
    """This rank's part of `t`: the local shard of a DTensor (a view: writing
    to it writes to the DTensor), `t` itself otherwise. Call under no_grad."""
    return t.to_local() if is_sharded(t) else t


def full_tensor(t):
    """`t` whole: a DTensor gathered from every rank (a collective), any
    other tensor as it is."""
    return t.full_tensor() if is_sharded(t) else t


def full_state_dict(tree):
    """`tree` (dicts and lists of tensors and plain values) with every
    DTensor gathered whole; the counterpart of `unshard_tree`."""
    if isinstance(tree, dict):
        return {k: full_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [full_state_dict(v) for v in tree]
    return full_tensor(tree) if torch.is_tensor(tree) else tree


def load_full(target, full):
    """Copy the whole tensor `full` into `target`: into this rank's shard
    when `target` is a DTensor sharded on dim 0, else all of it."""
    with torch.no_grad():
        if not is_sharded(target):
            target.copy_(full)
            return
        mesh = target.device_mesh
        chunks = torch.chunk(full, mesh.size(), dim=0)
        rank = mesh.get_local_rank()
        part = chunks[rank] if rank < len(chunks) else full[:0]
        shard = target.to_local()
        if part.shape != shard.shape:
            raise ValueError(f"shard of {tuple(full.shape)} on rank {rank}: "
                             f"{tuple(part.shape)}, the parameter holds {tuple(shard.shape)}")
        shard.copy_(part)


def all_reduce_gradients(grads: List[torch.Tensor], group=None):
    """Average `grads` (tensors, not DTensors) over `group`, in place: one
    all-reduce per bucket of at most BUCKET_ELEMENTS values of one dtype."""
    world = torch.distributed.get_world_size(group)
    buckets, current, size = [], [], 0
    for g in sorted(grads, key=lambda g: str(g.dtype)):
        if current and (size + g.numel() > BUCKET_ELEMENTS or g.dtype != current[0].dtype):
            buckets.append(current)
            current, size = [], 0
        current.append(g)
        size += g.numel()
    if current:
        buckets.append(current)
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        torch.distributed.all_reduce(flat, group=group)
        flat.div_(world)
        for g, part in zip(bucket, flat.split([g.numel() for g in bucket])):
            g.copy_(part.view_as(g))


def fsdp_shard(net: torch.nn.Module):
    """Shard `net` over every rank (FSDP2): each U-Net `Block` is one unit,
    the root holds the rest; 0-dim parameters stay replicated. Returns
    `net`. Build the training state after this call."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from vivid_tpu_torch.nn.blocks import Block
    device = next(net.parameters()).device
    mesh = init_device_mesh(device.type, (torch.distributed.get_world_size(),))
    scalars = {p for p in net.parameters() if p.ndim == 0}
    for module in net.modules():
        if isinstance(module, Block):
            fully_shard(module, mesh=mesh, ignored_params=scalars)
    fully_shard(net, mesh=mesh, ignored_params=scalars)
    return net


@dataclass(frozen=True)
class TPShard:
    """This rank's part of one block under tensor parallelism."""
    group: object
    size: int        # ranks in the group
    index: int       # this rank's place in it
    channels: int    # the block's output channels
    heads: int       # its attention heads (0 without attention)

    @property
    def local_channels(self) -> slice:
        n = self.channels // self.size
        return slice(self.index * n, (self.index + 1) * n)

    @property
    def local_heads(self) -> slice:
        n = self.heads // self.size
        return slice(self.index * n, (self.index + 1) * n)

    def all_reduce(self, y):
        """The sum of every rank's partial product `y`, taken in fp32."""
        out = y.float()
        torch.distributed.all_reduce(out, group=self.group)
        return out.to(y.dtype)


def tp_groups(tp: int):
    """(group, index in it, data group, data group count) of this rank when
    the ranks form tensor-parallel groups of `tp` consecutive ranks. Every
    rank creates every group (a collective)."""
    world, rank = torch.distributed.get_world_size(), torch.distributed.get_rank()
    if tp < 2 or world % tp:
        raise ValueError(f"tp={tp} needs a multiple of {tp} ranks (world size {world})")
    mine = None
    for start in range(0, world, tp):
        g = torch.distributed.new_group(list(range(start, start + tp)))
        if start <= rank < start + tp:
            mine = g
    return mine, rank % tp, rank // tp, world // tp


def tensor_parallel(net: torch.nn.Module, group):
    """Split every block of `net` whose channels and heads the size of
    `group` divides over the ranks of `group`, for evaluation; the others
    stay whole. Returns `net`, in eval mode."""
    from vivid_tpu_torch.nn.blocks import Block
    size = torch.distributed.get_world_size(group)
    index = torch.distributed.get_group_rank(group, torch.distributed.get_rank())
    for module in net.modules():
        if isinstance(module, Block):
            cfg = module.cfg
            heads = cfg.num_heads
            whole = cfg.out_channels % size or (heads and heads % size)
            module.tp = None if whole else TPShard(group, size, index, cfg.out_channels,
                                                   heads)
    return net.eval()
