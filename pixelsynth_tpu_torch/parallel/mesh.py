"""The data mesh over processes (port of pixelsynth_tpu/parallel/mesh.py).

JAX shards the batch (or the candidate population) over one mesh data
axis and replicates the parameters; GSPMD then makes every sum global:
the gradients, the BatchNorm moments, the codebook EMA.  The port runs
one process a device under torch.distributed (parallel/distributed.py),
and a `Mesh` names this process's place in it: the world size, the rank,
the process group and the device.  `shard_batch` gives each rank its
contiguous slice of the global batch, `replicate` broadcasts rank 0's
parameters and buffers, and inside `with mesh:` the sums JAX makes global
are all-reduced over the group:
  * the gradients (`all_reduce_mean`, train/dpr.py `_grads`);
  * the BatchNorm moments (models/layers.py `batch_moments`, through an
    autograd-aware all-reduce, so their backward crosses ranks too);
  * the codebook EMA's sums (models/vqvae.py `Quantize._ema_update`);
  * the random draws of a batch row (`draw_rows`): NoiseBN noise, dropout
    and the sampler's noise are drawn for the global batch on every rank
    from the same generator and sliced, so they do not depend on the
    world size;
  * the sampler's loop condition (`any_over_ranks`, `max_over_ranks`), so
    every rank runs as many forwards, and draws, as the slowest.
A run on N processes with the global batch split N ways then computes what
one process computes on the whole batch.  Outside `with mesh:`, or
without a process group, nothing is reduced and a step is what it was.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

_ACTIVE: List["Mesh"] = []


class Mesh:
    """This process's place on the data axis: rank `rank` of `world_size`,
    its `device`, and `group`, the torch.distributed process group (None
    for a mesh of one process without one)."""

    def __init__(self, world_size: int, rank: int, group, device):
        self.world_size, self.rank, self.group = world_size, rank, group
        self.device = torch.device(device)

    @property
    def distributed(self) -> bool:
        """A process group exists: collectives run (even at world size 1)."""
        return self.group is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.pop()
        return False

    def barrier(self) -> None:
        if self.distributed:
            import torch.distributed as dist

            dist.barrier(group=self.group)

    def __repr__(self):
        return (f"Mesh(world_size={self.world_size}, rank={self.rank}, "
                f"device={self.device})")


def make_mesh(cfg=None, *, device=None, group=None) -> Mesh:
    """A mesh over the initialized process group (or `group`): every rank
    on the data axis; else a mesh of this one process without a group
    (whatever cfg's sizes).  cfg: config.MeshConfig; its data_parallel
    (-1: the group's size) must be the group's size, and a model axis
    (model_parallel > 1), which no sharding of the JAX package splits,
    is not implemented.  device: the process's device; by default its
    card under NCCL (the one `initialize_multihost` bound), the CPU under
    gloo, and "cuda" without a group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(1, 0, None, device if device is not None else "cuda")
    group = group if group is not None else dist.group.WORLD
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if getattr(cfg, "model_parallel", 1) > 1:
        raise NotImplementedError("mesh.model_parallel > 1: the port shards the "
                                  "data axis only")
    if getattr(cfg, "data_parallel", -1) not in (-1, world):
        raise ValueError(f"mesh.data_parallel={cfg.data_parallel}, but the group "
                         f"has {world} processes")
    if device is None:
        device = ("cpu" if dist.get_backend(group) == "gloo"
                  else torch.device("cuda", torch.cuda.current_device()))
    return Mesh(world, rank, group, device)


def active_mesh() -> Optional[Mesh]:
    """The innermost `with mesh:` whose mesh has a process group, or None."""
    for mesh in reversed(_ACTIVE):
        if mesh.distributed:
            return mesh
    return None


def data_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a leading axis of global size n (contiguous);
    ValueError when n does not divide by the world size."""
    if n % mesh.world_size:
        raise ValueError(f"a batch of {n} rows does not divide over "
                         f"{mesh.world_size} ranks")
    k = n // mesh.world_size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def _map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _tensor(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        import numpy as np

        x = torch.as_tensor(np.ascontiguousarray(x))
    return x.to(device)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """Every array leaf (numpy or tensor) -> this rank's contiguous slice of
    its leading axis, as a tensor on the mesh's device (dtype kept)."""
    return _map(lambda x: _tensor(x[data_sharding(mesh, len(x))], mesh.device), batch)


def shard_batch_multihost(batch: Any, mesh: Mesh) -> Any:
    """A batch each process loaded itself (its own shard of the global
    batch) -> tensors on the mesh's device, unsliced.  On one process, the
    same as `shard_batch`."""
    if mesh.world_size == 1:
        return shard_batch(batch, mesh)
    return _map(lambda x: _tensor(x, mesh.device), batch)


def _tensors_of(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors_of(v)]
    return []


@torch.no_grad()
def replicate(tree: Any, mesh: Mesh) -> Any:
    """Broadcast every tensor of `tree` (modules, their parameters and
    buffers, state dicts, lists) from rank 0, in place; returns `tree`."""
    if mesh.distributed:
        import torch.distributed as dist

        src = dist.get_global_rank(mesh.group, 0) if mesh.group is not dist.group.WORLD else 0
        for t in _tensors_of(tree):
            dist.broadcast(t.data, src=src, group=mesh.group)
    return tree


def sum_over_ranks(t: torch.Tensor, *, autograd: bool = False) -> torch.Tensor:
    """The sum of `t` over the ranks of the active mesh (`t` itself outside
    one).  autograd=True keeps the graph: the backward all-reduces the
    incoming gradient."""
    mesh = active_mesh()
    if mesh is None:
        return t
    import torch.distributed as dist

    if autograd:
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(t.contiguous(), group=mesh.group)
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=mesh.group)
    return t


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor's mean over the ranks of the active mesh (one flat
    all-reduce); the tensors themselves outside one."""
    tensors = list(tensors)
    mesh = active_mesh()
    if mesh is None or not tensors:
        return tensors
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.world_size
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t).to(t.dtype))
        i += t.numel()
    return out


def mean_over_ranks(metrics: dict) -> dict:
    """A dict of scalar tensors -> their means over the active mesh (the
    dict itself outside one)."""
    if active_mesh() is None:
        return metrics
    keys = list(metrics)
    vals = all_reduce_mean([torch.as_tensor(metrics[k]).detach().reshape(())
                            for k in keys])
    return {k: v.reshape(()) for k, v in zip(keys, vals)}


def any_over_ranks(flag: bool) -> bool:
    """`flag` or-ed over the ranks of the active mesh."""
    return max_over_ranks(int(bool(flag))) > 0


def max_over_ranks(n: int) -> int:
    """The largest `n` over the ranks of the active mesh."""
    mesh = active_mesh()
    if mesh is None:
        return int(n)
    import torch.distributed as dist

    t = torch.tensor([int(n)], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t.item())


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a sharded axis 0 -> the global rows, in data
    order, on every rank of the active mesh (`x` outside one)."""
    mesh = active_mesh()
    if mesh is None:
        return x
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, 0)


def draw_rows(draw: Callable, shape: Sequence[int], **kw) -> torch.Tensor:
    """draw(shape, **kw) (torch.rand or torch.randn with a generator) for a
    tensor whose axis 0 is this rank's rows of a sharded batch: inside an
    active mesh, the global batch's draw (on every rank, from the same
    generator) sliced to this rank's rows, so the numbers a row gets do
    not depend on the world size."""
    mesh = active_mesh()
    shape = tuple(shape)
    if mesh is None:
        return draw(shape, **kw)
    n = shape[0]
    full = draw((n * mesh.world_size,) + shape[1:], **kw)
    return full[mesh.rank * n:(mesh.rank + 1) * n]
