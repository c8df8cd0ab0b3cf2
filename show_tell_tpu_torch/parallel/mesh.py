"""The data-parallel mesh over torch.distributed (counterpart of
show_tell_tpu/parallel/mesh.py).

The JAX package lays one ``jax.sharding.Mesh`` with a ``dp`` axis over its
devices and lets GSPMD reduce over the global batch.  The port runs one
process per device: a ``Mesh`` is this process's rank among ``dp`` ranks,
each batch's rows are split into ``dp`` contiguous shares
(``shard_rows``), the trainable gradients are averaged by
``DistributedDataParallel`` (train/train_step.py), and what GSPMD reduced
over the global batch is reduced here explicitly, on a process group of
its own so it never interleaves with DDP's bucket all-reduces:

  * train-mode BatchNorm statistics (``synced_batch_norm``: the mean,
    then the centred sum of squares, over every rank's rows; the head's
    BatchNorm1d differentiably, through ``all_reduce_sum``);
  * the train step's loss and the eval's loss, ids and score tables
    (train/train_step.py, evaluation/tester.py).

The masked mean CE and the attention penalty need no collective: their
denominators count the global batch's tokens and rows, which each rank
reads from the global batch's lengths (``models/captioner.decoder_loss``,
``batch_lengths``).

There is no counterpart of ``decoder_param_shardings`` /
``shard_train_state(tensor_parallel=True)`` yet: ``mp`` > 1 raises.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from show_tell_tpu_torch.parallel.multihost import process_count, process_index

MP_ITEM = "ROADMAP Queue 1 item 6"  # where tensor parallelism (mp > 1) waits
_GROUP: List = [None, None]  # (the default group it was made beside, the mesh's group)


class Mesh:
    """This process's place in a data-parallel mesh: ``rank`` of ``dp``,
    the process group of the mesh's own collectives (``group``), and the
    device that group's collectives take host tensors on (``device``:
    CUDA under nccl, the CPU under gloo)."""

    def __init__(self, dp: int, rank: int, group: Optional[dist.ProcessGroup], device: torch.device):
        self.dp, self.rank, self.group, self.device = dp, rank, group, device

    def __repr__(self) -> str:
        return "Mesh(dp=%d, rank=%d, device=%s)" % (self.dp, self.rank, self.device)

    def __deepcopy__(self, memo):  # a model deep-copied for the bf16 eval keeps its BatchNorms' mesh
        return self


def _mesh_group() -> dist.ProcessGroup:
    """One process group beside the default one, made once per default group
    (every rank calls make_mesh at the same points, so they make it together)."""
    if _GROUP[0] is not dist.group.WORLD:
        _GROUP[:] = [dist.group.WORLD, dist.new_group(backend=dist.get_backend())]
    return _GROUP[1]


def make_mesh(dp: int = 0, mp: int = 1, device: Optional[torch.device] = None) -> Mesh:
    """dp=0 means every process of the group (one device each).  Raises
    for a mesh the processes cannot form: more devices than processes, or
    fewer (a process would own no share of a batch); and for mp > 1.
    Outside a process group the mesh is one device with no collectives.
    ``device``: this process's device, where nccl takes host tensors."""
    world = process_count()
    if mp > 1:
        raise NotImplementedError("mp=%d (tensor parallelism over the vocabulary) is %s; the port's mesh is data "
                                  "parallel only" % (mp, MP_ITEM))
    if dp <= 0:
        dp = world // mp
    if dp * mp > world:
        raise ValueError(
            "mesh dp=%d x mp=%d needs %d devices but only %d are visible" % (dp, mp, dp * mp, world)
        )
    if world > 1 and dp * mp != world:
        counts = {p: 1 for p in range(dp * mp)}
        raise ValueError(
            "multi-host mesh (dp=%d, mp=%d) covers processes unevenly "
            "(%s of %d processes); every process must own the same number "
            "of mesh devices — use dp*mp == the process count (= %d) or "
            "run single-host" % (dp, mp, counts, world, world)
        )
    if not dist.is_initialized():
        return Mesh(dp, 0, None, torch.device("cpu"))
    if device is None:
        device = torch.device("cpu")
    collective = device if dist.get_backend() == "nccl" else torch.device("cpu")
    return Mesh(dp, process_index(), _mesh_group(), collective)


def active(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` where it is one of a process group (a one-rank group
    included: it runs DDP and the collectives, each over itself), else None."""
    return mesh if mesh is not None and mesh.group is not None else None


def shard_rows(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous rows of a batch of ``n``."""
    if n % mesh.dp:
        raise ValueError("a batch of %d rows does not divide over dp=%d" % (n, mesh.dp))
    share = n // mesh.dp
    return slice(mesh.rank * share, (mesh.rank + 1) * share)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each array (numpy or tensors), the leading axis split over dp."""
    out = tuple(a[shard_rows(mesh, len(a))] for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0, in place."""
    if active(mesh) is not None:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, 0, group=mesh.group)
    return module


class _AllReduceSum(torch.autograd.Function):
    """The sum over ranks; its gradient is the sum over ranks of the
    gradients (each rank's output feeds its own share of the loss)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.detach().clone().contiguous()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = g.clone().contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, differentiable."""
    return _AllReduceSum.apply(x, mesh.group)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along axis 0 in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.dp)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def sum_tables(table: np.ndarray, mesh: Optional[Mesh]) -> np.ndarray:
    """The element-wise sum of a float64 table over the ranks.  Each row
    is filled by exactly one rank and is +0.0 on the others, so the sum
    is the full table, bit for bit: gathered as float64 (gloo and nccl
    carry it), never through float32."""
    if active(mesh) is None:
        return table
    t = torch.from_numpy(np.ascontiguousarray(table, np.float64)).to(mesh.device)
    parts = [torch.empty_like(t) for _ in range(mesh.dp)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.stack(parts).sum(0).cpu().numpy()


def any_rank(flag: bool, mesh: Optional[Mesh]) -> bool:
    """True on every rank when ``flag`` is True on any (a SIGTERM reaches one process)."""
    if active(mesh) is None:
        return bool(flag)
    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item())


def synced_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                      running_var: torch.Tensor, momentum: float, eps: float, mesh: Mesh) -> torch.Tensor:
    """Train-mode BatchNorm over axis 1 of [B, C, ...] with the statistics
    of every rank's rows (the JAX package's ``_bn(training=True)`` over
    its global batch): the mean, then the mean of the squared deviations
    (two reductions, as ``jnp.var``); the running statistics move by
    ``momentum`` towards the mean and the unbiased variance (n = every
    rank's rows x the spatial size).  Computed in f32, returned in x's
    dtype; differentiable through the statistics."""
    axes = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    xf = x.float()
    n = xf.numel() // xf.shape[1] * mesh.dp  # equal shares
    mean = all_reduce_sum(xf.sum(axes), mesh) / n
    xc = xf - mean.view(shape)
    var = all_reduce_sum((xc * xc).sum(axes), mesh) / n
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(mean.detach(), alpha=momentum)
        running_var.mul_(1 - momentum).add_(var.detach() * (n / max(n - 1, 1)), alpha=momentum)
    return (xc * (torch.rsqrt(var + eps) * weight).view(shape) + bias.view(shape)).to(x.dtype)

