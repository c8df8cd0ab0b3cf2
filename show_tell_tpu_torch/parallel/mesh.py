"""The dp x mp mesh over torch.distributed (counterpart of
show_tell_tpu/parallel/mesh.py).

The JAX package lays one ``jax.sharding.Mesh`` with a ``dp`` and an ``mp``
axis over its devices (``devs.reshape(dp, mp)``) and lets GSPMD insert the
collectives.  The port runs one process per device and lays the ranks out
the same way: rank r is (dp_rank, mp_rank) = divmod(r, mp).  A ``Mesh`` is
this process's place in it, with one process group for each axis, made
once by every rank at the same point and never DDP's (the default group),
so the mesh's collectives never interleave with DDP's bucket all-reduces.

The dp axis: each batch's rows are split into ``dp`` contiguous shares
(``shard_rows``), the trainable gradients are averaged by
``DistributedDataParallel`` (train/train_step.py), and what GSPMD reduced
over the global batch is reduced here explicitly, on the dp group:

  * train-mode BatchNorm statistics (``synced_batch_norm``: the mean,
    then the centred sum of squares, over every rank's rows; the head's
    BatchNorm1d differentiably, through ``all_reduce_sum``);
  * the train step's loss and the eval's loss, ids and score tables
    (train/train_step.py, evaluation/tester.py), and serving's ids
    (serve.py).

The masked mean CE and the attention penalty need no collective: their
denominators count the global batch's tokens and rows, which each rank
reads from the global batch's lengths (``models/captioner.decoder_loss``,
``batch_lengths``).

The mp axis shards the vocabulary (the counterpart of
``decoder_param_shardings``): ``decoder_vocab_shard`` gives a rank its
V/mp columns of the output projection (rows of ``decoder.linear``'s torch
[V, H] weight, and of its bias) and its V/mp rows of the embedding; the
recurrence, the attention and the encoder stay replicated.  The ranks of
an mp group hold the same batch rows and run the same recurrence; what
reduces over the vocabulary is a collective on the mp group
(``vocab_argmax``, ``vocab_log_softmax``, ``vocab_logsumexp``,
``vocab_target_logit``, ``vocab_topk``, ``vocab_embedding``).  A failed
collective raises: nothing falls back to an unsharded decode.  Training
stays data-parallel only, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from show_tell_tpu_torch.parallel.multihost import process_count, process_index

_GROUPS: Dict = {}  # "world": the default group they were made beside; (dp, mp): (dp groups, mp groups)
PAD_LOGIT = -1e9  # the bias of a padded vocabulary column (show_tell_tpu/serve.py:93-106)


class Mesh:
    """This process's place in a dp x mp mesh: ``dp_rank`` of ``dp`` along
    the batch axis, ``mp_rank`` of ``mp`` along the vocabulary axis;
    ``group``, the process group of the dp axis (the ranks that share this
    rank's mp_rank), ``mp_group``, that of the mp axis (the ranks that share
    its dp_rank; None for mp = 1); and the device their collectives take
    tensors on (``device``: CUDA under nccl, the CPU under gloo)."""

    def __init__(self, dp: int, dp_rank: int, group: Optional[dist.ProcessGroup], device: torch.device,
                 mp: int = 1, mp_rank: int = 0, mp_group: Optional[dist.ProcessGroup] = None):
        self.dp, self.dp_rank, self.group, self.device = dp, dp_rank, group, device
        self.mp, self.mp_rank, self.mp_group = mp, mp_rank, mp_group

    def __repr__(self) -> str:
        return "Mesh(dp=%d, mp=%d, dp_rank=%d, mp_rank=%d, device=%s)" % (self.dp, self.mp, self.dp_rank,
                                                                           self.mp_rank, self.device)

    def __deepcopy__(self, memo):  # a model deep-copied for the bf16 eval keeps its BatchNorms' mesh
        return self


def _axis_groups(dp: int, mp: int) -> Tuple[List, List]:
    """The dp groups (one for each mp_rank m: ranks d * mp + m over d) and
    the mp groups (one for each dp_rank d: ranks d * mp + m over m), made
    once per default group and mesh shape.  new_group wants every rank to
    make every group in one order, so every rank calls make_mesh at the
    same points."""
    if _GROUPS.get("world") is not dist.group.WORLD:
        _GROUPS.clear()
        _GROUPS["world"] = dist.group.WORLD
    if (dp, mp) not in _GROUPS:
        backend = dist.get_backend()
        dp_groups = [dist.new_group([d * mp + m for d in range(dp)], backend=backend) for m in range(mp)]
        mp_groups = ([dist.new_group([d * mp + m for m in range(mp)], backend=backend) for d in range(dp)]
                     if mp > 1 else [None] * dp)
        _GROUPS[(dp, mp)] = (dp_groups, mp_groups)
    return _GROUPS[(dp, mp)]


def make_mesh(dp: int = 0, mp: int = 1, device: Optional[torch.device] = None) -> Mesh:
    """dp=0 means every process of the group, divided by mp (one device
    each).  Raises for a mesh the processes cannot form: more devices than
    processes, or fewer (a process would own no share of a batch).
    Outside a process group the mesh is one device with no collectives.
    ``device``: this process's device, where nccl takes tensors."""
    world = process_count()
    if dp <= 0:
        dp = max(1, world // mp)
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
    dp_rank, mp_rank = divmod(process_index(), mp)
    dp_groups, mp_groups = _axis_groups(dp, mp)
    return Mesh(dp, dp_rank, dp_groups[mp_rank], collective, mp, mp_rank, mp_groups[dp_rank])


def active(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` where it is one of a process group (a one-rank group
    included: it runs DDP and the collectives, each over itself), else None."""
    return mesh if mesh is not None and mesh.group is not None else None


def shard_rows(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous rows of a batch of ``n`` (its dp_rank's share)."""
    if n % mesh.dp:
        raise ValueError("a batch of %d rows does not divide over dp=%d" % (n, mesh.dp))
    share = n // mesh.dp
    return slice(mesh.dp_rank * share, (mesh.dp_rank + 1) * share)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each array (numpy or tensors), the leading axis split over dp."""
    out = tuple(a[shard_rows(mesh, len(a))] for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from the dp
    group's first rank (dp_rank 0: global rank mp_rank), in place."""
    if active(mesh) is not None:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, mesh.mp_rank, group=mesh.group)
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
    """The sum of ``x`` over the dp axis's ranks, differentiable."""
    return _AllReduceSum.apply(x, mesh.group)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every dp rank's ``x`` (the same shape on each) concatenated along axis 0 in dp_rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.dp)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def sum_tables(table: np.ndarray, mesh: Optional[Mesh]) -> np.ndarray:
    """The element-wise sum of a float64 table over the dp axis's ranks.
    Each row is filled by exactly one of them and is +0.0 on the others
    (the ranks of an mp group fill the same rows), so the sum is the full
    table, bit for bit: gathered as float64 (gloo and nccl carry it),
    never through float32."""
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
    for group in (mesh.group, mesh.mp_group):
        if group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
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


# ----------------------------------------------------------------------------------------------------------------
# The mp axis: the vocabulary shard and its collectives


class VocabShard(NamedTuple):
    """A rank's share of the (padded) vocabulary: columns ``lo`` ..
    ``lo + size - 1`` of ``padded`` = mp x size."""

    mesh: Mesh
    lo: int
    size: int
    padded: int


def decoder_vocab_shard(mesh: Mesh, decoder: nn.Module, pad: bool = True) -> VocabShard:
    """Keep only this rank's vocabulary shard of ``decoder`` (the pooled or
    the attention decoder), in place (the counterpart of
    ``decoder_param_shardings``'s rule for ``decoder.linear`` and
    ``decoder.embedding``): ``decoder.linear`` becomes [V/mp, H] and its
    bias [V/mp] (the mp_rank-th share of the torch weight's rows, which are
    the JAX weight's columns), ``decoder.embeddings`` [V/mp, E], and
    ``decoder.vocab_shard`` the returned VocabShard, which the decode and
    loss routes read.  A V that mp does not divide is padded first, as the
    JAX Captioner pads it (show_tell_tpu/serve.py:93-106): zero weight
    rows, bias PAD_LOGIT (so a padded column never wins, and stays finite
    in bf16), zero embedding rows; ``pad=False`` raises there instead.
    On a one-process mesh (mp = 1) the shard is the whole vocabulary and its
    collectives are the identity: the sharded route on one device."""
    w, b, emb = decoder.linear.weight.detach(), decoder.linear.bias.detach(), decoder.embeddings.weight.detach()
    V, H = w.shape
    E = emb.shape[1]
    padded = -(-V // mesh.mp) * mesh.mp
    if padded != V:
        if not pad:
            raise ValueError("mp=%d does not divide the vocabulary (V=%d)" % (mesh.mp, V))
        n = padded - V
        w = torch.cat([w, w.new_zeros(n, H)])
        b = torch.cat([b, b.new_full((n,), PAD_LOGIT)])
        emb = torch.cat([emb, emb.new_zeros(n, E)])
    size = padded // mesh.mp
    lo = mesh.mp_rank * size
    rows = slice(lo, lo + size)
    linear = nn.Linear(H, size, dtype=w.dtype, device=w.device)
    embeddings = nn.Embedding(size, E, dtype=emb.dtype, device=emb.device)
    with torch.no_grad():
        linear.weight.copy_(w[rows])
        linear.bias.copy_(b[rows])
        embeddings.weight.copy_(emb[rows])
    decoder.linear = linear.requires_grad_(False)
    decoder.embeddings = embeddings.requires_grad_(False)
    decoder.vocab_shard = VocabShard(mesh, lo, size, padded)
    return decoder.vocab_shard


def _on_mesh(shard: VocabShard, x: torch.Tensor) -> torch.Tensor:
    return x.to(shard.mesh.device).contiguous()


def _mp_all_reduce(shard: VocabShard, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the mp group, back on x's device (a one-rank shard: ``x``)."""
    if shard.mesh.mp == 1:
        return x
    y = _on_mesh(shard, x)
    dist.all_reduce(y, op=op, group=shard.mesh.mp_group)
    return y.to(x.device)


def _mp_all_gather(shard: VocabShard, x: torch.Tensor) -> torch.Tensor:
    """Every mp rank's ``x`` stacked on a new leading axis in mp_rank order, on x's device."""
    if shard.mesh.mp == 1:
        return x[None]
    y = _on_mesh(shard, x)
    parts = [torch.empty_like(y) for _ in range(shard.mesh.mp)]
    dist.all_gather(parts, y, group=shard.mesh.mp_group)
    return torch.stack(parts).to(x.device)


def vocab_argmax(shard: VocabShard, logits: torch.Tensor) -> torch.Tensor:
    """The first-max argmax over the whole vocabulary of this rank's f32
    logit columns [B, size], as [B] int32 global ids, the same on every
    rank of the mp group: each shard's first max and its global index,
    gathered (as float64 pairs, exact for both), then the first shard that
    holds the largest value.  Shards lie in index order, so of equal
    maxima the lower global index wins, as ``jnp.argmax`` over the whole
    row picks it.  One collective."""
    idx = torch.argmax(logits, dim=-1)
    val = logits.gather(-1, idx[:, None])[:, 0]
    pairs = _mp_all_gather(shard, torch.stack([val.double(), (idx + shard.lo).double()], dim=-1))  # [mp, B, 2]
    win = torch.argmax(pairs[..., 0], dim=0)  # the first shard of the largest value
    return pairs[..., 1].gather(0, win[None])[0].to(torch.int32)


def _max_and_sumexp(shard: VocabShard, logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole row's max and its sum of exp(x - max), over the last axis: two collectives."""
    m = _mp_all_reduce(shard, logits.max(dim=-1, keepdim=True).values, dist.ReduceOp.MAX)
    s = _mp_all_reduce(shard, torch.exp(logits - m).sum(dim=-1, keepdim=True))
    return m, s


def vocab_log_softmax(shard: VocabShard, logits: torch.Tensor) -> torch.Tensor:
    """This rank's columns of the f32 log_softmax over the whole vocabulary
    (the last axis): x - max - log(sum exp(x - max)), the max and the sum
    taken over the mp group, as torch.log_softmax takes them over a row."""
    m, s = _max_and_sumexp(shard, logits)
    return logits - m - torch.log(s)


def vocab_logsumexp(shard: VocabShard, logits: torch.Tensor) -> torch.Tensor:
    """logsumexp over the whole vocabulary (the last axis, dropped) of this rank's f32 logit columns."""
    m, s = _max_and_sumexp(shard, logits)
    return (m + torch.log(s))[..., 0]


def _owned(shard: VocabShard, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(whether this rank owns each global id, its local index, clamped into the shard)."""
    local = ids.long() - shard.lo
    own = (local >= 0) & (local < shard.size)
    return own, local.clamp(0, shard.size - 1)


def vocab_target_logit(shard: VocabShard, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits[..., targets] for global target ids, from this rank's columns
    [..., size]: the owning shard's value, zeros elsewhere, summed over the
    mp group (exact: one addend is nonzero)."""
    own, local = _owned(shard, targets)
    part = torch.where(own, logits.gather(-1, local[..., None])[..., 0], 0.0)
    return _mp_all_reduce(shard, part)


def vocab_embedding(shard: VocabShard, tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The embedding rows of global ids ``tokens`` from this rank's rows of
    the table [size, E]: the owning shard's row, zeros elsewhere, summed in
    f32 over the mp group (exact: one addend is nonzero) and returned in the
    table's dtype."""
    own, local = _owned(shard, tokens)
    rows = table.index_select(0, local.reshape(-1)).reshape(*tokens.shape, table.shape[1])
    return _mp_all_reduce(shard, torch.where(own[..., None], rows.float(), 0.0)).to(table.dtype)


def vocab_topk(shard: VocabShard, cand: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best of each batch row's candidates over the whole vocabulary:
    ``cand`` [B, R, size] is this rank's columns of R rows of scores an
    image, whose global index is r x padded + lo + column.  Returns (values
    [B, k] f32, global indices [B, k] int32), ordered by value descending
    and, among equal values, by global index ascending: ``jax.lax.top_k``'s
    order over the [B, R x padded] row.  Each shard's own k best by that
    rule (``stable_topk``, whose local order is the global one), gathered
    (float64 pairs, one collective), then the k best of the mp x k; the
    global k best are among them."""
    from show_tell_tpu_torch.ops.vocab import stable_topk

    B, R, size = cand.shape
    vals, idx = stable_topk(cand.reshape(B, R * size), k)
    idx = idx.long()
    gidx = idx // size * shard.padded + shard.lo + idx % size
    pairs = _mp_all_gather(shard, torch.stack([vals.double(), gidx.double()], dim=-1))  # [mp, B, k, 2]
    pairs = pairs.permute(1, 0, 2, 3).reshape(B, shard.mesh.mp * k, 2)
    by_index = torch.argsort(pairs[..., 1], dim=1, stable=True)
    pairs = pairs.gather(1, by_index[..., None].expand(-1, -1, 2))
    _, best = stable_topk(pairs[..., 0], k)  # of equal values the lower global index, already first
    best = pairs.gather(1, best.long()[..., None].expand(-1, -1, 2))
    return best[..., 0].float(), best[..., 1].to(torch.int32)
