"""Vocab projection for decode: the weights in kernel layout, the first-max
argmax and the stable top-k, the projection + argmax kernel
(csrc/project_argmax.cu, greedy) and the projection + top-k kernel
(csrc/project_topk.cu, beam), each with its plain twin and launch count
(counterpart of show_tell_tpu/ops/vocab_pallas.py).

The CUDA kernels read the projection in the torch layout [V, H], one
contiguous row per vocabulary entry, and mask the ragged end of V
themselves, so nothing is padded here.  Both kernels run on the tensor
cores (csrc/vocab_mma.cuh) in V-tiles whose geometry ``vocab_tiles``
computes here for each dtype and passes to the launch: bf16 by mma.sync
m16n8k16, f32 in split-precision TF32 (3xTF32) with a ring and pitches of
its own.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from show_tell_tpu_torch.ops import check_tensor, check_widths, dtype_code, raise_on_error, stream_arg, uses_kernel


def prepare_vocab(
    weight: torch.Tensor,  # [V, H], torch nn.Linear layout
    bias: torch.Tensor,  # [V]
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """The output projection as the kernels read it: w [V, H], b [V],
    contiguous, in ``dtype`` (default: the weight's)."""
    dtype = dtype or weight.dtype
    return {"w": weight.to(dtype).contiguous(), "b": bias.to(dtype).contiguous()}


def first_max_argmax(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis as int32; among equal maxima the lowest
    index wins (the rule of vocab_pallas.merge_block_argmax and of
    ``jnp.argmax``; ``torch.argmax`` documents the same)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def project_logits(vocab: Dict[str, torch.Tensor], top: torch.Tensor) -> torch.Tensor:
    """``top @ w.T + b`` in f32: [B, V]."""
    return top.float() @ vocab["w"].float().T + vocab["b"].float()


def project_argmax_plain(vocab: Dict[str, torch.Tensor], top: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch ops: [B] int32 tokens."""
    return first_max_argmax(project_logits(vocab, top))


# The projection kernels' V-tiles (csrc/vocab_mma.cuh; the constants must agree with it)
TILE_ROWS_MAX = 128  # mv <= this: 4 m16 tiles of f32 accumulators a warp
BATCH_GROUP = 64  # batch rows a pass: 4 slabs of 16
SMEM_LIMIT = 232448  # the 227 KB of shared memory a block may opt into on Hopper


class TileShape(NamedTuple):
    """The K geometry of one element type (TileShape<T> in csrc/vocab_mma.cuh)."""

    size: int  # bytes an element
    align: int  # K rounded up to this: the mma's k
    pad: int  # elements past the rounded K in a weight row: an odd number of 16-byte units in all
    chunk: int  # K elements a stage of the cp.async ring
    stages: int  # ring stages
    ring_pitch: int  # elements a ring row: 144 bytes, nine 16-byte units


TILE_SHAPES = {
    torch.bfloat16: TileShape(2, 16, 8, 64, 6, 72),  # mma.sync m16n8k16
    torch.float32: TileShape(4, 8, 4, 32, 4, 36),  # m16n8k8 in 3xTF32: the weights take twice bf16's bytes
}


class VocabTiles(NamedTuple):
    mv: int  # V-tile rows, a multiple of 16 (mma.sync's M)
    tiles: int  # ceil(V / mv): blocks of the grid, and top-k parts a row
    smem: int  # dynamic shared memory of a block, bytes


def tile_smem(mv: int, H: int, dtype: torch.dtype) -> int:
    """A block's shared memory (vocab_tile_smem in csrc/vocab_mma.cuh): the
    V-tile's weights at a row pitch of H rounded up to the mma's k, plus
    the shape's pad; the ring of batch chunks; the staged f32 logits of one
    batch group at a pitch of mv + 4.  In f32: 4 (mv (H + 4) + 4 x 64 x 36)
    + 4 x 64 (mv + 4) bytes for H a multiple of 8."""
    s = TILE_SHAPES[dtype]
    kp = -(-H // s.align) * s.align
    return s.size * (mv * (kp + s.pad) + s.stages * BATCH_GROUP * s.ring_pitch) + 4 * BATCH_GROUP * (mv + 4)


def vocab_tiles(H: int, V: int, sms: int, dtype: torch.dtype) -> VocabTiles:
    """The kernels' launch geometry in ``dtype``: V-tiles of mv rows, mv the
    least multiple of 16 that covers V in at most ``sms`` tiles (about one
    wave of one block an SM), capped at TILE_ROWS_MAX and at what fits in
    shared memory.  Raises for an H whose 16-row tile does not fit."""
    if H < 8 or H % 8:
        raise ValueError("the vocab projection needs H a multiple of 8 (got H=%d)" % H)
    fit = TILE_ROWS_MAX
    while fit >= 16 and tile_smem(fit, H, dtype) > SMEM_LIMIT:
        fit -= 16
    if fit < 16:
        raise ValueError("H=%d is too wide for the %s vocab projection: a 16-row V-tile needs %d bytes of shared "
                         "memory, over the %d a block may use" % (H, dtype, tile_smem(16, H, dtype), SMEM_LIMIT))
    units = -(-V // 16)  # 16-row units of V
    mv = min(16 * -(-units // sms), TILE_ROWS_MAX, fit)
    return VocabTiles(mv, -(-V // mv), tile_smem(mv, H, dtype))


def tile_rows(H: int, V: int, device: torch.device, dtype: torch.dtype) -> int:
    """The mv argument of a projection kernel: the V-tile rows on this device in this dtype."""
    return vocab_tiles(H, V, torch.cuda.get_device_properties(device).multi_processor_count, dtype).mv


def project_argmax_cuda(vocab: Dict[str, torch.Tensor], top: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream.  top [B, H], vocab w [V, H]
    and b [V], all on one CUDA device in one dtype, contiguous.  Raises on
    anything else and on a failed launch."""
    from show_tell_tpu_torch.ops.build import load_library

    B, H = top.shape
    V = vocab["w"].shape[0]
    dtype, device = top.dtype, top.device
    code = dtype_code("project_argmax", dtype)
    check_widths("project_argmax", H=H)
    if B < 1 or V < 1:
        raise ValueError("project_argmax needs B, V >= 1 (got B=%d V=%d)" % (B, V))
    check_tensor("top", top, (B, H), dtype, device)
    check_tensor("vocab w", vocab["w"], (V, H), dtype, device)
    check_tensor("vocab b", vocab["b"], (V,), dtype, device)
    mv = tile_rows(H, V, device, dtype)
    lib = load_library()
    tok = torch.empty(B, dtype=torch.int32, device=device)
    best = torch.empty(B, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = lib.st_project_argmax(code, top.data_ptr(), vocab["w"].data_ptr(), vocab["b"].data_ptr(),
                                    tok.data_ptr(), best.data_ptr(), B, H, V, mv, stream_arg(device))
    raise_on_error("project_argmax", err)
    project_argmax.launches += 1
    return tok


def project_argmax(vocab: Dict[str, torch.Tensor], top: torch.Tensor) -> torch.Tensor:
    """tok = first-max argmax(top @ w.T + b) as [B] int32, without a [B, V]
    logits tensor (counterpart of vocab_pallas.project_argmax_pallas).
    CUDA tensors launch the kernel (and count the launch in
    ``project_argmax.launches``); CPU tensors run the plain twin."""
    if uses_kernel(top):
        return project_argmax_cuda(vocab, top)
    return project_argmax_plain(vocab, top)


project_argmax.launches = 0


MAX_K = 8  # the top-k kernels keep each row's K best in registers: K <= 8


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their int32 indices,
    largest first and, among equal values, the lower index first: the
    order of ``jax.lax.top_k``.  ``torch.topk`` documents no order for
    ties, so this is a stable descending sort cut to k."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def project_topk_plain(vocab: Dict[str, torch.Tensor], top: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch ops: ``stable_topk`` of the
    f32 ``log_softmax(top @ w.T + b)``.  Returns (logp [B, k] f32, ids
    [B, k] int32)."""
    return stable_topk(torch.log_softmax(project_logits(vocab, top), dim=-1), k)


def topk_launch_args(kernel: str, B: int, V: int, k: int, device: torch.device, tiles: int):
    """Check k and allocate what a top-k vocab phase writes: logp and ids
    [B, k], and its scratch of ``tiles`` parts a row: the projection kernel
    writes one part per V-tile (vocab_tiles), the fused top-k step one per
    64-row vocabulary item; max_splits = n = tiles.  Returns (max_splits,
    part_keys [n, B, k] int64, part_ms [n, B, 2] f32, logp, ids)."""
    if not 1 <= k <= min(MAX_K, V):
        raise ValueError("%s takes 1 <= k <= min(%d, V) (got k=%d, V=%d)" % (kernel, MAX_K, k, V))
    return (
        tiles,
        torch.empty(tiles, B, k, dtype=torch.int64, device=device),
        torch.empty(tiles, B, 2, dtype=torch.float32, device=device),
        torch.empty(B, k, dtype=torch.float32, device=device),
        torch.empty(B, k, dtype=torch.int32, device=device),
    )


def project_topk_cuda(vocab: Dict[str, torch.Tensor], top: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream.  top [B, H], vocab w [V, H]
    and b [V], all on one CUDA device in one dtype, contiguous, H a
    multiple of 8, 1 <= k <= min(8, V).  Raises on anything else and on a
    failed launch."""
    from show_tell_tpu_torch.ops.build import load_library

    B, H = top.shape
    V = vocab["w"].shape[0]
    dtype, device = top.dtype, top.device
    code = dtype_code("project_topk", dtype)
    check_widths("project_topk", H=H)
    if B < 1:
        raise ValueError("project_topk needs B >= 1")
    check_tensor("top", top, (B, H), dtype, device)
    check_tensor("vocab w", vocab["w"], (V, H), dtype, device)
    check_tensor("vocab b", vocab["b"], (V,), dtype, device)
    mv = tile_rows(H, V, device, dtype)
    max_splits, part_keys, part_ms, logp, ids = topk_launch_args("project_topk", B, V, k, device, -(-V // mv))
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.st_project_topk(code, top.data_ptr(), vocab["w"].data_ptr(), vocab["b"].data_ptr(),
                                  part_keys.data_ptr(), part_ms.data_ptr(), logp.data_ptr(), ids.data_ptr(),
                                  B, H, V, k, max_splits, mv, stream_arg(device))
    raise_on_error("project_topk", err)
    project_topk.launches += 1
    return logp, ids


def project_topk(
    vocab: Dict[str, torch.Tensor], top: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's k best continuations, (logp [B, k] f32, ids [B, k]
    int32), as ``stable_topk(log_softmax(top @ w.T + b), k)`` but without a
    [B, V] logits tensor (counterpart of vocab_pallas.project_topk_pallas).
    CUDA tensors launch the kernel (and count the launch in
    ``project_topk.launches``); CPU tensors run the plain twin."""
    if uses_kernel(top):
        return project_topk_cuda(vocab, top, k)
    return project_topk_plain(vocab, top, k)


project_topk.launches = 0
