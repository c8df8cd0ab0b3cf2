"""The fused greedy decode step: the L-layer GRU or LSTM, the vocab
projection and the first-max argmax in one CUDA kernel launch
(csrc/fused_step.cu), the plain PyTorch twins, a count of kernel launches
for each cell, and the launcher that the kernel's beam ends share
(ops/fused_beam.py).

Counterpart of show_tell_tpu/ops/fused_step_pallas.py::fused_gru_decode_step_pallas
and ::fused_lstm_decode_step_pallas.  Layer 0 reads x at its own width E,
which may exceed H.

The bf16 instances that ``mma_step`` names (here, in ops/fused_attn.py
and the whole decode of ops/whole_decode.py) run their recurrence and
projection on the tensor cores (csrc/dense_mma.cuh), whose launch
geometry ``mma_tiles`` computes: the dense, top-k and argmax ends, both
cells (the pooled GRU's argmax instance bit-equal to the whole decode),
and the stack step (no vocab end), whose K split across blocks
``stack_tiles`` computes.  f32 keeps the SIMT code.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from show_tell_tpu_torch.ops import check_tensor, check_widths, dtype_code, raise_on_error, stream_arg, uses_kernel
from show_tell_tpu_torch.ops.rnn import LstmState, State, gru_stack_plain, lstm_stack_plain
from show_tell_tpu_torch.ops.vocab import SMEM_LIMIT, project_argmax_plain, topk_launch_args


# The tensor-core items of the bf16 steps (csrc/dense_mma.cuh; the constants must agree with it)
MMA_SLAB = 32  # batch rows an item: four n8 tiles of mma.sync m16n8k16
MMA_CHUNK = 32  # K columns a warp's step: two k16 steps
MMA_SLOTS = 4  # m16 accumulator tiles an item: the gates (GRU: r, z, n's x side, n's h side) or 64 vocab rows
MMA_VOCAB_ROWS = 16 * MMA_SLOTS  # vocabulary rows an item: the top-k end writes one part per such item
MMA_WARPS = 4  # warps a block (128 threads, the SIMT phases' block), splitting an item's K chunks
MMA_PITCH = 33  # floats a staged row of a warp's 32 lanes
MMA_SMEM = 4 * MMA_WARPS * MMA_SLOTS * 4 * 4 * MMA_PITCH  # bytes: every warp's 64 sums a lane
ATTN_ROWS = 8  # the attention's SIMT phase A1 holds 8 rows of h (kBM in csrc/decode_common.cuh)
MAX_SPLITS = 8  # parts a stack-step item's K chunks may be split into (kMaxSplits)
MMA_BLOCKS_PER_SM = 2  # blocks of a tensor-core step resident on an SM: 128 threads at <= 256 registers each
MMA_PART = MMA_SLOTS * MMA_SLAB * 16  # f32 sums of one split-K part: every slot's 16 columns x 32 rows


def mma_step(dtype: torch.dtype, end: Union[str, int, None]) -> bool:
    """Whether a fused step's instance runs on the tensor cores (mma_step()
    in csrc/dense_mma.cuh): bf16, with any end ("dense", "argmax", a top-k
    width, or None: the stack step), of either cell; the whole decode
    (csrc/whole_decode.cu) as the "argmax" end.  f32 keeps the SIMT code."""
    return dtype == torch.bfloat16


class MmaTiles(NamedTuple):
    gate_items: int  # (16 columns of every gate, 32 batch rows) items of a layer
    vocab_items: int  # (64 vocabulary rows, 32 batch rows) items of the projection
    layer0_chunks: int  # 32-column K chunks of layer 0 (I0, then H), split over the 4 warps
    upper_chunks: int  # the same for a layer l > 0 (H, then H)
    vocab_chunks: int  # the same for the projection (H)
    smem: int  # dynamic shared memory of a block, bytes


def mma_tiles(R: int, I0: int, H: int, V: int, attention: Optional[Tuple[int, int]] = None) -> MmaTiles:
    """The launch geometry of a tensor-core step (pooled, or with
    ``attention`` = (A, P)) at R batch rows: its items, K chunks and shared
    memory, as csrc/dense_mma.cuh and the kernels' launch compute them; the
    dense and the argmax end take the same items.  The grid is the
    occupancy times the SM count, and blocks walk the items.  Raises for
    widths whose shared memory exceeds a block's."""
    check_widths("tensor-core step", I0=I0, H=H)
    chunks = lambda k: -(-k // MMA_CHUNK)
    slabs = -(-R // MMA_SLAB)
    smem = MMA_SMEM
    if attention is not None:  # A1's rows of h and A2's A + P scores share the block's memory
        A, P = attention
        smem = max(smem, 4 * (A + P), 4 * ATTN_ROWS * H)
    if smem > SMEM_LIMIT:
        raise ValueError("the bf16 tensor-core step at H=%d%s needs %d bytes of shared memory a block, over the %d a "
                         "block may use" % (H, "" if attention is None else ", A=%d, P=%d" % attention, smem,
                                            SMEM_LIMIT))
    return MmaTiles(slabs * -(-H // 16), slabs * -(-V // MMA_VOCAB_ROWS), chunks(I0) + chunks(H), 2 * chunks(H),
                    chunks(H), smem)


class StackTiles(NamedTuple):
    items: int  # (16 columns of every gate, 32 batch rows) items of a layer
    chunks: Tuple[int, int]  # 32-column K chunks of layer 0 (I0, then H) and of a layer l > 0 (H, then H)
    splits: Tuple[int, int]  # S, the parts of an item's K chunks, in layer 0 and in the layers above
    parts: int  # split-K scratch parts, items x the larger S > 1 (0: no layer splits)


def stack_splits(B: int, I: int, H: int, sms: int) -> int:
    """S for a bf16 stack-step layer of input width I at B rows on a card
    of ``sms`` SMs: as many parts as the resident grid (MMA_BLOCKS_PER_SM
    blocks an SM) holds for the layer's items, at most MAX_SPLITS and at
    most a chunk a warp; 1 where the items alone fill the grid.  Settled
    on an H100 by chip_smoke.py's sweep of S = 1 .. 8 (PERF.md)."""
    items = -(-B // MMA_SLAB) * -(-H // 16)
    chunks = -(-I // MMA_CHUNK) + -(-H // MMA_CHUNK)
    return max(1, min(MAX_SPLITS, chunks // MMA_WARPS, MMA_BLOCKS_PER_SM * sms // items))


def stack_tiles(B: int, I0: int, H: int, sms: int, splits: int = 0) -> StackTiles:
    """The bf16 stack step's launch geometry at B rows: its items, K
    chunks, the S of layer 0 and of the upper layers (``stack_splits``, or
    ``splits`` for both where it is given) and the parts its scratch must
    hold.  Raises for widths that are not multiples of 8 and for an S
    outside 1 .. MAX_SPLITS."""
    check_widths("stack step", I0=I0, H=H)
    if splits and not 1 <= splits <= MAX_SPLITS:
        raise ValueError("the stack step splits K into 1 to %d parts (got %d)" % (MAX_SPLITS, splits))
    items = -(-B // MMA_SLAB) * -(-H // 16)
    chunks = lambda k: -(-k // MMA_CHUNK)
    S = tuple(splits or stack_splits(B, I, H, sms) for I in (I0, H))
    return StackTiles(items, (chunks(I0) + chunks(H), 2 * chunks(H)), S, items * max(S) if max(S) > 1 else 0)


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_ARRIVALS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def arrival_counters(device: torch.device, items: int) -> torch.Tensor:
    """The split-K arrival counters of the stack step on ``device``'s
    current stream, at least ``items`` of them: zeroed when allocated, and
    every launch leaves them at zero (each item's last part wraps its
    counter back), so a launch needs no memset of its own."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    counters = _ARRIVALS.get(key)
    if counters is None or counters.numel() < items:
        counters = _ARRIVALS[key] = torch.zeros(items, dtype=torch.int32, device=device)
    return counters


def fused_gru_decode_step_plain(
    stacked: Dict[str, torch.Tensor],  # prepare_rnn_weights output
    vocab: Dict[str, torch.Tensor],  # prepare_vocab output: w [V, H], b [V]
    x: torch.Tensor,  # [B, E]
    hs: torch.Tensor,  # [L, B, H]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch ops: ``gru_cell_math`` per
    layer, then ``x @ wv.T + bv`` in f32, then the first-max argmax.
    Returns (tok [B] int32, new_hs [L, B, H])."""
    top, new_hs = gru_stack_plain(stacked, x, hs)
    return project_argmax_plain(vocab, top), new_hs


def fused_lstm_decode_step_plain(stacked, vocab, x, state: LstmState) -> Tuple[torch.Tensor, LstmState]:
    """The LSTM twin: ``lstm_cell_math`` per layer, the projection and the
    first-max argmax.  Returns (tok [B] int32, (new_hs, new_cs))."""
    top, new_state = lstm_stack_plain(stacked, x, state)
    return project_argmax_plain(vocab, top), new_state


def check_stack(kernel: str, stacked: Dict[str, torch.Tensor], I0: int, hs: torch.Tensor, gates: int) -> None:
    """The ``prepare_rnn_weights`` tensors of a ``gates``-gate cell against
    hs [L, B, H] and a layer-0 width I0."""
    L, B, H = hs.shape
    check_widths(kernel, I0=I0, H=H)
    if B < 1 or L < 1:
        raise ValueError("%s needs B, L >= 1 (got L=%d B=%d)" % (kernel, L, B))
    GH = gates * H
    check_tensor("hs", hs, (L, B, H), hs.dtype, hs.device)
    check_tensor("w_ih0", stacked["w_ih0"], (GH, I0), hs.dtype, hs.device)
    check_tensor("w_ihU", stacked["w_ihU"], (L - 1, GH, H), hs.dtype, hs.device)
    check_tensor("w_hh", stacked["w_hh"], (L, GH, H), hs.dtype, hs.device)
    for key in ("b_ih", "b_hh"):
        check_tensor(key, stacked[key], (L, GH), hs.dtype, hs.device)


def launch_fused_step(kernel: str, stacked, vocab, x, state: State, end: Union[str, int, None], splits: int = 0):
    """Check, allocate and launch one instance of the fused step kernel:
    the cell by the state (hs: GRU, (hs, cs): LSTM), the vocab end by
    ``end``: "argmax" (tok [B] int32), "dense" (logits [B, V] f32), a top-k
    width k (logp [B, k] f32, ids [B, k] int32), or None, the stack step
    (the top activation [B, H], a view of new_hs[L-1]; ``vocab`` is not
    read).  An instance that ``mma_step`` names has its tensor-core
    geometry checked first (``mma_tiles``; the stack step ``stack_tiles``,
    which ``splits`` overrides); its top-k end gets one scratch part per
    MMA_VOCAB_ROWS vocabulary rows, the stack step its split-K scratch and
    the stream's arrival counters.  Returns (the end's output, new state)."""
    from show_tell_tpu_torch.ops.build import load_library

    lstm = isinstance(state, tuple)
    hs, cs = state if lstm else (state, None)
    L, B, H = hs.shape
    E = x.shape[-1]
    dtype, device = hs.dtype, hs.device
    code = dtype_code(kernel, dtype)
    check_stack(kernel, stacked, E, hs, 4 if lstm else 3)
    if lstm:
        check_tensor("cs", cs, (L, B, H), dtype, device)
    check_tensor("x", x, (B, E), dtype, device)
    ints = [L, B, E, H]
    vocab_ptrs = []
    if splits and not (end is None and dtype == torch.bfloat16):
        raise ValueError("%s: splits apply to the bf16 stack step only" % kernel)
    if end is not None:
        V = vocab["w"].shape[0]
        if V < 1:
            raise ValueError("%s needs V >= 1" % kernel)
        check_tensor("vocab w", vocab["w"], (V, H), dtype, device)
        check_tensor("vocab b", vocab["b"], (V,), dtype, device)
        ints.append(V)
        vocab_ptrs = [vocab["w"].data_ptr(), vocab["b"].data_ptr()]
        if mma_step(dtype, end):
            mma_tiles(B, E, H, V)
    new_hs = torch.empty_like(hs)
    new_cs = torch.empty_like(cs) if lstm else None
    if end is None:
        out, entry_name = new_hs[L - 1], "st_%s_stack_step"
        ptrs, split_ints = [None, None], [1, 1, 0]  # f32: no split
        if mma_step(dtype, end):
            tiles = stack_tiles(B, E, H, sm_count(device), splits)
            if tiles.parts:  # held until the launch is queued
                partial = torch.empty(tiles.parts * MMA_PART, dtype=torch.float32, device=device)
                ptrs = [partial.data_ptr(), arrival_counters(device, tiles.items).data_ptr()]
            split_ints = [*tiles.splits, tiles.parts]
        ints += split_ints
    elif end == "argmax":
        out = torch.empty(B, dtype=torch.int32, device=device)
        best = torch.empty(B, dtype=torch.int64, device=device)
        ptrs, entry_name = [out.data_ptr(), best.data_ptr()], "st_fused_%s_step"
    elif end == "dense":
        out = torch.empty(B, V, dtype=torch.float32, device=device)
        ptrs, entry_name = [out.data_ptr()], "st_fused_%s_dense_step"
    else:
        items = -(-V // MMA_VOCAB_ROWS) if mma_step(dtype, end) else None
        max_splits, part_keys, part_ms, logp, ids = topk_launch_args(kernel, B, V, end, device, items)
        out = (logp, ids)
        ptrs = [part_keys.data_ptr(), part_ms.data_ptr(), logp.data_ptr(), ids.data_ptr()]
        ints += [end, max_splits]
        entry_name = "st_fused_%s_topk_step"
    lib = load_library()
    entry = getattr(lib, entry_name % ("lstm" if lstm else "gru"))
    state_in = [hs.data_ptr(), cs.data_ptr()] if lstm else [hs.data_ptr()]
    state_out = [new_hs.data_ptr(), new_cs.data_ptr()] if lstm else [new_hs.data_ptr()]
    with torch.cuda.device(device):
        err = entry(
            code, x.data_ptr(), stacked["w_ih0"].data_ptr(), stacked["w_ihU"].data_ptr(),
            stacked["w_hh"].data_ptr(), stacked["b_ih"].data_ptr(), stacked["b_hh"].data_ptr(), *state_in,
            *vocab_ptrs, *state_out, *ptrs, *ints, stream_arg(device),
        )
    raise_on_error(kernel, err)
    return out, ((new_hs, new_cs) if lstm else new_hs)


def fused_gru_decode_step_cuda(stacked, vocab, x, hs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the GRU kernel on the current stream.  Every input must be on
    the same CUDA device, in one dtype (float32 or bfloat16), contiguous,
    with E and H multiples of 8.  Raises on anything else and on a failed
    launch."""
    out = launch_fused_step("fused_gru_decode_step", stacked, vocab, x, hs, "argmax")
    fused_gru_decode_step.launches += 1
    return out


def fused_lstm_decode_step_cuda(stacked, vocab, x, state: LstmState) -> Tuple[torch.Tensor, LstmState]:
    """Launch the LSTM kernel on the current stream; the GRU kernel's rules,
    with cs [L, B, H] held like hs."""
    out = launch_fused_step("fused_lstm_decode_step", stacked, vocab, x, state, "argmax")
    fused_lstm_decode_step.launches += 1
    return out


def fused_gru_decode_step(
    stacked: Dict[str, torch.Tensor],
    vocab: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [B, E]
    hs: torch.Tensor,  # [L, B, H]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One greedy decode step.  Returns (tok [B] int32, new_hs [L, B, H]).
    CUDA tensors launch the kernel (and count the launch in
    ``fused_gru_decode_step.launches``); CPU tensors run the plain twin."""
    if uses_kernel(hs):
        return fused_gru_decode_step_cuda(stacked, vocab, x, hs)
    return fused_gru_decode_step_plain(stacked, vocab, x, hs)


def fused_lstm_decode_step(
    stacked: Dict[str, torch.Tensor],
    vocab: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [B, E]
    state: LstmState,  # (hs, cs), each [L, B, H]
) -> Tuple[torch.Tensor, LstmState]:
    """One greedy LSTM decode step.  Returns (tok [B] int32, (new_hs,
    new_cs)).  CUDA tensors launch the kernel (and count the launch in
    ``fused_lstm_decode_step.launches``); CPU tensors run the plain twin."""
    if uses_kernel(state[0]):
        return fused_lstm_decode_step_cuda(stacked, vocab, x, state)
    return fused_lstm_decode_step_plain(stacked, vocab, x, state)


fused_gru_decode_step.launches = 0
fused_lstm_decode_step.launches = 0
