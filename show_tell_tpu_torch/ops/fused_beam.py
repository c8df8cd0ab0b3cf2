"""The fused beam steps: the L-layer GRU or LSTM and the vocab projection
in one CUDA kernel launch (csrc/fused_step.cu), ending in the dense f32
logits or in each row's top-k log-probabilities, their plain PyTorch
twins, and a count of kernel launches for each cell and end.

Counterpart of show_tell_tpu/ops/fused_beam_pallas.py::fused_dense_step_pallas
and ::fused_topk_step_pallas.  The beam rows ride the batch axis: x is
[R, E] and the state [L, R, H] for R = B x K rows.  Layer 0 reads x at its
own width E, which may exceed H (the TPU kernels refuse E > H).

The dense and top-k instances (and the attention's dense ones in
ops/fused_attn.py) run their recurrence and projection on the tensor
cores (csrc/dense_mma.cuh, whose launch geometry ``fused_step.mma_tiles``
computes): bf16 on mma.sync's bf16 tiles, f32 in split-precision TF32
with the layers' K split (``fused_step.tf32x3_step``, ``stack_tiles``), the
same S as the greedy step at the same rows.  The top-k end writes each
64-row vocabulary item's top-k keys and (max, sum) and merges them, in
item order, after a grid barrier.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from show_tell_tpu_torch.ops import uses_kernel
from show_tell_tpu_torch.ops.fused_step import launch_fused_step
from show_tell_tpu_torch.ops.rnn import State, stack_plain
from show_tell_tpu_torch.ops.vocab import project_logits, project_topk_plain

TopK = Tuple[torch.Tensor, torch.Tensor]  # (logp [R, k] f32, ids [R, k] int32)

def fused_dense_step_plain(stacked, vocab, x, state: State) -> Tuple[torch.Tensor, State]:
    """The dense kernel's function in plain torch ops: the cell's stack
    (GRU for hs, LSTM for (hs, cs)), then ``top @ wv.T + bv`` in f32.
    Returns (logits [R, V] f32, new state)."""
    top, new_state = stack_plain("lstm" if isinstance(state, tuple) else "gru")(stacked, x, state)
    return project_logits(vocab, top), new_state


def fused_topk_step_plain(stacked, vocab, x, state: State, k: int) -> Tuple[TopK, State]:
    """The top-k kernel's function in plain torch ops: the stack, then
    ``project_topk_plain``.  Returns ((logp, ids) [R, k] each, new state)."""
    top, new_state = stack_plain("lstm" if isinstance(state, tuple) else "gru")(stacked, x, state)
    return project_topk_plain(vocab, top, k), new_state


def fused_dense_step_cuda(stacked, vocab, x, state: State) -> Tuple[torch.Tensor, State]:
    """Launch the dense kernel's GRU (state hs) or LSTM (state (hs, cs))
    instance on the current stream and count it on ``fused_gru_dense_step``
    or ``fused_lstm_dense_step``.  Every tensor on the same CUDA device, in
    one dtype (float32 or bfloat16), contiguous, E and H multiples of 8;
    raises on anything else and on a failed launch."""
    out = launch_fused_step("fused_dense_step", stacked, vocab, x, state, "dense")
    (fused_lstm_dense_step if isinstance(state, tuple) else fused_gru_dense_step).launches += 1
    return out


def fused_topk_step_cuda(stacked, vocab, x, state: State, k: int) -> Tuple[TopK, State]:
    """Launch the top-k kernel's GRU or LSTM instance and count it on
    ``fused_gru_topk_step`` or ``fused_lstm_topk_step``; the dense rules,
    and 1 <= k <= min(8, V)."""
    out = launch_fused_step("fused_topk_step", stacked, vocab, x, state, k)
    (fused_lstm_topk_step if isinstance(state, tuple) else fused_gru_topk_step).launches += 1
    return out


def fused_gru_dense_step(stacked, vocab, x, hs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One GRU beam step, dense: (logits [R, V] f32, new_hs).  CUDA tensors
    launch the kernel (counted in ``fused_gru_dense_step.launches``); CPU
    tensors run the plain twin."""
    if uses_kernel(hs):
        return fused_dense_step_cuda(stacked, vocab, x, hs)
    return fused_dense_step_plain(stacked, vocab, x, hs)


def fused_lstm_dense_step(stacked, vocab, x, state) -> Tuple[torch.Tensor, State]:
    """The LSTM twin of ``fused_gru_dense_step``: state (hs, cs)."""
    if uses_kernel(state[0]):
        return fused_dense_step_cuda(stacked, vocab, x, state)
    return fused_dense_step_plain(stacked, vocab, x, state)


def fused_gru_topk_step(stacked, vocab, x, hs: torch.Tensor, k: int) -> Tuple[TopK, torch.Tensor]:
    """One GRU beam step, sparse: ((logp, ids) [R, k] each, new_hs).  CUDA
    tensors launch the kernel (counted in ``fused_gru_topk_step.launches``);
    CPU tensors run the plain twin."""
    if uses_kernel(hs):
        return fused_topk_step_cuda(stacked, vocab, x, hs, k)
    return fused_topk_step_plain(stacked, vocab, x, hs, k)


def fused_lstm_topk_step(stacked, vocab, x, state, k: int) -> Tuple[TopK, State]:
    """The LSTM twin of ``fused_gru_topk_step``: state (hs, cs)."""
    if uses_kernel(state[0]):
        return fused_topk_step_cuda(stacked, vocab, x, state, k)
    return fused_topk_step_plain(stacked, vocab, x, state, k)


def fused_dense_step(
    stacked: Dict[str, torch.Tensor],  # prepare_rnn_weights output
    vocab: Dict[str, torch.Tensor],  # prepare_vocab output: w [V, H], b [V]
    x: torch.Tensor,  # [R, E]
    state: State,  # hs [L, R, H] (GRU) or (hs, cs) (LSTM)
) -> Tuple[torch.Tensor, State]:
    """One fused beam step with dense logits out: (logits [R, V] f32, new
    state), by the state's cell."""
    step = fused_lstm_dense_step if isinstance(state, tuple) else fused_gru_dense_step
    return step(stacked, vocab, x, state)


def fused_topk_step(stacked, vocab, x, state: State, k: int) -> Tuple[TopK, State]:
    """One fused beam step with each row's top-k out: ((logp [R, k] f32,
    ids [R, k] int32), new state), by the state's cell; equal to
    ``stable_topk(log_softmax(logits), k)`` of the dense step."""
    step = fused_lstm_topk_step if isinstance(state, tuple) else fused_gru_topk_step
    return step(stacked, vocab, x, state, k)


fused_gru_dense_step.launches = 0
fused_lstm_dense_step.launches = 0
fused_gru_topk_step.launches = 0
fused_lstm_topk_step.launches = 0
