"""The fused greedy decode step: the L-layer GRU or LSTM, the vocab
projection and the first-max argmax in one CUDA kernel launch
(csrc/fused_step.cu), the plain PyTorch twins, and a count of kernel
launches for each cell.

Counterpart of show_tell_tpu/ops/fused_step_pallas.py::fused_gru_decode_step_pallas
and ::fused_lstm_decode_step_pallas.  Layer 0 reads x at its own width E,
which may exceed H.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from show_tell_tpu_torch.ops import check_tensor, check_widths, dtype_code, raise_on_error, stream_arg, uses_kernel
from show_tell_tpu_torch.ops.rnn import LstmState, gru_stack_plain, lstm_stack_plain
from show_tell_tpu_torch.ops.vocab import project_argmax_plain


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


def _fused_step_cuda(
    kernel: str, stacked, vocab, x, hs, cs: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Check, allocate and launch the GRU (cs None) or LSTM instance.
    Returns (tok, new_hs, new_cs or None)."""
    from show_tell_tpu_torch.ops.build import load_library

    L, B, H = hs.shape
    E = x.shape[-1]
    V = vocab["w"].shape[0]
    dtype, device = hs.dtype, hs.device
    code = dtype_code(kernel, dtype)
    if V < 1:
        raise ValueError("%s needs V >= 1" % kernel)
    check_stack(kernel, stacked, E, hs, 3 if cs is None else 4)
    if cs is not None:
        check_tensor("cs", cs, (L, B, H), dtype, device)
    check_tensor("x", x, (B, E), dtype, device)
    check_tensor("vocab w", vocab["w"], (V, H), dtype, device)
    check_tensor("vocab b", vocab["b"], (V,), dtype, device)
    lib = load_library()
    new_hs = torch.empty_like(hs)
    new_cs = None if cs is None else torch.empty_like(cs)
    tok = torch.empty(B, dtype=torch.int32, device=device)
    best = torch.empty(B, dtype=torch.int64, device=device)
    state_in = [hs.data_ptr()] if cs is None else [hs.data_ptr(), cs.data_ptr()]
    state_out = [new_hs.data_ptr()] if cs is None else [new_hs.data_ptr(), new_cs.data_ptr()]
    entry = lib.st_fused_gru_step if cs is None else lib.st_fused_lstm_step
    with torch.cuda.device(device):
        err = entry(
            code, x.data_ptr(), stacked["w_ih0"].data_ptr(), stacked["w_ihU"].data_ptr(),
            stacked["w_hh"].data_ptr(), stacked["b_ih"].data_ptr(), stacked["b_hh"].data_ptr(), *state_in,
            vocab["w"].data_ptr(), vocab["b"].data_ptr(), *state_out, tok.data_ptr(),
            best.data_ptr(), L, B, E, H, V, stream_arg(device),
        )
    raise_on_error(kernel, err)
    return tok, new_hs, new_cs


def fused_gru_decode_step_cuda(stacked, vocab, x, hs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the GRU kernel on the current stream.  Every input must be on
    the same CUDA device, in one dtype (float32 or bfloat16), contiguous,
    with E and H multiples of 8.  Raises on anything else and on a failed
    launch."""
    tok, new_hs, _ = _fused_step_cuda("fused_gru_decode_step", stacked, vocab, x, hs, None)
    fused_gru_decode_step.launches += 1
    return tok, new_hs


def fused_lstm_decode_step_cuda(stacked, vocab, x, state: LstmState) -> Tuple[torch.Tensor, LstmState]:
    """Launch the LSTM kernel on the current stream; the GRU kernel's rules,
    with cs [L, B, H] held like hs."""
    hs, cs = state
    tok, new_hs, new_cs = _fused_step_cuda("fused_lstm_decode_step", stacked, vocab, x, hs, cs)
    fused_lstm_decode_step.launches += 1
    return tok, (new_hs, new_cs)


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
