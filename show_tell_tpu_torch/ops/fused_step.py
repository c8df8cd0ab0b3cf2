"""The fused greedy decode step: L-layer GRU, vocab projection and
first-max argmax in one CUDA kernel launch (csrc/fused_gru_step.cu), its
plain PyTorch twin, and a count of kernel launches.

Counterpart of show_tell_tpu/ops/fused_step_pallas.py::fused_gru_decode_step_pallas.
Layer 0 reads x at its own width E, which may exceed H.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from show_tell_tpu_torch.ops import check_tensor, check_widths, dtype_code, raise_on_error, stream_arg, uses_kernel
from show_tell_tpu_torch.ops.rnn import gru_stack_plain
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


def check_stack(kernel: str, stacked: Dict[str, torch.Tensor], I0: int, hs: torch.Tensor) -> None:
    """The ``prepare_rnn_weights`` tensors against hs [L, B, H] and a layer-0 width I0."""
    L, B, H = hs.shape
    check_widths(kernel, I0=I0, H=H)
    if B < 1 or L < 1:
        raise ValueError("%s needs B, L >= 1 (got L=%d B=%d)" % (kernel, L, B))
    check_tensor("hs", hs, (L, B, H), hs.dtype, hs.device)
    check_tensor("w_ih0", stacked["w_ih0"], (3 * H, I0), hs.dtype, hs.device)
    check_tensor("w_ihU", stacked["w_ihU"], (L - 1, 3 * H, H), hs.dtype, hs.device)
    check_tensor("w_hh", stacked["w_hh"], (L, 3 * H, H), hs.dtype, hs.device)
    for key in ("b_ih", "b_hh"):
        check_tensor(key, stacked[key], (L, 3 * H), hs.dtype, hs.device)


def fused_gru_decode_step_cuda(stacked, vocab, x, hs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream.  Every input must be on
    the same CUDA device, in one dtype (float32 or bfloat16), contiguous,
    with E and H multiples of 8.  Raises on anything else and on a failed
    launch."""
    from show_tell_tpu_torch.ops.build import load_library

    L, B, H = hs.shape
    E = x.shape[-1]
    V = vocab["w"].shape[0]
    dtype, device = hs.dtype, hs.device
    code = dtype_code("fused_gru_decode_step", dtype)
    if V < 1:
        raise ValueError("fused_gru_decode_step needs V >= 1")
    check_stack("fused_gru_decode_step", stacked, E, hs)
    check_tensor("x", x, (B, E), dtype, device)
    check_tensor("vocab w", vocab["w"], (V, H), dtype, device)
    check_tensor("vocab b", vocab["b"], (V,), dtype, device)
    lib = load_library()
    new_hs = torch.empty_like(hs)
    tok = torch.empty(B, dtype=torch.int32, device=device)
    best = torch.empty(B, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = lib.st_fused_gru_step(
            code, x.data_ptr(), stacked["w_ih0"].data_ptr(), stacked["w_ihU"].data_ptr(),
            stacked["w_hh"].data_ptr(), stacked["b_ih"].data_ptr(), stacked["b_hh"].data_ptr(), hs.data_ptr(),
            vocab["w"].data_ptr(), vocab["b"].data_ptr(), new_hs.data_ptr(), tok.data_ptr(),
            best.data_ptr(), L, B, E, H, V, stream_arg(device),
        )
    raise_on_error("fused GRU step", err)
    fused_gru_decode_step.launches += 1
    return tok, new_hs


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


fused_gru_decode_step.launches = 0
