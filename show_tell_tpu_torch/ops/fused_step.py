"""The fused greedy decode step: L-layer GRU, vocab projection and
first-max argmax in one CUDA kernel launch (csrc/fused_gru_step.cu), its
plain PyTorch twin, and a count of kernel launches.

Counterpart of show_tell_tpu/ops/fused_step_pallas.py::fused_gru_decode_step_pallas.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from show_tell_tpu_torch.ops import uses_kernel
from show_tell_tpu_torch.ops.rnn import gru_cell_math, pad_cols
from show_tell_tpu_torch.ops.vocab import first_max_argmax

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_gru_decode_step_plain(
    stacked: Dict[str, torch.Tensor],  # prepare_rnn_weights output
    vocab: Dict[str, torch.Tensor],  # prepare_vocab output: w [V, H], b [V]
    x: torch.Tensor,  # [B, E] with E <= H
    hs: torch.Tensor,  # [L, B, H]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch ops: ``gru_cell_math`` per
    layer, then ``x @ wv.T + bv`` in f32, then the first-max argmax.
    Returns (tok [B] int32, new_hs [L, B, H])."""
    inp = pad_cols(x, hs.shape[2]).to(hs.dtype)
    new_hs = []
    for l in range(hs.shape[0]):
        inp = gru_cell_math(
            inp, hs[l], stacked["w_ih"][l], stacked["w_hh"][l],
            stacked["b_ih"][l], stacked["b_hh"][l], hs.dtype,
        )
        new_hs.append(inp)
    logits = inp.float() @ vocab["w"].float().T + vocab["b"].float()
    return first_max_argmax(logits), torch.stack(new_hs)


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise ValueError("%s has dtype %s, expected %s" % (name, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s" % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    if t.data_ptr() % 16:
        raise ValueError("%s must be 16-byte aligned" % name)


def fused_gru_decode_step_cuda(stacked, vocab, x, hs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream.  Every input must be on
    the same CUDA device, in one dtype (float32 or bfloat16), contiguous,
    with x already H wide.  Raises on anything else and on a failed launch."""
    from show_tell_tpu_torch.ops.build import load_library

    L, B, H = hs.shape
    V = vocab["w"].shape[0]
    dtype, device = hs.dtype, hs.device
    if dtype not in _DTYPE_CODES:
        raise ValueError("fused_gru_decode_step takes float32 or bfloat16, not %s" % dtype)
    if H % 8 or B < 1 or L < 1 or V < 1:
        raise ValueError("fused_gru_decode_step needs H % 8 == 0 and B, L, V >= 1 (got L=%d B=%d H=%d V=%d)"
                         % (L, B, H, V))
    _check("x", x, (B, H), dtype, device)
    _check("hs", hs, (L, B, H), dtype, device)
    for key in ("w_ih", "w_hh"):
        _check(key, stacked[key], (L, 3 * H, H), dtype, device)
    for key in ("b_ih", "b_hh"):
        _check(key, stacked[key], (L, 3 * H), dtype, device)
    _check("vocab w", vocab["w"], (V, H), dtype, device)
    _check("vocab b", vocab["b"], (V,), dtype, device)
    lib = load_library()
    new_hs = torch.empty_like(hs)
    tok = torch.empty(B, dtype=torch.int32, device=device)
    best = torch.empty(B, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = lib.st_fused_gru_step(
            _DTYPE_CODES[dtype], x.data_ptr(), stacked["w_ih"].data_ptr(), stacked["w_hh"].data_ptr(),
            stacked["b_ih"].data_ptr(), stacked["b_hh"].data_ptr(), hs.data_ptr(),
            vocab["w"].data_ptr(), vocab["b"].data_ptr(), new_hs.data_ptr(), tok.data_ptr(),
            best.data_ptr(), L, B, H, V, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream),
        )
    if err != 0:
        raise RuntimeError("fused GRU step kernel failed with cudaError_t %d" % err)
    fused_gru_decode_step.launches += 1
    return tok, new_hs


def fused_gru_decode_step(
    stacked: Dict[str, torch.Tensor],
    vocab: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [B, E] with E <= H
    hs: torch.Tensor,  # [L, B, H]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One greedy decode step.  Returns (tok [B] int32, new_hs [L, B, H]).
    CUDA tensors launch the kernel (and count the launch in
    ``fused_gru_decode_step.launches``); CPU tensors run the plain twin."""
    if uses_kernel(hs):
        return fused_gru_decode_step_cuda(stacked, vocab, pad_cols(x, hs.shape[2]), hs)
    return fused_gru_decode_step_plain(stacked, vocab, x, hs)


fused_gru_decode_step.launches = 0
