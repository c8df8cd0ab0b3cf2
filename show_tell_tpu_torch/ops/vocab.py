"""Vocab projection for greedy decode: the weights in kernel layout, the
first-max argmax, and the projection + argmax kernel (csrc/project_argmax.cu)
with its plain twin and launch count (counterpart of
show_tell_tpu/ops/vocab_pallas.py).

The CUDA kernels read the projection in the torch layout [V, H], one
contiguous row per vocabulary entry, and mask the ragged end of V
themselves, so nothing is padded here.
"""

from __future__ import annotations

from typing import Dict, Optional

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
    lib = load_library()
    tok = torch.empty(B, dtype=torch.int32, device=device)
    best = torch.empty(B, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = lib.st_project_argmax(code, top.data_ptr(), vocab["w"].data_ptr(), vocab["b"].data_ptr(),
                                    tok.data_ptr(), best.data_ptr(), B, H, V, stream_arg(device))
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
