"""Vocab projection for greedy decode: the weights in kernel layout and the
first-max argmax (counterpart of show_tell_tpu/ops/vocab_pallas.py).

The CUDA kernel (csrc/fused_gru_step.cu) reads the projection in the torch
layout [V, H], one contiguous row per vocabulary entry, and masks the
ragged end of V itself, so nothing is padded here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def prepare_vocab(
    weight: torch.Tensor,  # [V, H], torch nn.Linear layout
    bias: torch.Tensor,  # [V]
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """The output projection as the kernel reads it: w [V, H], b [V],
    contiguous, in ``dtype`` (default: the weight's)."""
    dtype = dtype or weight.dtype
    return {"w": weight.to(dtype).contiguous(), "b": bias.to(dtype).contiguous()}


def first_max_argmax(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis as int32; among equal maxima the lowest
    index wins (the rule of vocab_pallas.merge_block_argmax and of
    ``jnp.argmax``; ``torch.argmax`` documents the same)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
