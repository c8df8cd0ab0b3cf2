"""GRU decode math and the greedy loop over the fused step kernel
(counterpart of show_tell_tpu/ops/rnn_pallas.py).

Weights stay in the torch layout [3H, in] (one contiguous row per gate
column), which is what the CUDA kernel streams.  Layer 0's input width E
is zero-padded up to H once, in ``prepare_rnn_weights``, so the kernel
sees uniform [L, 3H, H] strides; the zeros add nothing to the sums.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F


def gru_cell_math(x, h, w_ih, w_hh, b_ih, b_hh, out_dtype: torch.dtype) -> torch.Tensor:
    """One GRU cell: products summed in f32, gate math in f32 (torch gate
    order r, z, n; double biases; the reset gate multiplies the hidden-side
    affine W_hn h + b_hn), result cast to the carry dtype.  Mirrors
    rnn_pallas.gru_cell_math; w_ih [3H, in], w_hh [3H, H]."""
    H = h.shape[-1]
    gx = x.float() @ w_ih.float().T + b_ih.float()
    gh = h.float() @ w_hh.float().T + b_hh.float()
    r = torch.sigmoid(gx[:, :H] + gh[:, :H])
    z = torch.sigmoid(gx[:, H : 2 * H] + gh[:, H : 2 * H])
    n = torch.tanh(gx[:, 2 * H :] + r * gh[:, 2 * H :])
    return ((1.0 - z) * n + z * h.float()).to(out_dtype)


def pad_cols(t: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad the last axis of ``t`` up to ``width`` (layer-0 input E -> H)."""
    if t.shape[-1] > width:
        raise ValueError("input width %d exceeds the hidden width %d" % (t.shape[-1], width))
    return F.pad(t, (0, width - t.shape[-1])) if t.shape[-1] < width else t


def prepare_rnn_weights(
    layers: List[Dict[str, torch.Tensor]], dtype: Optional[torch.dtype] = None
) -> Dict[str, torch.Tensor]:
    """Stack per-layer {w_ih [3H,in], w_hh [3H,H], b_ih [3H], b_hh [3H]}
    into w_ih/w_hh [L, 3H, H] and b_ih/b_hh [L, 3H], padding layer 0's
    input width up to H.  Done once per model, outside the decode loop."""
    H = layers[0]["w_hh"].shape[1]
    dtype = dtype or layers[0]["w_hh"].dtype
    stack = lambda ts: torch.stack([t.to(dtype) for t in ts]).contiguous()
    return {
        "w_ih": stack([pad_cols(l["w_ih"], H) for l in layers]),
        "w_hh": stack([l["w_hh"] for l in layers]),
        "b_ih": stack([l["b_ih"] for l in layers]),
        "b_hh": stack([l["b_hh"] for l in layers]),
    }


def prepare_greedy(
    layers: List[Dict[str, torch.Tensor]],
    embedding: torch.Tensor,  # [V, E]
    linear_w: torch.Tensor,  # [V, H]
    linear_b: torch.Tensor,  # [V]
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, object]:
    """Everything the greedy loop reads, in kernel layout, built once:
    stacked recurrence weights, the projection, and the embedding table
    zero-padded to H columns so each fed-back row is already the kernel's
    layer-0 input."""
    from show_tell_tpu_torch.ops.vocab import prepare_vocab

    stacked = prepare_rnn_weights(layers, dtype)
    dtype = stacked["w_hh"].dtype
    H = stacked["w_hh"].shape[2]
    return {
        "stacked": stacked,
        "vocab": prepare_vocab(linear_w, linear_b, dtype),
        "embedding": pad_cols(embedding.to(dtype), H).contiguous(),
    }


def greedy_decode_kernel(
    prepared: Dict[str, object],  # prepare_greedy output
    feats: torch.Tensor,  # [B, E] image features
    max_len: int,
    end_token: Optional[int] = None,
) -> torch.Tensor:
    """Greedy decode, one fused-step launch per token (counterpart of
    rnn_pallas.greedy_decode_pallas): ``tok, hs = fused_gru_decode_step``,
    then ``x = embedding[tok]``.  Returns [B, max_len] int32 ids.
    end_token: stop once every row emitted it (<pad> after it)."""
    from show_tell_tpu_torch.models.decoder import greedy_early_exit_loop, greedy_loop
    from show_tell_tpu_torch.ops.fused_step import fused_gru_decode_step

    stacked, vocab, embedding = prepared["stacked"], prepared["vocab"], prepared["embedding"]
    L, _, H = stacked["w_hh"].shape
    B = feats.shape[0]
    x0 = pad_cols(feats.to(embedding.dtype), H).contiguous()
    hs0 = torch.zeros(L, B, H, dtype=embedding.dtype, device=feats.device)

    def step(x, hs):
        return fused_gru_decode_step(stacked, vocab, x, hs)

    if end_token is None:
        return greedy_loop(step, embedding, x0, hs0, max_len)
    return greedy_early_exit_loop(step, embedding, x0, hs0, max_len, end_token)
