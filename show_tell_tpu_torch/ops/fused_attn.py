"""The fused attention decode step: attention, the embed-space context,
the L-layer GRU or LSTM, the vocab projection and the first-max argmax
(greedy) or the dense f32 logits (beam) in one CUDA kernel launch
(csrc/fused_attn_step.cu), its plain PyTorch twins, a count of kernel
launches for each cell and end, and the greedy decode over it
(counterpart of show_tell_tpu/ops/fused_attn_pallas.py, argmax and dense
modes).

The step takes the state as the greedy loop carries it: hs [L, B, H] for
the GRU, the tuple (hs, cs) for the LSTM.

Every instance runs the recurrence and the projection on the tensor cores
(csrc/dense_mma.cuh; geometry ``fused_step.mma_tiles``): bf16 as
``fused_step.mma_step`` names it, with the attention phases in SIMT code;
f32 in split-precision TF32 (``fused_step.tf32x3_step(..., attention=True)``:
three tf32 products a product, about f32's precision), its layers' K split
across blocks (``fused_step.layer_split``), with the attention phases in
SIMT code spread over the grid.

Two per-image constants are hoisted out of the step, as on the TPU:
``att1 = feats @ W_enc + b_enc`` and ``feats_e = feats @ W_embed``.  Decode
only needs ``embed(context)``, and ``embed(sum_p alpha_p feats_p) =
sum_p alpha_p feats_e_p + b_embed``, so the kernel reduces over E columns
instead of C.  Both are products in f32 rounded once to the compute dtype,
where the JAX package rounds them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from show_tell_tpu_torch.ops import check_tensor, check_widths, dtype_code, raise_on_error, stream_arg, uses_kernel
from show_tell_tpu_torch.ops.attention import attention_alpha_plain, precompute_att1
from show_tell_tpu_torch.ops.fused_step import check_stack, layer_split, mma_step, mma_tiles, tf32x3_step
from show_tell_tpu_torch.ops.rnn import LstmState, State, prepare_rnn_weights, stack_plain
from show_tell_tpu_torch.ops.vocab import prepare_vocab, project_argmax_plain, project_logits


def fused_attn_fits(hidden_dim: int, embed_dim: int) -> bool:
    """The fused step's shape rule, the JAX package's (ops/__init__.py
    fused_attn_step_fits without its VMEM budget): H <= 2E; wider hidden
    states take the composite path (ops/attention.py)."""
    return hidden_dim <= 2 * embed_dim


def prepare_attn_weights(decoder, dtype: Optional[torch.dtype] = None) -> Dict[str, object]:
    """Per model, in kernel layout and ``dtype`` (default the decoder's):
    the stacked recurrence (layer 0 is 2E wide), the vocab projection and
    the attention weights wdec [A, H], bdec [A], wfull [A] (full_att's
    weight; its bias is dropped), b_emb [E] (embed's bias)."""
    dtype = dtype or decoder.embeddings.weight.dtype
    c = lambda t: t.to(dtype).contiguous()
    att = decoder.attn
    return {
        "stacked": prepare_rnn_weights(decoder.unit.layers(), dtype),
        "vocab": prepare_vocab(decoder.linear.weight, decoder.linear.bias, dtype),
        "wdec": c(att.decoder_att.weight),
        "bdec": c(att.decoder_att.bias),
        "wfull": c(att.full_att.weight[0]),
        "b_emb": c(decoder.embed.bias),
    }


def prepare_attn_decode(weights: Dict[str, object], decoder, feats_pm: torch.Tensor) -> Dict[str, object]:
    """Per decode: ``weights`` plus att1 [B, P, A] and feats_e [B, P, E],
    each a product in f32 cast to the compute dtype once."""
    dtype = weights["wdec"].dtype
    feats_e = feats_pm.float() @ decoder.embed.weight.float().T
    return {
        **weights,
        "att1": precompute_att1(decoder.attn, feats_pm).to(dtype).contiguous(),
        "feats_e": feats_e.to(dtype).contiguous(),
    }


def _attn_stack_plain(prep: Dict[str, object], w_emb: torch.Tensor, state: State) -> Tuple[torch.Tensor, State]:
    """The kernels' trunk in plain torch ops: alpha from the last layer's
    incoming h, ctx_e = sum_p alpha_p feats_e_p + b_emb in f32, x =
    cat(w_emb, ctx_e) in hs's dtype, then the GRU or LSTM stack (by the
    state).  Returns (top h [B, H], new state)."""
    lstm = isinstance(state, tuple)
    hs = state[0] if lstm else state
    alpha = attention_alpha_plain(prep, prep["att1"], hs[-1])
    ctx_e = (prep["feats_e"].float() * alpha[..., None]).sum(dim=1) + prep["b_emb"].float()
    x = torch.cat([w_emb.to(hs.dtype), ctx_e.to(hs.dtype)], dim=-1)
    return stack_plain("lstm" if lstm else "gru")(prep["stacked"], x, state)


def fused_attn_decode_step_plain(
    prep: Dict[str, object], w_emb: torch.Tensor, state: State
) -> Tuple[torch.Tensor, State]:
    """The greedy kernel's function in plain torch ops: the trunk, the
    projection and the first-max argmax.  Returns (tok [B] int32, new
    state)."""
    top, new_state = _attn_stack_plain(prep, w_emb, state)
    return project_argmax_plain(prep["vocab"], top), new_state


def fused_attn_dense_step_plain(
    prep: Dict[str, object], w_emb: torch.Tensor, state: State
) -> Tuple[torch.Tensor, State]:
    """The dense kernel's function in plain torch ops: the trunk and the
    projection in f32.  Returns (logits [B, V] f32, new state)."""
    top, new_state = _attn_stack_plain(prep, w_emb, state)
    return project_logits(prep["vocab"], top), new_state


def _fused_attn_cuda(prep, w_emb, state: State, dense: bool):
    """Check, allocate and launch the GRU or (for a state (hs, cs)) the
    LSTM instance of the argmax or the dense kernel; its tensor-core
    geometry is checked first (``mma_tiles`` raises for a width that does
    not fit), and an f32 instance gets its layers' K split (``layer_split``:
    the scratch and the stream's arrival counters; layer 0 is 2E wide).
    Returns (tok or logits, new state)."""
    from show_tell_tpu_torch.ops.build import load_library

    lstm = isinstance(state, tuple)
    hs, cs = state if lstm else (state, None)
    L, B, H = hs.shape
    _, P, E = prep["feats_e"].shape
    A = prep["att1"].shape[2]
    V = prep["vocab"]["w"].shape[0]
    dtype, device = hs.dtype, hs.device
    kernel = "fused_attn_dense_step" if dense else "fused_attn_decode_step"
    code = dtype_code(kernel, dtype)
    check_widths(kernel, E=E, A=A)
    if P < 1 or V < 1:
        raise ValueError("%s needs P, V >= 1 (got P=%d V=%d)" % (kernel, P, V))
    check_stack(kernel, prep["stacked"], 2 * E, hs, 4 if lstm else 3)
    if lstm:
        check_tensor("cs", cs, (L, B, H), dtype, device)
    check_tensor("w_emb", w_emb, (B, E), dtype, device)
    check_tensor("feats_e", prep["feats_e"], (B, P, E), dtype, device)
    check_tensor("att1", prep["att1"], (B, P, A), dtype, device)
    check_tensor("wdec", prep["wdec"], (A, H), dtype, device)
    check_tensor("bdec", prep["bdec"], (A,), dtype, device)
    check_tensor("wfull", prep["wfull"], (A,), dtype, device)
    check_tensor("b_emb", prep["b_emb"], (E,), dtype, device)
    check_tensor("vocab w", prep["vocab"]["w"], (V, H), dtype, device)
    check_tensor("vocab b", prep["vocab"]["b"], (V,), dtype, device)
    end = "dense" if dense else "argmax"
    partial, split_ptrs, split_ints = None, [None, None], [1, 1, 0]  # the split's scratch is held until queued
    if mma_step(dtype, end):
        mma_tiles(B, 2 * E, H, V, (A, P))
    elif tf32x3_step(dtype, end, attention=True):
        mma_tiles(B, 2 * E, H, V, (A, P), dtype=dtype)
        partial, split_ptrs, split_ints = layer_split(B, 2 * E, H, device, dtype)
    lib = load_library()
    stacked, vocab = prep["stacked"], prep["vocab"]
    x = torch.empty(B, 2 * E, dtype=dtype, device=device)
    att2 = torch.empty(B, A + P, dtype=torch.float32, device=device)  # att2, then the f32 A2's scores
    new_hs = torch.empty_like(hs)
    new_cs = torch.empty_like(cs) if lstm else None
    if dense:
        out = torch.empty(B, V, dtype=torch.float32, device=device)
        end_ptrs = [out.data_ptr()]
    else:
        out = torch.empty(B, dtype=torch.int32, device=device)
        best = torch.empty(B, dtype=torch.int64, device=device)
        end_ptrs = [out.data_ptr(), best.data_ptr()]
    state_in = [hs.data_ptr(), cs.data_ptr()] if lstm else [hs.data_ptr()]
    state_out = [new_hs.data_ptr(), new_cs.data_ptr()] if lstm else [new_hs.data_ptr()]
    entry = getattr(lib, "st_fused_attn_%s%sstep" % ("lstm_" if lstm else "", "dense_" if dense else ""))
    with torch.cuda.device(device):
        err = entry(
            code, w_emb.data_ptr(), prep["feats_e"].data_ptr(), prep["att1"].data_ptr(), prep["wdec"].data_ptr(),
            prep["bdec"].data_ptr(), prep["wfull"].data_ptr(), prep["b_emb"].data_ptr(),
            stacked["w_ih0"].data_ptr(), stacked["w_ihU"].data_ptr(), stacked["w_hh"].data_ptr(),
            stacked["b_ih"].data_ptr(), stacked["b_hh"].data_ptr(), *state_in, vocab["w"].data_ptr(),
            vocab["b"].data_ptr(), x.data_ptr(), att2.data_ptr(), *state_out, *end_ptrs, *split_ptrs,
            L, B, E, H, A, P, V, *split_ints, stream_arg(device),
        )
    raise_on_error(kernel, err)
    return out, ((new_hs, new_cs) if lstm else new_hs)


def fused_attn_decode_step_cuda(prep, w_emb, state: State) -> Tuple[torch.Tensor, State]:
    """Launch the GRU or (for a state (hs, cs)) the LSTM instance of the
    greedy kernel on the current stream, and count it on
    ``fused_attn_decode_step`` or ``fused_attn_lstm_decode_step``.  Every
    tensor must be on the same CUDA device, in one dtype (float32 or
    bfloat16), contiguous, with E, H and A multiples of 8.  Raises on
    anything else and on a failed launch."""
    out = _fused_attn_cuda(prep, w_emb, state, dense=False)
    (fused_attn_lstm_decode_step if isinstance(state, tuple) else fused_attn_decode_step).launches += 1
    return out


def fused_attn_dense_step_cuda(prep, w_emb, state: State) -> Tuple[torch.Tensor, State]:
    """Launch the dense kernel's GRU or LSTM instance, the greedy one's
    rules, and count it on ``fused_attn_dense_step`` or
    ``fused_attn_lstm_dense_step``.  Returns (logits [B, V] f32, new
    state)."""
    out = _fused_attn_cuda(prep, w_emb, state, dense=True)
    (fused_attn_lstm_dense_step if isinstance(state, tuple) else fused_attn_dense_step).launches += 1
    return out


def fused_attn_decode_step(
    prep: Dict[str, object],  # prepare_attn_decode output
    w_emb: torch.Tensor,  # [B, E] current token embeddings
    hs: torch.Tensor,  # [L, B, H]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused attention GRU greedy step.  Returns (tok [B] int32, new_hs).
    CUDA tensors launch the kernel (and count the launch in
    ``fused_attn_decode_step.launches``); CPU tensors run the plain twin."""
    if uses_kernel(hs):
        return fused_attn_decode_step_cuda(prep, w_emb, hs)
    return fused_attn_decode_step_plain(prep, w_emb, hs)


def fused_attn_lstm_decode_step(
    prep: Dict[str, object],
    w_emb: torch.Tensor,  # [B, E]
    state: LstmState,  # (hs, cs), each [L, B, H]
) -> Tuple[torch.Tensor, LstmState]:
    """One fused attention LSTM greedy step.  Returns (tok [B] int32,
    (new_hs, new_cs)).  CUDA tensors launch the kernel's LSTM instance (and
    count the launch in ``fused_attn_lstm_decode_step.launches``); CPU
    tensors run the plain twin."""
    if uses_kernel(state[0]):
        return fused_attn_decode_step_cuda(prep, w_emb, state)
    return fused_attn_decode_step_plain(prep, w_emb, state)


def fused_attn_dense_step(
    prep: Dict[str, object],  # prepare_attn_decode output, att1 and feats_e per beam row
    w_emb: torch.Tensor,  # [R, E]
    hs: torch.Tensor,  # [L, R, H]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused attention GRU beam step: (logits [R, V] f32, new_hs).
    CUDA tensors launch the kernel (and count the launch in
    ``fused_attn_dense_step.launches``); CPU tensors run the plain twin."""
    if uses_kernel(hs):
        return fused_attn_dense_step_cuda(prep, w_emb, hs)
    return fused_attn_dense_step_plain(prep, w_emb, hs)


def fused_attn_lstm_dense_step(prep, w_emb, state: LstmState) -> Tuple[torch.Tensor, LstmState]:
    """The LSTM twin of ``fused_attn_dense_step``: state (hs, cs), counted
    in ``fused_attn_lstm_dense_step.launches``."""
    if uses_kernel(state[0]):
        return fused_attn_dense_step_cuda(prep, w_emb, state)
    return fused_attn_dense_step_plain(prep, w_emb, state)


fused_attn_decode_step.launches = 0
fused_attn_lstm_decode_step.launches = 0
fused_attn_dense_step.launches = 0
fused_attn_lstm_dense_step.launches = 0


def attn_greedy_decode_fused(
    weights: Dict[str, object],  # prepare_attn_weights
    decoder,  # models.attention.AttnDecoder
    cfg,  # models.attention.AttnDecoderConfig
    cnn_feature: torch.Tensor,  # [B, C, P]
    start_token: int,
    end_token: Optional[int] = None,
) -> torch.Tensor:
    """Greedy attention decode, one fused-step launch per token
    (fused_attn_pallas.attn_greedy_decode_fused_pallas).  Returns [B, T]
    int32 ids; end_token: stop once every row emitted it (<pad> after)."""
    from show_tell_tpu_torch.models.attention import init_hidden, start_embeddings
    from show_tell_tpu_torch.models.decoder import greedy_loop

    B = cnn_feature.shape[0]
    prep = prepare_attn_decode(weights, decoder, cnn_feature.transpose(1, 2))
    embedding = decoder.embeddings.weight
    w0 = start_embeddings(decoder, B, start_token, cnn_feature.device)
    state0 = init_hidden(decoder, cfg, cnn_feature)
    fused = fused_attn_lstm_decode_step if cfg.cell_type == "lstm" else fused_attn_decode_step

    def step(w_emb, state):
        return fused(prep, w_emb, state)

    return greedy_loop(step, embedding, w0, state0, cfg.max_caption_length, end_token)
