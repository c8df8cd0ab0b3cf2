"""The attention context kernel (csrc/attention_context.cu), its plain
twin and launch count, and the composite attention greedy decode built on
it (counterpart of show_tell_tpu/ops/attention_pallas.py).

The composite decode is the attention path for configurations outside the
fused step's shape rule (H > 2E, ops/fused_attn.py): per step the context
kernel (fed the last layer's h), ``embed(context)`` as a plain product,
the cell's plain stack step (GRU or LSTM), and the projection + argmax
kernel (ops/vocab.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from show_tell_tpu_torch.ops import check_tensor, check_widths, dtype_code, raise_on_error, stream_arg, uses_kernel


def precompute_att1(attn, feats_pm: torch.Tensor) -> torch.Tensor:
    """The encoder-side projection ``feats @ W_enc + b_enc``, constant over
    decode steps: [B, P, A] in f32 (``attn``: models.attention.AttentionNet)."""
    return feats_pm.float() @ attn.encoder_att.weight.float().T + attn.encoder_att.bias.float()


def attention_alpha_plain(
    weights: Dict[str, torch.Tensor], att1: torch.Tensor, h: torch.Tensor
) -> torch.Tensor:
    """alpha [B, P] f32 as the kernels compute it: att2 = h W_dec^T + b_dec,
    e = LeakyReLU_0.2(att1 + att2) . w_full (b_full dropped: the softmax
    does not see a constant), softmax over positions."""
    att2 = h.float() @ weights["wdec"].float().T + weights["bdec"].float()
    act = F.leaky_relu(att1.float() + att2[:, None, :], negative_slope=0.2)
    return torch.softmax((act * weights["wfull"].float()).sum(dim=-1), dim=1)


def attention_context_plain(weights, feats_pm, att1, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch ops: (ctx [B, C] in the
    feature dtype, alpha [B, P] f32)."""
    alpha = attention_alpha_plain(weights, att1, h)
    return (feats_pm.float() * alpha[..., None]).sum(dim=1).to(feats_pm.dtype), alpha


def attention_context_cuda(weights, feats_pm, att1, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream.  feats_pm [B, P, C], att1
    [B, P, A], h [B, H], weights wdec [A, H], bdec [A], wfull [A], all on
    one CUDA device in one dtype, contiguous, with C, A and H multiples of
    8.  Raises on anything else and on a failed launch."""
    from show_tell_tpu_torch.ops.build import load_library

    B, P, C = feats_pm.shape
    A, H = att1.shape[2], h.shape[1]
    dtype, device = feats_pm.dtype, feats_pm.device
    code = dtype_code("attention_context", dtype)
    check_widths("attention_context", C=C, A=A, H=H)
    if B < 1 or P < 1:
        raise ValueError("attention_context needs B, P >= 1 (got B=%d P=%d)" % (B, P))
    check_tensor("feats_pm", feats_pm, (B, P, C), dtype, device)
    check_tensor("att1", att1, (B, P, A), dtype, device)
    check_tensor("h", h, (B, H), dtype, device)
    check_tensor("wdec", weights["wdec"], (A, H), dtype, device)
    check_tensor("bdec", weights["bdec"], (A,), dtype, device)
    check_tensor("wfull", weights["wfull"], (A,), dtype, device)
    lib = load_library()
    ctx = torch.empty(B, C, dtype=dtype, device=device)
    alpha = torch.empty(B, P, dtype=torch.float32, device=device)
    att2 = torch.empty(B, A, dtype=torch.float32, device=device)  # scratch between the kernel's first two phases
    with torch.cuda.device(device):
        err = lib.st_attention_context(
            code, feats_pm.data_ptr(), att1.data_ptr(), h.data_ptr(), weights["wdec"].data_ptr(),
            weights["bdec"].data_ptr(), weights["wfull"].data_ptr(), ctx.data_ptr(), alpha.data_ptr(),
            att2.data_ptr(), B, P, C, A, H, stream_arg(device),
        )
    raise_on_error("attention_context", err)
    attention_context.launches += 1
    return ctx, alpha


def attention_context(
    weights: Dict[str, torch.Tensor],  # wdec [A, H], bdec [A], wfull [A]
    feats_pm: torch.Tensor,  # [B, P, C] positions-major features
    att1: torch.Tensor,  # [B, P, A] precompute_att1, in the feature dtype
    h: torch.Tensor,  # [B, H] the last layer's hidden state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (context [B, C] in the feature dtype, alpha [B, P] f32).
    CUDA tensors launch the kernel (and count the launch in
    ``attention_context.launches``); CPU tensors run the plain twin."""
    if uses_kernel(feats_pm):
        return attention_context_cuda(weights, feats_pm, att1, h)
    return attention_context_plain(weights, feats_pm, att1, h)


attention_context.launches = 0


def attn_greedy_decode_composite(
    weights: Dict[str, object],  # ops.fused_attn.prepare_attn_weights
    decoder,  # models.attention.AttnDecoder
    cfg,  # models.attention.AttnDecoderConfig
    cnn_feature: torch.Tensor,  # [B, C, P]
    start_token: int,
    end_token: Optional[int] = None,
) -> torch.Tensor:
    """Greedy attention decode with the context kernel and the projection
    + argmax kernel (attention_pallas.attn_greedy_decode_pallas).  Returns
    [B, T] int32 ids; end_token: stop once every row emitted it."""
    from show_tell_tpu_torch.models.attention import init_hidden, last_h, linear_f32, start_embeddings
    from show_tell_tpu_torch.models.decoder import greedy_loop
    from show_tell_tpu_torch.ops.rnn import stack_plain
    from show_tell_tpu_torch.ops.vocab import project_argmax

    B = cnn_feature.shape[0]
    feats_pm = cnn_feature.transpose(1, 2).contiguous()
    dtype = decoder.embeddings.weight.dtype
    att1 = precompute_att1(decoder.attn, feats_pm).to(dtype).contiguous()
    stack = stack_plain(cfg.cell_type)

    def step(w_emb, state):
        context, _ = attention_context(weights, feats_pm, att1, last_h(state))
        x = torch.cat([w_emb, linear_f32(decoder.embed, context).to(w_emb.dtype)], dim=-1)
        top, state2 = stack(weights["stacked"], x, state)
        return project_argmax(weights["vocab"], top.contiguous()), state2

    w0 = start_embeddings(decoder, B, start_token, cnn_feature.device)
    state0 = init_hidden(decoder, cfg, cnn_feature)
    embedding = decoder.embeddings.weight
    return greedy_loop(step, embedding, w0, state0, cfg.max_caption_length, end_token)
