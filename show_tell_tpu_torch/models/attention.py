"""The soft-attention GRU and LSTM caption decoders and their plain
greedy decode (counterpart of show_tell_tpu/models/attention.py, serving
half).

Parameter names are the reference's (Attention/rnn_attn.py:49-58,
rnn_attn_LSTM.py:55): ``embeddings.weight``,
``unit.{weight,bias}_{ih,hh}_l{k}`` (layer 0 is 2E wide), ``linear.*``,
``init_h.*``, ``init_c.*`` (LSTM only), ``embed.*``,
``attn.encoder_att.*``, ``attn.decoder_att.*``, ``attn.full_att.*``.

Per step (rnn_attn.py:21-31,69-94): additive attention of the last
layer's hidden state h (never the LSTM's c) over the P spatial positions,
the alpha-weighted feature sum, ``x = cat(embedding[w], embed(context))``,
the L-layer GRU or LSTM, the projection and the argmax.  Decode starts
from the <start> embedding with the hidden state ``init_h(mean over
positions)`` on every layer, and for the LSTM the cell state
``init_c(mean over positions)``.

Training (rnn_attn.py:64-74, main_attn.py:126-131): ``attn_decoder_forward``
feeds caption token w_t at step t; the caller picks the target (the
reference's w_t itself, or w_{t+1} under ``attn_next_token``).  The
reference's shrinking batch is a freeze mask: rows with t >= length keep
their state and get zero logits and alphas.  ``doubly_stochastic_penalty``
is the alpha_c regularizer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from show_tell_tpu_torch.models.decoder import RNNWeights, embed_tokens, greedy_loop, linear_f32
from show_tell_tpu_torch.models.rnn_cells import stack_step
from show_tell_tpu_torch.ops.rnn import State


class AttnDecoderConfig(NamedTuple):
    cell_type: str  # 'gru' | 'lstm'
    embed_dim: int
    nos_filters: int  # CNN channels (2048)
    attention_dim: int
    hidden_dim: int
    vocab_size: int
    num_layers: int
    max_caption_length: int = 25  # rnn_attn.py:53


class AttentionNet(nn.Module):
    """The reference's Attention_Net: encoder_att (C->A), decoder_att (H->A), full_att (A->1)."""

    def __init__(self, nos_filters: int, hidden_dim: int, attention_dim: int):
        super().__init__()
        self.encoder_att = nn.Linear(nos_filters, attention_dim)
        self.decoder_att = nn.Linear(hidden_dim, attention_dim)
        self.full_att = nn.Linear(attention_dim, 1)


class AttnDecoder(nn.Module):
    def __init__(self, cfg: AttnDecoderConfig):
        super().__init__()
        E, C, H = cfg.embed_dim, cfg.nos_filters, cfg.hidden_dim
        self.embeddings = nn.Embedding(cfg.vocab_size, E)
        self.unit = RNNWeights(cfg.cell_type, 2 * E, H, cfg.num_layers)
        self.linear = nn.Linear(H, cfg.vocab_size)
        self.init_h = nn.Linear(C, H)
        if cfg.cell_type == "lstm":
            self.init_c = nn.Linear(C, H)
        self.embed = nn.Linear(C, E)
        self.attn = AttentionNet(C, H, cfg.attention_dim)


def attention_net_hoisted(
    attn: AttentionNet, img_feat: torch.Tensor, att1: torch.Tensor, hidden: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention with ``att1 = encoder_att(img_feat)`` precomputed.
    img_feat [B, P, C] positions-major, hidden [B, H].  Returns (context
    [B, C] f32, alpha [B, P] f32); e keeps b_full, as the reference does."""
    att2 = linear_f32(attn.decoder_att, hidden)  # [B, A]
    act = F.leaky_relu(att1 + att2[:, None, :], negative_slope=0.2)
    e = linear_f32(attn.full_att, act)[..., 0]  # [B, P]
    alpha = torch.softmax(e, dim=1)
    return (img_feat.float() * alpha[..., None]).sum(dim=1), alpha


def attention_net(attn: AttentionNet, img_feat: torch.Tensor, hidden: torch.Tensor):
    """img_feat [B, P, C], hidden [B, H] -> (context [B, C], alpha [B, P])."""
    return attention_net_hoisted(attn, img_feat, linear_f32(attn.encoder_att, img_feat), hidden)


def init_hidden(decoder: AttnDecoder, cfg: AttnDecoderConfig, cnn_feature: torch.Tensor) -> State:
    """cnn_feature [B, C, P] -> hs0 [L, B, H] in the compute dtype: init_h
    of the mean over positions (taken in the feature dtype), repeated on
    every layer (rnn_attn.py:54,62).  The LSTM returns (hs0, cs0), cs0 made
    the same way by init_c (rnn_attn_LSTM.py:55,63)."""
    dtype = decoder.embeddings.weight.dtype
    pooled = cnn_feature.mean(dim=2)

    def repeat(layer):
        v = linear_f32(layer, pooled).to(dtype)
        return v[None].expand(cfg.num_layers, *v.shape).contiguous()

    hs0 = repeat(decoder.init_h)
    return (hs0, repeat(decoder.init_c)) if cfg.cell_type == "lstm" else hs0


def last_h(state: State) -> torch.Tensor:
    """The last layer's hidden state [B, H], which the attention reads (never c)."""
    return (state[0] if isinstance(state, tuple) else state)[-1]


def start_embeddings(decoder: AttnDecoder, B: int, start_token: int, device) -> torch.Tensor:
    """The first step's input: the <start> row of the embedding, [B, E]
    (from its owning shard where the decoder holds a vocabulary shard)."""
    return embed_tokens(decoder, torch.full((B,), start_token, dtype=torch.long, device=device))


def attn_greedy_decode(
    decoder: AttnDecoder,
    cfg: AttnDecoderConfig,
    cnn_feature: torch.Tensor,  # [B, C, P]
    start_token: int,
    end_token: Optional[int] = None,
) -> torch.Tensor:
    """Plain 25-step greedy decode from <start> (rnn_attn.py:77-94; the
    JAX package's attn_greedy_decode).  end_token: stop once every row
    emitted it, <pad> after it.  A decoder that holds a vocabulary shard
    takes the argmax and the fed-back rows over the mp group, as
    ``models.decoder.greedy_decode`` does.  Returns [B, T] int32 ids."""
    from show_tell_tpu_torch.ops.rnn import sharded_argmax, sharded_lookup

    B = cnn_feature.shape[0]
    feats_pm = cnn_feature.transpose(1, 2)
    att1 = linear_f32(decoder.attn.encoder_att, feats_pm)  # hoisted: constant over t
    layers = decoder.unit.layers()
    shard = getattr(decoder, "vocab_shard", None)
    argmax = sharded_argmax(shard)
    step_fn = stack_step(cfg.cell_type)

    def step(w_emb, state):
        top, state2 = attn_stack_step(decoder, step_fn, layers, feats_pm, att1, w_emb, state)
        return argmax(linear_f32(decoder.linear, top)), state2

    w0 = start_embeddings(decoder, B, start_token, cnn_feature.device)
    state0 = init_hidden(decoder, cfg, cnn_feature)
    return greedy_loop(step, sharded_lookup(shard, decoder.embeddings.weight), w0, state0, cfg.max_caption_length,
                       end_token)


def attn_stack_step(decoder: AttnDecoder, step_fn, layers, feats_pm: torch.Tensor, att1: torch.Tensor,
                    w_emb: torch.Tensor, state: State):
    """One plain attention step up to the top layer: the context of
    ``attention_net_hoisted`` from the last layer's h, ``x = cat(w_emb,
    embed(context))`` and ``step_fn`` (rnn_cells.stack_step) over
    ``layers``.  Returns (top h [B, H], new state)."""
    context, _ = attention_net_hoisted(decoder.attn, feats_pm, att1, last_h(state))
    x = torch.cat([w_emb, linear_f32(decoder.embed, context).to(w_emb.dtype)], dim=-1)
    return step_fn(layers, x, state)


def attn_decoder_forward(
    decoder: AttnDecoder,
    cfg: AttnDecoderConfig,
    cnn_feature: torch.Tensor,  # [B, C, P]
    captions: torch.Tensor,  # [B, T] int
    lengths: torch.Tensor,  # [B] int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced pass (attention.attn_decoder_forward in the JAX
    package): step t consumes captions[:, t].  Returns (predictions [B, T,
    V] f32, alphas [B, T, P] f32), both zero on rows with t >= lengths,
    whose state stays frozen from there on.  att1 is computed once."""
    feats_pm = cnn_feature.transpose(1, 2)  # [B, P, C]
    att1 = linear_f32(decoder.attn.encoder_att, feats_pm)  # hoisted: constant over t
    emb = embed_tokens(decoder, captions)  # [B, T, E]
    layers = decoder.unit.layers()
    step_fn = stack_step(cfg.cell_type)
    lengths = lengths.to(cnn_feature.device)
    state = init_hidden(decoder, cfg, cnn_feature)
    preds, alphas = [], []
    for t in range(captions.shape[1]):
        w_emb = emb[:, t]
        context, alpha = attention_net_hoisted(decoder.attn, feats_pm, att1, last_h(state))
        x = torch.cat([w_emb, linear_f32(decoder.embed, context).to(w_emb.dtype)], dim=-1)
        top, state2 = step_fn(layers, x, state)
        alive = (t < lengths)[:, None]  # [B, 1]
        if isinstance(state, tuple):
            state = tuple(torch.where(alive[None], n, o) for n, o in zip(state2, state))
        else:
            state = torch.where(alive[None], state2, state)
        preds.append(torch.where(alive, linear_f32(decoder.linear, top), 0.0))
        alphas.append(torch.where(alive, alpha, 0.0))
    return torch.stack(preds, dim=1), torch.stack(alphas, dim=1)


def doubly_stochastic_penalty(alphas: torch.Tensor, rows: Optional[int] = None) -> torch.Tensor:
    """alpha_c regularizer: ((1 - sum_t alpha)^2).mean() over [B, P]
    (main_attn.py:131).  ``rows``: the row count of the larger batch these
    B rows are one share of, the mean's denominator then being that
    batch's; by default B."""
    terms = (1.0 - alphas.sum(dim=1)) ** 2
    if rows is None:
        return terms.mean()
    return terms.sum() / (terms.shape[1] * rows)
