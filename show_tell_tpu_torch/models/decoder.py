"""The pooled GRU and LSTM caption decoders and their greedy loops
(counterpart of show_tell_tpu/models/decoder.py).

Parameter names are the reference's (rnn.py:23-25, LSTM/rnn_lstm.py):
``embeddings.weight``, ``unit.weight_ih_l{k}``, ``unit.weight_hh_l{k}``,
``unit.bias_ih_l{k}``, ``unit.bias_hh_l{k}``, ``linear.weight``,
``linear.bias``.  The recurrence is never run through ``nn.GRU`` or
``nn.LSTM``: greedy decode steps with the plain cell here or with the
fused kernel (ops/rnn.py).

Training (rnn.py:27-35): ``decoder_forward`` prepends the image feature as
the step-0 input and drops the last embedding, so position j consumes
``feat`` (j=0) or ``emb(w_{j-1})`` and predicts w_j; ``masked_cross_entropy``
averages over the positions j < length, which is the reference's CE over
its packed sequence.

Decode (rnn.py:37-58): a fixed 25 greedy steps, the argmax fed back
through the embedding.  The early-exit loop stops once every row has
emitted <end> and writes <pad> (0) after it; rows before <end> equal the
fixed loop's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Union

import torch
import torch.nn as nn

import torch.nn.functional as F

from show_tell_tpu_torch.models.rnn_cells import init_state, rnn_scan, stack_step


class DecoderConfig(NamedTuple):
    cell_type: str  # 'gru' | 'lstm'
    embed_dim: int
    hidden_dim: int
    vocab_size: int
    num_layers: int
    max_caption_length: int = 25  # reference rnn.py:39


GATES = {"gru": 3, "lstm": 4}


class RNNWeights(nn.Module):
    """A stacked GRU's or LSTM's parameters under nn.GRU's and nn.LSTM's
    names, without their forward: G = 3 (GRU) or 4 (LSTM) gate blocks of H
    rows each."""

    def __init__(self, cell_type: str, input_dim: int, hidden_dim: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        GH = GATES[cell_type] * hidden_dim
        for l in range(num_layers):
            in_dim = input_dim if l == 0 else hidden_dim
            self.register_parameter("weight_ih_l%d" % l, nn.Parameter(torch.empty(GH, in_dim)))
            self.register_parameter("weight_hh_l%d" % l, nn.Parameter(torch.empty(GH, hidden_dim)))
            self.register_parameter("bias_ih_l%d" % l, nn.Parameter(torch.empty(GH)))
            self.register_parameter("bias_hh_l%d" % l, nn.Parameter(torch.empty(GH)))

    def layers(self) -> List[Dict[str, torch.Tensor]]:
        """Per-layer {w_ih [G*H,in], w_hh [G*H,H], b_ih [G*H], b_hh [G*H]}."""
        return [
            {
                "w_ih": getattr(self, "weight_ih_l%d" % l),
                "w_hh": getattr(self, "weight_hh_l%d" % l),
                "b_ih": getattr(self, "bias_ih_l%d" % l),
                "b_hh": getattr(self, "bias_hh_l%d" % l),
            }
            for l in range(self.num_layers)
        ]


class Decoder(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.embeddings = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.unit = RNNWeights(cfg.cell_type, cfg.embed_dim, cfg.hidden_dim, cfg.num_layers)
        self.linear = nn.Linear(cfg.hidden_dim, cfg.vocab_size)


def linear_f32(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W^T + b`` with products summed in f32 (the JAX package's
    ``_linear``: dot with preferred_element_type=f32, plus the bias).  The
    operands are upcast before the product: a bf16 product is exact in f32,
    so only the order of the sums can differ."""
    return x.float() @ layer.weight.float().T + layer.bias.float()


def embed_tokens(decoder: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens`` (any shape of global ids): a lookup
    in ``decoder.embeddings``, or where the decoder holds a vocabulary
    shard (``parallel.mesh.decoder_vocab_shard``) the mp group's
    ``vocab_embedding``."""
    shard = getattr(decoder, "vocab_shard", None)
    if shard is None:
        return F.embedding(tokens.long(), decoder.embeddings.weight)
    from show_tell_tpu_torch.parallel.mesh import vocab_embedding

    return vocab_embedding(shard, tokens, decoder.embeddings.weight)


def _lookup(embedding: Union[torch.Tensor, Callable]) -> Callable:
    """A table's row lookup, or ``embedding`` itself where it is a lookup (tokens -> rows)."""
    return embedding if callable(embedding) else (lambda tok: embedding.index_select(0, tok))


def greedy_loop(
    step: Callable, embedding: Union[torch.Tensor, Callable], x0, state0, T: int, end_token: Optional[int] = None
) -> torch.Tensor:
    """Run ``step(x, state) -> (tok, state)`` T times, feeding back
    ``embedding[tok]`` (``embedding``: the table, or a lookup tokens ->
    rows, such as a vocabulary shard's).  Returns [B, T] int32 ids.
    end_token: run ``greedy_early_exit_loop`` instead."""
    if end_token is not None:
        return greedy_early_exit_loop(step, embedding, x0, state0, T, end_token)
    lookup = _lookup(embedding)
    x, state, toks = x0, state0, []
    for _ in range(T):
        tok, state = step(x, state)
        toks.append(tok)
        x = lookup(tok)
    return torch.stack(toks, dim=1).to(torch.int32)


def greedy_early_exit_loop(
    step: Callable, embedding: Union[torch.Tensor, Callable], x0, state0, T: int, end_token: int
) -> torch.Tensor:
    """``greedy_loop`` that stops once every row has emitted ``end_token``
    (or after T steps).  Positions after a row's first <end> are <pad> (0);
    rows and steps before it equal the fixed loop's."""
    B = x0.shape[0]
    lookup = _lookup(embedding)
    toks = torch.zeros(B, T, dtype=torch.int32, device=x0.device)
    done = torch.zeros(B, dtype=torch.bool, device=x0.device)
    x, state = x0, state0
    for t in range(T):
        tok, state = step(x, state)
        tok = torch.where(done, torch.zeros_like(tok), tok)
        toks[:, t] = tok
        done = done | (tok == end_token)
        if bool(done.all()):  # one host sync per step: the price of stopping early
            break
        x = lookup(tok)
    return toks


def greedy_decode(
    decoder: Decoder,
    cfg: DecoderConfig,
    feats: torch.Tensor,  # [B, E]
    end_token: Optional[int] = None,
) -> torch.Tensor:
    """Plain batched greedy decode: the per-layer cell, ``top @ W^T + b``
    in f32 and the first-max argmax (decoder.greedy_decode in the JAX
    package).  Computes in the embedding's dtype, from a zero state.
    Where the decoder holds a vocabulary shard, the logits are its columns
    and the argmax and the fed-back rows are the mp group's
    (``ops.rnn.sharded_argmax``, ``sharded_lookup``).  Returns [B, T] ids."""
    from show_tell_tpu_torch.ops.rnn import sharded_argmax, sharded_lookup

    layers, embedding = decoder.unit.layers(), decoder.embeddings.weight
    shard = getattr(decoder, "vocab_shard", None)
    argmax = sharded_argmax(shard)
    state0 = init_state(cfg.cell_type, cfg.num_layers, feats.shape[0], cfg.hidden_dim, embedding.dtype, feats.device)
    step_fn = stack_step(cfg.cell_type)

    def step(x, state):
        top, state2 = step_fn(layers, x, state)
        return argmax(linear_f32(decoder.linear, top)), state2

    return greedy_loop(step, sharded_lookup(shard, embedding), feats.to(embedding.dtype), state0,
                       cfg.max_caption_length, end_token)


def decoder_forward(
    decoder: Decoder,
    cfg: DecoderConfig,
    cnn_feature: torch.Tensor,  # [B, E]
    captions: torch.Tensor,  # [B, T] int
    lengths: torch.Tensor,  # [B] int
) -> torch.Tensor:
    """Teacher-forced logits [B, T, V] in f32; position j predicts
    captions[:, j] (decoder.decoder_forward in the JAX package).  Computes
    in the embedding's dtype from a zero state, layer-major (``rnn_scan``).
    Only positions j < lengths are meaningful; the loss masks the rest."""
    emb = embed_tokens(decoder, captions)  # [B, T, E]
    inputs = torch.cat([cnn_feature.to(emb.dtype)[:, None, :], emb[:, :-1, :]], dim=1)
    state = init_state(cfg.cell_type, cfg.num_layers, captions.shape[0], cfg.hidden_dim, inputs.dtype,
                       inputs.device)
    outs, _ = rnn_scan(decoder.unit.layers(), cfg.cell_type, inputs, state)
    return linear_f32(decoder.linear, outs)


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, lengths: torch.Tensor,
                         count: Optional[torch.Tensor] = None, shard=None) -> torch.Tensor:
    """Mean CE over the positions t < lengths of f32 logits [B, T, V]: the
    reference's CrossEntropyLoss over pack_padded_sequence data
    (main.py:145,149).  ``count``: the denominator where these rows are
    one share of a larger batch (that batch's token count); by default
    this batch's own.  ``shard``: the logits are a vocabulary shard's
    columns (``parallel.mesh.VocabShard``): the logsumexp is taken over the
    mp group and each target's logit from its owning shard."""
    T = logits.shape[1]
    mask = (torch.arange(T, device=logits.device)[None, :] < lengths.to(logits.device)[:, None]).float()
    if shard is not None:
        from show_tell_tpu_torch.parallel.mesh import vocab_logsumexp, vocab_target_logit

        logz, tok = vocab_logsumexp(shard, logits), vocab_target_logit(shard, logits, targets)
        return ((logz - tok) * mask).sum() / (mask.sum() if count is None else count)
    logz = torch.logsumexp(logits, dim=-1)  # [B, T]
    tok = logits.gather(-1, targets.long()[..., None])[..., 0]
    return ((logz - tok) * mask).sum() / (mask.sum() if count is None else count)
