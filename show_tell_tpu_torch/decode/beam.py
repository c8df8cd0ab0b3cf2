"""Batched top-k beam search (counterpart of show_tell_tpu/decode/beam.py).

Cumulative log-probabilities, per-hypothesis state, <end> retirement: the
beams ride the batch axis (B x K rows through one decode step), each step
takes one top-K over the K x V (or, sparse, K x K) candidates of an image,
and the hypotheses' states are gathered by their parents.  One engine
drives both decoder families:

  * ``beam_search_decode``: the pooled GRU and LSTM; step 0 consumes the
    image feature;
  * ``attn_beam_search_decode``: the attention GRU and LSTM; step 0
    consumes <start>, and the attention context is recomputed per
    hypothesis.

Every top-K here is ``stable_topk``: of equal scores the lower index
first, ``jax.lax.top_k``'s rule, on which the retirement and early-exit
semantics below rest.  Step 0 runs the plain stack and projection (and on
a GPU the attention context kernel), as the JAX package does; the other
T - 1 steps run one of its step routes, picked by the caller:

  fused_step="dense"   one fused-step kernel launch, dense f32 logits, then
                       log_softmax and the K x V top-K in torch (the
                       default of these functions);
  fused_step="topk"    one fused-step kernel launch ending in each row's
                       top-K log-probabilities (pooled only);
  fused_step=None      the composite: the plain stack (after the attention
                       context kernel), then the projection + top-k kernel
                       when ``sparse``, else the plain projection and
                       log_softmax.

Serving (``models.captioner.captioner_beam_decode``) gives the pooled
families the route that ``ops.beam_step_default()`` names, set by an H100
A/B; tests call each route directly.

Under a vocabulary shard (``prepared["shard"]``: a rank's share of an mp
mesh, parallel/mesh.py) every family takes the sharded route whatever the
caller asked, as the JAX package's sharded projection keeps its XLA path
(show_tell_tpu/decode/beam.py:166-190,249-256,310-330): per step the
stack-step kernel (after the attention context kernel in the attention
families), the shard's logits, ``vocab_log_softmax`` over the mp group, and
the K x V top-K as ``vocab_topk``; the next tokens' rows by
``vocab_embedding``.  The fused steps and the projection + top-k kernel are
never chosen there.

``library_beam_search_decode`` and ``library_attn_beam_search_decode`` are
the eval's ``--use_pallas 0`` route, the JAX package's XLA beam
(use_pallas=False, no fused step): every step in PyTorch's own operators
from the model's weights, ``rnn_cells.stack_step`` (after
``attention_net_hoisted`` in the attention families), the f32 projection
and ``log_softmax``, through the same engine; no function that launches a
kernel of this package, nor its twin.  A decoder that holds a vocabulary
shard takes the shard's logits and the same ``vocab_*`` collectives.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from show_tell_tpu_torch.ops.vocab import project_logits, project_topk, stable_topk

NEG_INF = -1e9


def beam_engine(
    logp0: torch.Tensor,  # [B, V] log-probabilities after the first step
    state1,  # the per-image state after the first step (B rows)
    step_fn: Callable,  # (tokens [B*K] int32, state) -> (logp [B*K, V] or (logp, ids) [B*K, K], state)
    tile_state: Callable,  # state (B rows) -> state (B*K rows)
    gather_state: Callable,  # (state, parent [B, K]) -> state reordered
    K: int,
    T: int,
    end_token: int,
    pad_token: int,
    sparse: bool = False,
    early_exit: bool = False,
    gaps: Optional[List[torch.Tensor]] = None,
    shard=None,
) -> torch.Tensor:
    """Beam search over a first-step distribution and a step function.
    Returns the best hypothesis's ids [B, T] int32.

    sparse: step_fn returns each row's top-K candidates (logp, ids) instead
    of the dense [B*K, V] log-probabilities; the global top-K over K rows
    lies in the union of the rows' top-Ks, so the result is the same.

    early_exit: stop once every beam of every image has retired, at one
    host sync a step.  The ids are bit-identical to the fixed-T loop's: once
    all beams are finished each further step would keep every beam in
    place (parent = itself, token = <pad>, score unchanged; the candidates
    are the sorted scores themselves and the stable top-K returns them in
    place), which is what the skipped tail is filled with.  The ranks of an
    mp group hold the same beams, so they stop at the same step.

    gaps: a list that gets every image's gap [B] between its K-th and
    (K+1)-th best candidate score at each step, and at the end between its
    best and second-best final score (a diagnostic: the places where two
    summation orders may keep, or pick, different beams).

    shard: logp0 and the dense steps' logp are a vocabulary shard's columns
    (parallel.mesh.VocabShard): each top-K is ``vocab_topk`` over the mp
    group, whose global index r x padded + column names the parent r and
    the token."""
    B, V = logp0.shape
    device = logp0.device
    Vg = V if shard is None else shard.padded  # the global index's row pitch

    def top_k(cand):  # cand [B, R, cols]: the K best of each image's R x cols, and the diagnostic gap
        n = K + 1 if gaps is not None else K
        if shard is None:
            vals, idx = stable_topk(cand.reshape(B, -1), n)
        else:
            from show_tell_tpu_torch.parallel.mesh import vocab_topk

            vals, idx = vocab_topk(shard, cand, n)
        if gaps is not None and vals.shape[1] > K:
            gaps.append(vals[:, K - 1] - vals[:, K])
        return vals[:, :K], idx[:, :K]

    scores, toks0 = top_k(logp0[:, None])  # [B, K]
    state = tile_state(state1)
    finished = toks0 == end_token
    tokens = toks0.reshape(B * K)
    # Retired beams continue only with <pad>, at zero cost.  fill_ takes the
    # scalar as a kernel argument: an item assignment would copy it from the
    # host and sync the stream.
    lo = 0 if shard is None else shard.lo
    pad_only = torch.full((V,), NEG_INF, device=device)
    if lo <= pad_token < lo + V:  # under a shard, on the rank that owns <pad>
        pad_only.narrow(0, pad_token - lo, 1).fill_(0.0)
    pad_first = torch.full((K,), NEG_INF, device=device)
    pad_first.narrow(0, 0, 1).fill_(0.0)
    parents, toks = [], []
    for _ in range(T - 1):
        if early_exit and bool(finished.all()):  # the host sync of each step
            break
        out, state2 = step_fn(tokens, state)
        if sparse:
            clogp, cids = (o.reshape(B, K, K) for o in out)
            clogp = torch.where(finished[..., None], pad_first, clogp)
            cids = torch.where(finished[..., None], pad_token, cids)
            scores, idx = top_k(scores[..., None] + clogp)
            parent = idx // K
            new_tok = cids.reshape(B, K * K).gather(1, idx.long())
        else:
            logp = torch.where(finished[..., None], pad_only, out.reshape(B, K, V))
            scores, idx = top_k(scores[..., None] + logp)
            parent, new_tok = idx // Vg, idx % Vg
        state = gather_state(state2, parent)
        finished = finished.gather(1, parent.long()) | (new_tok == end_token)
        tokens = new_tok.reshape(B * K)
        parents.append(parent)
        toks.append(new_tok)
    skipped = T - 1 - len(parents)
    parents += [torch.arange(K, dtype=torch.int32, device=device).expand(B, K)] * skipped
    toks += [torch.full((B, K), pad_token, dtype=torch.int32, device=device)] * skipped

    if gaps is not None and K > 1:
        gaps.append(scores[:, 0] - scores[:, 1])
    # Backtrack from the best final beam (the first of equal scores).
    beam = scores.argmax(dim=1, keepdim=True)  # [B, 1]
    seq = []
    for parent, tok in zip(reversed(parents), reversed(toks)):
        seq.append(tok.gather(1, beam))
        beam = parent.gather(1, beam).long()
    seq.append(toks0.gather(1, beam))
    return torch.cat(seq[::-1], dim=1).to(torch.int32)


def _log_softmax(shard):
    """logits -> f32 log-probabilities over the whole vocabulary: torch's,
    or under a vocabulary shard ``vocab_log_softmax`` over the mp group."""
    if shard is None:
        return lambda logits: torch.log_softmax(logits, dim=-1)
    from show_tell_tpu_torch.parallel.mesh import vocab_log_softmax

    return lambda logits: vocab_log_softmax(shard, logits)


def rnn_state_helpers(B: int, K: int):
    """(tile, gather) for a recurrent state, hs [L, rows, H] or (hs, cs):
    tile repeats each image's row K times in place (``jnp.repeat``, not a
    tile of the whole batch); gather takes row b*K + parent[b, k] for beam
    (b, k).  Both return contiguous tensors, as the kernels take them."""

    def each(state, fn):
        return tuple(fn(s) for s in state) if isinstance(state, tuple) else fn(state)

    def tile(state):
        return each(state, lambda s: s.repeat_interleave(K, dim=1))

    def gather(state, parent):
        rows = (torch.arange(B, device=parent.device)[:, None] * K + parent.long()).reshape(B * K)
        return each(state, lambda s: s.index_select(1, rows))

    return tile, gather


def _check_route(fused_step, allowed) -> None:
    if fused_step not in allowed:
        raise ValueError("fused_step must be one of %s, got %r" % (allowed, fused_step))


def beam_search_decode(
    prepared: Dict[str, object],  # ops.rnn.prepare_greedy output
    cfg,  # models.decoder.DecoderConfig
    feats: torch.Tensor,  # [B, E] image features
    beam_size: int,
    end_token: int = 2,
    pad_token: int = 0,
    fused_step: Optional[str] = "dense",
    sparse: bool = False,
    early_exit: bool = False,
) -> torch.Tensor:
    """Beam search over the pooled GRU or LSTM captioner: step 0 consumes
    the image feature from a zero state.  Returns [B, T] int32 ids.
    fused_step: "dense", "topk" or None (the module docstring); sparse:
    the composite's projection + top-k kernel.  Under a vocabulary shard
    (``prepared["shard"]``) both are set aside for the sharded route."""
    from show_tell_tpu_torch.models.rnn_cells import init_state
    from show_tell_tpu_torch.ops.fused_beam import fused_dense_step, fused_topk_step
    from show_tell_tpu_torch.ops.rnn import sharded_lookup, stack_kernel, stack_plain

    _check_route(fused_step, ("dense", "topk", None))
    B = feats.shape[0]
    K = beam_size
    stacked, vocab, embedding = prepared["stacked"], prepared["vocab"], prepared["embedding"]
    shard = prepared.get("shard")
    log_softmax, lookup = _log_softmax(shard), sharded_lookup(shard, embedding)
    stack = stack_plain(cfg.cell_type)
    state0 = init_state(cfg.cell_type, cfg.num_layers, B, cfg.hidden_dim, embedding.dtype, feats.device)
    top, state1 = stack(stacked, feats.to(embedding.dtype), state0)
    logp0 = log_softmax(project_logits(vocab, top))

    def sharded_step(tokens, state):
        top, state2 = stack_kernel(cfg.cell_type)(stacked, lookup(tokens), state)
        return log_softmax(project_logits(vocab, top)), state2

    def step_fn(tokens, state):
        x = embedding.index_select(0, tokens)
        if fused_step == "dense":
            logits, state2 = fused_dense_step(stacked, vocab, x, state)
            return torch.log_softmax(logits, dim=-1), state2
        if fused_step == "topk":
            return fused_topk_step(stacked, vocab, x, state, K)
        top, state2 = stack(stacked, x, state)
        if sparse:
            return project_topk(vocab, top.contiguous(), K), state2
        return torch.log_softmax(project_logits(vocab, top), dim=-1), state2

    tile, gather = rnn_state_helpers(B, K)
    if shard is not None:
        return beam_engine(logp0, state1, sharded_step, tile, gather, K, cfg.max_caption_length, end_token,
                           pad_token, early_exit=early_exit, shard=shard)
    return beam_engine(
        logp0, state1, step_fn, tile, gather, K, cfg.max_caption_length, end_token, pad_token,
        sparse=fused_step == "topk" or (fused_step is None and sparse), early_exit=early_exit,
    )


def attn_beam_search_decode(
    weights: Dict[str, object],  # ops.fused_attn.prepare_attn_weights output
    decoder,  # models.attention.AttnDecoder
    cfg,  # models.attention.AttnDecoderConfig
    cnn_feature: torch.Tensor,  # [B, C, P]
    beam_size: int,
    start_token: int = 1,
    end_token: int = 2,
    pad_token: int = 0,
    fused_step: Optional[str] = "dense",
    sparse: bool = False,
    early_exit: bool = False,
) -> torch.Tensor:
    """Beam search over the attention GRU or LSTM captioner: step 0
    consumes <start> from init_hidden.  fused_step="dense" takes the fused
    attention step when H <= 2E (``fused_attn_fits``), else the composite,
    as fused_step=None does: the attention context kernel over the beam
    rows' features, ``embed(context)`` and the stack in plain torch, then
    the projection + top-k kernel when ``sparse``, else the plain
    projection and log_softmax.  Under a vocabulary shard
    (``weights["shard"]``) both are set aside for the sharded route: the
    context kernel, the stack-step kernel, the shard's logits and
    ``vocab_log_softmax``.  Returns [B, T] int32 ids."""
    from show_tell_tpu_torch.models.attention import init_hidden, last_h, linear_f32, start_embeddings
    from show_tell_tpu_torch.ops.attention import attention_context, precompute_att1
    from show_tell_tpu_torch.ops.fused_attn import (
        fused_attn_dense_step,
        fused_attn_fits,
        fused_attn_lstm_dense_step,
        prepare_attn_decode,
    )
    from show_tell_tpu_torch.ops.rnn import sharded_lookup, stack_kernel, stack_plain

    _check_route(fused_step, ("dense", None))
    B = cnn_feature.shape[0]
    K = beam_size
    embedding = decoder.embeddings.weight
    vocab = weights["vocab"]
    shard = weights.get("shard")
    log_softmax, lookup = _log_softmax(shard), sharded_lookup(shard, embedding)
    feats_pm = cnn_feature.transpose(1, 2).contiguous()
    att1 = precompute_att1(decoder.attn, feats_pm).to(embedding.dtype).contiguous()

    def trunk(w_emb, feats, a1, state, stack=stack_plain(cfg.cell_type)):
        context, _ = attention_context(weights, feats, a1, last_h(state))
        x = torch.cat([w_emb, linear_f32(decoder.embed, context).to(w_emb.dtype)], dim=-1)
        return stack(weights["stacked"], x, state)

    state0 = init_hidden(decoder, cfg, cnn_feature)
    top0, state1 = trunk(start_embeddings(decoder, B, start_token, cnn_feature.device), feats_pm, att1, state0)
    logp0 = log_softmax(project_logits(vocab, top0))
    tile, gather = rnn_state_helpers(B, K)

    if shard is not None:
        feats_rows = feats_pm.repeat_interleave(K, dim=0)
        att1_rows = att1.repeat_interleave(K, dim=0)

        def sharded_step(tokens, state):
            top, state2 = trunk(lookup(tokens), feats_rows, att1_rows, state, stack_kernel(cfg.cell_type))
            return log_softmax(project_logits(vocab, top)), state2

        return beam_engine(logp0, state1, sharded_step, tile, gather, K, cfg.max_caption_length, end_token,
                           pad_token, early_exit=early_exit, shard=shard)

    if fused_step == "dense" and fused_attn_fits(cfg.hidden_dim, cfg.embed_dim):
        prep = prepare_attn_decode(weights, decoder, feats_pm)
        prep = dict(prep, feats_e=prep["feats_e"].repeat_interleave(K, dim=0),
                    att1=prep["att1"].repeat_interleave(K, dim=0))
        dense = fused_attn_lstm_dense_step if cfg.cell_type == "lstm" else fused_attn_dense_step

        def step_fn(tokens, state):
            logits, state2 = dense(prep, embedding.index_select(0, tokens), state)
            return torch.log_softmax(logits, dim=-1), state2

        fused = True
    else:
        # The per-hypothesis features ([B*K, P, C]) only where a step reads them.
        feats_rows = feats_pm.repeat_interleave(K, dim=0)
        att1_rows = att1.repeat_interleave(K, dim=0)

        def step_fn(tokens, state):
            top, state2 = trunk(embedding.index_select(0, tokens), feats_rows, att1_rows, state)
            if sparse:
                return project_topk(vocab, top.contiguous(), K), state2
            return torch.log_softmax(project_logits(vocab, top), dim=-1), state2

        fused = False

    return beam_engine(
        logp0, state1, step_fn, tile, gather, K, cfg.max_caption_length, end_token, pad_token,
        sparse=sparse and not fused, early_exit=early_exit,
    )


def library_beam_search_decode(
    decoder,  # models.decoder.Decoder
    cfg,  # models.decoder.DecoderConfig
    feats: torch.Tensor,  # [B, E] image features
    beam_size: int,
    end_token: int = 2,
    pad_token: int = 0,
    early_exit: bool = False,
) -> torch.Tensor:
    """``beam_search_decode`` by the library route (the module docstring):
    step 0 consumes the image feature from a zero state, each step is
    ``stack_step`` over the decoder's layers, the f32 projection and
    ``log_softmax``.  Returns [B, T] int32 ids."""
    from show_tell_tpu_torch.models.decoder import linear_f32
    from show_tell_tpu_torch.models.rnn_cells import init_state, stack_step
    from show_tell_tpu_torch.ops.rnn import sharded_lookup

    B, K = feats.shape[0], beam_size
    shard, embedding = getattr(decoder, "vocab_shard", None), decoder.embeddings.weight
    log_softmax, lookup = _log_softmax(shard), sharded_lookup(shard, embedding)
    layers, step = decoder.unit.layers(), stack_step(cfg.cell_type)
    state0 = init_state(cfg.cell_type, cfg.num_layers, B, cfg.hidden_dim, embedding.dtype, feats.device)
    top, state1 = step(layers, feats.to(embedding.dtype), state0)

    def step_fn(tokens, state):
        top, state2 = step(layers, lookup(tokens), state)
        return log_softmax(linear_f32(decoder.linear, top)), state2

    tile, gather = rnn_state_helpers(B, K)
    return beam_engine(log_softmax(linear_f32(decoder.linear, top)), state1, step_fn, tile, gather, K,
                       cfg.max_caption_length, end_token, pad_token, early_exit=early_exit, shard=shard)


def library_attn_beam_search_decode(
    decoder,  # models.attention.AttnDecoder
    cfg,  # models.attention.AttnDecoderConfig
    cnn_feature: torch.Tensor,  # [B, C, P]
    beam_size: int,
    start_token: int = 1,
    end_token: int = 2,
    pad_token: int = 0,
    early_exit: bool = False,
) -> torch.Tensor:
    """``attn_beam_search_decode`` by the library route: step 0 consumes
    <start> from init_hidden; each step is ``attention_net_hoisted`` over
    the beam rows' features (att1 hoisted, in f32), ``embed(context)``,
    ``stack_step``, the f32 projection and ``log_softmax``.  Returns [B, T]
    int32 ids."""
    from show_tell_tpu_torch.models.attention import attn_stack_step, init_hidden, start_embeddings
    from show_tell_tpu_torch.models.decoder import linear_f32
    from show_tell_tpu_torch.models.rnn_cells import stack_step
    from show_tell_tpu_torch.ops.rnn import sharded_lookup

    B, K = cnn_feature.shape[0], beam_size
    shard = getattr(decoder, "vocab_shard", None)
    log_softmax, lookup = _log_softmax(shard), sharded_lookup(shard, decoder.embeddings.weight)
    layers, step = decoder.unit.layers(), stack_step(cfg.cell_type)
    feats_pm = cnn_feature.transpose(1, 2)
    att1 = linear_f32(decoder.attn.encoder_att, feats_pm)  # hoisted: constant over t
    w0 = start_embeddings(decoder, B, start_token, cnn_feature.device)
    top0, state1 = attn_stack_step(decoder, step, layers, feats_pm, att1, w0, init_hidden(decoder, cfg, cnn_feature))
    feats_rows, att1_rows = feats_pm.repeat_interleave(K, dim=0), att1.repeat_interleave(K, dim=0)

    def step_fn(tokens, state):
        top, state2 = attn_stack_step(decoder, step, layers, feats_rows, att1_rows, lookup(tokens), state)
        return log_softmax(linear_f32(decoder.linear, top)), state2

    tile, gather = rnn_state_helpers(B, K)
    return beam_engine(log_softmax(linear_f32(decoder.linear, top0)), state1, step_fn, tile, gather, K,
                       cfg.max_caption_length, end_token, pad_token, early_exit=early_exit, shard=shard)
