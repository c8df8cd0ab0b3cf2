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
    place), which is what the skipped tail is filled with.

    gaps: a list that gets every image's gap [B] between its K-th and
    (K+1)-th best candidate score at each step, and at the end between its
    best and second-best final score (a diagnostic: the places where two
    summation orders may keep, or pick, different beams)."""
    B, V = logp0.shape
    device = logp0.device

    def top_k(cand):  # the K best of each row, and the diagnostic gap
        vals, idx = stable_topk(cand, K + 1 if gaps is not None else K)
        if gaps is not None and vals.shape[1] > K:
            gaps.append(vals[:, K - 1] - vals[:, K])
        return vals[:, :K], idx[:, :K]

    scores, toks0 = top_k(logp0)  # [B, K]
    state = tile_state(state1)
    finished = toks0 == end_token
    tokens = toks0.reshape(B * K)
    # Retired beams continue only with <pad>, at zero cost.
    pad_only = torch.full((V,), NEG_INF, device=device)
    pad_only[pad_token] = 0.0
    pad_first = torch.full((K,), NEG_INF, device=device)
    pad_first[0] = 0.0
    parents, toks = [], []
    for _ in range(T - 1):
        if early_exit and bool(finished.all()):  # the host sync of each step
            break
        out, state2 = step_fn(tokens, state)
        if sparse:
            clogp, cids = (o.reshape(B, K, K) for o in out)
            clogp = torch.where(finished[..., None], pad_first, clogp)
            cids = torch.where(finished[..., None], pad_token, cids)
            scores, idx = top_k((scores[..., None] + clogp).reshape(B, K * K))
            parent = idx // K
            new_tok = cids.reshape(B, K * K).gather(1, idx.long())
        else:
            logp = torch.where(finished[..., None], pad_only, out.reshape(B, K, V))
            scores, idx = top_k((scores[..., None] + logp).reshape(B, K * V))
            parent, new_tok = idx // V, idx % V
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
    the composite's projection + top-k kernel."""
    from show_tell_tpu_torch.models.rnn_cells import init_state
    from show_tell_tpu_torch.ops.fused_beam import fused_dense_step, fused_topk_step
    from show_tell_tpu_torch.ops.rnn import stack_plain

    _check_route(fused_step, ("dense", "topk", None))
    B = feats.shape[0]
    K = beam_size
    stacked, vocab, embedding = prepared["stacked"], prepared["vocab"], prepared["embedding"]
    stack = stack_plain(cfg.cell_type)
    state0 = init_state(cfg.cell_type, cfg.num_layers, B, cfg.hidden_dim, embedding.dtype, feats.device)
    top, state1 = stack(stacked, feats.to(embedding.dtype), state0)
    logp0 = torch.log_softmax(project_logits(vocab, top), dim=-1)

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
    projection and log_softmax.  Returns [B, T] int32 ids."""
    from show_tell_tpu_torch.models.attention import init_hidden, last_h, linear_f32, start_embeddings
    from show_tell_tpu_torch.ops.attention import attention_context, precompute_att1
    from show_tell_tpu_torch.ops.fused_attn import (
        fused_attn_dense_step,
        fused_attn_fits,
        fused_attn_lstm_dense_step,
        prepare_attn_decode,
    )
    from show_tell_tpu_torch.ops.rnn import stack_plain

    _check_route(fused_step, ("dense", None))
    B = cnn_feature.shape[0]
    K = beam_size
    embedding = decoder.embeddings.weight
    vocab = weights["vocab"]
    feats_pm = cnn_feature.transpose(1, 2).contiguous()
    att1 = precompute_att1(decoder.attn, feats_pm).to(embedding.dtype).contiguous()
    stack = stack_plain(cfg.cell_type)

    def trunk(w_emb, feats, a1, state):
        context, _ = attention_context(weights, feats, a1, last_h(state))
        x = torch.cat([w_emb, linear_f32(decoder.embed, context).to(w_emb.dtype)], dim=-1)
        return stack(weights["stacked"], x, state)

    state0 = init_hidden(decoder, cfg, cnn_feature)
    top0, state1 = trunk(start_embeddings(decoder, B, start_token, cnn_feature.device), feats_pm, att1, state0)
    logp0 = torch.log_softmax(project_logits(vocab, top0), dim=-1)

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

    tile, gather = rnn_state_helpers(B, K)
    return beam_engine(
        logp0, state1, step_fn, tile, gather, K, cfg.max_caption_length, end_token, pad_token,
        sparse=sparse and not fused, early_exit=early_exit,
    )
