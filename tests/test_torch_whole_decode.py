"""The port's whole greedy decode (ops/whole_decode.py) and the routes of
``greedy_decode_kernel`` against the JAX package, on the CPU.

The same seeded JAX decoder weights (the JAX package's own init) go into
``gru_whole_greedy_decode_pallas`` in interpret mode (as
tests/test_pallas_ops.py runs it, block_v=32) and the XLA ``greedy_decode``,
and, in the torch layout, into the port, whose wrapper runs the plain twin
for CPU tensors.  Sizes: L <= 3, H <= 64, V = 70 (not a multiple of the
vocab block) and 128, T <= 9; the tie case E = H = 16, V = 64, block 16.
Ids must be bit-equal, f32 and bf16.

The bf16 kernel runs each step on the tensor cores (csrc/dense_mma.cuh):
the GRU layers and the argmax end's key merge of the per-step kernel, then
its own token phase, which feeds the winner's embedding row back.  Its
order of work is re-enacted here in f32 (tests/test_torch_gate_tiles.py's
lane-by-lane tiles, tests/test_torch_argmax_tiles.py's thread-by-thread
end) over T steps at E=16, H=24, L=2, V = 40 and 77, and held to the twin
and to the interpreted Pallas kernel on the rows whose top-2 gaps clear
GAP at every step; a tie across the first 64-row vocabulary item goes to
the lower index at every step, and that index's row is fed back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from show_tell_tpu.models.decoder import greedy_decode as jax_greedy_decode
from show_tell_tpu.models.decoder import init_decoder_params
from show_tell_tpu.ops.whole_decode_pallas import gru_whole_greedy_decode_pallas
from show_tell_tpu_torch import ops as port_ops
from show_tell_tpu_torch.ops import whole_decode as port_whole
from show_tell_tpu_torch.ops.rnn import greedy_decode_kernel, gru_stack_plain, prepare_greedy
from show_tell_tpu_torch.ops.vocab import project_logits
from show_tell_tpu_torch.ops.whole_decode import gru_whole_greedy_decode, gru_whole_greedy_decode_plain
from test_torch_argmax_tiles import tiled_argmax
from test_torch_gate_tiles import tiled_logits, tiled_stack

CASES = [(32, 64, 70, 3, 8, 9), (64, 64, 128, 1, 4, 5)]  # (E, H, V, L, B, T)
GAP = 1e-4  # f32: ids agree where each step's top-2 logit gap exceeds the summation order's reach


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _prepared(params, dtype=torch.float32):
    """prepare_greedy of a JAX decoder tree (w_ih [in, G*H], linear w [H, V])."""
    layers = [{k: t(v).T if np.ndim(v) == 2 else t(v) for k, v in layer.items()} for layer in params["rnn"]]
    return prepare_greedy(layers, t(params["embedding"]), t(params["linear"]["w"]).T, t(params["linear"]["b"]), dtype)


def _case(E, H, V, L, B, T, seed, cell="gru"):
    cfg = JaxDecoderConfig(cell, E, H, V, L, max_caption_length=T)
    params = init_decoder_params(jax.random.PRNGKey(seed), cfg)
    feat = np.random.RandomState(seed).randn(B, E).astype(np.float32)
    return cfg, params, feat


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,case", list(enumerate(CASES)))
def test_whole_decode_twin_bit_equal_to_pallas_and_xla(seed, case, dtype):
    """The twin's ids against the interpreted whole-decode kernel and the XLA
    scan, bit for bit; the wrapper runs the twin for CPU tensors without
    counting a launch."""
    E, H, V, L, B, T = case
    cfg, params, feat = _case(*case, seed=seed)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jparams = jax.tree.map(lambda a: a.astype(jd), params)
    jfeat = jnp.asarray(feat).astype(jd)
    ref_pallas = np.asarray(gru_whole_greedy_decode_pallas(jparams, cfg, jfeat, block_v=32, interpret=True))
    ref_xla = np.asarray(jax_greedy_decode(jparams, cfg, jfeat))
    prepared = _prepared(params, td)
    before = gru_whole_greedy_decode.launches
    got = gru_whole_greedy_decode(prepared, t(feat), T)
    assert gru_whole_greedy_decode.launches == before
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, T)
    np.testing.assert_array_equal(got.numpy(), ref_pallas)
    np.testing.assert_array_equal(got.numpy(), ref_xla)


def test_whole_decode_ties_take_the_first_index_and_feed_back_its_row():
    """A tie inside a vocab block (columns 3 and 5) and its duplicate in a
    later block (37) resolve to 3 at every step; a strictly greater 37
    displaces it, and its embedding row is the one fed back (the XLA scan
    and the interpreted kernel agree with the twin on every step)."""
    E, H, V, L, B, T, block = 16, 16, 64, 1, 4, 6, 16
    cfg, params, feat = _case(E, H, V, L, B, T, seed=2)
    params["linear"]["w"] = jnp.zeros((H, V), jnp.float32)
    params["linear"]["b"] = jnp.zeros((V,), jnp.float32).at[jnp.array([3, 5, 37])].set(7.0)
    for winner, bias37 in ((3, 7.0), (37, 8.0)):
        params["linear"]["b"] = params["linear"]["b"].at[37].set(bias37)
        ref = np.asarray(jax_greedy_decode(params, cfg, jnp.asarray(feat)))
        ref_pallas = np.asarray(gru_whole_greedy_decode_pallas(params, cfg, jnp.asarray(feat), block_v=block,
                                                               interpret=True))
        got = gru_whole_greedy_decode_plain(_prepared(params), t(feat), T).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, ref_pallas)
        assert (got == winner).all()


def tiled_whole_decode(prepared, feats, T):
    """The bf16 kernel's order of work, in f32: T times the L layers
    (tiled_stack, mma_stack_layer's tiles) and the argmax end's key merge
    into best (tiled_argmax), then the token phase: each row's token from
    its key, and emb[tok] as the next step's layer-0 input.  Returns (ids
    [B, T] int32, each row's smallest top-2 gap of the step's logits, the
    rows fed back at steps 1..T-1 [T-1, B, E], the final state)."""
    stacked, vocab, emb = prepared["stacked"], prepared["vocab"], prepared["embedding"].numpy()
    wv, bv = vocab["w"].numpy(), vocab["b"].numpy()
    L, _, H = stacked["w_hh"].shape
    x, hs = feats.numpy(), np.zeros((L, feats.shape[0], H), np.float32)
    ids, gaps, fed = [], [], []
    for step in range(T):
        top, hs = tiled_stack("gru", stacked, torch.from_numpy(x), torch.from_numpy(hs))
        tok, _ = tiled_argmax(top, wv, bv)
        logits = np.sort(tiled_logits(top, wv, bv), axis=1)
        ids.append(tok)
        gaps.append(logits[:, -1] - logits[:, -2])
        if step + 1 < T:
            x = emb[tok]
            fed.append(x)
    return np.stack(ids, 1), np.min(gaps, axis=0), np.array(fed), hs


TILE_CASES = [(16, 24, 40, 2, 19, 4), (16, 24, 77, 2, 33, 6)]  # (E, H, V, L, B, T): one and two 32-row slabs


@pytest.mark.parametrize("seed,case", list(enumerate(TILE_CASES)))
def test_tiled_whole_decode_matches_plain_and_pallas(seed, case):
    """The bf16 kernel's tiles, step by step: ids equal to the twin's and to
    the interpreted whole-decode kernel's on every row whose top-2 gaps
    all clear GAP (most rows), and each step's fed-back rows the embedding
    rows of that step's ids."""
    E, H, V, L, B, T = case
    cfg, params, feat = _case(*case, seed=40 + seed)
    prepared = _prepared(params)
    ids, gaps, fed, _ = tiled_whole_decode(prepared, t(feat), T)
    clear = gaps > GAP
    assert clear.mean() > 0.8
    ref = gru_whole_greedy_decode_plain(prepared, t(feat), T).numpy()
    ref_pallas = np.asarray(gru_whole_greedy_decode_pallas(params, cfg, jnp.asarray(feat), block_v=32,
                                                           interpret=True))
    np.testing.assert_array_equal(ids[clear], ref[clear])
    np.testing.assert_array_equal(ids[clear], ref_pallas[clear])
    np.testing.assert_array_equal(fed, prepared["embedding"].numpy()[ids[:, :-1].T])


def test_tiled_whole_decode_tie_across_a_vocab_item_takes_the_lower_index():
    """Columns 63 and 64, either side of the first 64-row vocabulary item,
    equal and top in every row (one weight, 1/4 at h column 0, and bias
    50: each logit rounds once, in any summation order): the tiles, the
    twin and the interpreted kernel give 63 at every step, and the rows
    fed back are row 63's (the final state equals a plain stack fed row
    63, not row 64, after step 0)."""
    E, H, V, L, B, T = 16, 24, 77, 2, 19, 5
    cfg, params, feat = _case(E, H, V, L, B, T, seed=9)
    w = np.array(params["linear"]["w"])
    b = np.array(params["linear"]["b"])
    w[:, 63] = w[:, 64] = 0.0
    w[0, 63] = w[0, 64] = 0.25
    b[63] = b[64] = 50.0
    params["linear"] = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    prepared = _prepared(params)
    emb = prepared["embedding"]
    assert not torch.equal(emb[63], emb[64])
    ids, _, fed, hs = tiled_whole_decode(prepared, t(feat), T)
    ref = gru_whole_greedy_decode_plain(prepared, t(feat), T).numpy()
    ref_pallas = np.asarray(gru_whole_greedy_decode_pallas(params, cfg, jnp.asarray(feat), block_v=32,
                                                           interpret=True))
    for got in (ids, ref, ref_pallas):
        assert (got == 63).all()
    np.testing.assert_array_equal(fed, np.broadcast_to(emb[63].numpy(), fed.shape))
    x, ref_hs = t(feat), torch.zeros(L, B, H)
    for _ in range(T):
        top, ref_hs = gru_stack_plain(prepared["stacked"], x, ref_hs)
        logits = project_logits(prepared["vocab"], top)
        assert torch.equal(logits[:, 63], logits[:, 64])  # the twin's product ties them bit for bit
        x = emb[63].expand(B, E)
    np.testing.assert_allclose(hs, ref_hs.numpy(), rtol=1e-5, atol=1e-5)


def test_greedy_decode_kernel_routes(monkeypatch):
    """whole_decode=True takes the whole-decode route once; an end token,
    whole_decode=False, a sharded projection and the LSTM take the per-step
    routes; None reads whole_decode_default().  Every route gives the
    same ids (the early-exit ones before each row's <end>)."""
    calls = []
    real = port_whole.gru_whole_greedy_decode
    monkeypatch.setattr(port_whole, "gru_whole_greedy_decode", lambda *a: calls.append(1) or real(*a))
    T = CASES[0][-1]
    _, params, feat = _case(*CASES[0], seed=6)
    prepared, feats = _prepared(params), t(feat)
    whole = greedy_decode_kernel(prepared, feats, T, whole_decode=True)
    assert calls == [1]
    end = int(whole[0, 2])
    monkeypatch.setattr(port_ops, "whole_decode_default", lambda: False)
    for kw in (dict(whole_decode=False), dict(whole_decode=True, vocab_sharded=True), dict(whole_decode=None)):
        np.testing.assert_array_equal(greedy_decode_kernel(prepared, feats, T, **kw).numpy(), whole.numpy())
    early = greedy_decode_kernel(prepared, feats, T, end_token=end, whole_decode=True).numpy()
    assert calls == [1]
    for row, fixed in zip(early, whole.numpy()):
        stop = int(np.argmax(fixed == end)) + 1 if (fixed == end).any() else T
        np.testing.assert_array_equal(row[:stop], fixed[:stop])
        assert (row[stop:] == 0).all()
    monkeypatch.setattr(port_ops, "whole_decode_default", lambda: True)
    np.testing.assert_array_equal(greedy_decode_kernel(prepared, feats, T).numpy(), whole.numpy())
    assert calls == [1, 1]
    lcfg, lparams, lfeat = _case(*CASES[0], seed=7, cell="lstm")
    lstm = greedy_decode_kernel(_prepared(lparams), t(lfeat), T, whole_decode=True).numpy()
    assert calls == [1, 1]
    np.testing.assert_array_equal(lstm, np.asarray(jax_greedy_decode(lparams, lcfg, jnp.asarray(lfeat))))
