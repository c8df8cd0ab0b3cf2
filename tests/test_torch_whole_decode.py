"""The port's whole greedy decode (ops/whole_decode.py) and the routes of
``greedy_decode_kernel`` against the JAX package, on the CPU.

The same seeded JAX decoder weights (the JAX package's own init) go into
``gru_whole_greedy_decode_pallas`` in interpret mode (as
tests/test_pallas_ops.py runs it, block_v=32) and the XLA ``greedy_decode``,
and, in the torch layout, into the port, whose wrapper runs the plain twin
for CPU tensors.  Sizes: L <= 3, H <= 64, V = 70 (not a multiple of the
vocab block) and 128, T <= 9; the tie case E = H = 16, V = 64, block 16.
Ids must be bit-equal, f32 and bf16.
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
from show_tell_tpu_torch.ops.rnn import greedy_decode_kernel, prepare_greedy
from show_tell_tpu_torch.ops.whole_decode import gru_whole_greedy_decode, gru_whole_greedy_decode_plain

CASES = [(32, 64, 70, 3, 8, 9), (64, 64, 128, 1, 4, 5)]  # (E, H, V, L, B, T)


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
