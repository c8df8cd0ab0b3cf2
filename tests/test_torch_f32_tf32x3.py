"""The f32 pooled greedy steps in split-precision TF32 (csrc/dense_mma.cuh, tf32x3_step()), on the CPU.

The kernels run only on the card; what surrounds them runs here.  Their
arithmetic is re-enacted in numpy: each f32 operand split into
big = tf32(a) and small = tf32(a - big) (round to nearest, ties away, 10
mantissa bits: cvt.rna), each k8 step's three mma.sync m16n8k8 (small_a
big_b, then big_a small_b, then big_a big_b) summed from zero and added to
an f32 accumulator, in the kernel's K order (16-column chunks, a lane's
four floats feeding two k8 steps, the chunks split over four warps and the
warps' sums added in order), then
the cells' finish and the first-max argmax.  The re-enactment is held to
the port's f32 twin and to the JAX package's fused step in interpret mode
at small widths and at one flagship-width step (B = 32), and one-pass
TF32 is shown to miss the f32 bar there.  Also: which instances the
predicate sends to the tensor cores (every f32 pooled end, the stack
step's included; the beam ends: tests/test_torch_beam_tf32x3.py, the
stack steps: tests/test_torch_stack_tf32x3.py), and the f32 items'
geometry.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.ops.fused_step_pallas import fused_gru_decode_step_pallas, fused_lstm_decode_step_pallas
from show_tell_tpu.ops.rnn_pallas import prepare_rnn_weights as jax_prepare_rnn_weights
from show_tell_tpu.ops.vocab_pallas import VOCAB_BLOCK
from show_tell_tpu.ops.vocab_pallas import prepare_vocab as jax_prepare_vocab
from show_tell_tpu_torch.ops import fused_step
from show_tell_tpu_torch.ops.fused_step import (
    TF32_CHUNK,
    fused_gru_decode_step_plain,
    fused_lstm_decode_step_plain,
    mma_step,
    mma_tiles,
    stack_tiles,
    tf32x3_step,
)
from show_tell_tpu_torch.ops.rnn import prepare_rnn_weights
from show_tell_tpu_torch.ops.vocab import prepare_vocab, project_logits
from test_torch_gate_tiles import BLOCK_V, HEADER, SLAB, WARPS
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

CSRC = os.path.dirname(HEADER)
STATE_TOL = 1e-5  # rtol = atol: the f32 bar of the port (PERF.md section 2)
GAP = 1e-4  # tokens agree on every row whose top-2 logit gap exceeds it
SMS = 132  # an H100's SMs: the K split's S follows from them


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- the split


def tf32(a):
    """cvt.rna.tf32.f32 with the low 13 bits cleared: the nearest value with 10
    mantissa bits, ties away from zero (the magnitude's half-ulp carries)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(a):
    """(big, small): big = tf32(a), small = tf32(a - big); a - big is exact in f32."""
    a = np.asarray(a, np.float32)
    big = tf32(a)
    return big, tf32(a - big)


def test_tf32_rounds_to_nearest_with_ties_away():
    one = np.float32(1.0)
    half_ulp, ulp = np.float32(2.0**-11), np.float32(2.0**-10)
    vals = np.array([one + half_ulp, -(one + half_ulp), one + half_ulp - np.float32(2.0**-23), one + 3 * half_ulp,
                     np.float32(0.0), np.float32(-3.0)], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + 2 * ulp, 0.0, -3.0], np.float32)
    assert np.array_equal(tf32(vals), want)
    rng = np.random.RandomState(0)
    a = (rng.randn(10000) * np.exp(rng.uniform(-20, 20, 10000))).astype(np.float32)
    big, small = split(a)
    assert not (big.view(np.uint32) & 0x1FFF).any() and not (small.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(a - big) <= np.abs(a) * 2.0**-11).all()  # half a tf32 ulp
    rest = np.abs(a.astype(np.float64) - big - small)
    assert (rest <= np.abs(a) * 2.0**-22).all()  # the split keeps 22 bits of 24


# ---------------------------------------------------------------- the re-enactment


def lane_columns(c, s):
    """The 8 K columns of k8 step s of chunk c, as logical k = 0..7: lane t's
    floats 2s and 2s + 1 (columns 4t + 2s, 4t + 2s + 1) are its k = t, t + 4."""
    tq = np.arange(4)
    return c * TF32_CHUNK + np.concatenate([4 * tq + 2 * s, 4 * tq + 2 * s + 1])


def mma(acc, a, b):
    """acc [M, N] f32 += a [M, 8] @ b [8, N]: tf32 products (exact in f64), added
    to the accumulator and rounded to f32 once an mma (the card truncates;
    the step's partial sum is small, so either is far inside the bars)."""
    return (acc.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def warp_sums(sides, n_rows, B, one_pass=False, S=1):
    """The sums of an item's rows: ``sides`` lists (weights [rows, K],
    activations [B, K], target rows) for each operand pair in K order (a
    layer: x side, then h side).  The chunks of the whole list go in S
    parts (the K split across blocks: part p the run [p n / S, (p + 1) n /
    S)); each part's warps run their share of its chunks, each from 0, and
    are added in order; the parts are added in order."""
    chunks = []  # (side, chunk index in its side)
    padded = []
    for w, x, rows in sides:
        K = w.shape[1]
        Kp = -(-K // TF32_CHUNK) * TF32_CHUNK
        wp = np.zeros((w.shape[0], Kp), np.float32)
        xp = np.zeros((x.shape[0], Kp), np.float32)
        wp[:, :K], xp[:, :K] = w, x
        padded.append((split(wp), split(xp), rows))
        chunks += [(len(padded) - 1, c) for c in range(Kp // TF32_CHUNK)]
    n = len(chunks)
    total = None
    for part in range(S):
        run = chunks[part * n // S:(part + 1) * n // S]
        part_sum = _part_sums(run, padded, n_rows, B, one_pass)
        total = part_sum if total is None else (total + part_sum).astype(np.float32)
    return total


def _part_sums(run, padded, n_rows, B, one_pass):
    """One part's run of chunks over the four warps (mma_split), their sums added in warp order (mma_sum)."""
    n = len(run)
    total = None
    for warp in range(WARPS):
        acc = np.zeros((n_rows, B), np.float32)
        for side, c in run[warp * n // WARPS:(warp + 1) * n // WARPS]:
            (wb, ws), (xb, xs), rows = padded[side]
            for s in (0, 1):
                k = lane_columns(c, s)
                a_big, a_small, b_big, b_small = wb[:, k], ws[:, k], xb[:, k].T, xs[:, k].T
                part = np.zeros((len(rows), B), np.float32)  # the step's partial sum, from zero
                if not one_pass:
                    part = mma(part, a_small, b_big)
                    part = mma(part, a_big, b_small)
                part = mma(part, a_big, b_big)
                acc[rows] = (acc[rows] + part).astype(np.float32)  # an f32 add
        total = acc if total is None else (total + acc).astype(np.float32)
    return total


def sigmoid(v):
    return (np.float32(1.0) / (np.float32(1.0) + np.exp(-v))).astype(np.float32)


def tf32x3_layer(cell, x, h, c, w_ih, w_hh, b_ih, b_hh, one_pass=False, S=1):
    """mma_rnn_layer's f32 instance re-enacted, its K split in S parts: (h',
    c') [B, H] (c' None for the GRU).  Sums [G*H (+ H), B]: the GRU's r and
    z over both sides, its n gate's h side apart in rows 3H..4H; the LSTM's
    four gates over both."""
    Hd, B = h.shape[1], h.shape[0]
    G = 4 if cell == "lstm" else 3
    if G == 3:
        n_rows = 4 * Hd
        h_rows = np.concatenate([np.arange(2 * Hd), np.arange(3 * Hd, 4 * Hd)])
    else:
        n_rows, h_rows = 4 * Hd, np.arange(4 * Hd)
    sums = warp_sums([(w_ih, x, np.arange(G * Hd)), (w_hh, h, h_rows)], n_rows, B, one_pass, S)
    g = lambda i: sums[i * Hd:(i + 1) * Hd].T  # [B, H]
    bi = lambda i: b_ih[i * Hd:(i + 1) * Hd]
    bh = lambda i: b_hh[i * Hd:(i + 1) * Hd]
    if G == 3:  # GruCell::finish with the sums {s0, s1, s2, 0, 0, s3}
        r = sigmoid((g(0) + bi(0)) + (np.float32(0) + bh(0)))
        z = sigmoid((g(1) + bi(1)) + (np.float32(0) + bh(1)))
        n = np.tanh((g(2) + bi(2)) + r * (g(3) + bh(2))).astype(np.float32)
        return ((1 - z) * n + z * h).astype(np.float32), None
    ig, fg = sigmoid(g(0) + bi(0) + bh(0)), sigmoid(g(1) + bi(1) + bh(1))
    gg, og = np.tanh(g(2) + bi(2) + bh(2)).astype(np.float32), sigmoid(g(3) + bi(3) + bh(3))
    c2 = (fg * c + ig * gg).astype(np.float32)
    return (og * np.tanh(c2)).astype(np.float32), c2


def tf32x3_step_reenacted(cell, stacked, vocab, x, state, one_pass=False):
    """The f32 greedy step of st_fused_gru_step / st_fused_lstm_step re-enacted,
    with the K split that stack_tiles gives on an H100's 132 SMs: (tokens
    [B], logits [B, V], new state), numpy; ``vocab`` None: (None, None,
    new state)."""
    npy = lambda v: v.numpy()
    hs, cs = (npy(state[0]), npy(state[1])) if cell == "lstm" else (npy(state), None)
    splits = stack_tiles(hs.shape[1], x.shape[1], hs.shape[2], SMS, dtype=torch.float32).splits
    inp, new_h, new_c = npy(x), [], []
    for l in range(hs.shape[0]):
        w_ih = stacked["w_ih0"] if l == 0 else stacked["w_ihU"][l - 1]
        inp, c2 = tf32x3_layer(cell, inp, hs[l], None if cs is None else cs[l], npy(w_ih), npy(stacked["w_hh"][l]),
                               npy(stacked["b_ih"][l]), npy(stacked["b_hh"][l]), one_pass, splits[l > 0])
        new_h.append(inp)
        new_c.append(c2)
    state2 = (np.stack(new_h), np.stack(new_c)) if cell == "lstm" else np.stack(new_h)
    if vocab is None:  # the stack alone
        return None, None, state2
    wv, bv = npy(vocab["w"]), npy(vocab["b"])
    logits = (warp_sums([(wv, inp, np.arange(wv.shape[0]))], wv.shape[0], inp.shape[0], one_pass).T + bv)
    logits = logits.astype(np.float32)
    return np.argmax(logits, axis=1).astype(np.int32), logits, state2


def _states(state):
    return [np.asarray(s) for s in (state if isinstance(state, tuple) else (state,))]


def _excess(got, ref):
    """The largest |got - ref| - (atol + rtol |ref|) over the states, rtol = atol = STATE_TOL: <= 0 within the bar."""
    return max(float(np.max(np.abs(g - r) - STATE_TOL * (1 + np.abs(r)))) for g, r in zip(_states(got), _states(ref)))


def _clear(top, vocab):
    logits = project_logits(vocab, t(top)).numpy()
    two = np.sort(logits, axis=1)[:, -2:]
    return two[:, 1] - two[:, 0] > GAP


def _case(cell, B, E, H, V, L, seed, bound=0.3, block_v=BLOCK_V):
    """Weights and biases uniform in +-bound, x ~ N(0, 1), h in +-1 (c in
    +-2): the port's operands and the JAX package's (its layout, vocab in
    ``block_v`` blocks: BLOCK_V at the small widths, several blocks a step;
    the flagship steps take the package's default VOCAB_BLOCK, whose 20
    blocks interpret in a quarter of the time of 623 blocks of 16)."""
    rng = np.random.RandomState(seed)
    u = lambda *s: rng.uniform(-bound, bound, s).astype(np.float32)
    G = (4 if cell == "lstm" else 3) * H
    layers = [{"w_ih": u(E if l == 0 else H, G), "w_hh": u(H, G), "b_ih": u(G), "b_hh": u(G)} for l in range(L)]
    linear = {"w": u(H, V), "b": u(V)}
    x = rng.randn(B, E).astype(np.float32)
    hs = rng.uniform(-1, 1, (L, B, H)).astype(np.float32)
    state = (hs, rng.uniform(-2, 2, (L, B, H)).astype(np.float32)) if cell == "lstm" else hs
    port = (prepare_rnn_weights([{k: t(v.T) if v.ndim == 2 else t(v) for k, v in l.items()} for l in layers]),
            prepare_vocab(t(linear["w"].T), t(linear["b"])), t(x),
            tuple(t(s) for s in state) if cell == "lstm" else t(state))
    jax_args = (jax_prepare_rnn_weights([{k: jnp.asarray(v) for k, v in l.items()} for l in layers]),
                jax_prepare_vocab({k: jnp.asarray(v) for k, v in linear.items()}, block_v=block_v), jnp.asarray(x),
                jax.tree.map(jnp.asarray, state), block_v)
    return port, jax_args


def _jax_step(cell, jax_args):
    stacked, vocab, x, state, block_v = jax_args
    if cell == "lstm":
        tok, st = fused_lstm_decode_step_pallas(stacked, vocab, x, *state, block_v=block_v, interpret=True)
    else:
        tok, st = fused_gru_decode_step_pallas(stacked, vocab, x, state, block_v=block_v, interpret=True)
    return np.asarray(tok), jax.tree.map(np.asarray, st)


def _hold(cell, port, jax_args):
    """The re-enactment against the twin and the interpreted Pallas step:
    states within STATE_TOL, tokens equal where the gap is clear.  Returns
    the re-enacted state and the twin's state."""
    tok, logits, state = tf32x3_step_reenacted(cell, *port)
    assert np.array_equal(tok, np.argmax(logits, axis=1))
    plain = fused_lstm_decode_step_plain if cell == "lstm" else fused_gru_decode_step_plain
    ref_tok, ref_state = plain(*port)
    ref_state = tuple(s.numpy() for s in ref_state) if cell == "lstm" else ref_state.numpy()
    assert _excess(state, ref_state) <= 0
    top = _states(state)[0][-1]
    clear = _clear(top, port[1])
    assert clear.mean() > 0.8
    assert np.array_equal(tok[clear], ref_tok.numpy()[clear])
    j_tok, j_state = _jax_step(cell, jax_args)
    assert _excess(state, j_state) <= 0
    assert np.array_equal(tok[clear], j_tok[clear])
    return state, ref_state


# (B, E, H, V, L): ragged slabs (3, 19; 33 and 65 a slab pair and a part), E and H multiples of 8, not of the 16-column
# chunk (H = 24: the second h-side chunk half zeros), V not a multiple of the 64-row vocabulary item; the K split
# across blocks at S = 2 (5 rows, E = H = 64) and S = 2 then 3 (40 rows, E = 64, H = 96: runs of uneven length)
SMALL = [(3, 16, 24, 40, 2), (19, 24, 40, 77, 2), (33, 16, 16, 65, 1), (65, 16, 24, 77, 2), (5, 64, 64, 77, 2),
         (40, 64, 96, 77, 2)]


@pytest.mark.parametrize("B,E,H,V,L", SMALL)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_tf32x3_step_matches_the_twin_and_pallas(cell, B, E, H, V, L):
    port, jax_args = _case(cell, B, E, H, V, L, 700 + B + V)
    _hold(cell, port, jax_args)


def f64_stack(cell, stacked, x, state):
    """The L-layer recurrence in float64 from the same f32 operands: [L, B, H] states (and cell states)."""
    d = lambda v: v.numpy().astype(np.float64)
    hs, cs = (d(state[0]), d(state[1])) if cell == "lstm" else (d(state), None)
    Hd, inp, new_h, new_c = hs.shape[2], d(x), [], []
    sg = lambda v: 1.0 / (1.0 + np.exp(-v))
    for l in range(hs.shape[0]):
        w_ih = d(stacked["w_ih0"]) if l == 0 else d(stacked["w_ihU"][l - 1])
        gx = inp @ w_ih.T + d(stacked["b_ih"][l])
        gh = hs[l] @ d(stacked["w_hh"][l]).T + d(stacked["b_hh"][l])
        g = lambda a, i: a[:, i * Hd:(i + 1) * Hd]
        if cell == "lstm":
            c = sg(g(gx, 1) + g(gh, 1)) * cs[l] + sg(g(gx, 0) + g(gh, 0)) * np.tanh(g(gx, 2) + g(gh, 2))
            inp = sg(g(gx, 3) + g(gh, 3)) * np.tanh(c)
            new_c.append(c)
        else:
            r, z = sg(g(gx, 0) + g(gh, 0)), sg(g(gx, 1) + g(gh, 1))
            inp = (1 - z) * np.tanh(g(gx, 2) + r * g(gh, 2)) + z * hs[l]
        new_h.append(inp)
    return (np.stack(new_h), np.stack(new_c)) if cell == "lstm" else np.stack(new_h)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_flagship_step_at_b32_and_one_pass_tf32_misses_the_bar(cell):
    """L=5, H=512, V=9,956, E=256 (GRU) or 512 (LSTM), B=32, weights at the
    decoder init's scale (U(+-1/sqrt(H)), as chip_smoke.py draws them):
    3xTF32 holds the f32 bars against the twin and the interpreted Pallas
    step; one-pass TF32 (big_a big_b alone) on the same inputs leaves the
    1e-5 band of the twin's states by more than ten times the band."""
    port, jax_args = _case(cell, 32, 256 if cell == "gru" else 512, 512, 9956, 5, 800, bound=512 ** -0.5,
                           block_v=VOCAB_BLOCK)
    _, ref_state = _hold(cell, port, jax_args)
    _, _, one_pass = tf32x3_step_reenacted(cell, port[0], None, *port[2:], one_pass=True)
    assert _excess(one_pass, ref_state) > 10 * STATE_TOL


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_flagship_step_is_nearer_an_f64_step_than_the_twin(cell):
    """The same widths with weights in +-0.3 (pre-activations of several
    units, where two f32 summation orders part by up to 1e-5 in the states):
    against the recurrence in float64, the re-enacted 3xTF32 states err less
    than the port's f32 twin and the interpreted Pallas step, at the worst
    value and in the mean square; one-pass TF32 errs a hundred times more."""
    port, jax_args = _case(cell, 32, 256 if cell == "gru" else 512, 512, 9956, 5, 801, block_v=VOCAB_BLOCK)
    exact = _states(f64_stack(cell, port[0], port[2], port[3]))
    _, _, state = tf32x3_step_reenacted(cell, *port)
    _, _, one_pass = tf32x3_step_reenacted(cell, port[0], None, *port[2:], one_pass=True)
    plain = fused_lstm_decode_step_plain if cell == "lstm" else fused_gru_decode_step_plain
    ref_state = plain(*port)[1]
    errs = lambda got: np.concatenate([np.abs(g.astype(np.float64) - e).ravel() for g, e in zip(_states(got), exact)])
    ours, twin, pallas = errs(state), errs(ref_state), errs(_jax_step(cell, jax_args)[1])
    for other in (twin, pallas):
        assert ours.max() < other.max() and np.sqrt((ours ** 2).mean()) < np.sqrt((other ** 2).mean())
    assert errs(one_pass).max() > 100 * ours.max()


# ---------------------------------------------------------------- the predicate and the sources

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
ENDS = ["argmax", "dense", 3, None]


@pytest.mark.parametrize("end", ENDS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_the_predicate_sends_only_the_f32_argmax_end_to_the_tensor_cores(dtype, end):
    """tf32x3_step: of the pooled instances, f32 with every end, argmax,
    dense, top-k and None, the stack step (the pooled step, the stack step
    and the whole decode ask it; which wrappers do: test_torch_argmax_tiles.py's
    test_mma_tiles_check_runs_for_the_tensor_core_instances_only); of the
    attention instances (``attention``), f32 with the argmax and the dense
    end (there is no attention stack step), so no f32 instance is left on
    the SIMT layers; mma_step (every bf16 instance) unchanged, and never
    both."""
    f32 = dtype == torch.float32
    assert tf32x3_step(dtype, end) is f32
    assert tf32x3_step(dtype, end, attention=True) is (f32 and end in ("argmax", "dense"))
    assert mma_step(dtype, end) is (dtype == torch.bfloat16)
    assert not ((tf32x3_step(dtype, end) or tf32x3_step(dtype, end, attention=True)) and mma_step(dtype, end))


def test_the_kernel_sources_gate_the_f32_instances_narrowly():
    """In CUDA: tf32x3_step() is f32 with the argmax, the dense or (not
    with kAttention) the top-k end or none, the stack step's;
    fused_step.cu and whole_decode.cu ask pooled_mma_step() (mma_step() or
    tf32x3_step() without kAttention), and fused_step.cu holds every
    instance to it, the stack steps and the f32 steps on the split layers
    at the depth of layer_depth() (kTf32StackDepth = 2 for the f32 GRU
    stack step alone), with no SIMT layer or projection left in it, and
    decode_common.cuh keeps no SIMT layer code; fused_attn_step.cu asks
    tf32x3_step<T, kMode, true>() and holds every other instance to
    mma_step(), with no SIMT layer or projection left in it (its f32
    instances: the attention phases in a launch of their own); the
    constants agree."""
    src = open(HEADER).read()
    const = lambda name: int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))
    assert const("kTf32Chunk") == TF32_CHUNK == 16 and const("kTf32Depth") == 1 and const("kTf32StackDepth") == 2
    assert ("return std::is_same<T, float>::value && kMode == kNone && Cell::kGates == 3 ? kTf32StackDepth : "
            "MmaShape<T>::kDepth;" in src)
    assert ("return std::is_same<T, float>::value &&\n         (kMode == kArgmax || kMode == kDense || (!kAttention "
            "&& (kMode == kTopk || kMode == kNone)));" in src)
    assert "template <typename T, int kMode, bool kAttention = false>" in src
    assert "return mma_step<T, kMode>() || tf32x3_step<T, kMode>();" in src
    assert "static constexpr int kChunk = kTf32Chunk, kLane = 4, kDepth = kTf32Depth;" in src
    read = lambda name: open(os.path.join(CSRC, name)).read()
    shared = read("vocab_mma.cuh")  # mma_tf32_1688, shared with the f32 projection kernels
    assert '#include "vocab_mma.cuh"' in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in shared and "cvt.rna.tf32.f32" in src
    step, whole, attn = read("fused_step.cu"), read("whole_decode.cu"), read("fused_attn_step.cu")
    common = read("decode_common.cuh")
    assert 'static_assert(pooled_mma_step<T, kMode>(), "every instance runs the tensor cores");' in step
    assert "if constexpr (kMode == kNone || tf32x3_step<T, kMode>())" in step
    assert "mma_stack_layer<T, Cell, layer_depth<T, Cell, kMode>()>(s, l, smem, p.split);" in step
    assert "kMmaSmemFloats * sizeof(float)" in step and "stack_smem_floats" not in step
    assert step.count("split_args_ok(true, split, B, H)") == 2  # both stack steps take a K split in both dtypes
    assert not re.search(r"(?<!mma_)(stack_layer|vocab_phase)<", step)  # the SIMT layer and projection
    for gone in ("rnn_layer", "gate_dots", "stack_smem_floats", "stack_layer<"):
        assert gone not in common.replace("mma_stack_layer<", "")
    assert "stack_layer_args" in common and "struct Tiling" in common and "void load_rows(" in common
    assert "pooled_mma_step<T, kArgmax>()" in whole
    assert "constexpr bool kTf32 = tf32x3_step<T, kMode, true>();" in attn
    assert "static_assert(mma_step<T, kMode>() || kTf32," in attn
    assert "mma_stack_layer<T, Cell>(s, l, smem, p.split);" in attn and "mma_vocab_phase<kMode>(" in attn
    assert "launch_cooperative(attention_f32_kernel," in attn  # the f32 attention phases: a launch of their own
    assert "pooled_mma_step" not in attn
    assert not re.search(r"(?<!mma_)(stack_layer|vocab_phase)<", attn)  # the SIMT layer and projection


# ---------------------------------------------------------------- geometry


@pytest.mark.parametrize("R,I0,H_,V", [(1, 8, 8, 1), (3, 16, 24, 40), (19, 40, 24, 77), (33, 24, 16, 65),
                                       (64, 256, 512, 9956), (65, 512, 512, 9956), (512, 256, 512, 9956)])
def test_f32_items_cover_every_output_once(R, I0, H_, V):
    """mma_tiles(dtype=float32): an item is a weight tile (16 gate columns, or
    64 vocabulary rows) and a 32-row batch slab, as in bf16; the items cover
    each (row, column) once, the warps' runs of 16-column chunks cover K
    once, and every lane's 4-float load is whole or past K (K a multiple of
    8).  The layers' K split: every part's run of chunks, split over the
    warps, covers the layer's chunks once, in order."""
    g = mma_tiles(R, I0, H_, V, dtype=torch.float32)
    slabs = -(-R // SLAB)
    assert (g.layer0_chunks, g.upper_chunks, g.vocab_chunks) == (-(-I0 // 16) + -(-H_ // 16), 2 * -(-H_ // 16),
                                                                  -(-H_ // 16))
    assert g.smem == fused_step.MMA_SMEM
    for items, width, rows in ((g.gate_items, H_, 16), (g.vocab_items, V, 64)):
        assert items == slabs * -(-width // rows)
        covered = np.zeros((R, width), np.int64)
        for item in range(items):
            n0, c0 = (item % slabs) * SLAB, (item // slabs) * rows
            covered[n0:n0 + SLAB, c0:c0 + rows] += 1
        assert (covered == 1).all()
    split = stack_tiles(R, I0, H_, SMS, dtype=torch.float32)
    assert split.items == g.gate_items and split.chunks == (g.layer0_chunks, g.upper_chunks)
    for n_chunks, S in zip(split.chunks, split.splits):
        runs = [range(p * n_chunks // S + w * ((p + 1) * n_chunks // S - p * n_chunks // S) // WARPS,
                      p * n_chunks // S + (w + 1) * ((p + 1) * n_chunks // S - p * n_chunks // S) // WARPS)
                for p in range(S) for w in range(WARPS)]
        assert [c for run in runs for c in run] == list(range(n_chunks))
    for K in (I0, H_):
        starts = np.arange(0, -(-K // 16) * 16, 4)  # k0 + 4t over the chunks
        assert all(k + 3 < K for k in starts if k < K)


def test_f32_flagship_geometry_and_the_widths_it_refuses():
    """The flagship GRU at B = 32 and 64: 32 and 64 items a layer in 8 and 4
    parts (the K split), 156 and 312 vocabulary items, 48 and 64 chunks a
    layer, 32 a projection; one part from B = 160; bf16 is unchanged;
    widths not multiples of 8 raise."""
    assert mma_tiles(32, 256, 512, 9956, dtype=torch.float32) == (32, 156, 48, 64, 32, 33792)
    assert mma_tiles(64, 256, 512, 9956, dtype=torch.float32) == (64, 312, 48, 64, 32, 33792)
    assert [stack_tiles(B, 256, 512, SMS, dtype=torch.float32).splits for B in (1, 32, 64, 128, 160, 512)] == [
        (8, 8), (8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
    assert mma_tiles(64, 256, 512, 9956) == (64, 312, 24, 32, 16, 33792)
    with pytest.raises(ValueError, match="multiples of 8"):
        mma_tiles(32, 20, 512, 9956, dtype=torch.float32)
