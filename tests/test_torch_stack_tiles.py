"""The bf16 stack steps' K split across blocks (csrc/dense_mma.cuh, SplitK), on the CPU.

The stack steps' bf16 instances run the tensor-core layers of the dense
steps with no vocab phase, and at small batches cut each (16 columns, 32
rows) item into S parts over its K chunks.  The kernels run only on the
card; here the split layer is re-enacted in numpy lane by lane, on the
fragments and staged sums of tests/test_torch_gate_tiles.py: part s of
S runs the chunks [s n / S, (s + 1) n / S) of the layer's n, split over
the four warps as an unsplit item's; its sums, added in warp order, go
to the scratch; the part that arrives last at the item's counter
(atomicInc wrapping at S - 1) adds the S parts in the order s = 0 .. S-1
and finishes the item as GruCell / LstmCell::finish does.  The
re-enactment is held to the plain stack (``stack_plain``) and to the JAX
package's gru_stack_step_pallas / lstm_stack_step_pallas in interpret
mode, in f32 at B = 1, 3, 33, E = 16, 24, H = 24, L = 1, 3 and S = 1, 2,
3, tolerance 1e-5; it gives the same bits in every order of arrival, and
at S = 1 the bits of the unsplit layer (``tiled_stack``).  The rule for
S and the split geometry (``fused_step.stack_tiles``: items, chunk runs,
scratch) are held to the header's constants.
"""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.ops.rnn_pallas import gru_stack_step_pallas, lstm_stack_step_pallas
from show_tell_tpu.ops.rnn_pallas import prepare_rnn_weights as jax_prepare_rnn_weights
from show_tell_tpu_torch.ops import fused_step
from show_tell_tpu_torch.ops.fused_step import stack_splits, stack_tiles
from show_tell_tpu_torch.ops.rnn import prepare_rnn_weights, stack_plain
from test_torch_gate_tiles import (
    CHUNK,
    G_OF,
    HEADER,
    PITCH,
    SLAB,
    SLOTS,
    VALS,
    WARPS,
    LANES,
    lane_loads,
    mma_chunk,
    mma_sum,
    sigmoid,
    slab_rows,
    tiled_stack,
)

H = 24
MAX_SPLITS = fused_step.MAX_SPLITS
PART = SLOTS * SLAB * 16  # f32 sums of a part in the scratch


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def part_chunks(n_chunks, S, s):
    """The K chunks [lo, hi) of part s of S (mma_part_split in csrc/dense_mma.cuh)."""
    return s * n_chunks // S, (s + 1) * n_chunks // S


# ---------------------------------------------------------------- geometry and the rule


def test_split_constants_agree_with_the_kernel_header():
    src = open(HEADER).read()
    const = lambda name: int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))
    assert const("kMaxSplits") == MAX_SPLITS
    assert "kMmaPartFloats = kMmaSlots * kMmaSlab * 16;" in src and fused_step.MMA_PART == PART == 2048
    # the part's run of chunks and its warps' split, as the header writes them
    assert "lo = s * n_chunks / S, n = (s + 1) * n_chunks / S - lo;" in src
    assert "c0 = warp * n_chunks / kWarps;" in src and "c1 = (warp + 1) * n_chunks / kWarps;" in src


# (B, I0, sms) -> (S of layer 0, S above) at H=512: the flagships (GRU E=256, LSTM E=512) on an H100's 132 SMs
@pytest.mark.parametrize("B,I0,sms,splits", [
    (1, 256, 132, (6, 8)), (1, 512, 132, (8, 8)), (32, 256, 132, (6, 8)), (33, 256, 132, (4, 4)),
    (64, 512, 132, (4, 4)), (65, 256, 132, (2, 2)), (128, 512, 132, (2, 2)), (129, 256, 132, (1, 1)),
    (512, 256, 132, (1, 1)), (1, 64, 1000, (4, 8)), (1, 256, 16, (1, 1)), (1024, 512, 132, (1, 1))])
def test_the_rule_for_s(B, I0, sms, splits):
    """S = the parts the resident grid (two blocks an SM) holds for a
    layer's items (2 sms // items), at most MAX_SPLITS and a chunk a warp
    (chunks // 4), at least 1."""
    g = stack_tiles(B, I0, 512, sms)
    assert g.splits == splits
    items = -(-B // 32) * 32
    assert g.items == items and g.chunks == (-(-I0 // 32) + 16, 32)
    assert g.parts == (items * max(splits) if max(splits) > 1 else 0)
    for I, S in zip((I0, 512), splits):
        assert S == stack_splits(B, I, 512, sms) == max(1, min(MAX_SPLITS, (-(-I // 32) + 16) // WARPS,
                                                                2 * sms // items))


def test_forced_splits_and_their_limits():
    assert stack_tiles(512, 256, 512, 132, splits=8) == (512, (24, 32), (8, 8), 4096)
    assert stack_tiles(1, 256, 512, 132, splits=1) == (32, (24, 32), (1, 1), 0)
    for bad in (-1, 9):
        with pytest.raises(ValueError, match="1 to 8 parts"):
            stack_tiles(1, 256, 512, 132, splits=bad)
    with pytest.raises(ValueError, match="multiples of 8"):
        stack_tiles(1, 20, 512, 132)


@pytest.mark.parametrize("n_chunks", [2, 5, 24, 32, 40])
@pytest.mark.parametrize("S", range(1, MAX_SPLITS + 1))
def test_parts_and_warps_cover_each_chunk_once(n_chunks, S):
    """Part s's run [s n / S, (s + 1) n / S), split over the four warps as
    mma_split splits an item's, covers the layer's chunks once, in order."""
    seen = []
    for s in range(S):
        lo, hi = part_chunks(n_chunks, S, s)
        for w in range(WARPS):
            seen += range(lo + w * (hi - lo) // WARPS, lo + (w + 1) * (hi - lo) // WARPS)
    assert seen == list(range(n_chunks))


# ---------------------------------------------------------------- the split layer, lane by lane


def arrive(counter, item, S):
    """atomicInc(counter + item, S - 1): the old count; the counter wraps to 0 at the last arrival."""
    old = counter[item]
    counter[item] = 0 if old >= S - 1 else old + 1
    return old


def part_sums(sources, lo, hi):
    """One part: each warp runs its share of the chunks [lo, hi), stages its
    sums at the kernel's pitch; returns the part's scratch [SLOTS, SLAB, 16],
    every (slot, row, column) summed over the warps in order (mma_sum)."""
    red = np.zeros(WARPS * VALS * PITCH, np.float32)
    for w in range(WARPS):
        acc = np.zeros((32, SLOTS, 4, 4), np.float32)
        for c in range(lo + w * (hi - lo) // WARPS, lo + (w + 1) * (hi - lo) // WARPS):
            slots, a_tiles, b_lanes = sources(c)
            for slot, a_lanes in zip(slots, a_tiles):
                mma_chunk(acc[:, slot], a_lanes, b_lanes)
        for s in range(SLOTS):
            for nt in range(4):
                for e in range(4):
                    red[w * VALS * PITCH + ((s * 4 + nt) * 4 + e) * PITCH + LANES] = acc[:, s, nt, e]
    return np.array([[[mma_sum(red, s, m, n) for m in range(16)] for n in range(SLAB)] for s in range(SLOTS)],
                    np.float32)


def split_layer(cell, x, h, c, w_ih, w_hh, b_ih, b_hh, S, order=None):
    """mma_rnn_layer<Cell, true> re-enacted at S parts an item, the parts of
    every item arriving in ``order`` (a permutation of range(S); default
    0 .. S - 1): (h' [R, H], c' or None, the counters afterwards)."""
    G = 4 if cell == "lstm" else 3
    R, I = x.shape
    Hd = h.shape[1]
    cx = -(-I // CHUNK)
    n_chunks = cx + -(-Hd // CHUNK)
    slabs = -(-R // SLAB)
    items = slabs * -(-Hd // 16)
    h2, c2 = np.zeros((R, Hd), np.float32), np.zeros((R, Hd), np.float32)
    scratch = np.full((items * S, SLOTS, SLAB, 16), np.nan, np.float32)
    counter = np.zeros(items, np.int64)
    for item in range(items):
        n0, j0 = (item % slabs) * SLAB, (item // slabs) * 16

        def sources(ch):
            xs = ch < cx
            w, src, k0 = (w_ih, x, ch * CHUNK) if xs else (w_hh, h, (ch - cx) * CHUNK)
            tiles = []
            for gate in range(G):  # rows gate*H + j0 + r of the tile, r < H - j0
                rows = gate * Hd + j0 + np.stack([G_OF, G_OF + 8], 1)
                tiles.append(lane_loads(w, np.where(rows - gate * Hd < Hd, rows, -1), k0))
            slots = [3 if (G == 3 and gate == 2 and not xs) else gate for gate in range(G)]
            return slots, tiles, lane_loads(src, slab_rows(n0, R), k0)

        finisher = None
        for s in (range(S) if order is None else order):
            scratch[item * S + s] = part_sums(sources, *part_chunks(n_chunks, S, s))
            if arrive(counter, item, S) == S - 1:
                assert finisher is None
                finisher = s
        assert finisher is not None and counter[item] == 0
        parts = scratch[item * S : (item + 1) * S]
        total = parts[0].copy()
        for p in range(1, S):  # the S parts in order, whichever arrived last
            total = total + parts[p]
        for m in range(16):
            for n in range(SLAB):
                j, row = j0 + m, n0 + n
                if row >= R or j >= Hd:
                    continue
                s = total[:, n, m]
                bi = lambda gate: np.float32(b_ih[gate * Hd + j])
                bh = lambda gate: np.float32(b_hh[gate * Hd + j])
                if G == 3:  # GruCell::finish with the sums {s0, s1, s2, 0, 0, s3}
                    r = sigmoid((s[0] + bi(0)) + (np.float32(0) + bh(0)))
                    z = sigmoid((s[1] + bi(1)) + (np.float32(0) + bh(1)))
                    ng = np.tanh((s[2] + bi(2)) + r * (s[3] + bh(2)))
                    h2[row, j] = (1 - z) * ng + z * h[row, j]
                else:  # LstmCell::finish
                    ig, fg = sigmoid(s[0] + bi(0) + bh(0)), sigmoid(s[1] + bi(1) + bh(1))
                    gg, og = np.tanh(s[2] + bi(2) + bh(2)), sigmoid(s[3] + bi(3) + bh(3))
                    c2[row, j] = fg * c[row, j] + ig * gg
                    h2[row, j] = og * np.tanh(c2[row, j])
    return h2, (c2 if G == 4 else None), counter


def split_stack(cell, stacked, x, state, S, order=None):
    """The stack step's L split layers re-enacted, in f32: (top [R, H], new state)."""
    npy = lambda v: v.numpy()
    hs, cs = (npy(state[0]), npy(state[1])) if cell == "lstm" else (npy(state), None)
    inp, new_h, new_c = npy(x), [], []
    for l in range(hs.shape[0]):
        w_ih = stacked["w_ih0"] if l == 0 else stacked["w_ihU"][l - 1]
        inp, c2, counter = split_layer(cell, inp, hs[l], None if cs is None else cs[l], npy(w_ih),
                                       npy(stacked["w_hh"][l]), npy(stacked["b_ih"][l]), npy(stacked["b_hh"][l]), S,
                                       order)
        assert not counter.any()  # every counter back at zero after the layer
        new_h.append(inp)
        new_c.append(c2)
    return inp, ((np.stack(new_h), np.stack(new_c)) if cell == "lstm" else np.stack(new_h))


def _states(state):
    return [np.asarray(s) for s in (state if isinstance(state, tuple) else (state,))]


def _case(cell, B, E, L, seed):
    """Torch-layout stacked weights, x [B, E] and the state, with the JAX package's stacked weights."""
    rng = np.random.RandomState(seed)
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    G = (4 if cell == "lstm" else 3) * H
    layers = [{"w_ih": u(E if l == 0 else H, G), "w_hh": u(H, G), "b_ih": u(G), "b_hh": u(G)} for l in range(L)]
    x = rng.randn(B, E).astype(np.float32)
    hs = rng.uniform(-1, 1, (L, B, H)).astype(np.float32)
    cs = rng.uniform(-2, 2, (L, B, H)).astype(np.float32)
    stacked = prepare_rnn_weights([{k: t(v.T) if v.ndim == 2 else t(v) for k, v in l.items()} for l in layers])
    jax_stacked = jax_prepare_rnn_weights([{k: jnp.asarray(v) for k, v in l.items()} for l in layers])
    state = (t(hs), t(cs)) if cell == "lstm" else t(hs)
    return stacked, t(x), state, jax_stacked, (x, hs, cs)


@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("E", [16, 24], ids=["E<H", "E=H"])
@pytest.mark.parametrize("B", [1, 3, 33])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_split_stack_matches_plain_and_pallas(cell, B, E, L):
    """At S = 1, 2 and 3 the split stack step's new state is within 1e-5 of
    the plain stack and of the interpreted stack-step kernel; at S = 1 it
    is the unsplit layer's, bit for bit."""
    stacked, x, state, jax_stacked, (xn, hs, cs) = _case(cell, B, E, L, seed=7 * B + E + L)
    _, ref_state = stack_plain(cell)(stacked, x, state)
    if cell == "lstm":
        _, j_state = lstm_stack_step_pallas(jax_stacked, jnp.asarray(xn), jnp.asarray(hs), jnp.asarray(cs),
                                            interpret=True)
    else:
        _, j_state = gru_stack_step_pallas(jax_stacked, jnp.asarray(xn), jnp.asarray(hs), interpret=True)
    for S in (1, 2, 3):
        top, new_state = split_stack(cell, stacked, x, state, S)
        np.testing.assert_array_equal(top, _states(new_state)[0][-1])
        for got, ref, jref in zip(_states(new_state), _states(ref_state), _states(j_state)):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5, err_msg="S=%d" % S)
            np.testing.assert_allclose(got, jref, rtol=1e-5, atol=1e-5, err_msg="S=%d" % S)
        if S == 1:
            for got, unsplit in zip(_states(new_state), _states(tiled_stack(cell, stacked, x, state)[1])):
                np.testing.assert_array_equal(got, unsplit)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_every_arrival_order_gives_the_same_bits(cell):
    """A layer with more chunks than parts (E=64, H=24: 3 chunks) at S = 3,
    two slabs (B=33): every order in which the three parts of each item
    arrive finishes the item once, leaves the counters at zero and gives
    the same bits; S = 2 and 3 differ from each other only by f32 order."""
    stacked, x, state, _, _ = _case(cell, 33, 64, 1, seed=5)
    runs = [split_stack(cell, stacked, x, state, 3, order)[1] for order in itertools.permutations(range(3))]
    for other in runs[1:]:
        for a, b in zip(_states(runs[0]), _states(other)):
            np.testing.assert_array_equal(a, b)
    _, ref_state = stack_plain(cell)(stacked, x, state)
    for S in (2, 3):
        for got, ref in zip(_states(split_stack(cell, stacked, x, state, S)[1]), _states(ref_state)):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
