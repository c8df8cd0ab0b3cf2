"""The bf16 greedy steps' argmax end on the tensor cores (csrc/dense_mma.cuh), on the CPU.

The bf16 greedy instances (pooled and attention, GRU and LSTM) and the
bf16 whole decode run the recurrence and the projection on the tensor
cores and end in an argmax
over each item's staged sums.  The kernels run only on the card; here the
end is re-enacted in numpy thread by thread, on the staged sums that
tests/test_torch_gate_tiles.py's lane-by-lane re-enactment of the
projection forms: thread 4n + q scans the 16 consecutive vocabulary rows
v0 + 16q .. v0 + 16q + 15 of batch row n for their first max (sum + bias),
the four threads of a row take the max of their packed (logit, ~index)
keys by two xor shuffles, and one atomicMax a row merges the item into
best.  The re-enactment is held to the plain twins
(``fused_gru_decode_step_plain``, ``fused_lstm_decode_step_plain``,
``fused_attn_decode_step_plain``) and to the JAX package's
fused_gru_decode_step_pallas, fused_lstm_decode_step_pallas and
fused_attn_decode_step_pallas in interpret mode, in f32 at small widths
(E=16, H=24, L=2, R = 3, 19, 33, V = 40 and 77); ties within one thread's
run, between two threads of a row, across two items and between the
first and last items go to the lower index, whatever the items' order.
The geometry constants are read back from the headers, and the wrappers'
geometry check (``fused_step.mma_tiles`` for the instances that
``fused_step.mma_step`` names, ``fused_step.stack_tiles`` for the stack
steps) is tested with the library replaced.
"""

import os
import re

import numpy as np
import pytest
import torch

from show_tell_tpu.ops.fused_attn_pallas import fused_attn_decode_step_pallas
from show_tell_tpu.ops.fused_step_pallas import fused_gru_decode_step_pallas, fused_lstm_decode_step_pallas
from show_tell_tpu_torch.ops import build, fused_attn, fused_step, whole_decode
from show_tell_tpu_torch.ops.fused_attn import (
    fused_attn_decode_step_cuda,
    fused_attn_decode_step_plain,
    fused_attn_dense_step_cuda,
)
from show_tell_tpu_torch.ops.fused_beam import fused_dense_step_cuda
from show_tell_tpu_torch.ops.fused_step import (
    fused_gru_decode_step_cuda,
    fused_gru_decode_step_plain,
    fused_lstm_decode_step_cuda,
    fused_lstm_decode_step_plain,
)
from show_tell_tpu_torch.ops.rnn import gru_stack_step_cuda, lstm_stack_step_cuda, stack_plain
from show_tell_tpu_torch.ops.vocab import first_max_argmax, project_logits
from show_tell_tpu_torch.ops.whole_decode import gru_whole_greedy_decode_cuda
from test_torch_gate_tiles import (
    BLOCK_V,
    HEADER,
    SLAB,
    SLOTS,
    WARPS,
    _assert_states,
    _attn_case,
    _pooled_case,
    mma_sum,
    tiled_logits,
    tiled_stack,
    vocab_item_sums,
)

ROW_THREADS = 4  # threads scanning one batch row of an item (kRowThreads in csrc/vocab_mma.cuh)
THREADS = 32 * WARPS
RUN = 16  # consecutive vocabulary rows a thread scans: one m16 slot
GAP = 1e-4  # f32: tokens agree where the top-2 logit gap exceeds the summation order's reach


# ---------------------------------------------------------------- the end, thread by thread


def pack_key(val, idx):
    """pack_key of csrc/decode_common.cuh as a Python int: the float's
    ordered bits (-0.0 folded onto +0.0) over ~index."""
    u = int(np.float32(val + np.float32(0.0)).view(np.uint32))
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | (0xFFFFFFFF - idx)


def key_index(key):
    return 0xFFFFFFFF - (key & 0xFFFFFFFF)


def argmax_end(red, n0, nb, v0, bv, best):
    """The argmax end of one item on its staged sums: each thread's first
    max over its run, row_max_key's two xor shuffles, the q = 0 thread of
    each real row's atomicMax into best (a list of Python ints)."""
    V = len(bv)
    keys = [0] * THREADS
    for tid in range(THREADS):
        n, q = tid // ROW_THREADS, tid % ROW_THREADS
        val, idx = np.float32(-np.inf), -1
        if n < nb:
            for m in range(RUN):  # increasing v: a later v replaces the best only if strictly greater
                v = v0 + RUN * q + m
                if v < V:
                    x = mma_sum(red, q, m, n) + np.float32(bv[v])
                    if idx < 0 or x > val:
                        val, idx = x, v
        keys[tid] = pack_key(val, idx) if idx >= 0 else 0
    for off in (1, 2):  # row_max_key: lanes 4n .. 4n + 3 of a warp
        keys = [max(keys[tid], keys[tid ^ off]) for tid in range(THREADS)]
    for tid in range(0, THREADS, ROW_THREADS):
        if tid // ROW_THREADS < nb:
            best[n0 + tid // ROW_THREADS] = max(best[n0 + tid // ROW_THREADS], keys[tid])


def tiled_argmax(top, wv, bv, order=None):
    """mma_vocab_phase's argmax end re-enacted: best starts at 0 (below every
    key), the items merge in ``order``; returns (tok [R] int32, best keys)."""
    best = [0] * top.shape[0]
    for n0, v0, red in vocab_item_sums(top, wv, order):
        argmax_end(red, n0, min(SLAB, top.shape[0] - n0), v0, bv, best)
    return np.array([key_index(k) for k in best], np.int32), best


def _clear(top, vocab):
    """Rows whose top-2 logit gap (plain projection) exceeds GAP."""
    logits = np.sort(project_logits(vocab, torch.as_tensor(top)).numpy(), axis=1)
    return logits[:, -1] - logits[:, -2] > GAP


# ---------------------------------------------------------------- geometry


def test_argmax_end_constants_agree_with_the_kernel_headers():
    """Four threads a batch row (kTileThreads / kGroup of vocab_mma.cuh),
    32 rows an item: the block's 128 threads; each thread one m16 slot of
    the item's 64 vocabulary rows, scanned in increasing v."""
    csrc = os.path.dirname(HEADER)
    vocab_src = open(os.path.join(csrc, "vocab_mma.cuh")).read()
    const = lambda name: int(re.search(r"constexpr int %s = (\d+);" % name, vocab_src).group(1))
    assert 32 * const("kTileWarps") // const("kGroup") == ROW_THREADS
    assert "constexpr int kRowThreads = kTileThreads / kGroup;" in vocab_src
    assert THREADS == ROW_THREADS * SLAB and RUN * ROW_THREADS == 16 * SLOTS
    src = open(HEADER).read()
    end = src[src.index("mma_project(top, wv, B, H, V, red, [&](int n0, int nb, int v0) {\n    const int n"):]
    assert "const int n = tid / kRowThreads, q = tid % kRowThreads;" in end
    assert "const int tid = phase_thread();\n  mma_project(top, wv, B, H, V, red, [&](int n0, int nb, int v0) {" in src
    assert "for (int m = 0; m < 16; ++m) {" in end and "const int v = v0 + 16 * q + m;" in end
    assert "const float x = mma_sum(red, q, m, n) + Vec<T>::to_f32(bv[v]);" in end
    assert "if (idx < 0 || x > val) {" in end
    assert "row_max_key(idx >= 0 ? pack_key(val, idx) : 0ull)" in end
    assert "if (n < nb && q == 0) atomicMax(best + n0 + n, key);" in end
    assert "mma_argmax_keys(top, wv, bv, B, H, V, out.best, red);\n    argmax_tokens(out, B, grid);" in src


def test_pack_key_orders_values_then_lower_indices():
    vals = [np.float32(v) for v in (-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf)]
    keys = [pack_key(v, 5) for v in vals]
    assert keys == sorted(keys) and keys[3] == keys[4]  # -0.0 and +0.0 compare equal
    assert pack_key(np.float32(1.0), 3) > pack_key(np.float32(1.0), 4) > 0
    assert key_index(pack_key(np.float32(-2.0), 9955)) == 9955


# ---------------------------------------------------------------- against the twins and Pallas


@pytest.mark.parametrize("V", [40, 77])
@pytest.mark.parametrize("R", [3, 19, 33])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_pooled_argmax_tiles_match_plain_and_pallas(cell, R, V):
    """The pooled greedy step of either cell in the tiles' order: the new
    state within 1e-5 of the plain twin's and the interpreted
    fused_gru_decode_step_pallas's / fused_lstm_decode_step_pallas's,
    tokens equal to both where the top-2 gap is clear, and bit for bit the
    first-max argmax of the dense end's logits on the same staged sums."""
    port, jax_args = _pooled_case(cell, R, V, 300 + R + V)
    stacked, vocab, x, state = port
    top, new_state = tiled_stack(cell, stacked, x, state)
    tok, _ = tiled_argmax(top, vocab["w"].numpy(), vocab["b"].numpy())
    dense = tiled_logits(top, vocab["w"].numpy(), vocab["b"].numpy())
    assert np.array_equal(tok, first_max_argmax(torch.from_numpy(dense)).numpy())
    plain_step = fused_lstm_decode_step_plain if cell == "lstm" else fused_gru_decode_step_plain
    ref_tok, ref_state = plain_step(*port)
    _assert_states(new_state, ref_state)
    clear = _clear(top, vocab)
    assert clear.mean() > 0.8
    assert np.array_equal(tok[clear], ref_tok.numpy()[clear])
    j_stacked, j_vocab, j_x, j_state0 = jax_args
    if cell == "lstm":
        j_tok, j_state = fused_lstm_decode_step_pallas(j_stacked, j_vocab, j_x, *j_state0, block_v=BLOCK_V,
                                                       interpret=True)
    else:
        j_tok, j_state = fused_gru_decode_step_pallas(j_stacked, j_vocab, j_x, j_state0, block_v=BLOCK_V,
                                                      interpret=True)
    assert np.array_equal(tok[clear], np.asarray(j_tok)[clear])
    _assert_states(new_state, j_state)


@pytest.mark.parametrize("V", [40, 77])
@pytest.mark.parametrize("R", [3, 19])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_attention_argmax_tiles_match_plain_and_pallas(cell, R, V):
    """The attention greedy step, both cells: A1 and A2 as the plain twin
    forms them (SIMT in every instance), the recurrence and the argmax end
    in the tiles' order, against the plain twin and the interpreted
    fused_attn_decode_step_pallas."""
    (prep, w_emb, tstate), x, (j_prep, j_emb, j_state0) = _attn_case(cell, R, V, 400 + R + V)
    with torch.inference_mode():
        top, new_state = tiled_stack(cell, prep["stacked"], x, tstate)
        ref_tok, ref_state = fused_attn_decode_step_plain(prep, w_emb, tstate)
    vocab = {k: v.detach() for k, v in prep["vocab"].items()}
    tok, _ = tiled_argmax(top, vocab["w"].numpy(), vocab["b"].numpy())
    _assert_states(new_state, ref_state)
    clear = _clear(top, vocab)
    assert clear.mean() > 0.8
    assert np.array_equal(tok[clear], ref_tok.numpy()[clear])
    j_tok, j_state = fused_attn_decode_step_pallas(j_prep, cell, j_emb, j_state0, block_v=BLOCK_V, interpret=True)
    assert np.array_equal(tok[clear], np.asarray(j_tok)[clear])
    _assert_states(new_state, j_state)


# (lower, higher) tied columns at V = 77 (items of 64 rows: v 0-63 and 64-76)
TIES = {
    "one thread's run": (3, 9),  # both in thread q = 0's rows 0-15
    "two threads of a row": (5, 20),  # q = 0 and q = 1
    "across two items": (63, 64),  # the first item's last row and the second's first
    "first and last items": (2, 76),
}


@pytest.mark.parametrize("where", list(TIES))
def test_ties_go_to_the_lower_index_whatever_the_item_order(where):
    """Two vocabulary rows equal and top in every row (the same weight row,
    bias 50): the end gives the lower index, as the plain twin, with the
    items merged in their order, reversed, or shuffled; the keys agree.
    The tied rows hold one weight, 1/4 at column 0, so each logit is 50 +
    top[n, 0] / 4 rounded once in any summation order: the twin's CPU
    product ties them bit for bit too (equal rows of an inexact product
    need not, whatever the thread count)."""
    lo, hi = TIES[where]
    port, _ = _pooled_case("lstm", 19, 77, 11)
    stacked, vocab, x, state = port
    vocab["w"][lo] = vocab["w"][hi] = 0.0
    vocab["w"][lo, 0] = vocab["w"][hi, 0] = 0.25
    vocab["b"][lo] = vocab["b"][hi] = 50.0
    top, _ = tiled_stack("lstm", stacked, x, state)
    wv, bv = vocab["w"].numpy(), vocab["b"].numpy()
    dense = tiled_logits(top, wv, bv)
    assert np.array_equal(dense[:, lo], dense[:, hi])
    twin = project_logits(vocab, stack_plain("lstm")(stacked, x, state)[0])
    assert torch.equal(twin[:, lo], twin[:, hi])
    items = 2  # one slab of 19 rows, two vocabulary items
    runs = [tiled_argmax(top, wv, bv, order) for order in (None, range(items)[::-1], [1, 0])]
    for tok, best in runs:
        assert tok.tolist() == [lo] * 19 and best == runs[0][1]
    assert fused_lstm_decode_step_plain(*port)[0].tolist() == [lo] * 19


def test_item_order_does_not_change_the_keys():
    """Three slabs (R = 65) and two items a slab, merged in every order of a
    random permutation and its reverse: the same best keys."""
    port, _ = _pooled_case("lstm", 65, 77, 12)
    stacked, vocab, x, state = port
    top, _ = tiled_stack("lstm", stacked, x, state)
    wv, bv = vocab["w"].numpy(), vocab["b"].numpy()
    order = np.random.RandomState(0).permutation(6).tolist()
    _, best = tiled_argmax(top, wv, bv)
    assert tiled_argmax(top, wv, bv, order)[1] == best == tiled_argmax(top, wv, bv, order[::-1])[1]


# ---------------------------------------------------------------- the wrappers' geometry check


STACK_TILES = fused_step.stack_tiles


class _Launched(Exception):
    """The library was asked for: the wrapper got past its checks."""


def _small(dtype, lstm, B=3, E=16, H=24, V=40, A=16, P=5, L=2, device="cpu"):
    """Pooled step operands (stacked, vocab, x, state) and attention
    operands (prep, w_emb, state) of the kernel layout, zeros."""
    G = (4 if lstm else 3) * H
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    hs = z(L, B, H)
    state = (hs, z(L, B, H)) if lstm else hs
    stacked = lambda I0: {"w_ih0": z(G, I0), "w_ihU": z(L - 1, G, H), "w_hh": z(L, G, H), "b_ih": z(L, G),
                          "b_hh": z(L, G)}
    vocab = {"w": z(V, H), "b": z(V)}
    prep = {"stacked": stacked(2 * E), "vocab": vocab, "wdec": z(A, H), "bdec": z(A), "wfull": z(A), "b_emb": z(E),
            "att1": z(B, P, A), "feats_e": z(B, P, E)}
    return (stacked(E), vocab, z(B, E), state), (prep, z(B, E), state)


@pytest.fixture
def no_library(monkeypatch):
    """mma_tiles' calls recorded; the library replaced by a raise."""
    calls = []

    def spy(*args, **kw):
        calls.append(args + tuple(kw.values()))
        return fused_step.mma_tiles.__wrapped__(*args, **kw)

    spy.__wrapped__ = fused_step.mma_tiles
    monkeypatch.setattr(fused_step, "mma_tiles", spy)
    monkeypatch.setattr(fused_attn, "mma_tiles", spy)
    monkeypatch.setattr(whole_decode, "mma_tiles", spy)

    def stack_spy(*args, **kw):
        calls.append(args + tuple(kw.values()))
        return STACK_TILES(*args, **kw)

    monkeypatch.setattr(fused_step, "stack_tiles", stack_spy)
    monkeypatch.setattr(fused_step, "sm_count", lambda device: 132)  # an H100's SMs, for tensors off the card

    def load_library():
        raise _Launched()

    monkeypatch.setattr(build, "load_library", load_library)
    return calls


def test_mma_tiles_check_runs_for_the_tensor_core_instances_only(no_library):
    """bf16 dense steps, the greedy steps (pooled and attention, both
    cells), the whole decode and the stack steps (``stack_tiles``, with
    the card's SM count and no forced S) check the tensor-core geometry
    before the launch; in f32 the pooled greedy and dense steps of both
    cells, the whole decode and the attention steps (greedy and dense, both
    cells) do too (split-precision TF32, ``tf32x3_step``, with the f32
    chunks and slabs), and so does their K split (``stack_tiles`` in f32);
    the f32 stack steps check their K split (``stack_tiles`` in f32) as
    the bf16 ones do in bf16.  The top-k steps: tests/test_torch_topk_tiles.py."""
    B, E, H, V, A, P = 3, 16, 24, 40, 16, 5
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for lstm in (False, True):
            (stacked, vocab, x, state), (prep, w_emb, astate) = _small(dtype, lstm)
            # the attention steps, greedy and dense: in f32 with their 2E-wide layer 0's K split
            attn_checks = ([(B, 2 * E, H, V, (A, P))] if bf16 else
                           [(B, 2 * E, H, V, (A, P), dtype), (B, 2 * E, H, 132, 0, dtype)])
            launches = [
                (lambda: (fused_lstm_decode_step_cuda if lstm else fused_gru_decode_step_cuda)(stacked, vocab, x,
                                                                                                 state),
                 [(B, E, H, V) if bf16 else (B, E, H, V, dtype)] + ([] if bf16 else [(B, E, H, 132, 0, dtype)])),
                (lambda: fused_dense_step_cuda(stacked, vocab, x, state),
                 [(B, E, H, V)] if bf16 else [(B, E, H, V, dtype), (B, E, H, 132, 0, dtype)]),
                (lambda: (lstm_stack_step_cuda if lstm else gru_stack_step_cuda)(stacked, x, state),
                 [(B, E, H, 132, 0, dtype)]),
                (lambda: fused_attn_decode_step_cuda(prep, w_emb, astate), attn_checks),
                (lambda: fused_attn_dense_step_cuda(prep, w_emb, astate), attn_checks),
            ]
            if not lstm:  # the whole decode: the pooled GRU's greedy step T times (in f32 with its K split)
                emb = torch.zeros(V, E, dtype=dtype)
                launches.append((lambda: gru_whole_greedy_decode_cuda(
                    {"stacked": stacked, "vocab": vocab, "embedding": emb}, x, 4),
                    [(B, E, H, V) if bf16 else (B, E, H, V, dtype)] + ([] if bf16 else [(B, E, H, 132, 0, dtype)])))
            for launch, checked in launches:
                no_library.clear()
                with pytest.raises(_Launched):
                    launch()
                assert no_library == checked
        assert fused_step.mma_step(dtype, "argmax") == fused_step.mma_step(dtype, "dense") == bf16
        assert fused_step.mma_step(dtype, 3) == bf16  # a top-k width: bf16 top-k runs on the tensor cores too
        assert fused_step.mma_step(dtype, None) == bf16  # the stack step: bf16 on the tensor cores too


def test_a_width_that_does_not_fit_raises_before_the_launch(no_library):
    """The attention greedy step at H=8,192 (A1 holds 8 rows of h in f32:
    262,144 bytes) raises, on meta tensors, before the library is asked
    for: in bf16, and in f32, whose instances run the tensor cores in
    split-precision TF32 and check the same geometry."""
    for lstm in (False, True):
        for dtype in (torch.bfloat16, torch.float32):
            (_, _, _, _), (prep, w_emb, state) = _small(dtype, lstm, H=8192, E=512, A=512, P=49, L=1, device="meta")
            with pytest.raises(ValueError, match="H=8192, A=512, P=49 needs 262144 bytes"):
                fused_attn_decode_step_cuda(prep, w_emb, state)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_step.mma_tiles(64, 20, 512, 9956)
    assert fused_step.mma_tiles(64, 512, 512, 9956) == (64, 312, 32, 32, 16, 33792)
