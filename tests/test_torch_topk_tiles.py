"""The bf16 pooled top-k beam step's end on the tensor cores (csrc/dense_mma.cuh), on the CPU.

The bf16 top-k instances of csrc/fused_step.cu (GRU and LSTM) run the
recurrence and the projection on the tensor cores and end in
``mma_topk_parts``: for each (64 vocabulary rows, 32 batch rows) item,
thread 4n + q scans vocabulary rows v0 + 16q .. v0 + 16q + 15 of batch row
n (sum + bias) into its K greatest packed (logit, ~index) keys and its
(max, sum of exp); the four threads of a row combine by xor shuffles (the
max of the maxima, the rescaled sum of the sums) and K pops of the greatest
head, and one thread writes the row's part of the item at part index
v0 / 64.  After a grid barrier, ``merge_topk`` reduces each row's
ceil(V / 64) parts.  The kernels run only on the card; here the end is
re-enacted in numpy thread by thread on the staged sums that
tests/test_torch_gate_tiles.py's lane-by-lane re-enactment of the
projection forms, and the merge by tests/test_torch_vocab_tiles.py's
``merge_parts``.  The re-enactment is held, in f32 at small widths (E=16,
H=24, L=2, R = 3, 19, 33, V = 40 and 77, k = 1, 3, 5), to the plain twin
``fused_topk_step_plain`` and to the JAX package's
fused_topk_step_pallas in interpret mode.  Ties within one thread's run,
between two threads of a row, across two items, inside the last item and
between the first and last items list the lower index first, whatever
the items' order; their data lie on a 1/64 grid, so every sum is exact in
any order.  The scratch (one part per item) and the wrappers' geometry
check are tested with the library replaced.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.ops.fused_beam_pallas import fused_topk_step_pallas
from show_tell_tpu.ops.vocab_pallas import project_topk_pallas
from show_tell_tpu_torch.ops import fused_step
from show_tell_tpu_torch.ops.fused_beam import fused_topk_step, fused_topk_step_cuda, fused_topk_step_plain
from show_tell_tpu_torch.ops.fused_step import MMA_VOCAB_ROWS
from show_tell_tpu_torch.ops.vocab import (
    MAX_K,
    project_logits,
    project_topk_plain,
    stable_topk,
    topk_launch_args,
    vocab_tiles,
)
from test_torch_argmax_tiles import RUN, THREADS, ROW_THREADS, _Launched, _small, no_library, pack_key  # noqa: F401
from test_torch_gate_tiles import (
    BLOCK_V,
    HEADER,
    SLAB,
    SLOTS,
    _assert_states,
    _pooled_case,
    mma_sum,
    tiled_logits,
    tiled_stack,
    vocab_item_sums,
)
from test_torch_vocab_tiles import _assert_tied, _case, _jax_vocab, _port_vocab, key_indices, merge_parts

GAP = 1e-4  # f32: ids agree where the k + 1 best logits are this far apart (the summation order's reach)


# ---------------------------------------------------------------- the end, thread by thread


def insert(keys, key):
    """TopkList::insert: keep the MAX_K greatest keys, largest first."""
    if len(keys) < MAX_K or key > keys[-1]:
        keys.append(key)
        keys.sort(reverse=True)
        del keys[MAX_K:]


def topk_end(red, n0, nb, v0, bv, k, part_keys, part_ms):
    """mma_topk_parts on one item's staged sums: each thread's keys and (m,
    s) over its run, the xor shuffles of its row's four threads, and the
    writer's part at index v0 / 64 of part_keys [parts, R, k] (uint64) and
    part_ms [parts, R, 2] (f32)."""
    V = len(bv)
    lists, ms, ss = [], [], []
    for tid in range(THREADS):
        n, q = tid // ROW_THREADS, tid % ROW_THREADS
        keys, xs, m = [], [], np.float32(-np.inf)
        if n < nb:
            for i in range(RUN):
                v = v0 + RUN * q + i
                if v < V:
                    x = mma_sum(red, q, i, n) + np.float32(bv[v])
                    m = max(m, x)
                    insert(keys, pack_key(x, v))
                    xs.append(x)
        s = np.float32(0.0)
        for x in xs:  # a second pass, from the thread's maximum
            s = np.float32(s + np.exp(np.float32(x - m)))
        lists.append(keys)
        ms.append(m)
        ss.append(s)
    mx = list(ms)
    for off in (1, 2):  # xor shuffles over lanes 4n .. 4n + 3
        mx = [max(mx[t], mx[t ^ off]) for t in range(THREADS)]
    sums = [np.float32(ss[t] * np.exp(np.float32(ms[t] - mx[t]))) if ss[t] > 0 else np.float32(0.0)
            for t in range(THREADS)]
    for off in (1, 2):
        sums = [np.float32(sums[t] + sums[t ^ off]) for t in range(THREADS)]
    p = v0 // MMA_VOCAB_ROWS
    for j in range(k):
        best = [keys[0] if keys else 0 for keys in lists]
        for off in (1, 2):  # row_max_key
            best = [max(best[t], best[t ^ off]) for t in range(THREADS)]
        for t in range(THREADS):
            if lists[t] and lists[t][0] == best[t]:
                lists[t].pop(0)
        for t in range(0, THREADS, ROW_THREADS):
            if t // ROW_THREADS < nb:
                part_keys[p, n0 + t // ROW_THREADS, j] = best[t]
    for t in range(0, THREADS, ROW_THREADS):
        if t // ROW_THREADS < nb:
            part_ms[p, n0 + t // ROW_THREADS] = (mx[t], sums[t])


def tiled_topk(top, wv, bv, k, order=None):
    """mma_vocab_phase's top-k end re-enacted: every item's part, in
    ``order``, then merge_topk over the ceil(V / 64) parts of each row.
    Returns (logp [R, k] f32, ids [R, k] int32, part_keys, part_ms)."""
    R, V = top.shape[0], wv.shape[0]
    parts = -(-V // MMA_VOCAB_ROWS)
    part_keys = np.zeros((parts, R, k), np.uint64)
    part_ms = np.full((parts, R, 2), np.nan, np.float32)
    for n0, v0, red in vocab_item_sums(top, wv, order):
        topk_end(red, n0, min(SLAB, R - n0), v0, bv, k, part_keys, part_ms)
    assert not np.isnan(part_ms).any()  # every (part, row) written once the items are done
    logp, ids = merge_parts(list(part_keys), [(ms[:, 0], ms[:, 1]) for ms in part_ms], k)
    return logp, ids, part_keys, part_ms


def _clear(logits, k):
    """Rows whose k + 1 best logits are more than GAP apart."""
    best = np.sort(logits, axis=1)[:, ::-1][:, : k + 1]
    return (best[:, :-1] - best[:, 1:]).min(axis=1) > GAP


# ---------------------------------------------------------------- the kernel's source


def test_topk_end_agrees_with_the_kernel_sources():
    """The re-enactment's rules, read back from dense_mma.cuh and
    fused_step.cu: bf16 top-k is an mma_step instance (f32 top-k a
    tf32x3_step one, the same end templated on the type); the end scans
    thread q's 16 rows, keys them by pack_key, sums exp from the thread's
    max, combines the row's four threads, writes part v0 / 64; the merge
    reads ceil(V / 64) parts after a grid barrier; the C entry points
    refuse scratch for fewer parts in either dtype."""
    src = open(HEADER).read()
    assert "(kMode == kDense || kMode == kTopk || kMode == kArgmax || kMode == kNone)" in src
    end = src[src.index("__device__ void mma_topk_parts("):src.index("// The vocab phase of an mma_step instance")]
    assert "const int n = tid / kRowThreads, q = tid % kRowThreads;" in end
    assert "const int v = v0 + 16 * q + i;" in end and "for (int i = 0; i < 16; ++i) {" in end
    assert "x[i] = mma_sum(red, q, i, n) + Vec<T>::to_f32(bv[v]);" in end
    assert "m = fmaxf(m, x[i]);\n        list.insert(pack_key(x[i], v));" in end
    assert "if (n < nb && v0 + 16 * q + i < V) s += expf(x[i] - m);" in end
    assert "float sum = s > 0.0f ? s * expf(m - mx) : 0.0f;" in end
    assert "const size_t at = static_cast<size_t>(v0 / kMmaVocabRows) * B + n0 + n;" in end
    assert "const unsigned long long best = row_max_key(list.keys[0]);" in end
    assert "if (writer) a.part_ms[at] = make_float2(mx, sum);" in end
    assert ("mma_topk_parts(top, wv, bv, B, H, V, out.topk, red);\n    grid.sync();  // every part is in scratch\n"
            "    merge_topk(out.topk, B, (V + kMmaVocabRows - 1) / kMmaVocabRows);") in src
    step = open(os.path.join(os.path.dirname(HEADER), "fused_step.cu")).read()
    assert "K <= V && max_splits >= (V + kMmaVocabRows - 1) / kMmaVocabRows;" in step
    refusal = ("if (!topk_args_ok(V, K, max_splits) || !split_args_ok(dtype == 0, split, B, H))\n"
               "    return static_cast<int>(cudaErrorInvalidValue);")
    assert step.count(refusal) == 2
    assert MMA_VOCAB_ROWS == 16 * SLOTS == RUN * ROW_THREADS


# ---------------------------------------------------------------- against the twin and Pallas

_STEPS = {}  # (cell, R, V) -> (port operands, JAX operands, top, new state, dense logits): the tiles' stack once


def _step(cell, R, V):
    if (cell, R, V) not in _STEPS:
        port, jax_args = _pooled_case(cell, R, V, 500 + R + V)
        stacked, vocab, x, state = port
        top, new_state = tiled_stack(cell, stacked, x, state)
        dense = tiled_logits(top, vocab["w"].numpy(), vocab["b"].numpy())
        _STEPS[cell, R, V] = port, jax_args, top, new_state, dense
    return _STEPS[cell, R, V]


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("V", [40, 77])
@pytest.mark.parametrize("R", [3, 19, 33])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_pooled_topk_tiles_match_plain_and_pallas(cell, R, V, k):
    """The pooled top-k step of either cell in the tiles' order: ids equal
    the stable top-k of the dense end's logits on the same staged sums bit
    for bit, and the plain twin's and the interpreted
    fused_topk_step_pallas's where the k + 1 best logits are clear; logp
    within 1e-5 of both and of log_softmax of the dense logits; the new
    state within 1e-5; no key of a padded row v >= V."""
    port, jax_args, top, new_state, dense = _step(cell, R, V)
    stacked, vocab, x, state = port
    logp, ids, part_keys, _ = tiled_topk(top, vocab["w"].numpy(), vocab["b"].numpy(), k)
    assert part_keys.shape == (-(-V // 64), R, k)
    assert (key_indices(part_keys[part_keys > 0]) < V).all()
    d_logp, d_ids = stable_topk(torch.log_softmax(torch.from_numpy(dense), dim=-1), k)
    np.testing.assert_array_equal(ids, stable_topk(torch.from_numpy(dense), k)[1].numpy())
    np.testing.assert_allclose(logp, d_logp.numpy(), rtol=1e-5, atol=1e-5)
    (ref_logp, ref_ids), ref_state = fused_topk_step_plain(stacked, vocab, x, state, k)
    _assert_states(new_state, ref_state)
    clear = _clear(dense, k)
    assert clear.mean() > 0.6  # k + 1 = 6 logits of 40-77 may come closer than GAP (one of the 3 rows at R=3)
    np.testing.assert_array_equal(ids[clear], ref_ids.numpy()[clear])
    np.testing.assert_allclose(logp, ref_logp.numpy(), rtol=1e-5, atol=1e-5)
    (j_logp, j_ids), j_state = fused_topk_step_pallas(cell, *jax_args, k, block_v=BLOCK_V, interpret=True)
    np.testing.assert_array_equal(ids[clear], np.asarray(j_ids)[clear])
    np.testing.assert_allclose(logp, np.asarray(j_logp), rtol=1e-5, atol=1e-5)
    _assert_states(new_state, j_state)
    got = fused_topk_step(stacked, vocab, x, state, k)[0]  # the wrapper on CPU tensors: the twin
    assert torch.equal(got[1], ref_ids)


# (lower, higher) tied columns at V = 77 (items of 64 rows: v 0-63 and 64-76; thread q scans v0 + 16q .. + 15)
TIES = {
    "one thread's run": (3, 9),  # both in item 0, thread q = 0
    "two threads of a row": (5, 20),  # q = 0 and q = 1
    "across two items": (63, 64),  # the first item's last row and the second's first
    "inside the last item": (70, 76),  # item 1, the ragged one
    "first and last items": (2, 76),
}


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("where", list(TIES))
def test_ties_list_the_lower_index_first_whatever_the_item_order(where, k):
    """Two equal columns on top of every row (one copied from the other,
    both biased to 50) come out lower index first, with the items merged in
    their order, reversed and shuffled: the same parts each time, and the
    plain twin's and the interpreted project_topk_pallas's ids.  The data
    lie on a 1/64 grid, so every sum of the product is exact and the tied
    logits are bit-equal in any summation order (a CPU BLAS need not tie
    equal columns of an inexact product: its blocking follows the thread
    count)."""
    lo, hi = TIES[where]
    linear, top = _case(20 + k, 77, R=33, ties=((lo, hi),))
    vocab = _port_vocab(linear)
    ref_logp, ref_ids = project_topk_plain(vocab, torch.from_numpy(top), k)
    wv, bv = vocab["w"].numpy(), vocab["b"].numpy()
    for logits in (tiled_logits(top, wv, bv), project_logits(vocab, torch.from_numpy(top)).numpy()):
        _assert_tied(logits, ((lo, hi),))
    items = 2 * 2  # two slabs of 32 rows, two vocabulary items
    runs = [tiled_topk(top, wv, bv, k, order)
            for order in (None, range(items)[::-1], np.random.RandomState(k).permutation(items).tolist())]
    for logp, ids, part_keys, part_ms in runs:
        assert ids[:, :2].tolist() == [[lo, hi]] * len(top)
        np.testing.assert_array_equal(ids, ref_ids.numpy())
        np.testing.assert_allclose(logp, ref_logp.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(part_keys, runs[0][2])
        np.testing.assert_array_equal(part_ms, runs[0][3])
    j_logp, j_ids = project_topk_pallas(_jax_vocab(linear), jnp.asarray(top), k, block_v=BLOCK_V, interpret=True)
    np.testing.assert_array_equal(runs[0][1], np.asarray(j_ids))


def test_item_order_does_not_change_the_parts():
    """Three slabs (R = 65) and two items a slab, in a random order and its
    reverse: the same parts, bit for bit, so the merge folds the same
    (max, sum) pairs in the same order."""
    port, _ = _pooled_case("gru", 65, 77, 13)
    stacked, vocab, x, state = port
    top, _ = tiled_stack("gru", stacked, x, state)
    wv, bv = vocab["w"].numpy(), vocab["b"].numpy()
    order = np.random.RandomState(1).permutation(6).tolist()
    runs = [tiled_topk(top, wv, bv, 5, o) for o in (None, order, order[::-1])]
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- scratch and the wrappers' checks


@pytest.mark.parametrize("B,V,k", [(1, 9956, 3), (3, 40, 1), (19, 77, 5), (192, 9956, 3), (320, 9956, 5),
                                   (768, 9956, 8)])
def test_topk_scratch_holds_one_part_per_item(B, V, k):
    """topk_launch_args(tiles=ceil(V / 64)): one part per 64-row vocabulary
    item (156 at V = 9,956), and every (part, row) is some item's, once."""
    parts = -(-V // MMA_VOCAB_ROWS)
    max_splits, part_keys, part_ms, logp, ids = topk_launch_args("fused_topk_step", B, V, k, torch.device("cpu"),
                                                                 parts)
    assert max_splits == parts and parts == (156 if V == 9956 else -(-V // 64))
    assert part_keys.shape == (parts, B, k) and part_keys.dtype == torch.int64
    assert part_ms.shape == (parts, B, 2) and part_ms.dtype == torch.float32
    assert logp.shape == ids.shape == (B, k)
    geometry = fused_step.mma_tiles(B, 16, 24, V)
    slabs = -(-B // SLAB)
    assert geometry.vocab_items == slabs * parts
    written = np.zeros((parts, B), np.int64)
    for item in range(geometry.vocab_items):  # mma_project's item -> (slab, v0); the part is v0 / 64
        n0, v0 = (item % slabs) * SLAB, (item // slabs) * MMA_VOCAB_ROWS
        written[v0 // MMA_VOCAB_ROWS, n0 : n0 + SLAB] += 1
    assert (written == 1).all()


def test_topk_launch_checks_geometry_and_sizes_scratch(no_library, monkeypatch):
    """Top-k steps (both cells, bf16 and f32) check the tensor-core
    geometry and size their scratch at one part per 64-row item before the
    library is asked for; f32 also takes its layers' K split (stack_tiles
    in f32).  Every top-k phase sizes its scratch by the parts it writes:
    the f32 projection kernel, on V-tiles as bf16's, one part a tile
    (vocab_tiles in f32), not a bound on a SIMT grid."""
    sized = []

    def spy(*args):
        sized.append(args[-1])
        return topk_launch_args(*args)

    monkeypatch.setattr(fused_step, "topk_launch_args", spy)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: types.SimpleNamespace(
        multi_processor_count=132))
    B, E, H, V = 3, 16, 24, 77
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for lstm in (False, True):
            stacked, vocab, x, state = _small(dtype, lstm, V=V)[0]
            no_library.clear()
            sized.clear()
            with pytest.raises(_Launched):
                fused_topk_step_cuda(stacked, vocab, x, state, 3)
            assert no_library == ([(B, E, H, V)] if bf16 else [(B, E, H, V, dtype), (B, E, H, 132, 0, dtype)])
            assert sized == [2]
        with pytest.raises(ValueError, match="k=%d" % (MAX_K + 1)):
            fused_topk_step_cuda(*_small(dtype, False, V=V)[0], MAX_K + 1)
    f32_tiles = vocab_tiles(H, V, 132, torch.float32).tiles
    max_splits, part_keys, part_ms = topk_launch_args("project_topk", 3, V, 3, torch.device("cpu"), f32_tiles)[:3]
    assert max_splits == f32_tiles == -(-V // 16) and part_keys.shape[0] == part_ms.shape[0] == f32_tiles
