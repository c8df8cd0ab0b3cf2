"""The f32 pooled beam steps in split-precision TF32 (csrc/fused_step.cu's dense and top-k ends, tf32x3_step()), on the CPU.

The kernels run only on the card; what surrounds them runs here.  Their
arithmetic is re-enacted in numpy with test_torch_f32_tf32x3.py's
helpers: each f32 operand split into tf32 halves, each k8 step's three
products summed from zero and added in f32, the 16-column chunks split
over four warps and the warps' sums added in order, and the layers' K
split in parts s = 0 .. S - 1 (S from stack_tiles on an H100's 132 SMs,
the greedy step's S at the same rows).  Then the two beam ends on the
staged sums: the dense logits (sum + bias in f32, stored as they are), and
the top-k end (mma_topk_parts): for each 64-row vocabulary item, each
batch row's four threads scan 16 rows each into their K greatest packed
(logit, ~index) keys and their (max, sum of exp), combined by two xor
shuffles into the item's part; then merge_topk: lane l of a row's warp
folds parts l, l + 32, ... in item order into its (max, sum), the warp
takes the K greatest keys and lse = max + log of the lanes' butterfly sum.
The re-enactment is held to the port's twins (fused_dense_step_plain,
fused_topk_step_plain) and to the JAX package's fused_dense_step_pallas
and fused_topk_step_pallas in interpret mode at small widths, both cells,
and to the twins at one flagship-width step (R = 96 beam rows), where
one-pass TF32 misses the f32 bar.  Also the geometry of the beam rows' K
split and top-k parts, and the launch arguments the wrappers hand the C
entry points.
"""

import contextlib
import os
import re

import numpy as np
import pytest
import torch

from show_tell_tpu.ops.fused_beam_pallas import fused_dense_step_pallas, fused_topk_step_pallas
from show_tell_tpu.ops.vocab_pallas import VOCAB_BLOCK
from show_tell_tpu_torch.ops import build, fused_step
from show_tell_tpu_torch.ops.fused_beam import (
    fused_dense_step_cuda,
    fused_dense_step_plain,
    fused_topk_step_cuda,
    fused_topk_step_plain,
)
from show_tell_tpu_torch.ops.fused_step import MMA_VOCAB_ROWS, mma_tiles, stack_tiles
from show_tell_tpu_torch.ops.vocab import stable_topk
from test_torch_f32_tf32x3 import CSRC, SMS, STATE_TOL, _case, _excess, tf32x3_step_reenacted
from test_torch_vocab_tiles import key_indices, key_values, pack_keys
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

LOGIT_TOL = 1e-4  # dense logits and top-k logp, rtol = atol
GAP = 1e-4  # top-k ids agree where the k + 1 best logits are this far apart
RUN = 16  # vocabulary rows a thread of the top-k end scans (one m16 slot)
ROW_THREADS = 4  # threads of a batch row in an item (kRowThreads)
LANES = 32  # merge_topk: a warp a row
K = 3  # the beam width of the main paths


# ---------------------------------------------------------------- the top-k end


def topk_parts(logits, k):
    """mma_topk_parts on the staged sums + bias (the dense end's very
    values): for each 64-row item p and batch row, thread q's K greatest
    keys and (max, sum of exp(x - max)) over rows 64p + 16q .. + 15 (summed
    in increasing v), the item's K greatest keys, and the four threads'
    (max, sum) by the xor shuffles: the max of the maxima, (s0' + s1') +
    (s2' + s3') of the sums rescaled to it.  Returns part_keys [P, R, k]
    uint64 (0 = empty) and part_ms [P, R, 2] f32, P = ceil(V / 64)."""
    R, V = logits.shape
    P = -(-V // MMA_VOCAB_ROWS)
    part_keys = np.zeros((P, R, k), np.uint64)
    part_ms = np.zeros((P, R, 2), np.float32)
    for p in range(P):
        ms, ss, keys = [], [], []
        for q in range(ROW_THREADS):
            lo = p * MMA_VOCAB_ROWS + RUN * q
            x = logits[:, lo:min(lo + RUN, V)]
            if x.shape[1] == 0:  # a thread past V: no key, (-inf, 0)
                ms.append(np.full(R, -np.inf, np.float32))
                ss.append(np.zeros(R, np.float32))
                continue
            m = x.max(axis=1)
            s = np.zeros(R, np.float32)
            for i in range(x.shape[1]):
                s = (s + np.exp(x[:, i] - m)).astype(np.float32)
            ms.append(m)
            ss.append(s)
            keys.append(pack_keys(x, np.broadcast_to(np.arange(lo, lo + x.shape[1]), x.shape)))
        mx = np.maximum(np.maximum(ms[0], ms[1]), np.maximum(ms[2], ms[3]))
        with np.errstate(invalid="ignore"):
            r = [np.where(s > 0, s * np.exp(m - mx), np.float32(0)).astype(np.float32) for m, s in zip(ms, ss)]
        part_ms[p, :, 0] = mx
        part_ms[p, :, 1] = ((r[0] + r[1]).astype(np.float32) + (r[2] + r[3]).astype(np.float32)).astype(np.float32)
        best = np.sort(np.concatenate(keys, axis=1), axis=1)[:, ::-1][:, :k]
        part_keys[p, :, :best.shape[1]] = best
    return part_keys, part_ms


def merge_topk(part_keys, part_ms, k):
    """merge_topk after the grid barrier: lane l folds parts l, l + 32, ...
    in that order by lse_merge (an empty sum skipped), then the lanes' max
    and lse = max + log of the butterfly sum (xor 16, 8, 4, 2, 1) of each
    lane's sum rescaled to it, in f32; the K greatest keys of all parts.
    Returns (logp [R, k] f32, ids [R, k] int32)."""
    P, R, _ = part_keys.shape
    m = np.full((LANES, R), -np.inf, np.float32)
    s = np.zeros((LANES, R), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for p in range(P):
            lane, (m2, s2) = p % LANES, part_ms[p].T
            up = (s2 != 0) & (m2 > m[lane])
            keep = (s2 != 0) & ~up
            s[lane] = np.where(up, s[lane] * np.exp(m[lane] - m2) + s2,
                               np.where(keep, s[lane] + s2 * np.exp(m2 - m[lane]), s[lane])).astype(np.float32)
            m[lane] = np.where(up, m2, m[lane])
        mx = m.max(axis=0)
        v = np.where(s > 0, s * np.exp(m - mx), np.float32(0)).astype(np.float32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(LANES) ^ off]).astype(np.float32)
    lse = (mx + np.log(v[0])).astype(np.float32)
    best = np.sort(part_keys.transpose(1, 0, 2).reshape(R, -1), axis=1)[:, ::-1][:, :k]
    return (key_values(best) - lse[:, None]).astype(np.float32), key_indices(best)


def beam_step_reenacted(cell, stacked, vocab, x, state, k=None, one_pass=False):
    """st_fused_*_dense_step (``k`` None: (logits [R, V], new state)) or
    st_fused_*_topk_step (((logp, ids) [R, k], new state)) in f32,
    re-enacted with the K split that stack_tiles gives on 132 SMs."""
    _, logits, state2 = tf32x3_step_reenacted(cell, stacked, vocab, x, state, one_pass)
    if k is None:
        return logits, state2
    return merge_topk(*topk_parts(logits, k), k), state2


def _clear(logits, k):
    """Rows whose k + 1 best logits are more than GAP apart."""
    best = np.sort(logits, axis=1)[:, ::-1][:, :k + 1]
    return (best[:, :-1] - best[:, 1:]).min(axis=1) > GAP


def _hold(cell, port, jax_args=None, k=K):
    """The re-enacted dense and top-k ends against the twins and, where
    ``jax_args`` is given, the interpreted Pallas steps: states within
    1e-5, logits and logp within 1e-4, ids equal where the k + 1 best
    logits are clear; the top-k ids the stable top-k of the re-enacted
    logits on every row, its logp within 1e-5 of their log_softmax.
    The two ends share the layers (the same code, the same K split), so
    the stack is re-enacted once.  Returns the re-enacted state and the
    twin's."""
    logits, state = beam_step_reenacted(cell, *port)
    logp, ids = merge_topk(*topk_parts(logits, k), k)
    ref_logp, ref_ids = stable_topk(torch.log_softmax(torch.from_numpy(logits), dim=-1), k)
    assert np.array_equal(ids, ref_ids.numpy())
    np.testing.assert_allclose(logp, ref_logp.numpy(), rtol=1e-5, atol=1e-5)
    ref_logits, ref_state = fused_dense_step_plain(*port)
    (t_logp, t_ids), t_state = fused_topk_step_plain(*port, k)
    assert _excess(state, ref_state) <= 0 and _excess(state, t_state) <= 0
    np.testing.assert_allclose(logits, ref_logits.numpy(), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(logp, t_logp.numpy(), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    clear = _clear(logits, k)
    assert clear.mean() > 0.6
    assert np.array_equal(ids[clear], t_ids.numpy()[clear])
    if jax_args is not None:
        stacked, vocab, x, jstate, block_v = jax_args
        j_logits, j_state = fused_dense_step_pallas(cell, stacked, vocab, x, jstate, logits.shape[1],
                                                    block_v=block_v, interpret=True)
        assert _excess(state, j_state) <= 0
        np.testing.assert_allclose(logits, np.asarray(j_logits), rtol=LOGIT_TOL, atol=LOGIT_TOL)
        (j_logp, j_ids), j_state = fused_topk_step_pallas(cell, stacked, vocab, x, jstate, k, block_v=block_v,
                                                          interpret=True)
        assert _excess(state, j_state) <= 0
        np.testing.assert_allclose(logp, np.asarray(j_logp), rtol=LOGIT_TOL, atol=LOGIT_TOL)
        assert np.array_equal(ids[clear], np.asarray(j_ids)[clear])
    return state, ref_state


# (R, E, H, V, L), E <= H (the JAX beam kernels pad x to H): ragged slabs (3, 19; 33 and 65 a slab pair and a part),
# H = 24 (the second h-side chunk half zeros), V not a multiple of the 64-row item (77: a ragged second item whose
# last thread scans nothing; 40 and 65: one item and one row past it); the layers' K split at S = 2 (5 rows, E = H =
# 64) and S = 2 then 3 (40 rows, E = 64, H = 96: runs of uneven length)
SMALL = [(3, 16, 24, 40, 2), (19, 24, 40, 77, 2), (33, 16, 16, 65, 1), (65, 16, 24, 77, 2), (5, 64, 64, 77, 2),
         (40, 64, 96, 77, 2)]


@pytest.mark.parametrize("R,E,H,V,L", SMALL)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_tf32x3_beam_ends_match_the_twins_and_pallas(cell, R, E, H, V, L):
    port, jax_args = _case(cell, R, E, H, V, L, 1200 + R + V)
    _hold(cell, port, jax_args, k=5 if R == 19 else K)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_flagship_beam_step_at_r96_and_one_pass_tf32_misses_the_bar(cell):
    """L=5, H=512, V=9,956, E=256 (GRU) or 512 (LSTM), R = 96 beam rows (B =
    32 at K = 3: S = 2 parts a layer item), weights at the decoder init's
    scale (U(+-1/sqrt(H)), as chip_smoke.py draws them): 3xTF32 holds the
    f32 beam bars against the twins; one-pass TF32 (big_a big_b alone, in
    the layers and the projection) on the same inputs leaves the 1e-5 band
    of the twin's states by more than ten times the band, and its logits
    leave the 1e-4 band of the twin's."""
    port, _ = _case(cell, 96, 256 if cell == "gru" else 512, 512, 9956, 5, 1300, bound=512 ** -0.5,
                    block_v=VOCAB_BLOCK)
    assert stack_tiles(96, port[2].shape[1], 512, SMS, dtype=torch.float32).splits == (2, 2)
    _, ref_state = _hold(cell, port)
    one_logits, one_pass = beam_step_reenacted(cell, *port, one_pass=True)
    assert _excess(one_pass, ref_state) > 10 * STATE_TOL
    ref_logits = fused_dense_step_plain(*port)[0].numpy()
    assert np.max(np.abs(one_logits - ref_logits) - LOGIT_TOL * (1 + np.abs(ref_logits))) > 0


# ---------------------------------------------------------------- the geometry and the launch arguments


def test_beam_rows_take_the_greedy_steps_split_and_one_part_per_item():
    """At the flagships on 132 SMs: S = 8 / 2 / 1 for every layer at R = 3 /
    96 / 192 beam rows (both cells: layer 0 is 256 or 512 wide), the
    greedy step's rule at the same rows; 156 top-k parts at V = 9,956, one
    per 64-row vocabulary item, each written by one item of each 32-row
    slab; the f32 items and chunks those of the greedy step."""
    for E in (256, 512):
        assert [stack_tiles(R, E, 512, SMS, dtype=torch.float32).splits for R in (3, 96, 192)] == [
            (8, 8), (2, 2), (1, 1)]
        assert stack_tiles(192, E, 512, SMS, dtype=torch.float32).parts == 0
    parts = -(-9956 // MMA_VOCAB_ROWS)
    assert parts == 156
    for R in (3, 96, 192):
        g = mma_tiles(R, 256, 512, 9956, dtype=torch.float32)
        assert g.vocab_items == -(-R // 32) * parts and g.gate_items == -(-R // 32) * 32
        assert (g.layer0_chunks, g.upper_chunks, g.vocab_chunks) == (48, 64, 32)


def _prototype(name):
    """The parameter names of C entry point ``name`` in fused_step.cu."""
    src = open(os.path.join(CSRC, "fused_step.cu")).read()
    params = re.search(r'extern "C" int %s\(([^)]*)\)' % name, src).group(1)
    return [p.split()[-1].lstrip("*") for p in params.split(",")]


@pytest.fixture
def fake_library(monkeypatch):
    """The wrappers run to their launch on CPU tensors, the library replaced
    by one that records each call's arguments by the C parameter names."""
    calls = []

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                names = _prototype(name)
                assert len(args) == len(names) == declared_arguments(name)
                calls.append((name, dict(zip(names, args))))
                return 0
            return entry

    monkeypatch.setattr(build, "load_library", lambda: Library())
    monkeypatch.setattr(fused_step, "sm_count", lambda device: SMS)
    monkeypatch.setattr(fused_step, "stream_arg", lambda device: None)
    monkeypatch.setattr(fused_step, "arrival_counters", lambda device, items: torch.zeros(items, dtype=torch.int32))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    return calls


def declared_arguments(name):
    """How many arguments build.load_library declares for ``name``: [i] + [p] * n + [i] * m + [p]."""
    n, m = re.search(r'"%s": \[i\] \+ \[p\] \* (\d+) \+ \[i\] \* (\d+) \+ \[p\],' % name,
                     open(build.__file__).read()).groups()
    return int(n) + int(m) + 2


@pytest.mark.parametrize("R", [3, 96, 192])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_f32_beam_wrappers_hand_the_kernel_its_split_and_parts(fake_library, cell, R):
    """fused_dense_step_cuda and fused_topk_step_cuda on f32 operands at the
    flagship widths: the C entry point gets (by its parameter names, as
    many arguments as build.py declares) the layers' K split of
    stack_tiles (s0, su, max_parts; partial and arrivals where S > 1, none
    at S = 1), and the top-k step max_splits = 156 with scratch for 156
    parts of [R, k]."""
    G, E = (4, 512) if cell == "lstm" else (3, 256)
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    stacked = {"w_ih0": z(G * 512, E), "w_ihU": z(4, G * 512, 512), "w_hh": z(5, G * 512, 512),
               "b_ih": z(5, G * 512), "b_hh": z(5, G * 512)}
    vocab = {"w": z(9956, 512), "b": z(9956)}
    state = (z(5, R, 512), z(5, R, 512)) if cell == "lstm" else z(5, R, 512)
    fused_dense_step_cuda(stacked, vocab, z(R, E), state)
    (logp, ids), _ = fused_topk_step_cuda(stacked, vocab, z(R, E), state, K)
    split = stack_tiles(R, E, 512, SMS, dtype=torch.float32)
    assert [name for name, _ in fake_library] == ["st_fused_%s_dense_step" % cell, "st_fused_%s_topk_step" % cell]
    for _, args in fake_library:
        assert args["dtype"] == 0 and (args["L"], args["B"], args["E"], args["H"], args["V"]) == (5, R, E, 512, 9956)
        assert (args["s0"], args["su"], args["max_parts"]) == (*split.splits, split.parts)
        assert (args["partial"] is None) == (split.parts == 0) and (args["arrivals"] is None) == (split.parts == 0)
    topk = fake_library[1][1]
    assert (topk["K"], topk["max_splits"]) == (K, 156) and logp.shape == ids.shape == (R, K)
    assert split.parts == (split.items * max(split.splits) if max(split.splits) > 1 else 0)
