"""The f32 projection kernels in split-precision TF32 (csrc/vocab_mma.cuh, TileShape<float>), on the CPU.

csrc/project_argmax.cu and csrc/project_topk.cu run their f32 instances on
the tensor cores: a block owns a V-tile of mv rows with its f32 weights in
shared memory, and each (m16 tile, n8 tile) of logits is one warp's sum
over all of K in its natural order, a k8 step at a time.  Each k8 step's
fragments come by ldmatrix.x4.b16 on the f32 rows (lane (g, t) takes float
t of row g: columns k .. k+3 and k+4 .. k+7 of the step), each f32 value
is split into big = tf32(a) and small = tf32(a - big), the step's three
mma.sync m16n8k8 (small_a big_b, big_a small_b, big_a big_b) are summed
from zero and added to the f32 accumulator, and the bias is added in f32.
The kernels run only on the card; here that arithmetic is re-enacted in
numpy (with tests/test_torch_f32_tf32x3.py's split and mma), then the two
ends: the first-max argmax, and one top-k part per V-tile merged as
tests/test_torch_vocab_tiles.py re-enacts it.  The re-enactment is held to
the port's twins (logits within 1e-5; tokens and ids equal on every row
whose top-2, or top-k+1, gap is over 1e-4) and to the JAX package's
project_argmax_pallas / project_topk_pallas in interpret mode, at small
widths (H = 24, V = 40 and 77, not multiples of the tile) and at one
flagship-width case (H = 512, V = 9,956, B = 32), where one-pass TF32
misses the bar.  Also the f32 geometry against the kernel header, and the
launch arguments the f32 wrappers hand the C entry points.
"""

import contextlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.ops.vocab_pallas import prepare_vocab as jax_prepare_vocab
from show_tell_tpu.ops.vocab_pallas import project_argmax_pallas, project_topk_pallas
from show_tell_tpu_torch.ops import build, vocab
from show_tell_tpu_torch.ops.vocab import (
    BATCH_GROUP,
    SMEM_LIMIT,
    TILE_ROWS_MAX,
    TILE_SHAPES,
    prepare_vocab,
    project_argmax,
    project_argmax_cuda,
    project_argmax_plain,
    project_logits,
    project_topk,
    project_topk_cuda,
    project_topk_plain,
    tile_smem,
    vocab_tiles,
)
from test_torch_f32_tf32x3 import CSRC, SMS, mma, split
from test_torch_vocab_tiles import BLOCK_V, merge_parts, tile_parts
from test_torch_vocab_tiles import _case as grid_case
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

F32 = torch.float32
TOL = 1e-5  # rtol = atol: the port's f32 bar on logits and log-probabilities
GAP = 1e-4  # tokens and ids agree on every row whose top-2 (top-k+1) logit gap exceeds it
STEP = 8  # K columns of an m16n8k8 step
HEADER = os.path.join(CSRC, "vocab_mma.cuh")
FLAGSHIP = (512, 9956, 32)  # H, V, B


# ---------------------------------------------------------------- the re-enactment


def tile_logits(w, b, top, one_pass=False):
    """The f32 tile kernel's staged logits [B, V]: w [V, H] and b [V] (the
    port's layout), top [B, H], H a multiple of 8.  For each k8 step in K
    order, the three tf32 products of the split operands (A the weights, B
    the batch rows) from a zero partial sum, added to the f32 accumulator;
    then + bias in f32.  one_pass: big_a big_b alone (one-pass TF32)."""
    H = w.shape[1]
    assert H % STEP == 0
    (wb, ws), (tb, ts) = split(w), split(top)
    acc = np.zeros((top.shape[0], w.shape[0]), np.float32)
    for k in range(0, H, STEP):
        c = slice(k, k + STEP)
        part = np.zeros_like(acc)  # the step's partial sum, from zero
        if not one_pass:
            part = mma(part, tb[:, c], ws[:, c].T)  # small_a big_b
            part = mma(part, ts[:, c], wb[:, c].T)  # big_a small_b
        part = mma(part, tb[:, c], wb[:, c].T)  # big_a big_b
        acc = (acc + part).astype(np.float32)  # an f32 add
    return (acc + b).astype(np.float32)


def tile_argmax(logits):
    """ArgmaxTileEnd and the atomicMax over packed keys: the first max of each row."""
    return np.argmax(logits, axis=1).astype(np.int32)


def tile_topk(logits, mv, k):
    """TopkTileEnd's one part per (V-tile, row), then merge_topk: (logp, ids)."""
    keys, ms = tile_parts(logits, mv, k)
    return merge_parts(keys, ms, k)


def _case(seed, B, H, V, bound=None):
    """The port's vocab (w [V, H], b [V]) and top [B, H]: weights uniform in +-1/sqrt(H) (chip_smoke.vocab_inputs'
    scale), top in +-1."""
    rng = np.random.RandomState(seed)
    bound = bound or 1.0 / np.sqrt(H)
    w = rng.uniform(-bound, bound, (V, H)).astype(np.float32)
    b = rng.uniform(-bound, bound, V).astype(np.float32)
    top = rng.uniform(-1, 1, (B, H)).astype(np.float32)
    return w, b, top


def _port(w, b):
    return prepare_vocab(torch.from_numpy(w), torch.from_numpy(b))


def _jax(w, b, block_v):
    return jax_prepare_vocab({"w": jnp.asarray(w.T), "b": jnp.asarray(b)}, block_v=block_v)


def _clear(logits, k=1):
    """Rows whose k + 1 best logits are each more than GAP apart."""
    best = np.sort(logits, axis=1)[:, ::-1][:, :k + 1]
    return (best[:, :-1] - best[:, 1:] > GAP).all(axis=1)


def _excess(got, ref):
    """The largest |got - ref| - TOL (1 + |ref|): <= 0 within the bar."""
    return float(np.max(np.abs(got - ref) - TOL * (1 + np.abs(ref))))


def _hold(w, b, top, k, block_v):
    """The re-enactment against the twins (logits, tokens, top-k) and the JAX
    Pallas kernels in interpret mode; returns the rows held."""
    vocab_t = _port(w, b)
    ref = project_logits(vocab_t, torch.from_numpy(top)).numpy()
    got = tile_logits(w, b, top)
    assert _excess(got, ref) <= 0
    tok = tile_argmax(got)
    clear = _clear(ref)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(tok[clear], project_argmax_plain(vocab_t, torch.from_numpy(top)).numpy()[clear])
    jvocab = _jax(w, b, block_v)
    j_tok = np.asarray(project_argmax_pallas(jvocab, jnp.asarray(top), block_v=block_v, interpret=True))
    np.testing.assert_array_equal(tok[clear], j_tok[clear])
    mv = vocab_tiles(w.shape[1], w.shape[0], SMS, F32).mv
    logp, ids = tile_topk(got, mv, k)
    clear_k = _clear(ref, k)
    ref_logp, ref_ids = project_topk_plain(vocab_t, torch.from_numpy(top), k)
    j_logp, j_ids = project_topk_pallas(jvocab, jnp.asarray(top), k, block_v=block_v, interpret=True)
    np.testing.assert_array_equal(ids[clear_k], ref_ids.numpy()[clear_k])
    np.testing.assert_array_equal(ids[clear_k], np.asarray(j_ids)[clear_k])
    assert _excess(logp, ref_logp.numpy()) <= 0 and _excess(logp, np.asarray(j_logp)) <= 0
    return int(clear.sum()), int(clear_k.sum())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("B", [1, 19, 70])
@pytest.mark.parametrize("V", [40, 77])
def test_f32_tiles_match_plain_and_pallas_at_small_widths(V, B, seed):
    """H = 24 (three k8 steps), V = 40 and 77 (not multiples of the 16-row tile), B = 1, 19 and 70 (two groups)."""
    w, b, top = _case(seed, B, 24, V, bound=0.5)
    _hold(w, b, top, 3, BLOCK_V)


def test_f32_tiles_order_ties_lower_index_first():
    """Columns mv - 1 and mv (across the first f32 V-tile boundary) and V - 2,
    V - 1 (inside the last tile) tied and top: the argmax takes mv - 1, the
    top-4 lists mv - 1, mv, V - 2, V - 1.  The data lie on
    test_torch_vocab_tiles.py's 1/64 grid, so the twin's logits of equal
    columns are bit-equal too."""
    V = 77
    mv = vocab_tiles(24, V, 2, F32).mv
    linear, top = grid_case(5, V, ties=((mv - 1, mv), (V - 2, V - 1)))
    w, b = np.ascontiguousarray(linear["w"].T), linear["b"]
    logits = tile_logits(w, b, top)
    assert (logits[:, mv - 1] == logits[:, mv]).all() and (logits[:, V - 2] == logits[:, V - 1]).all()
    assert tile_argmax(logits).tolist() == [mv - 1] * len(top)
    assert tile_topk(logits, mv, 4)[1].tolist() == [[mv - 1, mv, V - 2, V - 1]] * len(top)
    vocab_t = _port(w, b)
    assert project_argmax(vocab_t, torch.from_numpy(top)).tolist() == [mv - 1] * len(top)  # CPU: the twin
    assert project_topk(vocab_t, torch.from_numpy(top), 4)[1].tolist() == [[mv - 1, mv, V - 2, V - 1]] * len(top)


def test_f32_tiles_match_plain_and_pallas_at_the_flagship_width():
    """H = 512, V = 9,956, B = 32: the 3xTF32 logits within 1e-5 of the twin,
    the tokens and top-3 ids equal to the twin's and the Pallas kernels' on
    every clear row, logp within 1e-5 of both; one-pass TF32 misses the bar."""
    H, V, B = FLAGSHIP
    w, b, top = _case(2, B, H, V)
    rows, rows_k = _hold(w, b, top, 3, 512)
    assert rows >= B - 2 and rows_k >= B - 4
    ref = project_logits(_port(w, b), torch.from_numpy(top)).numpy()
    one_pass = tile_logits(w, b, top, one_pass=True)
    assert _excess(one_pass, ref) > 0  # outside the f32 bar
    assert np.max(np.abs(one_pass - ref)) > 10 * np.max(np.abs(tile_logits(w, b, top) - ref))


def test_integer_split_is_the_rounding_of_cvt_rna():
    """tf32_split_bits' rounding, + 0x1000 on the bits and the low 13 bits
    cleared, is round to nearest with ties away from zero on the magnitude
    (cvt.rna's), also at a carry into the exponent, at +-0, subnormals,
    the largest finite value (to infinity) and infinities."""
    u = np.array([0x3F800FFF, 0x3F801000, 0xBF801000, 0x3F802FFF, 0x3FFFF000, 0x00000000, 0x80000000, 0x00001000,
                  0x00000FFF, 0x7F7FFFFF, 0x7F800000, 0xFF800000], np.uint32)
    want = np.array([0x3F800000, 0x3F802000, 0xBF802000, 0x3F802000, 0x40000000, 0x00000000, 0x80000000, 0x00002000,
                     0x00000000, 0x7F800000, 0x7F800000, 0xFF800000], np.uint32)
    big = (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    np.testing.assert_array_equal(big, want)
    finite = np.isfinite(u.view(np.float32))
    np.testing.assert_array_equal(split(u.view(np.float32)[finite])[0].view(np.uint32), want[finite])


# ---------------------------------------------------------------- the geometry


def _shape(src, elem):
    """TileShape<elem>'s constants in the kernel header: (align, pad, chunk, stages, ring pitch)."""
    body = re.search(r"template <> struct TileShape<%s> \{\s*static constexpr int ([^;]*);" % re.escape(elem), src)
    vals = dict(item.split(" = ") for item in body.group(1).split(", "))
    return tuple(int(vals[n]) for n in ("kAlign", "kPad", "kChunk", "kStages", "kRingPitch"))


def test_f32_shared_memory_formula_matches_the_kernel_header():
    """The header's TileShape<float> (K to a multiple of 8, + 4 floats a
    weight row, 4 ring stages of 32 floats at a pitch of 36) and bf16's are
    ops/vocab.py's TILE_SHAPES; the f32 block's bytes are 4 (mv (kp + 4) +
    4 x 64 x 36) + 4 x 64 (mv + 4); each row pitch is an odd number of
    16-byte units (ldmatrix's eight rows on distinct banks)."""
    src = open(HEADER).read()
    const = lambda name: int(re.search(r"constexpr (?:int|size_t) %s = (\d+);" % name, src).group(1))
    assert (const("kGroup"), const("kTileRowsMax"), const("kSmemLimit")) == (BATCH_GROUP, TILE_ROWS_MAX, SMEM_LIMIT)
    for elem, dtype, size in (("float", F32, 4), ("__nv_bfloat16", torch.bfloat16, 2)):
        align, pad, chunk, stages, ring_pitch = _shape(src, elem)
        assert TILE_SHAPES[dtype] == (size, align, pad, chunk, stages, ring_pitch)
        assert ring_pitch * size == 144 and chunk * size // 16 == 8  # nine units a ring row, 8 pieces a chunk
        for mv, H in [(16, 8), (80, 512), (128, 24), (32, 1024), (16, 2968)]:
            kp = -(-H // align) * align
            assert (kp + pad) * size // 16 % 2 == 1
            assert tile_smem(mv, H, dtype) == (size * (mv * (kp + pad) + stages * BATCH_GROUP * ring_pitch)
                                               + 4 * BATCH_GROUP * (mv + 4))
    assert "sizeof(T) * (static_cast<size_t>(mv) * tile_pitch<T>(H)" in src
    assert tile_smem(80, 512, F32) == 4 * (80 * 516 + 4 * 64 * 36) + 4 * 64 * 84 == 223488


def test_f32_flagship_geometry_is_one_wave():
    """H = 512, V = 9,956 on 132 SMs: 80-row tiles, 125 of them (one block an
    SM, one wave), 223,488 bytes of shared memory, within the 232,448 a block
    may use; a 96-row tile would not fit."""
    g = vocab_tiles(512, 9956, 132, F32)
    assert g == (80, 125, 223488) and g.smem <= SMEM_LIMIT and g.tiles <= 132
    assert tile_smem(96, 512, F32) > SMEM_LIMIT


def test_kernel_source_runs_3xtf32_and_no_simt_projection():
    """The f32 instance's k8 step (tf32x3_steps): every fragment by
    ldmatrix first (4-float, 16-byte halves), the split by integer rounding
    (the test's tf32: + 0x1000, the low 13 bits cleared), each (m16, n8)
    pair's partial sum in three rounds of mma over the pairs, small_a big_b
    from zero, big_a small_b, big_a big_b, then an f32 add; the SIMT f32
    projection and its sinks are gone, and the C entry points take mv in
    both dtypes."""
    src = open(HEADER).read()
    steps = src[src.index("__device__ __forceinline__ void tf32x3_steps("):src.index("// tf32x3_steps at the warp's")]
    order = ["ldmatrix_x4_at(b[s], b_at + 32 * s);", "ldmatrix_x4_at(a[s][i], a_at + i * a_step + 32 * s);",
             "tf32_split_bits(b[s][j], bb[j], bs[j]);", "tf32_split_bits(a[s][i][j], ab[i][j], as[i][j]);",
             "mma_tf32_1688_zero(d[i][nt], as[i], bb[2 * nt], bb[2 * nt + 1]);",
             "mma_tf32_1688(d[i][nt], ab[i], bs[2 * nt], bs[2 * nt + 1]);",
             "mma_tf32_1688(d[i][nt], ab[i], bb[2 * nt], bb[2 * nt + 1]);", "acc[nt][i][e] += d[i][nt][e];"]
    assert [steps.index(line) for line in order] == sorted(steps.index(line) for line in order)
    assert "big = (v + 0x1000u) & 0xffffe000u;" in src
    assert ("small = (__float_as_uint(__uint_as_float(v) - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;"
            in src)
    zero = src[src.index("void mma_tf32_1688_zero("):src.index("// The f32 tile's products")]
    assert '"{%10, %11, %12, %13};' in zero and '"f"(z), "f"(z), "f"(z), "f"(z)' in zero
    assert "const float z = 0.0f;" in zero
    assert "constexpr int kVec = 16 / static_cast<int>(sizeof(T));" in src
    assert "(lm & 1) * kVec" in src and "(lm >> 1) * kVec" in src
    common = open(os.path.join(CSRC, "decode_common.cuh")).read()
    for gone in ("project_items", "ArgmaxSink", "TopkSink", "topk_phase", "project_argmax("):
        assert gone not in common
    for name in ("project_argmax.cu", "project_topk.cu"):
        cu = open(os.path.join(CSRC, name)).read()
        assert "launch<float>(p, mv, s)" in cu and "mv == 0" not in cu and "launch_cooperative" not in cu


# ---------------------------------------------------------------- the launch arguments


def _prototype(source, name):
    """The parameter names of C entry point ``name`` in ``source``."""
    params = re.search(r'extern "C" int %s\(([^)]*)\)' % name, open(os.path.join(CSRC, source)).read()).group(1)
    return [p.split()[-1].lstrip("*") for p in params.split(",")]


def _declared(name):
    """How many arguments build.load_library declares for ``name``: [i] + [p] * n + [i] * m + [p]."""
    n, m = re.search(r'"%s": \[i\] \+ \[p\] \* (\d+) \+ \[i\] \* (\d+) \+ \[p\],' % name,
                     open(build.__file__).read()).groups()
    return int(n) + int(m) + 2


@pytest.fixture
def fake_library(monkeypatch):
    """The wrappers run to their launch on CPU tensors, the library replaced
    by one that records each call's arguments by the C parameter names, on
    an H100's 132 SMs."""
    calls = []
    sources = {"st_project_argmax": "project_argmax.cu", "st_project_topk": "project_topk.cu"}

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                names = _prototype(sources[name], name)
                assert len(args) == len(names) == _declared(name)
                calls.append((name, dict(zip(names, args))))
                return 0
            return entry

    class Props:
        multi_processor_count = SMS

    monkeypatch.setattr(build, "load_library", lambda: Library())
    monkeypatch.setattr(vocab, "stream_arg", lambda device: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    return calls


@pytest.mark.parametrize("rows", [1, 32, 64, 96, 192])
def test_f32_wrappers_hand_the_kernel_its_tiles_and_parts(fake_library, monkeypatch, rows):
    """project_argmax_cuda and project_topk_cuda on f32 operands at the
    flagship widths: the C entry points get dtype 0 and mv = 80 (by their
    parameter names, as many arguments as build.py declares), and the top-k
    one max_splits = 125 with scratch for 125 parts of [rows, k]."""
    H, V = 512, 9956
    sized, real = [], vocab.topk_launch_args
    monkeypatch.setattr(vocab, "topk_launch_args", lambda *a: sized.append(real(*a)) or sized[-1])
    z = lambda *s: torch.zeros(s, dtype=F32)
    vocab_t, top = {"w": z(V, H), "b": z(V)}, z(rows, H)
    project_argmax_cuda(vocab_t, top)
    logp, ids = project_topk_cuda(vocab_t, top, 3)
    assert [name for name, _ in fake_library] == ["st_project_argmax", "st_project_topk"]
    for _, args in fake_library:
        assert args["dtype"] == 0 and args["mv"] == 80 and (args["B"], args["H"], args["V"]) == (rows, H, V)
    topk = fake_library[1][1]
    assert (topk["K"], topk["max_splits"]) == (3, 125) and logp.shape == ids.shape == (rows, 3)
    assert [(n, tuple(keys.shape), tuple(ms.shape)) for n, keys, ms, _, _ in sized] == [
        (125, (125, rows, 3), (125, rows, 2))]
