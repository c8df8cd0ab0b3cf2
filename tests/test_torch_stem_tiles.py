"""The bf16 fused stem's implicit GEMM on the tensor cores (csrc/stem.cu, stem_mma_kernel), on the CPU.

The kernel runs only on the card; here its plan is re-enacted in numpy,
in f32, address by address: each CTA's band of s2d input rows loaded
into shared memory as the kernel's 32-bit loads and stores place them
([row][column -2 .. 113][12], every element written once), the weights
at their padded pitch, the A fragments of the m16n8k16 products read
from the addresses the kernel computes (row m of an m16 tile is column
2 (m % 8) + m / 8), the B fragments as ldmatrix.x4.trans hands them to
the lanes, the products summed k16 step by k16 step, the class table tc
added by row and column class, relu, and the rows and columns pooled as
the kernel pools them (the open row, the pair that closes a pooled row,
the column pool over the staged row).  The re-enactment is held to the
plain twin (``stem_fused_plain``) and to the JAX package's
stem_fused_pallas in interpret mode, within 1e-5, at B = 1 and 2, both
layouts, pool on and off; the class table tc to prepare_stem's map t
(bit for bit), and the grid geometry to the kernel's constants.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.ops.stem_pallas import prepare_stem as jax_prepare_stem
from show_tell_tpu.ops.stem_pallas import stem_fused_pallas
from show_tell_tpu_torch.ops import stem
from show_tell_tpu_torch.ops.s2d_stem import space_to_depth
from show_tell_tpu_torch.ops.stem import CLASS_REPS, prepare_stem, stem_fused_plain

SOURCE = os.path.join(os.path.dirname(stem.__file__), "..", "csrc", "stem.cu")
LANES = np.arange(32)
G_OF, T_OF = LANES >> 2, LANES & 3  # lane = 4g + t


def kernel_constants():
    """The `constexpr int` constants of csrc/stem.cu, evaluated in order."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;,]+);", open(SOURCE).read(), re.MULTILINE):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


K = kernel_constants()
S, KK, C, TAPS = K["kS"], K["kK"], K["kC"], K["kTaps"]
WARPS, THREADS = K["kMmaWarps"], K["kMmaThreads"]
BAND_POOLED, BAND_CONV, BANDS, IN_ROWS = K["kBandPooled"], K["kBandConv"], K["kMmaBands"], K["kInRows"]
ROW_PITCH, W_PITCH, STAGE_PITCH, CLASSES = K["kRowPitch"], K["kWPitch"], K["kStagePitch"], K["kClasses"]


def pos_class(p):
    return np.where(p < 2, p, np.where(p == S - 1, 3, 2))


# ---------------------------------------------------------------- geometry


def test_constants_and_geometry():
    """Seven warps of 16 columns cover a conv row; 28 CTAs an image, pool
    or not (the SIMT kernel: 8); a pooled band's conv rows 2r0-1 .. 2r0+3
    read s2d rows 2r0-3 .. 2r0+4, the kernel's 8 input rows; the band's
    loads divide evenly over the threads; the shared memory, 86,272 bytes,
    lets two CTAs share an SM."""
    assert (S, KK, C, TAPS) == (112, 12, 64, 192)
    assert WARPS * 16 == S and THREADS == 32 * WARPS == 224
    assert BANDS == S // 2 // BAND_POOLED == S // BAND_CONV == 28 and BANDS > K["kBands"] == 8
    assert IN_ROWS == 2 * BAND_POOLED + 4 == 8
    assert (ROW_PITCH, W_PITCH, STAGE_PITCH) == ((S + 4) * KK, C + 8, C + 8)
    assert IN_ROWS * S * KK // 4 == 12 * THREADS
    smem = 2 * (IN_ROWS * ROW_PITCH + TAPS * W_PITCH + 2 * S * STAGE_PITCH) + 4 * CLASSES * CLASSES * C
    assert smem == 86272 and "// 86,272" in open(SOURCE).read()
    assert 2 * (smem + 1024) <= 232448  # two CTAs an SM (1 KB a block reserved)
    # ldmatrix needs 16-byte rows; an odd number of 16-byte units a row keeps its eight rows on distinct banks
    assert (2 * W_PITCH) % 16 == 0 and (2 * W_PITCH // 16) % 2 == 1
    # every pooled row, and every conv row without the pool, in exactly one band
    pooled = [BAND_POOLED * bx + r for bx in range(BANDS) for r in range(BAND_POOLED)]
    conv = [BAND_CONV * bx + r for bx in range(BANDS) for r in range(BAND_CONV)]
    assert pooled == list(range(S // 2)) and conv == list(range(S))
    for bx in range(BANDS):
        p0 = 2 * BAND_POOLED * bx - 1
        rows = [p for p in range(p0, p0 + 2 * BAND_POOLED + 1) if p >= 0]
        assert min(rows) - 2 >= p0 - 2 and max(rows) + 1 <= p0 - 2 + IN_ROWS - 1
        assert set(range(2 * bx * BAND_POOLED - 1, 2 * (bx + 1) * BAND_POOLED)) & set(range(S)) == set(rows)


def test_a_loads_fall_on_distinct_banks():
    """Row m of an m16 tile is column 2 (m % 8) + m / 8: the 32 lanes' 32-bit
    A loads (word 6 column + t, from any even column) touch 32 distinct
    banks; rows g and g + 8 as columns g and g + 8 would share banks."""
    for q0 in range(0, S, 16):
        for half in (0, 1):
            words = 6 * (q0 + 2 * G_OF + half) + T_OF
            assert len(set(words % 32)) == 32
    assert len(set((6 * G_OF + T_OF) % 32)) < 32


# ---------------------------------------------------------------- the plan, address by address


def load_band(x_flat, rgb, b, i0):
    """load_band: s2d rows i0 .. i0 + 7 of image b as the kernel's stores place
    them, [IN_ROWS * ROW_PITCH] (NaN where nothing was written)."""
    xs = np.full(IN_ROWS * ROW_PITCH, np.nan, np.float32)
    row_words, pad = ROW_PITCH // 2, KK
    for e in range(IN_ROWS * 2 * pad):
        r, c = divmod(e, 2 * pad)
        w = r * row_words + (c if c < pad else row_words - 2 * pad + c)
        xs[2 * w : 2 * w + 2] = 0
    quads = S * KK // 4
    e = np.arange(THREADS)[:, None] + THREADS * np.arange(IN_ROWS * quads // THREADS)[None, :]  # thread, j
    r, q = e // quads, e % quads
    i = i0 + r
    inside = (i >= 0) & (i < S)
    if rgb:
        di, u = q // (quads // 2), q % (quads // 2)
        src = (b * 2 * S + 2 * i + di) * 2 * S * 3 + 4 * u
    else:
        src = (b * S + i) * S * KK + 4 * q
    v = np.where(inside[..., None], x_flat[np.where(inside, src, 0)[..., None] + np.arange(4)], 0).astype(np.float32)
    base = 2 * (r * row_words + pad)  # element of column 0
    if rgb:
        for h in (0, 1):
            e2 = 4 * u + 2 * h
            at = base + 2 * (((e2 // 6) * KK + di * 6 + e2 % 6) // 2)
            xs[at] = v[..., 2 * h]
            xs[at + 1] = v[..., 2 * h + 1]
    else:
        for k in range(4):
            xs[base + 4 * q + k] = v[..., k]
    assert not np.isnan(xs).any()  # every element of the band written
    return xs


def b_tiles(w):
    """The weights at their shared-memory pitch, and each k16 step's B [16 k, 64 n]
    as ldmatrix.x4.trans hands it to the lanes: lane l gives row l % 8 of matrix
    l / 8, and lane (g, t) gets M_j[2t + i][g] in register j, which is b0 (j even)
    or b1 (j odd) of n8 tile 2 np + j / 2."""
    ws = np.zeros(TAPS * W_PITCH, np.float32)
    ws.reshape(TAPS, W_PITCH)[:, :C] = w
    wl = (((LANES >> 3) & 1) * 8 + (LANES & 7)) * W_PITCH + (LANES >> 4) * 8
    tiles = []
    for ks in range(TAPS // 16):
        tile = np.full((16, C), np.nan, np.float32)
        for np_ in range(4):
            at = wl + 16 * ks * W_PITCH + 16 * np_
            for j in range(4):
                mat = ws[at[8 * j : 8 * j + 8, None] + np.arange(8)]  # rows from lanes 8j .. 8j + 7
                n0, k0 = 16 * np_ + 8 * (j >> 1), 8 * (j & 1)
                for i in (0, 1):
                    tile[k0 + 2 * T_OF + i, n0 + G_OF] = mat[2 * T_OF + i, G_OF]
        assert not np.isnan(tile).any()
        tiles.append(tile)
    return tiles


def a_addresses(row, ks):
    """[warp, m, k] shared-memory elements of the A tile of k16 step ks at smem
    input row `row` (p + j + a - 2 - i0 for conv row p + j): the lanes' 32-bit
    loads, registers (row g | g + 8, k 2t | 2t + 8), two elements each."""
    a, s = divmod(ks, 3)
    at = np.full((WARPS, 16, 16), -1, np.int64)
    for w in range(WARPS):
        xr = (row + a) * ROW_PITCH + (16 * w + 2 * G_OF) * KK + 2 * T_OF + 16 * s
        for dm, dk, off in ((0, 0, 0), (8, 0, KK), (0, 8, 8), (8, 8, KK + 8)):
            for i in (0, 1):
                at[w, G_OF + dm, 2 * T_OF + dk + i] = xr + off + i
    assert (at >= 0).all()
    return at


def conv_rows(xs, tiles, row, rows):
    """conv_rows<rows> for every band at once: [rows, band, warp, m, 64] f32
    sums, k16 step by k16 step; smem input row `row` is conv row p's tap row 0."""
    out = []
    for j in range(rows):
        acc = np.zeros(xs.shape[:1] + (WARPS, 16, C), np.float32)
        for ks in range(TAPS // 16):
            acc += xs[:, a_addresses(row + j, ks)] @ tiles[ks]
        out.append(acc)
    return out


def columns_of(acc):
    """[band, warp, m, 64] -> [band, 112 columns, 64]: row m of warp w's tile is column 16 w + 2 (m % 8) + m // 8."""
    m = np.arange(16)
    cols = (16 * np.arange(WARPS)[:, None] + 2 * (m % 8) + m // 8).reshape(-1)
    out = np.zeros((acc.shape[0], S, C), np.float32)
    out[:, cols] = acc.reshape(acc.shape[0], -1, C)
    return out


def stem_plan(images_u8, w, tc, pool):
    """stem_mma_kernel re-enacted in f32 over the grid (28 bands x B images):
    the output, and how many times each element was written."""
    x = images_u8.numpy()
    rgb = x.shape[-1] == 3
    B = x.shape[0]
    tiles = b_tiles(w)
    side = S // 2 if pool else S
    out = np.zeros((B, side, side, C), np.float32)
    writes = np.zeros(out.shape[:3], np.int64)
    cls = pos_class(np.arange(S))
    bands = np.arange(BANDS)
    p0 = 2 * BAND_POOLED * bands - 1 if pool else BAND_CONV * bands  # each band's first conv row
    for b in range(B):
        xs = np.stack([load_band(x.reshape(-1), rgb, b, p - 2) for p in p0])

        def conv(dp, rows):  # conv rows p0 + dp .. (smem row dp + j for conv row p0 + dp + j): + tc, relu
            res = []
            for j, acc in enumerate(conv_rows(xs, tiles, dp, rows)):
                p = p0 + dp + j
                res.append(np.maximum(columns_of(acc) + tc[pos_class(np.maximum(p, 0))][:, cls], 0))
            return res

        if not pool:
            for dp in range(0, BAND_CONV, 2):
                for j, rows in enumerate(conv(dp, 2)):
                    out[b, p0 + dp + j] = rows
                    writes[b, p0 + dp + j] += 1
            continue
        open_row = conv(0, 1)[0]
        open_row[p0 < 0] = 0  # band 0 has no row -1: relu makes 0 the max's identity
        for r in range(BAND_POOLED):
            r0, r1 = conv(1 + 2 * r, 2)
            staged = np.maximum(np.maximum(r0, r1), open_row)
            m = np.maximum(staged[:, 0::2], staged[:, 1::2])  # columns 2s, 2s + 1
            m[:, 1:] = np.maximum(m[:, 1:], staged[:, 1:-1:2])  # column 2s - 1
            pr = BAND_POOLED * bands + r
            out[b, pr] = m
            writes[b, pr] += 1
            open_row = r1
    return out, writes


@pytest.fixture(scope="module")
def case():
    """Seeded conv1 and bn1 (BN off the identity), the port's and JAX's
    operands, two RGB images, and JAX's interpreted stem of them, pooled
    and not."""
    rng = np.random.RandomState(11)
    w7 = (rng.randn(64, 3, 7, 7) * 0.05).astype(np.float32)
    bn = {k: rng.uniform(lo, lo + 1.0, 64).astype(np.float32)
          for k, lo in (("weight", 0.5), ("bias", -0.2), ("running_mean", -0.2), ("running_var", 0.5))}
    t = torch.from_numpy
    resnet = type("R", (), {})()
    resnet.conv1 = type("Conv", (), {"weight": t(w7)})()
    resnet.bn1 = type("BN", (), {k: t(v) for k, v in bn.items()})()
    prepared = prepare_stem(resnet, torch.float32)
    jprep = jax_prepare_stem({"conv1.weight": jnp.asarray(w7.transpose(2, 3, 1, 0)), "bn1.weight": bn["weight"],
                              "bn1.bias": bn["bias"]},
                             {"bn1.running_mean": bn["running_mean"], "bn1.running_var": bn["running_var"]},
                             dtype=jnp.float32)
    rgb = rng.randint(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    jax_out = {pool: np.asarray(stem_fused_pallas(jnp.asarray(rgb), jprep, pool=pool, interpret=True))
               for pool in (True, False)}
    return prepared, rgb, jax_out


def test_class_table_reproduces_t(case):
    """tc [4, 4, 64] is t at rows and columns 0, 1, 2, 111, and expanding it by
    each row's and column's class gives prepare_stem's t bit for bit."""
    prepared, _, _ = case
    t, tc = prepared["t"].numpy(), prepared["tc"].numpy()
    assert CLASS_REPS == (0, 1, 2, S - 1) and tc.shape == (CLASSES, CLASSES, C) and tc.dtype == np.float32
    cls = pos_class(np.arange(S))
    np.testing.assert_array_equal(tc[cls][:, cls], t)
    # the four classes differ: the border carries less of the normalize shift than the interior
    assert all(np.abs(tc[i, 2] - tc[2, 2]).max() > 1e-3 for i in (0, 1, 3))


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "no_pool"])
@pytest.mark.parametrize("layout", ["s2d", "rgb"])
@pytest.mark.parametrize("B", [1, 2])
def test_plan_matches_plain_and_pallas(case, B, layout, pool):
    """The re-enacted plan writes every output once and is within 1e-5 of
    the plain twin and of the interpreted Pallas stem, f32."""
    prepared, rgb, jax_out = case
    x = torch.from_numpy(rgb[:B])
    if layout == "s2d":
        x = space_to_depth(x).contiguous()
    got, writes = stem_plan(x, prepared["w"].numpy(), prepared["tc"].numpy(), pool)
    assert (writes == 1).all()
    ref = stem_fused_plain(x, prepared, pool).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jax_out[pool][:B], rtol=1e-5, atol=1e-5)
