"""The fused stem's implicit GEMMs on the tensor cores (csrc/stem.cu: stem_mma_kernel, stem_tf32_kernel), on the CPU.

The kernels run only on the card; here their plans are re-enacted in numpy,
in f32, address by address.  bf16: each CTA's band of s2d input rows loaded
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

f32, the same way: the band as f32 (16- and 8-byte stores), each CTA's
half of the channels split into TF32 halves by cvt.rna's integer rounding
and stored channel-major, the A and B fragments as ldmatrix.x4 hands them
to the lanes (each matrix's 32 words on 32 distinct banks), two products
a k8 step (x lo, then x hi) into the f32 sums, tc, relu, and the pool in
registers: rows as maxima over the band's five conv rows, columns across
lanes by the kernel's shuffles and across warps through its exchange row.
Held to the same bars; also the split itself over all 256 pixel values,
the header's f32 constants and shared memory, and the source: the f32
instance is a tf32 mma.sync and no SIMT stem remains.
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
from show_tell_tpu_torch.ops.stem import CLASS_REPS, prepare_stem, stem_fused_f64, stem_fused_plain
from test_torch_f32_tf32x3 import split

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
HALVES, TF_C, TF_NTS = K["kTfHalves"], K["kTfC"], K["kTfNts"]
TF_W_PITCH, TF_POOL_ROWS = K["kTfWPitch"], K["kTfPoolRows"]
SMEM_LIMIT_SM = 233472  # an H100 SM's shared memory for its blocks (228 KB); 1 KB of it reserved a block


def pos_class(p):
    return np.where(p < 2, p, np.where(p == S - 1, 3, 2))


# ---------------------------------------------------------------- geometry


def test_constants_and_geometry():
    """Seven warps of 16 columns cover a conv row; 28 CTAs an image, pool
    or not; a pooled band's conv rows 2r0-1 .. 2r0+3
    read s2d rows 2r0-3 .. 2r0+4, the kernel's 8 input rows; the band's
    loads divide evenly over the threads; the shared memory, 86,272 bytes,
    lets two CTAs share an SM."""
    assert (S, KK, C, TAPS) == (112, 12, 64, 192)
    assert WARPS * 16 == S and THREADS == 32 * WARPS == 224
    assert BANDS == S // 2 // BAND_POOLED == S // BAND_CONV == 28
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


def load_band(x_flat, rgb, b, i0, f32=False):
    """load_band (f32: load_band_f32): s2d rows i0 .. i0 + 7 of image b as the
    kernel's stores place them, [IN_ROWS * ROW_PITCH] (NaN where nothing was
    written).  Both kernels lay the band out alike, element for element; bf16
    stores two elements a 32-bit word, f32 four (s2d, 16 bytes) or two (RGB)
    at an address aligned to its width."""
    xs = np.full(IN_ROWS * ROW_PITCH, np.nan, np.float32)
    row_words, pad = ROW_PITCH // 2, KK
    if f32:  # 16-byte units: 6 of pad on each side of a row
        for e in range(IN_ROWS * 2 * (KK // 2)):
            r, c = divmod(e, KK)
            unit = r * ROW_PITCH // 4 + (c if c < KK // 2 else ROW_PITCH // 4 - KK + c)
            xs[4 * unit : 4 * unit + 4] = 0
    else:
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
            assert not (at % 2).any()  # a float2 (f32) or one word (bf16)
            xs[at] = v[..., 2 * h]
            xs[at + 1] = v[..., 2 * h + 1]
    else:
        assert not ((base + 4 * q) % (4 if f32 else 2)).any()  # a float4 (f32) or two words (bf16)
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


# ---------------------------------------------------------------- f32: stem_tf32_kernel, address by address


def ldmatrix_words(row_at):
    """ldmatrix.x4 on f32 rows: lane l gives the address (in floats) of row l % 8
    of matrix l / 8, and lane (g, t) receives float t of row g of matrix j in
    register j.  [..., 32 lanes] row addresses -> [..., 32 lanes, 4 registers]
    addresses of the floats each lane receives; asserts every row 16-byte
    aligned and each matrix's 32 words on 32 distinct banks."""
    row_at = np.asarray(row_at)
    assert not (row_at % 4).any()
    words = row_at[..., None] + np.arange(4)  # [..., lane, word]
    for j in range(4):
        banks = words[..., 8 * j : 8 * j + 8, :].reshape(words.shape[:-2] + (32,)) % 32
        assert (np.sort(banks, axis=-1) == np.arange(32)).all()
    return row_at[..., 8 * np.arange(4)[None, :] + G_OF[:, None]] + T_OF[:, None]


def f32_a_addresses(row, s):
    """[warp, m, k] shared-memory floats of the A tile of k8 step s of a tap row
    at smem input row `row` (tap row a of conv row p0 + j: row a + j), as
    ldmatrix.x4 hands them to the lanes: lane l addresses row (column) q0 + l % 16
    at k 4 (l / 16), and registers 0-3 are a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
    a3 (g + 8, t + 4).  Row m of the tile is column q0 + m."""
    lane_row = (16 * np.arange(WARPS)[:, None] + (LANES & 15)) * KK + (LANES >> 4) * 4 + row * ROW_PITCH + 8 * s
    regs = ldmatrix_words(lane_row)
    at = np.full((WARPS, 16, 8), -1, np.int64)
    for j, (dm, dk) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
        at[:, G_OF + dm, T_OF + dk] = regs[:, :, j]
    want = row * ROW_PITCH + (16 * np.arange(WARPS)[:, None, None] + np.arange(16)[:, None]) * KK + 8 * s + np.arange(8)
    np.testing.assert_array_equal(at, want)
    return at


def f32_weights(w, half):
    """load_weights_tf32: the CTA's half of w [192, 64], each value split into
    TF32 halves, stored channel-major as the kernel's threads store them: hi and
    lo [TF_C * TF_W_PITCH] (NaN in the pad); and how many of the warps' store
    instructions put two lanes on one bank."""
    wh = np.full(TF_C * TF_W_PITCH, np.nan, np.float32)
    wl = wh.copy()
    e = np.arange(TF_C // 4 * TAPS)
    c, k = e // TAPS, e % TAPS  # channels 4c .. 4c + 3 of the half, tap k
    src = k * C + half * TF_C + 4 * c
    assert not (src % 4).any()  # a float4 of w
    hi, lo = split(w.reshape(-1)[src[:, None] + np.arange(4)])
    at = (4 * c[:, None] + np.arange(4)) * TF_W_PITCH + k[:, None]
    wh[at], wl[at] = hi, lo
    iters = -(-len(e) // THREADS)
    lanes = np.arange(iters * THREADS).reshape(iters, WARPS, 32)  # the e of each (iteration, warp, lane)
    conflicted = 0
    for i in range(4):
        for ee in lanes.reshape(-1, 32):
            ee = ee[ee < len(e)]
            conflicted += len(set(at[ee, i] % 32)) < len(ee)
    return wh, wl, conflicted


def f32_b_tiles(wh, wl):
    """Each k8 step's B [8 k, 32 n] of lo and of hi as ldmatrix.x4 hands them to
    the lanes: lane l addresses channel row 8 (l / 16) + l % 8 at k + 4 ((l / 8) % 2),
    and register j is b0 (j even) or b1 (j odd) of n8 tile 2 np + j / 2 (lane
    (g, t): b0 = B[t][g], b1 = B[t + 4][g])."""
    b_off = ((LANES >> 4) * 8 + (LANES & 7)) * TF_W_PITCH + ((LANES >> 3) & 1) * 4
    tiles = []
    for ks in range(TAPS // 8):
        pair = []
        for ws in (wl, wh):
            tile = np.full((8, TF_C), np.nan, np.float32)
            for np_ in range(TF_NTS // 2):
                regs = ldmatrix_words(b_off + 16 * np_ * TF_W_PITCH + 8 * ks)
                for j in range(4):
                    tile[T_OF + 4 * (j & 1), 8 * (2 * np_ + j // 2) + G_OF] = ws[regs[:, j]]
            assert not np.isnan(tile).any()
            pair.append(tile)
        tiles.append(pair)
    return tiles


def stem_plan_f32(images_u8, w, tc, pool):
    """stem_tf32_kernel re-enacted in f32 over its grid (28 bands x 2 channel
    halves x B images): the output, and how many times each element was
    written."""
    x = images_u8.numpy()
    rgb = x.shape[-1] == 3
    B = x.shape[0]
    side = S // 2 if pool else S
    out = np.zeros((B, side, side, C), np.float32)
    writes = np.zeros(out.shape, np.int64)
    cls = pos_class(np.arange(S))
    bands = np.arange(BANDS)
    p0 = 2 * BAND_POOLED * bands - 1 if pool else BAND_CONV * bands
    rows = TF_POOL_ROWS if pool else BAND_CONV
    a_at = {(row, s): f32_a_addresses(row, s) for row in range(rows + 3) for s in range(6)}
    up, down = (LANES + 28) & 31, (LANES + 4) & 31  # the shuffles' source lanes: g - 1 and g + 1
    for half in range(HALVES):
        wh, wl, _ = f32_weights(w, half)
        tiles = f32_b_tiles(wh, wl)
        split_w = split(w[:, half * TF_C : (half + 1) * TF_C])
        for ks in range(TAPS // 8):  # the fragments hold the split weights of k8 step ks, in K order
            for tile, part in zip(tiles[ks], split_w[::-1]):
                np.testing.assert_array_equal(tile, part[8 * ks : 8 * ks + 8])
        chans = half * TF_C + np.arange(TF_C)
        for b in range(B):
            xs = np.stack([load_band(x.reshape(-1), rgb, b, p - 2, f32=True) for p in p0])
            y = np.zeros((rows, BANDS, S, TF_C), np.float32)
            for j in range(rows):
                acc = np.zeros((BANDS, WARPS, 16, TF_C), np.float32)
                for ks in range(TAPS // 8):  # two products a k8 step into the f32 sums: x lo, then x hi
                    a_tile = xs[:, a_at[ks // 6 + j, ks % 6]]
                    for part in tiles[ks]:
                        acc = acc + a_tile @ part
                p = p0 + j
                y[j] = np.maximum(acc.reshape(BANDS, S, TF_C) + tc[pos_class(np.maximum(p, 0))][:, cls][..., chans], 0)
                y[j][p < 0] = 0  # band 0's row -1: relu's floor, the max's identity
            if not pool:
                for j in range(rows):
                    out[b, p0 + j, :, half * TF_C : (half + 1) * TF_C] = y[j]
                    writes[b, p0 + j, :, half * TF_C : (half + 1) * TF_C] += 1
                continue
            v = np.stack([np.maximum(np.maximum(y[2 * r], y[2 * r + 1]), y[2 * r + 2]) for r in range(2)])
            v = v.reshape(2, BANDS, WARPS, 16, TF_C)
            ch = 8 * np.arange(TF_NTS)[None, :, None] + 2 * T_OF[:, None, None] + np.arange(2)  # [lane, nt, c]
            h0 = v[:, :, :, G_OF[:, None, None], ch]  # lane (g, t)'s column q0 + g: [r, band, warp, lane, nt, c]
            h1 = v[:, :, :, G_OF[:, None, None] + 8, ch]  # and column q0 + g + 8
            xch = np.full((2, BANDS, WARPS, TF_C), np.nan, np.float32)
            for lane in np.flatnonzero(G_OF == 7):
                xch[:, :, :, ch[lane]] = h1[:, :, :, lane]
            prev = np.zeros_like(h0)
            prev[:, :, 1:] = xch[:, :, :-1][..., ch]  # lane (g, t) reads channels ch[lane] of the warp before
            g0 = (G_OF == 0)[:, None, None]
            left0 = np.where(g0, prev, h0[:, :, :, up])
            left1 = np.where(g0, h0[:, :, :, up], h1[:, :, :, up])
            cols = (np.maximum(np.maximum(left0, h0), h0[:, :, :, down]),
                    np.maximum(np.maximum(left1, h1), h1[:, :, :, down]))
            for lane in np.flatnonzero(G_OF % 2 == 0):
                for hh, vals in enumerate(cols):
                    for warp in range(WARPS):
                        s = 8 * warp + G_OF[lane] // 2 + 4 * hh
                        at = (b, (2 * bands[:, None] + np.arange(2))[:, :, None], s, half * TF_C + ch[lane].reshape(-1))
                        out[at] = vals[:, :, warp, lane].reshape(2, BANDS, -1).transpose(1, 0, 2)
                        writes[at] += 1
    return out, writes


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "no_pool"])
@pytest.mark.parametrize("layout", ["s2d", "rgb"])
@pytest.mark.parametrize("B", [1, 2])
def test_f32_plan_matches_plain_and_pallas(case, B, layout, pool):
    """The re-enacted f32 plan writes every output element once and is within
    1e-5 of the plain twin and of the interpreted Pallas stem, f32."""
    prepared, rgb, jax_out = case
    x = torch.from_numpy(rgb[:B])
    if layout == "s2d":
        x = space_to_depth(x).contiguous()
    got, writes = stem_plan_f32(x, prepared["w"].numpy(), prepared["tc"].numpy(), pool)
    assert (writes == 1).all()
    ref = stem_fused_plain(x, prepared, pool).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, jax_out[pool][:B], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "no_pool"])
@pytest.mark.parametrize("layout", ["s2d", "rgb"])
def test_f64_reference_matches_plain_and_pallas(case, layout, pool):
    """stem_fused_f64, the reference the card's checks measure the f32 kernel
    and the twin from, is the same function: within 1e-5 of the twin and of
    the interpreted Pallas stem at B=2, and f64 (not rounded to f32)."""
    prepared, rgb, jax_out = case
    x = torch.from_numpy(rgb)
    if layout == "s2d":
        x = space_to_depth(x).contiguous()
    exact = stem_fused_f64(x, prepared, pool)
    assert exact.dtype == torch.float64 and exact.shape == stem_fused_plain(x, prepared, pool).shape
    np.testing.assert_allclose(exact.numpy(), stem_fused_plain(x, prepared, pool).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(exact.numpy(), jax_out[pool], rtol=1e-5, atol=1e-5)


def test_split_products_of_every_pixel_value():
    """w = hi + lo by cvt.rna's integer rounding, over a spread of weights
    (magnitudes 2^-30 .. 2^4, both signs, ties of the first and of the second
    rounding): hi and lo are TF32 values (low 13 bits zero); for every pixel
    value x in 0..255, x hi and x lo are exact in f32; |w - hi - lo| <= 2^-22 |w|
    (lo's rounding), so x hi + x lo is the f32 product x w to within
    x |w - hi - lo| and half an f32 ulp."""
    rng = np.random.RandomState(3)
    spread = np.exp2(rng.uniform(-30, 4, 3000)) * rng.choice([-1.0, 1.0], 3000)
    ties = (rng.randint(0x30000000, 0x40000000, 200).astype(np.uint32) & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
    w = np.concatenate([spread.astype(np.float32), ties.view(np.float32), -ties.view(np.float32),
                        ties.view(np.float32) + np.float32(2.0**-11) * ties.view(np.float32), [0.0, -0.0]])
    w = w.astype(np.float32)
    hi, lo = split(w)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    x = np.arange(256, dtype=np.float64)[:, None]
    for part in (hi, lo):
        np.testing.assert_array_equal((x.astype(np.float32) * part).astype(np.float64), x * part.astype(np.float64))
    d = w.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64)
    assert (np.abs(d) <= 2.0**-22 * np.abs(w.astype(np.float64))).all()
    exact = x * hi.astype(np.float64) + x * lo.astype(np.float64)
    f32_product = (x.astype(np.float32) * w).astype(np.float64)
    assert (np.abs(exact - f32_product) <= x * np.abs(d) + 2.0**-24 * np.abs(x * w.astype(np.float64))).all()
    assert (lo != 0).mean() > 0.9  # lo carries most weights' last bits: one TF32 product would drop them


def test_f32_constants_and_shared_memory():
    """stem_tf32_kernel: two CTAs of 32 channels (four n8 tiles) a band, 56 an
    image, seven warps of one m16 tile; five conv rows a pooled band; a weight
    row of 196 floats, an odd number (49) of 16-byte units; shared memory of
    the band, hi and lo, tc and the exchange rows, 100,608 bytes as the
    header's formula and note say, so two CTAs share an SM and three do not;
    the header's widths are the wrapper's (ops/stem.py)."""
    text = open(SOURCE).read()
    assert (S, C, TAPS, CLASSES) == (stem.S2D_SIDE, stem.CHANNELS, stem.TAPS, len(CLASS_REPS))
    assert HALVES * TF_C == C and TF_NTS * 8 == TF_C and TF_POOL_ROWS == 2 * BAND_POOLED + 1 == 5
    assert TF_W_PITCH == TAPS + 4 and (4 * TF_W_PITCH) % 16 == 0 and (4 * TF_W_PITCH // 16) % 2 == 1
    assert K["kTfExchange"] == WARPS * 2 * TF_C
    smem = 4 * (IN_ROWS * ROW_PITCH + 2 * TF_C * TF_W_PITCH + CLASSES * CLASSES * C + WARPS * 2 * TF_C)
    assert smem == 4 * K["kTfSmemFloats"] == 100608 and "// 100,608" in text
    assert 2 * (smem + 1024) <= SMEM_LIMIT_SM < 3 * (smem + 1024)
    assert "stem_tf32_kernel<<<dim3(kMmaBands * kTfHalves, B), kMmaThreads, kTfSmemBytes, stream>>>" in text
    # a pooled band's five conv rows read smem input rows 0 .. 7, a band without the pool's four rows 0 .. 6
    assert TF_POOL_ROWS + 3 == IN_ROWS and BAND_CONV + 3 < IN_ROWS


def test_f32_fragments_and_weight_stores_fall_on_distinct_banks():
    """ldmatrix.x4 of A (row m = column q0 + m; a column is 48 bytes, 16-byte
    aligned) and of B (784-byte channel rows): each matrix's 32 words on 32
    distinct banks at every warp, input row and k8 step (ldmatrix_words
    asserts it), while the bf16 kernel's row order 2 (m % 8) + m / 8 would put
    two of a matrix's rows in one bank group.  The transposing weight stores:
    a warp's lanes take neighbouring taps, so only the stores of a warp whose
    taps wrap past 191 to the next channels put two lanes on one bank."""
    for row in range(IN_ROWS - 1):
        for s in range(6):
            f32_a_addresses(row, s)
    b_off = ((LANES >> 4) * 8 + (LANES & 7)) * TF_W_PITCH + ((LANES >> 3) & 1) * 4
    for np_ in range(TF_NTS // 2):
        for ks in range(TAPS // 8):
            ldmatrix_words(b_off + 16 * np_ * TF_W_PITCH + 8 * ks)
    m = np.arange(8)
    assert len(set((2 * m * KK * 4 // 16) % 8)) < 8 and len(set((m * KK * 4 // 16) % 8)) == 8
    n = TF_C // 4 * TAPS
    warps = [e[e < n] for e in np.arange(-(-n // THREADS) * THREADS).reshape(-1, 32)]  # each warp store's e
    wrapping = sum(1 for e in warps if len(set(e // TAPS)) > 1)
    _, _, conflicted = f32_weights(np.zeros((TAPS, C), np.float32), 0)
    assert conflicted <= 4 * wrapping and wrapping <= len(warps) // 4  # four stores (hi) a lane and iteration


def test_f32_instance_is_a_tf32_mma_and_no_simt_stem_remains():
    """st_stem sends float32 (dtype 0) to launch_tf32, which launches
    stem_tf32_kernel; its products are conv_rows_tf32's mma_tf32_1688 on
    ldmatrix fragments, the header's mma.sync.aligned.m16n8k8 with tf32
    operands, two a k8 step; the source's only kernels are the two
    tensor-core ones: no SIMT stem (no fmaf, no stem_simt_kernel) remains."""
    text = open(SOURCE).read()
    code = re.sub(r"//[^\n]*", "", text)
    assert re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s*(\w+)", code) == ["stem_mma_kernel",
                                                                                       "stem_tf32_kernel"]
    assert re.search(r"if \(dtype == 0\)\s*return static_cast<int>\(launch_tf32\(", code)
    conv = code[code.index("void conv_rows_tf32(") : code.index("void shift_relu_tf32(")]
    assert conv.count("mma_tf32_1688(") == 2 and conv.count("ldmatrix_x4_at(") == 3
    assert "fmaf" not in code and "simt" not in code.lower()
    header = open(os.path.join(os.path.dirname(SOURCE), "vocab_mma.cuh")).read()
    mma = header[header.index("void mma_tf32_1688(") :]
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in mma[: mma.index("}")]


def test_precision_tool_variant_edits_only_the_order_of_the_sums():
    """tools/stem_precision.py --variant fresh-sums edits the text of
    conv_rows_tf32's product loop, which the source holds once, into one
    partial sum from zero a k8 step (x lo, then x hi) added to the f32 sums:
    the same two products of the same fragments in another order."""
    import importlib.util

    path = os.path.join(os.path.dirname(SOURCE), "..", "..", "tools", "stem_precision.py")
    spec = importlib.util.spec_from_file_location("stem_precision", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    text = open(SOURCE).read()
    old, new = tool.VARIANTS["fresh-sums"]
    assert text.count(old) == 1
    edited = text.replace(old, new)
    conv = edited[edited.index("void conv_rows_tf32(") : edited.index("void shift_relu_tf32(")]
    assert conv.count("mma_tf32_1688_zero(d, af[j], bl[") == 1 and conv.count("mma_tf32_1688(d, af[j], bh[") == 1
    assert conv.count("ldmatrix_x4_at(") == 3 and "acc[j][2 * np + h][e] += d[e]" in conv
