"""The bf16 projection kernels' V-tiles (csrc/vocab_mma.cuh), on the CPU.

The kernels run only on the card; what surrounds them is Python that runs
here: the launch geometry (``vocab_tiles``: tile rows, tile count, shared
memory) and the top-k scratch it sizes.  Their arithmetic is re-enacted in
torch and numpy: each V-tile's top-K (value, index) keys, packed as the
kernels pack them, and its online logsumexp (m, s); then the merge of one
part per tile.  The re-enactment is held to the plain twins and to the JAX
package's Pallas kernels in interpret mode, with ties that straddle tiles.
f32, H=24; V=77 (not a multiple of the tile) and V=40.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.ops.vocab_pallas import prepare_vocab as jax_prepare_vocab
from show_tell_tpu.ops.vocab_pallas import project_argmax_pallas, project_topk_pallas
from show_tell_tpu_torch.ops.vocab import (
    BATCH_GROUP,
    K_CHUNK,
    MAX_K,
    RING_STAGES,
    SMEM_LIMIT,
    TILE_ROWS_MAX,
    prepare_vocab,
    project_argmax,
    project_argmax_plain,
    project_logits,
    project_topk,
    project_topk_plain,
    tile_smem,
    topk_launch_args,
    vocab_tiles,
)

H = 24
BLOCK_V = 16  # the JAX kernels' vocab block here


# (H, V, SMs): the flagship on an H100 SXM (132 SMs) and PCIe (114); the card tests' shapes; widths up to the largest
# that fits; a vocabulary too large for one wave of 128-row tiles.
GEOMETRIES = [(512, 9956, 132), (512, 9956, 114), (24, 40, 132), (24, 1001, 132), (128, 1001, 132),
              (512, 1001, 132), (1024, 9956, 132), (2048, 9956, 132), (5360, 9956, 132), (512, 30000, 132),
              (8, 1, 132), (16, 17, 1)]


@pytest.mark.parametrize("H_,V,sms", GEOMETRIES)
def test_tiles_cover_the_vocabulary_exactly(H_, V, sms):
    g = vocab_tiles(H_, V, sms)
    assert g.mv % 16 == 0 and 16 <= g.mv <= TILE_ROWS_MAX
    assert g.tiles == -(-V // g.mv)
    covered = np.zeros(V, np.int64)
    for t in range(g.tiles):
        lo, hi = t * g.mv, min(V, (t + 1) * g.mv)
        assert lo < hi  # no empty tile
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert g.smem == tile_smem(g.mv, H_) <= SMEM_LIMIT
    if g.mv < TILE_ROWS_MAX and tile_smem(g.mv + 16, H_) <= SMEM_LIMIT:
        assert g.tiles <= sms  # not capped: about one wave of one block an SM
        if g.mv > 16:
            assert -(-V // (g.mv - 16)) > sms  # and mv is the least that does it


def test_flagship_geometry():
    """V=9,956 at H=512 on 132 SMs: 80-row tiles, 125 of them, 156 KB a block."""
    assert vocab_tiles(512, 9956, 132) == (80, 125, 160000)


def test_shared_memory_layout_matches_the_kernel_formula():
    """Weights at a pitch of K rounded to 16, plus 8 bf16 (an odd number of
    16-byte units); the ring; the staged f32 logits at a pitch of mv + 4."""
    for mv, H_ in [(16, 8), (80, 512), (128, 24), (32, 2048)]:
        kp = -(-H_ // 16) * 16
        assert (kp + 8) * 2 // 16 % 2 == 1
        ring = RING_STAGES * BATCH_GROUP * (K_CHUNK + 8) * 2
        assert tile_smem(mv, H_) == mv * (kp + 8) * 2 + ring + BATCH_GROUP * (mv + 4) * 4


@pytest.mark.parametrize("H_", [5376, 8192])
def test_too_wide_h_raises_a_clear_error(H_):
    with pytest.raises(ValueError, match="H=%d is too wide.*shared memory" % H_):
        vocab_tiles(H_, 9956, 132)


def test_h_must_be_a_multiple_of_8():
    with pytest.raises(ValueError, match="multiple of 8"):
        vocab_tiles(20, 40, 132)


@pytest.mark.parametrize("B,V,k", [(1, 9956, 3), (19, 1001, 5), (192, 9956, 3), (320, 9956, 8), (3, 40, 1)])
def test_topk_scratch_holds_one_part_per_tile(B, V, k):
    g = vocab_tiles(512, V, 132)
    max_splits, part_keys, part_ms, logp, ids = topk_launch_args("project_topk", B, V, k, torch.device("cpu"),
                                                                 g.tiles)
    assert max_splits == g.tiles
    assert part_keys.shape == (g.tiles, B, k) and part_keys.dtype == torch.int64
    assert part_ms.shape == (g.tiles, B, 2) and part_ms.dtype == torch.float32
    assert logp.shape == ids.shape == (B, k) and logp.dtype == torch.float32 and ids.dtype == torch.int32


def test_topk_scratch_checks_k():
    with pytest.raises(ValueError, match="k=9"):
        topk_launch_args("project_topk", 4, 40, MAX_K + 1, torch.device("cpu"), 3)


# ---- the re-enactment --------------------------------------------------------------------------------------------


def pack_keys(values: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """decode_common.cuh's pack_key: ordered float bits over ~index, so a
    greater value is a greater key and, of equal values, the lower index."""
    u = (values.astype(np.float32) + np.float32(0.0)).view(np.uint32).astype(np.uint64)
    u = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - idx.astype(np.uint64))


def key_values(keys: np.ndarray) -> np.ndarray:
    u = (keys >> np.uint64(32)).astype(np.uint32)
    u = np.where(u & 0x80000000, u & 0x7FFFFFFF, ~u)
    return u.view(np.float32)


def key_indices(keys: np.ndarray) -> np.ndarray:
    return (np.uint64(0xFFFFFFFF) - (keys & np.uint64(0xFFFFFFFF))).astype(np.int32)


def tile_parts(logits: np.ndarray, mv: int, k: int):
    """Each V-tile's part of every row: its K greatest keys (0 = empty, where
    the tile has fewer than K columns) and its (m, s)."""
    B, V = logits.shape
    keys, ms = [], []
    for v0 in range(0, V, mv):
        blk = logits[:, v0:v0 + mv]
        kk = pack_keys(blk, np.broadcast_to(np.arange(v0, v0 + blk.shape[1]), blk.shape))
        top = np.sort(kk, axis=1)[:, ::-1][:, :k]
        if top.shape[1] < k:
            top = np.concatenate([top, np.zeros((B, k - top.shape[1]), np.uint64)], axis=1)
        m = blk.max(axis=1)
        keys.append(top)
        ms.append((m, np.exp(blk - m[:, None]).sum(axis=1)))
    return keys, ms


def merge_parts(keys, ms, k):
    """merge_topk: the K greatest keys of all parts; lse = m* + log sum_i s_i exp(m_i - m*)."""
    best = np.sort(np.concatenate(keys, axis=1), axis=1)[:, ::-1][:, :k]
    m_star = np.max([m for m, _ in ms], axis=0)
    lse = m_star + np.log(np.sum([s * np.exp(m - m_star) for m, s in ms], axis=0))
    return key_values(best) - lse[:, None], key_indices(best)


def tiled_argmax(logits: np.ndarray, mv: int) -> np.ndarray:
    """ArgmaxTileEnd: the greatest key of each tile, then the greatest over tiles."""
    V = logits.shape[1]
    parts = [pack_keys(logits[:, v0:v0 + mv], np.broadcast_to(np.arange(v0, min(V, v0 + mv)),
                                                               logits[:, v0:v0 + mv].shape)).max(axis=1)
             for v0 in range(0, V, mv)]
    return key_indices(np.max(parts, axis=0))


def _case(seed, V, R=19, ties=()):
    """Weights in the JAX layout [H, V], top [R, H]; each tie (a, b) copies column a to b, both biased to the top.

    Every weight, bias and input is a multiple of 1/64 in [-0.5, 0.5]: each product is a multiple of 2^-12 below
    1/4 in size, so each partial sum of H = 24 of them and a bias (below 64 in size) is exact in f32.  Equal columns
    then give bit-equal logits whatever order a BLAS sums them in (a CPU BLAS does not promise that for equal
    columns at different positions of an inexact product: its blocking follows the thread count)."""
    rng = np.random.RandomState(seed)
    grid = lambda *shape: (rng.randint(-32, 33, shape) / 64.0).astype(np.float32)
    linear = {"w": grid(H, V), "b": grid(V)}
    for rank, (a, b) in enumerate(ties):
        linear["w"][:, b] = linear["w"][:, a]
        linear["b"][a] = linear["b"][b] = 50.0 - 20.0 * rank
    return linear, grid(R, H)


def _assert_tied(logits, ties):
    """The plain twin's logits of each tied pair of columns are bit-equal (the data ties exactly)."""
    for a, b in ties:
        np.testing.assert_array_equal(logits[:, a], logits[:, b])


def _port_vocab(linear):
    return prepare_vocab(torch.from_numpy(np.ascontiguousarray(linear["w"].T)), torch.from_numpy(linear["b"]))


def _jax_vocab(linear):
    return jax_prepare_vocab({k: jnp.asarray(v) for k, v in linear.items()}, block_v=BLOCK_V)


@pytest.mark.parametrize("k", [1, 3, 5, 8])
@pytest.mark.parametrize("V,sms", [(77, 132), (77, 2), (40, 2)])
def test_tiled_topk_matches_plain_and_pallas(V, sms, k):
    """Ties straddle the first tile boundary (columns mv - 1 and mv) and lie
    inside the last tile: the merged parts list the lower index first, as
    the plain twin and jax.lax.top_k do; logp within 1e-5 (per-tile sums)."""
    mv = vocab_tiles(H, V, sms).mv
    ties = ((mv - 1, mv), (V - 2, V - 1))
    linear, top = _case(k, V, ties=ties)
    vocab = _port_vocab(linear)
    logits = project_logits(vocab, torch.from_numpy(top)).numpy()
    _assert_tied(logits, ties)
    keys, ms = tile_parts(logits, mv, k)
    assert len(keys) == vocab_tiles(H, V, sms).tiles
    logp, ids = merge_parts(keys, ms, k)
    ref_logp, ref_ids = project_topk_plain(vocab, torch.from_numpy(top), k)
    j_logp, j_ids = project_topk_pallas(_jax_vocab(linear), jnp.asarray(top), k, block_v=BLOCK_V, interpret=True)
    np.testing.assert_array_equal(ids, ref_ids.numpy())
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    np.testing.assert_allclose(logp, ref_logp.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logp, np.asarray(j_logp), rtol=1e-5, atol=1e-5)
    assert ids[:, :min(k, 2)].tolist() == [[mv - 1, mv][:min(k, 2)]] * len(top)
    if k >= 4:
        assert ids[:, 2:4].tolist() == [[V - 2, V - 1]] * len(top)
    got = project_topk(vocab, torch.from_numpy(top), k)  # the wrapper on CPU tensors: the twin
    assert torch.equal(got[1], ref_ids)


@pytest.mark.parametrize("V,sms", [(77, 132), (77, 2), (40, 2)])
def test_tiled_argmax_takes_the_lower_index_across_a_tile_boundary(V, sms):
    mv = vocab_tiles(H, V, sms).mv
    linear, top = _case(3, V, ties=((mv - 1, mv),))
    vocab = _port_vocab(linear)
    logits = project_logits(vocab, torch.from_numpy(top)).numpy()
    _assert_tied(logits, ((mv - 1, mv),))
    tok = tiled_argmax(logits, mv)
    assert tok.tolist() == [mv - 1] * len(top)
    assert project_argmax_plain(vocab, torch.from_numpy(top)).tolist() == tok.tolist()
    assert project_argmax(vocab, torch.from_numpy(top)).tolist() == tok.tolist()
    assert np.asarray(project_argmax_pallas(_jax_vocab(linear), jnp.asarray(top), block_v=BLOCK_V,
                                            interpret=True)).tolist() == tok.tolist()


@pytest.mark.parametrize("seed", [0, 1])
def test_tiled_argmax_matches_plain_without_ties(seed):
    linear, top = _case(seed, 77)
    vocab = _port_vocab(linear)
    logits = project_logits(vocab, torch.from_numpy(top)).numpy()
    for mv in (16, 32, 80):
        assert tiled_argmax(logits, mv).tolist() == project_argmax_plain(vocab, torch.from_numpy(top)).tolist()


def test_key_packing_orders_values_then_lower_index():
    v = np.array([-np.inf, -2.0, -0.0, 0.0, 1.5, 1.5, np.float32(3e38)], np.float32)
    i = np.array([0, 1, 2, 3, 9, 4, 5])
    keys = pack_keys(v, i)
    assert key_indices(keys).tolist() == i.tolist()
    np.testing.assert_array_equal(key_values(keys), v + np.float32(0.0))
    assert keys[0] < keys[1] < keys[2] and keys[2] > keys[3]  # -0.0 and +0.0 tie: index 2 before 3
    assert keys[5] > keys[4]  # 1.5 at index 4 before 1.5 at index 9
