"""The bf16 dense beam steps' tensor-core tiles (csrc/dense_mma.cuh), on the CPU.

The kernels run only on the card; what surrounds them runs here: the
launch geometry (``fused_step.mma_tiles``: items, K chunks, shared
memory, and the error for a width that does not fit), with its constants
read back from the header.  The tiles' arithmetic is re-enacted in numpy
lane by lane: each lane's 16-byte loads in the kernel's K permutation,
the m16n8k16 fragments they form (the PTX layouts of A, B and the
accumulators), the split of K chunks over the four warps, the staged sums
at the kernel's pitch, their sum in warp order, and the finish: the
GRU's r and z over both sides and its n gate's two sides apart, the
LSTM's four gates, the vocabulary's bias.  The re-enactment is held to the
plain stack (``stack_plain``), the plain projection, and the JAX
package's fused_dense_step_pallas and fused_attn_dense_step_pallas in
interpret mode.  f32, H=24 (K padded to 32), E=16, L=2, R = 3 and 19, V =
40 and 77.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.ops.fused_attn_pallas import fused_attn_dense_step_pallas
from show_tell_tpu.ops.fused_attn_pallas import prepare_attn_decode as jax_prepare_attn_decode
from show_tell_tpu.ops.fused_beam_pallas import fused_dense_step_pallas
from show_tell_tpu.ops.rnn_pallas import prepare_rnn_weights as jax_prepare_rnn_weights
from show_tell_tpu.ops.vocab_pallas import prepare_vocab as jax_prepare_vocab
from show_tell_tpu.models.attention import AttnDecoderConfig as JaxAttnConfig
from show_tell_tpu.models.attention import init_attn_decoder_params
from show_tell_tpu_torch.models.attention import AttnDecoder, AttnDecoderConfig
from show_tell_tpu_torch.models.convert import decoder_from_jax
from show_tell_tpu_torch.ops import fused_step
from show_tell_tpu_torch.ops.attention import attention_alpha_plain
from show_tell_tpu_torch.ops.fused_attn import prepare_attn_decode, prepare_attn_weights
from show_tell_tpu_torch.ops.fused_step import mma_tiles
from show_tell_tpu_torch.ops.rnn import prepare_rnn_weights, stack_plain
from show_tell_tpu_torch.ops.vocab import prepare_vocab, project_logits

E, H, L = 16, 24, 2
AC, AA, P = 24, 16, 5  # attention: channels, attention width, positions
BLOCK_V = 16  # the JAX kernels' vocab block here
SLAB, CHUNK, SLOTS, WARPS, PITCH = (fused_step.MMA_SLAB, fused_step.MMA_CHUNK, fused_step.MMA_SLOTS,
                                    fused_step.MMA_WARPS, fused_step.MMA_PITCH)
VALS = SLOTS * 4 * 4  # f32 sums a lane
HEADER = os.path.join(os.path.dirname(fused_step.__file__), "..", "csrc", "dense_mma.cuh")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- geometry


def test_constants_agree_with_the_kernel_header():
    src = open(HEADER).read()
    const = lambda name: int(re.search(r"constexpr int %s = (\d+);" % name, src).group(1))
    assert (const("kMmaSlab"), const("kMmaChunk"), const("kMmaSlots"), const("kMmaPitch")) == (SLAB, CHUNK, SLOTS,
                                                                                             PITCH)
    assert "kMmaVocabRows = 16 * kMmaSlots" in src
    common = open(os.path.join(os.path.dirname(HEADER), "decode_common.cuh")).read()
    assert re.search(r"constexpr int kThreads = (\d+);", common).group(1) == str(32 * WARPS)
    assert re.search(r"constexpr int kBM = (\d+);", common).group(1) == str(fused_step.ATTN_ROWS)


# (family, R, I0, H, V, attention (A, P)): the four flagships at R = 3 (B=1) and 192 (B=64), K=3
FLAGSHIPS = [("pooled gru", 256, None), ("pooled lstm", 512, None), ("attention gru", 1024, (512, 49)),
             ("attention lstm", 1024, (512, 49))]


@pytest.mark.parametrize("R", [3, 192])
@pytest.mark.parametrize("family,I0,attention", FLAGSHIPS)
def test_flagship_geometry(family, I0, attention, R):
    """H=512, V=9,956: 32 column tiles and 156 vocabulary tiles, times ceil(R / 32) slabs; 33,792 bytes of
    staged sums a block, the largest of the attention's needs too (A1: 8 x 512 f32, A2: 561)."""
    g = mma_tiles(R, I0, 512, 9956, attention)
    slabs = -(-R // 32)
    assert g == (32 * slabs, 156 * slabs, I0 // 32 + 16, 32, 16, 33792)


@pytest.mark.parametrize("R,I0,H_,V", [(1, 8, 8, 1), (3, 16, 24, 40), (19, 40, 24, 77), (64, 256, 512, 9956),
                                       (65, 1024, 512, 9956), (192, 512, 512, 9956), (33, 24, 16, 65)])
def test_items_cover_every_output_once(R, I0, H_, V):
    """The kernel's item -> (slab, tile) maps cover each (row, column) of a
    layer and each (row, vocabulary entry) once, and every warp's chunk run
    together covers K once."""
    g = mma_tiles(R, I0, H_, V)
    slabs = -(-R // SLAB)
    for items, width, rows in ((g.gate_items, H_, 16), (g.vocab_items, V, 16 * SLOTS)):
        covered = np.zeros((R, width), np.int64)
        for item in range(items):
            n0, c0 = (item % slabs) * SLAB, (item // slabs) * rows
            assert n0 < R and c0 < width
            covered[n0 : n0 + SLAB, c0 : c0 + rows] += 1
        assert (covered == 1).all()
    for n_chunks in (g.layer0_chunks, g.upper_chunks, g.vocab_chunks):
        runs = [range(w * n_chunks // WARPS, (w + 1) * n_chunks // WARPS) for w in range(WARPS)]
        assert sorted(c for run in runs for c in run) == list(range(n_chunks))


def test_a_width_that_does_not_fit_raises():
    """The attention's SIMT phase A1 holds 8 rows of h in f32: H=8,192 needs 262,144 bytes."""
    with pytest.raises(ValueError, match="H=8192, A=512, P=49 needs 262144 bytes"):
        mma_tiles(192, 1024, 8192, 9956, (512, 49))
    with pytest.raises(ValueError, match="multiples of 8"):
        mma_tiles(3, 20, 24, 40)
    assert mma_tiles(192, 1024, 8192, 9956).smem == 33792  # the pooled step stages only its sums


# ---------------------------------------------------------------- the tiles' arithmetic, lane by lane

LANES = np.arange(32)
G_OF, T_OF = LANES >> 2, LANES & 3  # lane = 4g + t


def lane_loads(mat, rows, k0):
    """Each lane's 16 bytes of each listed row: columns k0 + 8t .. k0 + 8t + 7,
    zero past the matrix (rows < 0 are rows that do not exist).  [32, len(rows), 8]."""
    out = np.zeros((32, len(rows), 8), np.float32)
    for lane in LANES:
        k = k0 + 8 * T_OF[lane]
        for i, r in enumerate(rows[lane] if rows.ndim == 2 else rows):
            if r >= 0 and k < mat.shape[1]:
                out[lane, i] = mat[r, k : k + 8]
    return out


def mma_chunk(acc, a_lanes, b_lanes):
    """acc [32, 4 n8, 4] += the chunk's two m16n8k16 steps, built from the lanes'
    registers as mma_tile pairs them (lo: .x, .y of rows g, g + 8; hi: .z, .w),
    with PTX's fragment layouts: a0 = A[g][2t:2t+2], a1 = A[g+8][2t:2t+2],
    a2 = A[g][2t+8:2t+10], a3 = A[g+8][2t+8:2t+10]; b0 = B[2t:2t+2][g],
    b1 = B[2t+8:2t+10][g]; c_e = D[g + 8(e // 2)][2t + e % 2].
    a_lanes [32, 2 (rows g, g + 8), 8], b_lanes [32, 4 n8, 8]."""
    for step in (0, 1):
        words = lambda v, w: v[..., 4 * step + 2 * w : 4 * step + 2 * w + 2]  # 32-bit word .x/.y (or .z/.w)
        A = np.zeros((16, 16), np.float32)
        for lane in LANES:
            g, tq = G_OF[lane], T_OF[lane]
            A[g, 2 * tq : 2 * tq + 2] = words(a_lanes[lane, 0], 0)
            A[g + 8, 2 * tq : 2 * tq + 2] = words(a_lanes[lane, 1], 0)
            A[g, 2 * tq + 8 : 2 * tq + 10] = words(a_lanes[lane, 0], 1)
            A[g + 8, 2 * tq + 8 : 2 * tq + 10] = words(a_lanes[lane, 1], 1)
        for nt in range(4):
            Bm = np.zeros((16, 8), np.float32)
            for lane in LANES:
                g, tq = G_OF[lane], T_OF[lane]
                Bm[2 * tq : 2 * tq + 2, g] = words(b_lanes[lane, nt], 0)
                Bm[2 * tq + 8 : 2 * tq + 10, g] = words(b_lanes[lane, nt], 1)
            D = A @ Bm
            for lane in LANES:
                g, tq = G_OF[lane], T_OF[lane]
                for e in range(4):
                    acc[lane, nt, e] += D[g + 8 * (e // 2), 2 * tq + e % 2]


def slab_rows(n0, R):
    """Rows g, 8 + g, 16 + g, 24 + g of the slab, for each lane; -1 past R."""
    r = n0 + 8 * np.arange(4)[None, :] + G_OF[:, None]
    return np.where(r < R, r, -1)


def run_item(sources, n_chunks):
    """One item: each warp runs its chunks (sources(c) -> (slot of each A tile,
    A loads, B loads)) into acc [32, slots, 4, 4], stages them at the pitch;
    returns red [warps * VALS * PITCH]."""
    red = np.zeros(WARPS * VALS * PITCH, np.float32)
    for w in range(WARPS):
        acc = np.zeros((32, SLOTS, 4, 4), np.float32)
        for c in range(w * n_chunks // WARPS, (w + 1) * n_chunks // WARPS):
            slots, a_tiles, b_lanes = sources(c)
            for slot, a_lanes in zip(slots, a_tiles):
                mma_chunk(acc[:, slot], a_lanes, b_lanes)
        for s in range(SLOTS):
            for nt in range(4):
                for e in range(4):
                    red[w * VALS * PITCH + ((s * 4 + nt) * 4 + e) * PITCH + LANES] = acc[:, s, nt, e]
    return red


def mma_sum(red, s, m, n):
    """mma_sum of csrc/dense_mma.cuh: the staged sum of the four warps, in order."""
    at = ((s * 4 + (n >> 3)) * 4 + 2 * (m >> 3) + (n & 1)) * PITCH + 4 * (m & 7) + ((n & 7) >> 1)
    v = red[at]
    for w in range(1, WARPS):
        v = np.float32(v + red[w * VALS * PITCH + at])
    return v


def sigmoid(v):
    return np.float32(1.0) / (np.float32(1.0) + np.exp(-v))


def tiled_layer(cell, x, h, c, w_ih, w_hh, b_ih, b_hh):
    """mma_rnn_layer re-enacted: (h', c') [R, H] f32 (c' None for the GRU)."""
    G = 4 if cell == "lstm" else 3
    R, I = x.shape
    Hd = h.shape[1]
    cx = -(-I // CHUNK)
    n_chunks = cx + -(-Hd // CHUNK)
    h2, c2 = np.zeros((R, Hd), np.float32), np.zeros((R, Hd), np.float32)
    for item in range(-(-R // SLAB) * -(-Hd // 16)):
        slabs = -(-R // SLAB)
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

        red = run_item(sources, n_chunks)
        for o in range(16 * SLAB):
            m, n = o & 15, o >> 4
            j, row = j0 + m, n0 + n
            if row >= R or j >= Hd:
                continue
            s = [mma_sum(red, slot, m, n) for slot in range(4)]
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
    return h2, (c2 if G == 4 else None)


def vocab_item_sums(top, wv, order=None):
    """mma_project re-enacted: for each (64 vocabulary rows, 32 batch rows)
    item, in ``order`` (default the items' own), (n0, v0, red), red its
    staged sums.  top [R, H], wv [V, H]."""
    R, Hd = top.shape
    V = wv.shape[0]
    slabs = -(-R // SLAB)
    for item in range(slabs * -(-V // (16 * SLOTS))) if order is None else order:
        n0, v0 = (item % slabs) * SLAB, (item // slabs) * 16 * SLOTS

        def sources(ch):
            tiles = []
            for i in range(SLOTS):
                rows = v0 + 16 * i + np.stack([G_OF, G_OF + 8], 1)
                tiles.append(lane_loads(wv, np.where(rows < V, rows, -1), ch * CHUNK))
            return list(range(SLOTS)), tiles, lane_loads(top, slab_rows(n0, R), ch * CHUNK)

        yield n0, v0, run_item(sources, -(-Hd // CHUNK))


def tiled_logits(top, wv, bv):
    """mma_vocab_phase's dense end re-enacted: [R, V] f32."""
    R, V = top.shape[0], wv.shape[0]
    out = np.full((R, V), np.nan, np.float32)
    for n0, v0, red in vocab_item_sums(top, wv):
        for o in range(16 * SLOTS * SLAB):
            m, n = o % (16 * SLOTS), o // (16 * SLOTS)
            if n0 + n < R and v0 + m < V:
                out[n0 + n, v0 + m] = mma_sum(red, m >> 4, m & 15, n) + np.float32(bv[v0 + m])
    return out


def tiled_stack(cell, stacked, x, state):
    """mma_stack_layer's L layers re-enacted, in f32: (top [R, H], new state)."""
    npy = lambda v: v.numpy()
    hs, cs = (npy(state[0]), npy(state[1])) if cell == "lstm" else (npy(state), None)
    inp, new_h, new_c = npy(x), [], []
    for l in range(hs.shape[0]):
        w_ih = stacked["w_ih0"] if l == 0 else stacked["w_ihU"][l - 1]
        inp, c2 = tiled_layer(cell, inp, hs[l], None if cs is None else cs[l], npy(w_ih), npy(stacked["w_hh"][l]),
                              npy(stacked["b_ih"][l]), npy(stacked["b_hh"][l]))
        new_h.append(inp)
        new_c.append(c2)
    return inp, ((np.stack(new_h), np.stack(new_c)) if cell == "lstm" else np.stack(new_h))


def tiled_step(cell, stacked, vocab, x, state):
    """The bf16 dense step's order of work, in f32: (logits, new state)."""
    top, new_state = tiled_stack(cell, stacked, x, state)
    return tiled_logits(top, vocab["w"].numpy(), vocab["b"].numpy()), new_state


def _states(state):
    return [np.asarray(s) for s in (state if isinstance(state, tuple) else (state,))]


def _assert_states(got, ref):
    for g, r in zip(_states(got), _states(ref)):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)


def test_lane_loads_and_fragments_form_the_product():
    """One chunk of random rows: the lanes' permuted registers and the PTX
    fragment layouts multiply to the rows' dot products over the chunk."""
    rng = np.random.RandomState(0)
    a, b = rng.randn(16, 40).astype(np.float32), rng.randn(32, 40).astype(np.float32)
    for k0 in (0, 32):
        acc = np.zeros((32, 4, 4), np.float32)
        mma_chunk(acc, lane_loads(a, np.stack([G_OF, G_OF + 8], 1), k0), lane_loads(b, slab_rows(0, 32), k0))
        D = np.zeros((16, 32), np.float32)
        for lane in LANES:
            for nt in range(4):
                for e in range(4):
                    D[G_OF[lane] + 8 * (e // 2), 8 * nt + 2 * T_OF[lane] + e % 2] = acc[lane, nt, e]
        np.testing.assert_allclose(D, a[:, k0 : k0 + 32] @ b[:, k0 : k0 + 32].T, rtol=1e-5, atol=1e-5)


def _pooled_case(cell, R, V, seed):
    """Torch-layout weights and inputs, and the same in the JAX layout."""
    rng = np.random.RandomState(seed)
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    G = (4 if cell == "lstm" else 3) * H
    layers = [{"w_ih": u(E if l == 0 else H, G), "w_hh": u(H, G), "b_ih": u(G), "b_hh": u(G)} for l in range(L)]
    linear = {"w": u(H, V), "b": u(V)}
    x = rng.randn(R, E).astype(np.float32)
    hs = rng.uniform(-1, 1, (L, R, H)).astype(np.float32)
    state = (hs, rng.uniform(-2, 2, (L, R, H)).astype(np.float32)) if cell == "lstm" else hs
    port = (prepare_rnn_weights([{k: t(v.T) if v.ndim == 2 else t(v) for k, v in l.items()} for l in layers]),
            prepare_vocab(t(linear["w"].T), t(linear["b"])), t(x),
            tuple(t(s) for s in state) if cell == "lstm" else t(state))
    jax_args = (jax_prepare_rnn_weights([{k: jnp.asarray(v) for k, v in l.items()} for l in layers]),
                jax_prepare_vocab({k: jnp.asarray(v) for k, v in linear.items()}, block_v=BLOCK_V), jnp.asarray(x),
                jax.tree.map(jnp.asarray, state))
    return port, jax_args


@pytest.mark.parametrize("V", [40, 77])
@pytest.mark.parametrize("R", [3, 19])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_pooled_tiles_match_plain_and_pallas(cell, R, V):
    """The pooled dense step in the tiles' order: the new state and the
    logits within 1e-5 of the plain stack and projection, and of the
    interpreted fused_dense_step_pallas."""
    port, jax_args = _pooled_case(cell, R, V, 100 + R + V)
    logits, state = tiled_step(cell, *port)
    top, ref_state = stack_plain(cell)(port[0], port[2], port[3])
    _assert_states(state, ref_state)
    np.testing.assert_allclose(logits, project_logits(port[1], top).numpy(), rtol=1e-5, atol=1e-5)
    j_logits, j_state = fused_dense_step_pallas(cell, *jax_args, V, block_v=BLOCK_V, interpret=True)
    np.testing.assert_allclose(logits, np.asarray(j_logits), rtol=1e-5, atol=1e-5)
    _assert_states(state, j_state)


def _attn_case(cell, R, V, seed):
    """An attention decoder from the JAX package's init, in both layouts:
    (prep, w_emb, state) of the port, x = cat(w_emb, ctx_e) as the plain
    twin's A1 and A2 form it (they stay SIMT in every instance), and the
    JAX package's (prep, w_emb, state) with its vocab in BLOCK_V blocks."""
    jcfg = JaxAttnConfig(cell, E, AC, AA, H, V, L, max_caption_length=4)
    jparams = init_attn_decoder_params(jax.random.PRNGKey(seed), jcfg)
    with torch.device("meta"):
        dec = AttnDecoder(AttnDecoderConfig(*jcfg))
    sd = {k: t(np.array(v)) for k, v in decoder_from_jax(jax.tree.map(np.asarray, jparams)).items()}
    dec.load_state_dict(sd, strict=True, assign=True)
    rng = np.random.RandomState(200 + seed)
    feats_pm = rng.randn(R, P, AC).astype(np.float32)
    w_emb = rng.randn(R, E).astype(np.float32)
    hs = rng.uniform(-1, 1, (L, R, H)).astype(np.float32)
    state = (hs, rng.uniform(-2, 2, (L, R, H)).astype(np.float32)) if cell == "lstm" else hs
    tstate = tuple(t(s) for s in state) if cell == "lstm" else t(state)
    with torch.inference_mode():
        prep = prepare_attn_decode(prepare_attn_weights(dec), dec, t(feats_pm))
        alpha = attention_alpha_plain(prep, prep["att1"], t(hs[-1]))
        ctx_e = (prep["feats_e"].float() * alpha[..., None]).sum(dim=1) + prep["b_emb"].float()
        x = torch.cat([t(w_emb), ctx_e], dim=-1)
    j_prep = jax_prepare_attn_decode(jparams, jnp.asarray(feats_pm))
    j_prep["vocab"] = jax_prepare_vocab(jparams["linear"], block_v=BLOCK_V)
    return (prep, t(w_emb), tstate), x, (j_prep, jnp.asarray(w_emb), jax.tree.map(jnp.asarray, state))


@pytest.mark.parametrize("V", [40, 77])
@pytest.mark.parametrize("R", [3, 19])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_attention_tiles_match_plain_and_pallas(cell, R, V):
    """The attention dense step: A1 and A2 as the plain twin computes them
    (they stay SIMT), then the recurrence (layer 0 is 2E wide) and the
    projection in the tiles' order, against the plain stack and the
    interpreted fused_attn_dense_step_pallas."""
    (prep, _, tstate), x, (j_prep, j_emb, j_state0) = _attn_case(cell, R, V, R + V)
    with torch.inference_mode():
        logits, new_state = tiled_step(cell, prep["stacked"], prep["vocab"], x, tstate)
        top, ref_state = stack_plain(cell)(prep["stacked"], x, tstate)
        ref_logits = project_logits(prep["vocab"], top).numpy()
    _assert_states(new_state, ref_state)
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-5, atol=1e-5)
    j_logits, j_state = fused_attn_dense_step_pallas(j_prep, cell, j_emb, j_state0, V, block_v=BLOCK_V, interpret=True)
    np.testing.assert_allclose(logits, np.asarray(j_logits), rtol=1e-5, atol=1e-5)
    _assert_states(new_state, j_state)


def test_gru_n_gate_needs_its_two_sides_apart():
    """Summing the n gate's x and h sides into one slot, as r and z are,
    gives another state: the finish's r multiplies only W_hn h + b_hn."""
    port, _ = _pooled_case("gru", 3, 40, 7)
    stacked, _, x, hs = port
    good, _ = tiled_layer("gru", x.numpy(), hs[0].numpy(), None, stacked["w_ih0"].numpy(), stacked["w_hh"][0].numpy(),
                          stacked["b_ih"][0].numpy(), stacked["b_hh"][0].numpy())
    ref = stack_plain("gru")(stacked, x, hs)[1][0].numpy()
    np.testing.assert_allclose(good, ref, rtol=1e-5, atol=1e-5)
    fused_n = (x.numpy() @ stacked["w_ih0"].numpy().T + hs[0].numpy() @ stacked["w_hh"][0].numpy().T)[:, 2 * H :]
    gh = hs[0].numpy() @ stacked["w_hh"][0].numpy().T + stacked["b_hh"][0].numpy()
    r = sigmoid(x.numpy() @ stacked["w_ih0"].numpy().T[:, :H] + stacked["b_ih"][0].numpy()[:H] + gh[:, :H])
    wrong_n = np.tanh(fused_n + stacked["b_ih"][0].numpy()[2 * H :] + r * stacked["b_hh"][0].numpy()[2 * H :])
    right_n = np.tanh(x.numpy() @ stacked["w_ih0"].numpy().T[:, 2 * H :] + stacked["b_ih"][0].numpy()[2 * H :]
                      + r * gh[:, 2 * H :])
    assert np.abs(wrong_n - right_n).max() > 1e-2
