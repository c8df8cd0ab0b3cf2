"""The f32 attention steps in split-precision TF32 (csrc/fused_attn_step.cu, tf32x3_step<T, kMode, true>()), on the CPU.

The kernels run only on the card; what surrounds them runs here.  Their
arithmetic is re-enacted in numpy with the helpers of
test_torch_f32_tf32x3.py (each f32 operand split into tf32 halves, each k8
step's three products summed from zero and added in f32, the kernel's K
order): A1 (att2 = h W_dec^T + b_dec, in f32) and A2 (the scores,
softmax and embed-space context, its sums in f64 and each result rounded
once to f32) as the SIMT phases compute them; the
2E-wide layer 0 and the upper layers with the K split that stack_tiles
gives on an H100's 132 SMs; and both ends, the dense logits and the
first-max argmax.  The re-enactment is held to the port's twins and to the
JAX package's fused attention step (greedy and dense) in interpret mode at
small widths, both cells, and to the twins at one flagship-width step
(B = 32), where one-pass TF32 misses the f32 bar.  Also the predicate and
the f32 attention geometry.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.ops.fused_attn_pallas import fused_attn_decode_step_pallas, fused_attn_dense_step_pallas
from show_tell_tpu.ops.vocab_pallas import VOCAB_BLOCK
from show_tell_tpu.ops.vocab_pallas import prepare_vocab as jax_prepare_vocab
from show_tell_tpu_torch.ops import fused_step
from show_tell_tpu_torch.ops.fused_attn import fused_attn_decode_step_plain, fused_attn_dense_step_plain
from show_tell_tpu_torch.ops.fused_step import mma_step, mma_tiles, stack_tiles, tf32x3_step
from show_tell_tpu_torch.ops.rnn import prepare_rnn_weights
from show_tell_tpu_torch.ops.vocab import prepare_vocab, project_logits
from test_torch_f32_tf32x3 import GAP, SMS, STATE_TOL, _excess, _states, t, tf32x3_step_reenacted
from test_torch_gate_tiles import BLOCK_V, HEADER, SLAB
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

DENSE_STATE_TOL = 2e-5  # the beam steps' state bar (chip_smoke.BEAM_STATE_TOL in f32)
LOGIT_TOL = 1e-4  # dense logits, rtol = atol
CSRC = os.path.dirname(HEADER)


def attn_step_reenacted(cell, prep, w_emb, state, one_pass=False):
    """The f32 attention step of st_fused_attn_step and its LSTM and dense
    twins re-enacted: (tokens [B], logits [B, V], new state), numpy."""
    npy = lambda v: v.numpy()
    d = lambda v: npy(v).astype(np.float64)
    hs = npy(state[0] if cell == "lstm" else state)
    att2 = (hs[-1] @ npy(prep["wdec"]).T + npy(prep["bdec"])).astype(np.float32)
    v = d(prep["att1"]) + att2[:, None, :]
    e = ((np.where(v >= 0, v, 0.2 * v) * d(prep["wfull"])).sum(-1)).astype(np.float32)
    alpha = np.exp(e - e.max(1, keepdims=True)).astype(np.float32)
    alpha = (alpha / alpha.astype(np.float64).sum(1, keepdims=True)).astype(np.float32)
    ctx = ((alpha[..., None] * d(prep["feats_e"])).sum(1) + d(prep["b_emb"])).astype(np.float32)
    x = t(np.concatenate([npy(w_emb), ctx], axis=1))
    return tf32x3_step_reenacted(cell, prep["stacked"], prep["vocab"], x, state, one_pass)


def _case(cell, B, E, H, A, P, V, L, seed, bound=0.3, block_v=BLOCK_V):
    """Weights and biases uniform in +-bound, att1 and feats_e in +-1, w_emb ~
    N(0, 1), h in +-1 (c in +-2): the port's operands (prep, w_emb, state)
    and the JAX package's (prep, w_emb, state, V, block_v)."""
    rng = np.random.RandomState(seed)
    u = lambda *s, b=bound: rng.uniform(-b, b, s).astype(np.float32)
    G = (4 if cell == "lstm" else 3) * H
    layers = [{"w_ih": u(2 * E if l == 0 else H, G), "w_hh": u(H, G), "b_ih": u(G), "b_hh": u(G)} for l in range(L)]
    linear = {"w": u(H, V), "b": u(V)}
    wdec, bdec, wfull, b_emb = u(H, A), u(A), u(A), u(E)
    att1, feats_e = u(B, P, A, b=1.0), u(B, P, E, b=1.0)
    w_emb = rng.randn(B, E).astype(np.float32)
    hs = rng.uniform(-1, 1, (L, B, H)).astype(np.float32)
    state = (hs, rng.uniform(-2, 2, (L, B, H)).astype(np.float32)) if cell == "lstm" else hs
    prep = {"stacked": prepare_rnn_weights([{k: t(v.T) if v.ndim == 2 else t(v) for k, v in l.items()}
                                            for l in layers]),
            "vocab": prepare_vocab(t(linear["w"].T), t(linear["b"])), "wdec": t(wdec.T), "bdec": t(bdec),
            "wfull": t(wfull), "b_emb": t(b_emb), "att1": t(att1), "feats_e": t(feats_e)}
    port = (prep, t(w_emb), tuple(t(s) for s in state) if cell == "lstm" else t(state))
    upper = [l["w_ih"] for l in layers[1:]] or [np.zeros((H, G), np.float32)]
    j = lambda a: jnp.asarray(a)
    jprep = {"att1": j(att1), "feats_e": j(feats_e), "b_emb": j(b_emb), "wdec": j(wdec), "bdec": j(bdec),
             "wfull": j(wfull), "w_ih0": j(layers[0]["w_ih"]), "w_ihU": j(np.stack(upper)),
             "w_hh": j(np.stack([l["w_hh"] for l in layers])),
             "b_ih": j(np.stack([l["b_ih"] for l in layers])[:, None, :]),
             "b_hh": j(np.stack([l["b_hh"] for l in layers])[:, None, :]),
             "vocab": jax_prepare_vocab({k: j(v) for k, v in linear.items()}, block_v=block_v)}
    return port, (jprep, j(w_emb), jax.tree.map(j, state), V, block_v)


def _jax_step(cell, jax_args, dense):
    jprep, w_emb, state, V, block_v = jax_args
    if dense:
        out, st = fused_attn_dense_step_pallas(jprep, cell, w_emb, state, V, block_v=block_v, interpret=True)
    else:
        out, st = fused_attn_decode_step_pallas(jprep, cell, w_emb, state, block_v=block_v, interpret=True)
    return np.asarray(out), jax.tree.map(np.asarray, st)


def _clear(top, vocab):
    logits = project_logits(vocab, t(top)).numpy()
    two = np.sort(logits, axis=1)[:, -2:]
    return two[:, 1] - two[:, 0] > GAP


def _excess_at(got, ref, tol):
    """_excess at another bar: the largest |got - ref| - tol (1 + |ref|) over the states."""
    return max(float(np.max(np.abs(g - r) - tol * (1 + np.abs(r)))) for g, r in zip(_states(got), _states(ref)))


def _hold(cell, port, jax_args=None):
    """The re-enactment against the twins (greedy and dense) and, where
    ``jax_args`` is given, the interpreted Pallas steps: states within 1e-5
    (2e-5 for the dense twins), dense logits within 1e-4, tokens equal where
    the gap is clear and the first max of the re-enacted logits.  Returns
    the re-enacted state and the greedy twin's state."""
    tok, logits, state = attn_step_reenacted(cell, *port)
    assert np.array_equal(tok, np.argmax(logits, axis=1))
    ref_tok, ref_state = fused_attn_decode_step_plain(*port)
    ref_logits, dense_state = fused_attn_dense_step_plain(*port)
    ref_state, dense_state = (tuple(_states(st)) for st in (ref_state, dense_state))
    assert _excess(state, ref_state) <= 0 and _excess_at(state, dense_state, DENSE_STATE_TOL) <= 0
    np.testing.assert_allclose(logits, ref_logits.numpy(), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    clear = _clear(_states(state)[0][-1], port[0]["vocab"])
    assert clear.mean() > 0.8
    assert np.array_equal(tok[clear], ref_tok.numpy()[clear])
    if jax_args is not None:
        j_tok, j_state = _jax_step(cell, jax_args, dense=False)
        assert _excess(state, j_state) <= 0 and np.array_equal(tok[clear], j_tok[clear])
        j_logits, j_dense_state = _jax_step(cell, jax_args, dense=True)
        assert _excess_at(state, j_dense_state, DENSE_STATE_TOL) <= 0
        np.testing.assert_allclose(logits, j_logits, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    return state, ref_state


# (B, E, H, A, P, V, L), H <= 2E (the JAX package's fused-step rule): ragged slabs (3, 19, 65), A not a multiple of
# the 64-row item (A1's ragged W_dec rows: 16, 40, 72), H = 24 (the second h-side chunk half zeros), V not a multiple
# of the 64-row vocabulary item; the K split across blocks at S = 2 (5 rows, 2E = H = 64) and S = 3 (40 rows, 2E =
# 112, H = 96: layer 0's 13 chunks in runs of uneven length)
SMALL = [(3, 16, 24, 16, 5, 40, 1), (19, 24, 40, 40, 7, 77, 2), (65, 16, 24, 72, 3, 77, 2),
         (5, 32, 64, 32, 5, 77, 2), (40, 56, 96, 24, 6, 77, 2)]


@pytest.mark.parametrize("B,E,H,A,P,V,L", SMALL)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_tf32x3_attention_steps_match_the_twins_and_pallas(cell, B, E, H, A, P, V, L):
    port, jax_args = _case(cell, B, E, H, A, P, V, L, 900 + B + V)
    _hold(cell, port, jax_args)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_flagship_attention_step_at_b32_and_one_pass_tf32_misses_the_bar(cell):
    """L=5, E=H=A=512, P=49, V=9,956, B=32, weights at the decoder init's
    scale (U(+-1/sqrt(H)), as chip_smoke.py draws them): 3xTF32 holds the f32
    bars against the greedy and dense twins; one-pass TF32 (big_a big_b
    alone, in the layers and the projection) on the same inputs leaves
    the 1e-5 band of the twin's states by more than ten times the band."""
    port, _ = _case(cell, 32, 512, 512, 512, 49, 9956, 5, 910, bound=512 ** -0.5, block_v=VOCAB_BLOCK)
    _, ref_state = _hold(cell, port)
    _, _, one_pass = attn_step_reenacted(cell, *port, one_pass=True)
    assert _excess(one_pass, ref_state) > 10 * STATE_TOL


# ---------------------------------------------------------------- the predicate and the geometry


@pytest.mark.parametrize("end", ["argmax", "dense", 3, None])
def test_the_attention_instances_on_the_tiles_are_f32_argmax_and_dense(end):
    """The attention steps' f32 instances (argmax and dense: the only ends
    the attention kernel has) run the 3xTF32 tiles; the pooled instances
    run them with every end, the stack step's None included; bf16 is
    mma_step's."""
    assert tf32x3_step(torch.float32, end, attention=True) is (end in ("argmax", "dense"))
    assert tf32x3_step(torch.float32, end) is True
    assert not tf32x3_step(torch.bfloat16, end, attention=True) and mma_step(torch.bfloat16, end)


@pytest.mark.parametrize("R,E,H,A,P,V", [(1, 8, 8, 8, 1, 1), (3, 8, 24, 16, 5, 40), (19, 16, 40, 40, 7, 77),
                                         (32, 512, 512, 512, 49, 9956), (64, 512, 512, 512, 49, 9956),
                                         (96, 512, 512, 512, 49, 9956), (192, 512, 512, 512, 49, 9956)])
def test_f32_attention_items_cover_every_output_once(R, E, H, A, P, V):
    """mma_tiles(..., (A, P), dtype=float32): the layers' items (16 gate
    columns x 32 rows) and the projection's items (64 vocabulary rows x 32
    rows) cover each output once; the layers' K split takes stack_tiles' S
    for the 2E-wide layer 0 and the H-wide ones, whose parts cover each
    layer's 16-column chunks once and in order; shared memory is the staged
    sums', A1's 8 rows of h, or the f32 A2's P weights and four warps'
    f64 sums of 128 columns of E."""
    g = mma_tiles(R, 2 * E, H, V, (A, P), dtype=torch.float32)
    slabs = -(-R // SLAB)
    assert g.smem == max(fused_step.MMA_SMEM, 4 * 8 * H, 4 * P + 8 * 4 * 128)
    assert (g.layer0_chunks, g.upper_chunks, g.vocab_chunks) == (-(-2 * E // 16) + -(-H // 16), 2 * -(-H // 16),
                                                                  -(-H // 16))
    for items, width, rows in ((g.gate_items, H, 16), (g.vocab_items, V, 64)):
        assert items == slabs * -(-width // rows)
        covered = np.zeros((R, width), np.int64)
        for item in range(items):
            n0, c0 = (item % slabs) * SLAB, (item // slabs) * rows
            covered[n0:n0 + SLAB, c0:c0 + rows] += 1
        assert (covered == 1).all()
    split = stack_tiles(R, 2 * E, H, SMS, dtype=torch.float32)
    assert split.items == g.gate_items and split.chunks == (g.layer0_chunks, g.upper_chunks)
    for n_chunks, S in zip(split.chunks, split.splits):
        runs = [c for p in range(S) for c in range(p * n_chunks // S, (p + 1) * n_chunks // S)]
        assert runs == list(range(n_chunks))


def test_f32_attention_flagship_geometry():
    """At the flagship (2E = 1024, H = 512): S = 8 at B <= 32, 4 at 64, 2
    at R = 96, 1 at R = 192, for layer 0 and the layers above alike; 96
    chunks in layer 0, 64 above, 32 in the projection; H = 8,192 (A1's 8
    rows of h: 262,144 bytes) is refused in f32 as in bf16; the context's
    item width agrees with the kernel's."""
    src = open(os.path.join(CSRC, "fused_attn_step.cu")).read()
    assert "kCtxCols = 32 * 4;" in src and fused_step.ATTN_CTX_COLS == 32 * 4
    assert [stack_tiles(R, 1024, 512, SMS, dtype=torch.float32).splits for R in (1, 32, 64, 96, 192)] == [
        (8, 8), (8, 8), (4, 4), (2, 2), (1, 1)]
    assert mma_tiles(32, 1024, 512, 9956, (512, 49), dtype=torch.float32) == (32, 156, 96, 64, 32, 33792)
    assert mma_tiles(192, 1024, 512, 9956, (512, 49), dtype=torch.float32) == (192, 936, 96, 64, 32, 33792)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="needs 262144 bytes"):
            mma_tiles(64, 1024, 8192, 9956, (512, 49), dtype=dtype)
