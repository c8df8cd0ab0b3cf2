"""The attention context kernel's plan (csrc/attention_context.cu), on the CPU.

The kernel runs only on the card: one cooperative launch of three phases
with grid barriers between them.  Here its plan is re-enacted in numpy,
in f32, item by item and lane by lane:
- phase 1, att2 = h W_dec^T + b_dec: for the bf16 instance dense_mma.cuh's
  tensor-core tiles (mma_project: 64 rows of W_dec x 32 batch rows an
  item, each lane's 16-byte loads, the m16n8k16 fragments, K split over
  four warps and added in warp order; tests/test_torch_gate_tiles.py's
  re-enactment), for the f32 instance a warp per (row of W_dec, 8 batch
  rows), lanes over 4-column chunks of K, the warp's sum by a butterfly;
- phase 2, a block per row: warp w scores positions w, w + 4, ..., lanes
  over 16-byte chunks of A (8 values in bf16, 4 in f32), the warp's sum by
  a butterfly; warp 0's max and sum of exp over the row, alpha;
- phase 3, (row, 32 x 16 bytes of channels) items: warp w sums positions
  w, w + 4, ... of its lanes' channels in order, the four warps' sums are
  added in warp order.
Each plan is held to the plain twin (``attention_context_plain``) and to
the JAX package's attention_context_pallas in interpret mode, within
1e-5, at B = 1, 3, 33, P = 5, 49, C = 32, A = 16, H = 24; the item and
chunk geometry at the flagship widths (B = 1, 64, 256) to the kernel's
source and headers.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.ops.attention_pallas import attention_context_pallas
from show_tell_tpu_torch.ops import attention
from show_tell_tpu_torch.ops.attention import attention_context_plain
from test_torch_gate_tiles import LANES, SLAB, SLOTS, WARPS, tiled_logits

CSRC = os.path.join(os.path.dirname(attention.__file__), "..", "csrc")
SOURCE = open(os.path.join(CSRC, "attention_context.cu")).read()
BATCH = int(re.search(r"constexpr int kBatch = (\d+);", SOURCE).group(1))
BM = int(re.search(r"constexpr int kBM = (\d+);", open(os.path.join(CSRC, "decode_common.cuh")).read()).group(1))
ITEMSIZE = {"bf16": 2, "f32": 4}
C, A, H = 32, 16, 24


def vals(plan):
    """Values a lane's 16-byte load holds."""
    return 16 // ITEMSIZE[plan]


def ctx_cols(plan):
    """Channels a phase-3 item: a warp's 16-byte loads across one position (ctx_cols<T>)."""
    return 32 * vals(plan)


def warp_sum(v):
    """warp_sum of decode_common.cuh on lane values v [..., 32]: the xor butterfly, every lane's sum (lane 0's)."""
    v = v.astype(np.float32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[..., LANES ^ off]).astype(np.float32)
    return v[..., 0]


# ---------------------------------------------------------------- geometry


def test_constants_agree_with_the_source():
    assert BATCH == 16 and BM == 8 and WARPS == 4 and SLAB == 32 and SLOTS == 4
    assert "return 32 * (16 / static_cast<int>(sizeof(T)));" in SOURCE  # ctx_cols
    assert "size_t n = std::is_same<T, __nv_bfloat16>::value ? kMmaSmemFloats : 0;" in SOURCE
    assert "const size_t part = static_cast<size_t>(kWarps) * ctx_cols<T>();" in SOURCE
    # the phases and their two grid barriers, in order
    body = SOURCE[SOURCE.index("attention_context_kernel(Params p) {"):]
    order = [body.index(s) for s in ("att2_phase<T>", "grid.sync()", "score_phase<T>", "grid.sync();  // alpha",
                                     "context_phase<T>")]
    assert order == sorted(order)


# (B) -> (phase-1 items or tasks, phase-2 blocks, phase-3 items) at C=2048, P=49, A=H=512
@pytest.mark.parametrize("plan", ["bf16", "f32"])
@pytest.mark.parametrize("B", [1, 64, 256])
def test_flagship_items(B, plan):
    """Phase 1: ceil(B / 32) x 8 tensor-core items (bf16: W_dec read once per 32
    batch rows) or 512 x ceil(B / 8) warp tasks (f32); phase 2: B row blocks,
    each warp's 12-13 positions in one batch of loads; phase 3: B x 8 (bf16)
    or B x 16 (f32) items, so B=64 spreads over 512 blocks' worth of items and
    B=1 over eight or sixteen; shared memory: the larger phase's need."""
    Cf, P, Af = 2048, 49, 512
    att2_items = -(-B // SLAB) * -(-Af // (16 * SLOTS)) if plan == "bf16" else Af * -(-B // BM)
    assert att2_items == {("bf16", 1): 8, ("bf16", 64): 16, ("bf16", 256): 64, ("f32", 1): 512, ("f32", 64): 4096,
                          ("f32", 256): 16384}[plan, B]
    assert -(-P // WARPS) <= BATCH  # a warp's positions fit one batch: every load in flight at once
    chunks = -(-Cf // ctx_cols(plan))
    assert chunks == {"bf16": 8, "f32": 16}[plan]
    items = B * chunks
    covered = np.zeros((B, Cf), np.int64)
    for item in range(items):
        b, c0 = divmod(item, chunks)
        covered[b, c0 * ctx_cols(plan) : (c0 + 1) * ctx_cols(plan)] += 1
    assert (covered == 1).all()
    smem = max(WARPS * 64 * 33 if plan == "bf16" else 0, P, WARPS * ctx_cols(plan))
    assert smem == {"bf16": 8448, "f32": 512}[plan]


@pytest.mark.parametrize("P", [5, 49, 64, 65, 200])
def test_positions_go_to_warps_and_batches_once(P):
    """Warp w takes positions w, w + 4, ... in batches of kBatch: every position once, in order within a warp."""
    seen = []
    for w in range(WARPS):
        for q0 in range(w, P, WARPS * BATCH):
            seen += [q0 + j * WARPS for j in range(BATCH) if q0 + j * WARPS < P]
    assert sorted(seen) == list(range(P))


# ---------------------------------------------------------------- the plan, lane by lane


def att2_simt(h, wdec, bdec):
    """Phase 1, f32: a warp per (row a of W_dec, 8 batch rows); lane l sums its chunks
    k = 4l + 128 i in order, the warp by a butterfly."""
    B, Hd = h.shape
    Ad = wdec.shape[0]
    att2 = np.full((B, Ad), np.nan, np.float32)
    for task in range(Ad * -(-B // BM)):
        a, b0 = task % Ad, task // Ad * BM
        for b in range(b0, min(b0 + BM, B)):
            part = np.zeros(32, np.float32)
            for lane in LANES:
                for k in range(4 * lane, Hd, 128):
                    for i in range(4):
                        part[lane] = np.float32(part[lane] + wdec[a, k + i] * h[b, k + i])
            att2[b, a] = np.float32(warp_sum(part) + bdec[a])
    return att2


def alpha_plan(att1, att2, wfull, n):
    """Phase 2: each row's scores (warp w: positions w, w + 4, ...; lanes over chunks
    of n values, k = n l + 32 n i), then warp 0's softmax: [B, P] f32."""
    B, P, Ad = att1.shape
    alpha = np.full((B, P), np.nan, np.float32)
    for b in range(B):
        e = np.zeros(P, np.float32)
        for q in range(P):
            part = np.zeros(32, np.float32)
            for lane in LANES:
                for k in range(n * lane, Ad, 32 * n):
                    v = att1[b, q, k : k + n] + att2[b, k : k + n]
                    for x, w in zip(np.where(v >= 0, v, np.float32(0.2) * v), wfull[k : k + n]):
                        part[lane] = np.float32(part[lane] + x * w)
            e[q] = warp_sum(part)
        m = e.max()
        part = np.zeros(32, np.float32)
        for q in range(P):  # lane q % 32, in order
            part[q % 32] = np.float32(part[q % 32] + np.exp(e[q] - m))
        alpha[b] = np.exp(e - m) / warp_sum(part)
    return alpha


def context_plan(feats, alpha, n):
    """Phase 3: (row, 32 n channels) items; warp w sums positions w, w + 4, ... of
    its lanes' n channels each in order; the four warps added in warp order.
    Returns ctx [B, C] and how many times each element was written."""
    B, P, Cd = feats.shape
    cols = 32 * n
    ctx = np.full((B, Cd), np.nan, np.float32)
    writes = np.zeros((B, Cd), np.int64)
    chunks = -(-Cd // cols)
    for item in range(B * chunks):
        b, c0 = item // chunks, item % chunks * cols
        live = min(cols, Cd - c0)  # lanes past C load nothing
        part = np.zeros((WARPS, cols), np.float32)
        for w in range(WARPS):
            for q in range(w, P, WARPS):
                part[w, :live] = part[w, :live] + alpha[b, q] * feats[b, q, c0 : c0 + live]
        tot = part[0]
        for w in range(1, WARPS):
            tot = tot + part[w]
        ctx[b, c0 : c0 + live] = tot[:live]
        writes[b, c0 : c0 + live] += 1
    return ctx, writes


def _case(B, P, seed):
    rng = np.random.RandomState(seed)
    u = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    return {"wdec": u(A, H) * 0.3, "bdec": u(A) * 0.3, "wfull": u(A) * 0.5}, u(B, P, C), u(B, P, A), u(B, H)


_JAX = {}


def _jax_ref(B, P, seed):
    if (B, P, seed) not in _JAX:
        w, feats, att1, h = _case(B, P, seed)
        params = {"decoder_att": {"w": jnp.asarray(w["wdec"].T), "b": jnp.asarray(w["bdec"])},
                  "full_att": {"w": jnp.asarray(w["wfull"][:, None])}}
        ctx, alpha = attention_context_pallas(params, jnp.asarray(feats), jnp.asarray(att1), jnp.asarray(h),
                                              block_b=B, interpret=True)
        _JAX[B, P, seed] = np.asarray(ctx), np.asarray(alpha)
    return _JAX[B, P, seed]


@pytest.mark.parametrize("plan", ["bf16", "f32"])
@pytest.mark.parametrize("P", [5, 49])
@pytest.mark.parametrize("B", [1, 3, 33])
def test_plan_matches_plain_and_pallas(B, P, plan):
    """Each instance's plan, run in f32: every ctx element written once; ctx
    and alpha within 1e-5 of the plain twin and of the interpreted Pallas
    kernel (which keeps b_full out too)."""
    seed = 7 * B + P
    w, feats, att1, h = _case(B, P, seed)
    if plan == "bf16":
        att2 = tiled_logits(h, w["wdec"], w["bdec"])
    else:
        att2 = att2_simt(h, w["wdec"], w["bdec"])
    alpha = alpha_plan(att1, att2, w["wfull"], vals(plan))
    ctx, writes = context_plan(feats, alpha, vals(plan))
    assert (writes == 1).all()
    t = torch.from_numpy
    ref_ctx, ref_alpha = attention_context_plain({k: t(v) for k, v in w.items()}, t(feats), t(att1), t(h))
    j_ctx, j_alpha = _jax_ref(B, P, seed)
    for got, ref in ((ctx, ref_ctx.numpy()), (alpha, ref_alpha.numpy()), (ctx, j_ctx), (alpha, j_alpha)):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
