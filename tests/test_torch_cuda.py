"""The port's CUDA kernels against their plain twins, on an NVIDIA GPU:
the pooled fused step and the fused attention step (each with its GRU and
its LSTM instance; greedy, and the beam forms: dense logits, and top-k for
the pooled step), the stack steps, the whole greedy decode (bit-equal to
the per-step kernel's loop), the attention context, the projection +
argmax, the projection + top-k, the image preprocess and the fused s2d
stem; the f32 encode without TF32; and one f32 train step on the card
against the same step on the CPU.  The bf16 instances on the tensor
cores (the dense steps and the greedy steps, pooled and attention, GRU
and LSTM; the whole decode) are also held bit for bit to each other, and
the ones that keep the SIMT code (f32) to the SIMT ends.

Marked ``cuda``: each test skips where torch finds no CUDA device (the
kernels have no CPU or interpret mode).  Run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda``; chip_smoke.py runs
the same comparison at the flagship widths.
"""

import numpy as np
import pytest
import torch

from show_tell_tpu_torch.ops.attention import attention_context, attention_context_plain
from show_tell_tpu_torch.ops.fused_attn import (
    fused_attn_decode_step,
    fused_attn_decode_step_plain,
    fused_attn_dense_step,
    fused_attn_dense_step_plain,
    fused_attn_lstm_decode_step,
    fused_attn_lstm_dense_step,
)
from show_tell_tpu_torch.ops.fused_step import (
    fused_gru_decode_step,
    fused_gru_decode_step_cuda,
    fused_gru_decode_step_plain,
    fused_lstm_decode_step,
    fused_lstm_decode_step_plain,
)
from show_tell_tpu_torch.ops.fused_beam import (
    fused_dense_step,
    fused_dense_step_plain,
    fused_gru_dense_step,
    fused_gru_topk_step,
    fused_lstm_dense_step,
    fused_lstm_topk_step,
    fused_topk_step,
    fused_topk_step_plain,
)
from show_tell_tpu_torch.ops.preprocess import preprocess_u8, preprocess_u8_plain
from show_tell_tpu_torch.ops import stream_arg
from show_tell_tpu_torch.ops.rnn import (
    greedy_decode_kernel,
    gru_stack_step,
    gru_stack_step_cuda,
    lstm_stack_step,
    lstm_stack_step_cuda,
    prepare_rnn_weights,
    stack_plain,
)
from show_tell_tpu_torch.ops.s2d_stem import space_to_depth
from show_tell_tpu_torch.ops.stem import prepare_stem, stem_fused, stem_fused_plain
from show_tell_tpu_torch.ops.whole_decode import gru_whole_greedy_decode
from show_tell_tpu_torch.ops.vocab import (
    first_max_argmax,
    prepare_vocab,
    project_argmax,
    project_argmax_plain,
    project_logits,
    project_topk,
    project_topk_plain,
    vocab_tiles,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, E, H, V, L, dtype, device, seed=0, gates=3):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.uniform(-0.3, 0.3, s).astype(np.float32))
    G = gates * H
    layers = [{"w_ih": t(G, E if l == 0 else H), "w_hh": t(G, H), "b_ih": t(G), "b_hh": t(G)} for l in range(L)]
    stacked = {k: v.to(device) for k, v in prepare_rnn_weights(layers, dtype).items()}
    vocab = {k: v.to(device) for k, v in prepare_vocab(t(V, H), t(V), dtype).items()}
    x = torch.from_numpy(rng.randn(B, E).astype(np.float32)).to(device, dtype)
    hs = torch.from_numpy(rng.uniform(-1, 1, (L, B, H)).astype(np.float32)).to(device, dtype)
    return stacked, vocab, x, hs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,E,H,V,L", [(3, 16, 24, 40, 2), (19, 64, 128, 1001, 3), (1, 256, 512, 9956, 5),
                                       (5, 32, 16, 40, 2), (64, 1024, 512, 9956, 5)])
def test_kernel_matches_plain(cuda, dtype, B, E, H, V, L):
    stacked, vocab, x, hs = _inputs(B, E, H, V, L, dtype, cuda)
    before = fused_gru_decode_step.launches
    tok, new_hs = fused_gru_decode_step(stacked, vocab, x, hs)
    torch.cuda.synchronize()
    assert fused_gru_decode_step.launches == before + 1
    ref_tok, ref_hs = fused_gru_decode_step_plain(stacked, vocab, x, hs)
    tol = 1e-5 if dtype == torch.float32 else 2e-2  # summation order; one bf16 ulp in h'
    torch.testing.assert_close(new_hs.float(), ref_hs.float(), rtol=tol, atol=tol)
    logits = ref_hs[-1].float() @ vocab["w"].float().T + vocab["b"].float()
    top = logits.topk(2, dim=-1).values
    clear = (top[:, 0] - top[:, 1]) > (1e-4 if dtype == torch.float32 else 5e-2)
    assert torch.equal(tok[clear], ref_tok[clear])


def test_kernel_tie_takes_lowest_index(cuda):
    stacked, vocab, x, hs = _inputs(33, 16, 24, 1000, 2, torch.float32, cuda, seed=1)
    vocab["w"][900] = vocab["w"][7]
    vocab["b"][7] = vocab["b"][900] = 50.0
    tok, _ = fused_gru_decode_step(stacked, vocab, x, hs)
    assert tok.tolist() == [7] * 33


def test_kernel_wrapper_rejects_what_it_does_not_take(cuda):
    stacked, vocab, x, hs = _inputs(3, 16, 24, 40, 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_gru_decode_step(stacked, vocab, x, hs.half())
    with pytest.raises(ValueError, match="dtype"):
        fused_gru_decode_step(stacked, vocab, x, hs.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        fused_gru_decode_step_cuda(stacked, vocab, x[:, :8].contiguous(), hs)  # x narrower than layer 0
    with pytest.raises(ValueError, match="contiguous"):
        fused_gru_decode_step(stacked, vocab, x, hs.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="is on"):
        fused_gru_decode_step(stacked, vocab, x.cpu(), hs)


TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 5e-2)}  # (values: summation order / one bf16 ulp, token gap)


def _clear(logits, gap):
    top = logits.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]) > gap


def _attn_prep(B, E, H, A, P, V, L, dtype, device, seed=0, gates=3):
    rng = np.random.RandomState(seed)
    t = lambda *s, b=0.3: torch.from_numpy(rng.uniform(-b, b, s).astype(np.float32))
    G = gates * H
    layers = [{"w_ih": t(G, 2 * E if l == 0 else H), "w_hh": t(G, H), "b_ih": t(G), "b_hh": t(G)} for l in range(L)]
    d = lambda x: x.to(device, dtype).contiguous()
    prep = {
        "stacked": {k: d(v) for k, v in prepare_rnn_weights(layers).items()},
        "vocab": {k: d(v) for k, v in prepare_vocab(t(V, H), t(V)).items()},
        "wdec": d(t(A, H)), "bdec": d(t(A)), "wfull": d(t(A)), "b_emb": d(t(E)),
        "att1": d(t(B, P, A, b=1.0)), "feats_e": d(t(B, P, E, b=1.0)),
    }
    return prep, d(torch.from_numpy(rng.randn(B, E).astype(np.float32))), d(t(L, B, H, b=1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,E,H,A,P,V,L", [(3, 16, 24, 16, 5, 40, 1), (19, 64, 128, 32, 7, 1001, 3),
                                           (64, 512, 512, 512, 49, 9956, 5)])
def test_fused_attn_kernel_matches_plain(cuda, dtype, B, E, H, A, P, V, L):
    prep, w_emb, hs = _attn_prep(B, E, H, A, P, V, L, dtype, cuda)
    before = fused_attn_decode_step.launches
    tok, new_hs = fused_attn_decode_step(prep, w_emb, hs)
    torch.cuda.synchronize()
    assert fused_attn_decode_step.launches == before + 1
    ref_tok, ref_hs = fused_attn_decode_step_plain(prep, w_emb, hs)
    tol, gap = TOL[dtype]
    torch.testing.assert_close(new_hs.float(), ref_hs.float(), rtol=tol, atol=tol)
    clear = _clear(ref_hs[-1].float() @ prep["vocab"]["w"].float().T + prep["vocab"]["b"].float(), gap)
    assert torch.equal(tok[clear], ref_tok[clear])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,C,A,H,P", [(3, 32, 16, 24, 5), (1, 2048, 512, 512, 49), (64, 2048, 512, 512, 49),
                                       (256, 2048, 512, 512, 49)])
def test_attention_context_kernel_matches_plain(cuda, dtype, B, C, A, H, P):
    """ctx within the values' tolerance, alpha (f32 in both) within 1e-6."""
    prep, _, hs = _attn_prep(B, 8, H, A, P, 40, 1, dtype, cuda, seed=2)
    feats = torch.rand(B, P, C, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    before = attention_context.launches
    ctx, alpha = attention_context(prep, feats, prep["att1"], hs[-1])
    torch.cuda.synchronize()
    assert attention_context.launches == before + 1 and ctx.dtype == dtype and alpha.dtype == torch.float32
    ref_ctx, ref_alpha = attention_context_plain(prep, feats, prep["att1"], hs[-1])
    tol = TOL[dtype][0]
    torch.testing.assert_close(ctx.float(), ref_ctx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(alpha, ref_alpha, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,V", [(3, 24, 40), (1, 512, 9956), (19, 512, 1001), (19, 24, 1001), (64, 512, 9956),
                                   (256, 512, 9956)])
def test_project_argmax_kernel_matches_plain(cuda, dtype, B, H, V):
    """B = 1, 19 (not a multiple of 8), 64, 256; V = 1,001, a multiple of
    no V-tile; H = 24, a multiple of 8 but not of the mma's 16."""
    prep, _, hs = _attn_prep(B, 8, H, 8, 1, V, 1, dtype, cuda, seed=4)
    before = project_argmax.launches
    tok = project_argmax(prep["vocab"], hs[-1])
    torch.cuda.synchronize()
    assert project_argmax.launches == before + 1
    logits = hs[-1].float() @ prep["vocab"]["w"].float().T + prep["vocab"]["b"].float()
    clear = _clear(logits, TOL[dtype][1])
    assert torch.equal(tok[clear], project_argmax_plain(prep["vocab"], hs[-1])[clear])


def test_project_argmax_and_fused_attn_ties_take_lowest_index(cuda):
    prep, w_emb, hs = _attn_prep(33, 16, 24, 16, 5, 1000, 2, torch.float32, cuda, seed=5)
    prep["vocab"]["w"][900] = prep["vocab"]["w"][7]
    prep["vocab"]["b"][7] = prep["vocab"]["b"][900] = 50.0
    assert project_argmax(prep["vocab"], hs[-1]).tolist() == [7] * 33
    assert fused_attn_decode_step(prep, w_emb, hs)[0].tolist() == [7] * 33


def _cell_state(hs, seed):
    """A cell state unlike hs (values in [-2, 2]), so reading one for the other shows."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(hs.shape, generator=g) * 4 - 2).to(hs.device, hs.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,E,H,V,L", [(3, 16, 24, 40, 2), (19, 64, 128, 1001, 3), (1, 512, 512, 9956, 5),
                                       (5, 32, 16, 40, 2), (64, 512, 512, 9956, 5), (512, 512, 512, 9956, 5)])
def test_lstm_kernel_matches_plain(cuda, dtype, B, E, H, V, L):
    """The pooled step's LSTM instance: new hs and cs within the values'
    tolerance, tokens equal where the top-2 logit gap is clear."""
    stacked, vocab, x, hs = _inputs(B, E, H, V, L, dtype, cuda, gates=4)
    cs = _cell_state(hs, 1)
    before = fused_lstm_decode_step.launches
    tok, (new_hs, new_cs) = fused_lstm_decode_step(stacked, vocab, x, (hs, cs))
    torch.cuda.synchronize()
    assert fused_lstm_decode_step.launches == before + 1 and new_cs.dtype == dtype
    ref_tok, (ref_hs, ref_cs) = fused_lstm_decode_step_plain(stacked, vocab, x, (hs, cs))
    tol, gap = TOL[dtype]
    torch.testing.assert_close(new_hs.float(), ref_hs.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(new_cs.float(), ref_cs.float(), rtol=tol, atol=tol)
    clear = _clear(ref_hs[-1].float() @ vocab["w"].float().T + vocab["b"].float(), gap)
    assert torch.equal(tok[clear], ref_tok[clear])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,E,H,A,P,V,L", [(3, 16, 24, 16, 5, 40, 1), (19, 64, 128, 32, 7, 1001, 3),
                                           (64, 512, 512, 512, 49, 9956, 5)])
def test_fused_attn_lstm_kernel_matches_plain(cuda, dtype, B, E, H, A, P, V, L):
    prep, w_emb, hs = _attn_prep(B, E, H, A, P, V, L, dtype, cuda, gates=4)
    cs = _cell_state(hs, 2)
    before = fused_attn_lstm_decode_step.launches
    tok, (new_hs, new_cs) = fused_attn_lstm_decode_step(prep, w_emb, (hs, cs))
    torch.cuda.synchronize()
    assert fused_attn_lstm_decode_step.launches == before + 1
    ref_tok, (ref_hs, ref_cs) = fused_attn_decode_step_plain(prep, w_emb, (hs, cs))
    tol, gap = TOL[dtype]
    torch.testing.assert_close(new_hs.float(), ref_hs.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(new_cs.float(), ref_cs.float(), rtol=tol, atol=tol)
    clear = _clear(ref_hs[-1].float() @ prep["vocab"]["w"].float().T + prep["vocab"]["b"].float(), gap)
    assert torch.equal(tok[clear], ref_tok[clear])


def test_lstm_kernels_tie_takes_lowest_index(cuda):
    stacked, vocab, x, hs = _inputs(33, 16, 24, 1000, 2, torch.float32, cuda, seed=6, gates=4)
    vocab["w"][900] = vocab["w"][7]
    vocab["b"][7] = vocab["b"][900] = 50.0
    assert fused_lstm_decode_step(stacked, vocab, x, (hs, _cell_state(hs, 3)))[0].tolist() == [7] * 33
    prep, w_emb, hs = _attn_prep(33, 16, 24, 16, 5, 1000, 2, torch.float32, cuda, seed=7, gates=4)
    prep["vocab"]["w"][900] = prep["vocab"]["w"][7]
    prep["vocab"]["b"][7] = prep["vocab"]["b"][900] = 50.0
    assert fused_attn_lstm_decode_step(prep, w_emb, (hs, _cell_state(hs, 4)))[0].tolist() == [7] * 33


def test_lstm_wrappers_reject_a_bad_cell_state(cuda):
    stacked, vocab, x, hs = _inputs(3, 16, 24, 40, 2, torch.float32, cuda, gates=4)
    with pytest.raises(ValueError, match="cs has shape"):
        fused_lstm_decode_step(stacked, vocab, x, (hs, hs[:, :2].contiguous()))
    with pytest.raises(ValueError, match="cs has dtype"):
        fused_lstm_decode_step(stacked, vocab, x, (hs, hs.bfloat16()))
    with pytest.raises(ValueError, match=r"w_ih0 has shape \(72, 16\), expected \(96, 16\)"):  # GRU weights
        fused_lstm_decode_step(_inputs(3, 16, 24, 40, 2, torch.float32, cuda)[0], vocab, x, (hs, hs))


# The beam kernels.  Logits and top-k results are held against the plain
# projection of the kernel's own new top activation, which isolates the
# f32 summation order: rtol = atol = 1e-4; top-k ids equal on every row
# whose K+1 best logits are more than 1e-4 apart.  New states against the
# plain twin's: bf16 as the greedy tests; f32 within 2e-5, as at R=192 the
# attention step's f32 new_hs, through the softmax-weighted context and
# five layers, differs from cuBLAS's by up to 1.2e-5 (2 of 491,520 values
# above 1e-5 on an H100).
BEAM_TOL = 1e-4
BEAM_STATE_TOL = {torch.float32: 2e-5, torch.bfloat16: TOL[torch.bfloat16][0]}
# (R, E, H, V, L): R = B x K beam rows, not all multiples of 8 (nor of the bf16 dense tiles' 32-row slabs); H=24
# pads K to the tiles' 32; E=40 is not a multiple of 16; the last two at the flagship widths
BEAM_SHAPES = [(3, 16, 24, 40, 2), (5, 32, 16, 40, 2), (19, 64, 128, 1001, 3), (1, 40, 24, 77, 2),
               (65, 40, 24, 1001, 2), (64, 256, 512, 9956, 5), (192, 256, 512, 9956, 5)]


def _state(cell, hs, seed):
    return (hs, _cell_state(hs, seed)) if cell == "lstm" else hs


def _top(state):
    return (state[0] if isinstance(state, tuple) else state)[-1]


def _check_states(got, ref, dtype):
    tol = BEAM_STATE_TOL[dtype]
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        torch.testing.assert_close(g.float(), r.float(), rtol=tol, atol=tol)


def _check_topk(logp, ids, vocab, top, k):
    """(logp, ids) against the plain top-k of the projection of ``top``."""
    ref_logp, ref_ids = project_topk_plain(vocab, top, k)
    torch.testing.assert_close(logp, ref_logp, rtol=BEAM_TOL, atol=BEAM_TOL)
    best = project_logits(vocab, top).topk(min(k + 1, vocab["w"].shape[0]), dim=-1).values
    clear = (best[:, :-1] - best[:, 1:]).min(dim=1).values > BEAM_TOL
    assert torch.equal(ids[clear], ref_ids[clear])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("R,E,H,V,L", BEAM_SHAPES)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_fused_dense_step_kernel_matches_plain(cuda, cell, dtype, R, E, H, V, L):
    stacked, vocab, x, hs = _inputs(R, E, H, V, L, dtype, cuda, gates=4 if cell == "lstm" else 3)
    state = _state(cell, hs, 8)
    counter = fused_lstm_dense_step if cell == "lstm" else fused_gru_dense_step
    before = counter.launches
    logits, new_state = fused_dense_step(stacked, vocab, x, state)
    torch.cuda.synchronize()
    assert counter.launches == before + 1 and logits.dtype == torch.float32 and tuple(logits.shape) == (R, V)
    _check_states(new_state, fused_dense_step_plain(stacked, vocab, x, state)[1], dtype)
    torch.testing.assert_close(logits, project_logits(vocab, _top(new_state)), rtol=BEAM_TOL, atol=BEAM_TOL)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("R,E,H,V,L", BEAM_SHAPES + [(512, 256, 512, 9956, 5)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_fused_topk_step_kernel_matches_plain(cuda, cell, dtype, R, E, H, V, L, k):
    stacked, vocab, x, hs = _inputs(R, E, H, V, L, dtype, cuda, seed=k, gates=4 if cell == "lstm" else 3)
    state = _state(cell, hs, 9)
    counter = fused_lstm_topk_step if cell == "lstm" else fused_gru_topk_step
    before = counter.launches
    (logp, ids), new_state = fused_topk_step(stacked, vocab, x, state, k)
    torch.cuda.synchronize()
    assert counter.launches == before + 1 and ids.dtype == torch.int32 and tuple(ids.shape) == (R, k)
    _check_states(new_state, fused_topk_step_plain(stacked, vocab, x, state, k)[1], dtype)
    _check_topk(logp, ids, vocab, _top(new_state), k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("R,E,H,A,P,V,L", [(3, 16, 24, 16, 5, 40, 1), (19, 64, 128, 32, 7, 1001, 3),
                                           (1, 24, 24, 16, 5, 77, 2), (65, 40, 24, 32, 7, 1001, 2),
                                           (64, 512, 512, 512, 49, 9956, 5), (192, 512, 512, 512, 49, 9956, 5)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_fused_attn_dense_kernel_matches_plain(cuda, cell, dtype, R, E, H, A, P, V, L):
    prep, w_emb, hs = _attn_prep(R, E, H, A, P, V, L, dtype, cuda, gates=4 if cell == "lstm" else 3)
    state = _state(cell, hs, 10)
    counter = fused_attn_lstm_dense_step if cell == "lstm" else fused_attn_dense_step
    before = counter.launches
    logits, new_state = counter(prep, w_emb, state)
    torch.cuda.synchronize()
    assert counter.launches == before + 1 and tuple(logits.shape) == (R, V)
    _check_states(new_state, fused_attn_dense_step_plain(prep, w_emb, state)[1], dtype)
    torch.testing.assert_close(logits, project_logits(prep["vocab"], _top(new_state)), rtol=BEAM_TOL, atol=BEAM_TOL)


@pytest.mark.parametrize("k", [1, 3, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("R,H,V", [(3, 24, 40), (3, 512, 9956), (5, 512, 9956), (19, 512, 1001), (19, 24, 1001),
                                   (192, 512, 9956), (320, 512, 9956)])
def test_project_topk_kernel_matches_plain(cuda, dtype, R, H, V, k):
    prep, _, hs = _attn_prep(R, 8, H, 8, 1, V, 1, dtype, cuda, seed=11)
    before = project_topk.launches
    logp, ids = project_topk(prep["vocab"], hs[-1], k)
    torch.cuda.synchronize()
    assert project_topk.launches == before + 1
    _check_topk(logp, ids, prep["vocab"], hs[-1], k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,V", [(19, 512, 9956), (19, 24, 1001), (64, 512, 1001)])
def test_projection_kernels_tie_across_a_tile_boundary(cuda, dtype, B, H, V):
    """Columns mv - 1 and mv, on either side of the first V-tile boundary at
    the tile the bf16 kernels pick for this V, equal and top in every row:
    argmax gives mv - 1, top-k lists mv - 1 then mv."""
    mv = vocab_tiles(H, V, torch.cuda.get_device_properties(cuda).multi_processor_count).mv
    prep, _, hs = _attn_prep(B, 8, H, 8, 1, V, 1, dtype, cuda, seed=14)
    vocab = prep["vocab"]
    vocab["w"][mv] = vocab["w"][mv - 1]
    vocab["b"][mv - 1] = vocab["b"][mv] = 50.0
    assert project_argmax(vocab, hs[-1]).tolist() == [mv - 1] * B
    for k in (2, 5):
        assert project_topk(vocab, hs[-1], k)[1][:, :2].tolist() == [[mv - 1, mv]] * B


def test_beam_kernels_order_ties_lower_index_first(cuda):
    """Columns 7 and 900 equal and top in every row: the top-k kernels list
    7 then 900, the dense kernels give them equal logits."""
    for cell in ("gru", "lstm"):
        stacked, vocab, x, hs = _inputs(21, 16, 24, 1000, 2, torch.float32, cuda, seed=12,
                                        gates=4 if cell == "lstm" else 3)
        vocab["w"][900] = vocab["w"][7]
        vocab["b"][7] = vocab["b"][900] = 50.0
        state = _state(cell, hs, 13)
        (_, ids), new_state = fused_topk_step(stacked, vocab, x, state, 3)
        assert ids[:, :2].tolist() == [[7, 900]] * 21
        assert project_topk(vocab, _top(new_state).contiguous(), 2)[1].tolist() == [[7, 900]] * 21
        logits, _ = fused_dense_step(stacked, vocab, x, state)
        assert torch.equal(logits[:, 7], logits[:, 900])


@pytest.mark.parametrize("lo,hi", [(63, 64), (5, 9955)])
@pytest.mark.parametrize("R", [21, 192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_topk_step_ties_across_vocab_items_list_the_lower_index_first(cuda, dtype, R, lo, hi):
    """Columns in two different 64-row vocabulary items (the bf16 top-k
    end's parts: the first item's last row and the second's first; the
    first item and the last), equal and top in every row: both cells list
    lo then hi, f32 and bf16."""
    for cell in ("gru", "lstm"):
        stacked, vocab, x, hs = _inputs(R, 256, 512, 9956, 5, dtype, cuda, seed=15, gates=4 if cell == "lstm" else 3)
        vocab["w"][hi] = vocab["w"][lo]
        vocab["b"][lo] = vocab["b"][hi] = 50.0
        (_, ids), _ = fused_topk_step(stacked, vocab, x, _state(cell, hs, 16), 3)
        assert ids[:, :2].tolist() == [[lo, hi]] * R


@pytest.mark.parametrize("V", [1001, 9956])
def test_bf16_dense_logits_tie_across_the_first_and_last_vocab_tiles(cuda, V):
    """Columns 5 (the first 64-row tile of the bf16 dense steps) and V - 2
    (the last) equal and top in every row: their logits are equal, and the
    first-max argmax of the logits is 5, for the pooled and the attention
    dense steps, both cells, R = 65 (a partial slab)."""
    R = 65
    for cell in ("gru", "lstm"):
        gates = 4 if cell == "lstm" else 3
        stacked, vocab, x, hs = _inputs(R, 40, 512, V, 2, torch.bfloat16, cuda, seed=15, gates=gates)
        prep, w_emb, ahs = _attn_prep(R, 40, 512, 32, 7, V, 2, torch.bfloat16, cuda, seed=16, gates=gates)
        runs = [(fused_dense_step, stacked, vocab, x, _state(cell, hs, 17)),
                (fused_attn_lstm_dense_step if cell == "lstm" else fused_attn_dense_step, prep, prep["vocab"], w_emb,
                 _state(cell, ahs, 18))]
        for step, weights, voc, inp, state in runs:
            voc["w"][V - 2] = voc["w"][5]
            voc["b"][5] = voc["b"][V - 2] = 50.0
            logits, _ = step(weights, voc, inp, state) if step is fused_dense_step else step(weights, inp, state)
            torch.cuda.synchronize()
            assert torch.equal(logits[:, 5], logits[:, V - 2])
            assert logits.argmax(dim=1).tolist() == [5] * R


@pytest.mark.parametrize("R,E,H,V,L", [(3, 16, 24, 40, 2), (65, 40, 24, 1001, 2), (192, 256, 512, 9956, 5)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_f32_dense_step_runs_the_simt_code(cuda, cell, R, E, H, V, L):
    """The f32 dense instances keep the SIMT code of the other ends: their new
    state is bit-equal to the stack step's and the top-k step's, and the
    first-max argmax of their logits is the greedy step's token on every row
    (the same per-column sums)."""
    stacked, vocab, x, hs = _inputs(R, E, H, V, L, torch.float32, cuda, seed=19, gates=4 if cell == "lstm" else 3)
    state = _state(cell, hs, 20)
    logits, new_state = fused_dense_step(stacked, vocab, x, state)
    stack = lstm_stack_step if cell == "lstm" else gru_stack_step
    greedy = fused_lstm_decode_step if cell == "lstm" else fused_gru_decode_step
    others = [stack(stacked, x, state)[1], fused_topk_step(stacked, vocab, x, state, 3)[1]]
    tok, greedy_state = greedy(stacked, vocab, x, state)
    torch.cuda.synchronize()
    for other in others + [greedy_state]:
        for a, b in zip(new_state if cell == "lstm" else (new_state,), other if cell == "lstm" else (other,)):
            assert torch.equal(a, b)
    assert torch.equal(first_max_argmax(logits), tok)


def test_beam_wrappers_reject_what_they_do_not_take(cuda):
    stacked, vocab, x, hs = _inputs(6, 16, 24, 40, 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="k=9"):
        fused_topk_step(stacked, vocab, x, hs, 9)
    with pytest.raises(ValueError, match="k=0"):
        project_topk(vocab, hs[-1], 0)
    small = {k: v[:4].contiguous() for k, v in vocab.items()}
    with pytest.raises(ValueError, match="V=4"):
        project_topk(small, hs[-1], 5)
    with pytest.raises(ValueError, match="contiguous"):
        fused_dense_step(stacked, vocab, x, hs.transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 224, 224, 3), (64, 224, 224, 3), (1, 112, 112, 12), (64, 112, 112, 12),
                                   (3, 100, 60, 3), (3, 50, 30, 12), (2, 3, 3, 3)])
def test_preprocess_kernel_bit_equal_to_plain(cuda, dtype, shape):
    """The kernel repeats the twin's arithmetic as PyTorch runs it on the
    card (x * float(1/255), - mean, / std, round to the dtype): bit for
    bit, at any shape (the last two leave a ragged end of 8 and 6 bytes)."""
    x = torch.from_numpy(np.random.RandomState(sum(shape)).randint(0, 256, shape, dtype=np.uint8)).to(cuda)
    before = preprocess_u8.launches
    got = preprocess_u8(x, dtype)
    torch.cuda.synchronize()
    assert preprocess_u8.launches == before + 1 and got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, preprocess_u8_plain(x, dtype))


def _stem_resnet(device, seed=0):
    """conv1 and bn1 as prepare_stem reads them, BN off the identity."""
    import types

    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return types.SimpleNamespace(
        conv1=types.SimpleNamespace(weight=t(rng.randn(64, 3, 7, 7) * 0.05)),
        bn1=types.SimpleNamespace(weight=t(rng.uniform(0.5, 1.5, 64)), bias=t(rng.uniform(-0.2, 0.2, 64)),
                                  running_mean=t(rng.uniform(-0.2, 0.2, 64)), running_var=t(rng.uniform(0.5, 1.5, 64))))


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "no_pool"])
@pytest.mark.parametrize("layout", ["s2d", "rgb"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 5])
def test_stem_kernel_matches_plain(cuda, B, dtype, layout, pool):
    """Against the twin, which sums the taps in the f32 kernel's order: f32
    within 1e-4 (the twin rounds each product, the kernel's FMA does not).
    bf16 within one bf16 ulp at every element, and bit-equal on at least
    99% of them: each product of a pixel and a bf16 weight is exact in f32,
    but the tensor cores add them in another order, so an f32 sum may
    round to the neighbouring bf16 value (below 2^-9, where a bf16 ulp is
    finer than that order's f32 differences around relu's zero, within
    2^-16)."""
    torch.backends.cudnn.allow_tf32 = False
    prepared = prepare_stem(_stem_resnet(cuda), dtype)
    rgb = torch.from_numpy(np.random.RandomState(B).randint(0, 256, (B, 224, 224, 3), dtype=np.uint8)).to(cuda)
    x = space_to_depth(rgb).contiguous() if layout == "s2d" else rgb
    before = stem_fused.launches
    got = stem_fused(x, prepared, pool)
    torch.cuda.synchronize()
    assert stem_fused.launches == before + 1 and got.dtype == dtype
    ref = stem_fused_plain(x, prepared, pool)
    assert got.shape == ref.shape == ((B, 56, 56, 64) if pool else (B, 112, 112, 64))
    if dtype == torch.bfloat16:
        g, r = got.float(), ref.float()
        ulp = torch.ldexp(torch.ones_like(g), torch.frexp(torch.maximum(g.abs(), r.abs())).exponent - 8)
        gap = (g - r).abs()
        equal = (got == ref).float().mean().item()
        assert bool((gap <= torch.clamp(ulp, min=2.0 ** -16)).all()), "largest gap %g" % gap.max().item()
        assert equal >= 0.99, "bit-equal on %.6f of the elements" % equal
    else:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_stem_and_preprocess_wrappers_reject_what_they_do_not_take(cuda):
    prepared = prepare_stem(_stem_resnet(cuda), torch.float32)
    x = torch.zeros(2, 112, 112, 12, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        stem_fused(x.transpose(1, 2), prepared)
    with pytest.raises(ValueError, match="stem tc"):
        stem_fused(x, dict(prepared, tc=prepared["tc"].to(torch.bfloat16)))
    with pytest.raises(ValueError, match="uint8"):
        stem_fused(torch.zeros(2, 112, 112, 3, dtype=torch.uint8, device=cuda), prepared)
    with pytest.raises(ValueError, match="contiguous"):
        preprocess_u8(torch.zeros(2, 8, 8, 3, dtype=torch.uint8, device=cuda).transpose(1, 2), torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        preprocess_u8(torch.zeros(2, 8, 8, 3, dtype=torch.uint8, device=cuda), torch.float16)


def test_staged_s2d_batches_on_the_card(cuda, tmp_path):
    """Captioner.stage copies a host batch through pinned memory on the
    side stream and hands back the copy's event; a staged batch, a host
    batch and the same pixels in the s2d layout caption alike (one stem
    launch a request), and caption_paths, whose worker thread stages
    batch k+1 while batch k is captioned, equals its serial run."""
    from PIL import Image

    from show_tell_tpu_torch.data.transforms import host_space_to_depth
    from show_tell_tpu_torch.models.captioner import CaptionerConfig, init_captioner
    from show_tell_tpu_torch.serve import Captioner, caption_paths
    from show_tell_tpu_torch.vocab import DatasetVocabulary

    torch.backends.cudnn.allow_tf32 = False
    vocab = DatasetVocabulary()
    for i, w in enumerate(["<pad>", "<start>", "<end>", "<unk>"] + ["w%d" % i for i in range(36)]):
        vocab.word_to_index[w], vocab.index_to_word[i] = i, w
    cfg = CaptionerConfig("gru", 18, 16, 24, len(vocab), 1)
    params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(3))
    cap = Captioner(params, bn_state, cfg, vocab, "float32", device=cuda, s2d=True)
    rgb = np.random.RandomState(3).randint(0, 256, (4, 224, 224, 3), dtype=np.uint8)
    staged = cap.stage(rgb)
    assert staged.ready is not None and staged.images.device.type == "cuda"
    before = stem_fused.launches
    ids = cap.caption_ids(staged)
    assert stem_fused.launches == before + 1
    assert np.array_equal(staged.images.cpu().numpy(), rgb)
    assert np.array_equal(cap.caption_ids(rgb), ids) and np.array_equal(cap.caption_ids(host_space_to_depth(rgb)), ids)

    for i in range(5):
        Image.fromarray(np.random.RandomState(i).randint(0, 256, (40, 56, 3), dtype=np.uint8)).save(
            str(tmp_path / ("img%d.jpg" % i)))
    paths = sorted(str(p) for p in tmp_path.iterdir())
    out = list(caption_paths(cap, paths, 2))
    assert [p for p, _ in out] == paths and out == list(caption_paths(cap, paths, 2, overlap=False))


def _greedy_prepared(B, E, H, V, L, dtype, device, seed=0):
    """prepare_greedy's dict of random weights, and f32 features [B, E]."""
    stacked, vocab, _, _ = _inputs(B, E, H, V, L, dtype, device, seed=seed)
    rng = np.random.RandomState(seed + 1)
    emb = torch.from_numpy(rng.randn(V, E).astype(np.float32)).to(device, dtype)
    return {"stacked": stacked, "vocab": vocab, "embedding": emb}, torch.from_numpy(
        rng.randn(B, E).astype(np.float32)).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,E,H,V,L,T", [(3, 16, 24, 40, 2, 7), (19, 64, 128, 1001, 3, 9), (5, 32, 16, 40, 2, 6),
                                         (65, 40, 24, 1001, 2, 6), (1, 256, 512, 9956, 5, 25),
                                         (64, 256, 512, 9956, 5, 25)])
def test_whole_decode_kernel_bit_equal_to_the_step_loop(cuda, dtype, B, E, H, V, L, T):
    """One launch for all T steps, ids equal bit for bit to T launches of the
    fused step with index_select between them (in bf16 both on the tensor
    cores, in f32 both SIMT); greedy_decode_kernel takes it under
    whole_decode=True."""
    prepared, feats = _greedy_prepared(B, E, H, V, L, dtype, cuda)
    before = gru_whole_greedy_decode.launches, fused_gru_decode_step.launches
    whole = gru_whole_greedy_decode(prepared, feats, T)
    loop = greedy_decode_kernel(prepared, feats, T, whole_decode=False)
    torch.cuda.synchronize()
    assert (gru_whole_greedy_decode.launches, fused_gru_decode_step.launches) == (before[0] + 1, before[1] + T)
    assert whole.dtype == torch.int32 and tuple(whole.shape) == (B, T)
    assert torch.equal(whole, loop)
    assert torch.equal(greedy_decode_kernel(prepared, feats, T, whole_decode=True), whole)
    assert gru_whole_greedy_decode.launches == before[0] + 2


def test_whole_decode_kernel_tie_takes_lowest_index(cuda):
    prepared, feats = _greedy_prepared(33, 16, 24, 1000, 2, torch.float32, cuda, seed=2)
    vocab = prepared["vocab"]
    vocab["w"][900] = vocab["w"][7]
    vocab["b"][7] = vocab["b"][900] = 50.0
    assert gru_whole_greedy_decode(prepared, feats, 5).tolist() == [[7] * 5] * 33


def test_whole_decode_wrapper_rejects_what_it_does_not_take(cuda):
    prepared, feats = _greedy_prepared(3, 16, 24, 40, 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="T, V >= 1"):
        gru_whole_greedy_decode(prepared, feats, 0)
    with pytest.raises(ValueError, match="embedding"):
        gru_whole_greedy_decode(dict(prepared, embedding=prepared["embedding"][:, :8].contiguous()), feats, 3)
    with pytest.raises(ValueError, match="is on"):
        gru_whole_greedy_decode(dict(prepared, embedding=prepared["embedding"].cpu()), feats, 3)
    lstm, _ = _greedy_prepared(3, 16, 24, 40, 2, torch.float32, cuda)
    lstm["stacked"] = _inputs(3, 16, 24, 40, 2, torch.float32, cuda, gates=4)[0]
    with pytest.raises(ValueError, match="GRU"):
        gru_whole_greedy_decode(lstm, feats, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,E,H,L", [(3, 16, 24, 2), (19, 64, 128, 3), (5, 32, 16, 1), (1, 256, 512, 5),
                                     (64, 512, 512, 5), (512, 256, 512, 5)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stack_step_kernels_match_plain(cuda, cell, dtype, B, E, H, L):
    stacked, _, x, hs = _inputs(B, E, H, 8, L, dtype, cuda, gates=3 if cell == "gru" else 4)
    state = (hs, (hs * 2).contiguous()) if cell == "lstm" else hs
    step = lstm_stack_step if cell == "lstm" else gru_stack_step
    before = step.launches
    top, new_state = step(stacked, x, state)
    torch.cuda.synchronize()
    assert step.launches == before + 1
    _, ref_state = stack_plain(cell)(stacked, x, state)
    # f32: summation order, up to 1.6e-5 against cuBLAS's at B=512 with these U(+-0.3) weights (gate sums of
    # 768 terms); bf16: one ulp of a state
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for got, ref in zip((new_state if cell == "lstm" else (new_state,)), (ref_state if cell == "lstm" else (ref_state,))):
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    new_hs = new_state[0] if cell == "lstm" else new_state
    assert torch.equal(top, new_hs[-1])


@pytest.mark.parametrize("B", [1, 3, 33, 64, 512])
@pytest.mark.parametrize("E,L", [(256, 1), (256, 5), (768, 5)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_bf16_stack_step_on_the_tensor_cores(cuda, cell, E, L, B):
    """The bf16 stack step (tensor cores, K split across S blocks by
    stack_tiles at small B) against its plain twin within 2e-2 at H=512,
    E != H; two launches on the same inputs bit-identical (the S parts are
    added in order whatever their arrival); the arrival counters back at
    zero; and every forced S = 1 .. MAX_SPLITS within 2e-2 of the twin."""
    from show_tell_tpu_torch.ops import fused_step

    H = 512
    stacked, _, x, hs = _inputs(B, E, H, 8, L, torch.bfloat16, cuda, seed=B + E + L, gates=3 if cell == "gru" else 4)
    state = (hs, (hs * 2).contiguous()) if cell == "lstm" else hs
    step = lstm_stack_step_cuda if cell == "lstm" else gru_stack_step_cuda
    _, ref_state = stack_plain(cell)(stacked, x, state)
    unpack = lambda st: st if cell == "lstm" else (st,)
    tiles = fused_step.stack_tiles(B, E, H, torch.cuda.get_device_properties(cuda).multi_processor_count)
    runs = {S: step(stacked, x, state, splits=S)[1] for S in range(1, fused_step.MAX_SPLITS + 1)}
    first, again = step(stacked, x, state)[1], step(stacked, x, state)[1]
    torch.cuda.synchronize()
    for a, b, forced in zip(unpack(first), unpack(again), unpack(runs[tiles.splits[1]])):
        assert torch.equal(a, b)
        if tiles.splits[0] == tiles.splits[1]:
            assert torch.equal(a, forced)  # the rule's S, forced, is the rule's launch
    for S, got in runs.items():
        for g, r in zip(unpack(got), unpack(ref_state)):
            torch.testing.assert_close(g.float(), r.float(), rtol=2e-2, atol=2e-2, msg=lambda m: "S=%d: %s" % (S, m))
    counters = fused_step.arrival_counters(x.device, tiles.items)  # the wrapper's: the device of its tensors
    assert int(counters.abs().sum()) == 0


def test_stack_step_split_arguments_are_checked(cuda):
    """A forced S outside 1 .. MAX_SPLITS, or any S for f32, raises before
    the launch; the kernel refuses an S the scratch does not hold."""
    from show_tell_tpu_torch.ops import build, fused_step

    stacked, _, x, hs = _inputs(1, 256, 512, 8, 2, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="1 to 8 parts"):
        gru_stack_step_cuda(stacked, x, hs, splits=9)
    s32, _, x32, hs32 = _inputs(1, 256, 512, 8, 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="bf16 stack step only"):
        gru_stack_step_cuda(s32, x32, hs32, splits=2)
    lib = build.load_library()
    new_hs = torch.empty_like(hs)
    partial = torch.empty(32 * 4 * fused_step.MMA_PART, dtype=torch.float32, device=cuda)
    counters = fused_step.arrival_counters(x.device, 32)
    args = lambda s0, parts: (1, x.data_ptr(), stacked["w_ih0"].data_ptr(), stacked["w_ihU"].data_ptr(),
                              stacked["w_hh"].data_ptr(), stacked["b_ih"].data_ptr(), stacked["b_hh"].data_ptr(),
                              hs.data_ptr(), new_hs.data_ptr(), partial.data_ptr(), counters.data_ptr(), 2, 1, 256,
                              512, s0, 1, parts, stream_arg(x.device))
    assert lib.st_gru_stack_step(*args(4, 32 * 3)) != 0  # 32 items x 4 parts need 128
    assert lib.st_gru_stack_step(*args(4, 32 * 4)) == 0
    torch.cuda.synchronize()
    assert int(counters.abs().sum()) == 0


def test_stack_step_wrappers_reject_what_they_do_not_take(cuda):
    stacked, _, x, hs = _inputs(3, 16, 24, 8, 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gru_stack_step(stacked, x, hs.half())
    with pytest.raises(ValueError, match="shape"):
        gru_stack_step(stacked, x[:, :8].contiguous(), hs)
    lstacked = _inputs(3, 16, 24, 8, 2, torch.float32, cuda, gates=4)[0]
    with pytest.raises(ValueError, match="cs"):
        lstm_stack_step(lstacked, x, (hs, hs[:1].contiguous()))


def test_f32_encode_runs_without_tf32_and_leaves_the_global(cuda):
    """With torch.backends.cudnn.allow_tf32 at its default (True), an f32
    Captioner's encode equals an encode with TF32 off (relative 1e-5), not
    one in TF32, and the global is still True afterwards."""
    from show_tell_tpu_torch.models.captioner import CaptionerConfig, build_model, encode, init_captioner

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        cfg = CaptionerConfig("gru", 18, 16, 24, 40, 1)
        params, bn_state = init_captioner(cfg, torch.Generator().manual_seed(5))
        model = build_model(params, bn_state, cfg, torch.float32, cuda)
        images = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (4, 224, 224, 3), dtype=np.uint8)).to(cuda)
        with torch.inference_mode():
            got = encode(model, images)
            assert torch.backends.cudnn.allow_tf32 is True
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                exact = model.encoder.encode_u8(images)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
                tf32 = model.encoder.encode_u8(images)
        scale = exact.abs().max().item()
        assert (got - exact).abs().max().item() <= 1e-5 * scale
        assert (tf32 - exact).abs().max().item() > 1e-5 * scale
    finally:
        torch.backends.cudnn.allow_tf32 = saved


# The bf16 greedy steps on the tensor cores (csrc/dense_mma.cuh): the pooled step's argmax instances and the
# attention step's, both cells, at the flagship widths (pooled GRU E = 256, the others E = H = A = 512, P = 49,
# V = 9,956, L = 5).  Tokens may differ from the SIMT code's where the top-2 logit gap is under 5e-2 (bf16
# near-ties).
TC_GREEDY = ["pooled gru", "pooled lstm", "attention gru", "attention lstm"]


def _tc_greedy(family, B, dtype, device, seed=21):
    """(step, plain twin, its arguments, vocab) of one tensor-core greedy family."""
    if family == "pooled gru":
        stacked, vocab, x, hs = _inputs(B, 256, 512, 9956, 5, dtype, device, seed=seed)
        return fused_gru_decode_step, fused_gru_decode_step_plain, (stacked, vocab, x, hs), vocab
    if family == "pooled lstm":
        stacked, vocab, x, hs = _inputs(B, 512, 512, 9956, 5, dtype, device, seed=seed, gates=4)
        args = (stacked, vocab, x, _state("lstm", hs, seed))
        return fused_lstm_decode_step, fused_lstm_decode_step_plain, args, vocab
    cell = family.split()[1]
    gates = 4 if cell == "lstm" else 3
    prep, w_emb, hs = _attn_prep(B, 512, 512, 512, 49, 9956, 5, dtype, device, seed=seed, gates=gates)
    step = fused_attn_lstm_decode_step if cell == "lstm" else fused_attn_decode_step
    return step, fused_attn_decode_step_plain, (prep, w_emb, _state(cell, hs, seed)), prep["vocab"]


@pytest.mark.parametrize("B", [1, 19, 64, 65, 512])
@pytest.mark.parametrize("family", TC_GREEDY)
def test_bf16_greedy_tensor_core_steps_match_plain(cuda, family, B):
    step, plain, args, vocab = _tc_greedy(family, B, torch.bfloat16, cuda)
    before = step.launches
    tok, new_state = step(*args)
    torch.cuda.synchronize()
    assert step.launches == before + 1 and tok.dtype == torch.int32 and tuple(tok.shape) == (B,)
    ref_tok, ref_state = plain(*args)
    tol, gap = TOL[torch.bfloat16]
    for g, r in zip(new_state if isinstance(new_state, tuple) else (new_state,),
                    ref_state if isinstance(ref_state, tuple) else (ref_state,)):
        torch.testing.assert_close(g.float(), r.float(), rtol=tol, atol=tol)
    clear = _clear(project_logits(vocab, _top(ref_state)), gap)
    assert torch.equal(tok[clear], ref_tok[clear])


@pytest.mark.parametrize("lo,hi", [(63, 64), (5, 9954)], ids=["across-two-items", "first-and-last-tiles"])
@pytest.mark.parametrize("family", TC_GREEDY)
def test_bf16_greedy_tie_across_vocab_items_takes_the_lower_index(cuda, family, lo, hi):
    """Two vocabulary rows equal and top in every row, in two 64-row items
    (63 and 64; 5 and V - 2 in the first and last): the lower index, at
    B = 65 (a partial slab), as the plain twin."""
    step, plain, args, vocab = _tc_greedy(family, 65, torch.bfloat16, cuda, seed=22)
    vocab["w"][hi] = vocab["w"][lo]
    vocab["b"][lo] = vocab["b"][hi] = 50.0
    assert step(*args)[0].tolist() == [lo] * 65
    assert plain(*args)[0].tolist() == [lo] * 65


@pytest.mark.parametrize("family", TC_GREEDY)
def test_bf16_greedy_tensor_core_steps_are_deterministic(cuda, family):
    """Two launches on the same inputs: equal tokens and states, bit for
    bit, whatever order the blocks' atomics land in."""
    step, _, args, _ = _tc_greedy(family, 64, torch.bfloat16, cuda, seed=23)
    (tok1, state1), (tok2, state2) = step(*args), step(*args)
    torch.cuda.synchronize()
    assert torch.equal(tok1, tok2)
    for a, b in zip(state1 if isinstance(state1, tuple) else (state1,),
                    state2 if isinstance(state2, tuple) else (state2,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B", [3, 65])
@pytest.mark.parametrize("family", TC_GREEDY)
def test_bf16_greedy_steps_run_the_tensor_core_code(cuda, family, B):
    """The four instances share the bf16 dense steps' tensor-core code: a
    new state bit-equal to the dense step's, and tokens equal to the
    first-max argmax of its logits (the same staged sums, the same bias)."""
    step, _, args, _ = _tc_greedy(family, B, torch.bfloat16, cuda, seed=24)
    if family.startswith("pooled"):
        dense = lambda: fused_dense_step(*args)
    else:
        dense_step = fused_attn_lstm_dense_step if family.endswith("lstm") else fused_attn_dense_step
        dense = lambda: dense_step(*args)
    (tok, state), (logits, dense_state) = step(*args), dense()
    torch.cuda.synchronize()
    for a, b in zip(state if isinstance(state, tuple) else (state,),
                    dense_state if isinstance(dense_state, tuple) else (dense_state,)):
        assert torch.equal(a, b)
    assert torch.equal(first_max_argmax(logits), tok)


@pytest.mark.parametrize("B,E,H,A,P,V,L", [(3, 16, 24, 16, 5, 40, 1), (65, 64, 128, 32, 7, 1001, 2),
                                           (64, 512, 512, 512, 49, 9956, 5)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_f32_attention_greedy_step_runs_the_simt_code(cuda, cell, B, E, H, A, P, V, L):
    """The f32 attention greedy instances keep the SIMT code: a new state
    bit-equal to the f32 dense step's, tokens the first-max argmax of its
    logits."""
    prep, w_emb, hs = _attn_prep(B, E, H, A, P, V, L, torch.float32, cuda, seed=26,
                                 gates=4 if cell == "lstm" else 3)
    state = _state(cell, hs, 27)
    greedy = fused_attn_lstm_decode_step if cell == "lstm" else fused_attn_decode_step
    dense = fused_attn_lstm_dense_step if cell == "lstm" else fused_attn_dense_step
    (tok, new_state), (logits, dense_state) = greedy(prep, w_emb, state), dense(prep, w_emb, state)
    torch.cuda.synchronize()
    for a, b in zip(new_state if cell == "lstm" else (new_state,), dense_state if cell == "lstm" else (dense_state,)):
        assert torch.equal(a, b)
    assert torch.equal(first_max_argmax(logits), tok)


@pytest.mark.parametrize("tf32_global", [False, True], ids=["tf32-off", "tf32-on"])
def test_f32_train_step_on_the_card_equals_the_cpu_step(cuda, tf32_global):
    """One f32 train step (flips from equal CPU generators) on the card and
    on the CPU from the same weights: the loss and every trainable
    gradient's norm within 1e-4 relative, the updated weights within 1e-4.
    With the global TF32 flags on (cuDNN's default), the step still runs
    in full f32 inside and leaves both flags as it found them."""
    from show_tell_tpu_torch.models.captioner import CaptionerConfig, init_captioner, trainable_parameters
    from show_tell_tpu_torch.train.train_step import create_train_state, make_train_step

    saved = (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = tf32_global
    torch.set_float32_matmul_precision("high" if tf32_global else "highest")
    try:
        for variant in ("gru", "attn_lstm"):
            cfg = CaptionerConfig(variant, 18, 16, 24, 40, 2, nos_filters=512, attn_dim=16)
            init = init_captioner(cfg, torch.Generator().manual_seed(3))
            rng = np.random.RandomState(4)
            images = rng.randint(0, 256, (4, 64, 64, 3), dtype=np.uint8)
            captions = rng.randint(4, 40, (4, 9)).astype(np.int32)
            lengths = np.array([9, 7, 5, 3], np.int32)
            out = {}
            for dev in ("cpu", "gpu"):
                ts = create_train_state(cfg, "SGD", 0.05, device=dev, init=init)
                loss = float(make_train_step(cfg)(ts, images, captions, lengths))
                params = trainable_parameters(ts.model)
                out[dev] = (loss, {n: p.grad.double().norm().item() for n, p in params.items() if p.grad is not None},
                            {n: p.detach().cpu() for n, p in params.items()})
            assert abs(out["gpu"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0]), (variant, out["gpu"][0], out["cpu"][0])
            for n, g in out["cpu"][1].items():
                assert abs(out["gpu"][1][n] - g) <= 1e-4 * g + 1e-7, (variant, n, out["gpu"][1][n], g)
                torch.testing.assert_close(out["gpu"][2][n], out["cpu"][2][n], rtol=1e-4, atol=1e-4)
            assert torch.backends.cudnn.allow_tf32 is tf32_global
            assert torch.backends.cuda.matmul.allow_tf32 is tf32_global
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


class _EvalVocab:
    def __init__(self, size):
        self.index_to_word = ["<pad>", "<start>", "<end>", "<unk>"] + ["w%d" % i for i in range(4, size)]
        self.word_to_index = {w: i for i, w in enumerate(self.index_to_word)}

    def start_token(self):
        return "<start>"

    def end_token(self):
        return "<end>"

    def __len__(self):
        return len(self.index_to_word)


def _eval_batches(V, seed=0):
    """Two batches of 8 and a tail of 3 (paths, uint8 images, captions, lengths), as the test loader yields them."""
    rng = np.random.RandomState(seed)
    out, n = [], 0
    for rows in (8, 8, 3):
        lengths = np.sort(rng.randint(4, 10, rows))[::-1].astype(np.int32).copy()
        caps = np.zeros((rows, 12), np.int32)
        for b in range(rows):
            caps[b, : lengths[b]] = rng.randint(4, V, lengths[b])
        out.append((tuple("img_%d.jpg" % (n + i) for i in range(rows)),
                    rng.randint(0, 256, (rows, 64, 64, 3), dtype=np.uint8), caps, lengths))
        n += rows
    return out


@pytest.mark.parametrize("variant", ["gru", "attn"])
def test_f32_test_model_on_the_card_equals_the_cpu_run(cuda, tmp_path, variant):
    """test_model (greedy, f32, no flips) from the same weights on the card
    (the fused greedy step kernels) and on the CPU (their plain twins):
    every score equal, the test loss within 1e-5 relative, the same
    captions; the decode kernel launched 25 times a batch."""
    import pickle

    from show_tell_tpu_torch.evaluation.tester import test_model
    from show_tell_tpu_torch.models.captioner import CaptionerConfig, init_captioner
    from show_tell_tpu_torch.train.train_step import create_train_state

    V = 40
    cfg = CaptionerConfig(variant, 18, 16, 24, V, 2, nos_filters=512, attn_dim=16)
    init = init_captioner(cfg, torch.Generator().manual_seed(5))
    step = fused_gru_decode_step if variant == "gru" else fused_attn_decode_step
    runs = {}
    for dev in ("cpu", "gpu"):
        out = tmp_path / dev
        out.mkdir()
        ts = create_train_state(cfg, "SGD", 0.01, device=dev, init=init)
        before = step.launches
        scores = test_model(ts, cfg, _eval_batches(V), _EvalVocab(V), {"output_dir": str(out), "eval_augment": 0})
        with open(out / "Candidate_Words_Dict.pickle", "rb") as f:
            runs[dev] = (scores, pickle.load(f), step.launches - before)
    (gpu, gpu_caps, gpu_launches), (cpu, cpu_caps, cpu_launches) = runs["gpu"], runs["cpu"]
    assert (gpu_launches, cpu_launches) == (3 * 25, 0)
    assert gpu_caps == cpu_caps
    for k in cpu:
        if k == "test_loss":
            assert abs(gpu[k] - cpu[k]) <= 1e-5 * abs(cpu[k]), (gpu[k], cpu[k])
        else:
            assert gpu[k] == cpu[k], (k, gpu[k], cpu[k])


@pytest.mark.parametrize("beam_size", [0, 3], ids=["greedy", "beam"])
@pytest.mark.parametrize("variant", ["gru", "attn"])
def test_eval_step_queues_without_a_device_sync(cuda, variant, beam_size):
    """test_model's step (flips, loss, decode) on a staged batch reads nothing
    on the host: under torch.cuda.set_sync_debug_mode("error") any sync raises."""
    from show_tell_tpu_torch.evaluation.tester import make_test_step
    from show_tell_tpu_torch.models.captioner import CaptionerConfig, init_captioner, prepare_decode
    from show_tell_tpu_torch.train.train_step import create_train_state

    cfg = CaptionerConfig(variant, 18, 16, 24, 40, 2, nos_filters=512, attn_dim=16)
    ts = create_train_state(cfg, "SGD", 0.01, device="gpu", init=init_captioner(cfg, torch.Generator().manual_seed(5)))
    _, images, captions, lengths = _eval_batches(40)[0]
    staged = [torch.from_numpy(a).to(cuda) for a in (images, captions, lengths)]
    step = make_test_step(cfg, beam_size, augment=True)
    prepared = prepare_decode(ts.model, torch.float32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, ids = step(ts, *staged, torch.Generator().manual_seed(1), prepared, int(lengths.max()))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ids.shape == (8, 25) and torch.isfinite(loss)
