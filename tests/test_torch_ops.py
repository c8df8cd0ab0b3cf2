"""The port's decode-step ops against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX function (Pallas kernels
in interpret mode, as tests/test_pallas_ops.py runs them) and through the
port's plain twin, which is what a port wrapper runs for CPU tensors.
Sizes: L=2, E=16/24, H=24, V=40, B=3; the JAX side uses block_v=16 so V
spans three vocab blocks.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.models.rnn_cells import gru_cell as jax_gru_cell
from show_tell_tpu.models.rnn_cells import stack_step_gru as jax_stack_step_gru
from show_tell_tpu.ops.fused_step_pallas import fused_gru_decode_step_pallas
from show_tell_tpu.ops.rnn_pallas import prepare_rnn_weights as jax_prepare_rnn_weights
from show_tell_tpu.ops.vocab_pallas import prepare_vocab as jax_prepare_vocab
from show_tell_tpu_torch.ops import build, uses_kernel
from show_tell_tpu_torch.ops.fused_step import fused_gru_decode_step, fused_gru_decode_step_plain
from show_tell_tpu_torch.ops.rnn import gru_cell_math, prepare_rnn_weights
from show_tell_tpu_torch.ops.vocab import prepare_vocab

L, H, V, B = 2, 24, 40, 3
BLOCK_V = 16


def _jax_tree(E, seed=0):
    """JAX-layout decoder weights: rnn layers (w_ih [in,3H]) and linear (w [H,V])."""
    rng = np.random.RandomState(seed)
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    layers = [
        {"w_ih": u(E if l == 0 else H, 3 * H), "w_hh": u(H, 3 * H), "b_ih": u(3 * H), "b_hh": u(3 * H)}
        for l in range(L)
    ]
    linear = {"w": u(H, V), "b": u(V)}
    x = rng.randn(B, E).astype(np.float32)
    hs = rng.randn(L, B, H).astype(np.float32)
    return layers, linear, x, hs


def _torch_side(layers, linear):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    tl = [{k: t(v.T) if v.ndim == 2 else t(v) for k, v in l.items()} for l in layers]
    return prepare_rnn_weights(tl), prepare_vocab(t(linear["w"].T), t(linear["b"]))


def _jax_side(layers, linear):
    jl = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    jlin = {k: jnp.asarray(v) for k, v in linear.items()}
    return jax_prepare_rnn_weights(jl), jax_prepare_vocab(jlin, block_v=BLOCK_V)


@pytest.mark.parametrize("E", [16, 24], ids=["E<H", "E=H"])
def test_fused_step_plain_matches_pallas_interpret(E):
    layers, linear, x, hs = _jax_tree(E, seed=E)
    stacked, vocab = _torch_side(layers, linear)
    j_stacked, j_vocab = _jax_side(layers, linear)
    j_tok, j_hs = fused_gru_decode_step_pallas(
        j_stacked, j_vocab, jnp.asarray(x), jnp.asarray(hs), block_v=BLOCK_V, interpret=True
    )
    tok, new_hs = fused_gru_decode_step_plain(stacked, vocab, torch.from_numpy(x), torch.from_numpy(hs))
    assert tok.dtype == torch.int32 and tuple(new_hs.shape) == (L, B, H)
    np.testing.assert_allclose(new_hs.numpy(), np.asarray(j_hs), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))


@pytest.mark.parametrize("E", [16, 24], ids=["E<H", "E=H"])
def test_fused_step_plain_matches_xla_stack_step(E):
    layers, linear, x, hs = _jax_tree(E, seed=100 + E)
    stacked, vocab = _torch_side(layers, linear)
    jl = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    top, j_hs = jax_stack_step_gru(jl, jnp.asarray(x), jnp.asarray(hs))
    j_tok = jnp.argmax(jnp.dot(top, linear["w"]) + linear["b"], axis=-1)
    tok, new_hs = fused_gru_decode_step_plain(stacked, vocab, torch.from_numpy(x), torch.from_numpy(hs))
    np.testing.assert_allclose(new_hs.numpy(), np.asarray(j_hs), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))


def test_fused_step_cross_block_tie_takes_lowest_index():
    """Columns 5 (vocab block 0) and 37 (block 2) are identical and the
    row maximum: both packages must return 5, the first-max rule."""
    layers, linear, x, hs = _jax_tree(16, seed=7)
    linear["w"][:, 37] = linear["w"][:, 5]
    linear["b"][5] = linear["b"][37] = 50.0
    stacked, vocab = _torch_side(layers, linear)
    j_stacked, j_vocab = _jax_side(layers, linear)
    j_tok, _ = fused_gru_decode_step_pallas(
        j_stacked, j_vocab, jnp.asarray(x), jnp.asarray(hs), block_v=BLOCK_V, interpret=True
    )
    tok, _ = fused_gru_decode_step_plain(stacked, vocab, torch.from_numpy(x), torch.from_numpy(hs))
    assert np.asarray(j_tok).tolist() == [5] * B
    assert tok.tolist() == [5] * B


def test_prepare_rnn_weights_matches_jax():
    """Same stacked arrays as the JAX package, in the torch [out, in]
    layout the CUDA kernel streams: w [L,3H,H] is JAX's [L,H,3H]
    transposed (layer 0 zero-padded the same way), b [L,3H] is JAX's [L,1,3H]."""
    layers, linear, _, _ = _jax_tree(16, seed=3)
    stacked, _ = _torch_side(layers, linear)
    j_stacked, _ = _jax_side(layers, linear)
    for k in ("w_ih", "w_hh"):
        assert tuple(stacked[k].shape) == (L, 3 * H, H) and stacked[k].is_contiguous()
        np.testing.assert_array_equal(stacked[k].transpose(1, 2).numpy(), np.asarray(j_stacked[k]))
    for k in ("b_ih", "b_hh"):
        np.testing.assert_array_equal(stacked[k][:, None, :].numpy(), np.asarray(j_stacked[k]))


def test_prepare_rnn_weights_rejects_embed_wider_than_hidden():
    """E > H has no kernel layout (layer 0 is padded up to H, never cut)."""
    layers, _, _, _ = _jax_tree(32, seed=6)
    tl = [{k: torch.from_numpy(np.ascontiguousarray(v.T)) for k, v in l.items()} for l in layers]
    with pytest.raises(ValueError, match="exceeds the hidden width"):
        prepare_rnn_weights(tl)


def test_prepare_vocab_matches_jax_unpadded():
    """The port keeps w [V,H] unpadded (the kernel masks the ragged end);
    its values are JAX's first V columns, whose padding carries -1e9."""
    layers, linear, _, _ = _jax_tree(16, seed=4)
    _, vocab = _torch_side(layers, linear)
    _, j_vocab = _jax_side(layers, linear)
    jw, jb = np.asarray(j_vocab["w"]), np.asarray(j_vocab["b"])
    assert jw.shape[1] == 48 and tuple(vocab["w"].shape) == (V, H)
    np.testing.assert_array_equal(vocab["w"].numpy().T, jw[:, :V])
    np.testing.assert_array_equal(vocab["b"].numpy(), jb[0, :V])
    assert (jb[0, V:] == -1e9).all() and (jw[:, V:] == 0).all()
    assert prepare_vocab(vocab["w"], vocab["b"], torch.bfloat16)["w"].dtype == torch.bfloat16


def test_gru_cell_bf16_carry_matches_jax():
    """bf16 carry: products summed and gates computed in f32, h' rounded
    to bf16 once.  Summation order may move h' by one bf16 ulp."""
    rng = np.random.RandomState(11)
    x, h = rng.randn(B, H).astype(np.float32), rng.randn(B, H).astype(np.float32)
    w_ih, w_hh = rng.uniform(-0.3, 0.3, (2, H, 3 * H)).astype(np.float32)
    b_ih, b_hh = rng.uniform(-0.3, 0.3, (2, 3 * H)).astype(np.float32)
    bf = jnp.bfloat16
    layer = {"w_ih": jnp.asarray(w_ih, bf), "w_hh": jnp.asarray(w_hh, bf),
             "b_ih": jnp.asarray(b_ih, bf), "b_hh": jnp.asarray(b_hh, bf)}
    ref = jax_gru_cell(layer, jnp.asarray(x, bf), jnp.asarray(h, bf))
    tb = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    got = gru_cell_math(tb(x), tb(h), tb(w_ih.T), tb(w_hh.T), tb(b_ih), tb(b_hh), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=1e-2, atol=1e-2)


def test_wrapper_runs_plain_twin_for_cpu_tensors_without_counting():
    layers, linear, x, hs = _jax_tree(16, seed=5)
    stacked, vocab = _torch_side(layers, linear)
    before = fused_gru_decode_step.launches
    tok, new_hs = fused_gru_decode_step(stacked, vocab, torch.from_numpy(x), torch.from_numpy(hs))
    ref_tok, ref_hs = fused_gru_decode_step_plain(stacked, vocab, torch.from_numpy(x), torch.from_numpy(hs))
    assert fused_gru_decode_step.launches == before
    assert torch.equal(tok, ref_tok) and torch.equal(new_hs, ref_hs)
    assert uses_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError):
        uses_kernel(torch.zeros(1, device="meta"))


def _isolate_build(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path / "empty_path"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    _isolate_build(monkeypatch, tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.load_library()


def test_build_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    _isolate_build(monkeypatch, tmp_path)
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\necho 'fused_gru_step.cu(1): error: made-up failure' >&2\nexit 1\n")
    os.chmod(fake, 0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    assert build.find_nvcc() == str(fake)
    with pytest.raises(build.KernelBuildError, match="made-up failure"):
        build.build()
    assert not os.listdir(tmp_path / "build")  # no partial library left behind
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
