"""The port's decode-step ops against the JAX package's, on the CPU.

The same seeded numpy inputs go through the JAX function (Pallas kernels
in interpret mode, as tests/test_pallas_ops.py runs them) and through the
port's plain twin, which is what a port wrapper runs for CPU tensors.
Sizes: L=2, E=16/24/32, H=24, V=40, B=3; the JAX side uses block_v=16 so V
spans three vocab blocks.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from show_tell_tpu.models.decoder import greedy_decode as jax_greedy_decode
from show_tell_tpu.models.rnn_cells import gru_cell as jax_gru_cell
from show_tell_tpu.models.rnn_cells import stack_step_gru as jax_stack_step_gru
from show_tell_tpu.ops.fused_step_pallas import fused_gru_decode_step_pallas
from show_tell_tpu.ops.rnn_pallas import prepare_rnn_weights as jax_prepare_rnn_weights
from show_tell_tpu.ops.vocab_pallas import prepare_vocab as jax_prepare_vocab
from show_tell_tpu_torch.ops import build, uses_kernel
from show_tell_tpu_torch.ops.fused_step import fused_gru_decode_step, fused_gru_decode_step_plain
from show_tell_tpu_torch.ops.rnn import greedy_decode_kernel, gru_cell_math, prepare_greedy, prepare_rnn_weights
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


def _torch_layer(layer):
    """A JAX-layout layer ({w_ih [in,3H], ...}) in the torch layout."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return {k: t(v.T) if v.ndim == 2 else t(v) for k, v in layer.items()}


def _torch_side(layers, linear):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return prepare_rnn_weights([_torch_layer(l) for l in layers]), prepare_vocab(t(linear["w"].T), t(linear["b"]))


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


@pytest.mark.parametrize("E", [16, 24, 32], ids=["E<H", "E=H", "E>H"])
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
    linear["w"][:, [5, 37]] = 0.0
    linear["w"][0, [5, 37]] = 0.25  # one weight: 50 + top[:, 0] / 4 rounds once, whatever order a BLAS sums in
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
    """Same values as the JAX package's stacked arrays, in the torch
    [out, in] layout the CUDA kernels stream, with layer 0 apart at its
    own width: w_ih0 [3H,E] is JAX's zero-padded layer 0 [H,3H] cut back to
    E rows and transposed, w_ihU [L-1,3H,H] and w_hh [L,3H,H] are JAX's
    [*,H,3H] transposed, b [L,3H] is JAX's [L,1,3H]."""
    layers, linear, _, _ = _jax_tree(16, seed=3)
    stacked, _ = _torch_side(layers, linear)
    j_stacked, _ = _jax_side(layers, linear)
    j_w_ih = np.asarray(j_stacked["w_ih"])
    assert tuple(stacked["w_ih0"].shape) == (3 * H, 16) and (j_w_ih[0, 16:] == 0).all()
    np.testing.assert_array_equal(stacked["w_ih0"].T.numpy(), j_w_ih[0, :16])
    assert tuple(stacked["w_ihU"].shape) == (L - 1, 3 * H, H) and stacked["w_ihU"].is_contiguous()
    np.testing.assert_array_equal(stacked["w_ihU"].transpose(1, 2).numpy(), j_w_ih[1:])
    assert tuple(stacked["w_hh"].shape) == (L, 3 * H, H) and stacked["w_hh"].is_contiguous()
    np.testing.assert_array_equal(stacked["w_hh"].transpose(1, 2).numpy(), np.asarray(j_stacked["w_hh"]))
    for k in ("b_ih", "b_hh"):
        np.testing.assert_array_equal(stacked[k][:, None, :].numpy(), np.asarray(j_stacked[k]))
    one = prepare_rnn_weights([_torch_layer(layers[0])])
    assert tuple(one["w_ihU"].shape) == (0, 3 * H, H)  # L=1: no upper layers


@pytest.mark.parametrize("end_token", [None, "emitted"], ids=["fixed_T", "early_exit"])
def test_embed_wider_than_hidden_decodes_like_jax_xla(end_token):
    """A pooled model with E=32 > H=24: layer 0 keeps its own width, so the
    fused step's greedy loop (plain twin on the CPU) serves it, with f32
    ids bit-equal to the JAX package's XLA decode (its only path for E > H)."""
    layers, linear, _, _ = _jax_tree(32, seed=6)
    rng = np.random.RandomState(6)
    embedding = rng.randn(V, 32).astype(np.float32)
    feats = rng.randn(B, 32).astype(np.float32)
    j_params = {"embedding": jnp.asarray(embedding), "linear": {k: jnp.asarray(v) for k, v in linear.items()},
                "rnn": [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]}
    dcfg = JaxDecoderConfig("gru", 32, H, V, L)
    fixed = np.asarray(jax_greedy_decode(j_params, dcfg, jnp.asarray(feats)))
    end = int(fixed[0, 2]) if end_token else None
    ref = np.asarray(jax_greedy_decode(j_params, dcfg, jnp.asarray(feats), end_token=end)) if end else fixed
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    prepared = prepare_greedy([_torch_layer(l) for l in layers], t(embedding), t(linear["w"].T), t(linear["b"]))
    ids = greedy_decode_kernel(prepared, t(feats), 25, end_token=end).numpy()
    np.testing.assert_array_equal(ids, ref)


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


def test_library_path_hashes_headers(monkeypatch, tmp_path):
    """Every source under csrc/ names the library: an edited shared header
    (*.cuh, *.h) gives a new path, so a stale library is never loaded;
    other files do not count."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    first = build.library_path()
    assert build._sources() == [str(csrc / "k.cu")]
    (csrc / "notes.txt").write_text("not a source\n")
    assert build.library_path() == first
    (csrc / "common.cuh").write_text("// v2\n")
    second = build.library_path()
    (csrc / "extra.h").write_text("// new\n")
    assert len({first, second, build.library_path()}) == 3
