"""The port's LSTM families (pooled LSTM, attention LSTM) against the JAX
package, on the CPU.

The same seeded weights (the JAX package's own init, across the bridge)
and numpy inputs go through the JAX functions (Pallas kernels in
interpret mode, as tests/test_pallas_ops.py runs them) and through the
port, whose kernel wrappers run their plain twins for CPU tensors.  f32
unless a test says otherwise.  Sizes: pooled B=3, E=16 (32 for E > H),
H=24, V=40, L=1 and 2; attention B=6, E=16, C=24, A=16, H=24 (40 for
H > 2E), V=37, P=5, T=7.  The JAX vocab kernels use block_v=16, so V spans
three vocab blocks.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from show_tell_tpu.models import captioner as jax_captioner
from show_tell_tpu.models.attention import AttnDecoderConfig as JaxAttnConfig
from show_tell_tpu.models.attention import _init_hidden as jax_init_hidden
from show_tell_tpu.models.attention import attn_greedy_decode as jax_attn_greedy_decode
from show_tell_tpu.models.attention import init_attn_decoder_params
from show_tell_tpu.models.convert import attn_decoder_params_from_torch, decoder_params_to_torch
from show_tell_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from show_tell_tpu.models.decoder import greedy_decode as jax_greedy_decode
from show_tell_tpu.models.decoder import init_decoder_params
from show_tell_tpu.models.rnn_cells import lstm_cell as jax_lstm_cell
from show_tell_tpu.models.rnn_cells import stack_step_lstm as jax_stack_step_lstm
from show_tell_tpu.ops.attention_pallas import attn_greedy_decode_pallas
from show_tell_tpu.ops.fused_attn_pallas import attn_greedy_decode_fused_pallas, fused_attn_decode_step_pallas
from show_tell_tpu.ops.fused_attn_pallas import prepare_attn_decode as jax_prepare_attn_decode
from show_tell_tpu.ops.fused_step_pallas import fused_lstm_decode_step_pallas
from show_tell_tpu.ops.rnn_pallas import greedy_decode_pallas
from show_tell_tpu.ops.rnn_pallas import prepare_rnn_weights as jax_prepare_rnn_weights
from show_tell_tpu.ops.vocab_pallas import prepare_vocab as jax_prepare_vocab
from show_tell_tpu.serve import Captioner as JaxCaptioner
from show_tell_tpu.train.checkpoint import create_checkpoint
from show_tell_tpu.train.train_step import TrainState
from show_tell_tpu.vocab.vocabulary import DatasetVocabulary, save_vocab
from show_tell_tpu_torch import serve as port_serve
from show_tell_tpu_torch.models import captioner as port_captioner
from show_tell_tpu_torch.models.attention import AttnDecoder, AttnDecoderConfig, attn_greedy_decode, init_hidden
from show_tell_tpu_torch.models.captioner import CaptionerConfig, CaptionerModel, build_model
from show_tell_tpu_torch.models.convert import decoder_from_jax, params_from_jax, params_to_jax
from show_tell_tpu_torch.models.decoder import Decoder, DecoderConfig, greedy_decode
from show_tell_tpu_torch.ops.attention import attn_greedy_decode_composite
from show_tell_tpu_torch.ops.fused_attn import (
    attn_greedy_decode_fused,
    fused_attn_lstm_decode_step,
    prepare_attn_decode,
    prepare_attn_weights,
)
from show_tell_tpu_torch.ops.fused_step import fused_lstm_decode_step
from show_tell_tpu_torch.ops.rnn import greedy_decode_kernel, lstm_cell_math, prepare_greedy, prepare_rnn_weights
from show_tell_tpu_torch.ops.vocab import prepare_vocab
from show_tell_tpu_torch.serve import Captioner

B, E, H, V = 3, 16, 24, 40  # pooled
AB, AC, AA, AV, P, T = 6, 24, 16, 37, 5, 7  # attention (E and H as above)
BLOCK_V = 16
CPU = torch.device("cpu")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _load(module, jax_decoder_params):
    """A port decoder module on the meta device, filled from a JAX decoder tree."""
    sd = {k: t(np.array(v)) for k, v in decoder_from_jax(jax.tree.map(np.asarray, jax_decoder_params)).items()}
    module.load_state_dict(sd, strict=True, assign=True)
    return module.eval()


def _pooled(L, E_=E, seed=0):
    """JAX pooled LSTM decoder params and config, the port's Decoder holding
    the same weights, and seeded features [B, E]."""
    jcfg = JaxDecoderConfig("lstm", E_, H, V, L)
    jparams = init_decoder_params(jax.random.PRNGKey(seed), jcfg)
    with torch.device("meta"):
        dec = Decoder(DecoderConfig(*jcfg))
    feats = np.random.RandomState(seed + 1).randn(B, E_).astype(np.float32)
    return jcfg, jparams, _load(dec, jparams), feats


def _attn(L, seed=3, H_=H):
    """JAX attention LSTM decoder params and config, the port's AttnDecoder
    holding the same weights, and seeded features [B, C, P]."""
    jcfg = JaxAttnConfig("lstm", E, AC, AA, H_, AV, L, max_caption_length=T)
    jparams = init_attn_decoder_params(jax.random.PRNGKey(seed), jcfg)
    with torch.device("meta"):
        dec = AttnDecoder(AttnDecoderConfig(*jcfg))
    feats = np.random.RandomState(seed + 1).randn(AB, AC, P).astype(np.float32)
    return jcfg, jparams, _load(dec, jparams), feats


def _cell_inputs(seed, Bc=16, I=32, Hc=32):
    rng = np.random.RandomState(seed)
    x, h = rng.randn(Bc, I).astype(np.float32), rng.uniform(-1, 1, (Bc, Hc)).astype(np.float32)
    c = rng.uniform(-2, 2, (Bc, Hc)).astype(np.float32)
    w = {"w_ih": rng.uniform(-0.3, 0.3, (I, 4 * Hc)).astype(np.float32),
         "w_hh": rng.uniform(-0.3, 0.3, (Hc, 4 * Hc)).astype(np.float32),
         "b_ih": rng.uniform(-0.3, 0.3, 4 * Hc).astype(np.float32),
         "b_hh": rng.uniform(-0.3, 0.3, 4 * Hc).astype(np.float32)}
    return x, h, c, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_cell_math_matches_jax(dtype):
    """h' and c' against the JAX lstm_cell with the same carry dtype: f32
    to summation order; bf16 bit-equal on >= 99% of values.  Taking tanh of
    the bf16-rounded c' instead of the f32 one (a plausible drift) agrees
    on far fewer, so the bf16 case pins the rule."""
    x, h, c, w = _cell_inputs(5)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    layer = {k: jnp.asarray(v, jd) for k, v in w.items()}
    jh, jc = jax_lstm_cell(layer, jnp.asarray(x, jd), (jnp.asarray(h, jd), jnp.asarray(c, jd)))
    tt = lambda a: t(a).to(td)
    args = (tt(x), tt(h), tt(c), tt(w["w_ih"].T), tt(w["w_hh"].T), tt(w["b_ih"]), tt(w["b_hh"]))
    th, tc = lstm_cell_math(*args, td, td)
    assert th.dtype == td and tc.dtype == td
    jh, jc = np.asarray(jh, np.float32), np.asarray(jc, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(th.numpy(), jh, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-5, atol=1e-6)
        return
    assert (th.float().numpy() == jh).mean() >= 0.99 and (tc.float().numpy() == jc).mean() >= 0.99
    Hc = h.shape[1]
    g = args[0].float() @ args[3].float().T + args[5].float() + args[1].float() @ args[4].float().T + args[6].float()
    i, f, gg, o = (torch.sigmoid(g[:, :Hc]), torch.sigmoid(g[:, Hc:2 * Hc]), torch.tanh(g[:, 2 * Hc:3 * Hc]),
                   torch.sigmoid(g[:, 3 * Hc:]))
    c_rounded = (f * args[2].float() + i * gg).to(td).float()
    wrong_h = (o * torch.tanh(c_rounded)).to(td)
    assert (wrong_h.float().numpy() == jh).mean() < 0.95


def _pooled_step_case(L, seed, E_=E):
    """JAX-layout LSTM layers (w_ih [in, 4H]) and projection, x, hs and cs."""
    rng = np.random.RandomState(seed)
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    layers = [{"w_ih": u(E_ if l == 0 else H, 4 * H), "w_hh": u(H, 4 * H), "b_ih": u(4 * H), "b_hh": u(4 * H)}
              for l in range(L)]
    linear = {"w": u(H, V), "b": u(V)}
    x = rng.randn(B, E_).astype(np.float32)
    hs, cs = rng.uniform(-1, 1, (L, B, H)).astype(np.float32), rng.uniform(-2, 2, (L, B, H)).astype(np.float32)
    return layers, linear, x, hs, cs


def _pooled_step_both(layers, linear, x, hs, cs):
    """(JAX tok, hs, cs) from the interpreted Pallas step and (port tok, (hs, cs)) from the wrapper."""
    jl = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    j_tok, (j_hs, j_cs) = fused_lstm_decode_step_pallas(
        jax_prepare_rnn_weights(jl), jax_prepare_vocab({k: jnp.asarray(v) for k, v in linear.items()}, block_v=BLOCK_V),
        jnp.asarray(x), jnp.asarray(hs), jnp.asarray(cs), block_v=BLOCK_V, interpret=True,
    )
    stacked = prepare_rnn_weights([{k: t(v.T) if v.ndim == 2 else t(v) for k, v in l.items()} for l in layers])
    vocab = prepare_vocab(t(linear["w"].T), t(linear["b"]))
    before = fused_lstm_decode_step.launches
    got = fused_lstm_decode_step(stacked, vocab, t(x), (t(hs), t(cs)))
    assert fused_lstm_decode_step.launches == before  # CPU tensors: the plain twin, not counted
    return (np.asarray(j_tok), np.asarray(j_hs), np.asarray(j_cs)), got


@pytest.mark.parametrize("L", [1, 2])
def test_fused_lstm_step_twin_matches_pallas_interpret(L):
    layers, linear, x, hs, cs = _pooled_step_case(L, seed=10 + L)
    (j_tok, j_hs, j_cs), (tok, (new_hs, new_cs)) = _pooled_step_both(layers, linear, x, hs, cs)
    assert tok.dtype == torch.int32 and tuple(new_hs.shape) == tuple(new_cs.shape) == (L, B, H)
    np.testing.assert_allclose(new_hs.numpy(), j_hs, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new_cs.numpy(), j_cs, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tok.numpy(), j_tok)
    # the JAX XLA stack step agrees too, hs and cs
    jl = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    _, (x_hs, x_cs) = jax_stack_step_lstm(jl, jnp.asarray(x), (jnp.asarray(hs), jnp.asarray(cs)))
    np.testing.assert_allclose(new_hs.numpy(), np.asarray(x_hs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new_cs.numpy(), np.asarray(x_cs), rtol=1e-5, atol=1e-5)


def test_fused_lstm_step_cross_block_tie_takes_lowest_index():
    """Columns 5 (vocab block 0) and 37 (block 2) are identical and the row
    maximum: both packages return 5, the first-max rule."""
    layers, linear, x, hs, cs = _pooled_step_case(2, seed=7)
    linear["w"][:, [5, 37]] = 0.0
    linear["w"][0, [5, 37]] = 0.25  # one weight: 50 + top[:, 0] / 4 rounds once, whatever order a BLAS sums in
    linear["b"][5] = linear["b"][37] = 50.0
    (j_tok, _, _), (tok, _) = _pooled_step_both(layers, linear, x, hs, cs)
    assert j_tok.tolist() == [5] * B and tok.tolist() == [5] * B


@pytest.mark.parametrize("end_token", [None, "emitted"], ids=["fixed_T", "early_exit"])
@pytest.mark.parametrize("L", [1, 2])
def test_pooled_lstm_greedy_bit_equal_to_jax(L, end_token):
    """f32 ids over T=25: the port's plain decoder against the JAX XLA
    decode, its fused-step loop (plain twin on the CPU) against the
    interpreted Pallas decode; early exit writes <pad> after <end>."""
    jcfg, jparams, dec, feats = _pooled(L, seed=20 + L)
    jf = jnp.asarray(feats)
    fixed = np.asarray(jax_greedy_decode(jparams, jcfg, jf))
    end = int(fixed[0, 2]) if end_token else None
    ref_xla = np.asarray(jax_greedy_decode(jparams, jcfg, jf, end_token=end)) if end else fixed
    ref_pallas = np.asarray(greedy_decode_pallas(jparams, jcfg, jf, interpret=True, end_token=end))
    with torch.inference_mode():
        plain = greedy_decode(dec, DecoderConfig(*jcfg), t(feats), end_token=end).numpy()
        prepared = prepare_greedy(dec.unit.layers(), dec.embeddings.weight, dec.linear.weight, dec.linear.bias)
        fused = greedy_decode_kernel(prepared, t(feats), 25, end_token=end).numpy()
    assert plain.shape == (B, 25) and plain.dtype == np.int32
    np.testing.assert_array_equal(plain, ref_xla)
    np.testing.assert_array_equal(fused, ref_pallas)
    if end is not None:
        for row, row_fixed in zip(plain, fixed):
            hits = np.flatnonzero(row == end)
            stop = hits[0] + 1 if len(hits) else 25
            np.testing.assert_array_equal(row[:stop], row_fixed[:stop])
            assert (row[stop:] == 0).all()


@pytest.mark.parametrize("end_token", [None, "emitted"], ids=["fixed_T", "early_exit"])
def test_pooled_lstm_embed_wider_than_hidden_decodes_like_jax_xla(end_token):
    """E=32 > H=24: layer 0 keeps its own width in the fused step, so its
    loop serves the model, with f32 ids bit-equal to the JAX XLA decode
    (the JAX package's only path for E > H)."""
    jcfg, jparams, dec, feats = _pooled(2, E_=32, seed=30)
    fixed = np.asarray(jax_greedy_decode(jparams, jcfg, jnp.asarray(feats)))
    end = int(fixed[0, 2]) if end_token else None
    ref = np.asarray(jax_greedy_decode(jparams, jcfg, jnp.asarray(feats), end_token=end)) if end else fixed
    with torch.inference_mode():
        prepared = prepare_greedy(dec.unit.layers(), dec.embeddings.weight, dec.linear.weight, dec.linear.bias)
        ids = greedy_decode_kernel(prepared, t(feats), 25, end_token=end).numpy()
    np.testing.assert_array_equal(ids, ref)


def test_pooled_lstm_bf16_decode_tracks_jax():
    """bf16 weights and carries, hs and cs both in bf16 from zeros: the
    fused-step loop's ids equal the JAX XLA decode's on >= 95% of positions
    (bf16 near-ties may move a token; carrying c in f32 would drift further)."""
    jcfg, jparams, dec, feats = _pooled(2, seed=40)
    ref = np.asarray(jax_greedy_decode(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams), jcfg,
                                       jnp.asarray(feats)))
    dec = dec.to(torch.bfloat16)
    with torch.inference_mode():
        prepared = prepare_greedy(dec.unit.layers(), dec.embeddings.weight, dec.linear.weight, dec.linear.bias)
        ids = greedy_decode_kernel(prepared, t(feats), 25).numpy()
    assert (ids == ref).mean() >= 0.95


def test_attn_lstm_init_hidden_matches_jax():
    """(hs0, cs0) in the compute dtype: init_h and init_c of the mean over positions, on every layer."""
    jcfg, jparams, dec, feats = _attn(2, seed=50)
    j_hs, j_cs = jax_init_hidden(jparams, jcfg, jnp.asarray(feats))
    with torch.inference_mode():
        hs, cs = init_hidden(dec, AttnDecoderConfig(*jcfg), t(feats))
    assert hs.is_contiguous() and cs.is_contiguous() and tuple(cs.shape) == (2, AB, H)
    np.testing.assert_allclose(hs.numpy(), np.asarray(j_hs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cs.numpy(), np.asarray(j_cs), rtol=1e-5, atol=1e-6)
    assert not np.allclose(hs.numpy(), cs.numpy())


@pytest.mark.parametrize("L", [1, 2])
def test_fused_attn_lstm_step_twin_matches_pallas(L):
    """One step from the same w_emb, hs and cs (cs far from hs, so reading
    c where h belongs would show): new hs and cs within 1e-5 of the
    interpreted fused Pallas step's LSTM cell, tokens equal."""
    jcfg, jparams, dec, feats = _attn(L, seed=60 + L)
    rng = np.random.RandomState(70 + L)
    w_emb = rng.randn(AB, E).astype(np.float32)
    hs = rng.uniform(-1, 1, (L, AB, H)).astype(np.float32)
    cs = rng.uniform(-3, 3, (L, AB, H)).astype(np.float32)
    feats_pm = np.ascontiguousarray(feats.transpose(0, 2, 1))
    j_prep = jax_prepare_attn_decode(jparams, jnp.asarray(feats_pm))
    j_tok, (j_hs, j_cs) = fused_attn_decode_step_pallas(
        j_prep, "lstm", jnp.asarray(w_emb), (jnp.asarray(hs), jnp.asarray(cs)), block_v=BLOCK_V, interpret=True
    )
    with torch.inference_mode():
        prep = prepare_attn_decode(prepare_attn_weights(dec), dec, t(feats_pm))
        before = fused_attn_lstm_decode_step.launches
        tok, (new_hs, new_cs) = fused_attn_lstm_decode_step(prep, t(w_emb), (t(hs), t(cs)))
    assert fused_attn_lstm_decode_step.launches == before
    np.testing.assert_allclose(new_hs.numpy(), np.asarray(j_hs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new_cs.numpy(), np.asarray(j_cs), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))


@pytest.mark.parametrize("end_token", [None, 2], ids=["fixed_T", "early_exit"])
@pytest.mark.parametrize("L", [1, 2])
def test_attn_lstm_decodes_bit_equal_to_jax(L, end_token):
    """f32 ids: the plain decode against attn_greedy_decode, the fused
    twin's against the interpreted attn_greedy_decode_fused_pallas, the
    composite's against the interpreted attn_greedy_decode_pallas."""
    jcfg, jparams, dec, feats = _attn(L)
    jf = jnp.asarray(feats)
    ref = np.asarray(jax_attn_greedy_decode(jparams, jcfg, jf, 1, end_token=end_token))
    ref_fused = np.asarray(attn_greedy_decode_fused_pallas(jparams, jcfg, jf, 1, interpret=True, end_token=end_token))
    ref_comp = np.asarray(attn_greedy_decode_pallas(jparams, jcfg, jf, 1, interpret=True, end_token=end_token))
    cfg = AttnDecoderConfig(*jcfg)
    with torch.inference_mode():
        weights = prepare_attn_weights(dec)
        plain = attn_greedy_decode(dec, cfg, t(feats), 1, end_token=end_token).numpy()
        fused = attn_greedy_decode_fused(weights, dec, cfg, t(feats), 1, end_token=end_token).numpy()
        comp = attn_greedy_decode_composite(weights, dec, cfg, t(feats), 1, end_token=end_token).numpy()
    assert plain.shape == (AB, T) and plain.dtype == np.int32
    np.testing.assert_array_equal(plain, ref)
    np.testing.assert_array_equal(fused, ref_fused)
    np.testing.assert_array_equal(comp, ref_comp)


@pytest.mark.parametrize("variant,H_,path", [("lstm", 24, "greedy_decode_kernel"),
                                             ("attn_lstm", 24, "attn_greedy_decode_fused"),
                                             ("attn_lstm", 40, "attn_greedy_decode_composite")],
                         ids=["pooled", "attn-H<=2E", "attn-H>2E"])
def test_captioner_lstm_dispatch(monkeypatch, variant, H_, path):
    """The pooled LSTM takes the fused step; the attention LSTM the fused
    step when H <= 2E and the composite path when H > 2E.  Either way the
    ids equal the JAX captioner's with its kernels (interpreted) on."""
    jcfg = jax_captioner.CaptionerConfig(variant, 18, E, H_, AV, 2, nos_filters=512, max_caption_length=T)
    params, state = jax.tree.map(np.asarray, jax_captioner.init_captioner(jax.random.PRNGKey(80), jcfg))
    images = np.random.RandomState(81).randn(2, 64, 64, 3).astype(np.float32)
    jp, js = jax.tree.map(jnp.asarray, (params, state))
    ref = np.asarray(jax_captioner.captioner_greedy_decode(jp, js, jcfg, jnp.asarray(images), use_pallas=True))
    import show_tell_tpu_torch.ops.attention as port_attention
    import show_tell_tpu_torch.ops.fused_attn as port_fused
    import show_tell_tpu_torch.ops.rnn as port_rnn

    taken = []
    for mod, name in ((port_rnn, "greedy_decode_kernel"), (port_fused, "attn_greedy_decode_fused"),
                      (port_attention, "attn_greedy_decode_composite")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _real=real, _name=name, **k: taken.append(_name) or _real(*a, **k))
    cfg = CaptionerConfig(*jcfg)
    model = build_model(params, state, cfg, torch.float32, CPU)
    with torch.inference_mode():
        ids = port_captioner.captioner_greedy_decode(model, cfg, t(images)).numpy()
    assert taken == [path]
    np.testing.assert_array_equal(ids, ref)


@pytest.mark.parametrize("variant", ["lstm", "attn_lstm"])
def test_lstm_bridge_round_trip_and_reference_keys(variant):
    """params_from_jax / params_to_jax invert each other on an LSTM tree
    (4H gate rows; init_c for the attention LSTM); the decoder's keys are
    the port module's, and the JAX package's torch loaders read them back
    into the same tree."""
    jcfg = jax_captioner.CaptionerConfig(variant, 18, E, H, V, 2, nos_filters=512)
    params, state = jax.tree.map(np.asarray, jax_captioner.init_captioner(jax.random.PRNGKey(90), jcfg))
    sds = params_from_jax(params, state)
    back_p, back_s = params_to_jax(sds)
    assert jax.tree.structure(back_p) == jax.tree.structure(params)
    assert jax.tree.structure(back_s) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves((back_p, back_s)), jax.tree.leaves((params, state))):
        np.testing.assert_array_equal(a, b)
    with torch.device("meta"):
        model = CaptionerModel(CaptionerConfig(*jcfg))
    assert sorted(model.decoder.state_dict()) == sorted(sds["decoder"])
    assert sorted(model.encoder.state_dict()) == sorted(sds["encoder"])
    assert sds["decoder"]["unit.weight_hh_l1"].shape == (4 * H, H)
    if variant == "attn_lstm":
        assert sds["decoder"]["init_c.weight"].shape == (H, 512)
        oracle = attn_decoder_params_from_torch(sds["decoder"], 2)
        assert jax.tree.structure(oracle) == jax.tree.structure(params["decoder"])
        for a, b in zip(jax.tree.leaves(oracle), jax.tree.leaves(params["decoder"])):
            np.testing.assert_array_equal(np.asarray(a), b)
    else:
        oracle = decoder_params_to_torch(params["decoder"])
        assert sorted(oracle) == sorted(sds["decoder"])
        for k, v in oracle.items():
            np.testing.assert_array_equal(sds["decoder"][k], v)


WORDS = ["a", "man", "dog", "on", "the", "with", "red", "bus", "plate", "of", "cat", "wave"]


@pytest.fixture(scope="module")
def lstm_checkpoints(tmp_path_factory):
    """Seeded tiny LSTM models (ResNet-18, E=16, H=24, L=2; the attention
    one with C=512, A=16) written as JAX-format pickles by the JAX
    package's own writer: {variant: (ckpt, vocab.pkl)}."""
    vocab = DatasetVocabulary()
    for w in ["<pad>", "<start>", "<end>", "<unk>"] + WORDS:
        vocab.add_new_word(w)
    out = {}
    for seed, variant in enumerate(["lstm", "attn_lstm"]):
        root = str(tmp_path_factory.mktemp("torch_%s_serve" % variant))
        cfg = jax_captioner.CaptionerConfig(variant, 18, E, H, len(vocab), 2, nos_filters=512, attn_dim=AA)
        params, bn_state = jax_captioner.init_captioner(jax.random.PRNGKey(100 + seed), cfg)
        rng = np.random.RandomState(100 + seed)
        bn_state = jax.tree.map(lambda v: v + rng.uniform(0.0, 0.3, v.shape).astype(np.float32), bn_state)
        trainable, frozen = jax_captioner.split_trainable(params)
        state = TrainState(trainable, frozen, bn_state, optax.adam(1e-3).init(trainable), jax.random.PRNGKey(1),
                           np.int32(0))
        ckpt = create_checkpoint(state, 1, 0, [], {"output_dir": root})
        vocab_path = os.path.join(root, "vocab.pkl")
        save_vocab(vocab, vocab_path)
        out[variant] = (ckpt, vocab_path)
    return out


@pytest.mark.parametrize("early_exit", [False, True], ids=["fixed_T", "early_exit"])
@pytest.mark.parametrize("variant", ["lstm", "attn_lstm"])
def test_lstm_captioner_from_jax_checkpoint_equals_jax(lstm_checkpoints, variant, early_exit):
    ckpt, vocab = lstm_checkpoints[variant]
    images = np.random.RandomState(110).randint(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    kw = dict(variant=variant, resnet_version=18, embed_dim=E, hidden_dim=H, num_layers=2,
              compute_dtype="float32", nos_filters=512, attn_dim=AA)
    ref = JaxCaptioner.from_checkpoint(ckpt, vocab, early_exit=early_exit, **kw)
    port = Captioner.from_checkpoint(ckpt, vocab, early_exit=early_exit, device="cpu", **kw)
    ids = port.caption_ids(images)
    assert ids.shape == (3, 25) and ids.dtype == np.int32
    np.testing.assert_array_equal(ids, ref.caption_ids(images))
    assert port.caption(images) == ref.caption(images)


@pytest.mark.parametrize("variant", ["lstm", "attn_lstm"])
def test_lstm_cli_captions_files(lstm_checkpoints, variant, tmp_path, capsys):
    from fixtures import build_mini_coco

    ckpt, vocab = lstm_checkpoints[variant]
    build_mini_coco(str(tmp_path / "data"))
    img_dir = str(tmp_path / "data" / "train2014")
    rc = port_serve.main([
        "--ckpt", ckpt, "--vocab", vocab, "--variant", variant, "--resnet_version", "18",
        "--embedding_length", str(E), "--num_hidden_units", str(H), "--num_layers", "2", "--attn_dim", str(AA),
        "--batch_size", "4", "--compute_dtype", "float32", "--device", "cpu", "--json", img_dir,
    ])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 8 and all('"caption"' in line for line in lines)
