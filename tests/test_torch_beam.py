"""The port's beam search against the JAX package's, on the CPU.

The same seeded weights (the JAX package's own init, across the bridge)
and numpy inputs go through the JAX functions (Pallas kernels in interpret
mode, as tests/test_beam.py runs them) and through the port, whose kernel
wrappers run their plain twins for CPU tensors.  f32.  Sizes: pooled B=4,
E=16 (32 for E > H), H=24, V=40, L=2, T=9; attention B=3, E=16, C=24,
A=16, H=24 (40 for H > 2E), V=37, P=5, T=7.  The JAX vocab kernels called
directly use block_v=16, so V spans three vocab blocks.  Beam ids must be
bit-equal to the JAX package's; the JAX package's tests hold its own
routes (XLA, sparse projection, fused dense, fused top-k, early exit) to
one another, so each port route is held to its XLA route.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from show_tell_tpu.decode.beam import _rnn_state_helpers as jax_rnn_state_helpers
from show_tell_tpu.decode.beam import attn_beam_search_decode as jax_attn_beam
from show_tell_tpu.decode.beam import beam_search_decode as jax_beam
from show_tell_tpu.models import captioner as jax_captioner
from show_tell_tpu.models.attention import AttnDecoderConfig as JaxAttnConfig
from show_tell_tpu.models.attention import init_attn_decoder_params
from show_tell_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from show_tell_tpu.models.decoder import greedy_decode as jax_greedy_decode
from show_tell_tpu.models.decoder import init_decoder_params
from show_tell_tpu.ops.fused_attn_pallas import fused_attn_dense_step_pallas
from show_tell_tpu.ops.fused_attn_pallas import prepare_attn_decode as jax_prepare_attn_decode
from show_tell_tpu.ops.fused_beam_pallas import fused_dense_step_pallas, fused_topk_step_pallas
from show_tell_tpu.ops.rnn_pallas import prepare_rnn_weights as jax_prepare_rnn_weights
from show_tell_tpu.ops.vocab_pallas import prepare_vocab as jax_prepare_vocab
from show_tell_tpu.ops.vocab_pallas import project_topk_pallas
from show_tell_tpu.serve import Captioner as JaxCaptioner
from show_tell_tpu.train.checkpoint import create_checkpoint
from show_tell_tpu.train.train_step import TrainState
from show_tell_tpu.vocab.vocabulary import DatasetVocabulary, save_vocab
from show_tell_tpu_torch import serve as port_serve
from show_tell_tpu_torch.data.images import load_images
from show_tell_tpu_torch.decode.beam import attn_beam_search_decode, beam_search_decode, rnn_state_helpers
from show_tell_tpu_torch.models.attention import AttnDecoder, AttnDecoderConfig
from show_tell_tpu_torch.models.convert import decoder_from_jax
from show_tell_tpu_torch.models.decoder import Decoder, DecoderConfig, greedy_decode
from show_tell_tpu_torch.ops.attention import attention_context
from show_tell_tpu_torch.ops.fused_attn import (
    fused_attn_dense_step,
    fused_attn_lstm_dense_step,
    prepare_attn_decode,
    prepare_attn_weights,
)
from show_tell_tpu_torch.ops.fused_beam import (
    fused_dense_step,
    fused_gru_dense_step,
    fused_gru_topk_step,
    fused_lstm_dense_step,
    fused_lstm_topk_step,
    fused_topk_step,
)
from show_tell_tpu_torch.ops.rnn import prepare_greedy, prepare_rnn_weights
from show_tell_tpu_torch.ops.vocab import prepare_vocab, project_topk, stable_topk
from show_tell_tpu_torch.serve import Captioner

B, E, H, V, L, T = 4, 16, 24, 40, 2, 9  # pooled
AB, AC, AA, AV, P, AT = 3, 24, 16, 37, 5, 7  # attention (E and H as above)
BLOCK_V = 16
END, PAD = 2, 0
COUNTERS = (fused_gru_dense_step, fused_lstm_dense_step, fused_gru_topk_step, fused_lstm_topk_step,
            fused_attn_dense_step, fused_attn_lstm_dense_step, project_topk, attention_context)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _counts():
    return [fn.launches for fn in COUNTERS]


def _load(module, jax_decoder_params):
    sd = {k: t(np.array(v)) for k, v in decoder_from_jax(jax.tree.map(np.asarray, jax_decoder_params)).items()}
    module.load_state_dict(sd, strict=True, assign=True)
    return module.eval()


def _end_bias(jparams, bias):
    """bias > 0 on <end>'s logit makes beams retire early."""
    jparams = dict(jparams)
    jparams["linear"] = dict(jparams["linear"])
    jparams["linear"]["b"] = jparams["linear"]["b"].at[END].add(bias)
    return jparams


def _pooled(cell, bias=0.0, E_=E, seed=0):
    jcfg = JaxDecoderConfig(cell, E_, H, V, L, max_caption_length=T)
    jparams = _end_bias(init_decoder_params(jax.random.PRNGKey(seed), jcfg), bias)
    with torch.device("meta"):
        dec = Decoder(DecoderConfig(*jcfg))
    dec = _load(dec, jparams)
    feats = np.random.RandomState(seed + 1).randn(B, E_).astype(np.float32)
    prepared = prepare_greedy(dec.unit.layers(), dec.embeddings.weight, dec.linear.weight, dec.linear.bias)
    return jcfg, jparams, dec, prepared, feats


def _attn(cell, H_=H, bias=0.0, seed=3):
    jcfg = JaxAttnConfig(cell, E, AC, AA, H_, AV, L, max_caption_length=AT)
    jparams = _end_bias(init_attn_decoder_params(jax.random.PRNGKey(seed), jcfg), bias)
    with torch.device("meta"):
        dec = AttnDecoder(AttnDecoderConfig(*jcfg))
    dec = _load(dec, jparams)
    feats = np.random.RandomState(seed + 1).randn(AB, AC, P).astype(np.float32)
    return jcfg, jparams, dec, feats


@pytest.mark.parametrize("k", [1, 3, 5, 8])
def test_stable_topk_matches_lax_top_k_on_ties(k):
    """Integer values in [0, 4): every row is full of ties, and the lower
    index must come first among them, as in jax.lax.top_k."""
    x = np.random.RandomState(k).randint(0, 4, (6, 4, 29)).astype(np.float32)
    x[0, 0] = 1.0  # a row of nothing but ties
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
    vals, idx = stable_topk(t(x), k)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    assert idx[0, 0].tolist() == list(range(k))


def _vocab_case(seed, R=6):
    rng = np.random.RandomState(seed)
    linear = {"w": rng.uniform(-0.3, 0.3, (H, V)).astype(np.float32), "b": rng.uniform(-0.3, 0.3, V).astype(np.float32)}
    return linear, rng.randn(R, H).astype(np.float32)


def _jax_vocab(linear):
    return jax_prepare_vocab({k: jnp.asarray(v) for k, v in linear.items()}, block_v=BLOCK_V)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_project_topk_twin_matches_pallas_interpret(k):
    """ids equal and logp within 1e-5 (the kernel forms the logsumexp per
    vocab block and merges, the twin over the whole row)."""
    linear, top = _vocab_case(10 + k)
    j_logp, j_ids = project_topk_pallas(_jax_vocab(linear), jnp.asarray(top), k, block_v=BLOCK_V, interpret=True)
    before = _counts()
    logp, ids = project_topk(prepare_vocab(t(linear["w"].T), t(linear["b"])), t(top), k)
    assert _counts() == before  # CPU tensors: the plain twin, not counted
    assert logp.dtype == torch.float32 and ids.dtype == torch.int32 and tuple(ids.shape) == (6, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(logp.numpy(), np.asarray(j_logp), rtol=1e-5, atol=1e-5)


def test_project_topk_cross_block_tie_takes_lower_index_first():
    """Columns 5 (vocab block 0) and 37 (block 2) are equal and top: both
    packages list 5, then 37."""
    linear, top = _vocab_case(20)
    linear["w"][:, [5, 37]] = 0.0
    linear["w"][0, [5, 37]] = 0.25  # one weight: 50 + top[:, 0] / 4 rounds once, whatever order a BLAS sums in
    linear["b"][5] = linear["b"][37] = 50.0
    _, j_ids = project_topk_pallas(_jax_vocab(linear), jnp.asarray(top), 3, block_v=BLOCK_V, interpret=True)
    _, ids = project_topk(prepare_vocab(t(linear["w"].T), t(linear["b"])), t(top), 3)
    assert np.asarray(j_ids)[:, :2].tolist() == [[5, 37]] * 6 and ids[:, :2].tolist() == [[5, 37]] * 6
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))


def _step_case(cell, seed):
    """JAX-layout layers and projection, x [R, E], and the state (hs, or (hs, cs))."""
    rng = np.random.RandomState(seed)
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)
    G = (4 if cell == "lstm" else 3) * H
    layers = [{"w_ih": u(E if l == 0 else H, G), "w_hh": u(H, G), "b_ih": u(G), "b_hh": u(G)} for l in range(L)]
    linear = {"w": u(H, V), "b": u(V)}
    x = rng.randn(6, E).astype(np.float32)
    hs = rng.uniform(-1, 1, (L, 6, H)).astype(np.float32)
    state = (hs, rng.uniform(-2, 2, (L, 6, H)).astype(np.float32)) if cell == "lstm" else hs
    jax_args = (jax_prepare_rnn_weights([{k: jnp.asarray(v) for k, v in l.items()} for l in layers]),
                _jax_vocab(linear), jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    port_args = (prepare_rnn_weights([{k: t(v.T) if v.ndim == 2 else t(v) for k, v in l.items()} for l in layers]),
                 prepare_vocab(t(linear["w"].T), t(linear["b"])), t(x),
                 tuple(t(s) for s in state) if cell == "lstm" else t(state))
    return jax_args, port_args


def _assert_states(got, ref):
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_fused_dense_step_twin_matches_pallas_interpret(cell):
    """The dense beam step: logits [R, V] and the new state within 1e-5."""
    jax_args, port_args = _step_case(cell, 30)
    j_logits, j_state = fused_dense_step_pallas(cell, *jax_args, V, block_v=BLOCK_V, interpret=True)
    before = _counts()
    logits, state = fused_dense_step(*port_args)
    assert _counts() == before
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (6, V)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=1e-5, atol=1e-5)
    _assert_states(state, j_state)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_fused_topk_step_twin_matches_pallas_interpret(cell):
    """The top-k beam step: ids equal, logp within 1e-5, the state within 1e-5."""
    jax_args, port_args = _step_case(cell, 40)
    (j_logp, j_ids), j_state = fused_topk_step_pallas(cell, *jax_args, 3, block_v=BLOCK_V, interpret=True)
    before = _counts()
    (logp, ids), state = fused_topk_step(*port_args, 3)
    assert _counts() == before
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(logp.numpy(), np.asarray(j_logp), rtol=1e-5, atol=1e-5)
    _assert_states(state, j_state)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_fused_attn_dense_step_twin_matches_pallas_interpret(cell):
    jcfg, jparams, dec, feats = _attn(cell, seed=50)
    rng = np.random.RandomState(51)
    w_emb = rng.randn(AB, E).astype(np.float32)
    hs = rng.uniform(-1, 1, (L, AB, H)).astype(np.float32)
    state = (hs, rng.uniform(-3, 3, (L, AB, H)).astype(np.float32)) if cell == "lstm" else hs
    feats_pm = np.ascontiguousarray(feats.transpose(0, 2, 1))
    j_prep = jax_prepare_attn_decode(jparams, jnp.asarray(feats_pm))
    j_prep["vocab"] = jax_prepare_vocab(jparams["linear"], block_v=BLOCK_V)
    j_logits, j_state = fused_attn_dense_step_pallas(j_prep, cell, jnp.asarray(w_emb), jax.tree.map(jnp.asarray, state),
                                                     AV, block_v=BLOCK_V, interpret=True)
    with torch.inference_mode():
        prep = prepare_attn_decode(prepare_attn_weights(dec), dec, t(feats_pm))
        step = fused_attn_lstm_dense_step if cell == "lstm" else fused_attn_dense_step
        before = _counts()
        logits, new_state = step(prep, t(w_emb), tuple(t(s) for s in state) if cell == "lstm" else t(state))
    assert _counts() == before
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=1e-5, atol=1e-5)
    _assert_states(new_state, j_state)


def test_rnn_state_helpers_repeat_each_row_and_gather_by_parent():
    """tile is jnp.repeat along the rows (image b's K beams adjacent, not a
    tile of the batch), gather takes row b*K + parent; both contiguous, an
    LSTM's hs and cs by the same parents."""
    Bh, Kh = 3, 2
    rng = np.random.RandomState(60)
    state1 = (rng.randn(L, Bh, 5).astype(np.float32), rng.randn(L, Bh, 5).astype(np.float32))
    parent = rng.randint(0, Kh, (Bh, Kh)).astype(np.int32)
    j_tile, j_gather = jax_rnn_state_helpers(Bh, Kh)
    tile, gather = rnn_state_helpers(Bh, Kh)
    tiled = tile(tuple(t(s) for s in state1))
    _assert_states(tiled, j_tile(tuple(jnp.asarray(s) for s in state1)))
    got = gather(tiled, t(parent))
    assert all(g.is_contiguous() for g in got + tiled)
    _assert_states(got, j_gather(j_tile(tuple(jnp.asarray(s) for s in state1)), jnp.asarray(parent)))
    np.testing.assert_array_equal(tile(t(state1[0])).numpy(), np.repeat(state1[0], Kh, axis=1))


# (fused_step, sparse, early_exit): every route of the port's pooled beam
POOLED_ROUTES = [("dense", False, False), ("dense", False, True), ("topk", False, False), ("topk", False, True),
                 (None, True, False), (None, True, True), (None, False, False), (None, False, True)]


@pytest.mark.parametrize("bias", [0.0, 3.0], ids=["no_retire", "early_retire"])
@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_beam_search_routes_bit_equal_to_jax(cell, K, bias):
    """Every route (fused dense, fused top-k, composite with and without
    the projection + top-k, each with and without early exit) gives the
    ids of the JAX package's beam_search_decode; a +3 bias on <end> retires
    beams early."""
    jcfg, jparams, _, prepared, feats = _pooled(cell, bias, seed=70)
    ref = np.asarray(jax_beam(jparams, jcfg, jnp.asarray(feats), K, use_pallas=False, fused_step=False))
    if bias:
        assert (ref == END).any()
    cfg = DecoderConfig(*jcfg)
    for fused_step, sparse, early_exit in POOLED_ROUTES:
        with torch.inference_mode():
            ids = beam_search_decode(prepared, cfg, t(feats), K, END, PAD, fused_step=fused_step, sparse=sparse,
                                     early_exit=early_exit).numpy()
        assert ids.shape == (B, T) and ids.dtype == np.int32
        np.testing.assert_array_equal(ids, ref, err_msg=str((fused_step, sparse, early_exit)))


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_beam_search_fused_dense_equals_jax_fused_dense(cell):
    """The fused dense route against the JAX package's own fused dense
    route (its Pallas step interpreted), with early exit."""
    jcfg, jparams, _, prepared, feats = _pooled(cell, 3.0, seed=80)
    ref = np.asarray(jax_beam(jparams, jcfg, jnp.asarray(feats), 3, use_pallas=False, fused_step="dense",
                              early_exit=True))
    with torch.inference_mode():
        ids = beam_search_decode(prepared, DecoderConfig(*jcfg), t(feats), 3, END, PAD, early_exit=True).numpy()
    np.testing.assert_array_equal(ids, ref)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_beam_embed_wider_than_hidden_equals_jax_xla(cell):
    """E=32 > H=24: the port's fused steps take layer 0 at its own width;
    the JAX package keeps such models on its XLA route."""
    jcfg, jparams, _, prepared, feats = _pooled(cell, 0.0, E_=32, seed=90)
    ref = np.asarray(jax_beam(jparams, jcfg, jnp.asarray(feats), 3, use_pallas=False, fused_step=False))
    for fused_step in ("dense", "topk"):
        with torch.inference_mode():
            ids = beam_search_decode(prepared, DecoderConfig(*jcfg), t(feats), 3, END, PAD,
                                     fused_step=fused_step).numpy()
        np.testing.assert_array_equal(ids, ref, err_msg=fused_step)


@pytest.mark.parametrize("H_", [24, 40], ids=["H<=2E", "H>2E"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_attn_beam_routes_bit_equal_to_jax(cell, H_):
    """The fused dense route (H <= 2E; the composite when H > 2E) and the
    composite with and without the projection + top-k, with and without
    early exit, against the JAX package's attn_beam_search_decode."""
    jcfg, jparams, dec, feats = _attn(cell, H_=H_, bias=2.0, seed=100)
    ref = np.asarray(jax_attn_beam(jparams, jcfg, jnp.asarray(feats), 3, 1, use_pallas=False, fused_step=False))
    cfg = AttnDecoderConfig(*jcfg)
    with torch.inference_mode():
        weights = prepare_attn_weights(dec)
        for fused_step, sparse, early_exit in [("dense", False, False), ("dense", False, True), (None, True, False),
                                               (None, True, True), (None, False, False)]:
            ids = attn_beam_search_decode(weights, dec, cfg, t(feats), 3, 1, END, PAD, fused_step=fused_step,
                                          sparse=sparse, early_exit=early_exit).numpy()
            assert ids.shape == (AB, AT)
            np.testing.assert_array_equal(ids, ref, err_msg=str((fused_step, sparse, early_exit)))


def test_attn_beam_fused_dense_equals_jax_fused_dense():
    jcfg, jparams, dec, feats = _attn("lstm", seed=110)
    ref = np.asarray(jax_attn_beam(jparams, jcfg, jnp.asarray(feats), 3, 1, use_pallas=False, fused_step="dense"))
    with torch.inference_mode():
        ids = attn_beam_search_decode(prepare_attn_weights(dec), dec, AttnDecoderConfig(*jcfg), t(feats), 3, 1,
                                      END, PAD).numpy()
    np.testing.assert_array_equal(ids, ref)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_beam_width_one_is_the_greedy_prefix(cell):
    """K=1 keeps the argmax path: the greedy ids up to and including the
    first <end>, <pad> after it (a retired beam continues only with <pad>)."""
    jcfg, jparams, dec, prepared, feats = _pooled(cell, 2.0, seed=120)
    greedy = np.asarray(jax_greedy_decode(jparams, jcfg, jnp.asarray(feats)))
    with torch.inference_mode():
        np.testing.assert_array_equal(greedy_decode(dec, DecoderConfig(*jcfg), t(feats)).numpy(), greedy)
        ids = beam_search_decode(prepared, DecoderConfig(*jcfg), t(feats), 1, END, PAD).numpy()
    assert (greedy == END).any()
    for row, g in zip(ids, greedy):
        hits = np.flatnonzero(g == END)
        stop = hits[0] + 1 if len(hits) else T
        np.testing.assert_array_equal(row[:stop], g[:stop])
        assert (row[stop:] == PAD).all()


def test_beam_routes_reject_unknown_fused_step():
    jcfg, _, dec, prepared, feats = _pooled("gru", seed=130)
    with pytest.raises(ValueError, match="fused_step"):
        beam_search_decode(prepared, DecoderConfig(*jcfg), t(feats), 2, fused_step="sparse")
    with pytest.raises(ValueError, match="fused_step"):
        attn_beam_search_decode({}, None, None, t(np.zeros((1, 8, 2), np.float32)), 2, fused_step="topk")


WORDS = ["a", "man", "dog", "on", "the", "with", "red", "bus", "plate", "of", "cat", "wave"]


@pytest.fixture(scope="module")
def beam_checkpoints(tmp_path_factory):
    """Seeded tiny models (ResNet-18, E=16, H=24, L=2; attention C=512,
    A=16) written as JAX-format pickles by the JAX package's own writer,
    with a +2 bias on <end> so that beams retire: {variant: (ckpt, vocab)}."""
    vocab = DatasetVocabulary()
    for w in ["<pad>", "<start>", "<end>", "<unk>"] + WORDS:
        vocab.add_new_word(w)
    out = {}
    for seed, variant in enumerate(["gru", "attn_lstm"]):
        root = str(tmp_path_factory.mktemp("torch_%s_beam" % variant))
        cfg = jax_captioner.CaptionerConfig(variant, 18, E, H, len(vocab), 2, nos_filters=512, attn_dim=AA)
        params, bn_state = jax_captioner.init_captioner(jax.random.PRNGKey(140 + seed), cfg)
        params["decoder"] = _end_bias(params["decoder"], 2.0)
        trainable, frozen = jax_captioner.split_trainable(params)
        state = TrainState(trainable, frozen, bn_state, optax.adam(1e-3).init(trainable), jax.random.PRNGKey(1),
                           np.int32(0))
        ckpt = create_checkpoint(state, 1, 0, [], {"output_dir": root})
        vocab_path = os.path.join(root, "vocab.pkl")
        save_vocab(vocab, vocab_path)
        out[variant] = (ckpt, vocab_path)
    return out


def _kw(variant):
    return dict(variant=variant, resnet_version=18, embed_dim=E, hidden_dim=H, num_layers=2,
                compute_dtype="float32", nos_filters=512, attn_dim=AA)


@pytest.mark.parametrize("variant", ["gru", "attn_lstm"])
def test_captioner_beam_from_jax_checkpoint_equals_jax(beam_checkpoints, variant):
    """caption_ids(..., beam_size=3) and the captions, early exit on, against
    the JAX Captioner from the same checkpoint."""
    ckpt, vocab = beam_checkpoints[variant]
    images = np.random.RandomState(150).randint(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    ref = JaxCaptioner.from_checkpoint(ckpt, vocab, early_exit=True, **_kw(variant))
    port = Captioner.from_checkpoint(ckpt, vocab, early_exit=True, device="cpu", **_kw(variant))
    ids = port.caption_ids(images, beam_size=3)
    assert ids.shape == (3, 25) and ids.dtype == np.int32
    np.testing.assert_array_equal(ids, ref.caption_ids(images, beam_size=3))
    assert port.caption(images, beam_size=3) == ref.caption(images, beam_size=3)


@pytest.mark.parametrize("route", ["dense", "topk"])
def test_captioner_beam_takes_the_beam_step_default(beam_checkpoints, route, monkeypatch):
    """A pooled Captioner's beam search takes the step route that
    ops.beam_step_default() names (its wrapper is the only step called)
    and gives the JAX Captioner's ids by either route."""
    from show_tell_tpu_torch import ops as port_ops
    from show_tell_tpu_torch.ops import fused_beam

    assert port_ops.beam_step_default() in ("dense", "topk")
    calls = []
    for name in ("fused_dense_step", "fused_topk_step"):
        real = getattr(fused_beam, name)
        monkeypatch.setattr(fused_beam, name, lambda *a, _real=real, _name=name: calls.append(_name) or _real(*a))
    monkeypatch.setattr(port_ops, "beam_step_default", lambda: route)
    ckpt, vocab = beam_checkpoints["gru"]
    images = np.random.RandomState(151).randint(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    port = Captioner.from_checkpoint(ckpt, vocab, device="cpu", **_kw("gru"))
    ids = port.caption_ids(images, beam_size=3)
    assert set(calls) == {"fused_%s_step" % route} and len(calls) == 24
    ref = JaxCaptioner.from_checkpoint(ckpt, vocab, **_kw("gru"))
    np.testing.assert_array_equal(ids, ref.caption_ids(images, beam_size=3))


@pytest.mark.parametrize("variant", ["gru", "attn_lstm"])
def test_cli_beam_size_captions_like_jax(beam_checkpoints, variant, tmp_path, capsys):
    """--beam_size 3: one JSON line per image, the JAX Captioner's beam
    captions of the same decoded files."""
    import json

    from fixtures import build_mini_coco

    ckpt, vocab = beam_checkpoints[variant]
    build_mini_coco(str(tmp_path / "data"))
    img_dir = str(tmp_path / "data" / "train2014")
    rc = port_serve.main([
        "--ckpt", ckpt, "--vocab", vocab, "--variant", variant, "--resnet_version", "18",
        "--embedding_length", str(E), "--num_hidden_units", str(H), "--num_layers", "2", "--attn_dim", str(AA),
        "--batch_size", "8", "--beam_size", "3", "--compute_dtype", "float32", "--device", "cpu", "--json", img_dir,
    ])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    paths = [line["image"] for line in lines]
    assert len(paths) == 8
    ref = JaxCaptioner.from_checkpoint(ckpt, vocab, **_kw(variant))
    images = load_images(paths)
    assert [line["caption"] for line in lines] == ref.caption(images, beam_size=3)
