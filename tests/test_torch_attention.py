"""The port's soft-attention GRU slice against the JAX package, on the CPU.

The same seeded weights (the JAX package's own init) and numpy inputs go
through the JAX functions (Pallas kernels in interpret mode, as
tests/test_pallas_ops.py runs them) and through the port, whose kernel
wrappers run their plain twins for CPU tensors.  f32 throughout.  Sizes:
B=6, E=16, C=24, A=16, H=24, V=37, P=5, T=7, L=1 and 3; the JAX vocab
kernel uses block_v=16 so V spans three vocab blocks.
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
from show_tell_tpu.models.attention import attention_net as jax_attention_net
from show_tell_tpu.models.attention import attn_greedy_decode as jax_attn_greedy_decode
from show_tell_tpu.models.attention import init_attn_decoder_params
from show_tell_tpu.models.convert import attn_decoder_params_from_torch
from show_tell_tpu.models.encoder import encoder_forward
from show_tell_tpu.models.rnn_cells import stack_step_gru as jax_stack_step_gru
from show_tell_tpu.ops.attention_pallas import attention_context_pallas, attn_greedy_decode_pallas
from show_tell_tpu.ops.attention_pallas import precompute_att1 as jax_precompute_att1
from show_tell_tpu.ops.fused_attn_pallas import attn_greedy_decode_fused_pallas, fused_attn_decode_step_pallas
from show_tell_tpu.ops.fused_attn_pallas import prepare_attn_decode as jax_prepare_attn_decode
from show_tell_tpu.ops.vocab_pallas import prepare_vocab as jax_prepare_vocab
from show_tell_tpu.ops.vocab_pallas import project_argmax_pallas
from show_tell_tpu.serve import Captioner as JaxCaptioner
from show_tell_tpu.train.checkpoint import create_checkpoint
from show_tell_tpu.train.train_step import TrainState
from show_tell_tpu.vocab.vocabulary import DatasetVocabulary, save_vocab
from show_tell_tpu_torch import serve as port_serve
from show_tell_tpu_torch.models import captioner as port_captioner
from show_tell_tpu_torch.models.attention import AttnDecoder, AttnDecoderConfig, attention_net, attn_greedy_decode
from show_tell_tpu_torch.models.captioner import CaptionerConfig, CaptionerModel, build_model, init_captioner
from show_tell_tpu_torch.models.convert import decoder_from_jax, decoder_to_jax, params_from_jax
from show_tell_tpu_torch.models.rnn_cells import stack_step_gru
from show_tell_tpu_torch.ops.attention import attention_context, attn_greedy_decode_composite, precompute_att1
from show_tell_tpu_torch.ops.fused_attn import (
    attn_greedy_decode_fused,
    fused_attn_decode_step,
    prepare_attn_decode,
    prepare_attn_weights,
)
from show_tell_tpu_torch.ops.vocab import prepare_vocab, project_argmax
from show_tell_tpu_torch.serve import Captioner

B, E, C, A, H, V, P, T = 6, 16, 24, 16, 24, 37, 5, 7
BLOCK_V = 16
CPU = torch.device("cpu")


def _case(L, seed=3, H_=H):
    """JAX attention decoder params (jnp), its config, the port's decoder
    holding the same weights, and seeded features [B, C, P]."""
    jcfg = JaxAttnConfig("gru", E, C, A, H_, V, L, max_caption_length=T)
    jparams = init_attn_decoder_params(jax.random.PRNGKey(seed), jcfg)
    with torch.device("meta"):
        dec = AttnDecoder(AttnDecoderConfig(*jcfg))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in decoder_from_jax(jax.tree.map(np.asarray, jparams)).items()}
    dec.load_state_dict(sd, strict=True, assign=True)
    feats = np.random.RandomState(seed + 1).randn(B, C, P).astype(np.float32)
    return jcfg, jparams, dec.eval(), feats


def test_spatial_encoder_matches_jax():
    """[B, C, P] with p = W*row + col, and its transpose is the contiguous
    positions-major view the decode reads."""
    jcfg = jax_captioner.CaptionerConfig("attn", 18, 16, 24, 40, 2, nos_filters=512)
    params, state = jax.tree.map(np.asarray, jax_captioner.init_captioner(jax.random.PRNGKey(2), jcfg))
    rng = np.random.RandomState(2)
    for k, v in state["resnet"].items():  # eval-mode BN off the identity
        state["resnet"][k] = rng.uniform(0.5, 1.0, v.shape).astype(np.float32) if "var" in k else v + 0.1
    model = build_model(params, state, CaptionerConfig(*jcfg), torch.float32, CPU)
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    ref, _ = encoder_forward(params["encoder"], state, jcfg.encoder_config(), jnp.asarray(x), training=False)
    with torch.inference_mode():
        got = model.encoder(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 512, 4) and got.transpose(1, 2).is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    # the dead pooled head stays in the state_dict, as in the reference checkpoint
    assert "linear_secondlast_layer.weight" in model.encoder.state_dict()


def test_attention_context_twin_matches_pallas_and_attention_net():
    """ctx and alpha within 2e-5 of the interpreted Pallas kernel (b_full
    dropped) and of the plain attention_net (b_full kept: alpha ignores it)."""
    jcfg, jparams, dec, feats = _case(2, seed=11)
    rng = np.random.RandomState(12)
    feats_pm = np.ascontiguousarray(feats.transpose(0, 2, 1))
    h = rng.randn(B, H).astype(np.float32)
    j_att1 = jax_precompute_att1(jparams["attn"], jnp.asarray(feats_pm))
    j_ctx, j_alpha = attention_context_pallas(jparams["attn"], jnp.asarray(feats_pm), j_att1, jnp.asarray(h),
                                              block_b=2, interpret=True)
    r_ctx, r_alpha = jax_attention_net(jparams["attn"], jnp.asarray(feats_pm), jnp.asarray(h))
    weights = prepare_attn_weights(dec)
    tf = torch.from_numpy(feats_pm)
    with torch.inference_mode():
        att1 = precompute_att1(dec.attn, tf)
        ctx, alpha = attention_context(weights, tf, att1, torch.from_numpy(h))
        p_ctx, p_alpha = attention_net(dec.attn, tf, torch.from_numpy(h))
    np.testing.assert_allclose(att1.numpy(), np.asarray(j_att1), rtol=2e-5, atol=2e-5)
    assert ctx.dtype == torch.float32 and tuple(alpha.shape) == (B, P)
    for c, a in ((j_ctx, j_alpha), (r_ctx, r_alpha), (p_ctx, p_alpha)):
        np.testing.assert_allclose(ctx.numpy(), np.asarray(c), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(alpha.numpy(), np.asarray(a), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("tie", [False, True], ids=["random", "cross_block_tie"])
def test_project_argmax_twin_matches_pallas(tie):
    """Ids equal to the interpreted Pallas kernel; with columns 5 (vocab
    block 0) and 35 (block 2) identical and the row maximum, both pick 5."""
    rng = np.random.RandomState(21)
    w, b = rng.uniform(-0.3, 0.3, (H, V)).astype(np.float32), rng.uniform(-0.3, 0.3, V).astype(np.float32)
    if tie:
        w[:, [5, 35]] = 0.0
        w[0, [5, 35]] = 0.25  # one weight: 50 + top[:, 0] / 4 rounds once, whatever order a BLAS sums in
        b[5] = b[35] = 50.0
    top = rng.randn(B, H).astype(np.float32)
    j_tok = project_argmax_pallas(jax_prepare_vocab({"w": jnp.asarray(w), "b": jnp.asarray(b)}, block_v=BLOCK_V),
                                  jnp.asarray(top), block_v=BLOCK_V, interpret=True)
    before = project_argmax.launches
    tok = project_argmax(prepare_vocab(torch.from_numpy(w.T), torch.from_numpy(b)), torch.from_numpy(top))
    assert project_argmax.launches == before and tok.dtype == torch.int32
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
    if tie:
        assert tok.tolist() == [5] * B


@pytest.mark.parametrize("L", [1, 3])
def test_fused_attn_step_twin_matches_pallas(L):
    """One step from the same w_emb and hs: new hs within 1e-5 of the
    interpreted fused Pallas step, tokens equal; att1 and feats_e equal
    JAX's hoisted constants."""
    jcfg, jparams, dec, feats = _case(L, seed=30 + L)
    rng = np.random.RandomState(40 + L)
    w_emb = rng.randn(B, E).astype(np.float32)
    hs = rng.uniform(-1, 1, (L, B, H)).astype(np.float32)
    feats_pm = np.ascontiguousarray(feats.transpose(0, 2, 1))
    j_prep = jax_prepare_attn_decode(jparams, jnp.asarray(feats_pm))
    j_tok, j_hs = fused_attn_decode_step_pallas(j_prep, "gru", jnp.asarray(w_emb), jnp.asarray(hs), block_v=BLOCK_V,
                                                interpret=True)
    with torch.inference_mode():
        prep = prepare_attn_decode(prepare_attn_weights(dec), dec, torch.from_numpy(feats_pm))
        before = fused_attn_decode_step.launches
        tok, new_hs = fused_attn_decode_step(prep, torch.from_numpy(w_emb), torch.from_numpy(hs))
    assert fused_attn_decode_step.launches == before
    np.testing.assert_allclose(prep["att1"].numpy(), np.asarray(j_prep["att1"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(prep["feats_e"].numpy(), np.asarray(j_prep["feats_e"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new_hs.numpy(), np.asarray(j_hs), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))


@pytest.mark.parametrize("end_token", [None, 2], ids=["fixed_T", "early_exit"])
@pytest.mark.parametrize("L", [1, 3])
def test_attn_decodes_bit_equal_to_jax(L, end_token):
    """f32 ids: the plain decode against attn_greedy_decode, the fused
    twin's against the interpreted attn_greedy_decode_fused_pallas, the
    composite's against the interpreted attn_greedy_decode_pallas."""
    jcfg, jparams, dec, feats = _case(L)
    jf = jnp.asarray(feats)
    ref = np.asarray(jax_attn_greedy_decode(jparams, jcfg, jf, 1, end_token=end_token))
    ref_fused = np.asarray(attn_greedy_decode_fused_pallas(jparams, jcfg, jf, 1, interpret=True, end_token=end_token))
    ref_comp = np.asarray(attn_greedy_decode_pallas(jparams, jcfg, jf, 1, interpret=True, end_token=end_token))
    cfg = AttnDecoderConfig(*jcfg)
    f = torch.from_numpy(feats)
    with torch.inference_mode():
        weights = prepare_attn_weights(dec)
        plain = attn_greedy_decode(dec, cfg, f, 1, end_token=end_token).numpy()
        fused = attn_greedy_decode_fused(weights, dec, cfg, f, 1, end_token=end_token).numpy()
        comp = attn_greedy_decode_composite(weights, dec, cfg, f, 1, end_token=end_token).numpy()
    assert plain.shape == (B, T) and plain.dtype == np.int32
    np.testing.assert_array_equal(plain, ref)
    np.testing.assert_array_equal(fused, ref_fused)
    np.testing.assert_array_equal(comp, ref_comp)
    if end_token is not None:
        fixed = np.asarray(jax_attn_greedy_decode(jparams, jcfg, jf, 1))
        for row, row_fixed in zip(plain, fixed):
            hits = np.flatnonzero(row == end_token)
            stop = hits[0] + 1 if len(hits) else T
            np.testing.assert_array_equal(row[:stop], row_fixed[:stop])
            assert (row[stop:] == 0).all()


def test_stack_step_gru_with_2e_wide_layer0_matches_jax():
    jcfg, jparams, dec, _ = _case(3, seed=50)
    rng = np.random.RandomState(51)
    x, hs = rng.randn(B, 2 * E).astype(np.float32), rng.uniform(-1, 1, (3, B, H)).astype(np.float32)
    j_top, j_hs = jax_stack_step_gru(jparams["rnn"], jnp.asarray(x), jnp.asarray(hs))
    top, new_hs = stack_step_gru(dec.unit.layers(), torch.from_numpy(x), torch.from_numpy(hs))
    np.testing.assert_allclose(top.detach().numpy(), np.asarray(j_top), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new_hs.detach().numpy(), np.asarray(j_hs), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("H_,path", [(24, "fused"), (40, "composite")], ids=["H<=2E", "H>2E"])
def test_captioner_dispatch_by_shape_rule(monkeypatch, H_, path):
    """H <= 2E takes the fused step, H > 2E the composite path (the JAX
    envelope's shape rule); either way the ids equal the JAX captioner's."""
    jcfg = jax_captioner.CaptionerConfig("attn", 18, E, H_, V, 2, nos_filters=512, max_caption_length=T)
    params, state = jax.tree.map(np.asarray, jax_captioner.init_captioner(jax.random.PRNGKey(60), jcfg))
    images = np.random.RandomState(61).randn(2, 64, 64, 3).astype(np.float32)
    jp, js = jax.tree.map(jnp.asarray, (params, state))
    ref = np.asarray(jax_captioner.captioner_greedy_decode(jp, js, jcfg, jnp.asarray(images), use_pallas=True))
    import show_tell_tpu_torch.ops.attention as port_attention
    import show_tell_tpu_torch.ops.fused_attn as port_fused

    taken = []
    for mod, name in ((port_fused, "attn_greedy_decode_fused"), (port_attention, "attn_greedy_decode_composite")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _real=real, _name=name, **k: taken.append(_name) or _real(*a, **k))
    cfg = CaptionerConfig(*jcfg)
    model = build_model(params, state, cfg, torch.float32, CPU)
    with torch.inference_mode():
        ids = port_captioner.captioner_greedy_decode(model, cfg, torch.from_numpy(images)).numpy()
    assert taken == ["attn_greedy_decode_" + path]
    np.testing.assert_array_equal(ids, ref)


def test_attn_bridge_round_trip_and_reference_keys():
    """params_from_jax / params_to_jax invert each other on an attention
    tree; the decoder's keys are the port module's, and the JAX package's
    torch loader reads them back into the same tree."""
    jcfg = jax_captioner.CaptionerConfig("attn", 18, E, H, V, 2, nos_filters=512)
    params, state = jax.tree.map(np.asarray, jax_captioner.init_captioner(jax.random.PRNGKey(70), jcfg))
    sds = params_from_jax(params, state)
    from show_tell_tpu_torch.models.convert import params_to_jax

    back_p, back_s = params_to_jax(sds)
    assert jax.tree.structure(back_p) == jax.tree.structure(params)
    assert jax.tree.structure(back_s) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves((back_p, back_s)), jax.tree.leaves((params, state))):
        np.testing.assert_array_equal(a, b)
    with torch.device("meta"):
        model = CaptionerModel(CaptionerConfig(*jcfg))
    assert sorted(model.decoder.state_dict()) == sorted(sds["decoder"])
    assert sorted(model.encoder.state_dict()) == sorted(sds["encoder"])
    assert {"init_h.weight", "embed.bias", "attn.encoder_att.weight", "attn.full_att.bias"} <= set(sds["decoder"])
    oracle = attn_decoder_params_from_torch(sds["decoder"], 2)
    assert jax.tree.structure(oracle) == jax.tree.structure(params["decoder"])
    for a, b in zip(jax.tree.leaves(oracle), jax.tree.leaves(params["decoder"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jax.tree.structure(decoder_to_jax(sds["decoder"])) == jax.tree.structure(params["decoder"])


def test_init_captioner_attn_matches_jax_tree_and_laws():
    cfg = CaptionerConfig("attn", 18, E, H, V, 2, nos_filters=512, attn_dim=A)
    params, state = init_captioner(cfg, torch.Generator().manual_seed(0))
    j_params, j_state = jax.eval_shape(
        lambda k: jax_captioner.init_captioner(k, jax_captioner.CaptionerConfig(*cfg)), jax.random.PRNGKey(0)
    )
    assert jax.tree.structure(params) == jax.tree.structure(j_params)
    assert jax.tree.structure(state) == jax.tree.structure(j_state)
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves((j_params, j_state))):
        assert a.shape == b.shape and a.dtype == np.float32
    dec = params["decoder"]
    assert dec["rnn"][0]["w_ih"].shape == (2 * E, 3 * H)
    for node, fan_in in ((dec["init_h"], 512), (dec["attn"]["decoder_att"], H), (dec["attn"]["full_att"], A)):
        assert np.abs(node["w"]).max() <= fan_in ** -0.5 and np.abs(node["w"]).max() > 0.8 * fan_in ** -0.5
    with pytest.raises(ValueError, match="nos_cnn_filters=2048"):
        init_captioner(cfg._replace(nos_filters=2048), torch.Generator().manual_seed(0))


WORDS = ["a", "man", "dog", "on", "the", "with", "red", "bus", "plate", "of", "cat", "wave"]


@pytest.fixture(scope="module")
def attn_checkpoint(tmp_path_factory):
    """A seeded tiny attention model (ResNet-18, C=512, E=16, H=24, A=16,
    L=2) written as a JAX-format pickle by the JAX package's own writer."""
    out = str(tmp_path_factory.mktemp("torch_attn_serve"))
    vocab = DatasetVocabulary()
    for w in ["<pad>", "<start>", "<end>", "<unk>"] + WORDS:
        vocab.add_new_word(w)
    cfg = jax_captioner.CaptionerConfig("attn", 18, E, H, len(vocab), 2, nos_filters=512, attn_dim=A)
    params, bn_state = jax_captioner.init_captioner(jax.random.PRNGKey(80), cfg)
    rng = np.random.RandomState(80)
    bn_state = jax.tree.map(lambda v: v + rng.uniform(0.0, 0.3, v.shape).astype(np.float32), bn_state)
    trainable, frozen = jax_captioner.split_trainable(params)
    state = TrainState(trainable, frozen, bn_state, optax.adam(1e-3).init(trainable), jax.random.PRNGKey(1),
                       np.int32(0))
    ckpt = create_checkpoint(state, 1, 0, [], {"output_dir": out})
    vocab_path = os.path.join(out, "vocab.pkl")
    save_vocab(vocab, vocab_path)
    return ckpt, vocab_path


KW = dict(variant="attn", resnet_version=18, embed_dim=E, hidden_dim=H, num_layers=2, compute_dtype="float32",
          nos_filters=512, attn_dim=A)


@pytest.mark.parametrize("early_exit", [False, True], ids=["fixed_T", "early_exit"])
def test_attn_captioner_from_jax_checkpoint_equals_jax(attn_checkpoint, early_exit):
    ckpt, vocab = attn_checkpoint
    images = np.random.RandomState(81).randint(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    ref = JaxCaptioner.from_checkpoint(ckpt, vocab, early_exit=early_exit, **KW)
    port = Captioner.from_checkpoint(ckpt, vocab, early_exit=early_exit, device="cpu", **KW)
    ids = port.caption_ids(images)
    assert ids.shape == (3, 25) and ids.dtype == np.int32
    np.testing.assert_array_equal(ids, ref.caption_ids(images))
    assert port.caption(images) == ref.caption(images)


def test_attn_cli_captions_files(attn_checkpoint, tmp_path, capsys):
    from fixtures import build_mini_coco

    ckpt, vocab = attn_checkpoint
    build_mini_coco(str(tmp_path / "data"))
    img_dir = str(tmp_path / "data" / "train2014")
    rc = port_serve.main([
        "--ckpt", ckpt, "--vocab", vocab, "--variant", "attn", "--resnet_version", "18",
        "--embedding_length", str(E), "--num_hidden_units", str(H), "--num_layers", "2", "--attn_dim", str(A),
        "--batch_size", "4", "--compute_dtype", "float32", "--device", "cpu", "--json", img_dir,
    ])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 8 and all('"caption"' in line for line in lines)
