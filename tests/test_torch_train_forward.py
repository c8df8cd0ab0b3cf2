"""The port's teacher-forced forward and loss against the JAX package, on
the CPU in f32: the encoder in train mode (features and the BatchNorm
statistics it moves), both decoders' teacher-forced passes, the masked CE
and the attention penalty, and ``captioner_loss`` with the gradient of
every trainable parameter, for all four families.

Weights come from the JAX package's seeded init and cross the bridge
(models/convert.py); inputs come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.data.transforms import preprocess_images as jax_preprocess
from show_tell_tpu.models import attention as jax_attention
from show_tell_tpu.models import captioner as jax_captioner
from show_tell_tpu.models import decoder as jax_decoder
from show_tell_tpu.models import encoder as jax_encoder
from show_tell_tpu.models.encoder import encoder_forward as jax_encoder_forward
from show_tell_tpu_torch.data.transforms import preprocess_images
from show_tell_tpu_torch.models.attention import attn_decoder_forward, doubly_stochastic_penalty
from show_tell_tpu_torch.models.captioner import captioner_loss, model_trees
from show_tell_tpu_torch.models.decoder import decoder_forward, masked_cross_entropy
from torch_train_helpers import (  # noqa: F401 (few_torch_threads: an autouse fixture)
    few_torch_threads,
    VARIANTS,
    assert_trees_close,
    jax_cfg,
    jax_init,
    make_batch,
    np_tree,
    port_cfg,
    port_grads,
    port_model,
    trainable_tree_to_port,
)


_jax_encode = jax.jit(jax_encoder_forward, static_argnums=(2, 4))


def _images(images_u8):
    """The same normalized float images for both packages (no flips)."""
    return np.asarray(jax_preprocess(jnp.asarray(images_u8), jax.random.PRNGKey(0), augment=False))


@pytest.mark.parametrize("spatial", [False, True], ids=["pooled", "spatial"])
def test_encoder_train_mode_features_and_bn_state(spatial):
    """One train-mode encode from identity BN: every running statistic the
    backbone's and the head's BatchNorms move (momentum 0.1 and 0.01,
    unbiased running variance) within 1e-5; the features within 1e-4, the
    eval-mode encoder's bar (tests/test_torch_models.py): the convolutions
    alone (oneDNN's sums against XLA's) leave 4e-5 at |x| ~ 6 through
    ResNet-18.  The pooled head alone, from the JAX backbone's own feature
    map, within 1e-5."""
    jcfg = jax_cfg("attn" if spatial else "gru")
    params, state = jax_init(jcfg)
    images_u8, _, _ = make_batch(0)
    x = _images(images_u8)
    want, new_state = _jax_encode(params["encoder"], state, jcfg.encoder_config(), jnp.asarray(x), True)
    model = port_model(jcfg, params, state)
    got = model.encoder(torch.from_numpy(x.copy()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    _, port_state = model_trees(model)
    new_state = np_tree(new_state)
    assert_trees_close(port_state["resnet"], new_state["resnet"], 1e-5, 1e-5, "resnet BN")
    if spatial:  # the head does not run: its statistics stay
        assert_trees_close(port_state["last_layer"], state["last_layer"], 0, 0, "head BN")
    else:
        assert not np.allclose(new_state["last_layer"]["running_var"], 1.0)
        assert_trees_close(port_state["last_layer"], new_state["last_layer"], 1e-5, 1e-5, "head BN")
    # eval mode reads the moved statistics and moves nothing
    model.eval()
    before = model_trees(model)[1]
    want_eval, _ = _jax_encode(params["encoder"], new_state, jcfg.encoder_config(), jnp.asarray(x), False)
    np.testing.assert_allclose(model.encoder(torch.from_numpy(x.copy())).detach().numpy(), np.asarray(want_eval),
                               rtol=1e-4, atol=1e-4)
    assert_trees_close(model_trees(model)[1]["resnet"], before["resnet"], 0, 0, "eval BN")


def test_pooled_head_train_mode():
    """The pooled head (mean over positions, Linear, BN1d with momentum
    0.01 and the unbiased running variance) in train mode on one feature
    map for both packages: output and moved statistics within 1e-5."""
    jcfg = jax_cfg("gru")
    params, state = jax_init(jcfg)
    fmap = np.random.RandomState(9).rand(4, 2, 2, 512).astype(np.float32) * 3
    head = params["encoder"]
    pooled = jnp.mean(jnp.asarray(fmap), axis=(1, 2))
    h = jnp.dot(pooled, head["linear_secondlast_layer"]["w"]) + head["linear_secondlast_layer"]["b"]
    want, want_state = jax_encoder._bn1d(head["last_layer"], state["last_layer"], h, True)
    model = port_model(jcfg, params, state)
    got = model.encoder.head(torch.from_numpy(fmap))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert_trees_close(model_trees(model)[1]["last_layer"], np_tree(want_state), 1e-5, 1e-6, "head BN")


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_decoder_forward_logits(cell):
    jcfg = jax_cfg(cell)
    params, state = jax_init(jcfg)
    _, captions, lengths = make_batch(1)
    feats = np.random.RandomState(2).randn(4, jcfg.embed_dim).astype(np.float32)
    want = jax_decoder.decoder_forward(params["decoder"], jcfg.decoder_config(), jnp.asarray(feats),
                                       jnp.asarray(captions), jnp.asarray(lengths))
    model = port_model(jcfg, params, state)
    got = decoder_forward(model.decoder, port_cfg(jcfg).decoder_config(), torch.from_numpy(feats),
                          torch.from_numpy(captions), torch.from_numpy(lengths))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("next_token", [False, True], ids=["w_t-to-w_t", "next-token"])
def test_attn_decoder_forward_predictions_and_alphas(cell, next_token):
    """Lengths that differ from row to row, so the freeze mask bites; the
    next-token alignment runs over lengths - 1, as captioner_loss gives it."""
    jcfg = jax_cfg("attn" if cell == "gru" else "attn_lstm")
    params, state = jax_init(jcfg)
    _, captions, lengths = make_batch(3)
    if next_token:
        lengths = np.maximum(lengths - 1, 0).astype(np.int32)
    assert len(set(lengths.tolist())) > 1
    feats = np.random.RandomState(4).rand(4, 512, 4).astype(np.float32)
    want_p, want_a = jax_attention.attn_decoder_forward(params["decoder"], jcfg.decoder_config(), jnp.asarray(feats),
                                                        jnp.asarray(captions), jnp.asarray(lengths))
    model = port_model(jcfg, params, state)
    got_p, got_a = attn_decoder_forward(model.decoder, port_cfg(jcfg).decoder_config(), torch.from_numpy(feats),
                                        torch.from_numpy(captions), torch.from_numpy(lengths))
    np.testing.assert_allclose(got_p.detach().numpy(), np.asarray(want_p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_a.detach().numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-5)
    dead = np.arange(captions.shape[1])[None, :] >= lengths[:, None]
    assert dead.any() and not got_p.detach().numpy()[dead].any() and not got_a.detach().numpy()[dead].any()


def test_masked_cross_entropy_and_penalty():
    rng = np.random.RandomState(5)
    logits = (rng.randn(4, 9, 40) * 3).astype(np.float32)
    _, targets, lengths = make_batch(6)
    alphas = rng.rand(4, 9, 4).astype(np.float32)
    want = float(jax_decoder.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(lengths)))
    got = float(masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets), torch.from_numpy(lengths)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the packed CE: torch's cross_entropy over the valid positions only
    valid = np.arange(9)[None, :] < lengths[:, None]
    packed = torch.nn.functional.cross_entropy(torch.from_numpy(logits[valid]), torch.from_numpy(targets[valid]).long())
    np.testing.assert_allclose(got, float(packed), rtol=1e-6)
    want_p = float(jax_attention.doubly_stochastic_penalty(jnp.asarray(alphas)))
    np.testing.assert_allclose(float(doubly_stochastic_penalty(torch.from_numpy(alphas))), want_p, rtol=1e-6)


@pytest.mark.parametrize("variant,next_token", [(v, False) for v in VARIANTS] + [("attn", True), ("attn_lstm", True)])
def test_captioner_loss_and_gradients(variant, next_token):
    """captioner_loss in train mode and the gradient of every trainable
    parameter against jax.value_and_grad of the JAX loss (rtol 1e-4, atol
    1e-6), and the BN statistics both moved."""
    jcfg = jax_cfg(variant, attn_next_token=next_token)
    params, state = jax_init(jcfg)
    images_u8, captions, lengths = make_batch(7)
    x = _images(images_u8)
    trainable, frozen = jax_captioner.split_trainable(params)

    def loss_fn(tr):
        return jax_captioner.captioner_loss(jax_captioner.merge_params(tr, frozen), state, jcfg, jnp.asarray(x),
                                            jnp.asarray(captions), jnp.asarray(lengths), training=True)

    (want, new_state), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)
    model = port_model(jcfg, params, state)
    loss = captioner_loss(model, port_cfg(jcfg), torch.from_numpy(x.copy()), torch.from_numpy(captions),
                          torch.from_numpy(lengths))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert_trees_close(port_grads(model), trainable_tree_to_port(np_tree(grads)), 1e-4, 1e-6, "grad")
    assert_trees_close(model_trees(model)[1]["resnet"], np_tree(new_state)["resnet"], 1e-5, 1e-5, "BN")


def test_forward_images_from_the_port_preprocess():
    """The port's preprocess without flips gives the JAX package's images
    within one f32 ulp (XLA folds /255 and the normalization differently)."""
    images_u8, _, _ = make_batch(8)
    got = preprocess_images(torch.from_numpy(images_u8), augment=False).numpy()
    np.testing.assert_allclose(got, _images(images_u8), rtol=0, atol=5e-7)
