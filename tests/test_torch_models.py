"""The port's models and weight bridge against the JAX package, on the CPU.

Weights come from the JAX package's own init (seeded), cross the bridge
(models/convert.py), and the same seeded numpy inputs go through both
packages' forwards in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from show_tell_tpu.data.transforms import preprocess_images as jax_preprocess_images
from show_tell_tpu.models import captioner as jax_captioner
from show_tell_tpu.models.convert import decoder_params_to_torch
from show_tell_tpu.models.decoder import greedy_decode as jax_greedy_decode
from show_tell_tpu.models.encoder import encoder_forward
from show_tell_tpu.models.resnet import init_resnet_params, resnet_forward
from show_tell_tpu.ops.rnn_pallas import greedy_decode_pallas
from show_tell_tpu_torch.data.transforms import preprocess_images
from show_tell_tpu_torch.models.captioner import (
    CaptionerConfig,
    CaptionerModel,
    build_model,
    init_captioner,
    prepare_decode,
)
from show_tell_tpu_torch.models.convert import params_from_jax, params_to_jax
from show_tell_tpu_torch.models.decoder import greedy_decode
from show_tell_tpu_torch.models.resnet import ResNet
from show_tell_tpu_torch.ops.rnn import greedy_decode_kernel

CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_model(version, E=16, H=24, V=40, L=2, seed=0, random_bn=True):
    """Seeded JAX captioner trees; BN statistics randomized so eval-mode
    BN is not the identity."""
    cfg = jax_captioner.CaptionerConfig("gru", version, E, H, V, L)
    params, state = _np_tree(jax_captioner.init_captioner(jax.random.PRNGKey(seed), cfg))
    if random_bn:
        rng = np.random.RandomState(seed)
        for tree in (params["encoder"]["resnet"], state["resnet"], params["encoder"]["last_layer"],
                     state["last_layer"]):
            for k, v in tree.items():
                if v.ndim == 1:
                    lo = 0.5 if ("var" in k or k.endswith("weight")) else -0.2
                    tree[k] = rng.uniform(lo, lo + 0.5, v.shape).astype(np.float32)
    return cfg, params, state


def _port_cfg(jcfg):
    return CaptionerConfig(*jcfg)


def model_cfg(jcfg):
    return _port_cfg(jcfg).decoder_config()


@pytest.mark.parametrize("version", [18, 50])
def test_resnet_eval_matches_jax(version):
    jcfg, params, state = _jax_model(version, seed=version)
    model = build_model(params, state, _port_cfg(jcfg), torch.float32, CPU)
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    ref, _ = resnet_forward(params["encoder"]["resnet"], state["resnet"], version, jnp.asarray(x), training=False)
    with torch.inference_mode():
        got = model.encoder.resnet(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_resnet101_keys_and_shapes_match_jax_init():
    """ResNet-101 (the flagship backbone): the bridge's keys and OIHW
    shapes are exactly the port module's, with no forward pass."""
    shapes = jax.eval_shape(lambda k: init_resnet_params(k, 101), jax.random.PRNGKey(0))
    p = {k: np.zeros(s.shape, np.float32) for k, s in shapes[0].items()}
    s = {k: np.zeros(v.shape, np.float32) for k, v in shapes[1].items()}
    enc = {"resnet": p, "linear_secondlast_layer": {"w": np.zeros((2048, 8), np.float32),
                                                    "b": np.zeros(8, np.float32)},
           "last_layer": {"weight": np.ones(8, np.float32), "bias": np.zeros(8, np.float32)}}
    dec = {"embedding": np.zeros((4, 8), np.float32), "rnn": [], "linear": {"w": np.zeros((8, 4), np.float32),
                                                                           "b": np.zeros(4, np.float32)}}
    bn = {"resnet": s, "last_layer": {"running_mean": np.zeros(8, np.float32), "running_var": np.ones(8, np.float32)}}
    sd = params_from_jax({"encoder": enc, "decoder": dec}, bn)["encoder"]
    bridged = {k[len("resnet."):]: v.shape for k, v in sd.items() if k.startswith("resnet.")}
    with torch.device("meta"):
        ported = {k: tuple(v.shape) for k, v in ResNet(101).state_dict().items()}
    assert bridged == ported
    assert len(ported) == len(p) + len(s) and any(k.startswith("layer3.22.") for k in ported)


def test_pooled_encoder_matches_jax():
    jcfg, params, state = _jax_model(18, seed=3)
    model = build_model(params, state, _port_cfg(jcfg), torch.float32, CPU)
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    ref, _ = encoder_forward(params["encoder"], state, jcfg.encoder_config(), jnp.asarray(x), training=False)
    with torch.inference_mode():
        got = model.encoder(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def decode_case():
    jcfg, params, state = _jax_model(18, E=16, H=24, V=40, L=2, seed=5, random_bn=False)
    model = build_model(params, state, _port_cfg(jcfg), torch.float32, CPU)
    feats = np.random.RandomState(6).randn(3, 16).astype(np.float32)
    return jcfg, params, model, feats


def test_greedy_decode_bit_equal_to_jax(decode_case):
    """f32 ids over T=25: the port's plain decoder and its fused-step loop
    (plain twin on the CPU) against the JAX XLA decoder and the
    interpreted Pallas fused step."""
    jcfg, params, model, feats = decode_case
    dcfg = jcfg.decoder_config()
    params = jax.tree.map(jnp.asarray, params)
    ref_xla = np.asarray(jax_greedy_decode(params["decoder"], dcfg, jnp.asarray(feats)))
    ref_pallas = np.asarray(greedy_decode_pallas(params["decoder"], dcfg, jnp.asarray(feats), interpret=True))
    with torch.inference_mode():
        plain = greedy_decode(model.decoder, model_cfg(jcfg), torch.from_numpy(feats)).numpy()
        fused = greedy_decode_kernel(prepare_decode(model, torch.float32), torch.from_numpy(feats), 25).numpy()
    assert plain.shape == (3, 25) and plain.dtype == np.int32
    np.testing.assert_array_equal(ref_xla, ref_pallas)
    np.testing.assert_array_equal(plain, ref_xla)
    np.testing.assert_array_equal(fused, ref_pallas)


def test_greedy_early_exit_bit_equal_to_jax(decode_case):
    """The early-exit loop with an <end> that rows really emit: <pad> after
    it, the same ids as the JAX while_loop engine, and the fixed loop's
    ids before it."""
    jcfg, params, model, feats = decode_case
    dcfg = jcfg.decoder_config()
    params = jax.tree.map(jnp.asarray, params)
    fixed = np.asarray(jax_greedy_decode(params["decoder"], dcfg, jnp.asarray(feats)))
    end = int(fixed[0, 2])
    ref = np.asarray(jax_greedy_decode(params["decoder"], dcfg, jnp.asarray(feats), end_token=end))
    ref_pallas = np.asarray(
        greedy_decode_pallas(params["decoder"], dcfg, jnp.asarray(feats), interpret=True, end_token=end)
    )
    with torch.inference_mode():
        plain = greedy_decode(model.decoder, model_cfg(jcfg), torch.from_numpy(feats), end_token=end).numpy()
        fused = greedy_decode_kernel(
            prepare_decode(model, torch.float32), torch.from_numpy(feats), 25, end_token=end
        ).numpy()
    np.testing.assert_array_equal(plain, ref)
    np.testing.assert_array_equal(fused, ref_pallas)
    for row_ids, row_fixed in zip(plain, fixed):
        hits = np.flatnonzero(row_ids == end)
        stop = hits[0] + 1 if len(hits) else 25
        np.testing.assert_array_equal(row_ids[:stop], row_fixed[:stop])
        assert (row_ids[stop:] == 0).all()


def test_bridge_round_trip_and_reference_decoder_keys():
    _, params, state = _jax_model(18, seed=8)
    sds = params_from_jax(params, state)
    back_p, back_s = params_to_jax(sds)
    assert jax.tree.structure(back_p) == jax.tree.structure(params)
    assert jax.tree.structure(back_s) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves((back_p, back_s)), jax.tree.leaves((params, state))):
        np.testing.assert_array_equal(a, b)
    oracle = decoder_params_to_torch(params["decoder"])
    assert sorted(sds["decoder"]) == sorted(oracle)
    for k, v in oracle.items():
        np.testing.assert_array_equal(sds["decoder"][k], v)
    with torch.device("meta"):
        model = CaptionerModel(_port_cfg(jax_captioner.CaptionerConfig("gru", 18, 16, 24, 40, 2)))
    assert sorted(model.encoder.state_dict()) == sorted(sds["encoder"])
    assert sorted(model.decoder.state_dict()) == sorted(sds["decoder"])


def test_init_captioner_matches_jax_tree_and_laws():
    cfg = CaptionerConfig("gru", 18, 16, 24, 40, 2)
    params, state = init_captioner(cfg, torch.Generator().manual_seed(0))
    j_params, j_state = jax.eval_shape(
        lambda k: jax_captioner.init_captioner(k, jax_captioner.CaptionerConfig(*cfg)), jax.random.PRNGKey(0)
    )
    assert jax.tree.structure(params) == jax.tree.structure(j_params)
    assert jax.tree.structure(state) == jax.tree.structure(j_state)
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves((j_params, j_state))):
        assert a.shape == b.shape and a.dtype == np.float32
    conv = params["encoder"]["resnet"]["layer1.0.conv1.weight"]  # 3x3, 64 out: std sqrt(2/576)
    assert abs(conv.std() - np.sqrt(2 / 576)) < 0.1 * np.sqrt(2 / 576)
    w_hh = params["decoder"]["rnn"][1]["w_hh"]
    assert np.abs(w_hh).max() <= 1 / np.sqrt(24) and np.abs(w_hh).max() > 0.9 / np.sqrt(24)
    again, _ = init_captioner(cfg, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again["decoder"]["embedding"], params["decoder"]["embedding"])


def test_preprocess_matches_jax():
    imgs = np.random.RandomState(9).randint(0, 256, (4, 8, 8, 3), dtype=np.uint8)
    ref = np.asarray(jax_preprocess_images(jnp.asarray(imgs), jax.random.PRNGKey(0), augment=False))
    got = preprocess_images(torch.from_numpy(imgs), augment=False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert preprocess_images(torch.from_numpy(imgs), augment=False, dtype=torch.bfloat16).dtype == torch.bfloat16
    # augment: every sample is one of its four flips, drawn from the generator
    flipped = preprocess_images(torch.from_numpy(imgs), torch.Generator().manual_seed(1), augment=True).numpy()
    for out, base in zip(flipped, ref):
        variants = [base, base[:, ::-1], base[::-1], base[::-1, ::-1]]
        assert any(np.allclose(out, v, rtol=0, atol=1e-6) for v in variants)


@pytest.mark.parametrize("variant", ["lstm", "attn_lstm"])
def test_init_captioner_lstm_variants_match_jax_tree_and_laws(variant):
    """The LSTM families: the JAX tree's structure and shapes (4H gate
    rows; init_c for the attention LSTM), the recurrence and init_c laws,
    and a model built from the trees."""
    cfg = CaptionerConfig(variant, 18, 16, 24, 40, 2, nos_filters=512)
    params, state = init_captioner(cfg, torch.Generator().manual_seed(0))
    j_params, j_state = jax.eval_shape(
        lambda k: jax_captioner.init_captioner(k, jax_captioner.CaptionerConfig(*cfg)), jax.random.PRNGKey(0)
    )
    assert jax.tree.structure(params) == jax.tree.structure(j_params)
    assert jax.tree.structure(state) == jax.tree.structure(j_state)
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves((j_params, j_state))):
        assert a.shape == b.shape and a.dtype == np.float32
    dec = params["decoder"]
    assert dec["rnn"][0]["w_ih"].shape == (32 if variant == "attn_lstm" else 16, 96)
    w_hh = dec["rnn"][1]["w_hh"]
    assert np.abs(w_hh).max() <= 1 / np.sqrt(24) and np.abs(w_hh).max() > 0.9 / np.sqrt(24)
    assert ("init_c" in dec) == (variant == "attn_lstm")
    if variant == "attn_lstm":
        w = dec["init_c"]["w"]
        assert w.shape == (512, 24) and 0.9 / np.sqrt(512) < np.abs(w).max() <= 1 / np.sqrt(512)
    model = build_model(params, state, cfg, torch.float32, CPU)
    assert model.decoder.unit.weight_hh_l1.shape == (96, 24)
