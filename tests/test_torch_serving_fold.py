"""The BN-folded serving encoder (models/serving.py) against the JAX
package's fold (show_tell_tpu/models/serving.py) and the port's unfolded
eval encoder, on the CPU.

Seeded JAX-layout trees with every BatchNorm off its identity (gamma,
beta, running mean and variance drawn).  The folded trees must equal the
JAX package's within 1e-6.  The folded encoder's f32 features must equal
the JAX ``folded_encoder_forward``'s within 1e-5 (relative, and absolute
of the features' largest value), and the port's unfolded ``Encoder``'s
within 2e-4, the JAX package's own bar for its fold
(tests/test_serving.py): pooled and spatial ResNet-18 at 224 from uint8
pixels, by the stock path (the preprocess twin) and the s2d path (the stem
twin from the folded conv1), and spatial ResNet-50 (bottlenecks) at 64 by
the stock path.  A folded f32 Captioner's greedy ids equal the unfolded
one's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_helpers import few_torch_threads  # noqa: F401  (autouse: 2 torch threads)
from show_tell_tpu.data.transforms import preprocess_images as jax_preprocess
from show_tell_tpu.models import captioner as jax_captioner
from show_tell_tpu.models.serving import fold_encoder as jax_fold_encoder
from show_tell_tpu.models.serving import folded_encoder_forward
from show_tell_tpu_torch.models.captioner import CaptionerConfig, build_model, encode
from show_tell_tpu_torch.models.serving import FoldedEncoder, fold_encoder
from show_tell_tpu_torch.serve import Captioner

CPU = torch.device("cpu")
# (variant, ResNet, image side, input paths): ResNet-18 at the serving side by both paths (the stem kernel takes
# 224 only), and ResNet-50's bottlenecks by the stock path at 64
CASES = {"pooled": ("gru", 18, 224, (False, True)), "spatial": ("attn", 18, 224, (False, True)),
         "spatial50": ("attn", 50, 64, (False,))}
FEATURE_CASES = [(case, s2d) for case in sorted(CASES) for s2d in CASES[case][3]]


class _Vocab:
    def __init__(self, size):
        self.index_to_word = ["<pad>", "<start>", "<end>", "<unk>"] + ["w%d" % i for i in range(size - 4)]
        self.word_to_index = {w: i for i, w in enumerate(self.index_to_word)}

    def start_token(self):
        return "<start>"

    def end_token(self):
        return "<end>"

    def __len__(self):
        return len(self.index_to_word)


def _trees(variant, version, seed):
    """A tiny captioner's (params, bn_state) numpy trees, every BN off its
    identity (tests/test_torch_models.py's draws: gamma and running var in
    [0.5, 1), beta and running mean in [-0.2, 0.3))."""
    kw = dict(nos_filters=2048 if version == 50 else 512, attn_dim=16) if variant.startswith("attn") else {}
    jcfg = jax_captioner.CaptionerConfig(variant, version, 16, 24, 40, 2, **kw)
    params, bn_state = jax.tree.map(np.asarray, jax_captioner.init_captioner(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed)
    for tree in (params["encoder"]["resnet"], bn_state["resnet"], params["encoder"]["last_layer"],
                 bn_state["last_layer"]):
        for k, v in tree.items():
            if v.ndim == 1:
                lo = 0.5 if ("var" in k or k.endswith("weight")) else -0.2
                tree[k] = rng.uniform(lo, lo + 0.5, v.shape).astype(np.float32)
    return jcfg, params, bn_state


def _images(side):
    return np.random.RandomState(7).randint(0, 256, (2, side, side, 3), dtype=np.uint8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_folded_trees_equal_jax(case):
    variant, version = CASES[case][:2]
    _, params, bn_state = _trees(variant, version, seed=1)
    want = jax_fold_encoder(params["encoder"], bn_state)
    got = fold_encoder(params["encoder"], bn_state)
    assert sorted(got["resnet"]) == sorted(want["resnet"]) and sorted(got["head"]) == sorted(want["head"])
    for part in ("resnet", "head"):
        for k, v in want[part].items():
            assert tuple(got[part][k].shape) == v.shape, k
            np.testing.assert_allclose(got[part][k].numpy(), np.asarray(v), rtol=1e-6, atol=1e-6, err_msg=k)
    cast = fold_encoder(params["encoder"], bn_state, dtype=torch.bfloat16)  # folded in f32, then cast
    assert cast["resnet"]["conv1.weight"].dtype == torch.bfloat16
    assert torch.equal(cast["head"]["w"], got["head"]["w"].to(torch.bfloat16))


@pytest.mark.parametrize("case,s2d", FEATURE_CASES,
                         ids=["%s-%s" % (c, "s2d" if s else "stock") for c, s in FEATURE_CASES])
def test_folded_features_equal_jax_and_unfolded(case, s2d):
    variant, version, side, _ = CASES[case]
    images = _images(side)
    jcfg, params, bn_state = _trees(variant, version, seed=2)
    cfg = CaptionerConfig(*jcfg)
    folded = FoldedEncoder.from_trees(params["encoder"], bn_state, cfg.encoder_config(), torch.float32, CPU)
    unfolded = build_model(params, bn_state, cfg, torch.float32, CPU)
    x = torch.from_numpy(images)
    with torch.no_grad():
        got = folded.encode_u8(x, s2d=s2d).numpy()
        ref_unfolded = unfolded.encoder.encode_u8(x, s2d=s2d).numpy()
    normalized = jax_preprocess(jnp.asarray(images), jax.random.PRNGKey(0), augment=False)
    ref_jax = np.asarray(folded_encoder_forward(jax_fold_encoder(params["encoder"], bn_state), version, normalized,
                                                spatial=cfg.is_attention))
    assert got.shape == ref_jax.shape == ref_unfolded.shape
    # within 1e-5 of the features' scale: the spatial maps reach 14-19 here, and at such values the two libraries'
    # f32 convolutions part by up to 2.5e-5 (1.3e-6 of the scale)
    np.testing.assert_allclose(got, ref_jax, rtol=1e-5, atol=1e-5 * np.abs(ref_jax).max())
    np.testing.assert_allclose(got, ref_unfolded, rtol=2e-4, atol=2e-4)


def test_folded_s2d_stem_operands_equal_the_unfolded():
    """The stem kernel's operands from the folded conv1 are the unfolded encoder's, bit for bit."""
    jcfg, params, bn_state = _trees("gru", 18, seed=3)
    cfg = CaptionerConfig(*jcfg)
    folded = FoldedEncoder.from_trees(params["encoder"], bn_state, cfg.encoder_config(), torch.float32, CPU)
    ref = build_model(params, bn_state, cfg, torch.float32, CPU).encoder.stem_operands()
    for k, v in ref.items():
        assert torch.equal(folded.stem_operands()[k], v), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_folded_captioner_greedy_ids_equal_unfolded(case):
    variant, version, side, paths = CASES[case]
    images = _images(side)
    jcfg, params, bn_state = _trees(variant, version, seed=4)
    cfg = CaptionerConfig(*jcfg)
    kw = dict(compute_dtype="float32", device="cpu")
    folded = Captioner(params, bn_state, cfg, _Vocab(cfg.vocab_size), fold_bn=True, **kw)
    plain = Captioner(params, bn_state, cfg, _Vocab(cfg.vocab_size), fold_bn=False, **kw)
    assert isinstance(folded.model.encoder, FoldedEncoder) and not isinstance(plain.model.encoder, FoldedEncoder)
    for s2d in paths:
        folded.s2d = plain.s2d = s2d
        np.testing.assert_array_equal(folded.caption_ids(images), plain.caption_ids(images), err_msg="s2d %s" % s2d)
    with torch.no_grad():  # captioner.encode reaches the folded encoder through the Encoder surface
        x = torch.from_numpy(images)
        assert encode(folded.model, x).shape == encode(plain.model, x).shape
