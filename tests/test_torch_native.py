"""The port's native JPEG decoder (native/fastimage.py, its own copy of the
JAX package's) and the ``fast_jpeg`` path through the serving API, on the
CPU.

JPEGs of MS-COCO's common sizes (640 x 480, 480 x 640, 640 x 427: smooth
colour fields under grain, from a seed) are written with PIL.  The port's
``load_images`` must give the JAX ``Captioner.load_files`` bytes, native
decode and PIL fallback alike.
"""

import os
import types

import jax
import numpy as np
import optax
import pytest
from PIL import Image

from show_tell_tpu.models import captioner as jax_captioner
from show_tell_tpu.serve import Captioner as JaxCaptioner
from show_tell_tpu.train.checkpoint import create_checkpoint
from show_tell_tpu.train.train_step import TrainState
from show_tell_tpu.vocab.vocabulary import DatasetVocabulary, save_vocab
from show_tell_tpu_torch import serve as port_serve
from show_tell_tpu_torch.data.images import load_images, pil_load
from show_tell_tpu_torch.data.serve_cache import ServeImageCache
from show_tell_tpu_torch.native import build as native_build
from show_tell_tpu_torch.native import fastimage
from show_tell_tpu_torch.serve import Captioner, caption_paths

COCO_SIZES = ((640, 480), (480, 640), (640, 427))  # (width, height)
KW = dict(variant="gru", resnet_version=18, embed_dim=16, hidden_dim=24, num_layers=1, compute_dtype="float32")


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_jpegs")
    rng = np.random.RandomState(11)
    paths = []
    for i, (w, h) in enumerate(COCO_SIZES):
        base = Image.fromarray(rng.randint(0, 256, (h // 32, w // 32, 3), dtype=np.uint8))
        field = np.asarray(base.resize((w, h), Image.BILINEAR), np.float32)
        pixels = np.clip(field + rng.normal(0.0, 12.0, (h, w, 3)), 0, 255).astype(np.uint8)
        paths.append(str(root / ("img%d.jpg" % i)))
        Image.fromarray(pixels).save(paths[-1], quality=90)
    return paths


def _jax_load_files(paths, fast_jpeg):
    """The JAX Captioner's loader (its native decoder, PIL per rejected file) on RGB rows."""
    loader = types.SimpleNamespace(s2d=False, _pil_load=JaxCaptioner._pil_load)
    return JaxCaptioner.load_files(loader, paths, fast_jpeg)


@pytest.mark.parametrize("fast_jpeg", [False, True], ids=["full", "fast_jpeg"])
def test_load_images_bit_equal_to_the_jax_loader(jpegs, fast_jpeg):
    got = load_images(jpegs, fast_jpeg)
    assert got.shape == (len(jpegs), 224, 224, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _jax_load_files(jpegs, fast_jpeg))
    assert fastimage.is_available() and fastimage.status().startswith("native (")
    pil = np.stack([pil_load(p) for p in jpegs])
    assert np.abs(got.astype(int) - pil).max() <= (8 if fast_jpeg else 2)  # PIL's filter, other roundings


def test_a_file_the_decoder_rejects_falls_back_to_pil_alone(jpegs, tmp_path):
    png = str(tmp_path / "not_a_jpeg.png")
    Image.open(jpegs[0]).save(png)
    paths = [jpegs[1], png, jpegs[2]]
    got = load_images(paths)
    np.testing.assert_array_equal(got[1], pil_load(png))
    np.testing.assert_array_equal(got[[0, 2]], load_images([jpegs[1], jpegs[2]]))
    np.testing.assert_array_equal(got, _jax_load_files(paths, False))


def test_build_reports_why_without_a_compiler(monkeypatch):
    monkeypatch.setenv("PATH", "")
    path, why = native_build.build()
    assert path == "" and why.startswith("g++ cannot run")


def test_cache_keys_differ_by_fast_jpeg(jpegs, tmp_path):
    full, fast = (ServeImageCache(str(tmp_path), 224, fast_jpeg=f) for f in (False, True))
    assert full._key(jpegs[0]) != fast._key(jpegs[0])
    full.put(jpegs[0], load_images(jpegs[:1])[0])
    assert fast.get(jpegs[0]) is None and full.get(jpegs[0]) is not None


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(checkpoint, vocab.pkl) of a seeded tiny pooled-GRU model, written by the JAX package."""
    root = str(tmp_path_factory.mktemp("native_model"))
    vocab = DatasetVocabulary()
    for w in ["<pad>", "<start>", "<end>", "<unk>", "a", "dog", "on", "the", "bus", "red", "cat"]:
        vocab.add_new_word(w)
    cfg = jax_captioner.CaptionerConfig("gru", 18, 16, 24, len(vocab), 1)
    params, bn_state = jax_captioner.init_captioner(jax.random.PRNGKey(12), cfg)
    trainable, frozen = jax_captioner.split_trainable(params)
    state = TrainState(trainable, frozen, bn_state, optax.adam(1e-3).init(trainable), jax.random.PRNGKey(1),
                       np.int32(0))
    ckpt = create_checkpoint(state, 1, 0, [], {"output_dir": root})
    vocab_path = os.path.join(root, "vocab.pkl")
    save_vocab(vocab, vocab_path)
    return ckpt, vocab_path


def test_cli_fast_jpeg_captions_the_files_as_the_api_does(model, jpegs, tmp_path, capsys):
    """serve.main --fast_jpeg 1 --image_cache prints Captioner.caption_files(fast_jpeg=True)'s
    captions; caption_paths agrees; the cache holds the scaled decode under
    its own key."""
    ckpt, vocab = model
    port = Captioner.from_checkpoint(ckpt, vocab, device="cpu", **KW)
    expected = port.caption_files(jpegs, fast_jpeg=True)
    assert [c for _, c in caption_paths(port, jpegs, 2, fast_jpeg=True)] == expected
    cache_dir = str(tmp_path / "cache")
    argv = ["--ckpt", ckpt, "--vocab", vocab, "--resnet_version", "18", "--embedding_length", "16",
            "--num_hidden_units", "24", "--num_layers", "1", "--compute_dtype", "float32", "--device", "cpu",
            "--fast_jpeg", "1", "--image_cache", cache_dir, *jpegs]
    assert port_serve.main(argv) == 0
    assert capsys.readouterr().out.strip().splitlines() == ["%s\t%s" % pc for pc in zip(jpegs, expected)]
    fast = ServeImageCache(cache_dir, 224, fast_jpeg=True)
    np.testing.assert_array_equal(fast.get(jpegs[0]), load_images(jpegs[:1], fast_jpeg=True)[0])
    assert ServeImageCache(cache_dir, 224).get(jpegs[0]) is None
