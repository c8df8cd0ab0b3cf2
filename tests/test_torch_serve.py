"""The port's serving slice against the JAX package's, end to end on the CPU.

A seeded tiny model (ResNet-18, E=16, H=24, L=1 and L=2) is written as a
JAX-format pickle checkpoint by the JAX package's own writer (optimizer
state included), then loaded by both packages' Captioners in f32.  Ids
must be bit-equal and the caption strings equal.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from fixtures import build_mini_coco
from show_tell_tpu.models import captioner as jax_captioner
from show_tell_tpu.serve import Captioner as JaxCaptioner
from show_tell_tpu.train.checkpoint import create_checkpoint
from show_tell_tpu.train.train_step import TrainState
from show_tell_tpu.vocab.vocabulary import DatasetVocabulary, save_vocab
from show_tell_tpu_torch import serve as port_serve
from show_tell_tpu_torch.serve import Captioner, load_checkpoint

KW = dict(variant="gru", resnet_version=18, embed_dim=16, hidden_dim=24, compute_dtype="float32")
WORDS = ["a", "man", "dog", "on", "the", "with", "red", "bus", "plate", "of", "cat", "wave"]


def _write_model(root, num_layers, seed):
    vocab = DatasetVocabulary()
    for w in ["<pad>", "<start>", "<end>", "<unk>"] + WORDS:
        vocab.add_new_word(w)
    cfg = jax_captioner.CaptionerConfig("gru", 18, 16, 24, len(vocab), num_layers)
    params, bn_state = jax_captioner.init_captioner(jax.random.PRNGKey(seed), cfg)
    # Move the BN statistics off the identity so the checkpoint carries them.
    rng = np.random.RandomState(seed)
    bn_state = jax.tree.map(lambda v: v + rng.uniform(0.0, 0.3, v.shape).astype(np.float32), bn_state)
    trainable, frozen = jax_captioner.split_trainable(params)
    opt_state = optax.adam(1e-3).init(trainable)
    state = TrainState(trainable, frozen, bn_state, opt_state, jax.random.PRNGKey(1), np.int32(0))
    out = os.path.join(root, "L%d" % num_layers)
    os.makedirs(out, exist_ok=True)
    ckpt = create_checkpoint(state, 1, 0, [], {"output_dir": out})
    vocab_path = os.path.join(out, "vocab.pkl")
    save_vocab(vocab, vocab_path)
    return ckpt, vocab_path


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_serve"))
    return {L: _write_model(root, L, seed=10 + L) for L in (1, 2)}


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(3).randint(0, 256, (2, 64, 64, 3), dtype=np.uint8)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_caption_ids_bit_equal_to_jax_captioner(models, images, num_layers):
    ckpt, vocab = models[num_layers]
    ref = JaxCaptioner.from_checkpoint(ckpt, vocab, num_layers=num_layers, **KW)
    port = Captioner.from_checkpoint(ckpt, vocab, num_layers=num_layers, device="cpu", **KW)
    ref_ids = ref.caption_ids(images)
    ids = port.caption_ids(images)
    assert ids.shape == (2, 25) and ids.dtype == np.int32
    np.testing.assert_array_equal(ids, ref_ids)
    assert port.caption(images) == ref.caption(images)


def test_early_exit_captions_equal_jax(models, images):
    ckpt, vocab = models[2]
    ref = JaxCaptioner.from_checkpoint(ckpt, vocab, num_layers=2, early_exit=True, **KW)
    port = Captioner.from_checkpoint(ckpt, vocab, num_layers=2, early_exit=True, device="cpu", **KW)
    np.testing.assert_array_equal(port.caption_ids(images), ref.caption_ids(images))
    assert port.caption(images) == ref.caption(images)


def test_checkpoint_reader_needs_no_jax_classes(models):
    """The reader returns the JAX layout as numpy and turns the optimizer's
    tuples into inert placeholders."""
    params, bn_state = load_checkpoint(models[2][0])
    assert params["decoder"]["rnn"][1]["w_hh"].shape == (24, 72)
    assert isinstance(params["encoder"]["resnet"]["conv1.weight"], np.ndarray)
    assert set(bn_state) == {"resnet", "last_layer"}


def test_bf16_serving_runs_on_cpu(models, images):
    ckpt, vocab = models[1]
    kw = dict(KW, compute_dtype="bfloat16")
    port = Captioner.from_checkpoint(ckpt, vocab, num_layers=1, device="cpu", **kw)
    assert port.model.decoder.linear.weight.dtype == torch.bfloat16
    assert port.model.encoder.resnet.bn1.running_var.dtype == torch.bfloat16
    ids = port.caption_ids(images)
    assert ids.shape == (2, 25) and ids.min() >= 0 and ids.max() < 4 + len(WORDS)


def test_cli_prints_one_line_per_image(models, tmp_path, capsys):
    ckpt, vocab = models[1]
    build_mini_coco(str(tmp_path / "data"))
    img_dir = str(tmp_path / "data" / "train2014")
    rc = port_serve.main([
        "--ckpt", ckpt, "--vocab", vocab, "--resnet_version", "18", "--embedding_length", "16",
        "--num_hidden_units", "24", "--num_layers", "1", "--batch_size", "3",
        "--compute_dtype", "float32", "--device", "cpu", img_dir,
    ])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    files = sorted(f for f in os.listdir(img_dir) if f.endswith(".jpg"))
    assert len(lines) == len(files) == 8
    for line, f in zip(lines, files):
        path, _, caption = line.partition("\t")
        assert path == os.path.join(img_dir, f) and isinstance(caption, str)


def test_cli_rejects_missing_path_and_gpu_without_cuda(models, capsys):
    ckpt, vocab = models[1]
    assert port_serve.main(["--ckpt", ckpt, "--vocab", vocab, "--device", "cpu", "/no/such/image.jpg"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Captioner.from_checkpoint(ckpt, vocab, num_layers=1, device="gpu", **KW)
