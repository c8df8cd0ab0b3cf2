"""The port's serving input path against the JAX package's, on the CPU:
``Captioner(s2d=True)`` (the fused stem's plain twin here), ``stage``,
``ServeImageCache``, ``caption_paths`` and the CLI's ``--s2d`` and
``--image_cache``.

A seeded tiny model (ResNet-18, E=16, H=24, L=1) is written as a JAX-format
pickle checkpoint by the JAX package's own writer and loaded by both
packages' Captioners in f32.  Images are made from a seed with numpy and
written as JPEGs with PIL.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from show_tell_tpu.data.transforms import host_space_to_depth as jax_host_space_to_depth
from show_tell_tpu.data.transforms import preprocess_images_s2d as jax_preprocess_images_s2d
from show_tell_tpu.models import captioner as jax_captioner
from show_tell_tpu.models.encoder import encoder_forward
from show_tell_tpu.serve import Captioner as JaxCaptioner
from show_tell_tpu.train.checkpoint import create_checkpoint
from show_tell_tpu.train.train_step import TrainState
from show_tell_tpu.vocab.vocabulary import DatasetVocabulary, save_vocab
from show_tell_tpu_torch import serve as port_serve
from show_tell_tpu_torch.data.serve_cache import ServeImageCache
from show_tell_tpu_torch.data.transforms import host_space_to_depth, preprocess_images_s2d
from show_tell_tpu_torch.models.captioner import captioner_greedy_decode
from show_tell_tpu_torch.models.decoder import greedy_loop
from show_tell_tpu_torch.models.rnn_cells import init_state
from show_tell_tpu_torch.ops.fused_step import fused_gru_decode_step_plain
from show_tell_tpu_torch.ops.vocab import project_logits
from show_tell_tpu_torch.serve import Captioner, Staged, caption_paths

KW = dict(variant="gru", resnet_version=18, embed_dim=16, hidden_dim=24, num_layers=1, compute_dtype="float32")
WORDS = ["a", "man", "dog", "on", "the", "with", "red", "bus", "plate", "of", "cat", "wave"]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(checkpoint, vocab.pkl) of a seeded model, BN statistics off the identity."""
    root = str(tmp_path_factory.mktemp("serve_path"))
    vocab = DatasetVocabulary()
    for w in ["<pad>", "<start>", "<end>", "<unk>"] + WORDS:
        vocab.add_new_word(w)
    cfg = jax_captioner.CaptionerConfig("gru", 18, 16, 24, len(vocab), 1)
    params, bn_state = jax_captioner.init_captioner(jax.random.PRNGKey(21), cfg)
    rng = np.random.RandomState(21)
    bn_state = jax.tree.map(lambda v: v + rng.uniform(0.0, 0.3, v.shape).astype(np.float32), bn_state)
    trainable, frozen = jax_captioner.split_trainable(params)
    state = TrainState(trainable, frozen, bn_state, optax.adam(1e-3).init(trainable), jax.random.PRNGKey(1), np.int32(0))
    ckpt = create_checkpoint(state, 1, 0, [], {"output_dir": root})
    vocab_path = os.path.join(root, "vocab.pkl")
    save_vocab(vocab, vocab_path)
    return ckpt, vocab_path


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Eight JPEGs of assorted sizes, pixels from a seed."""
    root = tmp_path_factory.mktemp("serve_images")
    rng = np.random.RandomState(5)
    for i in range(8):
        h, w = 48 + 16 * (i % 3), 64 + 8 * (i % 4)
        base = rng.randint(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)  # blocky, so JPEG keeps some structure
        arr = np.kron(base, np.ones((8, 8, 1), np.uint8))
        Image.fromarray(arr).save(str(root / ("img%02d.jpg" % i)), quality=90)
    return str(root)


def _paths(image_dir):
    return sorted(os.path.join(image_dir, f) for f in os.listdir(image_dir))


def _port(model, **kw):
    return Captioner.from_checkpoint(*model, device="cpu", **KW, **kw)


def test_s2d_captioner_matches_jax_s2d_captioner(model):
    """Captioner(s2d=True) on the CPU (the fused stem's plain twin, then
    layer1-4) against JAX's Captioner(s2d=True) (its preprocess and 4x4
    conv1): features within 1e-4 relative, ids equal.  The smallest top-2
    logit gap of the port's decode is asserted, so that a future flip of
    an id explains itself.  The port takes the pixels as decoded, JAX
    their host s2d relayout."""
    rgb = np.random.RandomState(3).randint(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    images = host_space_to_depth(rgb)
    ref = JaxCaptioner.from_checkpoint(*model, s2d=True, **KW)
    port = _port(model, s2d=True)
    ids = port.caption_ids(rgb)
    np.testing.assert_array_equal(ids, ref.caption_ids(images))
    assert port.caption(rgb) == ref.caption(images)

    jcfg = ref.cfg
    x = jax_preprocess_images_s2d(images, jax.random.PRNGKey(0), augment=False)
    ref_feats, _ = encoder_forward(ref.params["encoder"], ref.bn_state, jcfg.encoder_config(), x, training=False)
    ref_feats = np.asarray(ref_feats)
    with torch.inference_mode():
        feats = port.model.encoder.encode_u8(torch.from_numpy(rgb), s2d=True)
    np.testing.assert_allclose(feats.numpy(), ref_feats, rtol=1e-4, atol=1e-4 * np.abs(ref_feats).max())

    prep, gaps = port.prepared, []

    def step(xx, hs):
        tok, hs2 = fused_gru_decode_step_plain(prep["stacked"], prep["vocab"], xx, hs)
        top2 = project_logits(prep["vocab"], hs2[-1]).topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).min().item())
        return tok, hs2

    with torch.inference_mode():
        plain_ids = greedy_loop(step, prep["embedding"], feats, init_state("gru", 1, 2, 24, torch.float32), 25)
    np.testing.assert_array_equal(plain_ids.numpy(), ids)
    assert min(gaps) > 1e-3, "a top-2 logit gap of %g: a 1e-4 feature difference may flip that id" % min(gaps)


def test_s2d_and_stock_captioners_caption_alike(model):
    """Same pixels through the stock and the s2d Captioner (the fused stem
    fed RGB, and fed the s2d layout), and through the JAX package's s2d
    composite (normalized s2d input, 4x4 conv1): equal ids in f32, greedy
    and beam."""
    rgb = np.random.RandomState(4).randint(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    stock, s2d = _port(model), _port(model, s2d=True)
    ids = stock.caption_ids(rgb)
    np.testing.assert_array_equal(s2d.caption_ids(rgb), ids)  # the fused stem reads RGB through index math
    np.testing.assert_array_equal(s2d.caption_ids(host_space_to_depth(rgb)), ids)
    with torch.inference_mode():
        x12 = preprocess_images_s2d(torch.from_numpy(host_space_to_depth(rgb)), augment=False)
        conv = captioner_greedy_decode(s2d.model, s2d.cfg, x12, s2d.prepared)
    np.testing.assert_array_equal(conv.numpy(), ids)
    np.testing.assert_array_equal(s2d.caption_ids(rgb, beam_size=2), stock.caption_ids(rgb, 2))


def test_stage_on_the_cpu_and_staged_captioning(model):
    port = _port(model, s2d=True)
    images = np.random.RandomState(6).randint(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    staged = port.stage(images)
    assert isinstance(staged, Staged) and staged.ready is None
    assert staged.images.device.type == "cpu" and staged.images.dtype == torch.uint8
    np.testing.assert_array_equal(staged.images.numpy(), images)
    np.testing.assert_array_equal(port.caption_ids(staged), port.caption_ids(images))
    assert port.caption(staged) == port.caption(torch.from_numpy(images))


def test_load_files_equals_the_jax_pil_loader(model, image_dir):
    """Both Captioners load the decoded RGB rows (the s2d one relays out
    nothing on the host), the bytes of the JAX Captioner's loader (its
    native decoder, PIL for a file it rejects); JAX's s2d Captioner
    captions their relayout alike."""
    paths = _paths(image_dir)[:3]
    s2d, stock = _port(model, s2d=True), _port(model)
    rgb = stock.load_files(paths)
    assert rgb.shape == (3, 224, 224, 3) and rgb.dtype == np.uint8
    np.testing.assert_array_equal(s2d.load_files(paths), rgb)
    ref = JaxCaptioner.from_checkpoint(*model, s2d=True, **KW)
    loaded = ref.load_files(paths, rgb=True)
    np.testing.assert_array_equal(loaded, rgb)
    pil = np.stack([ref._pil_load(p) for p in paths])  # the JAX package's PIL loader, its parity reference
    assert np.abs(pil.astype(int) - rgb).max() <= 2
    assert s2d.caption_files(paths) == ref.caption(jax_host_space_to_depth(loaded))


def test_serve_image_cache_roundtrip_staleness_and_corruption(tmp_path):
    img = tmp_path / "a.jpg"
    img.write_bytes(b"not really a jpeg")
    cache = ServeImageCache(str(tmp_path / "cache"), 224)
    arr = np.random.RandomState(0).randint(0, 256, (224, 224, 3), dtype=np.uint8)
    assert cache.get(str(img)) is None and (cache.hits, cache.misses) == (0, 1)
    cache.put(str(img), arr)
    np.testing.assert_array_equal(cache.get(str(img)), arr)
    assert (cache.hits, cache.misses) == (1, 1)
    assert not [f for f in os.listdir(tmp_path / "cache") if f.endswith(".tmp")]  # the rename left no temporary

    st = os.stat(img)  # a newer mtime is another key: a miss
    os.utime(img, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    assert cache.get(str(img)) is None
    cache.put(str(img), arr)
    img.write_bytes(b"not really a jpeg, and longer")  # so is another size
    os.utime(img, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
    assert cache.get(str(img)) is None
    cache.put(str(img), arr)
    assert cache.get(str(img)) is not None

    entries = [f for f in os.listdir(tmp_path / "cache") if f.endswith(".npy")]
    assert len(entries) == 3
    for f in entries:  # corrupt every entry: each read is a miss, and a put repairs it
        (tmp_path / "cache" / f).write_bytes(b"\x93NUMPY garbage")
    hits, misses = cache.hits, cache.misses
    assert cache.get(str(img)) is None and (cache.hits, cache.misses) == (hits, misses + 1)
    np.save(str(tmp_path / "cache" / entries[0]), np.zeros((10, 10, 3), np.uint8))
    cache.put(str(img), arr)
    np.testing.assert_array_equal(cache.get(str(img)), arr)
    assert cache.get(str(tmp_path / "missing.jpg")) is None  # no file, no key: not counted
    assert cache.misses == misses + 1


def test_caption_paths_order_padding_and_overlap(model, image_dir, tmp_path):
    """Five files at batch 2: three batches of one shape, the last padded
    with its last image, outputs in input order and sliced; the
    overlapped pipeline equals the serial one and each batch captioned on
    its own; the cache serves a second pass entirely; no files, no output."""
    port = _port(model, s2d=True)
    paths = _paths(image_dir)[:5]
    seen = []
    caption = port.caption

    def recording(images, beam_size=0):
        seen.append(images.images.clone())
        return caption(images, beam_size)

    port.caption = recording
    out = list(caption_paths(port, paths, 2))
    assert [p for p, _ in out] == paths
    assert [tuple(s.shape) for s in seen] == [(2, 224, 224, 3)] * 3
    np.testing.assert_array_equal(seen[2][1].numpy(), seen[2][0].numpy())  # the padding repeats the last image
    np.testing.assert_array_equal(seen[2][0].numpy(), port.load_files(paths[4:])[0])
    port.caption = caption
    assert list(caption_paths(port, paths, 2, overlap=False)) == out
    expected = [c for lo in (0, 2) for c in port.caption_files(paths[lo : lo + 2])]
    assert [c for _, c in out[:4]] == expected

    cache = ServeImageCache(str(tmp_path / "cache"), 224)
    assert list(caption_paths(port, paths, 2, cache=cache)) == out
    assert (cache.hits, cache.misses) == (0, 5)
    assert list(caption_paths(port, paths, 2, cache=cache, overlap=False)) == out
    assert (cache.hits, cache.misses) == (5, 5)
    assert list(caption_paths(port, [], 2)) == []


def test_caption_paths_runs_fewer_files_than_a_batch_unpadded(model, image_dir):
    """A request smaller than the batch size is one batch of its own size:
    no padding to ``batch_size``, in both modes, with the captions of
    ``caption_files``."""
    port = _port(model, s2d=True)
    paths = _paths(image_dir)[:3]
    one, three = port.caption_files(paths[:1]), port.caption_files(paths)
    seen = []
    caption = port.caption

    def recording(images, beam_size=0):
        seen.append(tuple(images.images.shape))
        return caption(images, beam_size)

    port.caption = recording
    for overlap in (True, False):
        assert list(caption_paths(port, paths[:1], 64, overlap=overlap)) == [(paths[0], one[0])]
        assert list(caption_paths(port, paths, 64, overlap=overlap)) == list(zip(paths, three))
    assert seen == [(1, 224, 224, 3), (3, 224, 224, 3)] * 2


def test_cli_s2d_with_image_cache(model, image_dir, tmp_path, capsys):
    """--s2d 1 --image_cache prints the captions of Captioner(s2d=True).caption_files
    for the same images, and a second run is served from the cache alone."""
    ckpt, vocab = model
    cache_dir = str(tmp_path / "cache")
    argv = ["--ckpt", ckpt, "--vocab", vocab, "--resnet_version", "18", "--embedding_length", "16",
            "--num_hidden_units", "24", "--num_layers", "1", "--batch_size", "8", "--compute_dtype", "float32",
            "--device", "cpu", "--s2d", "1", "--image_cache", cache_dir, image_dir]
    paths = _paths(image_dir)
    expected = ["%s\t%s" % pc for pc in zip(paths, _port(model, s2d=True).caption_files(paths))]
    for run, report in enumerate(("0 hits, 8 misses", "8 hits, 0 misses")):
        assert port_serve.main(argv) == 0
        captured = capsys.readouterr()
        assert captured.out.strip().splitlines() == expected, run
        assert "image cache %s: %s" % (cache_dir, report) in captured.err
    assert len([f for f in os.listdir(cache_dir) if f.endswith(".npy")]) == 8
