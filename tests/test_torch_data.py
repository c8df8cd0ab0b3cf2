"""The port's data path against the JAX package's, on the CPU: the loader's
batches (paths, pixels, captions, lengths) batch for batch with shuffle and
drop_last, by either decoder and through the image cache; the vocabulary
builder's ids and its vocab.pkl in both directions; the tokenizer; the
memmap image cache; and the device prefetch on the CPU.
"""

import numpy as np
import pytest
import torch

from fixtures import CAPTIONS, build_mini_coco, build_mini_flickr, mini_params
from show_tell_tpu.data.dataset import MSCOCO as JaxMSCOCO
from show_tell_tpu.data.dataset import DataLoader as JaxDataLoader
from show_tell_tpu.data.dataset import get_data_loader as jax_get_data_loader
from show_tell_tpu.vocab.tokenize import word_tokenize as jax_word_tokenize
from show_tell_tpu.vocab.vocabulary import get_vocabulary as jax_get_vocabulary
from show_tell_tpu.vocab.vocabulary import load_vocab as jax_load_vocab
from show_tell_tpu_torch.data.dataset import MSCOCO, DataLoader, create_batch, get_data_loader
from show_tell_tpu_torch.data.device_prefetch import device_prefetch
from show_tell_tpu_torch.data.image_cache import ImageCache
from show_tell_tpu_torch.native import fastimage
from show_tell_tpu_torch.vocab import get_vocabulary, load_vocab, tokenizer_name, word_tokenize
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)


@pytest.fixture
def mini(tmp_path):
    build_mini_coco(str(tmp_path / "data"))
    params = mini_params(str(tmp_path / "data"), str(tmp_path / "out"), batch_size=3)
    return params, get_vocabulary("MSCOCO", params)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for (gp, gi, gc, gl), (wp, wi, wc, wl) in zip(got, want):
        assert gp == wp
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gl, wl)
        assert gc.dtype == gl.dtype == np.int32 and gi.dtype == np.uint8


@pytest.mark.parametrize("native", [True, False], ids=["native", "PIL"])
def test_loader_yields_the_jax_loaders_batches(mini, native):
    """Train loader (shuffled by the seed, drop_last) over two epochs and the
    test loader (in order, the partial batch kept): the same paths, pixels,
    captions and lengths as the JAX package's loader, batch for batch."""
    if native and not fastimage.is_available():
        pytest.skip("the native JPEG decoder does not build here: %s" % fastimage.status())
    params, vocab = mini
    jvocab = jax_load_vocab(params["vocab_path"])
    for shuffle, drop_last in ((True, True), (False, False)):
        ds = MSCOCO(params["ann_path_train"], params["data_path_train"], vocab, use_native_decode=native)
        jds = JaxMSCOCO(params["ann_path_train"], params["data_path_train"], jvocab, use_native_decode=native)
        kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last, pad_length=24, seed=7)
        loader, jloader = DataLoader(ds, **kw), JaxDataLoader(jds, **kw)
        assert len(loader) == len(jloader) == (5 if drop_last else 6)
        for _ in range(2):  # the shuffle's stream carries on into the next epoch
            _assert_batches_equal(list(loader), list(jloader))
        assert ds.decoder.startswith("native" if native else "PIL")


def test_get_data_loader_and_cache_match_the_jax_loader(mini, tmp_path):
    """get_data_loader's train and test loaders against the JAX package's,
    with an image cache: a first epoch fills it, a second reads it, the
    batches unchanged."""
    params, vocab = mini
    params = dict(params, image_cache=str(tmp_path / "cache"))
    jparams = dict(params, image_cache=str(tmp_path / "jcache"))
    jvocab = jax_load_vocab(params["vocab_path"])
    for run in ("train", "test"):
        loader, jloader = get_data_loader(vocab, params, run), jax_get_data_loader(jvocab, jparams, run)
        first = list(loader)
        _assert_batches_equal(first, list(jloader))
        assert loader.dataset.image_cache.hit_fraction() == 1.0
        if run == "test":
            _assert_batches_equal(list(loader), first)
    with pytest.raises(NotImplementedError, match="item 6"):
        get_data_loader(vocab, dict(params, multihost=1), "train")
    with pytest.raises(ValueError, match="valid run type"):
        get_data_loader(vocab, params, "eval")


def test_create_batch_sorts_pads_and_cuts():
    img = np.zeros((2, 2, 3), np.uint8)
    samples = [("a", img, [1, 5, 2]), ("b", img, [1, 5, 6, 7, 2]), ("c", img, [1, 9, 9, 2])]
    paths, images, captions, lengths = create_batch(samples, pad_length=4)
    assert paths == ("b", "c", "a") and images.shape == (3, 2, 2, 3)
    np.testing.assert_array_equal(lengths, [4, 4, 3])
    np.testing.assert_array_equal(captions, [[1, 5, 6, 7], [1, 9, 9, 2], [1, 5, 2, 0]])
    assert create_batch(samples, pad_length=None)[2].shape == (3, 5)


@pytest.mark.parametrize("threshold", [1, 2])
def test_vocabulary_builder_matches_the_jax_builder(tmp_path, threshold):
    """The same ids from the same captions (COCO JSON and Flickr TSV), and
    each package reads the other's vocab.pkl."""
    build_mini_coco(str(tmp_path / "coco"))
    build_mini_flickr(str(tmp_path / "flickr"))
    for source, root, ann in (("MSCOCO", "coco", "annotations/captions_train2014.json"),
                              ("Flickr", "flickr", "annotations/captions.tsv")):
        base = dict(data_dir=str(tmp_path / root), train_ann_path=ann, vocab_threshold=threshold)
        port_path, jax_path = str(tmp_path / (source + "_port.pkl")), str(tmp_path / (source + "_jax.pkl"))
        vocab = get_vocabulary(source, dict(base, vocab_path=port_path))
        jvocab = jax_get_vocabulary(source, dict(base, vocab_path=jax_path))
        assert vocab.word_to_index == jvocab.word_to_index and vocab.index == jvocab.index
        assert len(vocab) > 4 and vocab("<unk>") == 3 and vocab("no-such-word") == 3
        assert jax_load_vocab(port_path).word_to_index == vocab.word_to_index
        assert load_vocab(jax_path).index_to_word == jvocab.index_to_word
        assert get_vocabulary(source, dict(base, vocab_path=port_path)).word_to_index == vocab.word_to_index
    with pytest.raises(ValueError, match="valid dataset"):
        get_vocabulary("VOC", dict(base, vocab_path=str(tmp_path / "none.pkl")))


def test_tokenizer_matches_the_jax_tokenizer():
    assert tokenizer_name() is not None  # nltk is installed here
    for _, _, caption in CAPTIONS + [(0, 0, 'A dog\'s "toy" isn\'t red. mr. smith, e.g. at 3:30!')]:
        assert word_tokenize(caption.lower()) == jax_word_tokenize(caption.lower())


def test_image_cache_round_trip(tmp_path):
    names = ["b.jpg", "a.jpg", "c.jpg"]
    cache = ImageCache(str(tmp_path), names, 8)
    img = np.arange(8 * 8 * 3, dtype=np.uint8).reshape(8, 8, 3)
    assert cache.get("a.jpg") is None and cache.hit_fraction() == 0.0
    cache.put("a.jpg", img)
    cache.put("elsewhere.jpg", img)  # outside the index: ignored
    got = cache.get("a.jpg")
    np.testing.assert_array_equal(got, img)
    assert not got.flags.writeable
    again = ImageCache(str(tmp_path), list(reversed(names)), 8)  # another process's view: rows persist
    np.testing.assert_array_equal(again.get("a.jpg"), img)
    assert again.get("c.jpg") is None and again.hit_fraction() == pytest.approx(1 / 3)
    with pytest.raises(ValueError, match="different dataset"):
        ImageCache(str(tmp_path), names, 8, fast_jpeg=True)


def test_device_prefetch_on_the_cpu():
    batches = [(("p%d" % i,), np.full((2, 4, 4, 3), i, np.uint8), np.full((2, 5), i, np.int32),
                np.array([5, 3], np.int32)) for i in range(3)]
    out = list(device_prefetch(iter(batches), "cpu"))
    assert len(out) == 3
    for (p, im, cap, ln), (wp, wim, wcap, wln) in zip(out, batches):
        assert p == wp and isinstance(im, torch.Tensor) and im.device.type == "cpu"
        np.testing.assert_array_equal(im.numpy(), wim)
        np.testing.assert_array_equal(cap.numpy(), wcap)
        np.testing.assert_array_equal(ln.numpy(), wln)
    assert list(device_prefetch(iter([]), "cpu")) == []
