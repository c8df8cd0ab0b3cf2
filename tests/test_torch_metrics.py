"""The port's caption metrics (evaluation/metrics.py), its native scorer
(native/fastmetrics.cpp, built with g++ into build/) and its copy of the
reference's generic beam (decode/generic.py) against the JAX package's,
float for float (``==``): BLEU, CIDEr, ROUGE-L, evaluate() with and
without the reference's last-image quirk, the one-pass nltk method4 BLEU
and the per-image corpus sums, on seeded random caption sets, through the
native scorer and through the Python path (the library disabled, or made
unbuildable)."""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from show_tell_tpu.decode import generic as jax_generic
from show_tell_tpu.evaluation import metrics as jax_metrics
from show_tell_tpu.evaluation.tester import create_caption_word_format as jax_word_format
from show_tell_tpu.native import fastmetrics as jax_fastmetrics
from show_tell_tpu_torch.decode import generic
from show_tell_tpu_torch.evaluation import metrics
from show_tell_tpu_torch.evaluation.tester import create_caption_word_format
from show_tell_tpu_torch.native import fastmetrics

WORDS = ["a", "man", "dog", "on", "the", "red", "bus", "is", "riding", "wave", "of", "plate", "cat", "with"]
WEIGHTS = [(1.0, 0, 0, 0), (0.5, 0.5, 0, 0), (0.34, 0.33, 0.33, 0), (0.25, 0.25, 0.25, 0.25)]


def random_batch(seed, n_images=None, max_len=12):
    """(target, predicted): per image 1-5 reference token lists and one
    hypothesis, 0-12 words of a small vocabulary (so n-grams repeat)."""
    rng = np.random.RandomState(seed)
    n = n_images or rng.randint(1, 9)

    def caption(lo=0):
        return [WORDS[i] for i in rng.randint(0, len(WORDS), rng.randint(lo, max_len + 1))]

    target = [[caption(1) for _ in range(rng.randint(1, 6))] for _ in range(n)]
    return target, [caption() for _ in range(n)]


@pytest.fixture
def python_path(monkeypatch):
    """Both packages' native scorers off: evaluate() and the corpus pass take their Python paths."""
    monkeypatch.setenv("ST_FASTMETRICS", "0")


def test_native_scorer_builds_here():
    assert fastmetrics.is_available(), fastmetrics.status()
    assert fastmetrics.status().startswith("native (") and "build" in fastmetrics.status()


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), faithful=st.booleans())
def test_evaluate_equals_the_jax_package_native(seed, faithful):
    target, predicted = random_batch(seed)
    assert metrics.evaluate(target, predicted, faithful) == jax_metrics.evaluate(target, predicted, faithful)


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), faithful=st.booleans())
def test_native_equals_python_path(seed, faithful):
    target, predicted = random_batch(seed)
    native = metrics.evaluate(target, predicted, faithful)
    os.environ["ST_FASTMETRICS"] = "0"
    try:
        python = metrics.evaluate(target, predicted, faithful)
        jax_python = jax_metrics.evaluate(target, predicted, faithful)
    finally:
        del os.environ["ST_FASTMETRICS"]
    assert native == python == jax_python


@pytest.mark.parametrize("faithful", [True, False])
@pytest.mark.parametrize("seed", range(6))
def test_evaluate_python_path_equals_the_jax_package(python_path, seed, faithful):
    target, predicted = random_batch(100 + seed, n_images=seed + 1)
    assert metrics._evaluate_native(target, predicted, faithful) is None
    assert metrics.evaluate(target, predicted, faithful) == jax_metrics.evaluate(target, predicted, faithful)


def test_faithful_takes_the_last_image_and_corrected_the_means():
    target, predicted = random_batch(7, n_images=6)
    gts = {i: [" ".join(r) for r in target[i]] for i in range(6)}
    res = {i: [" ".join(predicted[i])] for i in range(6)}
    cider_mean, cider_per = metrics.cider_corpus(gts, res)
    rouge_mean, rouge_per = metrics.rouge_l_corpus(gts, res)
    faithful, corrected = metrics.evaluate(target, predicted, True), metrics.evaluate(target, predicted, False)
    assert (faithful["CIDEr"], faithful["ROUGE_L"]) == (cider_per[-1], rouge_per[-1])
    assert (corrected["CIDEr"], corrected["ROUGE_L"]) == (cider_mean, rouge_mean)
    assert faithful["Bleu_4"] == corrected["Bleu_4"]


@pytest.mark.parametrize("seed", range(8))
def test_corpus_scorers_equal_the_jax_package(seed):
    target, predicted = random_batch(200 + seed)
    gts = {i: [" ".join(r) for r in target[i]] for i in range(len(target))}
    res = {i: [" ".join(predicted[i])] for i in range(len(target))}
    for option in ("closest", "shortest", "average"):
        assert metrics.bleu_corpus(gts, res, 4, option) == jax_metrics.bleu_corpus(gts, res, 4, option)
    port_c, jax_c = metrics.cider_corpus(gts, res), jax_metrics.cider_corpus(gts, res)
    assert port_c[0] == jax_c[0] and np.array_equal(port_c[1], jax_c[1])
    port_r, jax_r = metrics.rouge_l_corpus(gts, res), jax_metrics.rouge_l_corpus(gts, res)
    assert port_r[0] == jax_r[0] and np.array_equal(port_r[1], jax_r[1])


@settings(max_examples=80, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_nltk_bleu4_method4_and_corpus_sums_equal_the_jax_package(seed):
    target, predicted = random_batch(seed, n_images=1)
    refs = target[0]
    cands = [predicted[0]] + random_batch(seed + 1, n_images=3)[1]
    for cand in cands:
        assert metrics.nltk_bleu4_method4(refs, cand, WEIGHTS) == jax_metrics.nltk_bleu4_method4(refs, cand, WEIGHTS)
    sums = fastmetrics.corpus_bleu4_sums(refs, cands, WEIGHTS)
    assert np.array_equal(sums, jax_fastmetrics.corpus_bleu4_sums(refs, cands, WEIGHTS))
    python = [0.0] * 4
    for cand in cands:
        for w, v in enumerate(metrics.nltk_bleu4_method4(refs, cand, WEIGHTS)):
            python[w] += v
    assert list(sums) == python


def test_nltk_bleu4_method4_equals_nltk():
    from nltk.translate.bleu_score import SmoothingFunction, corpus_bleu

    method4 = SmoothingFunction().method4
    for seed in range(40):
        target, predicted = random_batch(300 + seed, n_images=1)
        want = [corpus_bleu([target[0]], [predicted[0]], w, smoothing_function=method4) for w in WEIGHTS]
        assert metrics.nltk_bleu4_method4(target[0], predicted[0], WEIGHTS) == want


def test_exotic_tokens_take_the_python_path_with_equal_scores():
    target = [[["a", "red\tbus"], ["the", "bus"]], [["a", "cat"], ["cat\xa0on", "mat"]]]
    predicted = [["a", "red\tbus"], ["a", "cat", ""]]
    assert fastmetrics.score_batch(target, predicted) is None
    assert fastmetrics.corpus_bleu4_sums(target[0], predicted[:1], WEIGHTS) is None
    for faithful in (True, False):
        assert metrics.evaluate(target, predicted, faithful) == jax_metrics.evaluate(target, predicted, faithful)


def test_an_unbuildable_library_scores_by_python_and_says_why(monkeypatch):
    """Without g++ the build fails, status() says so, and every score is the Python path's."""
    monkeypatch.setattr(fastmetrics, "_lib", None)
    monkeypatch.setattr(fastmetrics, "_why", "")
    monkeypatch.setenv("PATH", "")
    assert not fastmetrics.is_available()
    assert fastmetrics.status().startswith("Python (g++ cannot run")
    target, predicted = random_batch(11, n_images=5)
    assert fastmetrics.score_batch(target, predicted) is None
    monkeypatch.setenv("ST_FASTMETRICS", "0")  # the JAX package's Python path
    assert metrics.evaluate(target, predicted) == jax_metrics.evaluate(target, predicted)
    assert fastmetrics.status() == "Python (ST_FASTMETRICS=0)"


def test_the_library_lands_in_the_build_directory():
    from show_tell_tpu_torch.native import build
    from show_tell_tpu_torch.ops.build import BUILD_DIR

    path, why = build.build("fastmetrics")
    assert path and not why and os.path.dirname(path) == BUILD_DIR
    assert os.path.basename(path).startswith("libfastmetrics_") and path in fastmetrics.status()
    assert build.library_path("fastmetrics") != build.library_path("fastimage")


class _Vocab:
    def __init__(self):
        self.index_to_word = ["<pad>", "<start>", "<end>", "<unk>"] + WORDS
        self.word_to_index = {w: i for i, w in enumerate(self.index_to_word)}

    def start_token(self):
        return "<start>"

    def end_token(self):
        return "<end>"


@pytest.mark.parametrize("flag_blue", [False, True])
def test_caption_word_format_equals_the_jax_package(flag_blue):
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 4 + len(WORDS), (16, 25)).astype(np.int32)
    ids[3, 0] = 2  # <end> first: an empty caption
    want = jax_word_format(ids, _Vocab(), flag_blue)
    assert create_caption_word_format(ids, _Vocab(), flag_blue) == want
    assert any(len(c) == 0 for c in (want if not flag_blue else [c[0] for c in want]))


def _callbacks(seed, V=12, retire=True):
    """A seeded random transition table: probs depend on (state, token)."""
    rng = np.random.RandomState(seed)
    table = rng.dirichlet(np.ones(V) * 0.5, size=(V, 4))
    if not retire:
        table[:, :, 2] = 0.0  # <end> (id 2) is never emitted

    def init(X):
        return int(X) % 4

    def gen(state, value):
        return table[value, state], (state + value) % 4

    return init, gen


@pytest.mark.parametrize("retire", [True, False], ids=["retires", "nothing-retired"])
@pytest.mark.parametrize("seed", range(5))
def test_generic_beam_search_equals_the_jax_package(seed, retire):
    init, gen = _callbacks(seed, retire=retire)
    for width, hyps in ((1, 1), (3, 2), (4, 4)):
        kw = dict(beam_width=width, num_hypotheses=hyps, max_length=9)
        got = generic.beam_search(init, gen, seed, 1, 2, **kw)
        assert got == jax_generic.beam_search(init, gen, seed, 1, 2, **kw)
        assert len(got) >= 1 and all(seq[0] == 1 for seq in got)
        if not retire:
            assert all(2 not in seq for seq in got) and all(len(seq) == 10 for seq in got)
