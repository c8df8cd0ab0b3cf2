"""The port's caption tokenizer against nltk and the JAX package, on the CPU:
its copy of nltk's Treebank word tokenizer (show_tell_tpu_torch/treebank.py)
equals ``nltk.tokenize.destructive.NLTKWordTokenizer().tokenize``, and its
``word_tokenize`` equals ``show_tell_tpu.vocab.tokenize.word_tokenize``, on
the fixture captions, every caption the demonstration's generator writes,
and caption-like strings drawn by hypothesis (quotes, brackets,
contractions, dashes, ellipses, unicode quotes)."""

import os
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from nltk.tokenize.destructive import NLTKWordTokenizer

from fixtures import CAPTIONS
from show_tell_tpu.vocab.tokenize import word_tokenize as jax_word_tokenize
from show_tell_tpu_torch import treebank, vocab
from torch_train_helpers import few_torch_threads  # noqa: F401 (an autouse fixture)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import demo_synthetic_torch as demo  # noqa: E402

NLTK = NLTKWordTokenizer()


def _demo_captions():
    plain = [t.format(color=c, shape=s, bg=b) for t in demo.TEMPLATES for c in demo.COLORS for s in demo.SHAPES
             for b in demo.BACKGROUNDS]
    pairs = [(c, s) for c in demo.COLORS for s in demo.SHAPES]
    two = ["a %s %s left of a %s %s." % (c1, s1, c2, s2) for c1, s1 in pairs for c2, s2 in pairs if (c1, s1) != (c2, s2)]
    return plain + two + [c.replace("a ", "one ", 1) for c in two]


EDGE = [
    'He said, "it\'s a dog\'s life" -- and left...',
    "“Quoted” and ‘single’ and «chevrons» and „low“ quotes.",
    "I can't, won't, shouldn't; they'd've gone (maybe) [twice] {or} <thrice>.",
    "cannot gimme gonna gotta lemme wanna go, 'tis 'twas d'ye more'n",
    "Prices: $3.88 & 3,36 euros @ 50% #1 *star* on 12:30",
    "An em—dash, an en–dash, a figure‒dash and a bar― too",
    "Mr. Smith went to St. Louis. He saw a U.S. flag! Did he? Yes.",
    "''double single'' and ``backticks'' and 'single' quotes'",
    "ends with a quote.\" and (a paren.) and [brackets.]",
    "a man's dogs' toys ... aren't there?!",
    "",
    "   ",
    ".",
    "'",
]
CORPUS = {"fixtures": [c for _, _, c in CAPTIONS] + [c.lower() for _, _, c in CAPTIONS],
          "demo": _demo_captions(), "edge": EDGE + [e.lower() for e in EDGE]}

PIECES = ["a", "dog", "man's", "dogs'", "can't", "isn't", "they'll", "we're", "i'm", "you'd", "cannot", "gonna",
          "'tis", "'twas", "--", "...", "..", ".", ",", ";", ":", "?", "!", "(", ")", "[", "]", "{", "}", "<", ">",
          '"', "'", "''", "``", "`", "“", "”", "‘", "’", "«", "»", "„", "—", "–", "$", "3,36", "3.88", "12:30", "&",
          "%", "#", "@", "*", "St.", "u.s.", "e.g.", "Mr.", "the", "A", "Red", "BUS", "N'T", "'S"]
caption_like = st.lists(st.tuples(st.sampled_from(PIECES), st.sampled_from(["", " ", " ", "  ", "\n"])),
                        max_size=24).map(lambda parts: "".join(p + sep for p, sep in parts))
characters = st.text(alphabet=st.sampled_from(list("ab .,;:!?'\"`()[]{}<>-$%&*@#\n") + list("“”‘’«»„—–")),
                     max_size=40)


@pytest.mark.parametrize("group", sorted(CORPUS))
def test_treebank_copy_equals_nltk_on_the_corpus(group):
    for text in CORPUS[group]:
        assert treebank.tokenize(text) == NLTK.tokenize(text), text


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(text=st.one_of(caption_like, characters))
def test_treebank_copy_equals_nltk_on_caption_like_strings(text):
    assert treebank.tokenize(text) == NLTK.tokenize(text)


@pytest.mark.parametrize("group", sorted(CORPUS))
def test_word_tokenize_equals_the_jax_package_on_the_corpus(group):
    for text in CORPUS[group]:
        assert vocab.word_tokenize(text) == jax_word_tokenize(text), text


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(text=st.one_of(caption_like, characters))
def test_word_tokenize_equals_the_jax_package_on_caption_like_strings(text):
    assert vocab.word_tokenize(text) == jax_word_tokenize(text)


def test_tokenizer_name_says_which_path_runs(monkeypatch):
    """Without punkt data (this host) the copied Treebank words run and the name says why; where nltk's
    word_tokenize loads its data, nltk's own runs."""
    import nltk

    vocab._tokenizer.cache_clear()
    try:
        try:
            nltk.tokenize.word_tokenize("probe.")
            has_punkt = True
        except LookupError:
            has_punkt = False
        if not has_punkt:
            assert vocab.tokenizer_name().endswith("(nltk has no punkt data)"), vocab.tokenizer_name()
            assert vocab._tokenizer()[0] is not nltk.tokenize.word_tokenize
        fake = lambda text: ["fake:" + text]  # noqa: E731 (stands for nltk's word_tokenize with punkt loaded)
        monkeypatch.setattr(nltk.tokenize, "word_tokenize", fake)
        vocab._tokenizer.cache_clear()
        assert vocab.tokenizer_name() == "nltk word_tokenize (punkt)"
        assert vocab.word_tokenize("a dog.") == ["fake:a dog."]
    finally:
        monkeypatch.undo()
        vocab._tokenizer.cache_clear()
