"""The caption vocabulary: its vocab.pkl reader and writer, its builder
and the caption tokenizer (the port's own copy of
show_tell_tpu/vocab/vocabulary.py and tokenize.py).

A vocab.pkl, whether written by the reference, the JAX package or this
module, stores a ``vocab_builder.DatasetVocabulary`` instance: the two maps
and the next index.  ``load_vocab`` reads that class name (and the JAX
package's and this module's own) as ``DatasetVocabulary`` here, and
nothing else but builtin containers, so loading imports no other package.
``save_vocab`` writes under the reference's class path, so the reference,
the JAX package and this module all read the file.

``get_vocabulary`` builds the vocabulary by the reference's rules
(vocab_builder.py:46-102): specials <pad> <start> <end> <unk> at ids 0-3,
then every word of the lowercased, tokenized training captions with at
least ``vocab_threshold`` occurrences, in first-occurrence order.
``word_tokenize`` is nltk's, imported when first called: nltk is not a
dependency of the port, and without it tokenizing raises.
"""

from __future__ import annotations

import functools
import os
import pickle
import re
import sys
import types
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple


class DatasetVocabulary(object):
    """The word <-> index maps of a vocab.pkl (what serving reads of it);
    the specials <pad> <start> <end> <unk> are ids 0-3 in a vocabulary
    built by the reference's rules."""

    def __init__(self):
        self.word_to_index: Dict[str, int] = {}
        self.index_to_word: Dict[int, str] = {}
        self.index = 0

    def __len__(self) -> int:
        return len(self.word_to_index)

    def add_new_word(self, word: str) -> None:
        if word not in self.word_to_index:
            self.word_to_index[word] = self.index
            self.index_to_word[self.index] = word
            self.index += 1

    def __call__(self, word: str) -> int:
        """The word's id, <unk>'s for a word outside the vocabulary."""
        if word not in self.word_to_index:
            return self.word_to_index["<unk>"]
        return self.word_to_index[word]

    def start_token(self) -> str:
        return "<start>"

    def end_token(self) -> str:
        return "<end>"


class _VocabUnpickler(pickle.Unpickler):
    _VOCAB_CLASSES = {("vocab_builder", "DatasetVocabulary"), ("show_tell_tpu.vocab.vocabulary", "DatasetVocabulary"),
                      ("show_tell_tpu_torch.vocab", "DatasetVocabulary")}

    def find_class(self, module: str, name: str):
        if (module, name) in self._VOCAB_CLASSES:
            return DatasetVocabulary
        if module in ("builtins", "copyreg", "__builtin__", "copy_reg"):  # the last two: Python 2 pickles
            return super().find_class(module, name)
        raise pickle.UnpicklingError("a vocab.pkl holds no %s.%s" % (module, name))


def load_vocab(path: str) -> DatasetVocabulary:
    """Read a vocab.pkl written by the reference or the JAX package."""
    with open(path, "rb") as f:
        obj = _VocabUnpickler(f).load()
    vocab = DatasetVocabulary()
    vocab.__dict__.update(obj.__dict__)
    return vocab


class _ReferenceShim(object):
    """The class a vocab.pkl is written under: the reference's module path,
    carrying only the vocabulary's attributes."""


_ReferenceShim.__module__ = "vocab_builder"
_ReferenceShim.__name__ = _ReferenceShim.__qualname__ = "DatasetVocabulary"


def save_vocab(vocab: DatasetVocabulary, path: str) -> None:
    """Write ``vocab`` to ``path`` atomically (tmp + rename), pickled under
    the reference's class path ``vocab_builder.DatasetVocabulary`` (a stub
    module registered for the dump, unless the reference's own is loaded)."""
    prior = sys.modules.get("vocab_builder")
    transient = prior is None or not hasattr(prior, "DatasetVocabulary")
    mod = prior
    if transient:
        mod = types.ModuleType("vocab_builder")
        mod.DatasetVocabulary = _ReferenceShim
        sys.modules["vocab_builder"] = mod
    try:
        cls = mod.DatasetVocabulary
        obj = cls.__new__(cls)
        obj.__dict__.update({"word_to_index": dict(vocab.word_to_index),
                             "index_to_word": dict(vocab.index_to_word), "index": int(vocab.index)})
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "wb") as f:
            pickle.dump(obj, f)
        os.replace(tmp, path)
    finally:
        if transient:
            if prior is None:
                del sys.modules["vocab_builder"]
            else:
                sys.modules["vocab_builder"] = prior


# Lowercase abbreviations that do not end a sentence in the fallback splitter.
_ABBREVS = {
    "mr.", "mrs.", "ms.", "dr.", "st.", "no.", "vs.", "etc.", "approx.",
    "jr.", "sr.", "prof.", "inc.", "ltd.", "co.", "e.g.", "i.e.",
}
_SENT_BOUNDARY = re.compile(r"(?<=[.!?])\s+")


def _sent_split(text: str) -> List[str]:
    """Rule-based stand-in for nltk's punkt model on caption-like text."""
    sents: List[str] = []
    for piece in _SENT_BOUNDARY.split(text):
        if sents:
            prev = sents[-1]
            last_word = prev.rsplit(None, 1)[-1] if prev.strip() else ""
            if last_word in _ABBREVS or re.fullmatch(r"\w\.", last_word):
                sents[-1] = prev + " " + piece
                continue
        sents.append(piece)
    return [s for s in sents if s.strip()]


@functools.lru_cache(maxsize=None)
def _tokenizer() -> Tuple[Callable[[str], List[str]], str]:
    """(tokenize, its name): nltk's ``word_tokenize`` where its punkt data is
    installed, else its Treebank word tokenizer over a rule-based sentence
    split (the JAX package's offline fallback; the two agree on
    single-sentence captions).  Without nltk it raises, and is asked again
    at the next call."""
    try:
        import nltk
        from nltk.tokenize.destructive import NLTKWordTokenizer
    except ImportError as e:
        raise ImportError("tokenizing captions needs nltk (the reference's tokenizer), which is not "
                          "installed here: %s" % e) from e
    try:
        nltk.tokenize.word_tokenize("probe.")
        return nltk.tokenize.word_tokenize, "nltk word_tokenize (punkt)"
    except LookupError:
        treebank = NLTKWordTokenizer()
        return (lambda text: [t for s in _sent_split(text) for t in treebank.tokenize(s)],
                "nltk Treebank words over a rule-based sentence split (no punkt data)")


def word_tokenize(text: str) -> List[str]:
    """nltk.tokenize.word_tokenize, with the offline fallback of
    ``_tokenizer``; raises where nltk is not installed."""
    return _tokenizer()[0](text)


def tokenizer_name() -> Optional[str]:
    """Which tokenizer ``word_tokenize`` runs, or None where nltk is not installed."""
    try:
        return _tokenizer()[1]
    except ImportError:
        return None


def get_vocabulary(dataset: str, params: Dict[str, Any],
                   tokenize: Callable[[str], List[str]] = word_tokenize) -> DatasetVocabulary:
    """Load ``params['vocab_path']`` if it exists (tokenizing nothing), else
    build the vocabulary from ``data_dir/train_ann_path`` (COCO JSON for
    "MSCOCO", a TSV for "Flickr") by the reference's rules and save it there."""
    if os.path.isfile(params["vocab_path"]):
        print("Loading vocabulary from the existing file.")
        return load_vocab(params["vocab_path"])
    print("Vocabulary does not exist. Creating vocab...")
    vocab = DatasetVocabulary()
    for word in ["pad", "start", "end", "unk"]:
        vocab.add_new_word("<" + word + ">")
    annotation_path = os.path.join(params["data_dir"], params["train_ann_path"])
    counts: Counter = Counter()
    if dataset == "MSCOCO":
        print("Building vocabulary for the MSCOCO dataset.")
        from show_tell_tpu_torch.data.coco import CocoCaptions

        coco = CocoCaptions(annotation_path)
        for ann_id in coco.anns.keys():  # file order, which pins the ids
            counts.update(tokenize(str(coco.anns[ann_id]["caption"]).lower()))
    elif dataset == "Flickr":
        print("Building vocabulary for the Flickr dataset.")
        from show_tell_tpu_torch.data.coco import parse_flickr_tsv

        for _, caption in parse_flickr_tsv(annotation_path):
            counts.update(tokenize(str(caption).lower()))
    else:
        raise ValueError("Please specify a valid dataset. %s is invalid." % (dataset,))
    for word, count in counts.items():
        if count >= params["vocab_threshold"]:
            vocab.add_new_word(word)
    os.makedirs(os.path.dirname(params["vocab_path"]) or ".", exist_ok=True)
    save_vocab(vocab, params["vocab_path"])
    return vocab
