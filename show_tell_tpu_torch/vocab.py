"""The caption vocabulary that a checkpoint's vocab.pkl holds (the port's
own copy of show_tell_tpu/vocab/vocabulary.py's class and reader).

A vocab.pkl, whether written by the reference or by the JAX package,
stores a ``vocab_builder.DatasetVocabulary`` instance: the two maps and
the next index.  ``load_vocab`` reads that class name (and the JAX
package's and this module's own) as ``DatasetVocabulary`` here, and nothing else but
builtin containers, so loading imports no other package.
"""

from __future__ import annotations

import pickle
from typing import Dict


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
