# A copy of nltk's improved Treebank word tokenizer (nltk/tokenize/destructive.py, nltk 3.10.0: the
# MacIntyre contractions and NLTKWordTokenizer.tokenize without its two options), so that the port
# tokenizes captions on a host without nltk.
#
# Natural Language Toolkit: NLTK's very own tokenizer.
#
# Copyright (C) 2001-2026 NLTK Project
# Author: Liling Tan
#         Tom Aarsen <> (modifications)
# URL: <https://www.nltk.org>
#
# Licensed under the Apache License, Version 2.0 (the "License"); you may not use this file except in
# compliance with the License.  You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software distributed under the License is
# distributed on an "AS IS" BASIS, WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or
# implied.  See the License for the specific language governing permissions and limitations under the
# License.
"""nltk's ``NLTKWordTokenizer().tokenize``: regexes only, no data files.
``tokenize(text)`` splits one sentence into Penn Treebank tokens, as
``nltk.tokenize.destructive.NLTKWordTokenizer().tokenize(text)`` does
(tests/test_torch_tokenize.py holds the two equal)."""

from __future__ import annotations

import re
from typing import List

# Contractions adapted from Robert MacIntyre's tokenizer (nltk's CONTRACTIONS4 is unused there too).
CONTRACTIONS2 = [
    r"(?i)\b(can)(?#X)(not)\b",
    r"(?i)\b(d)(?#X)('ye)\b",
    r"(?i)\b(gim)(?#X)(me)\b",
    r"(?i)\b(gon)(?#X)(na)\b",
    r"(?i)\b(got)(?#X)(ta)\b",
    r"(?i)\b(lem)(?#X)(me)\b",
    r"(?i)\b(more)(?#X)('n)\b",
    r"(?i)\b(wan)(?#X)(na)(?=\s)",
]
CONTRACTIONS3 = [r"(?i) ('t)(?#X)(is)\b", r"(?i) ('t)(?#X)(was)\b"]

STARTING_QUOTES = [
    (re.compile("([«“‘„]|[`]+)", re.U), r" \1 "),
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
    (re.compile(r"(?i)(\')(?!re|ve|ll|m|t|s|d|n)(\w)\b", re.U), r"\1 \2"),
]

ENDING_QUOTES = [
    (re.compile("([»”’])", re.U), r" \1 "),
    (re.compile(r"''"), " '' "),
    (re.compile(r'"'), " '' "),
    (re.compile(r"\s+"), " "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

PUNCTUATION = [
    (re.compile(r'([^\.])(\.)([\]\)}>"\'' "»”’ " r"]*)\s*$", re.U), r"\1 \2 \3 "),
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.{2,}", re.U), r" \g<0> "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    (re.compile(r"[\u2012-\u2015]", re.UNICODE), r" \g<0> "),  # figure, en and em dashes, horizontal bar
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),  # the final period
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
    (re.compile(r"[*]", re.U), r" \g<0> "),
]

PARENS_BRACKETS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")
DOUBLE_DASHES = (re.compile(r"--"), r" -- ")

_CONTRACTIONS2 = [re.compile(p) for p in CONTRACTIONS2]
_CONTRACTIONS3 = [re.compile(p) for p in CONTRACTIONS3]


def tokenize(text: str) -> List[str]:
    """The Treebank tokens of one sentence, in nltk's order of substitutions."""
    for regexp, substitution in STARTING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp, substitution in PUNCTUATION:
        text = regexp.sub(substitution, text)
    regexp, substitution = PARENS_BRACKETS
    text = regexp.sub(substitution, text)
    regexp, substitution = DOUBLE_DASHES
    text = regexp.sub(substitution, text)
    text = " " + text + " "  # the ending rules look for a space after a token
    for regexp, substitution in ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp in _CONTRACTIONS2:
        text = regexp.sub(r" \1 \2 ", text)
    for regexp in _CONTRACTIONS3:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()
