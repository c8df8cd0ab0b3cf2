"""ctypes binding of the native caption scorer (fastmetrics.cpp); the
port's own copy of show_tell_tpu/native/fastmetrics.py.

``score_batch(target, predicted)`` computes the per-batch BLEU corpus
totals, CIDEr per-image and ROUGE-L per-image scores BIT-IDENTICALLY to
the pure-Python path in evaluation/metrics.py (exact ``==`` differential
tests in tests/test_torch_metrics.py, against both packages).
evaluation.metrics.evaluate() dispatches here when the inputs satisfy the
reference semantics' preconditions (see ``score_batch``); the Python path
remains the fallback and the semantic source of truth.  The library is
built with g++ at first use (native/build.py); where it does not build,
the Python path scores, and ``status()`` says which scorer runs and why.

Set ``ST_FASTMETRICS=0`` to disable (A/B and debugging), as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import os
import re
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_lib = None
_path = ""  # the loaded library
_why = ""  # why the library is not there, once a build was tried
_lock = threading.Lock()

# str.split() whitespace == Py_UNICODE_ISSPACE == re's unicode \s.  A
# token containing any of these (or an empty token) breaks the
# reference's " ".join -> .split() round-trip, so such batches take the
# Python path (which IS the join+split semantics).  Plain spaces are
# the separators we inserted; everything else whitespace is a red flag.
_WS_NONSPACE = re.compile(r"[^\S ]")

# idf inputs must be SCALAR np.log bits (the Python path computes
# log_num_images - float(np.log(max(1.0, df))) per distinct df value;
# numpy's vectorized log may take a different SIMD path).  The table
# depends only on the batch size, which repeats — cache it.
_log_tables: dict = {}


def _log_table(n_images: int) -> np.ndarray:
    t = _log_tables.get(n_images)
    if t is None:
        t = np.array(
            [float(np.log(max(1.0, float(d)))) for d in range(n_images + 1)], dtype=np.float64
        )
        if len(_log_tables) < 64:  # eval uses a handful of batch sizes
            _log_tables[n_images] = t
    return t


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _path, _why
    with _lock:
        if _lib is None and not _why:
            from show_tell_tpu_torch.native.build import build

            path, _why = build("fastmetrics")
            if not path:
                return None
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                _why = "the library does not load: %s" % e
                return None
            lib.st_eval_batch.restype = ctypes.c_int
            lib.st_eval_batch.argtypes = [
                ctypes.c_char_p,  # tokens blob (flat, space-separated)
                ctypes.c_int64,  # blob byte length
                ctypes.c_int64,  # expected total token count
                ctypes.POINTER(ctypes.c_int32),  # tok_counts
                ctypes.POINTER(ctypes.c_int32),  # ref_counts
                ctypes.c_int32,  # n_images
                ctypes.POINTER(ctypes.c_double),  # log_table
                ctypes.POINTER(ctypes.c_double),  # bleu_totals[10]
                ctypes.POINTER(ctypes.c_double),  # cider_per_image
                ctypes.POINTER(ctypes.c_double),  # rouge_per_image
            ]
            lib.st_bleu4_method4_image.restype = ctypes.c_int
            lib.st_bleu4_method4_image.argtypes = [
                ctypes.c_char_p,  # tokens blob (refs then candidates)
                ctypes.c_int64,  # blob byte length
                ctypes.c_int64,  # expected total token count
                ctypes.POINTER(ctypes.c_int32),  # tok_counts
                ctypes.c_int32,  # n_refs
                ctypes.c_int32,  # n_cands
                ctypes.POINTER(ctypes.c_double),  # weights [n_weights*4]
                ctypes.c_int32,  # n_weights
                ctypes.c_int32,  # smooth_k
                ctypes.POINTER(ctypes.c_double),  # out_sums [n_weights]
            ]
            _lib, _path = lib, path
        return _lib


def is_available() -> bool:
    if os.environ.get("ST_FASTMETRICS", "1") == "0":
        return False
    return _load() is not None


def status() -> str:
    """Which scorer evaluate() and the corpus-BLEU pass run here, and why:
    "native (path)", or "Python (the reason)"."""
    if os.environ.get("ST_FASTMETRICS", "1") == "0":
        return "Python (ST_FASTMETRICS=0)"
    return "native (%s)" % _path if _load() is not None else "Python (%s)" % _why


def score_batch(
    target: Sequence[Sequence[Sequence[str]]], predicted: Sequence[Sequence[str]]
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(bleu_totals[10], cider_per_image, rouge_per_image) or None.

    None means "use the Python path": library unavailable, empty batch,
    a token that breaks the join/split round-trip, or >=65535 distinct
    tokens (the native key packing limit — never hit by real captions).
    bleu_totals layout: guess[4], correct[4], total_testlen,
    total_reflen (exact integers stored in doubles).
    """
    lib = _load()
    n_images = len(target)
    if lib is None or n_images == 0 or os.environ.get("ST_FASTMETRICS", "1") == "0":
        return None

    # One flat token stream; caption boundaries travel as counts.  All
    # per-token work happens in C (str.join / list.extend / the single
    # whitespace regex below); tokens that would break the reference's
    # " ".join -> .split() round-trip are detected cheaply: a token
    # with an embedded space inflates the parsed count and an empty
    # token yields a zero-length split (C++ returns -3), while any
    # OTHER unicode whitespace is caught by one scan of the whole blob.
    flat: List[str] = []
    tok_counts: List[int] = []
    ref_counts: List[int] = []
    for i in range(n_images):
        refs = target[i]
        if not refs:
            return None  # Python path raises/zero-divides identically
        ref_counts.append(len(refs))
        cap = predicted[i]
        tok_counts.append(len(cap))
        flat.extend(cap)
        for cap in refs:
            tok_counts.append(len(cap))
            flat.extend(cap)

    s = " ".join(flat)
    if _WS_NONSPACE.search(s):
        return None  # \t, \n, \xa0, ... inside a token: .split() differs
    blob = s.encode("utf-8")
    tc = np.asarray(tok_counts, dtype=np.int32)
    rc = np.asarray(ref_counts, dtype=np.int32)
    bleu_totals = np.zeros(10, dtype=np.float64)
    cider = np.zeros(n_images, dtype=np.float64)
    rouge = np.zeros(n_images, dtype=np.float64)

    rcode = lib.st_eval_batch(
        blob,
        len(blob),
        int(len(flat)),
        tc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_images,
        _log_table(n_images).ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        bleu_totals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cider.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rouge.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rcode != 0:
        return None
    return bleu_totals, cider, rouge


def corpus_bleu4_sums(
    references: Sequence[Sequence[str]],
    candidates: Sequence[Sequence[str]],
    weights: Sequence[Tuple[float, ...]],
    k: int = 5,
) -> Optional[np.ndarray]:
    """Per-image corpus-BLEU pass (reference utils.py:232-246): for each
    weight tuple, the SUM over candidates of nltk
    corpus_bleu([references], [cand], w, method4) — bit-identical to
    summing metrics.nltk_bleu4_method4 per candidate (exact ``==``
    differential tests in tests/test_native.py).  None -> caller uses
    the Python path (library unavailable, no refs/cands, or tokens that
    break the join/split round-trip)."""
    lib = _load()
    if (
        lib is None
        or not references
        or not candidates
        or os.environ.get("ST_FASTMETRICS", "1") == "0"
    ):
        return None

    flat: List[str] = []
    tok_counts: List[int] = []
    for cap in references:
        tok_counts.append(len(cap))
        flat.extend(cap)
    for cap in candidates:
        tok_counts.append(len(cap))
        flat.extend(cap)
    s = " ".join(flat)
    if _WS_NONSPACE.search(s):
        return None
    blob = s.encode("utf-8")
    w = np.ascontiguousarray(weights, dtype=np.float64)
    tc = np.asarray(tok_counts, dtype=np.int32)
    out = np.zeros(len(weights), dtype=np.float64)
    rcode = lib.st_bleu4_method4_image(
        blob,
        len(blob),
        int(len(flat)),
        tc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(references),
        len(candidates),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(weights),
        k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rcode != 0:
        return None
    return out
