"""Caption metrics: BLEU-1..4, CIDEr, ROUGE-L (+ optional METEOR); the port's own
copy of show_tell_tpu/evaluation/metrics.py (pure Python and numpy).

Re-implements the scoring semantics of the reference's vendored
coco-caption suite (evaluation/evaluation_metrics.py) from the algorithms,
including its exact numeric conventions, so per-batch scores match:

  BLEU  (evaluation_metrics.py:117-320): corpus clip-counted n-gram
    precision with brevity penalty; reflen option 'closest' (:313);
    smoothing constants small=1e-9 / tiny=1e-15 (:222-223); per-image
    scores use per-sentence counts with the same BP.
  CIDEr (evaluation_metrics.py:323-504): tf-idf n-gram cosine with
    clipping, per-call document frequency, log(#images) ref_len, gaussian
    length penalty sigma=6, x10 scaling.  The upstream quirk where
    "length" counts bigrams (:402-403, `if n == 1`) is preserved.
  ROUGE-L (evaluation_metrics.py:592-660): LCS F-measure, beta=1.2, with
    max-precision and max-recall taken independently over references.
  METEOR: the reference ships the wrapper but strips meteor-1.5.jar and
    disables the scorer (:682); ``meteor_available()`` gates it here.

``evaluate(target, predicted)`` reproduces the reference wrapper
(:662-717): token lists in, {'Bleu_1'..'Bleu_4','CIDEr','ROUGE_L'} out.
"""

from __future__ import annotations

import math
import os
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_SMALL = 1e-9
_TINY = 1e-15


def _ngram_counts(words: Sequence[str], n: int) -> Counter:
    counts: Counter = Counter()
    for k in range(1, n + 1):
        if len(words) >= k:
            # Counter.update over a zip iterator counts in C — ~3x the
            # per-slice Python loop on the eval hot path.
            counts.update(zip(*(words[i:] for i in range(k))))
    return counts


# ---------------------------------------------------------------- BLEU ----


def _closest_reflen(reflens: List[int], testlen: int) -> int:
    return min((abs(l - testlen), l) for l in reflens)[1]


def nltk_bleu4_method4(
    references: List[List[str]], hypothesis: List[str], weights_list: List[Tuple], k: int = 5
) -> List[float]:
    """``nltk.corpus_bleu([references], [hypothesis], w, smoothing_function=
    SmoothingFunction().method4)`` for every weight tuple ``w`` in ONE
    pass — BIT-EQUAL to calling nltk per tuple (fuzz-pinned against the
    installed nltk in tests/test_metrics.py), ~10x faster: the n-gram
    clipping runs once instead of per weight tuple, and the integer
    numerators/denominators skip nltk's Fraction construction entirely.
    Every float operation (int true-division, method4's smoothing
    formula, fsum over the weighted logs, exp, brevity penalty) mirrors
    nltk's bleu_score.py op-for-op in the same order, so the roundings
    are identical.  This is the hot call of the reference's final
    per-image eval pass (reference utils.py:232-246: 4 weight tuples x
    ~5 candidates x every val image — ~810k nltk calls for COCO val2014)."""
    hyp_len = len(hypothesis)
    nums, dens = [0] * 4, [0] * 4
    for n in range(1, 5):
        if hyp_len >= n:
            counts = Counter(zip(*(hypothesis[i:] for i in range(n))))
        else:
            counts = Counter()
        max_counts: Dict = {}
        for ref in references:
            if len(ref) >= n:
                rc = Counter(zip(*(ref[i:] for i in range(n))))
                for ng in counts:
                    c = rc[ng]
                    if c > max_counts.get(ng, 0):
                        max_counts[ng] = c
        nums[n - 1] = sum(min(c, max_counts.get(ng, 0)) for ng, c in counts.items())
        dens[n - 1] = max(1, sum(counts.values()))
    if nums[0] == 0:  # no unigram match -> no higher order either
        return [0.0] * len(weights_list)
    closest = min((len(r) for r in references), key=lambda rl: (abs(rl - hyp_len), rl))
    if hyp_len > closest:
        bp = 1.0
    elif hyp_len == 0:
        bp = 0.0
    else:
        bp = math.exp(1 - closest / hyp_len)
    # method4 smoothing: zero-match orders get 1/(2^incvnt * k / ln(len))
    # over the same denominator; hyp_len <= 1 leaves them at true zero
    # (excluded from the geometric mean, like nltk's `if p_i > 0`).
    logs = [0.0] * 4
    positive = [False] * 4
    incvnt = 1
    for i in range(4):
        if nums[i] == 0:
            if hyp_len > 1:
                numerator = 1 / (2**incvnt * k / math.log(hyp_len))
                logs[i] = math.log(numerator / dens[i])
                positive[i] = True
                incvnt += 1
        else:
            logs[i] = math.log(nums[i] / dens[i])
            positive[i] = True
    return [
        bp * math.exp(math.fsum(w_i * l for w_i, l, p in zip(w, logs, positive) if p))
        for w in weights_list
    ]


def bleu_corpus(
    gts: Dict, res: Dict, n: int = 4, option: str = "closest", pre=None
) -> Tuple[List[float], List[List[float]]]:
    """gts/res: image_id -> list of sentence strings (res has exactly 1).

    ``pre``: optional shared precompute from evaluate() —
    {hyp_words, ref_words, hyp_counts, ref_counts} keyed by image id
    (identical to what this function would compute; BLEU and CIDEr
    tokenize and count the same sentences, so one pass serves both).

    Returns ([Bleu_1..Bleu_n corpus], [per-image lists per n])."""
    total_guess = [0] * n
    total_correct = [0] * n
    total_testlen = 0
    total_reflen = 0.0
    per_image: List[List[float]] = [[] for _ in range(n)]

    for img_id in gts.keys():
        if pre is not None:
            hyp_words = pre["hyp_words"][img_id]
            refs = pre["ref_words"][img_id]
        else:
            hyp_words = res[img_id][0].split()
            refs = [r.split() for r in gts[img_id]]
        testlen = len(hyp_words)
        reflens = [len(r) for r in refs]
        if option == "closest":
            reflen: float = _closest_reflen(reflens, testlen)
        elif option == "shortest":
            reflen = min(reflens)
        else:  # 'average'
            reflen = float(sum(reflens)) / len(reflens)

        max_ref_counts: Dict[tuple, int] = {}
        ref_counts_list = (
            pre["ref_counts"][img_id] if pre is not None else [_ngram_counts(r, n) for r in refs]
        )
        for rc in ref_counts_list:
            for ng, c in rc.items():
                max_ref_counts[ng] = max(max_ref_counts.get(ng, 0), c)
        hyp_counts = pre["hyp_counts"][img_id] if pre is not None else _ngram_counts(hyp_words, n)
        guess = [max(0, testlen - k + 1) for k in range(1, n + 1)]
        correct = [0] * n
        for ng, c in hyp_counts.items():
            correct[len(ng) - 1] += min(max_ref_counts.get(ng, 0), c)

        total_testlen += testlen
        total_reflen += reflen
        for k in range(n):
            total_guess[k] += guess[k]
            total_correct[k] += correct[k]

        # Per-image score with its own brevity penalty.
        prod = 1.0
        ratio = (testlen + _TINY) / (reflen + _SMALL)
        for k in range(n):
            prod *= (correct[k] + _TINY) / (guess[k] + _SMALL)
            s = prod ** (1.0 / (k + 1))
            if ratio < 1:
                s *= math.exp(1 - 1 / ratio)
            per_image[k].append(s)

    corpus: List[float] = []
    prod = 1.0
    ratio = (total_testlen + _TINY) / (total_reflen + _SMALL)
    for k in range(n):
        prod *= (total_correct[k] + _TINY) / (total_guess[k] + _SMALL)
        s = prod ** (1.0 / (k + 1))
        if ratio < 1:
            s *= math.exp(1 - 1 / ratio)
        corpus.append(s)
    return corpus, per_image


# --------------------------------------------------------------- CIDEr ----


def cider_corpus(gts: Dict, res: Dict, n: int = 4, sigma: float = 6.0, pre=None) -> Tuple[float, np.ndarray]:
    img_ids = list(gts.keys())
    if pre is not None:  # shared with bleu_corpus via evaluate()
        ref_counts, hyp_counts = pre["ref_counts"], pre["hyp_counts"]
    else:
        ref_counts = {i: [_ngram_counts(r.split(), n) for r in gts[i]] for i in img_ids}
        hyp_counts = {i: _ngram_counts(res[i][0].split(), n) for i in img_ids}

    # Document frequency over this call's reference set (per-batch in the
    # reference flow — evaluate() is invoked per batch, utils.py:201).
    df: Dict[tuple, float] = defaultdict(float)
    for i in img_ids:
        seen = set()
        for rc in ref_counts[i]:
            seen.update(rc.keys())
        for ng in seen:
            df[ng] += 1.0
    log_num_images = np.log(float(len(img_ids)))

    # One idf per REFERENCE n-gram, computed once per call: distinct df
    # values are few (<= #images), so np.log goes through a value cache,
    # and to_vec's hot loop then does ONE dict lookup per n-gram instead
    # of df.get + log-cache.get.  Hyp-only n-grams (df absent) fall back
    # to the default log_num_images — exactly log_n - log(max(1, 0.0))
    # = log_n - 0.0, so every value is bit-identical to the per-ngram
    # computation.
    _log_cache: Dict[float, float] = {}
    idf_table: Dict[tuple, float] = {}
    for ng, dfv in df.items():
        idf = _log_cache.get(dfv)
        if idf is None:
            idf = _log_cache[dfv] = log_num_images - float(np.log(max(1.0, dfv)))
        idf_table[ng] = idf
    _idf_get = idf_table.get

    def to_vec(cnts: Counter):
        vec = [{} for _ in range(n)]
        norm = [0.0] * n
        length = 0
        for ng, tf in cnts.items():
            k = len(ng) - 1
            v = float(tf) * _idf_get(ng, log_num_images)
            vec[k][ng] = v
            norm[k] += v * v
            if k == 1:  # upstream quirk: "length" counts bigrams
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    scores = []
    for i in img_ids:
        hvec, hnorm, hlen = to_vec(hyp_counts[i])
        total = [0.0] * n
        for rc in ref_counts[i]:
            rvec, rnorm, rlen = to_vec(rc)
            delta = float(hlen - rlen)
            gauss = np.e ** (-(delta ** 2) / (2 * sigma ** 2))
            for k in range(n):
                hv, rv = hvec[k], rvec[k]
                val = 0.0
                for ng, h in hv.items():
                    r = rv.get(ng, 0.0)
                    if r:  # zero terms add exactly 0.0
                        val += (h if h < r else r) * r
                if hnorm[k] != 0 and rnorm[k] != 0:
                    val /= hnorm[k] * rnorm[k]
                total[k] += val * gauss
        scores.append(float(np.mean(total)) / len(ref_counts[i]) * 10.0)
    arr = np.array(scores)
    return float(np.mean(arr)), arr


# -------------------------------------------------------------- ROUGE-L ----


def _lcs_len(a: List[str], b: List[str]) -> int:
    if len(a) < len(b):
        a, b = b, a
    lb = len(b)
    prev = [0] * (lb + 1)
    cur = [0] * (lb + 1)
    for x in a:
        c = 0  # cur[j-1], carried to avoid a second index per cell
        for j, y in enumerate(b, 1):
            if x == y:
                c = prev[j - 1] + 1
            elif c < prev[j]:
                c = prev[j]
            cur[j] = c
        prev, cur = cur, prev
    return prev[lb]


def rouge_l_corpus(gts: Dict, res: Dict, beta: float = 1.2) -> Tuple[float, np.ndarray]:
    scores = []
    for i in gts.keys():
        hyp = res[i][0].split(" ")
        precs, recs = [], []
        for r in gts[i]:
            ref = r.split(" ")
            lcs = _lcs_len(ref, hyp)
            precs.append(lcs / float(len(hyp)))
            recs.append(lcs / float(len(ref)))
        pmax, rmax = max(precs), max(recs)
        if pmax != 0 and rmax != 0:
            scores.append(((1 + beta ** 2) * pmax * rmax) / float(rmax + beta ** 2 * pmax))
        else:
            scores.append(0.0)
    arr = np.array(scores)
    return float(np.mean(arr)), arr


# --------------------------------------------------------------- METEOR ----

METEOR_JAR = os.path.join(os.path.dirname(__file__), "meteor-1.5.jar")


def meteor_available() -> bool:
    return os.path.isfile(METEOR_JAR)


def meteor_corpus(gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
    """Drives meteor-1.5.jar over stdio like the reference (:510-567).
    The jar is not shipped (stripped in the reference too); callers must
    check ``meteor_available()`` first."""
    if not meteor_available():
        raise FileNotFoundError(
            "meteor-1.5.jar not found next to metrics.py; METEOR is disabled "
            "by default, matching the reference (evaluation_metrics.py:682)."
        )
    import subprocess

    img_ids = list(gts.keys())
    cmd = ["java", "-jar", "-Xmx2G", METEOR_JAR, "-", "-", "-stdio", "-l", "en", "-norm"]
    proc = subprocess.Popen(
        cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=os.path.dirname(METEOR_JAR)
    )
    eval_line = "EVAL"
    for i in img_ids:
        stat_line = "SCORE ||| " + " ||| ".join(gts[i]) + " ||| " + res[i][0]
        proc.stdin.write((stat_line + "\n").encode())
        proc.stdin.flush()
        eval_line += " ||| " + proc.stdout.readline().decode().strip()
    proc.stdin.write((eval_line + "\n").encode())
    proc.stdin.flush()
    scores = [float(proc.stdout.readline().strip()) for _ in img_ids]
    final = float(proc.stdout.readline().strip())
    proc.kill()
    return final, np.array(scores)


# -------------------------------------------------------------- wrapper ----


def _evaluate_native(target, predicted, faithful: bool) -> Optional[Dict[str, float]]:
    """Native scoring path (native/fastmetrics.cpp): bit-identical score
    dict, ~20x the Python scorers.  None -> caller runs the Python path
    (library unavailable, METEOR enabled, or inputs outside the
    join/split round-trip preconditions — see fastmetrics.score_batch)."""
    if meteor_available():
        return None  # the gated METEOR scorer needs the string corpora
    from show_tell_tpu_torch.native import fastmetrics

    if not fastmetrics.is_available():
        return None
    out = fastmetrics.score_batch(target, predicted)
    if out is None:
        return None
    bleu_totals, cider_per, rouge_per = out
    scores: Dict[str, float] = {}
    # Corpus BLEU from the exact-integer totals — the same final float
    # expression as bleu_corpus (metrics.py:179-187).
    total_guess, total_correct = bleu_totals[0:4], bleu_totals[4:8]
    total_testlen, total_reflen = float(bleu_totals[8]), float(bleu_totals[9])
    prod = 1.0
    ratio = (total_testlen + _TINY) / (total_reflen + _SMALL)
    for k in range(4):
        prod *= (float(total_correct[k]) + _TINY) / (float(total_guess[k]) + _SMALL)
        s = prod ** (1.0 / (k + 1))
        if ratio < 1:
            s *= math.exp(1 - 1 / ratio)
        scores["Bleu_%d" % (k + 1)] = s
    if faithful:
        scores["CIDEr"] = float(cider_per[-1])
        scores["ROUGE_L"] = float(rouge_per[-1])
    else:
        scores["CIDEr"] = float(np.mean(cider_per))
        scores["ROUGE_L"] = float(np.mean(rouge_per))
    return scores


def evaluate(target, predicted, faithful: bool = True) -> Dict[str, float]:
    """Reference evaluate() (:662-717): batch token lists -> score dict.

    target[i]: list of reference token lists for sample i;
    predicted[i]: hypothesis token list for sample i.

    FAITHFUL REFERENCE BUG: in the reference wrapper the inner loop
    ``for imgId, score in zip(imgIds, scores)`` rebinds ``score``, so the
    returned 'CIDEr' and 'ROUGE_L' are the LAST image's per-image score,
    not the corpus mean (evaluation_metrics.py:707-715; the BLEU branch
    returns ``sc`` and is unaffected).  ``faithful=True`` (default)
    reproduces that; ``faithful=False`` returns the corpus means.
    """
    native = _evaluate_native(target, predicted, faithful)
    if native is not None:
        return native

    gts = {}
    res = {}
    for i in range(len(target)):
        gts[i] = [" ".join(ref) for ref in target[i]]
        res[i] = [" ".join(predicted[i])]

    # One tokenize+ngram-count pass shared by BLEU and CIDEr (both use
    # str.split(); ROUGE keeps its own split(" ") — reference rouge.py
    # semantics differ on empty tokens, so it is NOT shared).
    pre = {
        "hyp_words": {i: res[i][0].split() for i in res},
        "ref_words": {i: [r.split() for r in gts[i]] for i in gts},
    }
    pre["hyp_counts"] = {i: _ngram_counts(w, 4) for i, w in pre["hyp_words"].items()}
    pre["ref_counts"] = {i: [_ngram_counts(w, 4) for w in ws] for i, ws in pre["ref_words"].items()}

    scores: Dict[str, float] = {}
    bleus, _ = bleu_corpus(gts, res, 4, option="closest", pre=pre)
    for k, name in enumerate(["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]):
        scores[name] = bleus[k]
    cider_mean, cider_per = cider_corpus(gts, res, pre=pre)
    rouge_mean, rouge_per = rouge_l_corpus(gts, res)
    if faithful:
        scores["CIDEr"] = float(cider_per[-1])
        scores["ROUGE_L"] = float(rouge_per[-1])
    else:
        scores["CIDEr"] = cider_mean
        scores["ROUGE_L"] = rouge_mean
    if meteor_available():
        scores["METEOR"], _ = meteor_corpus(gts, res)
    return scores
