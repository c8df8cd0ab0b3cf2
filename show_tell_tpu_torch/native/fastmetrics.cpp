// Native per-batch caption scoring: BLEU-1..4 corpus totals, CIDEr and
// ROUGE-L per-image scores — BIT-IDENTICAL to the Python implementation
// in evaluation/metrics.py (itself numerically pinned to the reference's
// vendored coco-caption scorers, evaluation_metrics.py).  The port's own
// copy of show_tell_tpu/native/fastmetrics.cpp, unchanged below this
// comment.
//
// Why native: the reference's scorer is pure Python, and the per-batch
// host scoring is what the eval loop waits on behind a fast decode.
// Plain C ABI + ctypes (see fastmetrics.py), the pattern of fastimage.cpp.
//
// Bit-exactness contract (validated by exact `==` differential tests in
// tests/test_torch_metrics.py against the JAX package's scorers):
//   * every double operation mirrors the Python expression tree with the
//     same associativity; compiled with -ffp-contract=off so no FMA
//     contraction reorders roundings;
//   * libm calls (pow/exp/sqrt) hit the same glibc libm CPython uses;
//   * np.log values are NOT recomputed here — Python passes a
//     log_table[df] of scalar np.log results, so idf subtraction uses
//     the exact same inputs;
//   * n-gram float accumulation follows Python's Counter insertion
//     order: for each caption, n-gram length k=1..4 ascending, first
//     occurrence position within each k (first-occurrence-ordered
//     vectors below).
//
// Wrapper-side preconditions (fastmetrics.py falls back to Python
// otherwise): >=1 image, tokens non-empty with no whitespace (so the
// reference's join+split round-trips), <65536 distinct tokens per batch.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr double TINY = 1e-15;  // metrics.py _TINY
constexpr double SMALL = 1e-9;  // metrics.py _SMALL

// Python float ** float is CPython float_pow -> libm pow after special
// cases none of which arise here (finite positive bases).
static inline double py_pow(double a, double b) { return std::pow(a, b); }

struct KBucket {
  // (packed ngram key, term frequency) in FIRST-OCCURRENCE order — the
  // iteration order of Python's Counter for this caption.
  std::vector<std::pair<uint64_t, int32_t>> items;
};

struct Caption {
  int32_t len = 0;      // token count
  KBucket k[4];         // 1..4-gram counts
  const uint32_t* ids;  // token ids (view into the batch-wide id pool)
};

struct Scratch {
  std::unordered_map<uint64_t, int32_t> map;  // key -> index or count
  std::unordered_set<uint64_t> seen;
};

// Build the per-k first-occurrence-ordered (key, tf) lists for one
// caption.  Mirrors metrics._ngram_counts: k ascending, positions
// left-to-right, Counter preserving first-insertion order.
static void count_ngrams(Caption& c, Scratch& sc) {
  for (int k = 0; k < 4; ++k) {
    const int n = k + 1;
    if (c.len < n) continue;
    auto& bucket = c.k[k].items;
    sc.map.clear();
    for (int32_t pos = 0; pos + n <= c.len; ++pos) {
      uint64_t key = 0;
      for (int j = 0; j < n; ++j) key |= (uint64_t)c.ids[pos + j] << (16 * j);
      auto it = sc.map.find(key);
      if (it == sc.map.end()) {
        sc.map.emplace(key, (int32_t)bucket.size());
        bucket.emplace_back(key, 1);
      } else {
        bucket[it->second].second += 1;
      }
    }
  }
}

// metrics._closest_reflen: min over (abs(l - testlen), l) tuples.
static int32_t closest_reflen(const std::vector<int32_t>& reflens, int32_t testlen) {
  int64_t best_d = INT64_MAX;
  int32_t best_l = 0;
  for (int32_t l : reflens) {
    int64_t d = l >= testlen ? l - testlen : testlen - l;
    if (d < best_d || (d == best_d && l < best_l)) {
      best_d = d;
      best_l = l;
    }
  }
  return best_l;
}

// metrics._lcs_len — integer DP, two rolling rows.
static int32_t lcs_len(const uint32_t* a, int32_t la, const uint32_t* b, int32_t lb,
                       std::vector<int32_t>& prev, std::vector<int32_t>& cur) {
  if (la < lb) {
    std::swap(a, b);
    std::swap(la, lb);
  }
  prev.assign(lb + 1, 0);
  cur.assign(lb + 1, 0);
  for (int32_t i = 0; i < la; ++i) {
    const uint32_t x = a[i];
    int32_t c = 0;
    for (int32_t j = 1; j <= lb; ++j) {
      if (x == b[j - 1])
        c = prev[j - 1] + 1;
      else if (c < prev[j])
        c = prev[j];
      cur[j] = c;
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

// Split a flat single-space-separated blob into interned token ids.
// Returns 0, -1 on >=65535 distinct tokens, -3 on token-count mismatch
// (a token containing a space) or an empty token.
static int intern_blob(const char* tokens, int64_t blob_len, int64_t n_tokens,
                       std::vector<uint32_t>& ids) {
  ids.resize(n_tokens);
  std::unordered_map<std::string_view, uint32_t> intern;
  intern.reserve(256);
  const char* p = tokens;
  const char* end = tokens + blob_len;
  int64_t t = 0;
  while (p < end) {
    const char* sp = (const char*)memchr(p, ' ', end - p);
    const char* tok_end = sp ? sp : end;
    if (tok_end == p) return -3;   // empty token: "" in the token list
    if (t >= n_tokens) return -3;  // a token contained a space
    std::string_view tok(p, tok_end - p);
    auto it = intern.find(tok);
    if (it == intern.end()) {
      uint32_t id = (uint32_t)intern.size();
      if (id >= 65535) return -1;  // key packing limit; caller falls back
      it = intern.emplace(tok, id).first;
    }
    ids[t++] = it->second;
    p = tok_end + 1;
  }
  return t == n_tokens ? 0 : -3;
}

// math.fsum for a short vector — CPython's Shewchuk partials algorithm
// ported op-for-op (Modules/mathmodule.c), so the result is the same
// correctly-rounded sum nltk's geometric mean sees.
static double py_fsum(const double* a, int n) {
  double partials[8];  // callers pass <= 4 terms; partials can't exceed that
  int np = 0;
  for (int i = 0; i < n; ++i) {
    double x = a[i];
    int used = 0;
    for (int j = 0; j < np; ++j) {
      double y = partials[j];
      if (std::fabs(x) < std::fabs(y)) {
        double tmp = x;
        x = y;
        y = tmp;
      }
      const double hi = x + y;
      const double lo = y - (hi - x);
      if (lo != 0.0) partials[used++] = lo;
      x = hi;
    }
    partials[used++] = x;
    np = used;
  }
  double hi = 0.0;
  if (np > 0) {
    int n2 = np;
    hi = partials[--n2];
    double lo = 0.0;
    while (n2 > 0) {
      const double x = hi;
      const double y = partials[--n2];
      hi = x + y;
      const double yr = hi - x;
      lo = y - yr;
      if (lo != 0.0) break;
    }
    if (n2 > 0 && ((lo < 0.0 && partials[n2 - 1] < 0.0) || (lo > 0.0 && partials[n2 - 1] > 0.0))) {
      const double y = lo * 2.0;
      const double x = hi + y;
      if (y == x - hi) hi = x;
    }
  }
  return hi;
}

}  // namespace

extern "C" {

// tokens: ALL tokens of the batch, single-space-separated UTF-8 (one
//   flat " ".join — the cheapest serialization Python can produce),
//   captions ordered per image: hypothesis first, then its references;
//   caption boundaries come from tok_counts alone.  The space byte
//   never occurs inside multi-byte UTF-8 sequences, so byte-level
//   splitting is exact.  A token that itself contains a space would
//   inflate the parsed token count; an empty token (from "" in a token
//   list) would produce a zero-length split — both return -3 and the
//   caller falls back to the Python join/split semantics.
// n_tokens: expected total token count (sum of tok_counts).
// tok_counts[c]: token count of caption c (same order).
// ref_counts[i]: reference count of image i (>=1).
// log_table[d], d in 0..n_images: float(np.log(max(1.0, float(d)))),
//   computed with scalar np.log in Python (idf inputs must be np.log's
//   bits, not libm's).
// Outputs:
//   bleu_totals[10]: guess[4], correct[4], total_testlen, total_reflen
//     (exact integers in doubles; Python finishes the corpus formula).
//   cider_per_image[n_images], rouge_per_image[n_images].
// Returns 0, or -1 on >=65535 distinct tokens (caller falls back).
int st_eval_batch(const char* tokens, int64_t blob_len, int64_t n_tokens,
                  const int32_t* tok_counts, const int32_t* ref_counts, int32_t n_images,
                  const double* log_table, double* bleu_totals, double* cider_per_image,
                  double* rouge_per_image) {
  int64_t n_captions = 0, expect_tokens = 0;
  for (int32_t i = 0; i < n_images; ++i) n_captions += 1 + ref_counts[i];
  for (int64_t c = 0; c < n_captions; ++c) expect_tokens += tok_counts[c];
  if (expect_tokens != n_tokens) return -3;

  // ---- split the flat blob on ' ' and intern tokens to dense ids
  // (16-bit, so a 4-gram packs in 64).
  std::vector<uint32_t> ids;
  {
    const int rc = intern_blob(tokens, blob_len, n_tokens, ids);
    if (rc != 0) return rc;
  }

  std::vector<Caption> caps(n_captions);
  {
    Scratch sc;
    int64_t off = 0;
    for (int64_t c = 0; c < n_captions; ++c) {
      caps[c].len = tok_counts[c];
      caps[c].ids = ids.data() + off;
      off += tok_counts[c];
      count_ngrams(caps[c], sc);
    }
  }

  // Caption index of image i's hypothesis; refs follow it.
  std::vector<int64_t> hyp_at(n_images);
  {
    int64_t c = 0;
    for (int32_t i = 0; i < n_images; ++i) {
      hyp_at[i] = c;
      c += 1 + ref_counts[i];
    }
  }

  // ---- document frequency over the reference set (per k).
  std::unordered_map<uint64_t, int32_t> df[4];
  {
    std::unordered_set<uint64_t> seen[4];
    for (int32_t i = 0; i < n_images; ++i) {
      for (int k = 0; k < 4; ++k) seen[k].clear();
      for (int32_t r = 0; r < ref_counts[i]; ++r) {
        const Caption& rc = caps[hyp_at[i] + 1 + r];
        for (int k = 0; k < 4; ++k)
          for (const auto& kv : rc.k[k].items) seen[k].insert(kv.first);
      }
      for (int k = 0; k < 4; ++k)
        for (uint64_t key : seen[k]) df[k][key] += 1;
    }
  }
  const double log_n = log_table[n_images];

  // ---- BLEU corpus totals (integer counting; metrics.bleu_corpus).
  {
    int64_t total_guess[4] = {0, 0, 0, 0}, total_correct[4] = {0, 0, 0, 0};
    int64_t total_testlen = 0;
    double total_reflen = 0.0;  // Python accumulates float += int
    std::unordered_map<uint64_t, int32_t> max_ref;
    std::vector<int32_t> reflens;
    for (int32_t i = 0; i < n_images; ++i) {
      const Caption& hyp = caps[hyp_at[i]];
      const int32_t testlen = hyp.len;
      reflens.clear();
      for (int32_t r = 0; r < ref_counts[i]; ++r) reflens.push_back(caps[hyp_at[i] + 1 + r].len);
      const int32_t reflen = closest_reflen(reflens, testlen);
      total_testlen += testlen;
      total_reflen += (double)reflen;
      for (int k = 0; k < 4; ++k) {
        max_ref.clear();
        for (int32_t r = 0; r < ref_counts[i]; ++r)
          for (const auto& kv : caps[hyp_at[i] + 1 + r].k[k].items) {
            auto& slot = max_ref[kv.first];
            if (kv.second > slot) slot = kv.second;
          }
        int64_t correct = 0;
        for (const auto& kv : hyp.k[k].items) {
          auto it = max_ref.find(kv.first);
          const int32_t m = it == max_ref.end() ? 0 : it->second;
          correct += kv.second < m ? kv.second : m;
        }
        const int32_t g = testlen - k;  // max(0, testlen - (k+1) + 1)
        total_guess[k] += g > 0 ? g : 0;
        total_correct[k] += correct;
      }
    }
    for (int k = 0; k < 4; ++k) {
      bleu_totals[k] = (double)total_guess[k];
      bleu_totals[4 + k] = (double)total_correct[k];
    }
    bleu_totals[8] = (double)total_testlen;
    bleu_totals[9] = total_reflen;
  }

  // ---- CIDEr (metrics.cider_corpus): tf-idf vectors in Counter order.
  {
    struct Vec {
      // per k: (key, tf*idf) in the caption's insertion order
      std::vector<std::pair<uint64_t, double>> v[4];
      double norm[4];
      int32_t length;  // upstream quirk: counts BIGRAMS
    };
    auto to_vec = [&](const Caption& c, Vec& out) {
      for (int k = 0; k < 4; ++k) {
        out.v[k].clear();
        double norm = 0.0;
        for (const auto& kv : c.k[k].items) {
          auto it = df[k].find(kv.first);
          const double idf = log_n - log_table[it == df[k].end() ? 0 : it->second];
          const double val = (double)kv.second * idf;
          out.v[k].emplace_back(kv.first, val);
          norm += val * val;  // Python: norm[k] += v * v, same order
        }
        out.norm[k] = std::sqrt(norm);
      }
      out.length = 0;
      for (const auto& kv : c.k[1].items) out.length += kv.second;
    };

    const double gauss_den = 2.0 * py_pow(6.0, 2.0);  // 2 * sigma ** 2
    Vec hv, rv;
    std::unordered_map<uint64_t, double> rmap;
    for (int32_t i = 0; i < n_images; ++i) {
      to_vec(caps[hyp_at[i]], hv);
      double total[4] = {0.0, 0.0, 0.0, 0.0};
      for (int32_t r = 0; r < ref_counts[i]; ++r) {
        to_vec(caps[hyp_at[i] + 1 + r], rv);
        const double delta = (double)(hv.length - rv.length);
        const double gauss = py_pow(M_E, -(py_pow(delta, 2.0)) / gauss_den);
        for (int k = 0; k < 4; ++k) {
          rmap.clear();
          for (const auto& kv : rv.v[k]) rmap.emplace(kv.first, kv.second);
          double val = 0.0;
          for (const auto& kv : hv.v[k]) {  // hyp insertion order
            auto it = rmap.find(kv.first);
            if (it == rmap.end()) continue;
            const double rr = it->second;
            if (rr != 0.0) {  // Python: `if r:` — idf 0 terms skipped
              const double h = kv.second;
              val += (h < rr ? h : rr) * rr;
            }
          }
          if (hv.norm[k] != 0.0 && rv.norm[k] != 0.0) val /= hv.norm[k] * rv.norm[k];
          total[k] += val * gauss;
        }
      }
      // float(np.mean(total)) — sequential sum for n=4 — then / R * 10.
      const double mean4 = (((total[0] + total[1]) + total[2]) + total[3]) / 4.0;
      cider_per_image[i] = mean4 / (double)ref_counts[i] * 10.0;
    }
  }

  // ---- ROUGE-L (metrics.rouge_l_corpus).  split(" ") semantics: an
  // empty caption is ONE empty token (matching another empty caption).
  {
    const double beta2 = py_pow(1.2, 2.0);
    static const uint32_t EMPTY[1] = {0xFFFFFFFFu};  // never a real id
    std::vector<int32_t> prev, cur;
    for (int32_t i = 0; i < n_images; ++i) {
      const Caption& hyp = caps[hyp_at[i]];
      const uint32_t* h_ids = hyp.len ? hyp.ids : EMPTY;
      const int32_t h_len = hyp.len ? hyp.len : 1;
      double pmax = 0.0, rmax = 0.0;
      bool first = true;
      for (int32_t r = 0; r < ref_counts[i]; ++r) {
        const Caption& ref = caps[hyp_at[i] + 1 + r];
        const uint32_t* r_ids = ref.len ? ref.ids : EMPTY;
        const int32_t r_len = ref.len ? ref.len : 1;
        const int32_t lcs = lcs_len(r_ids, r_len, h_ids, h_len, prev, cur);
        const double prec = (double)lcs / (double)h_len;
        const double rec = (double)lcs / (double)r_len;
        if (first || prec > pmax) pmax = prec;
        if (first || rec > rmax) rmax = rec;
        first = false;
      }
      rouge_per_image[i] = (pmax != 0.0 && rmax != 0.0)
                               ? ((1.0 + beta2) * pmax * rmax) / (rmax + beta2 * pmax)
                               : 0.0;
    }
  }

  return 0;
}

// The reference's final per-image eval pass (utils.py:232-246): for one
// image, sum nltk corpus_bleu([refs],[cand],w,method4) over candidates
// for every weight tuple — bit-identical to metrics.nltk_bleu4_method4
// (itself fuzz-pinned == against the installed nltk), candidates
// accumulated in order so the float sums match Python's.
//
// tokens/blob_len/n_tokens: flat " ".join blob as in st_eval_batch;
//   captions ordered: the n_refs references first, then the n_cands
//   candidate hypotheses.  tok_counts[c] per caption.
// weights: n_weights tuples of 4 doubles.  smooth_k: nltk's k (5).
// out_sums[w] = sum over candidates of the weight-w score.
int st_bleu4_method4_image(const char* tokens, int64_t blob_len, int64_t n_tokens,
                           const int32_t* tok_counts, int32_t n_refs, int32_t n_cands,
                           const double* weights, int32_t n_weights, int32_t smooth_k,
                           double* out_sums) {
  if (n_refs < 1 || n_cands < 1) return -2;
  std::vector<uint32_t> ids;
  {
    const int rc = intern_blob(tokens, blob_len, n_tokens, ids);
    if (rc != 0) return rc;
  }
  const int64_t n_caps = (int64_t)n_refs + n_cands;
  std::vector<const uint32_t*> cap_ids(n_caps);
  {
    int64_t off = 0, expect = 0;
    for (int64_t c = 0; c < n_caps; ++c) {
      cap_ids[c] = ids.data() + off;
      off += tok_counts[c];
      expect += tok_counts[c];
    }
    if (expect != n_tokens) return -3;
  }

  // Reference n-gram counts per (ref, n) — hoisted across candidates
  // (integer counts; Python rebuilds them per candidate, same values).
  std::vector<std::unordered_map<uint64_t, int32_t>> ref_maps((size_t)n_refs * 4);
  for (int32_t r = 0; r < n_refs; ++r) {
    const int32_t len = tok_counts[r];
    for (int n = 1; n <= 4; ++n) {
      auto& m = ref_maps[(size_t)r * 4 + (n - 1)];
      for (int32_t pos = 0; pos + n <= len; ++pos) {
        uint64_t key = 0;
        for (int j = 0; j < n; ++j) key |= (uint64_t)cap_ids[r][pos + j] << (16 * j);
        m[key] += 1;
      }
    }
  }
  // closest ref length: min over (abs(rl - hyp_len), rl) — per candidate.
  std::vector<int32_t> reflens(n_refs);
  for (int32_t r = 0; r < n_refs; ++r) reflens[r] = tok_counts[r];

  for (int32_t w = 0; w < n_weights; ++w) out_sums[w] = 0.0;

  std::unordered_map<uint64_t, int32_t> hyp_cnt;
  for (int32_t cand = 0; cand < n_cands; ++cand) {
    const int32_t hyp_len = tok_counts[n_refs + cand];
    const uint32_t* hyp = cap_ids[n_refs + cand];
    int64_t nums[4] = {0, 0, 0, 0}, dens[4];
    for (int n = 1; n <= 4; ++n) {
      hyp_cnt.clear();
      for (int32_t pos = 0; pos + n <= hyp_len; ++pos) {
        uint64_t key = 0;
        for (int j = 0; j < n; ++j) key |= (uint64_t)hyp[pos + j] << (16 * j);
        hyp_cnt[key] += 1;
      }
      int64_t num = 0;
      for (const auto& kv : hyp_cnt) {
        int32_t max_c = 0;
        for (int32_t r = 0; r < n_refs; ++r) {
          const auto& m = ref_maps[(size_t)r * 4 + (n - 1)];
          auto it = m.find(kv.first);
          const int32_t c = it == m.end() ? 0 : it->second;
          if (c > max_c) max_c = c;
        }
        num += kv.second < max_c ? kv.second : max_c;
      }
      nums[n - 1] = num;
      const int64_t total = hyp_len >= n ? hyp_len - n + 1 : 0;
      dens[n - 1] = total > 1 ? total : 1;  // max(1, sum(counts))
    }
    if (nums[0] == 0) continue;  // contributes exact 0.0 to every sum

    const int32_t closest = closest_reflen(reflens, hyp_len);
    double bp;
    if (hyp_len > closest)
      bp = 1.0;
    else if (hyp_len == 0)
      bp = 0.0;
    else
      bp = std::exp(1.0 - (double)closest / (double)hyp_len);

    double logs[4] = {0.0, 0.0, 0.0, 0.0};
    bool positive[4] = {false, false, false, false};
    int64_t incvnt = 1;
    for (int i = 0; i < 4; ++i) {
      if (nums[i] == 0) {
        if (hyp_len > 1) {
          // 1 / (2**incvnt * k / math.log(hyp_len)) — integer 2**i * k,
          // then int/double, exactly Python's evaluation order.
          const double numerator =
              1.0 / ((double)((int64_t(1) << incvnt) * smooth_k) / std::log((double)hyp_len));
          logs[i] = std::log(numerator / (double)dens[i]);
          positive[i] = true;
          incvnt += 1;
        }
      } else {
        logs[i] = std::log((double)nums[i] / (double)dens[i]);
        positive[i] = true;
      }
    }
    for (int32_t w = 0; w < n_weights; ++w) {
      double terms[4];
      int nt = 0;
      for (int i = 0; i < 4; ++i)
        if (positive[i]) terms[nt++] = weights[w * 4 + i] * logs[i];
      out_sums[w] += bp * std::exp(py_fsum(terms, nt));
    }
  }
  return 0;
}

}  // extern "C"
