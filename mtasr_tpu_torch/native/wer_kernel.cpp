// Fast edit-distance alignment kernel for WER/cpWER scoring.
//
// Replaces the hot O(n*m) dynamic program of the reference's pure-Python
// scorer (the reference's utils/compute-wer.py Calculator.calculate,
// lines 96-213) with a banded-free C++ implementation over token IDs.
// Cost model and traceback preference order are kept IDENTICAL to the
// reference (del checked first, then ins, then diagonal, strict '<'),
// so counts match token-for-token.
//
// Exposed C ABI (ctypes-friendly):
//   wer_align(lab, n, rec, m, counts[5])          -> edit distance
//   wer_align_batch(...)                          -> many pairs at once
//   cpwer_best_perm(...)                          -> min-permutation WER
//     over K reference/hypothesis streams (K <= 8, K! enumerated)
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

// counts: [all, cor, sub, del, ins]; ops_out (optional, capacity >= n+m):
// traceback op codes in LEFT-TO-RIGHT order (1=cor 2=sub 3=del 4=ins) so
// callers can rebuild the reference's verbose alignment dumps
// (compute-wer.py Calculator.calculate 'lab'/'rec' rows) natively.
// Returns the number of ops written (or the op count if ops_out is null).
int64_t wer_align_ops(const int32_t* lab, int64_t n, const int32_t* rec,
                      int64_t m, int64_t* counts, uint8_t* ops_out) {
  // dist[i][j]: edit distance between lab[:i] and rec[:j]
  // err codes: 0=non 1=cor 2=sub 3=del 4=ins
  std::vector<int32_t> dist((n + 1) * (m + 1));
  std::vector<uint8_t> err((n + 1) * (m + 1));
  auto at = [m](int64_t i, int64_t j) { return i * (m + 1) + j; };

  dist[at(0, 0)] = 0;
  err[at(0, 0)] = 0;
  for (int64_t i = 1; i <= n; ++i) { dist[at(i, 0)] = i; err[at(i, 0)] = 3; }
  for (int64_t j = 1; j <= m; ++j) { dist[at(0, j)] = j; err[at(0, j)] = 4; }

  for (int64_t i = 1; i <= n; ++i) {
    const int32_t li = lab[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      int32_t best = dist[at(i - 1, j)] + 1;  // del (checked first)
      uint8_t bestE = 3;
      int32_t d = dist[at(i, j - 1)] + 1;     // ins
      if (d < best) { best = d; bestE = 4; }
      if (li == rec[j - 1]) {
        d = dist[at(i - 1, j - 1)];
        if (d < best) { best = d; bestE = 1; }
      } else {
        d = dist[at(i - 1, j - 1)] + 1;
        if (d < best) { best = d; bestE = 2; }
      }
      dist[at(i, j)] = best;
      err[at(i, j)] = bestE;
    }
  }

  int64_t all = 0, cor = 0, sub = 0, del = 0, ins = 0, n_ops = 0;
  int64_t i = n, j = m;
  while (i != 0 || j != 0) {
    const uint8_t e = err[at(i, j)];
    switch (e) {
      case 1: ++all; ++cor; --i; --j; break;
      case 2: ++all; ++sub; --i; --j; break;
      case 3: ++all; ++del; --i; break;
      case 4: ++ins; --j; break;
      default: i = 0; j = 0; continue;
    }
    if (ops_out) ops_out[n_ops] = e;
    ++n_ops;
  }
  if (ops_out) std::reverse(ops_out, ops_out + n_ops);
  counts[0] = all; counts[1] = cor; counts[2] = sub;
  counts[3] = del; counts[4] = ins;
  return ops_out ? n_ops : dist[at(n, m)];
}

int64_t wer_align(const int32_t* lab, int64_t n, const int32_t* rec,
                  int64_t m, int64_t* counts) {
  // counts-only wrapper; returns the edit distance (= S + D + I)
  wer_align_ops(lab, n, rec, m, counts, nullptr);
  return counts[2] + counts[3] + counts[4];
}

// Batched: pairs packed into flat arrays with offset tables.
// lab_flat/rec_flat: concatenated token ids; lab_off/rec_off: [P+1] offsets.
// counts_out: [P, 5].
void wer_align_batch(const int32_t* lab_flat, const int64_t* lab_off,
                     const int32_t* rec_flat, const int64_t* rec_off,
                     int64_t n_pairs, int64_t* counts_out) {
  for (int64_t p = 0; p < n_pairs; ++p) {
    wer_align(lab_flat + lab_off[p], lab_off[p + 1] - lab_off[p],
              rec_flat + rec_off[p], rec_off[p + 1] - rec_off[p],
              counts_out + p * 5);
  }
}

// cpWER: K reference streams vs K hypothesis streams (token ids, packed).
// Enumerates all K! assignments, returns best (err, total) and writes the
// best permutation (hyp index assigned to each ref stream) into perm_out.
void cpwer_best_perm(const int32_t* ref_flat, const int64_t* ref_off,
                     const int32_t* hyp_flat, const int64_t* hyp_off,
                     int64_t K, int64_t* err_out, int64_t* total_out,
                     int64_t* perm_out) {
  // precompute pairwise (errors, all) for every (ref i, hyp j)
  std::vector<int64_t> errs(K * K), alls(K * K);
  int64_t counts[5];
  for (int64_t i = 0; i < K; ++i) {
    for (int64_t j = 0; j < K; ++j) {
      wer_align(ref_flat + ref_off[i], ref_off[i + 1] - ref_off[i],
                hyp_flat + hyp_off[j], hyp_off[j + 1] - hyp_off[j], counts);
      errs[i * K + j] = counts[2] + counts[3] + counts[4];
      alls[i * K + j] = counts[0];
    }
  }
  std::vector<int64_t> perm(K);
  for (int64_t i = 0; i < K; ++i) perm[i] = i;
  int64_t best_err = -1, best_total = 0;
  std::vector<int64_t> best_perm(perm);
  do {
    int64_t e = 0, t = 0;
    for (int64_t i = 0; i < K; ++i) {
      e += errs[i * K + perm[i]];
      t += alls[i * K + perm[i]];
    }
    if (best_err < 0 || e < best_err) {
      best_err = e;
      best_total = t;
      best_perm = perm;
    }
  } while (std::next_permutation(perm.begin(), perm.end()));
  *err_out = best_err;
  *total_out = best_total;
  for (int64_t i = 0; i < K; ++i) perm_out[i] = best_perm[i];
}

}  // extern "C"
