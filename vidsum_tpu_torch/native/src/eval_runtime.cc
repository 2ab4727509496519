// ported from vidsum_tpu/native/src/eval_runtime.cc
// Native eval runtime: the host-side hot loops of the summary pipeline.
//
// The reference runs these as pure-Python loops — the O(n·W) 0/1-knapsack
// table (src/evaluation/knapsack_implementation.py:1-30) and the O(n²)
// KTS scatter matrix (src/data/preprocess/segmentations/kts/cpd_nonlin.py:5-24)
// — which dominate eval wall-clock once the model forward lives on the TPU.
// Both are reimplemented here with the exact same IEEE-double arithmetic and
// tie-breaking so selected shots stay bit-identical to the Python/NumPy paths
// (verified in tests/test_native.py and tests/test_torch_eval.py), loaded via ctypes (no pybind11 in this
// image).
//
// Build: python -m vidsum_tpu_torch.native.build  (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// 0/1 knapsack with backtrack. Returns the number of selected shots and
// writes their ascending indices into selected_out (caller allocates n).
// Table semantics match the reference DP: row i from row i-1 via
// max(val + prev[w - wt], prev[w]) with the take-branch winning ties, and
// the backtrack's strict != comparison.
int64_t vs_knapsack(int64_t W, const int64_t* wt, const double* val,
                    int64_t n, int64_t* selected_out) {
  const int64_t cols = W + 1;
  std::vector<double> table(static_cast<size_t>(n + 1) * cols, 0.0);
  for (int64_t i = 1; i <= n; ++i) {
    const double* prev = table.data() + (i - 1) * cols;
    double* row = table.data() + i * cols;
    const int64_t w_i = wt[i - 1];
    const double v_i = val[i - 1];
    if (w_i > W) {
      std::memcpy(row, prev, sizeof(double) * cols);
      continue;
    }
    std::memcpy(row, prev, sizeof(double) * w_i);
    for (int64_t w = w_i; w <= W; ++w) {
      const double cand = v_i + prev[w - w_i];
      row[w] = cand >= prev[w] ? cand : prev[w];
    }
  }
  int64_t count = 0;
  int64_t w = W;
  for (int64_t i = n; i >= 1; --i) {
    if (table[i * cols + w] != table[(i - 1) * cols + w]) {
      selected_out[count++] = i - 1;
      w -= wt[i - 1];
    }
  }
  // emitted in descending order; reverse to ascending
  for (int64_t a = 0, b = count - 1; a < b; ++a, --b) {
    const int64_t t = selected_out[a];
    selected_out[a] = selected_out[b];
    selected_out[b] = t;
  }
  return count;
}

// KTS scatter matrix: scatters[i][j] = within-segment variance of frames
// [i..j] from cumulative kernel sums, upper triangle (j >= i), zero below.
// Arithmetic order matches calc_scatters exactly:
//   K1[j+1]-K1[i] - (K2[j+1][j+1]+K2[i][i]-K2[j+1][i]-K2[i][j+1])/(j-i+1)
void vs_calc_scatters(const double* K, int64_t n, double* out) {
  const int64_t m = n + 1;
  std::vector<double> K1(m, 0.0);
  for (int64_t i = 0; i < n; ++i) K1[i + 1] = K1[i] + K[i * n + i];

  std::vector<double> K2(static_cast<size_t>(m) * m, 0.0);
  // K2[1:,1:] = cumsum(cumsum(K, axis=0), axis=1) — same association order
  // as NumPy (axis 0 fully first, then axis 1) for bit-identical results
  for (int64_t i = 1; i <= n; ++i)
    for (int64_t j = 1; j <= n; ++j)
      K2[i * m + j] = K2[(i - 1) * m + j] + K[(i - 1) * n + (j - 1)];
  for (int64_t i = 1; i <= n; ++i)
    for (int64_t j = 2; j <= n; ++j)
      K2[i * m + j] += K2[i * m + (j - 1)];
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t j = 0; j < n; ++j) {
      if (j < i) {
        out[i * n + j] = 0.0;
        continue;
      }
      const double diag = K1[j + 1] - K1[i];
      const double block = K2[(j + 1) * m + (j + 1)] + K2[i * m + i] -
                           K2[(j + 1) * m + i] - K2[i * m + (j + 1)];
      out[i * n + j] = diag - block / static_cast<double>(j - i + 1);
    }
  }
}

// KTS change-point DP (cpd_nonlin semantics): fills scores[0..m] with the
// objective per change-point count and cps[0..m-1] with the backtracked
// change points for exactly m change points. J is the n x n scatter matrix.
void vs_cpd_dp(const double* J, int64_t n, int64_t m, int64_t lmin,
               int64_t lmax, double* scores, int64_t* cps) {
  const double kHugeInit = 1e101;
  const double kHuge = 1e100;
  const int64_t cols = n + 1;
  std::vector<double> I(static_cast<size_t>(m + 1) * cols, kHugeInit);
  std::vector<int64_t> p(static_cast<size_t>(m + 1) * cols, 0);

  for (int64_t l = lmin; l < lmax && l <= n; ++l)
    I[l] = J[0 * n + (l - 1)];

  for (int64_t k = 1; k <= m; ++k) {
    const double* prev = I.data() + (k - 1) * cols;
    double* row = I.data() + k * cols;
    int64_t* prow = p.data() + k * cols;
    for (int64_t l = (k + 1) * lmin; l <= n; ++l) {
      double best = kHuge;
      int64_t best_t = 0;
      const int64_t t_lo = std::max(k * lmin, l - lmax);
      const int64_t t_hi = l - lmin;
      for (int64_t t = t_lo; t <= t_hi; ++t) {
        const double c = prev[t] + J[t * n + (l - 1)];
        if (c < best) {
          best = c;
          best_t = t;
        }
      }
      row[l] = best;
      prow[l] = best_t;
    }
  }

  for (int64_t k = 0; k <= m; ++k) {
    const double s = I[k * cols + n];
    scores[k] = s > 1e99 ? std::numeric_limits<double>::infinity() : s;
  }
  int64_t cur = n;
  for (int64_t k = m; k >= 1; --k) {
    cps[k - 1] = p[k * cols + cur];
    cur = cps[k - 1];
  }
}

}  // extern "C"
