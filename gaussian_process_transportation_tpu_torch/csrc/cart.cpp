// Greedy CART best-split search for the random forest's host fit.
//
// The port's copy of the JAX package's native/cart.cpp, called through
// ctypes by models/random_forest.py::_best_split_native and built with g++
// at first use (ops/_cuda.py::build_host).  Split finding is data-dependent
// and sequential, so it runs on the host; the trees' prediction is a gather
// descent on the device.
//
// Semantics equal the numpy twin (random_forest.py::_best_split): per
// feature, stable-sort the column, scan prefix sums of y and y^2, score the
// boundaries between strictly increasing consecutive values by the total SSE
// of the two children, keep the first minimum; across features keep the
// first strict improvement; the threshold is the midpoint of the straddling
// values.  Built with -ffp-contract=off so that no FMA changes a score's
// rounding and near-tie argmins resolve as numpy's do.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <vector>

extern "C" int gpt_best_split(const double* X, const double* y, int64_t n,
                              int64_t d, int64_t P, int64_t* out_feature,
                              double* out_threshold) {
  if (n < 2 || d < 1 || P < 1) return 0;
  std::vector<int64_t> order(n);
  std::vector<double> xs(n);
  std::vector<double> sl(P), ssl(P);
  std::vector<double> base_sum(P, 0.0), base_sq(P, 0.0);
  for (int64_t i = 0; i < n; ++i) {
    const double* yi = y + i * P;
    for (int64_t p = 0; p < P; ++p) {
      base_sum[p] += yi[p];
      base_sq[p] += yi[p] * yi[p];
    }
  }

  double best_score = std::numeric_limits<double>::infinity();
  int64_t best_f = -1;
  double best_thr = 0.0;

  for (int64_t f = 0; f < d; ++f) {
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
      return X[a * d + f] < X[b * d + f];
    });
    for (int64_t i = 0; i < n; ++i) xs[i] = X[order[i] * d + f];
    if (!(xs[n - 1] > xs[0])) continue;  // constant column: no valid split

    std::fill(sl.begin(), sl.end(), 0.0);
    std::fill(ssl.begin(), ssl.end(), 0.0);
    double feat_best = std::numeric_limits<double>::infinity();
    int64_t feat_i = -1;
    for (int64_t i = 1; i < n; ++i) {
      const double* yi = y + order[i - 1] * P;
      for (int64_t p = 0; p < P; ++p) {
        sl[p] += yi[p];
        ssl[p] += yi[p] * yi[p];
      }
      if (!(xs[i] > xs[i - 1])) continue;  // tie: not a boundary
      const double nl = static_cast<double>(i);
      const double nr = static_cast<double>(n - i);
      // accumulate the two children separately, then add — matches the
      // numpy twin's `A.sum(axis=1) + B.sum(axis=1)` rounding order so
      // near-tie argmins resolve identically
      double sse_l = 0.0, sse_r = 0.0;
      for (int64_t p = 0; p < P; ++p) {
        const double srp = base_sum[p] - sl[p];
        const double ssrp = base_sq[p] - ssl[p];
        sse_l += ssl[p] - sl[p] * sl[p] / nl;
        sse_r += ssrp - srp * srp / nr;
      }
      const double sse = sse_l + sse_r;
      if (sse < feat_best) {
        feat_best = sse;
        feat_i = i;
      }
    }
    if (feat_i >= 0 && feat_best < best_score) {
      best_score = feat_best;
      best_f = f;
      best_thr = 0.5 * (xs[feat_i - 1] + xs[feat_i]);
    }
  }
  if (best_f < 0) return 0;
  *out_feature = best_f;
  *out_threshold = best_thr;
  return 1;
}
