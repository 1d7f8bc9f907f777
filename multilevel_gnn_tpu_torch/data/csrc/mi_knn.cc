// Threaded kNN mutual-information estimators for the fold feature masks:
// continuous features against a discrete target (sklearn's _compute_mi_cd,
// mutual_info_classif) and against a continuous one (_compute_mi_cc,
// mutual_info_regression), value-exact to sklearn.
//
// The port's copy of multilevel_gnn_tpu's csrc/mi_knn.cc, built at first
// use by multilevel_gnn_tpu_torch/data/native.py (g++, -O3, one shared
// library with a plain C interface).  The caller reproduces sklearn's
// preprocessing in numpy (scale with_mean=False + the seeded 1e-10 noise)
// and passes a scipy digamma table of the integer arguments, so this core
// needs only sklearn's distance rounding (sqrt(d*d) for KDTree's
// euclidean, the GEMM expansion for brute kneighbors), the np.nextafter
// radius shrink and the <= radius counting.
//
// Each feature is one-dimensional, so the kNN radius and the radius counts
// are scans of a sorted array; features are split across threads.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// sklearn distance rounding: KDTree euclidean in 1-D computes
// sqrt((a-b)^2) — NOT fabs(a-b); the two can differ by one ulp, and the
// nextafter-shrunk radius makes that ulp decide counts.
static inline double skdist(double a, double b) {
  double d = a - b;
  return std::sqrt(d * d);
}

// sklearn BRUTE kneighbors rounding (pairwise-distances-reduction
// EuclideanArgKmin): squared distance via the GEMM expansion
// fl(fl(fl(a^2) + fl(-2 * fl(a*b))) + fl(b^2)), clamped at 0, then sqrt.
// NearestNeighbors(algorithm='auto') picks this path whenever
// k >= n_fit // 2 (neighbors/_base.py), which is every tiny class —
// verified bit-exact against sklearn over 3000 random classes
// (tests/test_torch_native.py).
static inline double skdist_brute(double a, double b) {
  double mid = -2.0 * (a * b);  // *2 is exact; one rounding in a*b
  double d2 = (a * a + mid) + b * b;
  return std::sqrt(d2 > 0.0 ? d2 : 0.0);
}

// One feature: x (n,) values, y (n,) class codes in [0, n_classes),
// counts per class precomputed.  digamma_tab[i] = scipy digamma(i).
double mi_cd_one(const double* x, const int32_t* y, long n, int n_classes,
                 const long* class_count, int k_neighbors,
                 const double* digamma_tab,
                 // scratch, reused across features per thread
                 std::vector<int>& order, std::vector<double>& xs,
                 std::vector<int>& ys, std::vector<double>& radius,
                 std::vector<std::vector<double>>& class_xs,
                 std::vector<int>& kept_k) {
  order.resize(n);
  for (long i = 0; i < n; ++i) order[i] = (int)i;
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return x[a] < x[b]; });
  xs.resize(n);
  ys.resize(n);
  for (long i = 0; i < n; ++i) {
    xs[i] = x[order[i]];
    ys[i] = y[order[i]];
  }

  // per-class sorted value lists
  for (int c = 0; c < n_classes; ++c) class_xs[c].clear();
  for (long i = 0; i < n; ++i) class_xs[ys[i]].push_back(xs[i]);

  radius.assign(n, -1.0);  // -1 = dropped (singleton class)
  kept_k.assign(n, 0);
  std::vector<long> pos(n_classes, 0);
  std::vector<double> brute_d;  // scratch for the brute regime
  for (long i = 0; i < n; ++i) {
    int c = ys[i];
    long cnt = class_count[c];
    long j = pos[c]++;  // index of this point within its class list
    if (cnt <= 1) continue;
    int k = (int)std::min<long>(k_neighbors, cnt - 1);
    const std::vector<double>& cx = class_xs[c];
    double kth = 0.0;
    if (k >= cnt / 2) {
      // sklearn auto-algorithm BRUTE regime (k >= n_fit // 2): GEMM-
      // expansion rounding, self excluded by INDEX (kneighbors with
      // X=None), k-th smallest by value
      brute_d.clear();
      for (long l = 0; l < cnt; ++l) {
        if (l == j) continue;
        brute_d.push_back(skdist_brute(cx[j], cx[l]));
      }
      std::nth_element(brute_d.begin(), brute_d.begin() + (k - 1),
                       brute_d.end());
      kth = brute_d[k - 1];
    } else {
      // KDTree regime: k-th smallest distance among class neighbors of a
      // sorted array — merge from both sides
      long li = j - 1, ri = j + 1;
      for (int step = 0; step < k; ++step) {
        double dl = li >= 0 ? cx[j] - cx[li] : HUGE_VAL;
        double dr = ri < (long)cx.size() ? cx[ri] - cx[j] : HUGE_VAL;
        if (dl <= dr) {
          kth = skdist(cx[j], cx[li]);
          --li;
        } else {
          kth = skdist(cx[ri], cx[j]);
          ++ri;
        }
      }
    }
    radius[i] = std::nextafter(kth, 0.0);
    kept_k[i] = k;
  }

  // m_all: for each kept point, count ALL kept points within <= radius.
  // Kept points are all points whose class count > 1 (sklearn drops
  // singleton-label points BEFORE the KDTree count).
  double sum_dg_m = 0.0, sum_dg_k = 0.0, sum_dg_lc = 0.0;
  long n_kept = 0;
  // compacted kept values for the window scan
  std::vector<double>& kx = class_xs.back();  // reuse slot n_classes
  kx.clear();
  for (long i = 0; i < n; ++i)
    if (class_count[ys[i]] > 1) kx.push_back(xs[i]);
  for (long i = 0; i < n; ++i) {
    if (radius[i] < 0.0) continue;
    double r = radius[i];
    double xi = xs[i];
    // conservative bracket, exact predicate inside
    double slack = 4e-16 * (std::abs(xi) + r) + 1e-300;
    long lo = std::lower_bound(kx.begin(), kx.end(), xi - r - slack) -
              kx.begin();
    long hi = std::upper_bound(kx.begin(), kx.end(), xi + r + slack) -
              kx.begin();
    long m = 0;
    for (long t = lo; t < hi; ++t)
      if (skdist(xi, kx[t]) <= r) ++m;
    sum_dg_m += digamma_tab[m];
    sum_dg_k += digamma_tab[kept_k[i]];
    sum_dg_lc += digamma_tab[class_count[ys[i]]];
    ++n_kept;
  }
  if (n_kept == 0) return 0.0;
  double mi = digamma_tab[n_kept] + sum_dg_k / n_kept - sum_dg_lc / n_kept -
              sum_dg_m / n_kept;
  return mi > 0.0 ? mi : 0.0;
}

}  // namespace

extern "C" {

// x: (n, g) row-major float64 (already scaled + noised by the caller)
// y: (n,) int32 class codes in [0, n_classes)
// digamma_tab: (n + 1,) scipy digamma of [0..n] (index 0 unused)
// out: (g,) float64
void mi_cd_batch(const double* x, long n, long g, const int32_t* y,
                 int n_classes, int k_neighbors, const double* digamma_tab,
                 double* out, int n_threads) {
  std::vector<long> class_count(n_classes, 0);
  for (long i = 0; i < n; ++i) ++class_count[y[i]];
  if (n_threads <= 0)
    n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
  n_threads = (int)std::min<long>(n_threads, g > 0 ? g : 1);

  auto worker = [&](long f0, long f1) {
    // per-thread scratch: column copy + sort buffers
    std::vector<double> col(n), xs, radius;
    std::vector<int> order, ys, kept_k;
    std::vector<std::vector<double>> class_xs(n_classes + 1);
    for (long f = f0; f < f1; ++f) {
      for (long i = 0; i < n; ++i) col[i] = x[i * g + f];
      out[f] = mi_cd_one(col.data(), y, n, n_classes, class_count.data(),
                         k_neighbors, digamma_tab, order, xs, ys, radius,
                         class_xs, kept_k);
    }
  };
  std::vector<std::thread> threads;
  long chunk = (g + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    long f0 = t * chunk, f1 = std::min<long>(g, f0 + chunk);
    if (f0 >= f1) break;
    threads.emplace_back(worker, f0, f1);
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------- //
// Continuous-continuous Kraskov estimator (sklearn _compute_mi_cc, the
// mutual_info_regression path): chebyshev kth-NN radius in the 2-D joint,
// then marginal range counts.  Chebyshev = max(|dx|, |dy|) has no sqrt
// rounding, so values are exact by construction.

namespace {

// count of sorted values v with |c - v| <= r, exact predicate inside a
// conservative bracket (binary-search endpoints round differently)
static inline long range_count(const std::vector<double>& v, double c,
                               double r) {
  double slack = 4e-16 * (std::abs(c) + r) + 1e-300;
  long lo = std::lower_bound(v.begin(), v.end(), c - r - slack) - v.begin();
  long hi = std::upper_bound(v.begin(), v.end(), c + r + slack) - v.begin();
  long m = 0;
  for (long t = lo; t < hi; ++t)
    if (std::abs(c - v[t]) <= r) ++m;
  return m;
}

double mi_cc_one(const double* x, const double* y, long n, int k,
                 const double* digamma_tab, std::vector<int>& order,
                 std::vector<double>& xs, std::vector<double>& ysv,
                 std::vector<double>& ys_sorted, std::vector<double>& heap) {
  order.resize(n);
  for (long i = 0; i < n; ++i) order[i] = (int)i;
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return x[a] < x[b]; });
  xs.resize(n);
  ysv.resize(n);
  for (long i = 0; i < n; ++i) {
    xs[i] = x[order[i]];
    ysv[i] = y[order[i]];
  }
  ys_sorted.assign(y, y + n);
  std::sort(ys_sorted.begin(), ys_sorted.end());

  double sum_dg_nx = 0.0, sum_dg_ny = 0.0;
  for (long i = 0; i < n; ++i) {
    // k smallest chebyshev distances via expansion in increasing |dx|
    heap.clear();  // max at front (small k: linear insert)
    long li = i - 1, ri = i + 1;
    while (true) {
      double dl = li >= 0 ? xs[i] - xs[li] : HUGE_VAL;
      double dr = ri < n ? xs[ri] - xs[i] : HUGE_VAL;
      double dx = std::min(dl, dr);
      if (dx == HUGE_VAL) break;
      if ((long)heap.size() >= k && dx >= heap.front()) break;
      long j = dl <= dr ? li : ri;
      if (dl <= dr) --li; else ++ri;
      double d = std::max(dx, std::abs(ysv[i] - ysv[j]));
      if ((long)heap.size() < k) {
        heap.push_back(d);
        std::sort(heap.rbegin(), heap.rend());
      } else if (d < heap.front()) {
        heap.front() = d;
        std::sort(heap.rbegin(), heap.rend());
      }
    }
    double r = std::nextafter(heap.front(), 0.0);
    sum_dg_nx += digamma_tab[range_count(xs, xs[i], r)];
    sum_dg_ny += digamma_tab[range_count(ys_sorted, ysv[i], r)];
  }
  double mi = digamma_tab[n] + digamma_tab[k] - sum_dg_nx / n -
              sum_dg_ny / n;
  return mi > 0.0 ? mi : 0.0;
}

}  // namespace

// x: (n, g) row-major float64, y: (n,) float64 — both already scaled +
// noised by the caller.  digamma_tab: (n + 1,).  out: (g,).
void mi_cc_batch(const double* x, long n, long g, const double* y,
                 int k_neighbors, const double* digamma_tab, double* out,
                 int n_threads) {
  if (n_threads <= 0)
    n_threads = (int)std::max(1u, std::thread::hardware_concurrency());
  n_threads = (int)std::min<long>(n_threads, g > 0 ? g : 1);
  auto worker = [&](long f0, long f1) {
    std::vector<double> col(n), xs, ysv, ys_sorted, heap;
    std::vector<int> order;
    for (long f = f0; f < f1; ++f) {
      for (long i = 0; i < n; ++i) col[i] = x[i * g + f];
      out[f] = mi_cc_one(col.data(), y, n, k_neighbors, digamma_tab, order,
                         xs, ysv, ys_sorted, heap);
    }
  };
  std::vector<std::thread> threads;
  long chunk = (g + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    long f0 = t * chunk, f1 = std::min<long>(g, f0 + chunk);
    if (f0 >= f1) break;
    threads.emplace_back(worker, f0, f1);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
