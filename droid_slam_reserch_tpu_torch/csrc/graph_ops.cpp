// Host graph operations of the SLAM engine: the Schur bucket tables, the
// greedy thresholded proximity-edge selection with non-maximum suppression,
// and edge dedup (reference factor_graph.py:44-55 and :315-379,
// droid_kernels.cu:1244-1272).
//
// The port's copy of the JAX package's native/graph_ops.cpp, line for line,
// so that both select the same edges, also where distances tie (std::sort
// orders equal keys as neither numpy sort does).  native.py builds it with
// the host compiler at first use and binds its C ABI with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_set>
#include <vector>

extern "C" {

// Group edges by their depth bucket (source frame).
// ii[n] -> bucket_edges[num_buckets * R], bucket_mask[num_buckets * R]
// Returns the max degree (callers can retry with a larger R if needed).
int schur_buckets(const int32_t* ii, int n, int num_buckets, int R,
                  int32_t* bucket_edges, uint8_t* bucket_mask) {
  std::vector<int> count(num_buckets, 0);
  std::memset(bucket_edges, 0, sizeof(int32_t) * num_buckets * R);
  std::memset(bucket_mask, 0, sizeof(uint8_t) * num_buckets * R);
  int max_deg = 0;
  for (int e = 0; e < n; e++) {
    int k = ii[e];
    if (k < 0 || k >= num_buckets) continue;
    int c = count[k]++;
    if (c < R) {
      bucket_edges[k * R + c] = e;
      bucket_mask[k * R + c] = 1;
    }
    if (count[k] > max_deg) max_deg = count[k];
  }
  return max_deg;
}

// Greedy thresholded proximity-edge selection with NMS suppression
// (reference factor_graph.py:343-379).  d is the [len_i * len_j] distance
// matrix over (t0..t, t1..t); existing edges already suppressed by caller
// or passed via ex_* for suppression here.  Outputs bidirectional pairs
// into out_i/out_j; returns the count written (capacity `cap`).
int proximity_select(double* d, int t0, int t1, int t, int rad, int nms,
                     double thresh, long long max_factors, int n_initial,
                     const int32_t* ex_i, const int32_t* ex_j, int n_ex,
                     int stereo, int32_t* out_i, int32_t* out_j, int cap) {
  const int leni = t - t0;
  const int lenj = t - t1;
  const double INF = 1e30;

  auto suppress = [&](long long i, long long j) {
    long long lim = std::max(std::min((long long)std::abs(i - j) - 2,
                                      (long long)nms), 0LL);
    for (int di = -nms; di <= nms; di++) {
      for (int dj = -nms; dj <= nms; dj++) {
        if (std::abs(di) + std::abs(dj) <= lim) {
          long long i1 = i + di, j1 = j + dj;
          if (t0 <= i1 && i1 < t && t1 <= j1 && j1 < t)
            d[(i1 - t0) * lenj + (j1 - t1)] = INF;
        }
      }
    }
  };

  // pre-filter (reference :327-328)
  for (int a = 0; a < leni; a++)
    for (int b = 0; b < lenj; b++) {
      long long i = a + t0, j = b + t1;
      if (i - rad < j) d[a * lenj + b] = INF;
      else if (d[a * lenj + b] > 100.0) d[a * lenj + b] = INF;
    }

  // suppress around existing edges (reference :330-340)
  for (int e = 0; e < n_ex; e++) suppress(ex_i[e], ex_j[e]);

  int m = 0;
  long long count = n_initial;  // forced radius/self edges added by caller

  // forced edges: stereo self + temporal radius (reference :343-352)
  for (long long i = t0; i < t; i++) {
    if (stereo) {
      if (m < cap) { out_i[m] = (int32_t)i; out_j[m] = (int32_t)i; m++; count++; }
      if (t1 <= i) d[(i - t0) * lenj + (i - t1)] = INF;
    }
    for (long long j = std::max(i - rad - 1, 0LL); j < i; j++) {
      if (m + 1 < cap) {
        out_i[m] = (int32_t)i; out_j[m] = (int32_t)j; m++;
        out_i[m] = (int32_t)j; out_j[m] = (int32_t)i; m++;
        count += 2;
      }
      if (t1 <= j && j < t) d[(i - t0) * lenj + (j - t1)] = INF;
    }
  }

  // greedy selection by ascending distance (reference :354-376)
  long long total = (long long)leni * lenj;
  std::vector<int64_t> order(total);
  for (long long k = 0; k < total; k++) order[k] = k;
  std::sort(order.begin(), order.end(),
            [&](int64_t a, int64_t b) { return d[a] < d[b]; });

  for (long long idx = 0; idx < total; idx++) {
    int64_t k = order[idx];
    if (d[k] > thresh) break;
    if (max_factors > 0 && count > max_factors) break;
    long long i = k / lenj + t0;
    long long j = k % lenj + t1;
    if (m + 1 >= cap) break;
    out_i[m] = (int32_t)i; out_j[m] = (int32_t)j; m++;
    out_i[m] = (int32_t)j; out_j[m] = (int32_t)i; m++;
    count += 2;
    suppress(i, j);
  }
  return m;
}

// Edge dedup against an existing set (reference factor_graph.py:44-55).
// keep[k] = 1 iff (ii[k], jj[k]) not already present.
void dedup_edges(const int64_t* ii, const int64_t* jj, int n,
                 const int64_t* ex_i, const int64_t* ex_j, int n_ex,
                 uint8_t* keep) {
  std::unordered_set<int64_t> eset;
  eset.reserve(n_ex * 2);
  const int64_t STRIDE = 1 << 20;
  for (int e = 0; e < n_ex; e++) eset.insert(ex_i[e] * STRIDE + ex_j[e]);
  for (int k = 0; k < n; k++)
    keep[k] = eset.count(ii[k] * STRIDE + jj[k]) ? 0 : 1;
}

}  // extern "C"
