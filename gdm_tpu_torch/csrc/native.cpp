// Exact k-NN and voxel-grid subsampling on the host (gdm_tpu_torch.native).
//
// Host code of gdm_tpu_torch/native.py (not a device kernel): the port's
// copy of gdm_knn, gdm_knn_batch and gdm_grid_subsample of the JAX
// package's native/gdm_native.cpp, so the port builds and runs without
// the JAX package; gdm_radius_nn1 is csrc/radius_nn.cpp.  A
// left-balanced implicit KD-tree over a flat array with a bounded max-heap
// per query (ties by traversal order), and a voxel map with a
// collision-free packed key that keeps the voxels' first-occurrence order.
// Queries run on one thread (the JAX package's build adds OpenMP across
// queries; the results do not depend on it).  Built at first use with the
// host C++ compiler (gdm_tpu_torch/_build.py) and called through ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Node {
  float p[3];
  int32_t index;   // original point index
  int8_t axis;
};

// Build an implicit KD-tree over pts[n*3] into nodes (size n), recursing
// on median splits. Layout: subtree root at `node_i`, children at ranges.
void build(std::vector<Node>& nodes, std::vector<int32_t>& order,
           const float* pts, int lo, int hi, int depth) {
  if (lo >= hi) return;
  int mid = (lo + hi) / 2;
  int axis = depth % 3;
  std::nth_element(order.begin() + lo, order.begin() + mid,
                   order.begin() + hi, [&](int32_t a, int32_t b) {
                     return pts[a * 3 + axis] < pts[b * 3 + axis];
                   });
  Node& nd = nodes[mid];
  nd.index = order[mid];
  nd.axis = static_cast<int8_t>(axis);
  std::memcpy(nd.p, pts + order[mid] * 3, 3 * sizeof(float));
  build(nodes, order, pts, lo, mid, depth + 1);
  build(nodes, order, pts, mid + 1, hi, depth + 1);
}

struct HeapEntry {
  float d2;
  int32_t idx;
  bool operator<(const HeapEntry& o) const { return d2 < o.d2; }
};

// Bounded max-heap of the k best candidates.
struct KBest {
  std::vector<HeapEntry> h;
  size_t k;
  explicit KBest(size_t k_) : k(k_) { h.reserve(k_); }
  float worst() const {
    return h.size() < k ? INFINITY : h.front().d2;
  }
  void push(float d2, int32_t idx) {
    if (h.size() < k) {
      h.push_back({d2, idx});
      std::push_heap(h.begin(), h.end());
    } else if (d2 < h.front().d2) {
      std::pop_heap(h.begin(), h.end());
      h.back() = {d2, idx};
      std::push_heap(h.begin(), h.end());
    }
  }
};

void query_rec(const std::vector<Node>& nodes, int lo, int hi,
               const float* q, KBest& best) {
  if (lo >= hi) return;
  int mid = (lo + hi) / 2;
  const Node& nd = nodes[mid];
  float dx = q[0] - nd.p[0], dy = q[1] - nd.p[1], dz = q[2] - nd.p[2];
  // dx*dx + dy*dy + dz*dz as g++ contracts it where FMA is available
  // (the JAX package builds with -march=native): the same bits there
  best.push(std::fma(dz, dz, std::fma(dx, dx, dy * dy)), nd.index);
  float delta = q[nd.axis] - nd.p[nd.axis];
  int near_lo = delta <= 0 ? lo : mid + 1;
  int near_hi = delta <= 0 ? mid : hi;
  int far_lo = delta <= 0 ? mid + 1 : lo;
  int far_hi = delta <= 0 ? hi : mid;
  query_rec(nodes, near_lo, near_hi, q, best);
  if (delta * delta < best.worst())
    query_rec(nodes, far_lo, far_hi, q, best);
}

}  // namespace

extern "C" {

// Exact k-NN: for each of the m queries, indices of its k nearest support
// points (ascending distance). Ties broken by traversal order, matching a
// KD-tree backend. out_idx: [m*k]; out_dist (nullable): [m*k] (metres).
void gdm_knn(const float* support, int32_t n, const float* query,
             int32_t m, int32_t k, int32_t* out_idx, float* out_dist) {
  if (n <= 0 || m <= 0 || k <= 0) return;
  std::vector<Node> nodes(n);
  std::vector<int32_t> order(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  build(nodes, order, support, 0, n, 0);
  int kk = std::min<int32_t>(k, n);

  for (int qi = 0; qi < m; ++qi) {
    KBest best(static_cast<size_t>(kk));
    query_rec(nodes, 0, n, query + qi * 3, best);
    std::sort_heap(best.h.begin(), best.h.end());
    for (int j = 0; j < k; ++j) {
      // wrap-pad when k > n (mirrors jnp top-k over padded distances)
      const HeapEntry& e = best.h[std::min<int>(j, kk - 1)];
      out_idx[qi * k + j] = e.idx;
      if (out_dist) out_dist[qi * k + j] = std::sqrt(e.d2);
    }
  }
}

// Batched variant over [b, n, 3] / [b, m, 3] (knn_batch parity,
// models/RandLA/utils/nearest_neighbors/knn.pyx).
void gdm_knn_batch(const float* support, int32_t b, int32_t n,
                   const float* query, int32_t m, int32_t k,
                   int32_t* out_idx) {
  for (int i = 0; i < b; ++i)
    gdm_knn(support + static_cast<int64_t>(i) * n * 3, n,
            query + static_cast<int64_t>(i) * m * 3, m, k,
            out_idx + static_cast<int64_t>(i) * m * k, nullptr);
}

// Voxel-grid barycenter subsampling (grid_subsampling.cpp parity):
// averages points (and optional features) per occupied voxel of size dl.
// Returns the number of voxels written; call first with out_* = nullptr
// to get the count.
int32_t gdm_grid_subsample(const float* pts, int32_t n,
                           const float* features, int32_t fdim, float dl,
                           float* out_pts, float* out_features) {
  if (n <= 0 || dl <= 0) return 0;
  float mn[3] = {INFINITY, INFINITY, INFINITY};
  for (int i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) mn[d] = std::min(mn[d], pts[i * 3 + d]);

  struct Acc {
    double p[3] = {0, 0, 0};
    std::vector<double> f;
    int32_t count = 0;
    int32_t order = 0;
  };
  std::unordered_map<int64_t, Acc> vox;
  vox.reserve(static_cast<size_t>(n) / 4 + 1);
  int32_t next_order = 0;
  for (int i = 0; i < n; ++i) {
    int64_t ix = static_cast<int64_t>(
        std::floor((pts[i * 3 + 0] - mn[0]) / dl));
    int64_t iy = static_cast<int64_t>(
        std::floor((pts[i * 3 + 1] - mn[1]) / dl));
    int64_t iz = static_cast<int64_t>(
        std::floor((pts[i * 3 + 2] - mn[2]) / dl));
    // collision-FREE key: grid indices are non-negative (offset by the
    // min corner) and bounded by extent/dl, so 21 bits per axis
    // (2M voxels/axis) always suffice in practice — a Teschner-style
    // XOR hash used as the identity would silently merge colliding
    // voxels into one wrong barycenter
    int64_t key = (ix << 42) | (iy << 21) | iz;
    Acc& a = vox[key];
    if (a.count == 0) {
      a.order = next_order++;
      if (features && fdim > 0) a.f.assign(fdim, 0.0);
    }
    for (int d = 0; d < 3; ++d) a.p[d] += pts[i * 3 + d];
    if (features && fdim > 0)
      for (int d = 0; d < fdim; ++d)
        a.f[d] += features[static_cast<int64_t>(i) * fdim + d];
    a.count++;
  }
  int32_t n_out = static_cast<int32_t>(vox.size());
  if (out_pts) {
    for (const auto& kv : vox) {
      const Acc& a = kv.second;
      for (int d = 0; d < 3; ++d)
        out_pts[a.order * 3 + d] =
            static_cast<float>(a.p[d] / a.count);
      if (out_features && features && fdim > 0)
        for (int d = 0; d < fdim; ++d)
          out_features[static_cast<int64_t>(a.order) * fdim + d] =
              static_cast<float>(a.f[d] / a.count);
    }
  }
  return n_out;
}

}  // extern "C"
