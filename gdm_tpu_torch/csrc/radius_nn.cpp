// Radius-bounded exact 1-NN on the host (GT correspondence generation).
//
// Host code of gdm_tpu_torch/data/gt_gen.py (not a device kernel): a copy
// of gdm_radius_nn1 in native/gdm_native.cpp, with the KD-tree it falls
// back to, so the port builds and runs without the JAX package.  For each
// query, the nearest support point within `radius` (inclusive) or -1,
// through a uniform voxel grid of cell size `radius` (any in-radius point
// lies in the query cell's 27 neighbours).  Built at first use with the
// host C++ compiler (gdm_tpu_torch/_build.py) and called through ctypes,
// which releases the GIL for the loader's threads.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
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
  best.push(dx * dx + dy * dy + dz * dz, nd.index);
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

// Radius-bounded exact 1-NN: for each query, the index of the nearest
// support point within `radius` (inclusive), or -1 when none is.  A
// uniform voxel grid with cell size = radius means any in-radius
// support point lies in one of the query cell's 27 neighbours, so this
// replaces the KD-tree build + backtracking search on the hot
// GT-correspondence path (gdm_tpu/data/gt_gen.py) where matches beyond
// nn_dist_th are discarded anyway — identical output, ~10x faster on
// ~2k-support / ~4k-query workloads.  out_dist (nullable): [m].
void gdm_radius_nn1(const float* support, int32_t n, const float* query,
                    int32_t m, float radius, int32_t* out_idx,
                    float* out_dist) {
  if (n <= 0 || m <= 0 || radius <= 0) {
    for (int i = 0; i < m; ++i) out_idx[i] = -1;
    return;
  }
  float mn[3] = {INFINITY, INFINITY, INFINITY};
  float mx[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int i = 0; i < n; ++i)
    for (int d = 0; d < 3; ++d) {
      mn[d] = std::min(mn[d], support[i * 3 + d]);
      mx[d] = std::max(mx[d], support[i * 3 + d]);
    }
  const float inv = 1.0f / radius;
  int64_t dims[3];
  double ncells_d = 1.0;
  bool oversize = false;
  for (int d = 0; d < 3; ++d) {
    // span in double first: casting a huge float to int64 is UB
    double span = std::floor(double(mx[d] - mn[d]) * double(inv)) + 1.0;
    if (!(span >= 1.0) || span > double(int64_t{1} << 24)) {
      oversize = true;
      span = 1.0;
    }
    dims[d] = static_cast<int64_t>(span);
    ncells_d *= span;
  }
  if (oversize || ncells_d > double(int64_t{1} << 24)) {
    // support spans >> its own density (e.g. a huge radius-relative
    // extent): dense cells would thrash — fall back to the KD-tree
    std::vector<Node> nodes(n);
    std::vector<int32_t> order(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    build(nodes, order, support, 0, n, 0);
    const float r2 = radius * radius;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int qi = 0; qi < m; ++qi) {
      KBest best(1);
      query_rec(nodes, 0, n, query + qi * 3, best);
      bool ok = !best.h.empty() && best.h[0].d2 <= r2;
      out_idx[qi] = ok ? best.h[0].idx : -1;
      if (out_dist)
        out_dist[qi] = ok ? std::sqrt(best.h[0].d2) : INFINITY;
    }
    return;
  }
  const int64_t ncells = dims[0] * dims[1] * dims[2];
  // dense counting-sort grid: no hashing on the hot path.  Cell coords
  // computed in double and clamped to [-2, dims+1] — far-away QUERIES
  // would otherwise overflow the int64 cast; the clamped sentinels
  // yield an empty scan window, which is the right answer for them.
  auto cell_of = [&](const float* p, int64_t c[3]) {
    for (int d = 0; d < 3; ++d) {
      double v = std::floor(double(p[d] - mn[d]) * double(inv));
      c[d] = v < -2.0 ? -2
             : (v > double(dims[d]) + 1.0 ? dims[d] + 1
                                          : static_cast<int64_t>(v));
    }
  };
  std::vector<int32_t> cell(n);
  std::vector<int32_t> start(ncells + 1, 0);
  for (int i = 0; i < n; ++i) {
    int64_t c[3];
    cell_of(support + i * 3, c);
    cell[i] = static_cast<int32_t>((c[0] * dims[1] + c[1]) * dims[2] + c[2]);
    start[cell[i] + 1]++;
  }
  for (int64_t c = 0; c < ncells; ++c) start[c + 1] += start[c];
  std::vector<int32_t> order(n);
  {
    std::vector<int32_t> cursor(start.begin(), start.end() - 1);
    for (int i = 0; i < n; ++i) order[cursor[cell[i]]++] = i;
  }
  const float r2 = radius * radius;

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int qi = 0; qi < m; ++qi) {
    const float* q = query + qi * 3;
    int64_t c[3];
    cell_of(q, c);
    float best_d2 = INFINITY;
    int32_t best = -1;
    const int64_t x0 = std::max<int64_t>(c[0] - 1, 0),
                  x1 = std::min<int64_t>(c[0] + 1, dims[0] - 1),
                  y0 = std::max<int64_t>(c[1] - 1, 0),
                  y1 = std::min<int64_t>(c[1] + 1, dims[1] - 1),
                  z0 = std::max<int64_t>(c[2] - 1, 0),
                  z1 = std::min<int64_t>(c[2] + 1, dims[2] - 1);
    if (x0 <= x1 && y0 <= y1 && z0 <= z1)
      for (int64_t cx = x0; cx <= x1; ++cx)
        for (int64_t cy = y0; cy <= y1; ++cy) {
          const int64_t row = (cx * dims[1] + cy) * dims[2];
          for (int64_t cz = z0; cz <= z1; ++cz) {
            for (int32_t j = start[row + cz]; j < start[row + cz + 1];
                 ++j) {
              int32_t si = order[j];
              const float* s = support + si * 3;
              float ddx = q[0] - s[0], ddy = q[1] - s[1],
                    ddz = q[2] - s[2];
              float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
              if (d2 < best_d2) { best_d2 = d2; best = si; }
            }
          }
        }
    if (best_d2 > r2) best = -1;
    out_idx[qi] = best;
    if (out_dist) out_dist[qi] = best < 0 ? INFINITY : std::sqrt(best_d2);
  }
}

}  // extern "C"
