// Depth rasterizers for BOP VSD on Hopper (sm_90a).
//
// They replace two XLA programs of the JAX package, not Pallas kernels:
// gdm_tpu/ops/render_depth.py render_depth_window (:96), the scatter-min
// z-buffer, and render_depth_window_gather (:347), the per-tile min over
// a host-binned candidate table (bin_faces_to_slots :299).  The JAX
// package's VSD runs the gather form; the port's eval/vsd renders its
// culled face lists with the stamp below, which gives the same depth
// and needs no binning.  PyTorch has no fused op for either; the plain
// versions in ops/render_depth.py materialise [faces, tile^2] (scatter)
// or [rows, k, tile^2] (gather) temporaries.
//
// Two entry points share one face setup pass and one stamp:
//   gdm_render_depth_scatter  face lists: each face stamps the pixels of
//                             its bbox, within the tile x tile stamp at
//                             floor(bbox min), as render_depth_window
//                             tests them;
//   gdm_render_depth_gather   a candidate table (dense rows or slot rows):
//                             each entry stamps the pixels of its bbox
//                             within its row's tile, where
//                             render_depth_window_gather tests it.
//
// Arithmetic.  The outputs must be the JAX renderers' bits: an inside test
// `b >= 0` or a `1 / max(invz, eps)` flips pixels on any change of
// rounding.  The JAX package's f32 arithmetic, as XLA compiles it, fuses
// `A*B - C*D` into fma(A, B, -(C*D)) (the edge functions and the signed
// area) and rounds every other operation.  Here each operation is written
// with an explicitly rounded intrinsic (__fadd_rn, __fsub_rn, __fmul_rn,
// __fdiv_rn, __fmaf_rn) in that order, so that nvcc contracts nothing
// else; the file is built without --use_fast_math.  Every pixel test
// evaluates the full expression (zpix) at the pixel centre: stepping edge
// functions from pixel to pixel would round differently.
//
// Z-buffer.  A pixel's depth is the min over the faces that cover it.
// Every depth written is positive (zpix > eps) or +inf, so the order of
// the floats' bit patterns as signed ints is the order of the floats, and
// atomicMin on the bits in any order leaves the minimum's bits.
//
// Bbox.  The JAX renderers test more pixels than a face can cover: the
// whole stamp, or the whole tile.  A pixel centre a pixel beyond a face's
// bbox lies outside the face by more than any rounding of its edge
// functions (tests/test_torch_render_stamp.py holds the plain arithmetic
// to that on slivers and boundary corners), so the stamp tests only the
// bbox widened by one pixel: on the high side for a face (the JAX stamp
// starts at floor(bbox min)), on both sides for a table entry.
//
// Bound and design.  A test is 3 edge functions (2 subtractions, a product
// and an FMA each) and 3 products by 1/area, ~18 f32 flops, plus the
// perspective depth (4 divisions) where it is inside.  VSD's faces are
// subdivided to a few pixels (2-9 px bboxes), so the tests a render needs
// are few (~180K per render of workload (b)) and the least time is that
// of writing the depth: the renderers are bound by bytes, and in practice
// by the latency of their passes.  One setup per (render, record):
// projection, area, 1/area and edge coefficients (7 divisions) go once
// into a 64-byte record.  Then a warp per record walks its bbox pixels, a
// lane per pixel.  The z-buffer is filled with +inf before and turned
// into depth (+inf as 0) after.  A tile raster (a block per tile, faces
// binned to tiles on the card) took 1.5-2x the stamp's time on every
// workload measured (PERF.md), and was dropped.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float EPS = 1e-9f;
constexpr int THREADS = 256;  // setup and stamp blocks
constexpr int WARPS = THREADS / 32;

struct Proj {
  float x, y, z;  // window pixel coords and camera depth
};

// x * fx / max(z, eps) + cx - ox, each operation rounded, as in
// ops/render_depth._project (jnp.maximum and torch.clamp_min keep a NaN).
__device__ __forceinline__ Proj project(const float* __restrict__ v,
                                        const float* __restrict__ K,
                                        float ox, float oy) {
  const float z = v[2];
  const float zs = (z != z) ? z : fmaxf(z, EPS);
  Proj p;
  p.x = __fsub_rn(__fadd_rn(__fdiv_rn(__fmul_rn(v[0], K[0]), zs), K[2]), ox);
  p.y = __fsub_rn(__fadd_rn(__fdiv_rn(__fmul_rn(v[1], K[4]), zs), K[5]), oy);
  p.z = z;
  return p;
}

// Face record: edge coefficients (bx - ax, by - ay, ax, ay) of the edges
// 1->2, 2->0, 0->1 (so ax, ay hold the projected vertices 1, 2, 0),
// 1/area and the vertex depths.  A kept face's 1/area is never NaN.
struct __align__(16) Rec {
  float ex[3], ey[3], ax[3], ay[3];
  float inv_a;
  float fz[3];
};
static_assert(sizeof(Rec) == 64, "a record is four float4");

__device__ __forceinline__ void set_edge(Rec& f, int e, const Proj& a,
                                         const Proj& b) {
  f.ax[e] = a.x;
  f.ay[e] = a.y;
  f.ex[e] = __fsub_rn(b.x, a.x);
  f.ey[e] = __fsub_rn(b.y, a.y);
}

// Fills f; returns ok (in front with |area| > eps).
__device__ __forceinline__ bool setup(const Proj& p0, const Proj& p1,
                                      const Proj& p2, Rec& f) {
  set_edge(f, 0, p1, p2);
  set_edge(f, 1, p2, p0);
  set_edge(f, 2, p0, p1);
  const bool front = p0.z > EPS && p1.z > EPS && p2.z > EPS;
  const float d01x = __fsub_rn(p1.x, p0.x), d01y = __fsub_rn(p1.y, p0.y);
  const float d02x = __fsub_rn(p2.x, p0.x), d02y = __fsub_rn(p2.y, p0.y);
  const float area = __fmaf_rn(d01x, d02y, -__fmul_rn(d01y, d02x));
  const bool nz = fabsf(area) > EPS;
  f.inv_a = __fdiv_rn(1.0f, nz ? area : 1.0f);
  f.fz[0] = p0.z;
  f.fz[1] = p1.z;
  f.fz[2] = p2.z;
  return front && nz;
}

// Depth of the face at pixel centre (sx, sy), or +inf where the pixel is
// outside it or the depth is not above eps.
__device__ __forceinline__ float zpix(const Rec& f, float sx, float sy) {
  float b[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float edge = __fmaf_rn(f.ex[e], __fsub_rn(sy, f.ay[e]),
                                 -__fmul_rn(f.ey[e], __fsub_rn(sx, f.ax[e])));
    b[e] = __fmul_rn(edge, f.inv_a);
  }
  if (!(b[0] >= 0.f && b[1] >= 0.f && b[2] >= 0.f)) return CUDART_INF_F;
  const float invz = __fadd_rn(
      __fadd_rn(__fdiv_rn(b[0], f.fz[0]), __fdiv_rn(b[1], f.fz[1])),
      __fdiv_rn(b[2], f.fz[2]));
  const float m = (invz != invz) ? invz : fmaxf(invz, EPS);
  const float z = __fdiv_rn(1.0f, m);
  return z > EPS ? z : CUDART_INF_F;
}

// Tile of a table row: slot_tile[n, row], or the row itself in the dense
// layout; -1 for a padding row (tile outside [0, G)).
__device__ __forceinline__ int entry_tile(const int* __restrict__ slot_tile,
                                          int n, int rows, int row, int G) {
  const int t = slot_tile ? slot_tile[(size_t)n * rows + row] : row;
  return (t >= 0 && t < G) ? t : -1;
}

// grid (ceil(R / THREADS), N): record r of render n from the vertex
// triple tri[n, r] (faces [N, R, 3], or a table [N, rows, k, 3] with R =
// rows * k).  inv_a is NaN in the record of a dropped face (behind the
// camera or |area| <= eps, as an all-zero padding row is).
__global__ void __launch_bounds__(THREADS) setup_kernel(
    const float* __restrict__ verts, int V, const int* __restrict__ tri,
    int R, const float* __restrict__ K, const float* __restrict__ origin,
    Rec* __restrict__ rec) {
  const int n = blockIdx.y;
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const int* t = tri + ((size_t)n * R + r) * 3;
  const float* vn = verts + (size_t)n * V * 3;
  const float ox = origin[2 * n], oy = origin[2 * n + 1];
  Rec f;
  if (!setup(project(vn + (size_t)t[0] * 3, K, ox, oy),
             project(vn + (size_t)t[1] * 3, K, ox, oy),
             project(vn + (size_t)t[2] * 3, K, ox, oy), f))
    f.inv_a = CUDART_NAN_F;
  rec[(size_t)n * R + r] = f;
}

// grid (ceil(R / WARPS), N), THREADS threads: warp i of block b stamps
// record b * WARPS + i of render n.  A face (k == 0) tests columns bx ..
// floor(bbox max) + 1 from bx = floor(bbox min), at most the tile (and
// the rows alike); a table entry (k > 0; row r / k) tests its bbox
// widened by one pixel on each side, clipped to its row's tile.
__global__ void __launch_bounds__(THREADS) stamp_kernel(
    const Rec* __restrict__ rec, int R, int k,
    const int* __restrict__ slot_tile, int h, int w, int tile,
    int* __restrict__ out) {
  const int n = blockIdx.y;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  const Rec f = rec[(size_t)n * R + r];
  if (f.inv_a != f.inv_a) return;  // dropped face
  const float bx = floorf(fminf(fminf(f.ax[0], f.ax[1]), f.ax[2]));
  const float by = floorf(fminf(fminf(f.ay[0], f.ay[1]), f.ay[2]));
  if (!(fabsf(bx) < CUDART_INF_F && fabsf(by) < CUDART_INF_F)) return;
  const float ex = floorf(fmaxf(fmaxf(f.ax[0], f.ax[1]), f.ax[2]));
  const float ey = floorf(fmaxf(fmaxf(f.ay[0], f.ay[1]), f.ay[2]));
  float x0 = bx, y0 = by;
  int cw, chh;
  if (k == 0) {
    cw = (int)fminf(__fsub_rn(ex, bx) + 2.f, (float)tile);
    chh = (int)fminf(__fsub_rn(ey, by) + 2.f, (float)tile);
  } else {
    const int gx = w / tile;
    const int t = entry_tile(slot_tile, n, R / k, r / k, gx * (h / tile));
    if (t < 0) return;  // a padding row
    const float tx = (float)(t % gx * tile), ty = (float)(t / gx * tile);
    x0 = fmaxf(bx - 1.f, tx);
    y0 = fmaxf(by - 1.f, ty);
    const float x1 = fminf(ex + 1.f, tx + (float)(tile - 1));
    const float y1 = fminf(ey + 1.f, ty + (float)(tile - 1));
    if (!(x1 >= x0 && y1 >= y0)) return;
    cw = (int)(x1 - x0) + 1;
    chh = (int)(y1 - y0) + 1;
  }
  int* on = out + (size_t)n * h * w;
  for (int q = lane; q < cw * chh; q += 32) {
    const float ix = __fadd_rn(x0, (float)(q % cw));
    const float iy = __fadd_rn(y0, (float)(q / cw));
    if (!(ix >= 0.f && ix < (float)w && iy >= 0.f && iy < (float)h)) continue;
    const float z = zpix(f, __fadd_rn(ix, 0.5f), __fadd_rn(iy, 0.5f));
    if (z < CUDART_INF_F)
      atomicMin(on + (size_t)(int)iy * w + (int)ix, __float_as_int(z));
  }
}

__global__ void fill_inf(int* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __float_as_int(CUDART_INF_F);
}

// +inf (no surface) -> 0, as jnp.where(isfinite(depth), depth, 0)
__global__ void inf_to_zero(float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && isinf(out[i])) out[i] = 0.f;
}

inline unsigned blocks(long long work, int per) {
  return (unsigned)((work + per - 1) / per);
}

// Fill, setup of R records per render, stamp, finish.
int render(const float* verts, int V, const int* tri, int R, int k,
           const int* slot_tile, const float* K, const float* origin, int N,
           int h, int w, int tile, Rec* rec, float* out, cudaStream_t st) {
  const long long total = (long long)N * h * w;
  fill_inf<<<blocks(total, THREADS), THREADS, 0, st>>>(
      reinterpret_cast<int*>(out), total);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  setup_kernel<<<dim3(blocks(R, THREADS), N), THREADS, 0, st>>>(
      verts, V, tri, R, K, origin, rec);
  if ((rc = (int)cudaGetLastError())) return rc;
  stamp_kernel<<<dim3(blocks(R, WARPS), N), THREADS, 0, st>>>(
      rec, R, k, slot_tile, h, w, tile, reinterpret_cast<int*>(out));
  if ((rc = (int)cudaGetLastError())) return rc;
  inf_to_zero<<<blocks(total, THREADS), THREADS, 0, st>>>(out, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scatter renderer over N renders of F faces each (faces [N, F, 3]): out
// [N, h, w] f32 depth, 0 where no surface; rec [N * F] records (64 bytes
// each) of scratch, allocated by the caller.  Returns the CUDA error of
// the launches (0 = launched).
int gdm_render_depth_scatter(const float* verts, int V, const int* faces,
                             int F, const float* K, const float* origin,
                             int N, int h, int w, int tile, void* rec,
                             float* out, cudaStream_t stream) {
  return render(verts, V, faces, F, 0, nullptr, K, origin, N, h, w, tile,
                static_cast<Rec*>(rec), out, stream);
}

// Gather renderer: cand [N, rows, k, 3] with slot_tile [N, rows] (or null:
// the dense layout, row r is tile r); rows whose tile lies outside [0, G)
// are padding.  rec [N * rows * k] records of scratch.
int gdm_render_depth_gather(const float* verts, int V, const int* cand,
                            const int* slot_tile, int rows, int k,
                            const float* K, const float* origin, int N,
                            int h, int w, int tile, void* rec, float* out,
                            cudaStream_t stream) {
  return render(verts, V, cand, rows * k, k, slot_tile, K, origin, N, h, w,
                tile, static_cast<Rec*>(rec), out, stream);
}

}  // extern "C"
