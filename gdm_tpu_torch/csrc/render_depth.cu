// Depth rasterizers for BOP VSD on Hopper (sm_90a): a gather form
// (per-tile min over binned candidate faces) and a scatter form
// (per-face stamps into an atomic-min z-buffer).
//
// They replace two XLA programs of the JAX package, not Pallas kernels:
// gdm_tpu/ops/render_depth.py render_depth_window_gather (:347), which
// eval/vsd runs, and render_depth_window (:96), its bit-identical
// cross-check.  PyTorch has no fused op for either; the plain versions in
// ops/render_depth.py materialise [rows, k, tile^2] (gather) or
// [faces, tile^2] (scatter) temporaries.
//
// Arithmetic.  The outputs must be the JAX renderers' bits: an inside test
// `b >= 0` or a `1 / max(invz, eps)` flips pixels on any change of
// rounding.  The JAX package's f32 arithmetic, as XLA compiles it, fuses
// `A*B - C*D` into fma(A, B, -(C*D)) (the edge functions and the signed
// area) and rounds every other operation.  Here each operation is written
// with an explicitly rounded intrinsic (__fadd_rn, __fsub_rn, __fmul_rn,
// __fdiv_rn, __fmaf_rn) in that order, so that nvcc contracts nothing
// else; the file is built without --use_fast_math.
//
// Z-buffer.  Every depth written is positive (zpix > eps) or +inf, so the
// order of the floats' bit patterns as signed ints is the order of the
// floats, and atomicMin on the bits in any order leaves the minimum's bits:
// the result does not depend on the order of the atomics.
//
// Bound.  The gather form does one edge test per (candidate, pixel) of
// its rows: 3 edge functions (2 subtractions, a product and an FMA each)
// and 3 products by 1/area, ~18 f32 flops, plus the perspective depth
// (4 divisions) for the pixels inside.  At tile 32 and 64 candidates a row
// that is 64K tests against ~3 KB of candidate data: it is bound by
// operations, not bytes.  Design: one block per candidate row of one
// render and one thread per pixel of the row's tile; the row's candidates
// are set up once (projection, area, 1/area, edge coefficients) in shared
// memory and every thread loops over them with its running min in a
// register, then writes once.  Render and frame are the grid's y axis, so
// one launch covers a whole VSD chunk (frames x 2 renders).  The scatter
// form is a thread per (face, stamp pixel); it is the cross-check, not on
// the VSD path.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float EPS = 1e-9f;
constexpr int CH = 64;  // candidates set up in shared memory per step

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

// Per-face constants: edge coefficients (bx - ax, by - ay, ax, ay) of the
// edges 1->2, 2->0, 0->1, 1/area, the vertex depths, and ok (in front with
// |area| > eps).
struct Face {
  float ex[3], ey[3], ax[3], ay[3];
  float inv_a;
  float fz[3];
  bool ok;
};

__device__ __forceinline__ void set_edge(Face& f, int e, const Proj& a,
                                         const Proj& b) {
  f.ax[e] = a.x;
  f.ay[e] = a.y;
  f.ex[e] = __fsub_rn(b.x, a.x);
  f.ey[e] = __fsub_rn(b.y, a.y);
}

__device__ __forceinline__ Face setup(const Proj& p0, const Proj& p1,
                                      const Proj& p2) {
  Face f;
  set_edge(f, 0, p1, p2);
  set_edge(f, 1, p2, p0);
  set_edge(f, 2, p0, p1);
  const bool front = p0.z > EPS && p1.z > EPS && p2.z > EPS;
  const float d01x = __fsub_rn(p1.x, p0.x), d01y = __fsub_rn(p1.y, p0.y);
  const float d02x = __fsub_rn(p2.x, p0.x), d02y = __fsub_rn(p2.y, p0.y);
  const float area = __fmaf_rn(d01x, d02y, -__fmul_rn(d01y, d02x));
  const bool nz = fabsf(area) > EPS;
  f.ok = front && nz;
  f.inv_a = __fdiv_rn(1.0f, nz ? area : 1.0f);
  f.fz[0] = p0.z;
  f.fz[1] = p1.z;
  f.fz[2] = p2.z;
  return f;
}

// Depth of the face at pixel centre (sx, sy), or +inf where the pixel is
// outside it or the depth is not above eps.
__device__ __forceinline__ float zpix(const float* ex, const float* ey,
                                      const float* ax, const float* ay,
                                      float inv_a, const float* fz, float sx,
                                      float sy) {
  float b[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float edge = __fmaf_rn(ex[e], __fsub_rn(sy, ay[e]),
                                 -__fmul_rn(ey[e], __fsub_rn(sx, ax[e])));
    b[e] = __fmul_rn(edge, inv_a);
  }
  if (!(b[0] >= 0.f && b[1] >= 0.f && b[2] >= 0.f)) return CUDART_INF_F;
  const float invz = __fadd_rn(
      __fadd_rn(__fdiv_rn(b[0], fz[0]), __fdiv_rn(b[1], fz[1])),
      __fdiv_rn(b[2], fz[2]));
  const float m = (invz != invz) ? invz : fmaxf(invz, EPS);
  const float z = __fdiv_rn(1.0f, m);
  return z > EPS ? z : CUDART_INF_F;
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

// grid (rows, N), block tile*tile threads.  cand [N, rows, k, 3];
// slot_tile [N, rows] or null (dense layout: row r is tile r); verts
// [N, V, 3]; origin [N, 2]; out [N, h, w] filled with +inf bits.
__global__ void __launch_bounds__(1024) render_gather_kernel(
    const float* __restrict__ verts, int V, const int* __restrict__ cand,
    const int* __restrict__ slot_tile, int rows, int k,
    const float* __restrict__ K, const float* __restrict__ origin, int h,
    int w, int tile, int* __restrict__ out) {
  __shared__ float s_ex[3][CH], s_ey[3][CH], s_ax[3][CH], s_ay[3][CH];
  __shared__ float s_inva[CH], s_fz[3][CH];
  __shared__ int s_ok[CH];

  const int r = blockIdx.x, n = blockIdx.y;
  const int gx = w / tile, G = gx * (h / tile);
  const int tg = slot_tile ? slot_tile[(size_t)n * rows + r] : r;
  if (tg < 0 || tg >= G) return;  // padding row (sentinel tile G)
  const int lane = threadIdx.x;
  const int px = (tg % gx) * tile + lane % tile;
  const int py = (tg / gx) * tile + lane / tile;
  const float sx = __fadd_rn((float)px, 0.5f);
  const float sy = __fadd_rn((float)py, 0.5f);
  const float* vn = verts + (size_t)n * V * 3;
  const float ox = origin[2 * n], oy = origin[2 * n + 1];
  const int* row = cand + ((size_t)n * rows + r) * k * 3;

  float best = CUDART_INF_F;
  for (int c0 = 0; c0 < k; c0 += CH) {
    const int nc = min(CH, k - c0);
    if (lane < nc) {
      const int* t = row + (size_t)(c0 + lane) * 3;
      const Face f = setup(project(vn + (size_t)t[0] * 3, K, ox, oy),
                           project(vn + (size_t)t[1] * 3, K, ox, oy),
                           project(vn + (size_t)t[2] * 3, K, ox, oy));
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        s_ex[e][lane] = f.ex[e];
        s_ey[e][lane] = f.ey[e];
        s_ax[e][lane] = f.ax[e];
        s_ay[e][lane] = f.ay[e];
        s_fz[e][lane] = f.fz[e];
      }
      s_inva[lane] = f.inv_a;
      s_ok[lane] = f.ok;
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      if (!s_ok[c]) continue;
      const float ex[3] = {s_ex[0][c], s_ex[1][c], s_ex[2][c]};
      const float ey[3] = {s_ey[0][c], s_ey[1][c], s_ey[2][c]};
      const float ax[3] = {s_ax[0][c], s_ax[1][c], s_ax[2][c]};
      const float ay[3] = {s_ay[0][c], s_ay[1][c], s_ay[2][c]};
      const float fz[3] = {s_fz[0][c], s_fz[1][c], s_fz[2][c]};
      best = fminf(best, zpix(ex, ey, ax, ay, s_inva[c], fz, sx, sy));
    }
    __syncthreads();
  }
  if (best < CUDART_INF_F) {
    atomicMin(out + (size_t)n * h * w + (size_t)py * w + px,
              __float_as_int(best));
  }
}

// grid (ceil(F * tile^2 / 256), N), 256 threads: thread e stamps pixel
// e % tile^2 of face e / tile^2.  faces [N, F, 3]; verts [N, V, 3].
__global__ void __launch_bounds__(256) render_scatter_kernel(const float* __restrict__ verts, int V,
                                      const int* __restrict__ faces, int F,
                                      const float* __restrict__ K,
                                      const float* __restrict__ origin,
                                      int h, int w, int tile,
                                      int* __restrict__ out) {
  const int n = blockIdx.y;
  const int s = tile * tile;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)F * s) return;
  const int face = (int)(e / s), lane = (int)(e % s);
  const float* vn = verts + (size_t)n * V * 3;
  const float ox = origin[2 * n], oy = origin[2 * n + 1];
  const int* t = faces + ((size_t)n * F + face) * 3;
  const Proj p0 = project(vn + (size_t)t[0] * 3, K, ox, oy);
  const Proj p1 = project(vn + (size_t)t[1] * 3, K, ox, oy);
  const Proj p2 = project(vn + (size_t)t[2] * 3, K, ox, oy);
  const Face f = setup(p0, p1, p2);
  if (!f.ok) return;
  // raster anchor: bbox min, floored
  const float bx = floorf(fminf(fminf(p0.x, p1.x), p2.x));
  const float by = floorf(fminf(fminf(p0.y, p1.y), p2.y));
  const float ix = __fadd_rn(bx, (float)(lane % tile));
  const float iy = __fadd_rn(by, (float)(lane / tile));
  if (!(ix >= 0.f && ix < (float)w && iy >= 0.f && iy < (float)h)) return;
  const float z = zpix(f.ex, f.ey, f.ax, f.ay, f.inv_a, f.fz,
                       __fadd_rn(ix, 0.5f), __fadd_rn(iy, 0.5f));
  if (z < CUDART_INF_F) {
    atomicMin(out + (size_t)n * h * w + (size_t)iy * w + (size_t)ix,
              __float_as_int(z));
  }
}

int launch_fill(float* out, long long n, cudaStream_t st) {
  if (n == 0) return 0;
  fill_inf<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<int*>(out), n);
  return (int)cudaGetLastError();
}

int launch_finish(float* out, long long n, cudaStream_t st) {
  if (n == 0) return 0;
  inf_to_zero<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Gather renderer over N renders: out [N, h, w] f32 depth, 0 where no
// surface.  Returns the CUDA error of the launches (0 = launched).
int gdm_render_depth_gather(const float* verts, int V, const int* cand,
                            const int* slot_tile, int rows, int k,
                            const float* K, const float* origin, int N,
                            int h, int w, int tile, float* out,
                            cudaStream_t stream) {
  const long long total = (long long)N * h * w;
  int rc = launch_fill(out, total, stream);
  if (rc || rows == 0) return rc;
  render_gather_kernel<<<dim3(rows, N), tile * tile, 0, stream>>>(
      verts, V, cand, slot_tile, rows, k, K, origin, h, w, tile,
      reinterpret_cast<int*>(out));
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return launch_finish(out, total, stream);
}

// Scatter renderer over N renders of F faces each.
int gdm_render_depth_scatter(const float* verts, int V, const int* faces,
                             int F, const float* K, const float* origin,
                             int N, int h, int w, int tile, float* out,
                             cudaStream_t stream) {
  const long long total = (long long)N * h * w;
  int rc = launch_fill(out, total, stream);
  if (rc) return rc;
  const long long work = (long long)F * tile * tile;
  render_scatter_kernel<<<dim3((unsigned)((work + 255) / 256), N), 256, 0,
                          stream>>>(verts, V, faces, F, K, origin, h, w,
                                    tile, reinterpret_cast<int*>(out));
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return launch_finish(out, total, stream);
}

}  // extern "C"
