// Cosine-similarity argmax for Hopper (sm_90a), f32 in, f32 accumulate.
//
// Replaces gdm_tpu/ops/pallas/similarity.py (_make_kernel, launched by
// _pallas_cosine_argmax) and computes exactly what the JAX main path runs,
// _xla_cosine_argmax: for each scene row r,
//     idx[r]   = argmax_j <scene[r], mesh[j]>   (ties -> lowest j)
//     score[r] = that maximum
// The [R, M] similarity matrix never reaches device memory.
//
// Bound: at the serving shape (R = 8*4096, M = 4096, C = 128) the work is
// 2*R*M*C = 34 GFLOP against ~19 MB read, so the kernel is compute-bound
// on the f32 FMA pipes.  The design keeps both operands in shared memory
// and gives every thread an 8x4 register tile, so each 4-deep k step costs
// twelve 16-byte shared loads for 128 FMAs.  Tensor cores (wgmma,
// bf16/TF32) are left for later work: they would change the arithmetic the
// JAX path does.
//
// Layout:
//   * one block per tile of TR scene rows; the tile is loaded once into
//     shared memory, row-major with rows padded to C + 4 floats;
//   * a loop inside the block walks the mesh in tiles of TM rows, staged
//     through shared memory the same way; this loop replaces the TPU's
//     sequential grid axis;
//   * thread (tr, tc) owns scene rows tr + 16*i (i < 8) and, in every mesh
//     tile, columns tc + 16*j (j < 4).  With the padded row stride the 16
//     column owners of a half-warp read 16-byte words from distinct banks,
//     and the two row owners of a warp read broadcast words;
//   * each thread keeps a running (best, idx) per row; it visits its
//     columns in ascending order and takes a strict '>', so it keeps the
//     lowest index among equal scores;
//   * the 16 threads that share rows sit in one half-warp and merge with
//     shuffles, ordering by (score desc, idx asc);
//   * the ragged mesh edge is a bounds check on the column, not padding.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TR = 128;       // scene rows per block
constexpr int TM = 64;        // mesh rows per shared-memory tile
constexpr int NT = 16;        // threads along each tile axis
constexpr int THREADS = NT * NT;
constexpr int MR = TR / NT;   // rows per thread (8)
constexpr int MC = TM / NT;   // mesh columns per thread per tile (4)
constexpr int PAD = 4;        // floats of padding per shared-memory row

__device__ __forceinline__ bool wins(float s, long long i, float bs,
                                     long long bi) {
  return s > bs || (s == bs && i < bi);
}

// Copy `rows` rows of a row-major [*, C] matrix, starting at row0, into
// shared memory with row stride C + PAD; rows past n_rows become zeros.
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int row0, int n_rows, int C,
                                          int rows, float* __restrict__ dst) {
  const int c4 = C / 4;
  for (int e = threadIdx.x; e < rows * c4; e += THREADS) {
    const int r = e / c4;
    const int k4 = e - r * c4;
    const int gr = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < n_rows) {
      v = reinterpret_cast<const float4*>(src + (size_t)gr * C)[k4];
    }
    *reinterpret_cast<float4*>(dst + r * (C + PAD) + 4 * k4) = v;
  }
}

__global__ void __launch_bounds__(THREADS)
cosine_argmax_kernel(const float* __restrict__ scene,
                     const float* __restrict__ mesh, int R, int M, int C,
                     long long* __restrict__ idx_out,
                     float* __restrict__ score_out) {
  extern __shared__ float4 smem4[];
  const int ld = C + PAD;
  float* scene_s = reinterpret_cast<float*>(smem4);  // [TR][C + PAD]
  float* mesh_s = scene_s + (size_t)TR * ld;         // [TM][C + PAD]

  const int tr = threadIdx.x / NT;
  const int tc = threadIdx.x % NT;
  const int row0 = blockIdx.x * TR;

  load_rows(scene, row0, R, C, TR, scene_s);

  float best[MR];
  long long arg[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    best[i] = -CUDART_INF_F;
    arg[i] = 0;
  }

  for (int m0 = 0; m0 < M; m0 += TM) {
    __syncthreads();  // the previous mesh tile has been consumed
    load_rows(mesh, m0, M, C, TM, mesh_s);
    __syncthreads();

    float acc[MR][MC];
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < MC; ++j) acc[i][j] = 0.f;

#pragma unroll 2
    for (int k = 0; k < C; k += 4) {
      float4 a[MR], b[MC];
#pragma unroll
      for (int i = 0; i < MR; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            scene_s + (tr + NT * i) * ld + k);
#pragma unroll
      for (int j = 0; j < MC; ++j)
        b[j] = *reinterpret_cast<const float4*>(
            mesh_s + (tc + NT * j) * ld + k);
#pragma unroll
      for (int i = 0; i < MR; ++i) {
#pragma unroll
        for (int j = 0; j < MC; ++j) {
          float s = acc[i][j];
          s = fmaf(a[i].x, b[j].x, s);
          s = fmaf(a[i].y, b[j].y, s);
          s = fmaf(a[i].z, b[j].z, s);
          s = fmaf(a[i].w, b[j].w, s);
          acc[i][j] = s;
        }
      }
    }

#pragma unroll
    for (int j = 0; j < MC; ++j) {
      const int col = m0 + tc + NT * j;
      if (col < M) {
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          if (acc[i][j] > best[i]) {
            best[i] = acc[i][j];
            arg[i] = col;
          }
        }
      }
    }
  }

  // merge the 16 threads of a half-warp that share these rows
#pragma unroll
  for (int i = 0; i < MR; ++i) {
#pragma unroll
    for (int off = NT / 2; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const long long oi = __shfl_xor_sync(0xffffffffu, arg[i], off);
      if (wins(ob, oi, best[i], arg[i])) {
        best[i] = ob;
        arg[i] = oi;
      }
    }
  }
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int gr = row0 + tr + NT * i;
      if (gr < R) {
        idx_out[gr] = arg[i];
        score_out[gr] = best[i];
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  scene [R, C], mesh [M, C]
// row-major f32, C % 4 == 0, C <= 256, 16-byte aligned; idx [R] int64,
// score [R] f32.  Launches on `stream` without synchronising; returns
// cudaGetLastError().
extern "C" int gdm_cosine_argmax(const float* scene, const float* mesh,
                                 int R, int M, int C, long long* idx,
                                 float* score, void* stream) {
  if (R <= 0) return 0;
  const size_t smem = (size_t)(TR + TM) * (C + PAD) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cosine_argmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((R + TR - 1) / TR);
  cosine_argmax_kernel<<<grid, THREADS, smem,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      scene, mesh, R, M, C, idx, score);
  return (int)cudaGetLastError();
}
