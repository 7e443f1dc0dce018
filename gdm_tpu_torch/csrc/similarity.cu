// Cosine-similarity argmax for Hopper (sm_90a): f32-accurate products on
// the tensor cores by the three-way TF32 split ("3xTF32"), fed by TMA,
// with the argmax fused into the epilogue.
//
// Replaces gdm_tpu/ops/pallas/similarity.py:89 (the pallas_call of
// _make_kernel, launched by _pallas_cosine_argmax) and computes what the
// JAX main path runs, _xla_cosine_argmax: for each scene row r,
//     idx[r]   = argmax_j <scene[r], mesh[j]>   (ties -> lowest j)
//     score[r] = that maximum
// The [R, M] similarity matrix never reaches device memory.
//
// Arithmetic.  Each operand is split as x = hi + lo with
// hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi); <a, b> is taken as
// lo_a.hi_b + hi_a.lo_b + hi_a.hi_b by TF32 wgmma (k = 8, f32
// accumulators), the two small terms first at every k step.  For unit
// rows the dropped lo.lo term and the rounding of lo cost at most
// ~3 * 2^-22 ~ 7e-7 in a score (Cauchy-Schwarz over the row); the tensor
// cores' f32 accumulation over C/8 k steps x 3 terms adds at most ~48
// ulp(1) ~ 6e-6 at C = 128.  So the kernel keeps the plain f32 product's
// contract: |dscore| <= 1e-5, equal indices beyond a 1e-5 top-2 gap.  One
// TF32 (or bf16) pass would be ~1e-3 off.
//
// Bound.  The least time for f32-accurate products on this card is the
// three tensor-core passes: 3 * 2*R*M*C flops over the dense TF32 peak
// (SMs x 1024 FMA/clk x 2 x clock), 3.08 ms at the eval shape
// [524288,128] x [4096,128] at 1980 MHz (the f32 FMA pipes would need
// 8.22 ms for 2*R*M*C).  Both inputs once and idx, score once are 0.09 ms
// at 3.35 TB/s: the kernel is bound by operations.
//
// Design.
//   * split_mesh, a prepass, writes hi and lo of the mesh into a
//     [2, M, C] scratch (the wrapper's torch.empty), once per call.
//   * One CTA per BM = 128 scene rows (64 when C > 128, so the split scene
//     still fits), 2 consumer warpgroups of 64 rows (1 when C > 128) and
//     one producer warp.  The producer TMA-loads the CTA's scene rows once
//     (128-byte swizzle, [BM x 32] boxes, rows past R zero-filled); each
//     consumer warpgroup splits its rows in shared memory (hi in place,
//     lo beside), and wgmma reads A from there.  The split sits in shared
//     memory, not registers, by measurement: A taken from registers, split
//     from the raw tile per k chunk (which frees room for 5 stages), was
//     slower, and right only with every wgmma group retired before the
//     next chunk's fragments were loaded (ptxas does not keep a register
//     A operand alive across wgmma.wait_group 1); holding all of A in
//     registers takes C of them a thread, 256 at C = 256.
//   * The producer then streams the mesh in stages of [128 rows x 32
//     floats] of hi and of lo (32 KB) through a ring of 3 stages with
//     full/empty mbarriers.  CTAs run in clusters of two: CTA 0 loads the
//     hi half of each stage and CTA 1 the lo half, each multicast to both,
//     so a pair of CTAs (256 scene rows) reads the 4 MB split mesh from L2
//     once: 8.4 GB at the eval shape, as much as the SIMT kernel's 2 MB
//     per 128 rows (8.6 GB).  A stage's empty barrier counts the consumer
//     warpgroups of both CTAs, since each producer writes into both.
//   * Each consumer warpgroup runs m64n128k8 wgmma (both operands K-major,
//     as scene [R, C] and mesh [M, C] already are) into 64 f32
//     accumulators a thread, one commit group per stage, and releases a
//     stage as soon as the group after it has been issued and it retired.
//   * Fused argmax: after each 128-column mesh tile every thread folds its
//     accumulators into a running (best, idx) for its two rows, columns
//     in ascending order with a strict '>'; columns >= M are masked to
//     -inf by index (TMA zero-fills them, and a zero would beat a row
//     whose every true score is negative).  At the end the four threads
//     of a row merge by (score desc, idx asc), so exact ties go to the
//     lowest index and an all-zero row gives index 0, score 0.  Each
//     warpgroup owns its rows: no merge across warpgroups.  Rows past R
//     are never written.
//   scripts/profile_similarity.py times each of these choices against a
//   variant of this source that undoes it (PERF.md, section 6).

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;                      // mesh rows per tile
constexpr int BK = 32;                       // floats per k chunk
constexpr int ROW_BYTES = BK * 4;            // one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int CLUSTER = 2;
constexpr int HALF_BYTES = BN * ROW_BYTES;   // hi (or lo) of a stage
constexpr int STAGE_BYTES = 2 * HALF_BYTES;
constexpr int WG_THREADS = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ float4 split_hi(float4 x, float4& lo) {
  float4 h;
  h.x = rna_tf32(x.x);
  h.y = rna_tf32(x.y);
  h.z = rna_tf32(x.z);
  h.w = rna_tf32(x.w);
  lo.x = rna_tf32(x.x - h.x);
  lo.y = rna_tf32(x.y - h.y);
  lo.z = rna_tf32(x.z - h.z);
  lo.w = rna_tf32(x.w - h.w);
  return h;
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` to complete.  A pipeline fault
// traps after ~10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 == 0) t0 = now;
    else if (now - t0 > 20000000000LL) __trap();
  }
}

// Arrive on the barrier at offset `bar` in CTA `cta` of this cluster.
// Release at CTA scope is enough: what the arrival publishes is that the
// consumer's wgmma reads of a stage have retired, and no data flows from
// consumer to producer.  Cluster scope made the whole kernel 1.4-1.5x
// slower: the arriving thread holds up its warpgroup's next wgmma.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 remote;\n"
      " mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      :: "r"(bar), "r"(cta) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// ---- TMA ----------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1) : "memory");
}

// Load a box into the same offset of every CTA in `mask`, completing
// bytes on each one's barrier at offset `bar`.
__device__ __forceinline__ void tma_load_3d_multicast(
    uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
    int c2, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "h"(mask) : "memory");
}

// ---- wgmma --------------------------------------------------------------

// Shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle that TMA wrote: rows of 128 bytes, 8-row atoms 1024 bytes apart
// (SBO), the tile 1024-byte aligned; a k step of 8 floats advances the
// start address by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators across a
// wgmma wait or fence.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A[64 x 8] . B[128 x 8]^T, both tf32 in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ bool wins(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// Fold one 128-column tile of accumulators into the running (best, arg)
// of this thread's two rows.  Thread (warp w, lane l) holds, for n8 block
// j, columns 8j + 2(l%4) + {0, 1} of row 16w + l/4 (d[4j], d[4j+1]) and
// of row 16w + l/4 + 8 (d[4j+2], d[4j+3]): ascending order, strict '>'.
template <bool RAGGED>
__device__ __forceinline__ void fold(const float (&d)[64], int col0, int M,
                                     float& best0, int& arg0, float& best1,
                                     int& arg1) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + e;
      float v0 = d[4 * j + e], v1 = d[4 * j + 2 + e];
      if (RAGGED && col >= M) v0 = v1 = -CUDART_INF_F;
      if (v0 > best0) { best0 = v0; arg0 = col; }
      if (v1 > best1) { best1 = v1; arg1 = col; }
    }
  }
}

// ---- kernels ------------------------------------------------------------

__global__ void split_mesh(const float4* __restrict__ mesh,
                           float4* __restrict__ hi, float4* __restrict__ lo,
                           int n4) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += gridDim.x * blockDim.x) {
    float4 l;
    hi[i] = split_hi(mesh[i], l);
    lo[i] = l;
  }
}

// WGS consumer warpgroups of 64 scene rows each, then one producer warp.
template <int WGS>
__global__ void __cluster_dims__(CLUSTER, 1, 1)
__launch_bounds__(WGS * WG_THREADS + 32, 1)
argmax_kernel(const __grid_constant__ CUtensorMap scene_map,
              const __grid_constant__ CUtensorMap mesh_map, int R, int M,
              int KC, long long* __restrict__ idx_out,
              float* __restrict__ score_out) {
  constexpr int BM = 64 * WGS;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment for the 128-byte swizzle atoms
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int part = KC * BM * ROW_BYTES;       // scene hi (or lo), [KC][BM][32]
  uint8_t* scene_hi = base;
  uint8_t* scene_lo = base + part;
  uint8_t* ring = base + 2 * part;            // STAGES x [hi | lo]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = smem_u32(bars + STAGES);
  const uint32_t scene_bar = smem_u32(bars + 2 * STAGES);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  uint32_t rank;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, WGS * CLUSTER);
    }
    mbar_init(scene_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // both CTAs' barriers exist before any multicast or remote arrive
  cluster_sync();

  const int n_tiles = (M + BN - 1) / BN;
  const int row0 = blockIdx.x * BM;

  if (warp == WGS * 4) {
    // ---- producer ----
    if (lane == 0) {
      mbar_expect_tx(scene_bar, part);
      for (int kc = 0; kc < KC; ++kc)
        tma_load_2d(smem_u32(scene_hi + kc * BM * ROW_BYTES), &scene_map,
                    scene_bar, kc * BK, row0);
      int s = 0;
      uint32_t ph = 0;
      for (int t = 0; t < n_tiles; ++t) {
        for (int kc = 0; kc < KC; ++kc) {
          mbar_wait(empty0 + 8 * s, ph ^ 1);
          mbar_expect_tx(full0 + 8 * s, STAGE_BYTES);
          // this CTA's half (rank 0: hi, rank 1: lo) into both CTAs
          tma_load_3d_multicast(
              smem_u32(ring + s * STAGE_BYTES + rank * HALF_BYTES),
              &mesh_map, full0 + 8 * s, kc * BK, t * BN, (int)rank,
              (uint16_t)((1 << CLUSTER) - 1));
          if (++s == STAGES) { s = 0; ph ^= 1; }
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumer warpgroup wg: scene rows row0 + 64 wg + [0, 64) ----
    const int wg = warp / 4;
    const int wt = tid % WG_THREADS;
    const int wg_off = wg * 64 * ROW_BYTES;
    mbar_wait(scene_bar, 0);
    for (int kc = 0; kc < KC; ++kc) {
      float4* hi = reinterpret_cast<float4*>(scene_hi + kc * BM * ROW_BYTES
                                             + wg_off);
      float4* lo = reinterpret_cast<float4*>(scene_lo + kc * BM * ROW_BYTES
                                             + wg_off);
#pragma unroll
      for (int e = wt; e < 64 * ROW_BYTES / 16; e += WG_THREADS) {
        float4 l;
        hi[e] = split_hi(hi[e], l);
        lo[e] = l;
      }
    }
    // the split was written by this warpgroup's threads; wgmma reads it
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, %1;" :: "r"(1 + wg), "n"(WG_THREADS)
                 : "memory");

    const uint32_t a_hi0 = smem_u32(scene_hi) + wg_off;
    const uint32_t a_lo0 = smem_u32(scene_lo) + wg_off;
    const uint32_t ring0 = smem_u32(ring);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float best0 = -CUDART_INF_F, best1 = -CUDART_INF_F;
    int arg0 = 0, arg1 = 0;
    int s = 0;
    uint32_t ph = 0;
    for (int t = 0; t < n_tiles; ++t) {
      int prev = -1;
      for (int kc = 0; kc < KC; ++kc) {
        mbar_wait(full0 + 8 * s, ph);
        const uint32_t a_hi = a_hi0 + kc * BM * ROW_BYTES;
        const uint32_t a_lo = a_lo0 + kc * BM * ROW_BYTES;
        const uint32_t b_hi = ring0 + s * STAGE_BYTES;
        const uint32_t b_lo = b_hi + HALF_BYTES;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) {
          const uint32_t o = ks * 32;
          wgmma_tf32(acc, desc_sw128(a_lo + o), desc_sw128(b_hi + o),
                     kc | ks);
          wgmma_tf32(acc, desc_sw128(a_hi + o), desc_sw128(b_lo + o), 1);
          wgmma_tf32(acc, desc_sw128(a_hi + o), desc_sw128(b_hi + o), 1);
        }
        wgmma_commit();
        fence_acc(acc);
        if (prev >= 0) {
          wgmma_wait<1>();
          if (wt == 0)
            for (int c = 0; c < CLUSTER; ++c)
              mbar_arrive_cluster(empty0 + 8 * prev, c);
        }
        prev = s;
        if (++s == STAGES) { s = 0; ph ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (wt == 0)
        for (int c = 0; c < CLUSTER; ++c)
          mbar_arrive_cluster(empty0 + 8 * prev, c);
      const int col0 = t * BN + 2 * (lane % 4);
      if ((t + 1) * BN <= M)
        fold<false>(acc, col0, M, best0, arg0, best1, arg1);
      else
        fold<true>(acc, col0, M, best0, arg0, best1, arg1);
    }

    // merge the four threads of each row
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ob0 = __shfl_xor_sync(0xffffffffu, best0, off);
      const int oa0 = __shfl_xor_sync(0xffffffffu, arg0, off);
      const float ob1 = __shfl_xor_sync(0xffffffffu, best1, off);
      const int oa1 = __shfl_xor_sync(0xffffffffu, arg1, off);
      if (wins(ob0, oa0, best0, arg0)) { best0 = ob0; arg0 = oa0; }
      if (wins(ob1, oa1, best1, arg1)) { best1 = ob1; arg1 = oa1; }
    }
    if ((lane & 3) == 0) {
      const int r = row0 + wg * 64 + (warp % 4) * 16 + lane / 4;
      if (r < R) {
        idx_out[r] = arg0;
        score_out[r] = best0;
      }
      if (r + 8 < R) {
        idx_out[r + 8] = arg1;
        score_out[r + 8] = best1;
      }
    }
  }
  // no CTA leaves while its pair may still arrive on its barriers
  cluster_sync();
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

template <int WGS>
int launch(const CUtensorMap& scene_map, const CUtensorMap& mesh_map, int R,
           int M, int KC, long long* idx, float* score, cudaStream_t stream) {
  constexpr int BM = 64 * WGS;
  const size_t smem = 1024 + 2 * (size_t)KC * BM * ROW_BYTES
                      + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      argmax_kernel<WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int ctas = (R + BM - 1) / BM;
  ctas = (ctas + CLUSTER - 1) / CLUSTER * CLUSTER;
  argmax_kernel<WGS><<<ctas, WGS * WG_THREADS + 32, smem, stream>>>(
      scene_map, mesh_map, R, M, KC, idx, score);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  scene [R, C], mesh [M, C]
// row-major f32, C % 4 == 0, C <= 256, 16-byte aligned; idx [R] int64,
// score [R] f32; scratch [2, M, C] f32 (the mesh's hi and lo).  Launches
// on `stream` without synchronising; returns cudaGetLastError(), or -1
// when the driver's cuTensorMapEncodeTiled is missing and -2 when it
// refuses a tensor map.
extern "C" int gdm_cosine_argmax(const float* scene, const float* mesh,
                                 int R, int M, int C, long long* idx,
                                 float* score, float* scratch,
                                 void* stream) {
  if (R <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int n4 = M * C / 4;
  const int blocks = (n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024;
  split_mesh<<<blocks, 256, 0, st>>>(
      reinterpret_cast<const float4*>(mesh),
      reinterpret_cast<float4*>(scratch),
      reinterpret_cast<float4*>(scratch + (size_t)M * C), n4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const EncodeTiled encode = encode_tiled();
  if (!encode) return -1;
  const int wgs = C <= 128 ? 2 : 1;
  const int KC = (C + BK - 1) / BK;
  CUtensorMap scene_map, mesh_map;
  const cuuint64_t s_dim[2] = {(cuuint64_t)C, (cuuint64_t)R};
  const cuuint64_t s_stride[1] = {(cuuint64_t)C * 4};
  const cuuint32_t s_box[2] = {BK, (cuuint32_t)(64 * wgs)};
  const cuuint32_t one[3] = {1, 1, 1};
  CUresult cr = encode(&scene_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                       const_cast<float*>(scene), s_dim, s_stride, s_box,
                       one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (cr != CUDA_SUCCESS) return -2;
  const cuuint64_t m_dim[3] = {(cuuint64_t)C, (cuuint64_t)M, 2};
  const cuuint64_t m_stride[2] = {(cuuint64_t)C * 4,
                                  (cuuint64_t)M * C * 4};
  const cuuint32_t m_box[3] = {BK, BN, 1};
  cr = encode(&mesh_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, scratch, m_dim,
              m_stride, m_box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (cr != CUDA_SUCCESS) return -2;
  return wgs == 2 ? launch<2>(scene_map, mesh_map, R, M, KC, idx, score, st)
                  : launch<1>(scene_map, mesh_map, R, M, KC, idx, score, st);
}
