"""The similarity kernel of csrc/similarity.cu on the card, against
variants of its own source that each undo one design choice:

- ``arrive_cluster``: consumers release a stage with a release at
  cluster scope instead of the default CTA scope;
- ``no_multicast``: clusters of one, each CTA loading both halves (hi
  and lo) of every mesh stage for itself (twice the L2 reads);
- ``no_fold``: the argmax fold left out (timing only; its output is
  wrong by construction);
- ``register_a``: A (the scene rows) from registers instead of shared
  memory, split from the raw TMA-loaded tile at every k chunk, which
  frees shared memory for 5 stages; ``register_a_wait0`` retires each
  wgmma group before the next chunk's fragments are loaded.

Each variant is built with nvcc from the checkout's source (text
substitutions that fail loudly if the source changed), checked against
the plain version on a ragged case and at the serving shape (max
|dscore| and the share of equal indices), then timed (median of CUDA-event
timed calls) at the three main-path shapes in four rounds, alternating
forward and reversed order, beside the restated bound (3*2*R*M*C over
the dense TF32 peak).  Needs a CUDA card; run from the repo root (~1
min):

    python3 scripts/profile_similarity.py
"""

import ctypes
import json
import os
import os.path as osp
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (blocks jax, flax and gdm_tpu)
from gdm_tpu_torch import _build  # noqa: E402
from gdm_tpu_torch.ops import similarity as sim  # noqa: E402

VARIANT_DIR = osp.join(_build.BUILD_DIR, "variants")


def sub(src, old, new):
    if old not in src:
        raise SystemExit(f"profile_similarity: source changed, no match "
                         f"for:\n{old}")
    return src.replace(old, new)


FOLD = """      if ((t + 1) * BN <= M)
        fold<false>(acc, col0, M, best0, arg0, best1, arg1);
      else
        fold<true>(acc, col0, M, best0, arg0, best1, arg1);"""

MULTICAST = """          // this CTA's half (rank 0: hi, rank 1: lo) into both CTAs
          tma_load_3d_multicast(
              smem_u32(ring + s * STAGE_BYTES + rank * HALF_BYTES),
              &mesh_map, full0 + 8 * s, kc * BK, t * BN, (int)rank,
              (uint16_t)((1 << CLUSTER) - 1));"""

BOTH_HALVES = """          for (int h = 0; h < 2; ++h)
            asm volatile(
                "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier"
                "::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];"
                :: "r"(smem_u32(ring + s * STAGE_BYTES + h * HALF_BYTES)),
                   "l"(reinterpret_cast<uint64_t>(&mesh_map)),
                   "r"(full0 + 8 * s), "r"(kc * BK), "r"(t * BN), "r"(h)
                : "memory");"""

WGMMA_RS = """
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\\n .reg .pred p;\\n setp.ne.b32 p, %69, 0;\\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      OUTS "}, {%64, %65, %66, %67}, %68, p, 1, 1;\\n}\\n"
      : ACC
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ bool wins("""

REGISTER_A_LOOP = """        const uint8_t* a_kc = a_base + kc * BM * ROW_BYTES;
        uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // a0..a3: (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)
            const int chunk = (2 * ks + i / 2) ^ g;
            const float x = *reinterpret_cast<const float*>(
                a_kc + chunk * 16 + (i % 2) * 8 * ROW_BYTES);
            const float h = rna_tf32(x);
            ah[ks][i] = __float_as_uint(h);
            al[ks][i] = __float_as_uint(rna_tf32(x - h));
          }
        }
        const uint32_t b_hi = ring0 + s * STAGE_BYTES;
        const uint32_t b_lo = b_hi + HALF_BYTES;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 8; ++ks) {
          const uint32_t o = ks * 32;
          wgmma_tf32_rs(acc, al[ks], desc_sw128(b_hi + o), kc | ks);
          wgmma_tf32_rs(acc, ah[ks], desc_sw128(b_lo + o), 1);
          wgmma_tf32_rs(acc, ah[ks], desc_sw128(b_hi + o), 1);
        }
"""


def register_a(src):
    outs = ", ".join(f"%{i}" for i in range(64))
    acc = ", ".join(f'"+f"(d[{i}])' for i in range(64))
    src = sub(src, "constexpr int STAGES = 3;", "constexpr int STAGES = 5;")
    src = sub(src, "\n__device__ __forceinline__ bool wins(",
              WGMMA_RS.replace("OUTS", f'"{outs}"').replace("ACC", acc))
    src = sub(src, """  uint8_t* scene_hi = base;
  uint8_t* scene_lo = base + part;
  uint8_t* ring = base + 2 * part;""", """  uint8_t* scene_hi = base;
  uint8_t* ring = base + part;""")
    i = src.index("    mbar_wait(scene_bar, 0);\n    for (int kc = 0;")
    j = src.index("    const uint32_t ring0 = smem_u32(ring);")
    src = src[:i] + """    mbar_wait(scene_bar, 0);
    const int g = lane / 4, q = lane % 4;
    const uint8_t* a_base = scene_hi + wg_off + (warp % 4) * 16 * ROW_BYTES
                            + g * ROW_BYTES + q * 4;
""" + src[j:]
    i = src.index("        const uint32_t a_hi = a_hi0 + kc * BM * ROW_BYTES;")
    j = src.index("        wgmma_commit();")
    src = src[:i] + REGISTER_A_LOOP + src[j:]
    return sub(src, "const size_t smem = 1024 + 2 * (size_t)KC * BM",
               "const size_t smem = 1024 + (size_t)KC * BM")


VARIANTS = {
    "arrive_cluster": lambda s: sub(
        s, "mbarrier.arrive.shared::cluster.b64",
        "mbarrier.arrive.release.cluster.shared::cluster.b64"),
    "no_multicast": lambda s: sub(sub(
        s, "constexpr int CLUSTER = 2;", "constexpr int CLUSTER = 1;"),
        MULTICAST, BOTH_HALVES),
    "no_fold": lambda s: sub(
        s, FOLD, "      if (acc[0] == 12345.f && acc[63] == 1.f) "
                 "{ best0 = acc[1]; arg0 = col0; }"),
    "register_a": register_a,
    "register_a_wait0": lambda s: sub(
        register_a(s), "        wgmma_commit();\n",
        "        wgmma_commit();\n        wgmma_wait<0>();\n"),
}
WRONG_BY_DESIGN = {"no_fold"}


def build(name, src):
    cu = osp.join(VARIANT_DIR, f"{name}.cu")
    so = osp.join(VARIANT_DIR, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(VARIANTS[name](src))
    p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                       capture_output=True, text=True)
    if p.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{p.stdout}{p.stderr}")
    return name, so, p.stdout + p.stderr


def runner(so):
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gdm_cosine_argmax.argtypes = [p, p, i, i, i, p, p, p, p]

    def run(s, m):
        r, c = s.shape
        n = m.shape[0]
        idx = torch.empty(r, dtype=torch.int64, device="cuda")
        score = torch.empty(r, dtype=torch.float32, device="cuda")
        scratch = torch.empty(2 * n * c, device="cuda")
        rc = lib.gdm_cosine_argmax(
            s.data_ptr(), m.data_ptr(), r, n, c, idx.data_ptr(),
            score.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
        return idx, score
    return run


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "C75" in ln]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_similarity: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["similarity"])
    for ln in ptxas_lines(_build.build_logs.get("similarity", "")):
        print(f"  built ptxas: {ln}", flush=True)
    os.makedirs(VARIANT_DIR, exist_ok=True)
    with open(osp.join(_build.CSRC_DIR, "similarity.cu")) as f:
        src = f.read()
    runs = {"built": sim.cosine_argmax}
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        for name, so, log in pool.map(lambda n: build(n, src), VARIANTS):
            for ln in ptxas_lines(log):
                print(f"  {name} ptxas: {ln}", flush=True)
            runs[name] = runner(so)

    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    result = {"card": smi, "agreement": {}, "ms": {}}
    for tag, (r, m, c) in (("ragged", (1100, 700, 128)),
                           ("serving", cs.SERVE_SHAPE)):
        s, mf = cs.unit_rows(r, c, g), cs.unit_rows(m, c, g)
        idx_r, score_r = sim.cosine_argmax_reference(s, mf)
        for name, fn in runs.items():
            idx, score = fn(s, mf)
            torch.cuda.synchronize()
            err = float((score - score_r).abs().max())
            same = float((idx == idx_r).float().mean())
            note = " (wrong by design)" if name in WRONG_BY_DESIGN else ""
            print(f"  {tag} [{r},{c}]x[{m},{c}] {name}: max|dscore| "
                  f"{err:.3g}, equal indices {same:.5f}{note}", flush=True)
            result["agreement"][f"{tag}/{name}"] = [err, same]
    peak = cs.peak_flops(1024, "dense TF32")
    for tag, shape, reps in (("serving", cs.SERVE_SHAPE, 20),
                             ("eval", cs.EVAL_SHAPE, 10),
                             ("train_val", cs.TRAIN_VAL_SHAPE, 20)):
        r, m, c = shape
        s, mf = cs.unit_rows(r, c, g), cs.unit_rows(m, c, g)
        bound = 3 * 2.0 * r * m * c / peak * 1e3
        times = {name: [] for name in runs}
        for order in (list(runs), list(runs)[::-1]) * 2:
            for name in order:
                times[name].append(cs.median_ms(runs[name], s, mf,
                                                reps=reps))
        for name, t in times.items():
            print(f"  {tag} {list(shape)} {name}: "
                  + "; ".join(f"{x:.4f}" for x in t)
                  + f" ms (median {np.median(t):.4f}, "
                  f"{100 * bound / np.median(t):.1f}% of the bound "
                  f"{bound:.4f} ms)", flush=True)
        result["ms"][tag] = times
        del s, mf
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
