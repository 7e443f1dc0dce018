"""The VSD renderers of csrc/render_depth.cu on the card: each against its
plain version at tiles 16, 24 and 32 on square and non-square windows
(a hull object, padding faces, three renders at other origins), then on
the first chunk of chip_smoke's workload (b) (the trefoil, 32 renders,
faces ~2 px across) and of the same workload on two convex hulls (faces
~5 and ~9 px): each renderer against the plain stamp, its CUDA-event time
for the whole wrapper call, its host enqueue time and its passes' device
time by torch.profiler; and the faces' sizes per render.  Needs a CUDA
card; run from the repo root:

    python3 scripts/profile_render_depth.py
"""

import os.path as osp
import subprocess
import sys
import time

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402  (blocks jax, flax and gdm_tpu)
from gdm_tpu_torch import _build  # noqa: E402
from gdm_tpu_torch.eval.vsd import vsd_err_batch  # noqa: E402
from gdm_tpu_torch.ops import render_depth as rd  # noqa: E402


LABELS = {"render_depth_window_gather": "gather",
          "render_depth_window": "stamp"}


def hull_object(tile, side=128, seed=0):
    """A convex hull (5 cm) at 0.7 m, subdivided to the tile's bound, and
    intrinsics that centre it in a side x side window."""
    from scipy.spatial import ConvexHull

    from gdm_tpu_torch.data.synthetic import make_object

    rng = np.random.RandomState(seed)
    verts = (make_object(256, rng, radius=0.05)[:, :3] / 1000.0).astype(
        np.float32)
    faces = ConvexHull(verts).simplices.astype(np.int32)
    Kw = np.array([[500.0, 0, side / 2], [0, 500.0, side / 2], [0, 0, 1]],
                  np.float32)
    v, f = rd.subdivide_max_edge(verts, faces, (tile - 2) * 0.6 / Kw[0, 0])
    t = np.array([0.0, 0.0, 0.7], np.float32)
    return (v + t).astype(np.float32), f, Kw


def tiles_check():
    """The stamp, and on square windows the gather form (slot rows of the
    host binning, and a dense table that lists every face under every
    tile), against their plain versions; returns the number of cases
    that differ."""
    bad = 0
    for tile in (16, 24, 32):
        for window in ((tile * 4, tile * 4), (tile * 3, tile * 5),
                       (tile * 6, tile * 2)):
            vc0, f, Kw = hull_object(tile, side=min(window))
            vc = torch.from_numpy(np.stack(
                [vc0, vc0 + np.float32(0.003), vc0])).cuda()
            origin = torch.tensor([[0.0, 0.0], [5.0, -3.0],
                                   [-7.5, 11.0]]).cuda()
            K = torch.from_numpy(Kw).cuda()
            fl = torch.from_numpy(np.stack([f, f[::-1].copy(), f])).cuda()
            fl = torch.cat([fl, torch.zeros_like(fl[:, :17])], 1)
            args = (vc, fl, K, origin, window, tile)
            cases = [("render_depth_window", args, {})]
            if window[0] == window[1]:
                cand, st = cs.host_slot_table(args)
                every = fl[:, None].expand(
                    -1, (window[0] // tile) ** 2, -1, -1).contiguous()
                cases += [("render_depth_window_gather",
                           (vc, cand) + args[2:], {"slot_tile": st}),
                          ("render_depth_window_gather",
                           (vc, every) + args[2:], {})]
            res = []
            for name, a, kw in cases:
                got = getattr(rd, name)(*a, **kw)
                want = cs.render_plain(name, a, kw)
                torch.cuda.synchronize()
                same = torch.equal(got, want)
                bad += not same
                res.append(f"{LABELS[name]} "
                           f"{'equal' if same else 'DIFFER'} "
                           f"({int((want > 0).sum())} covered)")
            print(f"  tile {tile}, window {window}: " + ", ".join(res),
                  flush=True)
    return bad


def device_us(prof, calls):
    """{kernel or memset name: device µs per call} of a profiled window."""
    out = {}
    for e in prof.key_averages():
        dt = getattr(e, "device_time_total", None)
        if dt is None:
            dt = e.cuda_time_total
        if dt and ("kernel" in e.key or "Memset" in e.key
                   or "fill_inf" in e.key or "inf_to_zero" in e.key):
            key = e.key.replace("(anonymous namespace)::", "")
            key = key.replace("void ", "").split("(")[0].split("<")[0]
            out[key] = out.get(key, 0.0) + dt / calls
    return out


def hull_mesh(n_pts, seed=5):
    """A mesh of larger faces: the outward-wound convex hull of an
    n_pts-point synthetic object (~12 cm across; at 4096 points ~1000
    faces, as the eval tree's models_eval hull).  VSD subdivides faces to
    the tile's bound: at z = 0.55 m their bboxes are ~5 px (4096 points)
    to ~9 px (64 points) across, where the trefoil's are ~2."""
    from gdm_tpu_torch.data.synthetic import make_object

    pts = (make_object(n_pts, np.random.RandomState(seed))[:, :3]
           / 1000.0).astype(np.float32)
    return pts, cs.outward_hull(pts)


def first_chunk(mesh):
    """The first renderer call of vsd_err_batch on 32 frames of
    chip_smoke's hard workload with ``mesh`` (None: the trefoil), and the
    GT render's inputs."""
    poses, depths, K, verts, faces, diam, _, gt_args = \
        cs.hard_vsd_workload(mesh=mesh)
    with cs.Calls("render_depth_window") as rec:
        vsd_err_batch(poses, depths, K, verts, faces, diam,
                      group_cap=cs.VSD_GROUP, device="cuda")
    (args, _), _ = rec.first
    return args, gt_args


def time_calls(calls):
    """Each call's median CUDA-event time, host enqueue time and passes'
    device time (torch.profiler)."""
    for name, fn in calls.items():
        ms = cs.median_ms(fn, reps=20, warmup=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        passes = device_us(prof, 10)
        print(f"  {name}: median {ms:.4f} ms per call (CUDA events), host "
              f"enqueue {host:.4f} ms; device µs per call: "
              + ", ".join(f"{k} {v:.1f}" for k, v in passes.items())
              + f"; sum {sum(passes.values()):.1f}", flush=True)


def face_sizes(args, n=4):
    """Kept faces and their bbox sizes, first n renders."""
    for i in range(n):
        pix, z = rd._project(args[0][i], args[2], args[3][i])
        fl = args[1][i].long()
        ok, _ = rd._setup(pix[fl], z[fl])
        p = pix[fl][ok]
        ext = (p.max(1).values - p.min(1).values).cpu().numpy()
        print(f"  render {i}: kept faces {int(ok.sum())}; bbox w, h median "
              f"{np.median(ext, 0).round(2)}, p90 "
              f"{np.percentile(ext, 90, 0).round(2)} px")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_render_depth: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build_all(["render_depth"])
    print("renderers against their plain versions:")
    bad = tiles_check()

    for title, mesh in (("workload (b), the trefoil", None),
                        ("the hull of 4096 points", hull_mesh(4096)),
                        ("the hull of 64 points", hull_mesh(64))):
        args, gt_args = first_chunk(mesh)
        cand, st = cs.host_slot_table(args)
        calls = {
            "stamp": lambda: rd.render_depth_window(*args),
            "gather": lambda: rd.render_depth_window_gather(
                args[0], cand, *args[2:], slot_tile=st),
        }
        if mesh is None:
            calls["GT stamp (32 x 480x640, tile 16)"] = \
                lambda: rd.render_depth_window(*gt_args)
        want = cs.render_plain("render_depth_window", args, {})
        for name in ("stamp", "gather"):
            got = calls[name]()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad += 1
                print(f"  {name} DIFFERS from the plain stamp")
        print(f"{title}, first chunk ({args[0].shape[0]} renders, window "
              f"{args[4][0]}, tile {args[5]}, {args[1].shape[1]} face "
              f"slots; {int((want > 0).sum())} pixels covered):")
        time_calls(calls)
        print("faces (first 4 renders):")
        face_sizes(args)
    if bad:
        raise SystemExit(f"profile_render_depth: {bad} cases differ")


if __name__ == "__main__":
    main()
