"""PLY mesh IO and the fps mesh loaders (host side).

A copy of gdm_tpu/data/ply.py (its package imports jax).  Normal
estimation without faces takes the port's exact numpy KNN
(models/spline_mesh.knn_np) in place of the JAX package's native KD-tree,
and the winding check is a copy of gdm_tpu/eval/vsd._winding_orientation.

Reference: utils/ply.py (load_ply/read_ply/write_ply) and the
fps-keypoint mesh loader at datasets/lm/linemod_pbr.py:89-97.  Re-written
from the PLY spec: supports ascii and binary_little_endian.  The matching
pipeline consumes vertices; faces feed the VSD depth renderer (not ported
yet) and the normal estimate.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(path: str) -> dict:
    """Parse a PLY file into {'pts', 'colors'?, 'normals'?, 'faces'?}.

    pts are returned as float64 [n, 3] in the file's units (BOP models are
    millimetres); colors as uint8 [n, 3]; normals float [n, 3].
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) | list-prop])
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append((name, int(count), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(
                        ("list", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append((parts[2], parts[1]))
            elif line == "end_header":
                break
            elif line == "":
                raise ValueError(f"{path}: truncated header")
        out = {}
        for name, count, props in elements:
            if fmt == "ascii":
                data = _read_ascii_element(f, count, props)
            else:
                endian = "<" if "little" in fmt else ">"
                data = _read_binary_element(f, count, props, endian)
            out[name] = data

    vert = out.get("vertex", {})
    res = {}
    if all(k in vert for k in "xyz"):
        res["pts"] = np.stack([vert["x"], vert["y"], vert["z"]],
                              axis=1).astype(np.float64)
    if all(k in vert for k in ("red", "green", "blue")):
        res["colors"] = np.stack(
            [vert["red"], vert["green"], vert["blue"]], axis=1)
    if all(k in vert for k in ("nx", "ny", "nz")):
        res["normals"] = np.stack([vert["nx"], vert["ny"], vert["nz"]],
                                  axis=1).astype(np.float64)
    if "face" in out and "_lists" in out["face"]:
        res["faces"] = out["face"]["_lists"]
    return res


def _read_ascii_element(f, count, props):
    cols = {p[0]: [] for p in props if p[0] != "list"}
    lists = []
    for _ in range(count):
        vals = f.readline().split()
        if props and props[0][0] == "list":
            n = int(vals[0])
            lists.append([int(v) for v in vals[1:1 + n]])
        else:
            for (pname, _), v in zip(props, vals):
                cols[pname].append(float(v))
    out = {k: np.asarray(v) for k, v in cols.items()}
    if lists:
        out["_lists"] = lists
    return out


def _read_binary_element(f, count, props, endian):
    if props and props[0][0] == "list":
        cnt_dt = np.dtype(endian + _PLY_DTYPES[props[0][1]])
        val_dt = np.dtype(endian + _PLY_DTYPES[props[0][2]])
        lists = []
        for _ in range(count):
            n = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
            lists.append(np.frombuffer(
                f.read(val_dt.itemsize * n), val_dt).tolist())
        return {"_lists": lists}
    dt = np.dtype([(p[0], endian + _PLY_DTYPES[p[1]]) for p in props])
    arr = np.frombuffer(f.read(dt.itemsize * count), dt)
    return {p[0]: arr[p[0]] for p in props}


def write_ply(path: str, pts: np.ndarray, colors: np.ndarray | None = None,
              normals: np.ndarray | None = None,
              faces: np.ndarray | None = None) -> None:
    """Minimal binary_little_endian writer (vertices + optional faces)."""
    n = len(pts)
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    if normals is not None:
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
    if colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [
        "property "
        + {"f4": "float", "u1": "uchar"}[d] + f" {nm}" for nm, d in props]
    if faces is not None:
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")
    rec = np.empty(n, np.dtype([(nm, "<" + d) for nm, d in props]))
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    if normals is not None:
        rec["nx"], rec["ny"], rec["nz"] = (normals[:, i] for i in range(3))
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = (
            colors[:, i].astype(np.uint8) for i in range(3))
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
        if faces is not None:
            fr = np.empty(len(faces), np.dtype(
                [("k", "u1"), ("v", "<i4", (3,))]))
            fr["k"] = 3
            fr["v"] = np.asarray(faces, np.int32)
            f.write(fr.tobytes())


def load_fps_mesh(kps_dir: str, obj_id: int, n_points: int) -> np.ndarray:
    """Load ``obj_{id:06d}_fps.npy`` -> [n_points, 9] (xyz m | rgb | nrm).

    Mirrors datasets/lm/linemod_pbr.py:89-97 (mm -> m on xyz only).
    """
    data = np.load(osp.join(kps_dir, f"obj_{obj_id:06d}_fps.npy"))
    pts = data[:n_points, :3].astype(np.float32) / 1000.0
    rgb = data[:n_points, 3:6].astype(np.float32)
    nrm = data[:n_points, 6:9].astype(np.float32)
    return np.concatenate([pts, rgb, nrm], axis=1)


# kps subdirectory names by dataset convention: the LM trees use kps/
# (config/lmo_cfg.py:127) while the reference's YCB-V loader reads
# bop_ycb_kps/ (datasets/ycbv/ycbv_pbr.py:76)
KPS_DIR_CANDIDATES = ("kps", "bop_ycb_kps")


def find_kps_mesh(data_root: str, obj_id: int,
                  n_points: int) -> np.ndarray:
    """Load the precomputed fps keypoint mesh from any known kps
    directory name under `data_root` -> [n_points, 9] (xyz m); raises
    FileNotFoundError when none exists."""
    for sub in KPS_DIR_CANDIDATES:
        try:
            return load_fps_mesh(osp.join(data_root, sub), obj_id,
                                 n_points)
        except FileNotFoundError:
            continue
    raise FileNotFoundError(
        f"no {'|'.join(KPS_DIR_CANDIDATES)}/obj_{obj_id:06d}_fps.npy "
        f"under {data_root}")


def load_or_build_fps_mesh(data_root: str, obj_id: int,
                           n_points: int) -> np.ndarray:
    """``find_kps_mesh`` with a raw-BOP fallback -> [n_points, 9] (xyz m).

    The reference REQUIRES precomputed ``kps/obj_XXXXXX_fps.npy`` files
    (datasets/lm/linemod_pbr.py:89-97, models/SplineCNN.py:180-193) and
    crashes without them.  Deliberate deviation: when the npy is absent,
    farthest-point-sample the object's BOP model PLY directly
    (``models_eval/`` preferred — same decimated mesh BOP evaluation
    uses — else ``models/``), so a plain BOP dataset tree works out of
    the box.
    """
    try:
        return find_kps_mesh(data_root, obj_id, n_points)
    except FileNotFoundError:
        pass
    for sub in ("models_eval", "models"):
        p = osp.join(data_root, sub, f"obj_{obj_id:06d}.ply")
        if osp.isfile(p):
            data = mesh_fps_from_ply(p, n_points)
            xyz_m = data[:, :3].astype(np.float32) / 1000.0
            return np.concatenate(
                [xyz_m, data[:, 3:9].astype(np.float32)], axis=1)
    raise FileNotFoundError(
        f"no fps mesh for obj {obj_id}: neither "
        f"{data_root}/kps/obj_{obj_id:06d}_fps.npy nor a model PLY in "
        f"{data_root}/models_eval|models")


def _estimate_normals(pts: np.ndarray, faces=None) -> np.ndarray:
    """Unit surface normals for a vertex cloud without stored normals.

    With faces: area-weighted average of incident face normals (exact
    for meshes).  Without: local PCA plane fit over the 16-NN
    neighbourhood, oriented away from the centroid.  Either way the
    result is unit length — the 9-d fps contract carries true normals.
    """
    pts = np.asarray(pts, np.float64)
    nrm = None
    if faces is not None and len(faces):
        # face averaging is only sound when the winding is consistent
        # (hull/fan soups have random per-face orientation)
        orient = _winding_orientation(pts, faces)
        if orient is not None:
            f = np.asarray(faces, np.int64)
            fn = orient * np.cross(pts[f[:, 1]] - pts[f[:, 0]],
                                   pts[f[:, 2]] - pts[f[:, 0]])
            nrm = np.zeros_like(pts)                 # |fn| = 2*area
            for c in range(3):
                np.add.at(nrm, f[:, c], fn)
    if nrm is None:
        from gdm_tpu_torch.models.spline_mesh import knn_np

        neigh = knn_np(pts, min(16, len(pts)))
        nb = pts[neigh]                              # [n, k, 3]
        centred = nb - nb.mean(axis=1, keepdims=True)
        cov = np.einsum("nki,nkj->nij", centred, centred)
        _, vecs = np.linalg.eigh(cov)                # ascending eigvals
        nrm = vecs[:, :, 0]                          # smallest = normal
        out = pts - pts.mean(axis=0)                 # orient outward
        flip = np.einsum("ni,ni->n", nrm, out) < 0
        nrm[flip] *= -1
    n = np.linalg.norm(nrm, axis=1, keepdims=True)
    return (nrm / np.maximum(n, 1e-12)).astype(np.float32)


def _winding_orientation(verts: np.ndarray, faces: np.ndarray):
    """+1/-1 if `faces` are a consistently wound closed 2-manifold
    (sign = direction of the signed volume, i.e. whether the winding is
    outward), else None.

    Consistent winding on a closed manifold means every undirected edge
    appears in exactly two faces with OPPOSITE directions — checked via
    directed-edge multisets.
    """
    f = np.asarray(faces, np.int64)
    if len(f) == 0:
        return None
    nv = int(f.max()) + 1
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    fwd = e[:, 0] * nv + e[:, 1]
    if np.unique(fwd).size != fwd.size:      # duplicated directed edge
        return None
    rev = e[:, 1] * nv + e[:, 0]
    if not np.array_equal(np.sort(fwd), np.sort(rev)):
        return None                          # boundary / non-manifold
    v = np.asarray(verts, np.float64)
    vol6 = np.einsum("ij,ij->i", v[f[:, 0]],
                     np.cross(v[f[:, 1]], v[f[:, 2]])).sum()
    if abs(vol6) < 1e-18:
        return None
    return 1.0 if vol6 > 0 else -1.0


def mesh_fps_from_ply(ply_path: str, n_points: int,
                      seed: int = 0) -> np.ndarray:
    """Build the [n, 9] fps-style array straight from a BOP model PLY when
    no precomputed ``*_fps.npy`` exists: farthest-point-sample the vertices
    (deterministic given seed).  Units: BOP PLYs are mm; output xyz in mm
    to match the .npy layout (callers divide by 1000 like load_fps_mesh).
    """
    d = load_ply(ply_path)
    pts = d["pts"].astype(np.float32)
    colors = d.get("colors")
    normals = d.get("normals")
    if colors is None:
        colors = np.full_like(pts, 127.0)
    if normals is None:
        normals = _estimate_normals(pts, d.get("faces"))
    n = len(pts)
    if n <= n_points:
        idx = np.pad(np.arange(n), (0, n_points - n), "wrap")
    else:
        rng = np.random.RandomState(seed)
        idx = np.zeros(n_points, np.int64)
        idx[0] = rng.randint(n)
        d2 = np.sum((pts - pts[idx[0]]) ** 2, axis=1)
        for i in range(1, n_points):
            idx[i] = int(np.argmax(d2))
            d2 = np.minimum(
                d2, np.sum((pts - pts[idx[i]]) ** 2, axis=1))
    return np.concatenate(
        [pts[idx], colors[idx].astype(np.float32), normals[idx]],
        axis=1).astype(np.float32)
