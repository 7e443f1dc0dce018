"""Mixed-object inference of the port (eval/multimodel.MultiObjectEngine)
at the harness widths: three objects, each with its own flax init carried
over by export_state_dict, one skewed mixed batch (objects [0, 0, 0, 0,
1, 2]) and groups of 2.  Both schedules are held against the port's
per-object engines on the same rows, and against the JAX package's
by-class stacked path on the same inputs, without refinement and with
ICP under per-object gates.

The features of each object are centred as in tests/test_torch_cli.py
(_spread_matches) so that matches spread over the mesh and the fits are
well posed; the seg head is biased so that about half of the points are
foreground.  Correspondences are compared beyond near-ties (top-2 gap
<= 1e-5), poses on frames whose weighted correspondences all agree."""

import numpy as np
import pytest
import torch

import _torch_harness as H
from gdm_tpu_torch.eval.multimodel import MultiObjectEngine, row_groups
from gdm_tpu_torch.serve import PoseEngine
from test_torch_cli import _spread_matches
from test_torch_serve import _split_seg_bias, _tiny_config

torch.set_num_threads(1)
OBJ_POS = np.array([0, 0, 0, 0, 1, 2], np.int32)
GATES = (0.01, 0.02, 0.005)      # per-object ICP gates, metres
GROUP = 2
POSE_TOL = 1e-5
GAP = 1e-5          # near-tie: top-2 cosine gap
FEAT_TOL = 1e-4     # |port - JAX| of a normalised feature row


@pytest.fixture(scope="module")
def objects():
    """Per object: its fps mesh, reference state dict and the JAX
    model/variables/mesh; the raw batch and its JAX inputs."""
    import jax
    import jax.numpy as jnp

    from gdm_tpu.data.pipeline import assemble_inputs, finalize_batch
    from gdm_tpu.models import GeoMatch
    from gdm_tpu.models.geomatch import MeshArrays
    from gdm_tpu.models.spline_mesh import build_mesh_graph
    from gdm_tpu.train.import_torch import export_state_dict

    raw = H.raw_request(seed=3, b=len(OBJ_POS))
    fin = finalize_batch({k: jnp.asarray(v) for k, v in raw.items()})
    inputs = assemble_inputs(fin["rgb"], fin["cld_rgb_nrm"], fin["choose"],
                             fin["xyz_img"], approx=False)
    model = GeoMatch(positive_r=0.01)
    init = jax.jit(lambda r, i, m: model.init(r, i, m, train=False))
    objs = []
    for c in range(3):
        fps = H.mesh_fps(seed=c)
        mesh = MeshArrays.from_graph(build_mesh_graph(fps, H.N_MESH))
        # the whole batch for every object: one shape, one compile of
        # each op
        variables = init(jax.random.PRNGKey(c), inputs, mesh)
        variables = _spread_matches(model, variables, inputs, mesh)
        feats = model.apply(variables, mesh, train=False,
                            method="encode_mesh")
        seg = model.apply(variables, inputs, mesh, train=False,
                          mesh_features=feats)["seg"]
        variables = {"params": _split_seg_bias(variables["params"],
                                               np.asarray(seg)),
                     "batch_stats": variables["batch_stats"]}
        objs.append({"fps": fps, "mesh": mesh, "model": model,
                     "variables": variables,
                     "sd": export_state_dict(variables["params"],
                                             variables["batch_stats"])})
    return {"raw": raw, "fin": fin, "inputs": inputs, "objs": objs}


def _port_engines(objects, refine):
    return [PoseEngine(_tiny_config(), o["fps"], o["sd"], "cpu",
                       batch=len(OBJ_POS), knn_chunk=H.KNN_CHUNK,
                       refine=refine, icp_reject=g)
            for o, g in zip(objects["objs"], GATES)]


@pytest.fixture(scope="module")
def port_runs(objects):
    """{refine: {'per_object': (poses, w, idx, rgbd, mesh feats per row),
    'by_class' / 'vmap': the same from the stacked engine}}."""
    raw = objects["raw"]
    out = {}
    for refine in (None, "icp"):
        engines = _port_engines(objects, refine)
        n = len(OBJ_POS)
        per = {k: [None] * n for k in ("pose", "w", "idx", "rgbd", "mesh")}
        for c, e in enumerate(engines):
            rows = np.nonzero(OBJ_POS == c)[0]
            poses = e.run({k: v[rows] for k, v in raw.items()})
            for j, i in enumerate(rows):
                per["pose"][i] = poses[j]
                for k in ("w", "idx", "rgbd"):
                    per[k][i] = e.last_fit[k][j].numpy()
                per["mesh"][i] = e.last_fit["mesh"].numpy()
        res = {"per_object": {k: np.stack(v) for k, v in per.items()}}
        for schedule in ("by_class", "vmap"):
            st = MultiObjectEngine(engines, schedule, GROUP)
            assert st.meta["icp_reject_m"] == list(GATES)
            assert st.meta["raw_spec"]["obj_pos"] == [[len(OBJ_POS)], "int32"]
            poses = st.run(dict(raw, obj_pos=OBJ_POS))
            fit = {k: v.numpy() for k, v in st.last_fit.items()
                   if k != "obj_pos"}
            res[schedule] = dict(fit, pose=poses, mesh=np.stack(
                [engines[c].mesh_feats.numpy() for c in OBJ_POS]))
        out[refine] = res
    return out


@pytest.fixture(scope="module")
def jax_runs(objects):
    """JAX's make_multi_model_infer_by_class (group 2) on the same
    inputs, per refine mode, and its per-object fit's weights and
    correspondences."""
    import jax
    import jax.numpy as jnp

    from gdm_tpu.eval.multimodel import (
        encode_stacked_mesh_feats,
        make_multi_model_infer_by_class,
        stack_trees,
    )
    from gdm_tpu.eval.pose_fit import fit_pose_single
    from gdm_tpu.models.geomatch import MeshArrays

    objs, inputs, fin = objects["objs"], objects["inputs"], objects["fin"]
    model = objs[0]["model"]
    all_vars = [o["variables"] for o in objs]
    meshes = [o["mesh"] for o in objs]
    stacked_vars = stack_trees(all_vars)
    stacked_mesh = MeshArrays(
        *[jnp.stack([jnp.asarray(getattr(m, f)) for m in meshes])
          for f in ("xyz", "node_x", "neigh_idx", "basis", "slot")],
        sym_idx=None)
    feats = encode_stacked_mesh_feats(model, all_vars, meshes)
    cld = fin["cld_rgb_nrm"][..., :3]
    det = fin["det"].astype(jnp.float32)
    out = {}
    for refine in (None, "icp"):
        infer = make_multi_model_infer_by_class(model, group=GROUP,
                                                refine=refine)
        out[refine] = np.asarray(infer(
            stacked_vars, stacked_mesh, inputs, cld, jnp.asarray(OBJ_POS),
            det, jnp.asarray(np.asarray(GATES, np.float32)),
            mesh_feats=feats))
    w = np.zeros(OBJ_POS.shape + (H.N_SAMPLE,), np.float32)
    idx = np.zeros(OBJ_POS.shape + (H.N_SAMPLE,), np.int64)
    rgbd = np.zeros(OBJ_POS.shape + (H.N_SAMPLE, 128), np.float32)
    for c, o in enumerate(objs):
        # every row through object c's model (rows are independent; one
        # shape for all objects), then object c's rows kept
        rows = np.nonzero(OBJ_POS == c)[0]
        res = o["model"].apply(o["variables"], inputs, o["mesh"],
                               train=False, mesh_features=feats[c])
        _, w_c, idx_c = jax.vmap(lambda a, s, r, d: fit_pose_single(
            a, s, res["mesh"], r, o["mesh"].xyz, d))(
                cld, res["seg"], res["rgbd"], det)
        w[rows], idx[rows] = np.asarray(w_c)[rows], np.asarray(idx_c)[rows]
        rgbd[rows] = np.asarray(res["rgbd"])[rows]
    return {"poses": out, "w": w, "idx": idx, "rgbd": rgbd}


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _compare(got, w_ref, idx_ref, poses_ref, rgbd_ref):
    """Weights equal; correspondences equal on the points whose
    normalised feature both runs computed within FEAT_TOL and whose
    top-2 gap exceeds GAP (a point whose feature differs more has a KNN
    near-tie in its neighbourhood: the pyramid's f32 distances round
    differently); poses within POSE_TOL on frames whose weighted
    correspondences all agree.  Returns the number of frames compared."""
    np.testing.assert_array_equal(got["w"], w_ref)
    f, f_ref = _unit(got["rgbd"]), _unit(rgbd_ref)
    same_f = np.abs(f - f_ref).max(-1) <= FEAT_TOL
    assert same_f.mean() > 0.9, same_f.mean()
    gap = np.stack([H.top2_gap(f_ref[i], _unit(m))
                    for i, m in enumerate(got["mesh"])])
    sure = same_f & (gap > GAP)
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got["idx"][sure], idx_ref[sure])
    same = ((got["idx"] == idx_ref) | (w_ref == 0)).all(1)
    for i in np.nonzero(same)[0]:
        np.testing.assert_allclose(got["pose"][i], poses_ref[i], rtol=0,
                                   atol=POSE_TOL, err_msg=f"frame {i}")
    return int(same.sum())


def test_row_groups():
    """by_class: stable sort by object, runs of at most `group`; vmap:
    one row each in row order."""
    oi = np.array([2, 0, 2, 2, 1, 0, 2], np.int32)
    got = [(c, r.tolist()) for c, r in row_groups(oi, "by_class", 3)]
    assert got == [(0, [1, 5]), (1, [4]), (2, [0, 2, 3]), (2, [6])]
    assert [(c, r.tolist()) for c, r in row_groups(oi, "vmap")] == \
        [(int(c), [i]) for i, c in enumerate(oi)]
    counts = np.bincount(OBJ_POS)
    assert len(row_groups(OBJ_POS, "by_class", GROUP)) == \
        int(np.sum(-(-counts // GROUP)))
    with pytest.raises(ValueError, match="schedule"):
        row_groups(oi, "scan")


@pytest.mark.parametrize("refine", [None, "icp"])
@pytest.mark.parametrize("schedule", ["by_class", "vmap"])
def test_stacked_matches_per_object(port_runs, schedule, refine):
    r = port_runs[refine]
    per, got = r["per_object"], r[schedule]
    # a forward's f32 sums depend on its batch: rows of a group of 2 and
    # of the object's 4 differ in the last places
    n = _compare(got, per["w"], per["idx"], per["pose"], per["rgbd"])
    assert n == len(OBJ_POS)


@pytest.mark.parametrize("refine", [None, "icp"])
@pytest.mark.parametrize("schedule", ["by_class", "vmap"])
def test_stacked_matches_jax_by_class(port_runs, jax_runs, schedule,
                                      refine):
    got = port_runs[refine][schedule]
    n = _compare(got, jax_runs["w"], jax_runs["idx"],
                 jax_runs["poses"][refine], jax_runs["rgbd"])
    assert n >= 4


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="schedule"):
        MultiObjectEngine([object()], schedule="scan")
