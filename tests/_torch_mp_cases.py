"""What the ranks of the port's multi-process tests run (tests/_torch_mp.py
starts them): each function is ``fn(rank, world, payload)`` and returns
numpy arrays and numbers.  Only torch and the port are imported here, so
the parent test process can call the same functions for its one-rank
references."""

from __future__ import annotations

import numpy as np
import torch

# the mini BOP tree of tests/test_data.py as --opt overrides of the LM-O
# preset: spawned ranks (cli --devices) start from a fresh import, where
# a test's preset patch does not reach
MINI_OPTS = ["--opt", "data.obj_ids=1", "--opt", "data.img_hw=120,160",
             "--opt", "data.model_pt_num=128", "--opt",
             "data.num_sample_points=256", "--opt", "data.input_size=64",
             "--opt", "model.n_mesh_node=128"]


def data_rows(grid, b: int) -> slice:
    """The batch rows of this rank's data rank: contiguous blocks, as
    JAX's P('data') lays a batch over the data axis."""
    n = b // grid.data_size
    return slice(grid.data_rank * n, (grid.data_rank + 1) * n)


def sp_functions(rank, world, payload):
    """parallel/sp.py on this rank: the argmax and, for each loss case,
    the loss and its gradients with respect to this rank's scene rows
    and the whole mesh features."""
    from gdm_tpu_torch.parallel import mesh as pmesh
    from gdm_tpu_torch.parallel.sp import sharded_cosine_argmax, \
        sharded_matching_loss

    grid = pmesh.make_grid(payload["shards"])
    scene, meshf = payload["argmax"]
    rows = data_rows(grid, scene.shape[0])
    idx, score = sharded_cosine_argmax(torch.from_numpy(scene[rows]),
                                       torch.from_numpy(meshf), grid)
    out = {"rows": (rows.start, rows.stop), "idx": idx.numpy(),
           "score": score.numpy(), "loss": {}}
    for name, c in payload["cases"].items():
        rows = data_rows(grid, c["rgbd"].shape[0])
        f = torch.tensor(c["rgbd"][rows], requires_grad=True)
        g = torch.tensor(c["meshf"], requires_grad=True)

        def t(key):
            v = c.get(key)
            return None if v is None else torch.from_numpy(v)

        loss = sharded_matching_loss(
            f, g, t("mesh_xyz"), t("labels")[rows], t("match_idx")[rows],
            t("vis")[rows], c["positive_r"], grid, sym_idx=t("sym_idx"),
            pad_onehot=c.get("pad_onehot", False),
            rt=None if c.get("rt") is None else t("rt")[rows],
            depth_scaled_r_mm=c.get("r_mm"))
        loss.backward()
        out["loss"][name] = (float(loss), f.grad.numpy(), g.grad.numpy())
    return out


def train_model(p: dict):
    """The port's training model, mesh and state of a train-step case, in
    float64 without dropout: the same start on every rank and in the
    one-rank reference."""
    from gdm_tpu_torch import configs, weights
    from gdm_tpu_torch.models.build import build_model
    from gdm_tpu_torch.models.layers import Dropout
    from gdm_tpu_torch.train.state import create_train_state

    cfg = configs.config_from_dict(p["cfg"])
    model, mesh, _, _ = build_model(cfg, p["fps_mm"], "cpu", awl=True)
    weights.init_random_(model, torch.Generator().manual_seed(p["seed"]))
    model.double()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    mesh = type(mesh)(*[t.double() if t is not None and t.is_floating_point()
                        else t for t in mesh])
    state = create_train_state(model, lambda _: 1e-3)
    return model, mesh, state


def step_inputs(inputs: dict, rows=slice(None)) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
            if np.ndim(v) else torch.tensor(v) for k, v in inputs.items()}


def run_steps(model, mesh, state, inputs: dict, n_steps: int, grid=None,
              rows=slice(None)) -> dict:
    """``n_steps`` train steps on ``inputs`` (this rank's ``rows``): the
    losses, the first step's gradients, and the parameters and buffers
    after the last."""
    from gdm_tpu_torch.train.step import make_train_step

    step = make_train_step(lambda _: 0.3, 0.0, 64, grid=grid)
    losses, grads = [], None
    for _ in range(n_steps):
        m = step(state, step_inputs(inputs, rows), mesh, 7)
        losses.append({k: float(m[k]) for k in ("loss", "seg_loss",
                                                "match_loss")})
        if grads is None:
            grads = {k: p.grad.numpy().copy()
                     for k, p in model.named_parameters()}
    return {"losses": losses, "grads": grads,
            "state": {k: v.numpy().copy()
                      for k, v in model.state_dict().items()}}


def train_steps(rank, world, payload):
    """The train step (train/step.py) on this rank's rows of one global
    batch, the model attached to the grid."""
    from gdm_tpu_torch.parallel import mesh as pmesh

    grid = pmesh.make_grid(payload["shards"])
    model, mesh, state = train_model(payload)
    pmesh.attach(model, grid)
    pmesh.broadcast_module(model, grid)
    b = payload["inputs"]["rgb"].shape[0]
    return run_steps(model, mesh, state, payload["inputs"],
                     payload["steps"], grid, data_rows(grid, b))


def cli_rank(rank, world, payload):
    """``cli.main(argv + ['--multihost'])`` on this rank ('{rank}' in an
    argument becomes the rank), with the models' dropout off when asked
    and the correspondences of every pose fit recorded."""
    import gdm_tpu_torch.eval.infer as infer_mod
    from gdm_tpu_torch import cli, weights
    from gdm_tpu_torch.models.layers import Dropout

    if payload.get("no_dropout"):
        Dropout.forward = lambda self, x: x
    fits = []
    fit_outputs = infer_mod.fit_outputs

    def recording(out, *args, **kw):
        poses, fit = fit_outputs(out, *args, **kw)
        fits.append({k: fit[k].numpy().copy() for k in ("rgbd", "mesh",
                                                        "idx")})
        return poses, fit

    infer_mod.fit_outputs = recording
    argv = [a.replace("{rank}", str(rank)) for a in payload["argv"]]
    res = cli.main(argv + ["--multihost"])
    out = {"fits": fits}
    if argv[0] == "train":
        out["timing"] = res["timing"]
        out["objects"] = {
            name: {"step": o["state"].step, "state": {
                k: v.numpy().copy() for k, v in
                weights.reference_state_dict(o["state"].model).items()}}
            for name, o in res["objects"].items()}
    return out
