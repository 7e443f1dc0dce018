"""Weight bridge: the port's parameter names are the reference torch
names that gdm_tpu.train.import_torch.export_state_dict emits, and a
flax GeoMatch's variables load into the port strictly and unchanged."""

import numpy as np
import pytest
import torch

import _torch_harness as H
from gdm_tpu.train.import_torch import _ALIASES, export_state_dict
from gdm_tpu_torch import weights
from gdm_tpu_torch.models.geomatch import GeoMatch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def exported():
    import jax.numpy as jnp

    from gdm_tpu.data.pipeline import assemble_inputs
    from gdm_tpu.data.synthetic import make_batch
    from gdm_tpu.models.geomatch import MeshArrays
    from gdm_tpu.models.spline_mesh import build_mesh_graph

    fps = H.mesh_fps()
    mesh = MeshArrays.from_graph(build_mesh_graph(fps, H.N_MESH))
    data, _ = make_batch(fps, H.B, H.intrinsics(), im_size=H.IM,
                         n_sample=H.N_SAMPLE, seed=0)
    inputs = assemble_inputs(
        jnp.asarray(data["rgb"]), jnp.asarray(data["cld_rgb_nrm"]),
        jnp.asarray(data["choose"]), jnp.asarray(data["xyz_img"]),
        knn_chunk=H.KNN_CHUNK, approx=False)
    _, variables = H.jax_model_and_variables(inputs, mesh)
    return export_state_dict(variables["params"], variables["batch_stats"])


def test_state_dict_keys_equal_export_minus_aliases(exported):
    # both alias tables also list the DGCNN variant's duplicates; compare
    # the flagship's (tests/test_torch_dgcnn.py compares DGCNN's)
    aliases = {a: b for a, b in _ALIASES.items() if a in exported}
    own = set(GeoMatch().state_dict())
    ref = set(exported) - set(aliases.values())
    assert sorted(own - ref) == [] and sorted(ref - own) == []
    assert {d: n for d, n in weights.ALIASES.items() if n in own} \
        == {b: a for a, b in aliases.items()}


def test_strict_load_keeps_every_value(exported):
    m = GeoMatch()
    weights.load_reference_state_dict(m, exported)
    sd = m.state_dict()
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(exported[k]),
                                      err_msg=k)
    n_bn = sum(k.endswith("num_batches_tracked") for k in sd)
    assert n_bn == sum(k.endswith("num_batches_tracked") for k in exported)
    assert n_bn > 90


def test_alias_name_alone_loads(exported):
    """A dict carrying cnn.final only under its second slot name."""
    sd = {k: v for k, v in exported.items() if k not in _ALIASES}
    m = GeoMatch()
    weights.load_reference_state_dict(m, sd)
    key = "pcd_emb.cnn_up_stages.2.0.0.weight"
    np.testing.assert_array_equal(m.state_dict()[key].numpy(),
                                  exported[key])


def test_reference_conv_ranks_and_module_prefix_load(exported):
    """Torch checkpoints store point convs as [out, in, 1] or
    [out, in, 1, 1]: those load.  A DataParallel 'module.' prefix is not
    stripped: it is an unexpected key, and the strict load raises."""
    for unit in ((1,), (1, 1)):
        sd = {}
        for k, v in exported.items():
            v = np.asarray(v)
            if k.endswith("conv.weight") and v.ndim == 2:
                v = v.reshape(v.shape + unit)
            sd[k] = v
        m = GeoMatch()
        weights.load_reference_state_dict(m, sd)
        key = "seg_layer.0.conv.weight"
        np.testing.assert_array_equal(m.state_dict()[key].numpy(),
                                      exported[key])
    with pytest.raises(RuntimeError, match="module.seg_layer"):
        weights.load_reference_state_dict(
            GeoMatch(), {"module." + k: v for k, v in exported.items()})


@pytest.mark.parametrize("case", ["missing", "unexpected", "shape",
                                  "transposed", "conv_reordered"])
def test_strict_load_raises(exported, case):
    """Every mismatch raises; a weight with the right element count in
    another layout (a transposed point conv, a [k, k, in, out] conv) is a
    shape mismatch, never reshaped into place."""
    sd = dict(exported)
    if case == "missing":
        del sd["seg_layer.3.conv.bias"]
    elif case == "unexpected":
        sd["seg_layer.9.conv.weight"] = np.zeros((2, 2), np.float32)
    elif case == "shape":
        sd["seg_layer.3.conv.bias"] = np.zeros((3,), np.float32)
    elif case == "transposed":
        key = next(k for k, v in sd.items() if k.endswith("conv.weight")
                   and np.asarray(v).ndim == 2
                   and np.asarray(v).shape[0] != np.asarray(v).shape[1])
        sd[key] = np.asarray(sd[key]).T
    else:
        key = next(k for k, v in sd.items() if np.asarray(v).ndim == 4
                   and np.asarray(v).shape[0] != np.asarray(v).shape[-1])
        sd[key] = np.asarray(sd[key]).transpose(2, 3, 1, 0)
    with pytest.raises(RuntimeError):
        weights.load_reference_state_dict(GeoMatch(), sd)


def test_seeded_init_is_reproducible_and_finite():
    a, b = GeoMatch(), GeoMatch()
    weights.init_random_(a, torch.Generator().manual_seed(3))
    weights.init_random_(b, torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
        assert torch.isfinite(va.float()).all(), k
