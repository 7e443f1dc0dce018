"""One training step of the port's DGCNN variant in bf16
(``model.compute_dtype`` bfloat16; the gathers' backward keeps the
cotangent's dtype, as the JAX CLI's DGCNN does) against the JAX
package's, exact graphs, on the tiny problem of _torch_harness at the
full widths, by tests/test_torch_bf16_train.py's rule.
"""

import numpy as np
import pytest
import torch

import _torch_harness as H
import test_torch_dgcnn as TD
import test_torch_train as TT
from test_torch_bf16_train import VALUES, _case, _jax_steps, \
    check_gradients, check_loss_value
from gdm_tpu_torch import weights
from gdm_tpu_torch.models.geomatch_dgcnn import GeoMatchDGCNN

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dgcnn():
    import jax
    import jax.numpy as jnp
    from _pytest.monkeypatch import MonkeyPatch

    from gdm_tpu.data.synthetic import make_batch
    from gdm_tpu.models.geomatch_dgcnn import GeoMatchDGCNN as GeoMatchJ

    mp = MonkeyPatch()
    TD._no_dropout(mp)
    try:
        data, _ = make_batch(H.mesh_fps(), H.B, H.intrinsics(), im_size=H.IM,
                             n_sample=H.N_SAMPLE, seed=0)
        inputs = {k: np.asarray(data[k]) for k in TD.KEYS}
        for k in ("labels", "origin_labels", "match_idx"):
            inputs[k] = inputs[k].astype(np.int32)
        cld = inputs["cld_rgb_nrm"].copy()
        cld[..., :3] += 1e-4 * np.random.RandomState(1).randn(
            *cld[..., :3].shape)
        cld[..., :3] -= cld[..., :3].reshape(-1, 3).mean(0)
        inputs["cld_rgb_nrm"] = cld
        mesh_x = TD._mesh_x()
        ij = {k: jnp.asarray(v) for k, v in inputs.items()}
        init = GeoMatchJ()
        key = jax.random.PRNGKey(0)
        variables = jax.jit(lambda r, i, m: init.init(
            {"params": r, "dropout": r}, i, m, train=True))(
                key, ij, jnp.asarray(mesh_x))
        jax_out = _jax_steps(GeoMatchJ, {}, variables, ij,
                             jnp.asarray(mesh_x))
    finally:
        mp.undo()
    sd = TT._named(variables["params"], variables["batch_stats"])

    def make():
        m = TT._without_dropout(GeoMatchDGCNN(
            awl=True, compute_dtype=torch.bfloat16))
        weights.load_reference_state_dict(m, sd)
        return m

    return _case(make, H.to_torch(inputs), torch.from_numpy(mesh_x),
                 jax_out)


@pytest.mark.parametrize("key", VALUES)
def test_loss_values_within_jax_bf16_gap(dgcnn, key):
    check_loss_value(dgcnn, key)


def test_every_gradient_within_jax_bf16_gap(dgcnn):
    check_gradients(dgcnn)
