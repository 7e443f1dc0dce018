"""Multi-process training and evaluation over ``torch.distributed``.

Counterpart of gdm_tpu/parallel.  Where the JAX package lays a device
mesh over one process's devices and lets XLA insert the collectives,
the port runs one process per card (NCCL) or per CPU rank (gloo) and
writes its few collectives out:

  * parallel/mesh.py: the ranks as a (data, model) grid, the process
    group set-up, a differentiable all-reduce, gradient averaging, the
    parameter broadcast and the host gather of the evaluator.  JAX's
    ``shard_batch`` and ``local_rows`` have no counterpart: a rank's
    loader yields only its rows (data/loader.py ``rank``/``world``),
    which go to its card as any batch does (data/pipeline.to_device);
  * parallel/sp.py: mesh-column (model-axis) sharding of the
    correspondence argmax (the CUDA similarity kernel on each rank's
    columns) and of the matching loss.
"""

from gdm_tpu_torch.parallel.mesh import (
    Grid,
    all_gather_host,
    all_reduce_sum,
    average_gradients,
    broadcast_module,
    make_grid,
)
from gdm_tpu_torch.parallel.sp import (
    sharded_cosine_argmax,
    sharded_matching_loss,
)

__all__ = ["Grid", "all_gather_host", "all_reduce_sum", "average_gradients",
           "broadcast_module", "make_grid", "sharded_cosine_argmax",
           "sharded_matching_loss"]
