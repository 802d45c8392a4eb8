"""No-donation twins of the donating entry points (port of
scalecube_cluster_tpu/testlib/donation.py).

PyTorch has no buffer donation, so the aliasing race these twins sidestep
in the reference does not exist here, and each twin is the port's plain
runner itself.
"""

from __future__ import annotations

from scalecube_cluster_tpu_torch.sim.ensemble import run_ensemble_sparse_ticks
from scalecube_cluster_tpu_torch.sim.sparse import run_sparse_ticks


def nodonate(fn, *, static_argnums=(), static_argnames=()):
    """The runner ``fn`` unchanged; the static-argument keywords are taken
    for the reference's signature and ignored."""
    del static_argnums, static_argnames
    return fn


#: Non-donating twin of sim/sparse.py::run_sparse_ticks.
run_sparse_ticks_nodonate = nodonate(
    run_sparse_ticks, static_argnums=(0, 3), static_argnames=("collect",)
)

#: Non-donating twin of sim/ensemble.py::run_ensemble_sparse_ticks.
run_ensemble_sparse_ticks_nodonate = nodonate(
    run_ensemble_sparse_ticks, static_argnums=(0, 3), static_argnames=("collect",)
)
