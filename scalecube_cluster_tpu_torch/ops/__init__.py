"""Tensor ops and kernels of the sim engines (port of
scalecube_cluster_tpu/ops/): the merge lattice, peer selection, structured
fan-out delivery, and the hand-written kernels (the sparse core, the dense
tick core, the persistent k-tick sparse core, the fused delivery + merge)."""
