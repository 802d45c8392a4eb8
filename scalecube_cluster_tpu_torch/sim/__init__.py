"""Simulation backend (port of scalecube_cluster_tpu/sim/): N SWIM nodes as
one dataclass of tensors over the member axis, stepped a gossip period at a
time. Ported so far: the sparse and dense engines, their checkpoints, and
ensembles of universes stepped as one batch."""
