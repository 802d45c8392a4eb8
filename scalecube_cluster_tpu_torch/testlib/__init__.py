"""Test support of the port (twin of scalecube_cluster_tpu/testlib/): the
SWIM invariant certifiers (``invariants``)."""
