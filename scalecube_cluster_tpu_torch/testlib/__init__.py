"""Test support of the port (twin of scalecube_cluster_tpu/testlib/): the
SWIM and Rapid invariant certifiers (``invariants``) and the seeded serving
replays (``serving``)."""
