"""Command-line tools of the port (twins of the JAX package's ``tools/``):
``profile_tick`` (where a dense tick's time goes on the card) and
``probe_kernels`` (the card features the port's kernels rely on)."""
