"""Command-line tools of the port (twins of the JAX package's ``tools/``):
``profile_tick`` (where a dense tick's time goes on the card),
``probe_kernels`` (the card features the port's kernels rely on) and
``trace_explain`` (the flight recorder's C6 walk)."""
