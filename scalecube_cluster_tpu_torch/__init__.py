"""scalecube_cluster_tpu_torch — the PyTorch/CUDA port of scalecube_cluster_tpu.

The JAX package (``scalecube_cluster_tpu``) is the reference; this package
mirrors its layout file for file and imports nothing from it. Each module's
header names the reference file it ports. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; on a CPU tensor every kernel
wrapper runs its plain PyTorch version.

Ported so far: the sparse SWIM engine's bench path (``sim/sparse.py``) with
its hand-written CUDA sparse-core kernel (``ops/sparse_core.py`` +
``csrc/sparse_core.cu``); the dense engine (``sim/tick.py``) with its tick
core (``ops/tick_core.py``); the persistent k-tick sparse core
(``ops/sparse_persistent.py``, driven by ``bench.py --engine persistent``);
the fused delivery + merge (``ops/delivery_merge.py``, driven by
``tools/profile_tick.py``); the card probes (``tools/probe_kernels.py``); fault timelines, geo
worlds and knobs; elastic membership and geometry promotion; the causal
flight recorder (``obs/tracer.py``, decoded by ``obs/trace.py`` and
certified by ``tools/trace_explain.py``) and the other observability
copies (``obs/``); ``sim/monitor.py``; checkpoints that cross packages
(``sim/checkpoint.py``); and ensembles of B universes stepped as one batch
(``sim/ensemble.py``, the fused cores taking the universe as a grid axis),
with their population report (``obs/ensemble.py``) and the SWIM
certifiers (``testlib/invariants.py``).
"""
