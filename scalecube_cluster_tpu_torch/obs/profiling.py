"""Optional profiler named-scope annotations (the port's counterpart of
scalecube_cluster_tpu/obs/profiling.py).

``trace_scope`` wraps host-side dispatch loops (the bench's chunk dispatch)
in a ``torch.profiler.record_function`` scope, so a profiler trace
attributes wall time to protocol phases. It is a no-op when torch has not
been imported, and it never initialises CUDA on its own account.
"""

from __future__ import annotations

import sys
from contextlib import nullcontext


def trace_scope(name: str):
    """Context manager: a profiler named scope when torch is live, else a
    no-op."""
    torch_mod = sys.modules.get("torch")
    if torch_mod is None:
        return nullcontext()
    try:
        return torch_mod.profiler.record_function(name)
    except Exception:
        return nullcontext()
