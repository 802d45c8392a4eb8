"""Rolling-window SLO tracking for the serving bridge (the port's copy of
scalecube_cluster_tpu/obs/slo.py).

One :class:`RollingSLOTracker` owns BOTH views of a serving session's SLO
numbers:

- :meth:`session` — every launch since the bridge opened (what the
  ``kind="serve"`` close-time summary row reports);
- :meth:`rolling` — the last ``window`` launches (what the live telemetry
  plane publishes while the session is still running: the ``serve/metrics``
  transport qualifier and the Prometheus endpoint in serve/telemetry.py).

Both views compute percentiles through the same
obs/latency.py::percentile_summary call, so a live scrape taken after the
final launch and the close-time summary are the SAME numbers by
construction, not by parallel bookkeeping that happens to agree
(tests/test_telemetry.py pins this).
"""

from __future__ import annotations

from collections import deque

from scalecube_cluster_tpu_torch.obs.latency import percentile_summary


class RollingSLOTracker:
    """Per-launch SLO accumulator with a bounded rolling window.

    ``record`` ingests one launch (ingest→verdict latency in ms, events
    served, wall seconds of the assemble→verdicts-ready span, and the
    backpressure waits accrued during the launch). The full-session sample
    is kept exactly (the close-time summary must not be lossy); the rolling
    window is a ``deque(maxlen=window)`` so live metrics stay O(window)
    regardless of session length.
    """

    def __init__(self, window: int = 64):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self._all_lat_ms: list[float] = []
        self._win: deque[tuple[float, int, float, int]] = deque(maxlen=window)
        self._events_total = 0
        self._exec_s_total = 0.0
        self._backpressure_total = 0

    def __len__(self) -> int:
        return len(self._all_lat_ms)

    def record(
        self,
        latency_ms: float,
        n_events: int,
        exec_s: float,
        backpressure: int = 0,
    ) -> None:
        """Ingest one launch's measurements."""
        self._all_lat_ms.append(float(latency_ms))
        self._win.append((float(latency_ms), int(n_events), float(exec_s),
                          int(backpressure)))
        self._events_total += int(n_events)
        self._exec_s_total += float(exec_s)
        self._backpressure_total += int(backpressure)

    @property
    def latencies_ms(self) -> list[float]:
        """The full-session latency sample (copy-free; do not mutate)."""
        return self._all_lat_ms

    @property
    def exec_s_total(self) -> float:
        return self._exec_s_total

    def session(self) -> dict:
        """Whole-session SLO summary (the close-time ``kind="serve"`` view)."""
        lat = percentile_summary(self._all_lat_ms)
        exec_s = max(self._exec_s_total, 1e-9)
        return {
            "launches": len(self._all_lat_ms),
            "events_total": self._events_total,
            "events_per_sec": self._events_total / exec_s,
            "backpressure": self._backpressure_total,
            "latency": lat,
        }

    def rolling(self) -> dict:
        """SLO summary over the last ``window`` launches (the live view).

        ``events_per_sec`` is the window's served events over the window's
        execution seconds — a rate that tracks the CURRENT load, unlike the
        session mean which a long warmup would bias forever.
        """
        lats = [r[0] for r in self._win]
        lat = percentile_summary(lats)
        win_events = sum(r[1] for r in self._win)
        win_exec = max(sum(r[2] for r in self._win), 1e-9)
        return {
            "window": self.window,
            "launches": len(self._win),
            "events": win_events,
            "events_per_sec": win_events / win_exec,
            "backpressure": sum(r[3] for r in self._win),
            "latency": lat,
        }
