"""Protocol counter registry shared by the host backend and the sim engines
(the port's copy of scalecube_cluster_tpu/obs/counters.py; the names and
their order are the schema both packages emit).

``SHARED_COUNTERS`` is the schema: every name here is emitted by the sparse
engine's in-scan metrics dict (sim/sparse.py, ``collect=True``), by the dense
engine where the event exists there, and by the asyncio host backend via
:class:`ProtocolCounters`. testlib/crossval.py cross-validates the two
backends on this key set, so adding a counter means adding it to *both*
backends (or documenting the asymmetry in ``SIM_ONLY_COUNTERS``).
"""

from __future__ import annotations

# Counters every backend reports. Semantics (host backend <-> sim engines):
#   pings              direct PING issued (FailureDetectorImpl PING round)
#   ping_reqs          indirect PING_REQ relays issued
#   acks               ack responses received by the prober
#   suspicions_raised  member table cells transitioning into SUSPECT
#   verdicts_dead      cells transitioning into DEAD (suspicion expiry)
#   verdicts_alive     previously-known cells transitioning back to ALIVE
#                      (incarnation refutation / recovery)
#   gossip_infections  first sighting of a gossip rumor at a node
#   msgs_fd            FD wire messages sent (pings + relayed ping-reqs)
#   msgs_sync          SYNC / SYNC_ACK messages sent
#   msgs_gossip        gossip protocol messages sent
#   fault_blocked      membership-plane messages dropped by a BLOCKED link
#                      (FaultPlan.block / NetworkEmulator blockOutbound)
#   fault_lost         membership-plane messages dropped by probabilistic
#                      link loss (FaultPlan.loss / emulator loss_percent)
#   view_changes       members committing/adopting a new membership
#                      configuration (Rapid engine, sim/rapid.py; SWIM has
#                      no consistent views — its engines emit constant 0)
#   alarms_raised      observer edges newly crossing the L-watermark into
#                      the alarming state (Rapid; 0 for SWIM)
#   cut_detected       members whose cut detector turned stable and locked
#                      a vote this tick (Rapid; 0 for SWIM)
#   exchange_overflow  cross-shard payloads dropped because a fixed-capacity
#                      per-destination bucket was full this tick (explicit
#                      shard_map engine, parallel/spmd.py; the single-program
#                      engines have no buckets and emit constant 0)
#   ingest_overflow    live/replayed events the serving bridge could not fit
#                      into their target tick's fixed event capacity and
#                      DEFERRED to a later tick — never dropped (serve/,
#                      the host-outran-the-budget signal; offline engines
#                      have no ingest path and emit constant 0)
#   ingest_rejected    malformed serve-event payloads a live session refused
#                      (unknown kind, out-of-range node/slot, non-object
#                      data) — wire accounting stamped by the bridge from
#                      TcpEventSource.rejected; per-tick engine metrics emit
#                      constant 0 (no ingest path offline)
#   ingest_backpressure  full->pause->resume flow-control cycles a live
#                      session's pump took against producers under the
#                      lossless ``defer`` overflow policy (serve/ingest.py);
#                      host accounting like serve_batches — engines emit
#                      constant 0
#   serve_batches      event batches the serving bridge completed (stamped
#                      into serve session rows from host accounting;
#                      per-tick engine metrics emit constant 0 — a batch is
#                      a launch, not a tick event)
#   fallback_rounds    classic-Paxos fallback prepare rounds opened by a
#                      rotating coordinator this tick (Rapid with
#                      fallback=True, sim/rapid.py; every other engine —
#                      and Rapid with fallback=False — emits constant 0)
#   fallback_commits   members committing a view change through the classic
#                      fallback's decide broadcast rather than the fast-path
#                      quorum (Rapid fallback only; constant 0 elsewhere)
#   join_requests      join-handshake request messages sent by joiners to
#                      their current seed (Rapid fallback only; constant 0
#                      elsewhere)
#   join_confirms      join-confirm messages newly latched at a seed — the
#                      certificate that gates the joiner's stable_add cut
#                      (Rapid fallback only; constant 0 elsewhere)
#   joins_admitted     capacity rows activated by a join this tick (elastic
#                      membership, the 4-tuple events path of
#                      sim/sparse.py::sparse_tick; fixed-shape engines have
#                      no capacity rows and emit constant 0)
#   joins_deferred     joins parked for the next geometry promotion because
#                      every capacity row is taken — a GAUGE (currently
#                      parked, serve/ingest.py::EventBatcher.deferred_joins)
#                      stamped by the elastic bridge over the engines'
#                      constant-0 slot; deferred is never dropped (the
#                      admission conservation ledger, join_ledger())
#   promotions         geometry promotions the serving session has taken
#                      (ServeBridge.promote, the n_alloc doubling ladder);
#                      host accounting like serve_batches — engines emit
#                      constant 0
#   n_live             members whose identity has ever been live — a GAUGE
#                      (sum of the elastic live_mask; the per-tick elastic
#                      metrics emit it so growth is visible per tick, and
#                      the bridge stamps the session-end value over the
#                      meaningless tick-sum; fixed-shape engines emit
#                      constant 0, NOT n — the slot reads "elastic
#                      occupancy", absent when the cluster cannot grow)
#   tenants_active     tenants currently holding a universe slot in a fleet
#                      session — a GAUGE stamped by serve/fleet.py::
#                      FleetBridge over the engines' constant-0 slot (tick
#                      metrics have no tenancy axis; every engine emits 0)
#   tenants_deferred   tenants parked awaiting fleet capacity — a GAUGE
#                      (deferred is never dropped; the fleet admission
#                      ledger requested == placed + pending + deferred +
#                      evicted, serve/fleet.py); engines emit constant 0
#   tenant_evictions   tenants explicitly evicted from a fleet session
#                      (operator action, counted in the admission ledger);
#                      host accounting — engines emit constant 0
#   fleet_launches     ensemble launches a fleet session completed (one
#                      vmapped executable stepping every tenant universe;
#                      the fleet twin of serve_batches) — host accounting,
#                      engines emit constant 0
SHARED_COUNTERS: tuple[str, ...] = (
    "pings",
    "ping_reqs",
    "acks",
    "suspicions_raised",
    "verdicts_dead",
    "verdicts_alive",
    "gossip_infections",
    "msgs_fd",
    "msgs_sync",
    "msgs_gossip",
    "fault_blocked",
    "fault_lost",
    "view_changes",
    "alarms_raised",
    "cut_detected",
    "exchange_overflow",
    "ingest_overflow",
    "ingest_rejected",
    "ingest_backpressure",
    "serve_batches",
    "fallback_rounds",
    "fallback_commits",
    "join_requests",
    "join_confirms",
    "joins_admitted",
    "joins_deferred",
    "promotions",
    "n_live",
    "tenants_active",
    "tenants_deferred",
    "tenant_evictions",
    "fleet_launches",
)

# Emitted by the sparse engine only — they measure the compact working-set
# machinery, which has no host-backend analog (a dict has no slots).
# ``link_attempts`` / ``link_delivered`` complete the sim engines' per-tick
# conservation split (attempts == delivered + fault_blocked + fault_lost,
# checked by testlib/invariants.py); the host backend counts only the drop
# sides, so the attempt totals stay sim-only.
SIM_ONLY_COUNTERS: tuple[str, ...] = (
    "slot_activations",
    "slot_frees",
    "slot_overflow",
    "sync_window_accepts",
    "link_attempts",
    "link_delivered",
)


class ProtocolCounters:
    """Mutable counter block for one host-backend node.

    One instance is created per host-backend ``Cluster``
    and shared by its failure detector, gossip and membership protocols plus
    the transport wrapper — the moral equivalent of the reference's per-node
    MBean. Plain ints on the asyncio loop; no locking needed.
    """

    __slots__ = ("_counts", "_sent_by_qualifier")

    def __init__(self) -> None:
        self._counts: dict[str, int] = {k: 0 for k in SHARED_COUNTERS}
        self._sent_by_qualifier: dict[str, int] = {}

    def inc(self, name: str, delta: int = 1) -> None:
        if name not in self._counts:
            # Strict: a typo'd name would silently widen the snapshot key
            # set and break the crossval schema check (testlib/crossval.py).
            raise KeyError(f"unknown counter {name!r}; add it to SHARED_COUNTERS")
        self._counts[name] += delta

    def sent(self, qualifier: str) -> None:
        """Record one outbound transport message by qualifier."""
        self._sent_by_qualifier[qualifier] = self._sent_by_qualifier.get(qualifier, 0) + 1

    def snapshot(self) -> dict[str, int]:
        """Copy of the shared counters (stable key set)."""
        return dict(self._counts)

    def sent_by_qualifier(self) -> dict[str, int]:
        return dict(self._sent_by_qualifier)


def sum_counters(snapshots: list[dict[str, int]]) -> dict[str, int]:
    """Aggregate per-node snapshots into cluster totals."""
    total: dict[str, int] = {k: 0 for k in SHARED_COUNTERS}
    for snap in snapshots:
        for k, v in snap.items():
            total[k] = total.get(k, 0) + v
    return total


def diff_counters(after: dict[str, int], before: dict[str, int]) -> dict[str, int]:
    """Per-key ``after - before`` (keys from ``after``)."""
    return {k: v - before.get(k, 0) for k, v in after.items()}
