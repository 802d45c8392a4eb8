"""LinkWorld — a zone-level geo topology over the fault model
(port of scalecube_cluster_tpu/sim/topology.py).

Members live in zones and link behaviour is a property of the zone pair:

- ``zone[i]``          — zone id of member i, ``[N]`` int32;
- ``latency[za, zb]``  — extra one-way delay in ms on za→zb links;
- ``loss[za, zb]``     — extra drop probability on za→zb links;
- ``block[za, zb]``    — hard one-way block of every za→zb link;
- ``bw_class[za, zb]`` — advisory bandwidth class (:data:`BW_LAN`,
  :data:`BW_METRO`, :data:`BW_WAN`); the ticks never read it.

A plan's edge lookups compose with the world (sim/faults.py): blocked = plan
OR zone block, loss = ``1 - (1-p)(1-q)``, delay = plan delay + zone latency.
Inside a :class:`~scalecube_cluster_tpu_torch.sim.schedule.FaultSchedule`
the matrices carry a leading segment axis ``[K, Z, Z]`` and ``zone`` stays
``[N]``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from scalecube_cluster_tpu_torch.cluster_api.member import MemberStatus
from scalecube_cluster_tpu_torch.ops.merge import DEAD_BIT, decode_epoch, decode_status

_ALIVE = int(MemberStatus.ALIVE)

#: Advisory bandwidth classes for ``bw_class`` and the class presets.
BW_LAN = 0
BW_METRO = 1
BW_WAN = 2

#: Preset one-way latency (ms) per bandwidth class.
CLASS_LATENCY_MS = {BW_LAN: 0.0, BW_METRO: 5.0, BW_WAN: 60.0}
#: Preset extra loss per class (zero: the presets model slow, not lossy).
CLASS_LOSS = {BW_LAN: 0.0, BW_METRO: 0.0, BW_WAN: 0.0}

#: Viewer rows per block when the per-zone gauges are counted from the
#: sparse engine's working set (bounds the [rows, N] intermediates).
ZONE_ROW_BLOCK = 2048


@dataclass
class LinkWorld:
    """Zone assignment + zone×zone link matrices (see the module docstring)."""

    zone: torch.Tensor  # [N] int32 zone id per member
    latency: torch.Tensor  # [Z, Z] float32 extra one-way delay ms
    loss: torch.Tensor  # [Z, Z] float32 extra drop probability in [0, 1)
    block: torch.Tensor  # [Z, Z] bool one-way zone-level block
    bw_class: torch.Tensor  # [Z, Z] int32 advisory class (ticks never read)

    def replace(self, **changes) -> "LinkWorld":
        return dataclasses.replace(self, **changes)

    @property
    def n_zones(self) -> int:
        return self.latency.shape[-1]

    @classmethod
    def flat(cls, n: int, n_zones: int = 1, device="cuda") -> "LinkWorld":
        """A do-nothing world: everyone in zone 0, clean matrices."""
        return cls.from_zones(np.zeros(n, np.int32), n_zones=n_zones, device=device)

    @classmethod
    def from_zones(cls, zone, n_zones: int | None = None, device="cuda") -> "LinkWorld":
        """A clean world over an explicit assignment (``[N]`` ints)."""
        z_arr = np.asarray(zone, np.int32)
        z = int(n_zones) if n_zones is not None else int(z_arr.max()) + 1
        if z_arr.size and (z_arr.min() < 0 or z_arr.max() >= z):
            raise ValueError(
                f"zone ids must sit in [0, {z}); got "
                f"[{int(z_arr.min())}, {int(z_arr.max())}]"
            )
        return cls(
            zone=torch.from_numpy(z_arr.copy()).to(device),
            latency=torch.zeros((z, z), dtype=torch.float32, device=device),
            loss=torch.zeros((z, z), dtype=torch.float32, device=device),
            block=torch.zeros((z, z), dtype=torch.bool, device=device),
            bw_class=torch.full((z, z), BW_LAN, dtype=torch.int32, device=device),
        )

    @classmethod
    def even_zones(cls, n: int, n_zones: int, device="cuda") -> "LinkWorld":
        """Contiguous near-equal zones: member i in zone ``i * Z // N``."""
        zone = (np.arange(n, dtype=np.int64) * n_zones) // n
        return cls.from_zones(zone.astype(np.int32), n_zones=n_zones, device=device)

    def zone_members(self, z: int) -> np.ndarray:
        """Host-side member indices of zone ``z``."""
        return np.flatnonzero(self.zone.cpu().numpy() == z)

    # ------------------------------------------------------ host builders
    def _set_pairs(self, mat: torch.Tensor, za, zb, value, symmetric: bool):
        a = torch.as_tensor(np.atleast_1d(np.asarray(za, np.int64)), device=mat.device)
        b = torch.as_tensor(np.atleast_1d(np.asarray(zb, np.int64)), device=mat.device)
        out = mat.clone()
        out[a[:, None], b[None, :]] = value
        if symmetric:
            out[b[:, None], a[None, :]] = value
        return out

    def with_zone_latency(self, za, zb, latency_ms: float, symmetric: bool = True):
        """Set the extra one-way latency on za→zb links (both directions by
        default)."""
        return self.replace(
            latency=self._set_pairs(self.latency, za, zb, float(latency_ms), symmetric)
        )

    def with_zone_loss(self, za, zb, loss: float, symmetric: bool = True):
        """Set the extra drop probability on za→zb links."""
        return self.replace(loss=self._set_pairs(self.loss, za, zb, float(loss), symmetric))

    def block_zones(self, za, zb, symmetric: bool = False):
        """Block every za→zb link; one-way unless ``symmetric``."""
        return self.replace(block=self._set_pairs(self.block, za, zb, True, symmetric))

    def with_zone_class(self, za, zb, bw_class: int, symmetric: bool = True):
        """Label za→zb links with a bandwidth class and apply the class
        preset latency/loss (:data:`CLASS_LATENCY_MS`, :data:`CLASS_LOSS`)."""
        if bw_class not in CLASS_LATENCY_MS:
            raise ValueError(f"unknown bandwidth class {bw_class}")
        out = self.with_zone_latency(za, zb, CLASS_LATENCY_MS[bw_class], symmetric=symmetric)
        if CLASS_LOSS[bw_class] > 0:
            out = out.with_zone_loss(za, zb, CLASS_LOSS[bw_class], symmetric=symmetric)
        return out.replace(
            bw_class=out._set_pairs(out.bw_class, za, zb, int(bw_class), symmetric)
        )

    def any_faults(self) -> torch.Tensor:
        """Scalar bool: could this world disturb any edge? Latency counts."""
        return self.block.any() | (self.loss > 0).any() | (self.latency > 0).any()


def stack_segment_worlds(worlds: list, n: int) -> "LinkWorld | None":
    """Stack per-segment worlds into a schedule's ``[K, Z, Z]`` form. All
    worlds must share one zone assignment; segments without a world get
    clean slices. All None → None (a flat-world schedule)."""
    present = [w for w in worlds if w is not None]
    if not present:
        return None
    ref = present[0]
    zone = ref.zone.cpu().numpy()
    if zone.shape != (n,):
        raise ValueError(f"link_world.zone must be [{n}]; got {zone.shape}")
    z = ref.n_zones
    for w in present[1:]:
        if w.n_zones != z or not np.array_equal(w.zone.cpu().numpy(), zone):
            raise ValueError(
                "all segments of one schedule must share the same zone "
                "assignment (members don't change zones mid-run; schedule "
                "a different world's matrices per segment instead)"
            )
    flat = LinkWorld.from_zones(zone, n_zones=z, device=ref.zone.device)
    filled = [w if w is not None else flat for w in worlds]
    return LinkWorld(
        zone=flat.zone,
        latency=torch.stack([w.latency for w in filled]),
        loss=torch.stack([w.loss for w in filled]),
        block=torch.stack([w.block for w in filled]),
        bw_class=torch.stack([w.bw_class for w in filled]),
    )


def world_segment(world: "LinkWorld | None", k: int) -> "LinkWorld | None":
    """Segment ``k`` of a stacked schedule world, in per-tick ``[Z, Z]``
    form (views, no copy)."""
    if world is None:
        return None
    return LinkWorld(
        zone=world.zone,
        latency=world.latency[k],
        loss=world.loss[k],
        block=world.block[k],
        bw_class=world.bw_class[k],
    )


def zone_pair_counts(world: LinkWorld, view_rows, alive, epoch, row0: int = 0):
    """Per-viewer counts behind :func:`zone_tick_metrics` for the viewer
    rows ``row0 .. row0 + R`` of a ``[N, N]`` view (``view_rows`` is
    ``[R, N]``): ``[4, R]`` int32 — live intra-zone pairs, those whose
    record is correct-ALIVE, those holding a DEAD record at the subject's
    current epoch, and those holding a SUSPECT record. Exact integers on
    any device."""
    r, n = view_rows.shape
    dev = view_rows.device
    rows = torch.arange(row0, row0 + r, device=dev)
    cols = torch.arange(n, device=dev)
    z_of = world.zone
    alive_r = alive[row0:row0 + r]
    intra = (
        (z_of[row0:row0 + r, None] == z_of[None, :])
        & (rows[:, None] != cols[None, :])
        & alive_r[:, None]
        & alive[None, :]
    )
    epoch_ok = decode_epoch(view_rows) == epoch[None, :]
    ok_alive = epoch_ok & (decode_status(view_rows) == _ALIVE)
    rec_dead = ((view_rows & DEAD_BIT) != 0) & (view_rows >= 0) & epoch_ok
    rec_susp = ((view_rows & 1) != 0) & ((view_rows & DEAD_BIT) == 0) & (view_rows >= 0)
    return torch.stack([
        intra.sum(dim=1, dtype=torch.int32),
        (intra & ok_alive).sum(dim=1, dtype=torch.int32),
        (intra & rec_dead).sum(dim=1, dtype=torch.int32),
        (intra & rec_susp).sum(dim=1, dtype=torch.int32),
    ])


def zone_metrics_from_counts(zone: np.ndarray, n_zones: int, counts: np.ndarray) -> dict:
    """Fold ``counts [T, 4, N]`` (:func:`zone_pair_counts` over all viewers,
    T ticks) into the per-zone gauges, ``[T, Z]`` numpy arrays.

    The reference folds per-viewer counts into zones by a float32
    ``[N] @ [N, Z]`` one-hot product, which XLA:CPU sums in member order,
    one rounding per term (a zone's pair count passes 2**24 at n=10240 with
    two zones, where the order decides the value). ``np.cumsum`` over
    float32 is that same in-order sum, so the gauges here equal the
    reference's at every n (tests/test_torch_topology.py)."""
    counts = np.asarray(counts)
    t = counts.shape[0]
    sums = np.zeros((t, 4, n_zones), np.float32)
    for z in range(n_zones):
        members = np.flatnonzero(zone == z)
        if members.size:
            part = counts[:, :, members].astype(np.float32)
            sums[:, :, z] = np.cumsum(part, axis=2, dtype=np.float32)[:, :, -1]
    pairs = sums[:, 0]
    conv = np.where(
        pairs > 0, sums[:, 1] / np.maximum(pairs, np.float32(1.0)), np.float32(1.0)
    ).astype(np.float32)
    return {
        "zone_intra_conv": conv,
        "zone_false_dead": sums[:, 2].astype(np.int32),
        "zone_intra_suspects": sums[:, 3].astype(np.int32),
    }


def zone_tick_metrics(world: LinkWorld, view, alive, epoch) -> dict:
    """Per-zone graceful-degradation gauges from a ``[N, N]`` view, one
    ``[Z]`` tensor each on the view's device:

    - ``zone_intra_conv[z]`` — over ordered live intra-zone pairs, the
      fraction where the viewer's record is correct-ALIVE (1.0 when the zone
      has no live pair);
    - ``zone_false_dead[z]`` — live intra-zone pairs holding a DEAD record at
      the subject's current epoch;
    - ``zone_intra_suspects[z]`` — SUSPECT records on live intra-zone pairs.

    Reads the per-viewer counts back to the host for the in-order float32
    fold (:func:`zone_metrics_from_counts`). Consumes no RNG."""
    counts = zone_pair_counts(world, view, alive, epoch)
    out = zone_metrics_from_counts(
        world.zone.cpu().numpy(), world.n_zones, counts.cpu().numpy()[None]
    )
    return {k: torch.from_numpy(v[0]).to(view.device) for k, v in out.items()}
