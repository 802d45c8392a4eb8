"""Schema-versioned metrics export: JSONL rows + Prometheus text format
(the port's copy of scalecube_cluster_tpu/obs/export.py).

Every row the port's bench emits goes through :func:`make_row`, which
stamps a ``schema`` version and a ``kind`` tag and merges run metadata
(commit, n, S, seed, platform). The schema version, the reserved keys, the
metadata keys and their order are the JAX package's, so rows of the two
packages sit in one JSONL file; serialization is deterministic
(``sort_keys=True``). :func:`run_metadata` reads torch where the original
reads jax, under the same passive rule: it never imports torch and never
initialises CUDA on its own account. The jax and jaxlib version fields have
no counterpart here and stay ``"unknown"``, as the original writes them
when jax is absent.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SCHEMA_VERSION = 1

#: The repo's committed tpulint census golden (anchored from this module's
#: path, so export works from any CWD; read as a file, nothing imported).
_CENSUS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "artifacts",
    "jax_census.json",
)
_CENSUS_STAMP_CACHE: dict | None = None

#: Committed collective census golden (tpulint tier 3) — same anchoring.
_COLLECTIVE_CENSUS_PATH = os.path.join(
    os.path.dirname(_CENSUS_PATH), "collective_census.json"
)
_COLLECTIVE_STAMP_CACHE: dict | None = None


def _census_stamp() -> dict:
    """``{"lint_schema", "census_digest"}`` from the committed census golden.

    Ties every exported measurement row to the exact executable surface
    tpulint tier 2 verified (artifacts/jax_census.json): a bench row whose
    digest differs from HEAD's census was measured on drifted code. Empty
    when the golden is absent (fresh checkout before the first
    ``--census-update``) — rows simply omit the stamp.
    """
    global _CENSUS_STAMP_CACHE
    if _CENSUS_STAMP_CACHE is None:
        try:
            with open(_CENSUS_PATH) as fh:
                data = json.load(fh)
            _CENSUS_STAMP_CACHE = {
                "lint_schema": int(data["census_schema"]),
                "census_digest": str(data["digest"])[:12],
            }
        except Exception:
            _CENSUS_STAMP_CACHE = {}
    return dict(_CENSUS_STAMP_CACHE)


def _collective_stamp() -> dict:
    """``{"collective_digest"}`` from the committed collective census.

    The tier-3 twin of :func:`_census_stamp`: ties every exported row to
    the mesh exchange surface tpulint verified
    (artifacts/collective_census.json — per-entry collectives, axes,
    payload bytes/tick). Empty when the golden is absent.
    """
    global _COLLECTIVE_STAMP_CACHE
    if _COLLECTIVE_STAMP_CACHE is None:
        try:
            with open(_COLLECTIVE_CENSUS_PATH) as fh:
                data = json.load(fh)
            _COLLECTIVE_STAMP_CACHE = {
                "collective_digest": str(data["digest"])[:12],
            }
        except Exception:
            _COLLECTIVE_STAMP_CACHE = {}
    return dict(_COLLECTIVE_STAMP_CACHE)

# Row keys reserved by the exporter itself; payloads may not override them.
_RESERVED = ("schema", "kind")


def run_metadata(
    n: int | None = None,
    slot_budget: int | None = None,
    seed: int | None = None,
    platform: str | None = None,
    commit: str | None = None,
) -> dict:
    """Identifying metadata stamped onto every exported row.

    ``platform`` (``gpu`` or ``cpu``) is only auto-detected when torch is
    *already imported*, and ``device_kind`` (``torch.cuda.get_device_name``)
    is read only once CUDA is initialised, so a process that never touched
    the card stays off it. ``lint_schema``, ``census_digest`` and
    ``collective_digest`` are stamped from the repo's committed census
    goldens when present (see :func:`_census_stamp`).
    """
    if commit is None:
        try:
            commit = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                capture_output=True,
                text=True,
                timeout=10,
            ).stdout.strip() or "unknown"
        except Exception:
            commit = "unknown"
    torch_mod = sys.modules.get("torch")
    device_kind = "unknown"
    if platform is None:
        if torch_mod is not None:
            try:
                platform = "gpu" if torch_mod.cuda.is_available() else "cpu"
            except Exception:
                platform = "unknown"
        else:
            platform = "unknown"
    if torch_mod is not None:
        try:
            if torch_mod.cuda.is_initialized():
                device_kind = torch_mod.cuda.get_device_name()
        except Exception:
            device_kind = "unknown"
    meta: dict = {
        "commit": commit,
        "platform": platform,
        "jax_version": "unknown",
        "jaxlib_version": "unknown",
        "device_kind": device_kind,
        **_census_stamp(),
        **_collective_stamp(),
    }
    if n is not None:
        meta["n"] = int(n)
    if slot_budget is not None:
        meta["slot_budget"] = int(slot_budget)
    if seed is not None:
        meta["seed"] = int(seed)
    return meta


def make_row(kind: str, payload: dict, meta: dict | None = None) -> dict:
    """One export row: ``{"schema": 1, "kind": kind, **meta, **payload}``.

    Payload keys win over metadata keys (a scenario that measured its own
    ``n`` keeps it), but neither may shadow the reserved schema keys.
    """
    for k in _RESERVED:
        if k in payload or (meta and k in meta):
            raise ValueError(f"payload/meta may not set reserved key {k!r}")
    row: dict = {"schema": SCHEMA_VERSION, "kind": kind}
    if meta:
        row.update(meta)
    row.update(payload)
    return row


def jsonl_line(row: dict) -> str:
    """Deterministic single-line serialization (golden-file stable)."""
    return json.dumps(row, sort_keys=True, separators=(", ", ": "))


def append_jsonl(path: str, rows: list[dict]) -> None:
    with open(path, "a") as fh:
        for row in rows:
            fh.write(jsonl_line(row) + "\n")


def _prom_escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _metric_name(prefix: str, kind: str, field: str) -> str:
    name = f"{prefix}_{kind}_{field}"
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    if out and out[0].isdigit():
        out.insert(0, "_")
    return "".join(out)


def prometheus_text(rows: list[dict], prefix: str = "scalecube") -> str:
    """Render rows in the Prometheus text exposition format.

    String-valued fields become labels; numeric scalars become gauge samples
    named ``<prefix>_<kind>_<field>``. Non-scalar fields (lists, dicts) are
    JSONL-only and skipped here. Output is sorted for determinism.
    """
    lines: list[str] = []
    seen_help: set[str] = set()
    for row in rows:
        kind = str(row.get("kind", "row"))
        labels = {
            k: str(v)
            for k, v in row.items()
            if isinstance(v, str) and k != "kind"
        }
        label_str = ",".join(
            f'{k}="{_prom_escape(v)}"' for k, v in sorted(labels.items())
        )
        for field, value in sorted(row.items()):
            if field in _RESERVED or isinstance(value, (str, bool)):
                continue
            if not isinstance(value, (int, float)) or value != value:  # skip NaN
                continue
            name = _metric_name(prefix, kind, field)
            if name not in seen_help:
                lines.append(f"# TYPE {name} gauge")
                seen_help.add(name)
            sample = f"{name}{{{label_str}}}" if label_str else name
            lines.append(f"{sample} {value}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path: str, rows: list[dict], prefix: str = "scalecube") -> None:
    with open(path, "w") as fh:
        fh.write(prometheus_text(rows, prefix=prefix))
