"""``python -m scalecube_cluster_tpu_torch.experiments [small|large]
[--out FILE] [--prom FILE] [--cpu]``.

Runs the BASELINE scenario grid (scenarios.py) on the card (``--cpu``: on
the CPU) and prints one JSON line per scenario; ``--out`` additionally
appends the rows to FILE as schema-versioned JSONL (obs/export.py: stamped
with commit/platform and deterministically ordered). ``--prom FILE`` also
writes the rows as a Prometheus text-format snapshot.
"""

import sys

from scalecube_cluster_tpu_torch.experiments import cli_device
from scalecube_cluster_tpu_torch.experiments.scenarios import run_all
from scalecube_cluster_tpu_torch.obs.export import (
    append_jsonl,
    make_row,
    run_metadata,
    write_prometheus,
)

USAGE = "usage: ... [small|large] [--out FILE] [--prom FILE] [--cpu]"


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in args
    if cpu:
        args.remove("--cpu")

    def path_opt(flag: str) -> str | None:
        if flag not in args:
            return None
        i = args.index(flag)
        if i + 1 >= len(args):
            sys.exit(f"{USAGE}  ({flag} needs a path)")
        path = args[i + 1]
        del args[i : i + 2]
        return path

    out = path_opt("--out")
    prom = path_opt("--prom")
    device = cli_device(cpu)
    results = run_all(args[0] if args else "small", device=device)
    if out or prom:
        meta = run_metadata(platform="cpu" if device == "cpu" else "gpu")
        rows = [make_row("experiment", r, meta) for r in results]
        if out:
            append_jsonl(out, rows)
        if prom:
            write_prometheus(prom, rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
