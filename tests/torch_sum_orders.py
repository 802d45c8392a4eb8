"""Which float32 summation order reproduces the reference's Rapid
``convergence`` inside its fused tick (ROADMAP Queue C).

Runs the JAX package's ``run_rapid_ticks`` and the port's over the chaos
harness's sampled schedules, records the port's per-tick terms of the
live-viewer sum (``viewer_conv * alive``; every other leaf is equal, so the
terms are the reference's), and replays candidate orders on them in numpy
float32 against the reference's trace: in order, XLA's windows of 32, and
``L`` vector lanes × ``U`` interleaved accumulators (combined in sequence
or as a tree), a tree of lanes and an in-order tail, for every n; then the
port's rule (sim/tick.py::xla_cpu_fused_sum_f32). Prints, for each order,
the sizes at which some tick differs in the last bit. Run on the CPU from
the repository root:

    JAX_PLATFORMS=cpu python -m tests.torch_sum_orders [n ...]
"""

from __future__ import annotations

import sys

import numpy as np

SIZES = (12, 16, 20, 24, 33, 40, 48, 64)
SEEDS = (0, 3, 7)
TICKS = 100
_F32 = np.float32


def collect(sizes, seeds=SEEDS, ticks=TICKS) -> dict:
    """``{(n, seed): (reference convergence [T], port terms [T, n],
    live counts [T])}``."""
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    from scalecube_cluster_tpu.sim import rapid as JR
    from scalecube_cluster_tpu.testlib.chaos import rapid_chaos_params, sample_schedule
    from scalecube_cluster_tpu_torch.sim import rapid as TR
    from tests.test_torch_rapid import port_input, tparams

    torch.set_num_threads(1)
    terms = []
    summed = TR.xla_cpu_fused_sum_f32

    def spy(x):
        terms.append(x.detach().clone().reshape(-1).numpy())
        return summed(x)

    out = {}
    TR.xla_cpu_fused_sum_f32 = spy
    try:
        for n in sizes:
            rp = rapid_chaos_params(n)
            for seed in seeds:
                st = JR.init_rapid_full_view(rp, seed=seed)
                _, jtr = JR.run_rapid_ticks(rp, st, sample_schedule(seed, n), ticks)
                terms.clear()
                tst = TR.init_rapid_full_view(tparams(rp), seed=seed, device="cpu")
                _, ttr = TR.run_rapid_ticks(tparams(rp), tst, port_input(sample_schedule(seed, n)),
                                            ticks)
                out[(n, seed)] = (np.asarray(jtr["convergence"]), np.stack(terms),
                                  ttr["alive_mask"].numpy().sum(axis=1))
    finally:
        TR.xla_cpu_fused_sum_f32 = summed
    return out


def in_order(x):
    s = _F32(0)
    for v in x:
        s = _F32(s + v)
    return s


def _tree(v):
    v = list(v)
    while len(v) > 1:
        h = len(v) // 2
        v = [_F32(v[i] + v[i + h]) for i in range(h)]
    return v[0]


def windows32(x):
    x = np.asarray(x, _F32)
    while len(x) > 32:
        pad = -len(x) % 32
        x = np.pad(x, (pad // 2, pad - pad // 2)).reshape(-1, 32)
        acc = np.zeros(x.shape[0], _F32)
        for i in range(32):
            acc = (acc + x[:, i]).astype(_F32)
        x = acc
    return in_order(x)


def vectorized(lanes: int, unroll: int, tree_parts: bool):
    def total(x):
        step = lanes * unroll
        body = len(x) // step * step
        if body == 0:
            return in_order(x)
        parts = [np.zeros(lanes, _F32) for _ in range(unroll)]
        for b in range(0, body, step):
            for u in range(unroll):
                parts[u] = (parts[u] + x[b + u * lanes: b + (u + 1) * lanes]).astype(_F32)
        while len(parts) > 1:
            if tree_parts:
                h = len(parts) // 2
                parts = [(parts[i] + parts[i + h]).astype(_F32) for i in range(h)]
            else:
                parts = [(parts[1] + parts[0]).astype(_F32)] + parts[2:]
        s = _tree(parts[0])
        for v in x[body:]:
            s = _F32(s + v)
        return s

    return total


def port_rule(x):
    n = len(x)
    if n > 32:
        return windows32(x)
    return vectorized(8, 1, False)(x) if n >= 16 else in_order(x)


def orders() -> dict:
    out = {"in order": in_order, "windows of 32": windows32}
    for lanes in (4, 8, 16):
        for unroll in (1, 2, 4):
            for tree_parts in (False, True):
                name = f"{lanes} lanes x {unroll}" + (" (tree)" if tree_parts else "")
                out[name] = vectorized(lanes, unroll, tree_parts)
    out["the port's rule"] = port_rule
    return out


def failing_sizes(data: dict) -> dict:
    """For each order, the sizes where some tick differs from the reference."""
    result = {}
    for name, fn in orders().items():
        bad = set()
        for (n, _), (ref, terms, live) in data.items():
            for t in range(len(ref)):
                s = np.array([fn(terms[t].astype(_F32))], _F32)
                conv = (s / np.array([max(int(live[t]), 1)], np.int32).astype(_F32))[0]
                if conv.view(np.int32) != ref[t].view(np.int32):
                    bad.add(n)
                    break
        result[name] = sorted(bad)
    return result


def main(argv) -> int:
    sizes = [int(a) for a in argv[1:]] or list(SIZES)
    data = collect(sizes)
    ticks = sum(len(v[0]) for v in data.values())
    print(f"{len(data)} runs, {ticks} ticks; sizes {sizes}, seeds {list(SEEDS)}")
    for name, bad in failing_sizes(data).items():
        print(f"{name:22s} fails at n = {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
