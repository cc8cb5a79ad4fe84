"""One run of one cell: the manifest, the files a cell names, the
metric readers, the checks and the result line.

Everything a cell needs is found by name: BENCHMARK.json's workload
names a configuration (portbench/configs/<config>.json) and a traffic
mix (portbench/traffic/<traffic>.json, whose "kind" picks the driver in
portbench/lib/); every metric is read by portbench/metrics/<name>.py
(`read(ctx)`, None when it finds nothing to read); the limits of the
cell's checks are portbench/limits/<workload>.json."""

import importlib.util
import json
import os
import sys

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)

# modules that may not be loaded in a run's process, by top-level name
BANNED = ("jax", "jaxlib", "flax", "dram_tpu")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        return json.load(fp)


def _json(*parts):
    with open(os.path.join(PORTBENCH, *parts)) as fp:
        return json.load(fp)


def cell(name, bench=None):
    """(workload entry, configuration, traffic, limits) of cell `name`."""
    bench = bench or manifest()
    wl = {w["name"]: w for w in bench["workloads"]}.get(name)
    if wl is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    cfg = _json("configs", f"{wl['config']}.json")
    traffic = _json("traffic", f"{wl['traffic']}.json")
    limits = _json("limits", f"{name}.json")
    return wl, cfg, traffic, limits


def metrics_of(bench, workload, trace):
    """The cell's metric entries: end-to-end with trace 0, per-layer with
    trace 1 (those whose "workloads" list the cell, or that have none)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def read_metric(name, ctx):
    path = os.path.join(PORTBENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def banned_modules():
    """Top-level names of loaded modules that are banned, compared
    whole (dram_tpu_torch is not dram_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def checks_line(numbers, limits):
    """{name: {"value", "limit"}} in the limits' order, and whether every
    number is finite and within its limit."""
    out, ok = {}, True
    for k, lim in limits.items():
        v = numbers.get(k)
        v = float("inf") if v is None else float(v)
        out[k] = {"value": v, "limit": float(lim)}
        ok = ok and v <= float(lim)
    return out, ok


class Phases:
    """A run's phases' host seconds, printed to standard error as they
    end (`phase <name>: <s>`)."""

    def __init__(self):
        import time
        self.time = time.perf_counter
        self.t = self.time()

    def __call__(self, name):
        t = self.time()
        print(f"phase {name}: {t - self.t:.3f} s", file=sys.stderr,
              flush=True)
        self.t = t


def device_info(torch, count):
    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def host_line():
    """The host's speed in this run: the milliseconds of a fixed
    pure-Python loop (it paces the set-up's imports, and a cell whose
    card waits for the host)."""
    import time
    t, x = time.perf_counter(), 0
    for i in range(1_000_000):
        x += i
    return (f"host: {os.cpu_count()} cores; loop "
            f"{(time.perf_counter() - t) * 1e3:.1f} ms")
