"""A short steady part of a traced run under torch.profiler (CPU and
CUDA activities), read in memory: nothing is exported."""

import time

import torch

from . import trace

PCM_TAPS = "portbench.pcm_taps"
# the kernel torch.cuda._sleep launches: the primer of a profiled part,
# left out of its device span
PRIMER = "spin_kernel"


class Profiled:
    """Profile the units between start() and stop(); each ends in a
    device synchronize, so the part holds whole units. warm() starts the
    profiler once in set-up (its first start initialises the device
    tracer, which takes seconds)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.prof = None
        self.units = 0

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _prime(self):
        if self.cuda:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()

    def warm(self):
        p = torch.profiler.profile(activities=self._activities())
        p.start()
        self._prime()
        p.stop()

    def start(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.start()
        # one kernel through the tracer before the units, so that it
        # records from their first launch
        self._prime()
        self.t0 = time.perf_counter()

    def stop(self, units):
        if self.cuda:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.units = units

    def readings(self):
        """{"window_s", "busy_s", "span_s", "units", "device_ops" [(name,
        s, e) us], "pcm_taps_us", "breakdown"}. span_s: the device clock
        from the units' first operation's start to their last one's end
        (the primer left out), idle gaps included; 0 without operations."""
        ops = [op for op in trace.device_events(self.prof)
               if PRIMER not in op[0]]
        busy_us = trace.union_us([(a, b) for _, a, b in ops])
        out = {"window_s": self.window_s, "busy_s": busy_us / 1e6,
               "span_s": trace.span_us(ops) / 1e6,
               "units": self.units, "device_ops": ops,
               "pcm_taps_us": trace.range_device_us(self.prof, PCM_TAPS)}
        out["breakdown"] = _breakdown(self.prof, ops)
        return out


def _breakdown(prof, ops):
    """The ten device operations with the most time (by name, seconds)
    and the ten longest idle gaps between device operations, named by
    the host's top-level operation at the gap's middle."""
    by_name = {}
    for n, a, b in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    spans = sorted((a, b) for _, a, b in ops)
    gaps, end = [], None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.cpu_parent is None]
    named = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        mid = (a + b) / 2
        host = [e.name for e in cpu
                if e.time_range.start <= mid <= e.time_range.end]
        key = "idle: " + (host[0] if host else "host between operations")
        named[key] = named.get(key, 0.0) + (b - a) / 1e6
    gaps_top = sorted(named.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n[:120], s] for n, s in gaps_top]}
