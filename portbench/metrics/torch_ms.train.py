"""Device ms a step in kernels that are not the port's own (PyTorch's
elementwise, reduction, copy and matmul kernels: lib/trace.py's
group_of), over the profiled steps."""

from portbench.lib import trace


def read(ctx):
    p = ctx["prof"]
    if p is None or ctx["traffic"]["kind"] != "train_step" or not p["units"]:
        return None
    us = sum(b - a for n, a, b in p["device_ops"]
             if trace.is_kernel(n) and not trace.is_port(n))
    return us / 1e3 / p["units"] if us > 0 else None
