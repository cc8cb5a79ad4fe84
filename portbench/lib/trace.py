"""Reading a torch.profiler run in memory: the device's activity, the
busy union, kernel groups, and the device time of layers the harness
marks with ranges.

`union_us` and `group_of` are frozen copies of
tools/profile_torch_train.py (the port's kernels by their __global__
names; PyTorch's own kernels grouped)."""

import torch

# the port's kernels (dram_tpu_torch/kernels/csrc/*.cu) by symbol
PORT_KERNELS = ("conv3x3x3_wgmma_kernel", "conv3x3x3_dw_wgmma_kernel",
                "conv3x3x3_c1_kernel", "conv3x3x3_c1_dw_kernel",
                "colsum_kernel",
                "maxpool2_kernel", "maxpool2_bwd_kernel",
                "upsample2x_kernel", "upsample2x_bwd_kernel",
                "stencil_attention_kernel", "stencil_attention_scal_kernel",
                "stencil_attention_bwd_kernel",
                "stencil_attention_generic", "stencil_attention_scal_generic",
                "stencil_attention_bwd_plus", "stencil_attention_bwd_minus")

# the conv family: the forward / input-gradient kernel, the weight
# gradient, the Ci = 1 pair, and the column sums that finish their
# statistics and split-K weight gradients
CONV_KERNELS = {"wgmma": "conv3x3x3_wgmma_kernel",
                "dw_wgmma": "conv3x3x3_dw_wgmma_kernel",
                "c1": "conv3x3x3_c1_kernel",
                "c1_dw": "conv3x3x3_c1_dw_kernel",
                "colsum": "colsum_kernel"}


def conv_kind(name):
    """The conv-family key of a kernel symbol, or None."""
    for key in ("dw_wgmma", "c1_dw", "c1", "wgmma", "colsum"):
        if CONV_KERNELS[key] in name:
            return key
    return None


def group_of(name):
    for k in PORT_KERNELS:
        if k in name:
            return "port " + k
    low = name.lower()
    if "adam" in low or "multi_tensor" in low:
        return "torch optimizer (Adam)"
    if "gemm" in low or "gemv" in low or "xmma" in low:
        return "torch matmul"
    if "reduce" in low:
        return "torch reductions"
    if "copy" in low or "cat" in low:
        return "torch copies / casts"
    return "torch elementwise"


def is_port(name):
    return group_of(name).startswith("port ")


def union_us(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def span_us(ops):
    """From the earliest start to the latest end of (name, start_us,
    end_us) operations; 0 without any."""
    if not ops:
        return 0.0
    return max(b for _, _, b in ops) - min(a for _, a, _ in ops)


def device_events(prof):
    """(name, start_us, end_us) of every operation the profiler saw on a
    CUDA device (kernels, copies, sets), without the annotations PyTorch
    draws on the device timeline."""
    out = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False):
            continue
        out.append((e.name, float(e.time_range.start),
                    float(e.time_range.end)))
    return out


def is_kernel(name):
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def range_device_us(prof, label):
    """Device microseconds of the kernels launched inside the ranges
    named `label` (record_function, opened by the harness around a
    layer's forward) and by the backward of the operations recorded
    there (autograd's evaluate_function events carry the forward
    operation's sequence number). None when no such range was
    recorded."""
    events = list(prof.events())
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    ranges = [(e.thread, e.time_range.start, e.time_range.end)
              for e in cpu if e.name == label]
    if not ranges:
        return None

    def inside(e, spans):
        return any(e.thread == t and a <= e.time_range.start
                   and e.time_range.end <= b for t, a, b in spans)
    fwd = [e for e in cpu if e.name != label and inside(e, ranges)]
    seqs = {e.sequence_nr for e in fwd if e.sequence_nr >= 0}
    bwd_spans = [(e.thread, e.time_range.start, e.time_range.end)
                 for e in cpu
                 if e.name.startswith("autograd::engine::evaluate_function")
                 and e.sequence_nr in seqs]
    bwd = [e for e in cpu if inside(e, bwd_spans)]
    total = 0.0
    for e in {id(e): e for e in fwd + bwd}.values():
        for k in getattr(e, "kernels", []):
            total += float(k.duration)
    return total


class Ranges:
    """record_function ranges around modules' forwards (hooks), named
    `label`, for range_device_us."""

    def __init__(self, modules, label):
        self.label = label
        self.handles = []
        self.open = {}
        for m in modules:
            self.handles.append(m.register_forward_pre_hook(self._pre))
            self.handles.append(m.register_forward_hook(self._post))

    def _pre(self, mod, args):
        r = torch.autograd.profiler.record_function(self.label)
        r.__enter__()
        self.open[id(mod)] = r

    def _post(self, mod, args, out):
        r = self.open.pop(id(mod), None)
        if r is not None:
            r.__exit__(None, None, None)

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []
