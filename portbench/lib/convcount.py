"""Operations and bytes of the model's conv launches, and the model's
FLOPs a chunk.

`estimate_conv3d_macs` is a frozen copy of dram_tpu_torch/utils.py
(estimate_conv3d_macs): the conv stacks' MACs of a DC3D channel plan at a
chunk size. `conv_shapes` and `train_launches` follow chip_smoke.py's
conv_shapes / flagship_conv_launches (the 3x3x3 convs of the backbone in
forward order, and per conv of a training step its forward, its input
gradient (none for the network-entry conv) and its weight gradient);
`launch_cost` counts their operations and bytes as chip_smoke.py's conv
sweep does: bf16 activations read once and written once, bf16 weights,
an f32 weight gradient."""

import math

# the MODEL methods whose conv plan these counts describe (the DC3D
# backbone); a reader returns None for any other
METHODS = ("models.DC3D", "models.DC3DATGeneric")


def estimate_conv3d_macs(model_cfg, spatial_size):
    n = model_cfg["n_layers"]
    base = model_cfg["base_ch_list"]
    end = model_cfg["end_ch_list"]
    in_ch = model_cfg["in_ch_list"]
    macs = 0
    size = [int(s) for s in spatial_size]
    for i in range(n):  # encoder, full size down
        macs += math.prod(size) * 27 * (in_ch[i] * base[i] + base[i] * end[i])
        size = [s // 2 for s in size]
    macs += math.prod(size) * 27 * (in_ch[n] * base[n] + base[n] * end[n])
    for i in range(n):  # decoder
        size = [s * 2 for s in size]
        li = n + 1 + i
        macs += math.prod(size) * 27 * (in_ch[li] * base[li]
                                        + base[li] * end[li])
    return macs


def conv_shapes(model_cfg, size):
    """(name, edge, (C1, C2), Co) of the backbone's 3x3x3 convs in forward
    order; C2 is the skip part of a decoder conv_0's [upsample, skip]
    input (0 for one part)."""
    n = model_cfg["n_layers"]
    base, end = model_cfg["base_ch_list"], model_cfg["end_ch_list"]
    ins = [1] + list(end[:n - 1])
    out = []
    for i in range(n):
        e = size >> i
        out.append((f"ds_{i}.conv_0", e, (ins[i], 0), base[i]))
        out.append((f"ds_{i}.conv_1", e, (base[i], 0), end[i]))
    e = size >> n
    out.append(("bg.conv_0", e, (end[n - 1], 0), base[n]))
    out.append(("bg.conv_1", e, (base[n], 0), end[n]))
    for i in range(n):
        e = size >> (n - 1 - i)
        up, skip = end[n + i], end[n - 1 - i]
        out.append((f"us_{i}.conv_0", e, (up, skip), base[n + 1 + i]))
        out.append((f"us_{i}.conv_1", e, (base[n + 1 + i], 0),
                    end[n + 1 + i]))
    return out


def launch_cost(kind, e, ci, co, batch):
    """(flops, bytes) of one launch. kind: 'fwd' (any forward mode), 'dx'
    (ci: the forward's Co, the gradient's input; co: the forward's Ci)
    or 'dw'."""
    vox = batch * e ** 3
    flops = 2.0 * 27 * ci * co * vox
    if kind == "dw":
        return flops, 2.0 * vox * (ci + co) + 27 * ci * co * 4
    return flops, 2.0 * vox * (ci + co) + 27 * ci * co * 2


def eval_launches(model_cfg, size):
    """(kind, name, edge, Ci, Co) of one eval forward's conv launches."""
    return [("fwd", name, e, c1 + c2, co)
            for name, e, (c1, c2), co in conv_shapes(model_cfg, size)]


def train_launches(model_cfg, size):
    """(kind, name, edge, Ci, Co) of a training step's conv launches:
    forward, input gradient (not for the CT input) and weight gradient
    of every conv."""
    out = []
    for name, e, (c1, c2), co in conv_shapes(model_cfg, size):
        ci = c1 + c2
        out.append(("fwd", name, e, ci, co))
        if ci != 1:
            out.append(("dx", name, e, co, ci))
        out.append(("dw", name, e, ci, co))
    return out


def model_flops(model_cfg, size):
    """Forward FLOPs of one chunk of size^3: 2 x the conv stacks' MACs."""
    return 2.0 * estimate_conv3d_macs(model_cfg, (size,) * 3)


def train_flops(model_cfg, size):
    """FLOPs of one chunk through a training step: the forward, the input
    gradient and the weight gradient of every conv (3 x the forward),
    less the entry conv's input gradient, which is never computed."""
    first = conv_shapes(model_cfg, size)[0]
    _, e, (c1, c2), co = first
    entry = 2.0 * 27 * (c1 + c2) * co * e ** 3
    return 3.0 * model_flops(model_cfg, size) - entry


def expected_counts(launches):
    """Launches by conv-family kernel (lib/trace.py's keys): the Ci = 1
    entry conv runs the c1 pair, every other conv the wgmma kernels."""
    out = {"wgmma": 0, "dw_wgmma": 0, "c1": 0, "c1_dw": 0}
    for kind, _, _, ci, _ in launches:
        entry = ci == 1 and kind != "dx"
        if kind == "dw":
            out["c1_dw" if entry else "dw_wgmma"] += 1
        else:
            out["c1" if entry else "wgmma"] += 1
    return out


def roofline_share(ops, launches, batch, units):
    """Share (%) of the conv kernels' device time in `ops` ((name, start,
    end) us) that their bounds take: each launch of a kernel counted at
    the mean bound of that kernel's launches in `launches` (at `batch`),
    which is exact when the trace holds all `units` x `launches`. None
    when it holds no conv launch, or when a kernel's count is off the
    list's: more launches than listed, or more than two missing (the
    program's conv path changed, and the list no longer describes it);
    a launch the tracer lost at the part's edges costs its time and its
    bound alike."""
    from .trace import conv_kind
    from .peaks import bound_s
    counts = {"wgmma": 0, "dw_wgmma": 0, "c1": 0, "c1_dw": 0, "colsum": 0}
    t_us = 0.0
    for name, a, b in ops:
        k = conv_kind(name)
        if k is not None:
            counts[k] += 1
            t_us += b - a
    per_unit = expected_counts(launches)
    bounds = {k: 0.0 for k in per_unit}
    for kind, _, e, ci, co in launches:
        key = [k for k, v in expected_counts([(kind, "", e, ci, co)]).items()
               if v][0]
        bounds[key] += bound_s(*reversed(launch_cost(kind, e, ci, co, batch)))
    short = sum(n * units - counts[k] for k, n in per_unit.items())
    if t_us <= 0 or units <= 0 or short > 2 or any(
            counts[k] > n * units for k, n in per_unit.items()):
        import sys
        print(f"portbench: conv launches {counts} against "
              f"{ {k: n * units for k, n in per_unit.items()} }: no roofline",
              file=sys.stderr)
        return None
    bound = sum(counts[k] * bounds[k] / n for k, n in per_unit.items() if n)
    return 100.0 * bound / (t_us / 1e6)
