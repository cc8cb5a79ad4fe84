#!/usr/bin/env python3
"""The network-entry conv's accumulation order and what it moves, on one
NVIDIA GPU.

    python3 tools/entry_conv_orders.py [--orders pairwise,chained01]

The forward of csrc/conv3x3x3_c1.cu sums its 27 taps in two K steps of
the tensor cores (taps 0-15 and 16-31). Three orders are equally valid:

- chained10 (the tree): one chain, K step 1 then 0;
- chained01: one chain, K step 0 then 1;
- pairwise: two independent mma.sync chains, added once in f32.

For each order the script builds a copy of the port with it
(tools/kernel_copies.py; the checkout is never changed) and reads, in
that copy: the share of the forward's bf16 outputs that differ from the
exactly rounded conv (float64) and from the plain version, on a seeded
random 2 x 80^3 batch and on the entry conv's input of variant B's first
training step (chip_smoke.variant_b); the raw + statistics forward's time
at 10 x 80^3 (per call over 10 back to back); and variant B's train gate
(chip_smoke's `train variant b` comparison, printed with "pass" or its
failure).
"""

import argparse
import os
import sys
import tempfile

from kernel_copies import card_line, make_copy, run_in_copy

C1 = "conv3x3x3_c1.cu"


def chained(first, second):
    """One mma chain a column tile: K step `first`, then `second`."""
    return f'''        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {{
          mma16816(acc[j], a[{first}], bfr[{first}][j].x, bfr[{first}][j].y);
          mma16816(acc[j], a[{second}], bfr[{second}][j].x, bfr[{second}][j].y);
        }}
'''


PAIRWISE = '''        float acc[4][4], acc1[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = acc1[j][i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma16816(acc[j], a[0], bfr[0][j].x, bfr[0][j].y);
          mma16816(acc1[j], a[1], bfr[1][j].x, bfr[1][j].y);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] += acc1[j][i];
'''
TREE = chained(1, 0)
ORDERS = {"chained10": [],
          "chained01": [(C1, TREE, chained(0, 1))],
          "pairwise": [(C1, TREE, PAIRWISE)]}
LIMIT_S = 300


def read(label):
    """Run in a copy's directory: that copy's readings (module doc)."""
    sys.path.insert(0, os.getcwd())
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from dram_tpu_torch.data.synth import train_batch
    from dram_tpu_torch.kernels import _build, conv_stack
    from dram_tpu_torch.train import train_steps

    if not cs.__file__.startswith(os.getcwd()):
        raise SystemExit(f"imported {cs.__file__}, not the copy's")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    vb = cs.variant_b()
    batch = train_batch(cs.SEED, batch=vb.TRAIN_BATCH_SIZE,
                        size=vb.RESAMPLE_SIZE[0],
                        window=(vb.WINDOWING_MIN, vb.WINDOWING_MAX))
    inputs = []
    kernel = conv_stack.conv3x3x3_c1

    def record(x, w, epilogue=None, stats=False):
        if not inputs:
            inputs.append((x.clone(), w.detach().clone()))
        return kernel(x, w, epilogue, stats)
    record.launches = 0  # the wrapper counts under its own name
    conv_stack.conv3x3x3_c1 = record
    train_steps(vb, 1, [batch], device="cuda")
    conv_stack.conv3x3x3_c1 = kernel
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    x = torch.randn(2, 80, 80, 80, 1, generator=gen,
                    device="cuda").to(torch.bfloat16)
    w = torch.randn(32, 1, 3, 3, 3, generator=gen, device="cuda") * 0.2
    off_exact = off_plain = total = 0
    for tag, (xi, wi) in (("random 2 x 80^3", (x, w)),
                          ("variant B's entry input", inputs[0])):
        with torch.no_grad():
            y = conv_stack.conv3x3x3_c1(xi, wi)[0]
            yp = conv_stack.conv3x3x3_c1_plain(xi, wi)[0]
            ex = F.conv3d(xi.permute(0, 4, 1, 2, 3).double(),
                          wi.to(torch.bfloat16).double(), padding=1) \
                .permute(0, 2, 3, 4, 1).to(torch.bfloat16)
        ne, npl = (y != ex).sum().item(), (y != yp).sum().item()
        off_exact, off_plain, total = (off_exact + ne, off_plain + npl,
                                       total + y.numel())
        print(f"# [{label}] {tag}: {ne} of {y.numel()} bf16 outputs off the "
              f"exactly rounded conv, {npl} off the plain version "
              f"(the plain version {(yp != ex).sum().item()} off exact)",
              flush=True)
    xt = torch.randn(10, 80, 80, 80, 1, generator=gen,
                     device="cuda").to(torch.bfloat16)
    ms = cs.cuda_ms(lambda: [conv_stack.conv3x3x3_c1(xt, w, stats=True)
                             for _ in range(10)]) / 10
    print(f"# [{label}] both inputs: {off_exact} of {total} off exact, "
          f"{off_plain} off plain; raw + statistics at 10 x 80^3: ms "
          f"{ms:.4f} (per call over 10 back to back)", flush=True)
    del x, xt, inputs[:]
    torch.cuda.empty_cache()
    k_run = cs.run_train(vb, "variant b kernels", batch, None)
    torch.cuda.empty_cache()
    with cs.plain_versions():
        p_run = cs.run_train(vb, "variant b plain versions", batch, None)
    try:
        cs.compare_train(k_run, p_run, cs.variant_buffers(vb, None)(),
                         "train variant b")
        print(f"# [{label}] train gate variant B: pass", flush=True)
    except SystemExit as e:
        print(f"# [{label}] train gate variant B: {e}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--orders", help="comma-separated names to read "
                    f"(default: all of {sorted(ORDERS)})")
    args = ap.parse_args()
    names = args.orders.split(",") if args.orders else list(ORDERS)
    unknown = set(names) - set(ORDERS)
    if unknown:
        raise SystemExit(f"unknown orders {sorted(unknown)}")
    print(card_line(), flush=True)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            d = make_copy(tmp, name, ORDERS[name])
            if run_in_copy(d, __file__, ["--read", name], LIMIT_S) != 0:
                failed.append(name)
    if failed:
        raise SystemExit(f"orders that did not run to the end: {failed}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--read"]:
        read(sys.argv[2])
    else:
        main()
