"""Copies of the port with lines of its CUDA sources changed, for the
tools that read variant or deliberately broken kernels on the card
(tools/train_gate_mutants.py, tools/prologue_variants.py) without
touching the checkout: each copy builds its own kernels with its own
dram_tpu_torch/kernels/_build.py."""

import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("dram_tpu_torch", "kernels", "csrc")


def kernel_span(text, kernel):
    """(start, end) of __global__ function `kernel` in a CUDA source: from
    its __global__ to the next one (or the end of the file)."""
    starts = [m for m in re.finditer(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
        text)]
    hits = [k for k, m in enumerate(starts) if m.group(1) == kernel]
    if len(hits) != 1:
        raise SystemExit(f"kernel {kernel} not defined once")
    k = hits[0]
    end = starts[k + 1].start() if k + 1 < len(starts) else len(text)
    return starts[k].start(), end


def make_copy(tmp, name, edits, root=ROOT):
    """dram_tpu_torch/ and chip_smoke.py of `root` (the checkout, or an
    unpacked archive of another commit) copied to tmp/name, with `edits`
    applied to the copy: (file, text, its replacement[, kernel]) each,
    the text found exactly once in the file or, where a __global__
    function `kernel` is named, in that kernel (kernel_span); a file name
    is one of csrc/, a path with a "/" one of dram_tpu_torch/. Returns
    the copy's directory."""
    d = os.path.join(tmp, name)
    shutil.copytree(os.path.join(root, "dram_tpu_torch"),
                    os.path.join(d, "dram_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(root, "chip_smoke.py"), d)
    for src, old, new, *kernel in edits:
        path = os.path.join(d, "dram_tpu_torch", src) if "/" in src \
            else os.path.join(d, CSRC, src)
        text = open(path).read()
        lo, hi = kernel_span(text, kernel[0]) if kernel else (0, len(text))
        if text.count(old, lo, hi) != 1:
            raise SystemExit(f"{name}: text not found once in {src}"
                             + (f" ({kernel[0]})" if kernel else ""))
        with open(path, "w") as fp:
            fp.write(text[:lo] + text[lo:hi].replace(old, new) + text[hi:])
    return d


def run_in_copy(d, script, args, timeout):
    """Runs `script` with `args` in the copy's directory, so that it
    imports the copy's package (insert os.getcwd() first on sys.path);
    returns its exit code."""
    return subprocess.run([sys.executable, os.path.abspath(script), *args],
                          cwd=d, timeout=timeout).returncode


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20).stdout.strip()
