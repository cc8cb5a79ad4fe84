"""Copies of the port with lines of its CUDA sources changed, for the
tools that read variant or deliberately broken kernels on the card
(tools/train_gate_mutants.py, tools/prologue_variants.py) without
touching the checkout: each copy builds its own kernels with its own
dram_tpu_torch/kernels/_build.py."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("dram_tpu_torch", "kernels", "csrc")


def make_copy(tmp, name, edits):
    """dram_tpu_torch/ and chip_smoke.py copied to tmp/name, with `edits`
    applied to the copy's CUDA sources: (file in csrc/, text, its
    replacement) each, the text found exactly once. Returns the copy's
    directory."""
    d = os.path.join(tmp, name)
    shutil.copytree(os.path.join(ROOT, "dram_tpu_torch"),
                    os.path.join(d, "dram_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), d)
    for src, old, new in edits:
        path = os.path.join(d, CSRC, src)
        text = open(path).read()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: text not found once in {src}")
        with open(path, "w") as fp:
            fp.write(text.replace(old, new))
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
