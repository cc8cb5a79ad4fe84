"""Guards of the port's boundaries: dram_tpu_torch, chip_smoke.py and two
gloo ranks of the port import and run without jax, flax, msgpack, ml_dtypes, scipy, pandas, matplotlib, cv2,
sklearn, tensorboard or dram_tpu; no module of the port names a file
under dram_tpu/; the CUDA sources include no PyTorch, pybind11 or
CUTLASS header; a CUDA request without a GPU raises, from the API and
from the training CLI; chip_smoke.py fails without a GPU and outside the
repo."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "dram_tpu_torch", "kernels", "csrc")

BLOCKER = """
import sys
BLOCKED = {"jax", "jaxlib", "flax", "msgpack", "ml_dtypes", "scipy",
           "pandas", "matplotlib", "cv2", "sklearn", "tensorboard",
           "dram_tpu"}
class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import " + name)
        return None
sys.meta_path.insert(0, _Blocker())
"""


def _run(code, cwd=REPO):
    return subprocess.run([sys.executable, "-c", BLOCKER + code], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_package_imports_without_jax_or_dram_tpu(tmp_path):
    """Every module imports with the blocked packages absent, and two
    gloo ranks of the port (core/mesh.py's start-up, a cross-rank gsum)
    run with them blocked in every rank."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    try:
        import _torch_port_dist_worker as worker
    finally:
        sys.path.pop(0)
    got = worker.spawn("guard", 2, str(tmp_path), prelude=BLOCKER)
    assert [g["sum"] for g in got] == [3.0, 3.0]
    r = _run("""
import pkgutil, importlib, dram_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dram_tpu_torch.__path__,
                                               "dram_tpu_torch.")]
for n in names + ["dram_tpu_torch.train", "dram_tpu_torch.losses",
                  "dram_tpu_torch.configs"]:
    importlib.import_module(n)
assert {"dram_tpu_torch.train.trainer", "dram_tpu_torch.losses.refine",
        "dram_tpu_torch.configs.st_dram_ref",
        "dram_tpu_torch.configs.st_dram_ref_att",
        "dram_tpu_torch.infer.engine", "dram_tpu_torch.data.io",
        "dram_tpu_torch.data.datasets", "dram_tpu_torch.data.transforms",
        "dram_tpu_torch.train.checkpoint", "dram_tpu_torch.train.runner",
        "dram_tpu_torch.viz", "dram_tpu_torch.process_pipeline",
        "dram_tpu_torch.native", "dram_tpu_torch.data.sampler",
        "dram_tpu_torch.data.pipeline", "dram_tpu_torch.data.prepare_data",
        "dram_tpu_torch.train.__main__", "dram_tpu_torch.train.chunk_train",
        "dram_tpu_torch.train.torch_import",
        "dram_tpu_torch.configs.st_copd_subtyping",
        "dram_tpu_torch.losses.equivariance", "dram_tpu_torch.models.pcm",
        "dram_tpu_torch.kernels.window_attention",
        "dram_tpu_torch.core.mesh"} <= set(names)
# the generic attention path and the equivariance losses run without
# scipy (blocked above): the stencil, a k = 5 PCM and the transforms
import torch
from dram_tpu_torch.kernels import window_attention as wa
from dram_tpu_torch.models.pcm import PCM
from dram_tpu_torch.losses import equivariance as eq
assert len(wa.stencil_offsets(5, 2, True)) == 98
m = PCM(in_ch=3, f_dim=4, g_dim=2, k_size=5, self_loop=True)
assert m(torch.zeros(1, 4, 4, 4, 1), torch.zeros(1, 4, 4, 4, 3)).shape == \
    (1, 4, 4, 4, 1)
T = eq.OneShotTransform(torch.Generator().manual_seed(0), (6, 4, 4))
assert T(torch.zeros(1, 4, 4, 4, 1)).shape == (1, 6, 4, 4, 1)
assert eq.rotate3d_x_oneshot(torch.ones(1, 3, 3, 3, 1), 0.3).shape == \
    (1, 3, 3, 3, 1)
print(len(names))
""")
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 49


def test_no_module_names_a_dram_tpu_file():
    """The port neither imports nor exec-loads a file of the JAX
    package: no source of dram_tpu_torch names a path under dram_tpu/."""
    root = os.path.join(REPO, "dram_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fp:
                    code = fp.read()
                assert not re.search(r"[\"'](\.\./)*dram_tpu[/\"']|"
                                     r"join\([^)]*[\"']dram_tpu[\"']",
                                     code), f


def test_chip_smoke_imports_without_jax_or_dram_tpu():
    r = _run("import runpy; runpy.run_path('chip_smoke.py', "
             "run_name='chip_smoke_import')")
    assert r.returncode == 0, r.stderr


def test_cuda_sources_include_plain_cuda_headers_only():
    srcs = [f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))]
    assert sorted(srcs) == ["conv3x3x3.cu", "conv3x3x3_c1.cu",
                            "conv3x3x3_dw.cu", "conv_wgmma.cuh",
                            "maxpool2.cu", "stencil_attention.cu",
                            "stencil_attention_generic.cu",
                            "stencil_attention_generic_bwd.cu",
                            "stencil_generic_ring.cuh", "upsample2x.cu"]
    for f in srcs:
        with open(os.path.join(CSRC, f)) as fp:
            includes = re.findall(r"#\s*include\s*[<\"]([^>\"]+)", fp.read())
        assert includes, f
        for inc in includes:
            assert not re.match(r"(torch|ATen|c10|pybind11|cutlass|cute)",
                                inc), f"{f} includes {inc}"
            assert inc in srcs or "/" not in inc and inc.endswith(".h"), \
                f"{f} includes {inc}"
        if f.endswith(".cu"):
            with open(os.path.join(CSRC, f)) as fp:
                assert 'extern "C" int' in fp.read(), f


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from dram_tpu_torch.kernels import _build
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


def test_library_name_tracks_sources_and_flags(monkeypatch):
    from dram_tpu_torch.kernels import _build
    a = _build.library_path()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path() != a
    assert os.path.dirname(a).endswith(os.path.join("dram_tpu_torch",
                                                    "_build"))


def test_require_cuda():
    from dram_tpu_torch import require_cuda
    assert require_cuda("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        require_cuda("cuda")


def test_train_cli_cuda_without_gpu_raises():
    """python3 -m dram_tpu_torch.train asks for CUDA by default and exits
    with the error when there is none, before it reads any data."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "dram_tpu_torch.train"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "cuda.is_available() is false" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_registry_resolves_every_dram_tpu_name():
    """Each of the 15 method names of dram_tpu/utils.py:_ALIASES resolves
    in the port's registry to a dram_tpu_torch object, the six names
    that the training options need among them."""
    from dram_tpu_torch.configs import get_callable_by_name
    with open(os.path.join(REPO, "dram_tpu", "utils.py")) as fp:
        text = fp.read()
    table = text[text.index("_ALIASES = {"):]
    table = table[:table.index("}")]
    names = re.findall(r'^\s*"([\w.]+)":', table, re.M)
    assert len(names) == 15
    for name in names:
        fn = get_callable_by_name(name)
        assert fn.__module__.startswith("dram_tpu_torch."), name
    for name in ("models.PCM", "metrics.IntRegAffLoss",
                 "metrics.IntRegAffRefineLoss", "metrics.BootBinCrossEntropy",
                 "metrics.BinaryCrossEntropySmooth", "torch.optim.SGD"):
        assert name in names


def test_no_stale_queue_item_names():
    """The port's messages name ROADMAP Queue 1 items that exist (it has
    five): no source of dram_tpu_torch names an "item 6" or later; and
    item 5 (multi-device) is ported, so neither the package nor
    chip_smoke.py names it for something still missing."""
    root = os.path.join(REPO, "dram_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(root):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    for path in paths:
        with open(path) as fp:
            code = fp.read()
        assert not re.search(r"item\s+([5-9]|\d\d)", code), path
