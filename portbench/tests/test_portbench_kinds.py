"""A new traffic kind and a new architecture's reference come in as files
only: a toy driver module and a toy reference module, put beside the
packages' own for the test, are found by name (the kind's FAMILY picks
the readers; the reference by the MODEL method its module declares),
with no edit of a file of the harness; an unknown method raises."""

import importlib.util
import os
import sys
import textwrap

import pytest
import torch

import portbench.lib
import portbench.reference
from portbench.lib import harness
from portbench.reference import forward_for
from portbench.reference import train as ref_train

TOY_DRIVER = '''
FAMILY = "train"


def run(cfg, traffic, seed, seconds, trace, device, fault=None,
        profiled=None, on_setup_done=None):
    raise NotImplementedError
'''

TOY_REFERENCE = '''
METHODS = ("models.ToyScale",)


def forward(x, P, model_cfg, train, q=lambda t: t, new_stats=None):
    dense = q(x) * q(P["scale"]) + P["shift"]
    return dense, dense
'''


def _reader(name):
    path = os.path.join(harness.PORTBENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture
def beside(tmp_path, monkeypatch):
    """Put a module into a package's search path for the test."""
    def put(package, name, source):
        d = tmp_path / package.__name__.replace(".", "_")
        d.mkdir(exist_ok=True)
        (d / f"{name}.py").write_text(textwrap.dedent(source))
        monkeypatch.setattr(package, "__path__",
                            list(package.__path__) + [str(d)])
        monkeypatch.delitem(sys.modules, f"{package.__name__}.{name}",
                            raising=False)
    yield put
    for name in ("portbench.lib.toykind", "portbench.reference.toyref"):
        sys.modules.pop(name, None)


def test_a_new_kind_is_read_by_its_family(beside):
    beside(portbench.lib, "toykind", TOY_DRIVER)
    traffic = {"kind": "toykind"}
    assert harness.family(traffic) == "train"
    model = {"method": "models.DC3D", "n_layers": 3,
             "in_ch_list": [1, 64, 128, 256, 768, 384, 192],
             "base_ch_list": [32, 64, 128, 256, 256, 128, 64],
             "end_ch_list": [64, 128, 256, 512, 256, 128, 64]}
    ctx = {"config": {"values": {"MODEL": model, "RESAMPLE_SIZE": [80] * 3,
                                 "TRAIN_BATCH_SIZE": 10}},
           "traffic": traffic,
           "window": {"done": 5, "window_s": 2.0, "chunks": 50,
                      "latencies_s": [0.1]},
           "prof": {"device_ops": [("k", 0.0, 1e5)], "units": 2,
                    "busy_s": 0.1, "window_s": 0.2, "span_s": 0.1,
                    "pcm_taps_us": None}}
    assert _reader("train_chunks_per_s")(ctx) == pytest.approx(25.0)
    assert _reader("idle_share.train")(ctx) == pytest.approx(50.0)
    assert _reader("train_mfu")(ctx) > 0
    assert _reader("scans_per_min")(ctx) is None
    assert _reader("idle_share.infer")(ctx) is None
    # a model whose conv plan convcount does not count: no MFU, no
    # roofline
    model["method"] = "models.ToyScale"
    assert _reader("train_mfu")(ctx) is None
    assert _reader("conv_roofline.train")(ctx) is None
    assert _reader("train_chunks_per_s")(ctx) == pytest.approx(25.0)


def test_a_new_method_finds_its_reference(beside):
    beside(portbench.reference, "toyref", TOY_REFERENCE)
    fwd = forward_for({"method": "models.ToyScale"})
    assert fwd.__module__ == "portbench.reference.toyref"
    assert forward_for({"method": "models.DC3D"}).__module__ == \
        "portbench.reference.nets"
    # the reference's training steps run the toy through forward_for
    g = torch.Generator().manual_seed(3)
    batch = {"image": torch.rand(2, 4, 4, 4, generator=g),
             "lobe": torch.ones(2, 4, 4, 4, dtype=torch.uint8),
             "lesion": (torch.rand(2, 4, 4, 4, generator=g) > 0.7)
             .to(torch.uint8),
             "ctss": torch.tensor([2, 3]),
             "freq": torch.full((6,), 0.5)}
    cfg = {"MODEL": {"method": "models.ToyScale"},
           "LOSS_FUNC": {"method": "metrics.IntRegRefineLoss",
                         "band_width": 0.01, "smoothing": 0.1},
           "LOSS_FACTORS": [2.0, 1.0, 0.5, 0.5],
           "OPTIMIZER": {"method": "torch.optim.Adam", "lr": 1e-2}}
    P0 = {"scale": torch.tensor(0.5), "shift": torch.tensor(-1.0)}
    out = ref_train.steps(P0, [batch], cfg, n_steps=2)
    assert len(out["loss"]) == 2 and set(out["grads"]) == set(P0)
    assert float(out["state"]["scale"]) != 0.5


def test_an_unknown_method_raises():
    with pytest.raises(NotImplementedError):
        forward_for({"method": "models.NoSuchNet"})
    with pytest.raises(NotImplementedError):
        ref_train.steps({}, [], {"MODEL": {"method": "models.NoSuchNet"}})
