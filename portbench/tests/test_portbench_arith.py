"""The frozen arithmetic against hand counts: roofline bounds, the MAC
and FLOP counts, conv launch lists, the busy union, and the readers on
synthetic traces."""

import importlib.util
import os

import pytest

from portbench.lib import convcount, harness, peaks, trace

FLAGSHIP = {"method": "models.DC3DATGeneric", "n_layers": 3,
            "in_ch_list": [1, 64, 128, 256, 768, 384, 192],
            "base_ch_list": [32, 64, 128, 256, 256, 128, 64],
            "end_ch_list": [64, 128, 256, 512, 256, 128, 64]}


def test_bound_takes_the_larger_time():
    assert peaks.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 989e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e9, 989e12) == pytest.approx(1.0)


def test_flops_and_launches_by_hand():
    # ds_0 at 80^3: 512000 voxels x 27 x (1 x 32 + 32 x 64)
    ds0 = 512000 * 27 * (1 * 32 + 32 * 64)
    assert convcount.estimate_conv3d_macs(FLAGSHIP, (80,) * 3) > ds0
    assert convcount.model_flops(FLAGSHIP, 80) == pytest.approx(
        0.92454912e12)
    entry = 2.0 * 27 * 32 * 512000
    assert convcount.train_flops(FLAGSHIP, 80) == pytest.approx(
        3 * 0.92454912e12 - entry)
    ev = convcount.eval_launches(FLAGSHIP, 80)
    tr = convcount.train_launches(FLAGSHIP, 80)
    assert len(ev) == 14 and len(tr) == 14 + 13 + 14
    assert convcount.expected_counts(ev) == {"wgmma": 13, "dw_wgmma": 0,
                                             "c1": 1, "c1_dw": 0}
    assert convcount.expected_counts(tr) == {"wgmma": 26, "dw_wgmma": 13,
                                             "c1": 1, "c1_dw": 1}
    assert sum(convcount.launch_cost(k, e, ci, co, 10)[0]
               for k, _, e, ci, co in tr) == pytest.approx(
        10 * convcount.train_flops(FLAGSHIP, 80))
    # us_2.conv_0's input: 128 upsampled + 64 skip channels at 80^3
    assert ("us_2.conv_0", 80, (128, 64), 64) in \
        convcount.conv_shapes(FLAGSHIP, 80)
    flops, nbytes = convcount.launch_cost("fwd", 80, 1, 32, 5)
    assert nbytes == 2.0 * 5 * 512000 * 33 + 27 * 32 * 2


def test_union_and_groups():
    assert trace.union_us([(0, 10), (5, 20), (30, 40)]) == 30
    assert trace.union_us([(0, 10), (2, 3)]) == 10
    assert trace.conv_kind("void conv3x3x3_dw_wgmma_kernel<64>(...)") \
        == "dw_wgmma"
    assert trace.conv_kind("conv3x3x3_c1_dw_kernel") == "c1_dw"
    assert trace.conv_kind("conv3x3x3_c1_kernel") == "c1"
    assert trace.conv_kind("conv3x3x3_wgmma_kernel") == "wgmma"
    assert trace.is_port("stencil_attention_bwd_kernel")
    assert not trace.is_port("vectorized_elementwise_kernel")


def _reader(name):
    path = os.path.join(harness.PORTBENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(ops, units, kind="scan_infer", busy=None, window=1.0):
    cfg = {"values": {"MODEL": FLAGSHIP, "RESAMPLE_SIZE": [80] * 3,
                      "TRAIN_BATCH_SIZE": 10}}
    busy = trace.union_us([(a, b) for _, a, b in ops]) / 1e6 \
        if busy is None else busy
    return {"config": cfg, "traffic": {"kind": kind,
                                       "lesion_severity": [3] * 5},
            "window": {"done": 10, "window_s": 2.0, "chunks": 100,
                       "latencies_s": [0.1] * 19 + [0.3]},
            "setup_s": 5.0,
            "prof": {"device_ops": ops, "units": units, "busy_s": busy,
                     "window_s": window, "span_s": trace.span_us(ops) / 1e6,
                     "pcm_taps_us": None}}


def test_readers_on_synthetic_traces():
    launches = convcount.eval_launches(FLAGSHIP, 80)
    bound = sum(peaks.bound_s(*reversed(convcount.launch_cost(
        k, e, ci, co, 5))) for k, _, e, ci, co in launches)
    # two scans, every conv launch taking twice its bound
    ops, t = [], 0.0
    for _ in range(2):
        for k, _, e, ci, co in launches:
            d = 2e6 * peaks.bound_s(*reversed(convcount.launch_cost(
                k, e, ci, co, 5)))
            name = "conv3x3x3_c1_kernel" if ci == 1 \
                else "conv3x3x3_wgmma_kernel"
            ops.append((name, t, t + d))
            t += d
    ops.append(("elementwise_kernel", t, t + 1000.0))
    ops.append(("Memcpy HtoD", t + 1000.0, t + 3000.0))
    ctx = _ctx(ops, 2)
    assert _reader("conv_roofline.infer")(ctx) == pytest.approx(50.0)
    assert _reader("torch_ms.infer")(ctx) == pytest.approx(0.5)
    ctx = _ctx(ops, 2, busy=0.25, window=1.0)
    assert _reader("idle_share.infer")(ctx) == pytest.approx(75.0)
    # a launch lost at the part's edge costs its time and its bound
    assert _reader("conv_roofline.infer")(_ctx(ops[1:], 2)) == \
        pytest.approx(50.0)
    # a scan's wgmma launches missing, or one launch too many: the list
    # no longer describes the path, no roofline
    assert _reader("conv_roofline.infer")(_ctx(ops[14:], 2)) is None
    assert _reader("conv_roofline.infer")(_ctx(ops + ops[:1], 2)) is None
    assert _reader("conv_roofline.train")(ctx) is None
    assert _reader("scans_per_min")(ctx) == pytest.approx(300.0)
    assert _reader("scan_p95_ms")(ctx) == pytest.approx(110.0)
    # the device span of the two scans: the conv launches back to back,
    # then 1 ms of elementwise work and a 2 ms copy
    span = t + 3000.0
    assert trace.span_us(ops) == pytest.approx(span)
    assert _reader("infer_mfu")(ctx) == pytest.approx(
        100 * 2 * 5 * 0.92454912e12 / (span / 1e6) / 989e12)
    assert _reader("train_mfu")(ctx) is None
    assert _reader("train_chunks_per_s")(ctx) is None
    tctx = _ctx([("k", 100.0, 200.0), ("k", 1000.0, 200100.0)], 4,
                kind="train_step")
    assert _reader("train_mfu")(tctx) == pytest.approx(
        100 * 4 * 10 * convcount.train_flops(FLAGSHIP, 80) / 0.2 / 989e12)
    assert _reader("infer_mfu")(tctx) is None
    assert _reader("train_chunks_per_s")(tctx) == pytest.approx(50.0)
    assert _reader("pcm_taps_ms.train")(tctx) is None
    tctx["prof"]["pcm_taps_us"] = 8000.0
    assert _reader("pcm_taps_ms.train")(tctx) == pytest.approx(2.0)
    assert bound > 0
