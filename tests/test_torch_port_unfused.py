"""The port's unfused conv stack (USE_FUSED_STACK = False) vs the JAX
package's on the CPU, on the same numpy inputs:

- rows 10-11 of the TPU-kernel table: Conv3dFunction (kernels/conv3d.py)
  against conv3d_pallas in interpret mode, forward, dx and dW, bf16 and
  f32;
- ConvStack(fused=False) against JAX's ConvStack(use_pallas_conv=True,
  use_fused_stack=False) in bf16, train and eval;
- the first-maximum max-pool VJP against jax.grad of flax's nn.max_pool;
- the upsample against JAX's resize3d in bf16;
- the committed flagship golden against the port's prep, and the bench
  weights in an unfused flagship.
The whole unfused slice (training and inference) is held against the JAX
package in tests/test_torch_port_unfused_slice.py.

Each of the six ways the unfused path differs from the fused one has a
check here that fails for the fused path's choice: the rounding point of
the batch statistics (test_train_stats), the BN affine rounded after a
rounded conv output in eval (test_eval), dW rounded to bf16
(test_grads, TestConv3d), the first tied maximum (TestMaxPoolFirst); the
BN backward (PyTorch autograd of flax's formula) and the upsample's one
rounding move f32 rounding only and are held at stated tolerances."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import dram_tpu.core.pallas.conv3d as jconv
from dram_tpu.core.resample import resize3d as jax_resize3d
from dram_tpu.models.blocks import ConvStack as JaxConvStack

from dram_tpu_torch import weights
from dram_tpu_torch.configs import st_dram_ref_att as cfg
from dram_tpu_torch.configs import with_settings
from dram_tpu_torch.data.synth import synth_scan
from dram_tpu_torch.infer import fast
from dram_tpu_torch.kernels import conv3d, pool, upsample
from dram_tpu_torch.models import DC3DATGeneric
from dram_tpu_torch.models.blocks import ConvStack
from dram_tpu_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    """numpy f32 rounded to bf16 values (still f32)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _torch_w(w):
    """(3, 3, 3, Ci, Co) -> the port's (Co, Ci, 3, 3, 3)."""
    return _t(w.transpose(4, 3, 0, 1, 2))


def _f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.detach().float().numpy()


def _within_ulp(got, want, what):
    """bf16 on both sides, f32 sums in another order, rounded once: within
    one bf16 ulp of each value (rtol 2^-7), atol 2^-7 of the largest."""
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=BF16_ULP,
                               atol=BF16_ULP * np.abs(want).max(),
                               err_msg=what)


def _xla_conv(x, w):
    return jax.lax.conv_general_dilated(
        x, w, (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))


# --- rows 10-11: Conv3dFunction vs conv3d_pallas -----------------------------

CONV_CASES = {  # name: ((B, D, H, W), input parts, Co)
    "lane_padded_40": ((1, 2, 40, 40), (8,), 8),  # 1600 lanes -> 1664
    "two_parts": ((2, 2, 4, 8), (8, 8), 8),
    "entry_ci1": ((2, 2, 4, 8), (1,), 8),  # XLA's conv in the JAX package
}


class TestConv3d:
    @pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
    @pytest.mark.parametrize("case", list(CONV_CASES))
    def test_matches_conv3d_pallas(self, case, dtype):
        """Forward, dx and dW of Conv3dFunction against jax.vjp of
        conv3d_pallas (interpret mode; XLA's conv for the Ci = 1 entry,
        which conv3d.supported leaves to XLA) with the kernel cast to the
        compute dtype, as PallasConv3d casts it. The two-part input is
        held against the materialized concat. bf16: within one bf16 ulp,
        and dW reaches the f32 parameter rounded to bf16; f32: rtol 1e-4
        (tests/test_pallas_conv.py's bar), atol 1e-4 of the largest."""
        shape, parts, co = CONV_CASES[case]
        rng = np.random.default_rng(20)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        xs = [_bf16(rng.normal(size=shape + (c,))) for c in parts]
        ci = sum(parts)
        w = (rng.normal(size=(3, 3, 3, ci, co)) / np.sqrt(27 * ci)) \
            .astype(np.float32)
        cot = _bf16(rng.normal(size=shape + (co,)))
        conv = _xla_conv if ci < 8 else (
            lambda x, k: jconv.conv3d_pallas(x, k, True))

        @jax.jit
        def fwd_bwd(x, k, c):
            y, vjp = jax.vjp(lambda a, b: conv(a, b.astype(jdt)), x, k)
            return (y,) + vjp(c)
        y, jdx, jdw = fwd_bwd(jnp.asarray(np.concatenate(xs, -1), jdt),
                              jnp.asarray(w), jnp.asarray(cot, jdt))

        txs = [_t(x).to(tdt).requires_grad_() for x in xs]
        tw = _torch_w(w).requires_grad_()
        ty = conv3d.Conv3dFunction.apply(txs[0], txs[1] if len(txs) > 1
                                         else None, tw)
        ty.backward(_t(cot).to(tdt))
        assert ty.dtype == tdt and tw.grad.dtype == torch.float32
        tdx = torch.cat([x.grad for x in txs], -1)
        pairs = (("y", ty, y), ("dx", tdx, jdx),
                 ("dW", tw.grad.permute(2, 3, 4, 1, 0), jdw))
        for what, got, want in pairs:
            if dtype == "bfloat16":
                _within_ulp(got, want, what)
            else:
                want = _f32(want)
                np.testing.assert_allclose(
                    _f32(got), want, rtol=1e-4,
                    atol=1e-4 * np.abs(want).max(), err_msg=what)
        if dtype == "bfloat16":
            # dw.astype(w.dtype) of the bf16 kernel, carried back to f32
            g = tw.grad
            assert torch.equal(g, g.to(torch.bfloat16).float())


# --- the unfused ConvStack vs JAX's, bf16 ------------------------------------

SB, SD = 2, 2  # batch and depth of the stack cases (8 x 8 planes)


@pytest.fixture(scope="module")
def interpret_conv():
    """conv3d_pallas in interpret mode: PallasConv3d imports it from its
    module at call time (dram_tpu/models/blocks.py:112)."""
    orig = jconv.conv3d_pallas
    jconv.conv3d_pallas = lambda x, w: orig(x, w, True)
    yield
    jconv.conv3d_pallas = orig


def _port_stack(ci, c0, c1, fused, w0, w1, bns):
    m = ConvStack(ci, (c0, c1), fused=fused)
    with torch.no_grad():
        m.conv_0.weight.copy_(_torch_w(w0))
        m.conv_1.weight.copy_(_torch_w(w1))
        for bn, (g, b, mu, var) in zip((m.BatchNorm_0, m.BatchNorm_1), bns):
            bn.weight.copy_(_t(g))
            bn.bias.copy_(_t(b))
            bn.running_mean.copy_(_t(mu))
            bn.running_var.copy_(_t(var))
    return m


@pytest.fixture(scope="module", params=["two_parts", "entry_ci1"])
def stack_case(request, interpret_conv):
    """JAX's unfused ConvStack in bf16 (Pallas conv in interpret mode for
    Ci >= 8, XLA's for the Ci = 1 entry) in train mode under
    jax.value_and_grad and in eval mode, and the port's fused and unfused
    stacks on the same inputs and weights.

    The entry case runs JAX op by op: under jit XLA's CPU compiler removes
    the f32 -> bf16 -> f32 round trip between the XLA conv and the
    BatchNorm (excess precision is allowed by default), so the jitted
    program skips the rounding its source states; the Pallas conv's output
    is a kernel result, which it keeps."""
    parts = (8, 8) if request.param == "two_parts" else (1,)
    rng = np.random.default_rng(21)
    ci, c0, c1 = sum(parts), 8, 8
    xs = [_bf16(rng.normal(size=(SB, SD, 8, 8, c))) for c in parts]
    w0 = (rng.normal(size=(3, 3, 3, ci, c0)) / np.sqrt(27 * ci)) \
        .astype(np.float32)
    w1 = (rng.normal(size=(3, 3, 3, c0, c1)) / np.sqrt(27 * c0)) \
        .astype(np.float32)
    bns = [(rng.uniform(0.5, 1.5, c).astype(np.float32),
            (rng.normal(size=c) * 0.1).astype(np.float32),
            (rng.normal(size=c) * 0.05).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32)) for c in (c0, c1)]
    cot = rng.normal(size=(SB, SD, 8, 8, c1)).astype(np.float32)
    params = {"conv_0": {"kernel": w0}, "conv_1": {"kernel": w1}}
    stats = {}
    for i, (g, b, mu, var) in enumerate(bns):
        params[f"BatchNorm_{i}"] = {"scale": g, "bias": b}
        stats[f"BatchNorm_{i}"] = {"mean": mu, "var": var}
    xj = jnp.asarray(np.concatenate(xs, -1), jnp.bfloat16)

    def jstack(train):
        return JaxConvStack((c0, c1), [3, 3], [1, 1], [1, 1], False,
                            train=train, dtype=jnp.bfloat16,
                            use_pallas_conv=True, use_fused_stack=False)

    def loss(x, p):
        y, mut = jstack(True).apply({"params": p, "batch_stats": stats}, x,
                                    mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, mut)

    grad_fn = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    if ci >= 8:
        grad_fn = jax.jit(grad_fn)
    (_, (y, mut)), (gx, gp) = grad_fn(xj, params)
    y_eval = jstack(False).apply({"params": params, "batch_stats": stats},
                                 xj)

    port = {}
    for fused in (False, True):
        m = _port_stack(ci, c0, c1, fused, w0, w1, bns).train()
        txs = [_t(x).to(torch.bfloat16).requires_grad_() for x in xs]
        ty = m(*txs)
        (ty.float() * _t(cot)).sum().backward()
        with torch.no_grad():
            y_ev = _port_stack(ci, c0, c1, fused, w0, w1, bns).eval()(
                *[_t(x).to(torch.bfloat16) for x in xs])
        port[fused] = dict(m=m, y=ty, dx=torch.cat([x.grad for x in txs], -1)
                           if ci >= 8 else None, y_eval=y_ev)
    return dict(bns=bns, y=y, mut=mut["batch_stats"], gx=gx, gp=gp,
                y_eval=y_eval, port=port, entry=ci < 8)


def _batch_stats(bn, r0):
    """The batch (mean, var) a train step folded into the running ones:
    r1 = 0.9 r0 + 0.1 batch."""
    return [(r1 - 0.9 * r) / 0.1 for r1, r in zip(bn, r0)]


class TestUnfusedStack:
    def test_train_stats(self, stack_case):
        """Output within one bf16 ulp; the batch statistics, taken by flax
        from the conv output after its bf16 rounding: conv_0's within 1e-5
        (test_entry_stack_stats_bf16's bar), conv_1's within 1e-4 (its
        input may differ by one bf16 ulp at a few of the 256 voxels). The
        port's fused stack sums the f32 accumulator before the rounding:
        its conv_0 statistics miss JAX's unfused ones at the 1e-5 bar."""
        c, port = stack_case, stack_case["port"]
        _within_ulp(port[False]["y"], c["y"], "y")
        for fused in (False, True):
            m = port[fused]["m"]
            for i, bn in enumerate((m.BatchNorm_0, m.BatchNorm_1)):
                r0 = c["bns"][i][2:]
                jr = c["mut"][f"BatchNorm_{i}"]
                want = _batch_stats((np.asarray(jr["mean"]),
                                     np.asarray(jr["var"])), r0)
                got = _batch_stats((bn.running_mean.numpy(),
                                    bn.running_var.numpy()), r0)
                tol = 1e-5 if i == 0 else 1e-4
                for g, w in zip(got, want):
                    check = lambda: np.testing.assert_allclose(  # noqa: E731
                        g, w, rtol=tol, atol=tol * np.abs(w).max())
                    if not fused:
                        check()
                    elif i == 0:
                        with pytest.raises(AssertionError):
                            check()

    def test_grads(self, stack_case):
        """dx and dW within one bf16 ulp, dW rounded to bf16 (the fused
        stack's is not); the BatchNorm affine's gradients (f32 sums of
        bf16 cotangents) within 5e-3 of their largest value, the bar of
        tests/test_fused_stack.py."""
        c, port = stack_case, stack_case["port"]
        m = port[False]["m"]
        if not c["entry"]:
            _within_ulp(port[False]["dx"], c["gx"], "dx")
        for i in range(2):
            conv = getattr(m, f"conv_{i}").weight.grad
            _within_ulp(conv.permute(2, 3, 4, 1, 0),
                        c["gp"][f"conv_{i}"]["kernel"], f"dW {i}")
            assert torch.equal(conv, conv.to(torch.bfloat16).float())
            fused = getattr(port[True]["m"], f"conv_{i}").weight.grad
            assert not torch.equal(fused, fused.to(torch.bfloat16).float())
            bn = getattr(m, f"BatchNorm_{i}")
            for got, key in ((bn.weight.grad, "scale"),
                             (bn.bias.grad, "bias")):
                want = np.asarray(c["gp"][f"BatchNorm_{i}"][key])
                np.testing.assert_allclose(got.numpy(), want, rtol=5e-3,
                                           atol=5e-3 * np.abs(want).max())

    def test_eval(self, stack_case):
        """Eval: the running-stat BatchNorm in f32 on the bf16 conv output,
        rounded again, then ReLU. At most 1% of the outputs may differ
        (by the f32 summation order of the conv; none does here); the
        port's fused eval conv, which folds the affine into its epilogue
        and rounds once, differs at over 10% of them."""
        c, port = stack_case, stack_case["port"]
        want = _f32(c["y_eval"])
        for fused in (False, True):
            got = _f32(port[fused]["y_eval"])
            _within_ulp(got, want, "eval y")
            share = (got != want).mean()
            assert share > 0.1 if fused else share <= 0.01, (fused, share)


# --- the first-maximum max-pool VJP ------------------------------------------


def _tied_pool_input(rng):
    """Post-ReLU bf16 values (zeros tie) with duplicated rows (ties of 2
    and 4), (2, 4, 8, 8, 8)."""
    x = np.maximum(rng.normal(size=(2, 4, 8, 8, 8)), 0.0)
    x[:, :, ::2] = x[:, :, 1::2]
    return _bf16(x)


class TestMaxPoolFirst:
    def test_matches_flax_max_pool_vjp(self):
        """jax.grad of flax's nn.max_pool (XLA select-and-scatter) in bf16
        gives the whole cotangent to the first tied maximum; the port's
        first-maximum backward and MaxPool2First equal it exactly, and
        the tie-splitting backward does not."""
        rng = np.random.default_rng(22)
        x = _tied_pool_input(rng)
        g = _bf16(rng.normal(size=(2, 2, 4, 4, 8)))

        def f(a):
            y = fnn.max_pool(a, window_shape=(2, 2, 2), strides=(2, 2, 2))
            return jnp.sum(y.astype(jnp.float32) * g)
        want = np.asarray(jax.grad(f)(jnp.asarray(x, jnp.bfloat16))
                          .astype(jnp.float32))
        xt, gt = _t(x).to(torch.bfloat16), _t(g).to(torch.bfloat16)
        got = pool.maxpool2_bwd_first(xt, gt).float().numpy()
        np.testing.assert_array_equal(got, want)
        leaf = xt.clone().requires_grad_()
        pool.MaxPool2First.apply(leaf).backward(gt)
        np.testing.assert_array_equal(leaf.grad.float().numpy(), want)
        assert (want != 0).sum() == g.size  # one position per window
        split = pool.maxpool2_bwd(xt, gt).float().numpy()
        assert not np.array_equal(split, want)

    @pytest.mark.parametrize("tied,first", [((3, 5), 3), ((6, 1), 1),
                                            ((2, 4, 7), 2),
                                            (tuple(range(8)), 0)])
    def test_tie_positions(self, tied, first):
        """Window positions in row-major (dz, dy, dx) order: ties at (3, 5)
        route to 3, (6, 1) to 1, (2, 4, 7) to 2, all-equal to 0, for JAX
        and the port alike."""
        win = np.zeros(8, np.float32)
        win[list(tied)] = 1.0
        x = np.broadcast_to(win.reshape(1, 2, 2, 2, 1), (1, 2, 2, 2, 8)) \
            .copy()
        want = np.zeros(8, np.float32)
        want[first] = 1.0
        jg = jax.grad(lambda a: jnp.sum(fnn.max_pool(
            a, window_shape=(2, 2, 2), strides=(2, 2, 2))))(jnp.asarray(x))
        np.testing.assert_array_equal(np.asarray(jg)[0, ..., 0].ravel(),
                                      want)
        got = pool.maxpool2_bwd_first(_t(x), torch.ones(1, 1, 1, 1, 8))
        np.testing.assert_array_equal(got[0, ..., 0].numpy().ravel(), want)


# --- the upsample: resize3d on the unfused path ------------------------------


def test_upsample_matches_resize3d_bf16():
    """JAX's unfused decoder upsamples with resize3d (three f32 passes,
    rounded once; its autodiff adjoint likewise): the port's one-pass
    Upsample2x and its adjoint, also rounded once, agree within one bf16
    ulp (the passes add in another order)."""
    rng = np.random.default_rng(23)
    x = _bf16(rng.normal(size=(2, 5, 4, 6, 8)))
    g = _bf16(rng.normal(size=(2, 10, 8, 12, 8)))
    y, vjp = jax.vjp(lambda a: jax_resize3d(a, (10, 8, 12)),
                     jnp.asarray(x, jnp.bfloat16))
    (jdx,) = vjp(jnp.asarray(g, jnp.bfloat16))
    leaf = _t(x).to(torch.bfloat16).requires_grad_()
    ty = upsample.Upsample2x.apply(leaf)
    ty.backward(_t(g).to(torch.bfloat16))
    _within_ulp(ty, y, "upsample")
    _within_ulp(leaf.grad, jdx, "upsample adjoint")


# --- the flagship golden and the trained weights -----------------------------


def test_golden_matches_the_ports_prep():
    """The committed golden (tools/make_port_golden.py) was made from the
    port's NumPy prep of chip_smoke.py's scan: the same draw and lobe bits
    (sha256) and the same chunk values within chip_smoke's bound on the
    8^3 block means (the chunk bits' own sha256 depends on the host's
    BLAS, which rounds the float32 resample), so the golden cannot drift
    from the prep silently; its masks have the scan's shape."""
    gold = np.load(os.path.join(REPO, *chip_smoke.GOLDEN.split("/")))
    scan, lobe, _, vessel, _ = synth_scan(
        np.random.default_rng(chip_smoke.SEED), chip_smoke.SCAN_SHAPE,
        lesion_severity=chip_smoke.SEVERITIES)
    prepc = fast.prep_scan_chunks(scan, lobe, chip_smoke.SPACING,
                                  vessel_u8=vessel,
                                  windowing_span=chip_smoke.WINDOW,
                                  prep="numpy")
    assert chip_smoke.sha256(scan, lobe, vessel) == str(gold["draw_sha256"])
    assert chip_smoke.sha256(prepc["lobe_bits"]) == str(gold["lobe_sha256"])
    np.testing.assert_allclose(chip_smoke.block_means(prepc["x80_bits"]),
                               gold["x80_block_means"], rtol=0,
                               atol=chip_smoke.BLOCK_MEAN_ATOL)
    assert tuple(gold["scan_shape"]) == chip_smoke.SCAN_SHAPE
    n = int(np.prod(chip_smoke.SCAN_SHAPE))
    for key in ("pred_bits", "post_bits"):
        assert gold[key].size == n // 8 and gold[key].any(), key
    assert gold["ratios"].shape == (5,)
    assert int(gold["otsu_bin"]) == round(float(gold["threshold"]) * 255)


def test_bench_weights_fill_the_unfused_flagship():
    """flax names the unfused stack's modules conv_{i} and BatchNorm_{i},
    as the fused tree: the bench weights load into an unfused flagship
    with no missing or unexpected key, and its state_dict has the fused
    one's names."""
    params, bs = weights.load_bench_weights()
    m = weights.load_into(DC3DATGeneric(fused_stack=False), params, bs)
    assert set(m.state_dict()) == set(DC3DATGeneric().state_dict())


def test_build_model_reads_use_fused_stack():
    """build_model takes USE_FUSED_STACK from the settings (default True,
    the card's counterpart of the JAX package's accelerator default) for
    every conv stack and pool of the backbone."""
    unfused = with_settings(cfg, USE_FUSED_STACK=False)
    assert unfused.MODEL == cfg.MODEL and not hasattr(cfg, "USE_FUSED_STACK")
    for settings, fused in ((cfg, True), (unfused, False)):
        m = trainer.build_model(settings, torch.bfloat16)
        stacks = [s for s in m.modules() if isinstance(s, ConvStack)]
        assert len(stacks) == 7 and all(s.fused is fused for s in stacks)
        want = pool.MaxPool2 if fused else pool.MaxPool2First
        assert all(getattr(m.backbone, f"ds_{i}").pool is want
                   for i in range(3))
