"""The port's training kernels (their plain versions, which CPU tensors
take) and the differentiable conv stack vs the JAX package on the CPU:
conv_cm in its training modes, conv_dw_cm, the max-pool and upsample
VJPs and fused_cbr2 at train, the Pallas kernels in interpret mode, on
the same numpy inputs in f32. The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dram_tpu.core.pallas.cm import CM, as_ndhwc, from_cm, to_cm, to_cm_t
from dram_tpu.core.pallas.fused_stack import (_flip_wk, _wk, conv_cm,
                                              conv_dw_cm, fused_cbr2)
from dram_tpu.core.pallas.pool import maxpool2_flat

from dram_tpu_torch.kernels import conv_stack, pool, upsample
from dram_tpu_torch.models.blocks import BatchNorm, ConvStack

# f32 on both sides: summation order only
RTOL, ATOL = 1e-5, 2e-5
B, D, H, W = 2, 8, 8, 8
SD = 4  # depth of the conv-stack cases


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _parts(rng, parts, d=D):
    return [rng.normal(size=(B, d, H, W, c)).astype(np.float32)
            for c in parts]


def _jcm(xs):
    """numpy NDHWC parts -> conv_cm's input (one cm array or a tuple)."""
    cms = tuple(to_cm(jnp.asarray(x)) for x in xs)
    return cms if len(cms) > 1 else cms[0]


def _prologue(rng, ci):
    return (rng.uniform(0.5, 1.5, ci).astype(np.float32),
            (rng.normal(size=ci) * 0.3).astype(np.float32))


def _torch_w(w):
    """(3, 3, 3, Ci, Co) -> the port's (Co, Ci, 3, 3, 3)."""
    return _t(w.transpose(4, 3, 0, 1, 2))


# the stack's uses: conv_0 on one or two parts, conv_1 with the prologue
PART_CASES = [((16,), False), ((16,), True), ((8, 8), False)]
PART_IDS = ["one_part", "prologue", "two_parts"]


class TestConvTrainModes:
    @pytest.mark.parametrize("parts,pro", PART_CASES, ids=PART_IDS)
    def test_forward_with_stats(self, parts, pro):
        rng = np.random.default_rng(10)
        xs = _parts(rng, parts)
        ci, co = sum(parts), 16
        w = (rng.normal(size=(3, 3, 3, ci, co)) * 0.2).astype(np.float32)
        s, t = _prologue(rng, ci) if pro else (np.zeros(ci, np.float32),) * 2
        out, st = conv_cm(_jcm(xs), _wk(jnp.asarray(w), jnp.float32),
                          jnp.asarray(s), jnp.asarray(t), H, W, D,
                          prologue=pro, stats=True, interpret=True)
        want = np.asarray(from_cm(out, H, W))
        y, got_st = conv_stack.conv3x3x3_train(
            _t(xs[0]), _torch_w(w), x2=_t(xs[1]) if len(xs) > 1 else None,
            prologue=(_t(s), _t(t)) if pro else None, stats=True)
        np.testing.assert_allclose(y.numpy(), want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_st.numpy(), np.asarray(st),
                                   rtol=RTOL, atol=ATOL * want.size)

    def test_dx_split_output(self):
        """The input gradient on flipped weights, written as the two
        parts of a virtual concat (out_split)."""
        rng = np.random.default_rng(11)
        ci, co = 24, 16
        w = (rng.normal(size=(3, 3, 3, ci, co)) * 0.2).astype(np.float32)
        dy = rng.normal(size=(B, D, H, W, co)).astype(np.float32)
        z = jnp.zeros((co,), jnp.float32)
        outs, _ = conv_cm(to_cm(jnp.asarray(dy)),
                          _flip_wk(jnp.asarray(w), jnp.float32), z, z, H, W,
                          D, prologue=False, stats=False, interpret=True,
                          out_split=(16, 8))
        d1, d2 = conv_stack.conv3x3x3_dx(_t(dy), _torch_w(w), split=(16, 8))
        for got, want in ((d1, outs[0]), (d2, outs[1])):
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(from_cm(want, H, W)),
                                       rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("parts,pro", PART_CASES, ids=PART_IDS)
    def test_weight_gradient(self, parts, pro):
        rng = np.random.default_rng(12)
        xs = _parts(rng, parts)
        ci, co = sum(parts), 16
        dy = rng.normal(size=(B, D, H, W, co)).astype(np.float32)
        s, t = _prologue(rng, ci) if pro else (np.zeros(ci, np.float32),) * 2
        want = np.asarray(conv_dw_cm(_jcm(xs), to_cm(jnp.asarray(dy)),
                                     jnp.asarray(s), jnp.asarray(t), H, W, D,
                                     prologue=pro, interpret=True))
        got = conv_stack.conv3x3x3_dw(
            _t(xs[0]), _t(dy), x2=_t(xs[1]) if len(xs) > 1 else None,
            prologue=(_t(s), _t(t)) if pro else None)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy().transpose(2, 3, 4, 1, 0),
                                   want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())

    def test_dw_split_covers_k(self):
        """The weight-gradient kernel's splits of K tile every K box once
        (dw_plan), within the kernel's block target."""
        for B, e, C1, C2, Co in ((10, 80, 8, 0, 32), (10, 80, 128, 64, 64),
                                 (10, 20, 512, 256, 256), (1, 5, 16, 0, 16)):
            p = conv_stack.dw_plan(B, e, e, e, C1, C2, Co)
            kb, n = p["kboxes"], p["nsplit"]
            assert (n - 1) * kb < p["nboxes"] <= n * kb
            xy, z = -(-e // 8), -(-e // 2)
            assert p["nboxes"] == B * xy * xy * z
            tiles = 3 * -(-Co // 64) * len(conv_stack.k_chunks(C1, C2))
            assert p["grid"] == (tiles // -(-Co // 64), -(-Co // 64), n)
            assert tiles * n <= max(conv_stack.DW_TARGET_BLOCKS, tiles)


class TestPoolBackward:
    def test_ties_split_evenly_exact(self):
        """Zeros (post-ReLU) and duplicated values tie inside windows;
        the cotangent is split evenly over the ties, as jax.vjp of the
        Pallas pool gives it, exactly in f32."""
        rng = np.random.default_rng(13)
        x = np.maximum(rng.normal(size=(B, D, H, 16, 8)), 0.0) \
            .astype(np.float32)
        x[:, :, ::2] = x[:, :, 1::2]  # duplicated rows: ties of 2 and 4
        g = rng.normal(size=(B, D // 2, H // 2, 8, 8)).astype(np.float32)
        cm = to_cm_t(jnp.asarray(x))
        _, vjp = jax.vjp(lambda a: maxpool2_flat(a, H, 16, True), cm.data)
        (dx,) = vjp(to_cm(jnp.asarray(g)))
        want = np.asarray(from_cm(dx, H, 16))
        got = pool.maxpool2_bwd(_t(x), _t(g)).numpy()
        np.testing.assert_array_equal(got, want)
        # ties really occur, and the autograd Function routes through it
        assert (np.abs(want) > 0).sum() > g.size
        xt = _t(x).requires_grad_()
        pool.MaxPool2.apply(xt).backward(_t(g))
        np.testing.assert_array_equal(xt.grad.numpy(), got)


class TestUpsampleBackward:
    def test_matches_vjp_of_upsample2x_cm(self, monkeypatch):
        """jax.vjp of upsample2x_cm with its Pallas depth pass (interpret)
        forced on, as on the TPU: the adjoint of all three passes."""
        import dram_tpu.core.pallas.upsample as up_mod
        from dram_tpu.core.pallas.cm import upsample2x_cm
        orig = up_mod.up2_depth_flat
        monkeypatch.setattr(up_mod, "up2_depth_supported",
                            lambda *a, **k: True)
        monkeypatch.setattr(up_mod, "up2_depth_flat",
                            lambda x: orig(x, True))
        rng = np.random.default_rng(14)
        x = rng.normal(size=(2, 5, 4, 6, 8)).astype(np.float32)
        g = rng.normal(size=(2, 10, 8, 12, 8)).astype(np.float32)
        cm = to_cm_t(jnp.asarray(x))
        _, vjp = jax.vjp(lambda d: upsample2x_cm(CM(d, 4, 6)).data, cm.data)
        (dx,) = vjp(to_cm(jnp.asarray(g)))
        want = np.asarray(from_cm(dx, 4, 6))
        got = upsample.upsample2x_bwd(_t(g)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        xt = _t(x).requires_grad_()
        upsample.Upsample2x.apply(xt).backward(_t(g))
        np.testing.assert_array_equal(xt.grad.numpy(), got)


class TestTrainBatchNorm:
    def test_matches_flax(self):
        """Batch statistics (biased variance), output and the momentum-0.9
        running update against flax nn.BatchNorm."""
        rng = np.random.default_rng(15)
        x = (rng.normal(size=(3, 4, 5, 6, 8)) * 2 + 1).astype(np.float32)
        g = rng.uniform(0.5, 1.5, 8).astype(np.float32)
        b = rng.normal(size=8).astype(np.float32)
        rm = rng.normal(size=8).astype(np.float32)
        rv = rng.uniform(0.5, 1.5, 8).astype(np.float32)
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5)
        v = {"params": {"scale": jnp.asarray(g), "bias": jnp.asarray(b)},
             "batch_stats": {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}}
        want, upd = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        m = BatchNorm(8).train()
        with torch.no_grad():
            m.weight.copy_(_t(g))
            m.bias.copy_(_t(b))
            m.running_mean.copy_(_t(rm))
            m.running_var.copy_(_t(rv))
        got = m(_t(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(m.running_mean.numpy(),
                                   np.asarray(upd["batch_stats"]["mean"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(m.running_var.numpy(),
                                   np.asarray(upd["batch_stats"]["var"]),
                                   rtol=1e-6, atol=1e-6)


def _bn(rng, c):
    return (rng.uniform(0.5, 1.5, c).astype(np.float32),
            (rng.normal(size=c) * 0.1).astype(np.float32),
            (rng.normal(size=c) * 0.05).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32))


class TestConvStackFunction:
    """ConvStack in train mode (ConvStackFunction) vs fused_cbr2 at
    train=True in interpret mode: output, running statistics and the
    gradients of input parts, weights and BN affines; 5e-3 is the bar of
    tests/test_fused_stack.py's gradient test. Depth 4 keeps the
    interpreted Pallas grid small."""

    @pytest.mark.parametrize("parts", [(16,), (8, 8), (1,)],
                             ids=["one_part", "two_parts", "ci1"])
    def test_grads_match_fused_cbr2(self, parts):
        rng = np.random.default_rng(16)
        xs = _parts(rng, parts, SD)
        ci, c0, c1 = sum(parts), 16, 8
        w0 = (rng.normal(size=(3, 3, 3, ci, c0)) * 0.2).astype(np.float32)
        w1 = (rng.normal(size=(3, 3, 3, c0, c1)) * 0.2).astype(np.float32)
        bn0, bn1 = _bn(rng, c0), _bn(rng, c1)
        cot = rng.normal(size=(B, SD, H, W, c1)).astype(np.float32)
        (g0, b0, m0, v0), (g1, b1, m1, v1) = bn0, bn1

        # JAX: the Ci=1 network entry is zero-padded to 8 channels
        # (models/blocks.py:235-242); its extra input gradients are dropped
        jxs = [np.pad(x, [(0, 0)] * 4 + [(0, 7)]) for x in xs] \
            if ci == 1 else xs
        jw0 = np.pad(w0, [(0, 0)] * 3 + [(0, 7), (0, 0)]) if ci == 1 else w0
        multi = len(parts) > 1

        def jloss(xa, w0_, g0_, b0_, w1_, g1_, b1_):
            x = tuple(CM(p, H, W) for p in xa) if multi else xa
            y, new = fused_cbr2(x, w0_, g0_, b0_, jnp.asarray(m0),
                                jnp.asarray(v0), w1_, g1_, b1_,
                                jnp.asarray(m1), jnp.asarray(v1),
                                train=True, interpret=True, cm_out=multi)
            return jnp.sum(as_ndhwc(y) * jnp.asarray(cot)), new

        xa = tuple(to_cm(jnp.asarray(x)) for x in jxs) if multi \
            else jnp.asarray(jxs[0])
        args = (xa, jnp.asarray(jw0), jnp.asarray(g0), jnp.asarray(b0),
                jnp.asarray(w1), jnp.asarray(g1), jnp.asarray(b1))
        (jl, jnew), jg = jax.value_and_grad(jloss, argnums=tuple(range(7)),
                                            has_aux=True)(*args)
        jdx = [np.asarray(from_cm(d, H, W)) for d in jg[0]] if multi \
            else [np.asarray(jg[0])[..., :ci]]

        m = ConvStack(ci, (c0, c1)).train()
        with torch.no_grad():
            m.conv_0.weight.copy_(_torch_w(w0))
            m.conv_1.weight.copy_(_torch_w(w1))
            for bn, (g, b, mu, var) in ((m.BatchNorm_0, bn0),
                                        (m.BatchNorm_1, bn1)):
                bn.weight.copy_(_t(g))
                bn.bias.copy_(_t(b))
                bn.running_mean.copy_(_t(mu))
                bn.running_var.copy_(_t(var))
        txs = [_t(x).requires_grad_() for x in xs]
        y = m(*txs)
        loss = (y * _t(cot)).sum()
        loss.backward()
        tol = dict(atol=5e-3, rtol=5e-3)
        assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-4,
                                                     abs=1e-4)
        for got, want in zip((m.BatchNorm_0.running_mean,
                              m.BatchNorm_0.running_var,
                              m.BatchNorm_1.running_mean,
                              m.BatchNorm_1.running_var), jnew):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
        for x, want in zip(txs, jdx):
            np.testing.assert_allclose(x.grad.numpy(), want, **tol)
        jw0g = np.asarray(jg[1])[:, :, :, :ci]
        for got, want in ((m.conv_0.weight.grad, jw0g),
                          (m.BatchNorm_0.weight.grad, jg[2]),
                          (m.BatchNorm_0.bias.grad, jg[3]),
                          (m.conv_1.weight.grad, jg[4]),
                          (m.BatchNorm_1.weight.grad, jg[5]),
                          (m.BatchNorm_1.bias.grad, jg[6])):
            want = np.asarray(want)
            if want.ndim == 5:
                want = want.transpose(4, 3, 0, 1, 2)
            np.testing.assert_allclose(got.numpy(), want, **tol)

    def test_entry_stack_stats_bf16(self):
        """The bf16 entry stack (Ci = 1) takes its batch statistics where
        JAX's does. JAX zero-pads the CT chunk to 8 channels and runs the
        whole fused stack (models/blocks.py:235-242), whose conv_cm sums
        the f32 accumulator before the bf16 rounding; its XLA first-conv
        variant, which sums the rounded output, serves no DC3D shape. The
        statistics of the rounded conv_0 output lie outside the tolerance,
        so the test sees the rounding point."""
        rng = np.random.default_rng(18)
        c0, c1 = 16, 8
        x = rng.normal(size=(B, SD, H, W, 1)).astype(np.float32)
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        w0 = (rng.normal(size=(3, 3, 3, 1, c0)) * 0.5).astype(np.float32)
        w1 = (rng.normal(size=(3, 3, 3, c0, c1)) * 0.1).astype(np.float32)
        zeros, ones = np.zeros(c0, np.float32), np.ones(c0, np.float32)
        _, (jm0, jv0, _, _) = fused_cbr2(
            jnp.asarray(np.pad(x, [(0, 0)] * 4 + [(0, 7)]), jnp.bfloat16),
            jnp.asarray(np.pad(w0, [(0, 0)] * 3 + [(0, 7), (0, 0)])),
            jnp.asarray(ones), jnp.asarray(zeros), jnp.asarray(zeros),
            jnp.asarray(ones), jnp.asarray(w1), jnp.ones(c1), jnp.zeros(c1),
            jnp.zeros(c1), jnp.ones(c1), train=True, interpret=True)
        # running r <- 0.9 r + 0.1 batch from r = (0, 1)
        jm0, jv0 = np.asarray(jm0) / 0.1, (np.asarray(jv0) - 0.9) / 0.1

        m = ConvStack(1, (c0, c1)).train()
        with torch.no_grad():
            m.conv_0.weight.copy_(_torch_w(w0))
            m.conv_1.weight.copy_(_torch_w(w1))
        m(_t(x).to(torch.bfloat16))
        bn = m.BatchNorm_0
        got_m, got_v = bn.running_mean / 0.1, (bn.running_var - 0.9) / 0.1
        out0, _ = conv_stack.conv3x3x3_train_plain(
            _t(x).to(torch.bfloat16), _torch_w(w0))
        _, rv = conv_stack.bn_batch_stats(torch.stack(
            [out0.float().sum((0, 1, 2, 3)),
             out0.float().square().sum((0, 1, 2, 3))]), out0[..., 0].numel())
        tol = dict(rtol=1e-5, atol=1e-5 * np.abs(jv0).max())
        np.testing.assert_allclose(got_m.numpy(), jm0, **tol)
        np.testing.assert_allclose(got_v.numpy(), jv0, **tol)
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(rv.numpy(), jv0, **tol)

    def test_entry_stack_skips_dx(self, monkeypatch):
        """An input that needs no gradient (the CT chunk) gets no dx conv;
        the decoder's two parts get theirs from one split launch."""
        calls = []
        orig = conv_stack.conv3x3x3_dx
        monkeypatch.setattr(conv_stack, "conv3x3x3_dx",
                            lambda *a, **k: calls.append(k) or orig(*a, **k))
        rng = np.random.default_rng(17)
        m = ConvStack(1, (8, 8)).train()
        x = _t(_parts(rng, (1,), SD)[0])
        m(x).sum().backward()
        assert len(calls) == 1 and x.grad is None
        m2 = ConvStack(16, (8, 8)).train()
        a, b = (_t(p).requires_grad_() for p in _parts(rng, (8, 8), SD))
        calls.clear()
        m2(a, b).sum().backward()
        assert len(calls) == 2 and calls[1]["split"] == (8, 8)
