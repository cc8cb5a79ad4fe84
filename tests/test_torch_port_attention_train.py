"""The port's flagship training slice vs the JAX package on the CPU: the
stencil attention's backward (statistics and gradient passes) against
jax.vjp of dram_tpu's Pallas kernel in interpret mode and its XLA twin,
StencilAttentionFunction against torch autograd of the plain forward,
the PCM's gradients against jax.grad of dram_tpu's PCM, two whole
TrainSteps of a narrow DC3DATGeneric against JAX's train step in float64,
and the port's st_dram_ref_att settings against the JAX config's."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port_slice import NARROW
from _torch_port_slice import flat as _flat
from _torch_port_slice import two_train_steps_match_jax

from dram_tpu.core.pallas.window_attention import stencil_attention as jax_att
from dram_tpu.models.pcm import PCM as JaxPCM
from dram_tpu.models.pcm import _masked_softmax, _shift, _valid_masks
from dram_tpu.models.pcm import stencil_offsets as jax_offsets

from dram_tpu_torch import weights
from dram_tpu_torch.configs import get_callable_by_name
from dram_tpu_torch.configs import st_dram_ref_att as cfg
from dram_tpu_torch.data.synth import train_batch
from dram_tpu_torch.kernels import window_attention as wa
from dram_tpu_torch.models import DC3DATGeneric
from dram_tpu_torch.models.pcm import PCM
from dram_tpu_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# f32 on the port's side against f32 (Pallas interpret, XLA twin) on
# JAX's: summation order and exp rounding only, ~1e-6 of O(1) values
ATT_RTOL, ATT_ATOL = 1e-5, 2e-5


def _att_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape + (8,)).astype(np.float32)
            for _ in range(4)]


class TestAttentionBackward:
    @pytest.mark.parametrize("shape", [(2, 4, 8, 8), (1, 6, 4, 8)])
    def test_bwd_plain_matches_pallas_vjp(self, shape):
        """(dtheta, dphi, dg) of the plain statistics + gradient passes
        against jax.vjp of dram_tpu's stencil_attention (its Pallas
        _scal_kernel and _bwd_kernel in interpret mode). At 4-8 voxels a
        side most voxels lie on a face, where the -o side's validity is
        i's own."""
        theta, phi, g, ybar = _att_inputs(shape, 11)
        offs = jax_offsets(3, 2, False)
        _, vjp = jax.vjp(lambda t, p, c: jax_att(t, p, c, offs, 4, True),
                         *(jnp.asarray(a) for a in (theta, phi, g)))
        want = vjp(jnp.asarray(ybar))
        t = [torch.from_numpy(a) for a in (theta, phi, g, ybar)]
        scal = wa.stencil_attention_scal_plain(*t)
        got = wa.stencil_attention_bwd_plain(*t, scal)
        for name, a, b in zip(("dtheta", "dphi", "dg"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=ATT_RTOL, atol=ATT_ATOL,
                                       err_msg=name)

    def test_scal_plain_matches_xla_twin(self):
        """[r, m, denom, c] against the same statistics computed from the
        JAX package's XLA attention math (models/pcm.py roll + mask)."""
        theta, phi, g, ybar = _att_inputs((2, 4, 8, 8), 12)
        offs = jax_offsets(3, 2, False)
        valid = _valid_masks((4, 8, 8), offs)
        deg = valid.sum(-1).astype(jnp.float32)
        dots = jnp.stack([jnp.sum(theta * _shift(jnp.asarray(phi), o), -1)
                          for o in offs], -1)
        logits = jax.nn.relu(dots) / jnp.sqrt(jnp.maximum(deg, 1.0))[..., None]
        m = jnp.maximum(jnp.max(jnp.where(valid, logits, 0.0), -1), 0.0)
        denom = jnp.sum(jnp.exp(logits - m[..., None]) * valid, -1)
        a = _masked_softmax(logits, valid[None])
        u = jnp.stack([jnp.sum(ybar * _shift(jnp.asarray(g), o), -1)
                       for o in offs], -1)
        want = [jnp.broadcast_to(jax.lax.rsqrt(jnp.maximum(deg, 1.0)),
                                 m.shape), m, denom, jnp.sum(a * u, -1)]
        got = wa.stencil_attention_scal_plain(
            *(torch.from_numpy(x) for x in (theta, phi, g, ybar)))
        assert got.shape == (2, 4, 8, 8, 4)
        for k, name in enumerate(("r", "m", "denom", "c")):
            np.testing.assert_allclose(got[..., k].numpy(),
                                       np.asarray(want[k]), rtol=ATT_RTOL,
                                       atol=ATT_ATOL, err_msg=name)

    @pytest.mark.parametrize("stencil", [(3, 2, False), (3, 1, True)])
    def test_function_matches_autograd_of_plain(self, stencil):
        """StencilAttentionFunction on CPU tensors (the plain forward,
        statistics and gradient passes) against torch autograd through
        stencil_attention_plain, with the same cotangent: the Function's
        wiring, for the kernel's stencil and a self-loop one."""
        offs = wa.stencil_offsets(*stencil)
        theta, phi, g, ybar = (torch.from_numpy(a) for a in
                               _att_inputs((2, 5, 6, 7), 13))
        leaves = [t.clone().requires_grad_() for t in (theta, phi, g)]
        want = torch.autograd.grad(wa.stencil_attention_plain(*leaves, offs),
                                   leaves, ybar)
        leaves2 = [t.clone().requires_grad_() for t in (theta, phi, g)]
        out = wa.stencil_attention(*leaves2, offs)
        np.testing.assert_array_equal(
            out.detach().numpy(),
            wa.stencil_attention_plain(theta, phi, g, offs).numpy())
        got = torch.autograd.grad(out, leaves2, ybar)
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-6 * b.abs().max().item())


class TestPCMGradients:
    def test_pcm_grads_match_jax_float64(self):
        """Parameter and input gradients of the port's PCM (f32, the
        attention through StencilAttentionFunction) against jax.grad of
        dram_tpu's PCM (XLA path) in float64, on a loss sum(out * w):
        within 1e-5 of each tensor's largest value (f32 against float64
        on O(1) values)."""
        rng = np.random.default_rng(14)
        shape = (2, 6, 8, 8)
        cam = rng.normal(size=shape + (1,))
        f = rng.normal(size=shape + (17,))
        wout = rng.normal(size=shape + (1,))
        jm = JaxPCM(pool_size=shape[1:], g_ch=1, f_dim=8, g_dim=8,
                    merge_type="scaled_dot_product_relu", self_loop=False,
                    connectivity=2, p_enc_dim=0)
        params = jax.jit(jm.init)(jax.random.PRNGKey(3),
                                  jnp.asarray(cam, jnp.float32),
                                  jnp.asarray(f, jnp.float32))["params"]
        with jax.enable_x64(True):
            f64 = jnp.float64
            jm64 = jm.clone(dtype=f64)
            p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, f64),
                                         params)

            def jloss(p, c, x):
                return jnp.sum(jm64.apply({"params": p}, c, x) * wout)
            jg, jgc, jgf = jax.grad(jloss, argnums=(0, 1, 2))(
                p64, jnp.asarray(cam), jnp.asarray(f))
        m = weights.load_into(PCM(in_ch=17, g_ch=1, f_dim=8, g_dim=8),
                              params, {})
        tc = torch.tensor(cam, dtype=torch.float32, requires_grad=True)
        tf = torch.tensor(f, dtype=torch.float32, requires_grad=True)
        (m(tc, tf) * torch.from_numpy(wout).float()).sum().backward()
        got = dict(_flat(weights.to_jax(
            {n: p.grad for n, p in m.named_parameters()})[0]))
        want = dict(_flat(jg))
        assert set(got) == set(want) == {f"{d}/{k}" for d in
                                         ("theta", "phi", "G", "r")
                                         for k in ("kernel", "bias")}
        for k, w in [*want.items(), ("cam", jgc), ("f", jgf)]:
            a = {"cam": tc.grad, "f": tf.grad}[k].numpy() if k in \
                ("cam", "f") else got[k]
            w = np.asarray(w)
            assert np.abs(w).max() > 0, k
            np.testing.assert_allclose(a, w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=k)


class TestSlice:
    def test_two_train_steps_match_jax(self):
        """Two whole TrainSteps of a narrow DC3DATGeneric (f32; the attention
        through StencilAttentionFunction, the taps detached) against JAX's
        DC3DATGeneric train step in float64, as
        tests/test_torch_port_train.py::TestSlice holds the DC3D
        (_torch_port_slice.two_train_steps_match_jax gives the checks).

        The batch is TestSlice's (window -1000..-300 HU). At the flagship's
        -700 HU window three quarters of each chunk clip to one constant,
        and the backbone's gradient becomes ill-conditioned in f32: with a
        random cotangent on the dense head, JAX's own f32 step is ~60% off
        its float64 one and the port's f32 step 0.6-1.2%, so no f32
        implementation holds 5e-3 there."""
        two_train_steps_match_jax(fused_stack=True)

    def test_train_steps_entry_point(self):
        """train_steps builds DC3DATGeneric from the port's st_dram_ref_att
        (here with narrow widths and a 16^3 attention grid, f32) and trains
        on the CPU when asked to: the PCM's and the tap heads' parameters
        get non-zero gradients."""
        class Narrow:
            pass
        s = Narrow()
        for k in dir(cfg):
            if k.isupper():
                setattr(s, k, getattr(cfg, k))
        s.MODEL = dict(cfg.MODEL, base_ch_list=list(NARROW["base_ch_list"]),
                       end_ch_list=list(NARROW["end_ch_list"]),
                       at_spatial_size=(16, 16, 16))
        s.COMPUTE_DTYPE = "float32"
        seen = {}

        def on_step(i, st, r):
            if i == 0:
                seen.update({n: p.grad.abs().max().item()
                             for n, p in st.model.named_parameters()})
        out = trainer.train_steps(s, 2, [train_batch(2, 2, 16,
                                                     (-1000, -700))],
                                  device="cpu", on_step=on_step)
        assert isinstance(out["step"].model, DC3DATGeneric)
        assert len(out["losses"]) == 2 and all(np.isfinite(out["loss"]))
        heads = [n for n in seen if n.startswith(("attention_module.",
                                                  "reshape_"))]
        assert len(heads) == 16
        for n in heads:
            if not (n.startswith("reshape_") and n.endswith("conv.bias")):
                assert seen[n] > 0, n


class TestSettings:
    def test_copy_of_the_jax_config(self):
        """The port's st_dram_ref_att holds the JAX package's values for
        everything the step reads."""
        spec = importlib.util.spec_from_file_location(
            "jax_st_dram_ref_att",
            os.path.join(REPO, "dram_tpu", "configs", "st_dram_ref_att.py"))
        ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref)
        for k in ("MODEL", "RESAMPLE_SIZE", "TRAIN_BATCH_SIZE", "LOSS_FUNC",
                  "LOSS_FACTORS", "OPTIMIZER", "SCHEDULER", "INITIALIZER",
                  "WINDOWING_MIN", "WINDOWING_MAX", "EXP_NAME", "MODEL_NAME",
                  "NR_CLASS"):
            assert getattr(cfg, k) == getattr(ref, k), k
        assert cfg.COMPUTE_DTYPE == os.environ.get("DRAM_COMPUTE_DTYPE",
                                                   "bfloat16")
        assert cfg.RANDOM_SEED == getattr(ref, "RANDOM_SEED", 33)

    def test_build_model(self):
        """build_model makes the flagship DC3DATGeneric at its published
        widths (the flax tree of the trained weights), and raises on the
        options the port does not have."""
        m = trainer.build_model(cfg, torch.bfloat16)
        assert isinstance(m, DC3DATGeneric)
        assert get_callable_by_name(cfg.MODEL["method"]) is DC3DATGeneric
        params, bs = weights.load_bench_weights()
        want = {k for k, _ in _flat(params)} | {k for k, _ in _flat(bs)}
        got = {k for k, _ in _flat(weights.to_jax(m.state_dict())[0])} | \
            {k for k, _ in _flat(weights.to_jax(m.state_dict())[1])}
        assert got == want
        assert m.attention_module.offsets == wa.KERNEL_OFFSETS
        for change in ({"at_merge_type": "l2"}, {"at_geo_f_dim": 4},
                       {"dropout": 0.1}):
            class S:
                MODEL = dict(cfg.MODEL, **change)
            with pytest.raises(NotImplementedError):
                trainer.build_model(S, torch.float32)
