"""The port's training slice vs the JAX package on the CPU: HeNorm's
distributions, the u16 wire, Adam, the settings, the weights round trip
and two whole TrainSteps of a narrow st_dram_ref DC3D (f32) against JAX's
DC3D train step (XLA path, IntRegRefineLoss, LOSS_FACTORS, optax adam, in
float64), from the same parameters and batch."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dram_tpu.losses.refine import IntRegRefineLoss as JaxRefineLoss
from dram_tpu.models import DC3D as JaxDC3D
from dram_tpu.train import trainer as jtrainer

from dram_tpu_torch import weights
from dram_tpu_torch.configs import get_callable_by_name
from dram_tpu_torch.configs import st_dram_ref as cfg
from dram_tpu_torch.data.synth import train_batch
from dram_tpu_torch.losses.refine import IntRegRefineLoss
from dram_tpu_torch.models import DC3D
from dram_tpu_torch.models.blocks import Dropout
from dram_tpu_torch.models.initializers import HeNorm
from dram_tpu_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# st_dram_ref's widths / 8
NARROW = dict(n_layers=3, stacking=3, base_ch_list=(4, 8, 16, 32, 32, 16, 8),
              end_ch_list=(8, 16, 32, 64, 32, 16, 8))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _close_trees(got, want, rtol, atol_frac, what):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol,
                                   atol=atol_frac * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what} {k}")


class TestSlice:
    def test_two_train_steps_match_jax(self):
        """Loss terms (rtol 1e-4), gradients, updated parameters, the
        update itself (new minus old parameters) and batch statistics
        (5e-3, relative to each tensor's largest value) after each of two
        steps. The JAX side runs in float64 (x64 on for
        this test only): its f32 XLA reductions sum in order, and on the
        clipped (constant) regions of windowed CT their error reaches
        several percent in the deep layers' gradients, where the port's f32
        step stays within 1e-4 of the float64 result."""
        batch = train_batch(1, batch=2, size=32)
        packed = trainer.pack_train_batch(batch)
        freq = batch["ctss_frequency"]
        factors = cfg.LOSS_FACTORS
        jm32 = JaxDC3D(train=True, **NARROW)
        v = jax.jit(jm32.init)(jax.random.PRNGKey(0),
                               jnp.asarray(packed["images"][:1]))
        model = weights.load_into(DC3D(**NARROW), v["params"],
                                  v["batch_stats"])
        step = trainer.TrainStep(
            model, IntRegRefineLoss(band_width=1e-2, smoothing=0.1),
            trainer.adam(model.parameters(), lr=1e-4), factors)
        tb = trainer.batch_tensors(batch, torch.device("cpu"))

        with jax.enable_x64(True):
            f64 = jnp.float64
            jm = JaxDC3D(train=True, dtype=f64, **NARROW)
            params, bs = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, f64), (v["params"],
                                                v["batch_stats"]))
            jloss = JaxRefineLoss(**{k: val for k, val in
                                     cfg.LOSS_FUNC.items() if k != "method"})
            tx = optax.adam(1e-4)
            opt_state = tx.init(params)

            @jax.jit
            def jstep(params, bs, opt_state, images, lobes, lesions, ctss):
                def loss_fn(p):
                    carry = {"bs": bs}

                    def model_fn(im, lo):
                        out, mut = jm.apply({"params": p, "batch_stats":
                                             carry["bs"]}, im, lo,
                                            mutable=["batch_stats"])
                        carry["bs"] = mut["batch_stats"]
                        return out
                    losses = jloss(model_fn, images, lobes, lesions, ctss,
                                   ctss_frequency=jnp.asarray(freq, f64),
                                   sample_weight=jnp.ones(images.shape[0],
                                                          f64))
                    total = sum(l * f for l, f in zip(losses, factors))
                    return total, (jnp.stack(losses), carry["bs"])
                (_, (losses, new_bs)), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(params)
                updates, new_opt = tx.update(grads, opt_state, params)
                return (optax.apply_updates(params, updates), new_bs,
                        new_opt, losses, grads)

            jargs = [jnp.asarray(packed[k], f64) for k in
                     ("images", "lobes", "lesions")]
            jargs.append(jnp.asarray(packed["ctss"]))
            ref_tx = optax.adam(1e-4)
            ref_state = ref_tx.init(weights.to_jax(
                {n: p.detach() for n, p in model.named_parameters()})[0])
            for it in range(2):
                jp0 = params
                tp0, _ = weights.to_jax({n: p.detach().clone() for n, p in
                                         model.named_parameters()})
                params, bs, opt_state, jl, jg = jstep(params, bs, opt_state,
                                                      *jargs)
                out = step(**tb)
                np.testing.assert_allclose(out["losses"].numpy(),
                                           np.asarray(jl), rtol=1e-4,
                                           err_msg=f"step {it}")
                assert np.isfinite(out["loss"].item())
                grads, _ = weights.to_jax({n: p.grad for n, p in
                                           model.named_parameters()})
                _close_trees(grads, jg, 5e-3, 5e-3, f"step {it} grad")
                got_p, got_bs = weights.to_jax(model.state_dict())
                _close_trees(got_p, params, 5e-3, 5e-3, f"step {it} param")
                # the update itself, which a step of ~lr hides in the
                # parameters: exactly optax's adam on the port's own
                # gradients, and JAX's update within 5e-3 in relative L2
                # per tensor (elementwise, adam's lr * g / (|g| + eps)
                # turns the gradients' f32 error at |g| ~ 1e-7 into a few
                # percent of that element's step)
                upd, ref_state = ref_tx.update(grads, ref_state, tp0)
                _close_trees(got_p, optax.apply_updates(tp0, upd), 1e-6,
                             1e-6, f"step {it} optax update")
                tu = dict(_flat(jax.tree_util.tree_map(np.subtract, got_p,
                                                       tp0)))
                ju = dict(_flat(jax.tree_util.tree_map(np.subtract, params,
                                                       jp0)))
                for k, w in ju.items():
                    rel = np.linalg.norm(tu[k] - w) / np.linalg.norm(w)
                    assert rel <= 5e-3, f"step {it} update {k}: {rel}"
                _close_trees(got_bs, bs, 5e-3, 5e-3,
                             f"step {it} batch_stats")

    def test_train_steps_entry_point(self):
        """train_steps builds everything from the port's settings (here
        with narrow widths) and runs on the CPU when asked to."""
        class Narrow:
            pass
        s = Narrow()
        for k in dir(cfg):
            if k.isupper():
                setattr(s, k, getattr(cfg, k))
        s.MODEL = dict(cfg.MODEL, base_ch_list=list(NARROW["base_ch_list"]),
                       end_ch_list=list(NARROW["end_ch_list"]))
        s.COMPUTE_DTYPE = "float32"
        seen = []
        out = trainer.train_steps(s, 2, [train_batch(2, 2, 16)],
                                  device="cpu",
                                  on_step=lambda i, st, r: seen.append(i))
        assert seen == [0, 1] and len(out["losses"]) == 2
        assert next(out["step"].model.parameters()).dtype == torch.float32
        assert all(np.isfinite(out["loss"]))
        assert set(out["ms"][0]) == {"forward", "backward", "optimizer"}
        # dropout is ported: the step builds, its model has the Dropouts
        s.MODEL = dict(s.MODEL, dropout=0.5)
        step = trainer.build_train_step(s, "cpu")
        assert any(isinstance(m, Dropout) for m in step.model.modules())


class TestInit:
    def test_henorm_distributions(self):
        """Conv kernels N(0, 2 / fan_in), the top layer's truncated
        lecun normal and unit/zero BatchNorm, as JAX's module inits draw
        them: compared in distribution (other random bits)."""
        widths = dict(base_ch_list=(8, 16, 32, 64, 64, 32, 16),
                      end_ch_list=(16, 32, 64, 128, 64, 32, 64))
        m = HeNorm("fan_in")(DC3D(n_layers=3, stacking=3, **widths),
                             torch.Generator().manual_seed(0))
        jv = jax.jit(JaxDC3D(train=True, n_layers=3, stacking=3,
                             **widths).init)(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 8, 8, 8, 1)))
        jp = dict(_flat(jv["params"]))
        got = dict(_flat(weights.to_jax(m.state_dict())[0]))
        assert set(got) == set(jp)
        for k, w in got.items():
            if k.endswith("conv_0/kernel") or k.endswith("conv_1/kernel"):
                std = np.sqrt(2.0 / np.prod(w.shape[:4]))
                assert abs(w.std() / std - 1) < 0.1, k
                assert abs(jp[k].std() / std - 1) < 0.1, k
                assert abs(w.mean()) < 5 * std / np.sqrt(w.size), k
            elif k == "top_layer/kernel":
                std = np.sqrt(1.0 / w.shape[3])
                assert np.abs(w).max() <= 2 * std / 0.8796 + 1e-6
                assert abs(w.std() / std - 1) < 0.3
            elif k.endswith("scale"):
                np.testing.assert_array_equal(w, 1.0)
            else:  # BN shift and the top layer's bias
                np.testing.assert_array_equal(w, 0.0)
        bs = dict(_flat(weights.to_jax(m.state_dict())[1]))
        for k, w in bs.items():
            np.testing.assert_array_equal(w, 1.0 if k.endswith("var")
                                          else 0.0)

    def test_henorm_is_seeded(self):
        a = HeNorm()(DC3D(**NARROW), torch.Generator().manual_seed(3))
        b = HeNorm()(DC3D(**NARROW), torch.Generator().manual_seed(3))
        for (n, x), (_, y) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
            assert torch.equal(x, y), n


class TestWireAndOptimizer:
    def test_u16_wire_round_trip_exact(self):
        batch = train_batch(4, batch=3, size=8)
        want = jtrainer.pack_train_batch(batch, "u16")
        got = trainer.pack_train_batch(batch, "u16")
        for k in ("images", "span", "lobes", "lesions", "ctss"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
        assert got["images"].dtype == np.uint16
        jim = np.asarray(jtrainer.unpack_image_wire(
            jnp.asarray(want["images"]), jnp.asarray(want["span"])))
        tim = trainer.unpack_image_wire(torch.from_numpy(got["images"]),
                                        torch.from_numpy(got["span"]))
        np.testing.assert_array_equal(tim.numpy(), jim)
        np.testing.assert_allclose(tim.numpy()[..., 0], batch["#image"],
                                   atol=1.0 / 65535)

    def test_adam_is_optax_adam(self):
        """torch.optim.Adam's update is optax.adam's formula: three steps
        on the same parameters and gradients."""
        rng = np.random.default_rng(5)
        p0 = rng.normal(size=(4, 7)).astype(np.float32)
        grads = [rng.normal(size=(4, 7)).astype(np.float32) * 10 ** -k
                 for k in range(3)]
        tx = optax.adam(1e-4)
        jp = jnp.asarray(p0)
        st = tx.init(jp)
        tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt = trainer.adam([tp], lr=1e-4)
        for g in grads:
            upd, st = tx.update(jnp.asarray(g), st, jp)
            jp = optax.apply_updates(jp, upd)
            tp.grad = torch.from_numpy(g)
            opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-9)

    def test_exponential_lr(self):
        s = trainer.ExponentialLR(1e-4, gamma=0.9)
        s.step()
        s.step()
        p = torch.nn.Parameter(torch.zeros(2))
        opt = trainer.adam([p])
        s.apply(opt)
        assert opt.param_groups[0]["lr"] == pytest.approx(1e-4 * 0.81)
        j = jtrainer.ExponentialLR(1e-4, 0.9)
        j.step()
        j.step()
        assert j.lr == pytest.approx(s.lr)

    def test_unported_options_raise(self):
        """Weight decay (optax's adamw) and HeNorm's fan_out mode are
        ported: adam with weight_decay is torch's AdamW, HeNorm takes any
        mode; an unknown MODEL key raises TypeError, as flax does."""
        p = torch.nn.Parameter(torch.zeros(2))
        assert isinstance(trainer.adam([p], weight_decay=1e-4),
                          torch.optim.AdamW)
        assert HeNorm("fan_out").mode == "fan_out"

        class S:
            MODEL = dict(cfg.MODEL, no_such_option=1)
        with pytest.raises(TypeError):
            trainer.build_model(S, torch.float32)


class TestSettings:
    def test_copy_of_the_jax_config(self):
        """The port's st_dram_ref holds the JAX package's values for
        everything the step reads."""
        spec = importlib.util.spec_from_file_location(
            "jax_st_dram_ref",
            os.path.join(REPO, "dram_tpu", "configs", "st_dram_ref.py"))
        ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref)
        for k in ("MODEL", "RESAMPLE_SIZE", "TRAIN_BATCH_SIZE", "LOSS_FUNC",
                  "LOSS_FACTORS", "OPTIMIZER", "SCHEDULER", "INITIALIZER",
                  "WINDOWING_MIN", "WINDOWING_MAX", "EXP_NAME"):
            assert getattr(cfg, k) == getattr(ref, k), k
        assert cfg.RANDOM_SEED == getattr(ref, "RANDOM_SEED", 33)

    def test_methods_resolve_inside_the_port(self):
        for sect in ("MODEL", "INITIALIZER", "OPTIMIZER", "SCHEDULER",
                     "LOSS_FUNC"):
            fn = get_callable_by_name(getattr(cfg, sect)["method"])
            assert fn.__module__.startswith("dram_tpu_torch."), sect
        with pytest.raises(KeyError):
            get_callable_by_name("dram_tpu.models.DC3D")

    def test_train_batch(self):
        a, b = train_batch(7, 2, 16), train_batch(7, 2, 16)
        np.testing.assert_array_equal(a["#image"], b["#image"])
        assert a["#image"].shape == (2, 16, 16, 16)
        assert 0.0 <= a["#image"].min() and a["#image"].max() <= 1.0
        assert set(np.unique(a["#lobe_reference"])) == {0, 1}
        assert not (a["#lesion_reference"] & (a["#lobe_reference"] == 0)).any()
        assert a["ctss_frequency"].shape == (6,)


class TestWeights:
    def test_to_jax_inverts_from_jax(self):
        rng = np.random.default_rng(8)
        jv = jax.jit(JaxDC3D(train=False, **NARROW).init)(
            jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 8, 1)))
        params = jax.tree_util.tree_map(
            lambda a: rng.normal(size=a.shape).astype(np.float32),
            jv["params"])
        bs = jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
            jv["batch_stats"])
        p2, b2 = weights.to_jax(weights.from_jax(params, bs))
        _close_trees(p2, params, 0, 0, "params")
        _close_trees(b2, bs, 0, 0, "batch_stats")

    def test_load_backbone(self):
        m = weights.load_backbone(DC3D(n_layers=3, stacking=3))
        params, bs = weights.load_bench_weights()
        got_p, got_bs = weights.to_jax(m.state_dict())
        _close_trees(got_p, params["backbone"], 0, 0, "params")
        _close_trees(got_bs, bs["backbone"], 0, 0, "batch_stats")
