"""Two whole TrainSteps of a narrow DC3DATGeneric against the JAX
package's train step in float64, shared by the port's slice tests
(tests/test_torch_port_attention_train.py, tests/test_torch_port_unfused.py).
Not a test module: the slice tests import it."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from dram_tpu.losses.refine import IntRegRefineLoss as JaxRefineLoss
from dram_tpu.models import DC3DATGeneric as JaxDC3DATGeneric

from dram_tpu_torch import weights
from dram_tpu_torch.configs import st_dram_ref_att as cfg
from dram_tpu_torch.data.synth import train_batch
from dram_tpu_torch.losses.refine import IntRegRefineLoss
from dram_tpu_torch.models import DC3DATGeneric
from dram_tpu_torch.train import trainer

# st_dram_ref's widths / 8, the flagship's attention at a 16^3 grid
NARROW = dict(n_layers=3, stacking=3, base_ch_list=(4, 8, 16, 32, 32, 16, 8),
              end_ch_list=(8, 16, 32, 64, 32, 16, 8))
AT = dict(at_spatial_size=(16, 16, 16), at_f_dim=8, at_g_dim=8,
          at_layers=(-1, 0, 1))


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def close(got, want, rtol, atol_frac, what):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol,
                                   atol=atol_frac * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"{what} {k}")


# The tap heads' 1x1x1 conv biases feed a train-mode BatchNorm, which
# subtracts the batch mean: their gradient is zero in exact arithmetic, and
# each side holds only its own rounding (f32 ~1e-11, float64 ~1e-19).
def zero_grad_key(k):
    return k.startswith("reshape_") and k.endswith("conv/bias")


def two_train_steps_match_jax(fused_stack=True):
    """The port's DC3DATGeneric (NARROW, AT, f32; its conv stacks fused or
    unfused) against JAX's DC3DATGeneric train step (XLA path,
    IntRegRefineLoss, LOSS_FACTORS, optax adam) in float64, for two
    steps: loss terms (rtol 1e-4), gradients, updated parameters and
    batch statistics (5e-3 of each tensor's largest value), the update
    itself (optax's adam on the port's gradients to 1e-6, JAX's update to
    5e-3 relative L2 per tensor), including attention_module and
    reshape_*. The tap heads' conv biases, whose gradient is zero in
    exact arithmetic, start non-zero here, and their gradients are held
    below 1e-6 of their conv weight's instead (so is their Adam step:
    below 5% of lr, since |g| << Adam's eps). On the CPU the JAX package
    runs its unfused stack with XLA convs (use_fused_stack =
    use_pallas_conv = False), in float64 the same function as both of
    the port's stacks."""
    batch = train_batch(1, batch=2, size=32)
    packed = trainer.pack_train_batch(batch)
    freq = batch["ctss_frequency"]
    factors = cfg.LOSS_FACTORS
    jm32 = JaxDC3DATGeneric(train=True, **NARROW, **AT)
    v = jax.jit(jm32.init)(jax.random.PRNGKey(0),
                           jnp.asarray(packed["images"][:1]))
    rng = np.random.default_rng(2)
    v = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        if zero_grad_key("/".join(p.key for p in path[1:]))
        else np.asarray(a), dict(v))
    model = weights.load_into(
        DC3DATGeneric(**NARROW, **AT, fused_stack=fused_stack), v["params"],
        v["batch_stats"])
    lr = cfg.OPTIMIZER["lr"]
    step = trainer.TrainStep(
        model, IntRegRefineLoss(band_width=1e-2, smoothing=0.1),
        trainer.adam(model.parameters(), lr=lr), factors)
    tb = trainer.batch_tensors(batch, torch.device("cpu"))

    with jax.enable_x64(True):
        f64 = jnp.float64
        jm = JaxDC3DATGeneric(train=True, dtype=f64, **NARROW, **AT)
        params, bs = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, f64), (v["params"],
                                            v["batch_stats"]))
        jloss = JaxRefineLoss(**{k: val for k, val in
                                 cfg.LOSS_FUNC.items() if k != "method"})
        tx = optax.adam(lr)
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
        ref_tx = optax.adam(lr)
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
            grads, _ = weights.to_jax({n: p.grad for n, p in
                                       model.named_parameters()})
            g, jgf = dict(flat(grads)), dict(flat(jg))
            assert set(g) == set(jgf)
            assert any(k.startswith("attention_module/") for k in g)
            for k in [k for k in jgf if zero_grad_key(k)]:
                wk = k[:-len("bias")] + "kernel"
                for side in (g, jgf):
                    assert np.abs(side[k]).max() <= \
                        1e-6 * np.abs(side[wk]).max(), f"step {it} {k}"
            close(g, {k: w for k, w in jgf.items()
                       if not zero_grad_key(k)}, 5e-3, 5e-3,
                   f"step {it} grad")
            for k, w in g.items():
                if not zero_grad_key(k):
                    assert np.abs(w).max() > 0, f"step {it} grad {k}"
            got_p, got_bs = weights.to_jax(model.state_dict())
            close(dict(flat(got_p)), dict(flat(params)), 5e-3, 5e-3,
                   f"step {it} param")
            upd, ref_state = ref_tx.update(grads, ref_state, tp0)
            close(dict(flat(got_p)),
                   dict(flat(optax.apply_updates(tp0, upd))), 1e-6,
                   1e-6, f"step {it} optax update")
            tu = dict(flat(jax.tree_util.tree_map(np.subtract, got_p,
                                                   tp0)))
            ju = dict(flat(jax.tree_util.tree_map(np.subtract, params,
                                                   jp0)))
            for k, w in ju.items():
                if zero_grad_key(k):
                    assert np.abs(tu[k]).max() <= 0.05 * lr, \
                        f"step {it} update {k}"
                    continue
                rel = np.linalg.norm(tu[k] - w) / np.linalg.norm(w)
                assert rel <= 5e-3, f"step {it} update {k}: {rel}"
            close(dict(flat(got_bs)), dict(flat(bs)), 5e-3, 5e-3,
                   f"step {it} batch_stats")
