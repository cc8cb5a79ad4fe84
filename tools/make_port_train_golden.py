#!/usr/bin/env python3
"""Make the flagship training-step golden that the port is held against.

    python3 tools/make_port_train_golden.py

Runs one training step of the JAX package's flagship DC3DATGeneric on the
CPU in float64: the published widths of configs/st_dram_ref_att.py
(taps (-1, 0, 1), PCM at 64^3, at_f_dim = at_g_dim = 8), the whole trained
tree of assets/bench_weights.ckpt.xz, IntRegRefineLoss with LOSS_FACTORS
and optax's adam at the configured rate, on the port's synthetic batch
(dram_tpu_torch.golden.train_golden_batch: data/synth.py:train_batch,
2 x 48^3 at the -1000..-300 HU window, where the f32 gradient is well
conditioned). On the CPU the JAX package runs its unfused stack with XLA
convs, in float64 the same function as both of the port's stacks.

Writes dram_tpu_torch/golden/flagship_train.npz (compressed): the batch's
SHA-256, the loss terms and their weighted total, and per port-named
tensor (dram_tpu_torch.golden.summarize): the gradient's L2 norm and
seeded projections, the projections of the Adam update and the BatchNorm
batch statistics of the step. This tool imports the JAX package;
dram_tpu_torch and chip_smoke.py do not.
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dram_tpu.losses.refine import IntRegRefineLoss  # noqa: E402
from dram_tpu.models import DC3DATGeneric  # noqa: E402

from dram_tpu_torch import golden, weights  # noqa: E402
from dram_tpu_torch.configs import st_dram_ref_att as cfg  # noqa: E402
from dram_tpu_torch.train import trainer  # noqa: E402

AT = ("at_spatial_size", "at_f_dim", "at_g_dim", "at_layers")


def jax_step(batch, params, batch_stats):
    """(losses, grads, new params, new batch_stats) of one float64 step."""
    f64 = jnp.float64
    m = cfg.MODEL
    model = DC3DATGeneric(
        train=True, dtype=f64, n_layers=m["n_layers"],
        base_ch_list=tuple(m["base_ch_list"]),
        end_ch_list=tuple(m["end_ch_list"]), stacking=m["stacking"],
        **{k: tuple(m[k]) if isinstance(m[k], list) else m[k] for k in AT})
    loss = IntRegRefineLoss(**{k: v for k, v in cfg.LOSS_FUNC.items()
                               if k != "method"})
    tx = optax.adam(cfg.OPTIMIZER["lr"])
    packed = trainer.pack_train_batch(batch)
    freq = jnp.asarray(batch["ctss_frequency"], f64)

    @jax.jit
    def step(params, bs, images, lobes, lesions, ctss):
        def loss_fn(p):
            carry = {"bs": bs}

            def model_fn(im, lo):
                out, mut = model.apply({"params": p, "batch_stats":
                                        carry["bs"]}, im, lo,
                                       mutable=["batch_stats"])
                carry["bs"] = mut["batch_stats"]
                return out
            terms = loss(model_fn, images, lobes, lesions, ctss,
                         ctss_frequency=freq,
                         sample_weight=jnp.ones(images.shape[0], f64))
            total = sum(t * f for t, f in zip(terms, cfg.LOSS_FACTORS))
            return total, (jnp.stack(terms), carry["bs"])
        (total, (terms, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return terms, total, grads, optax.apply_updates(params, updates), \
            new_bs

    to64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, f64), t)
    args = [jnp.asarray(packed[k], f64) for k in ("images", "lobes",
                                                  "lesions")]
    args.append(jnp.asarray(packed["ctss"]))
    out = step(to64(params), to64(batch_stats), *args)
    return jax.tree_util.tree_map(np.asarray, out)


def main():
    t0 = time.perf_counter()
    batch = golden.train_golden_batch()
    params, batch_stats = weights.load_bench_weights()
    terms, total, grads, new_params, new_bs = jax_step(batch, params,
                                                       batch_stats)
    t1 = time.perf_counter()
    port = lambda p, b: {n: t.numpy() for n, t in  # noqa: E731
                         weights.from_jax(p, b).items()}
    initial = port(params, batch_stats)
    after = port(new_params, new_bs)
    stats = {n for n in after if n.endswith(("running_mean",
                                             "running_var"))}
    fields = golden.summarize(
        port(grads, {}), {n: after[n] for n in stats}, initial,
        {n: a for n, a in after.items() if n not in stats}, initial)
    np.savez_compressed(
        golden.TRAIN_GOLDEN, **fields,
        losses=np.asarray(terms, np.float64), total=np.float64(total),
        batch_sha256=np.array(golden.batch_sha256(batch)),
        batch=np.array([golden.TRAIN_SEED, golden.TRAIN_BATCH,
                        golden.TRAIN_SIZE]),
        jax_version=np.array(jax.__version__))
    print(f"wrote {os.path.relpath(golden.TRAIN_GOLDEN, ROOT)} "
          f"({os.path.getsize(golden.TRAIN_GOLDEN)} bytes): loss terms "
          f"{np.asarray(terms).tolist()}, total {float(total):.9g}, "
          f"{sum(k.startswith('grad_norm/') for k in fields)} parameter "
          f"tensors, {len(stats)} BN statistics; JAX step "
          f"{t1 - t0:.1f} s, all {time.perf_counter() - t0:.1f} s on "
          f"{os.cpu_count()} CPU cores")


if __name__ == "__main__":
    main()
