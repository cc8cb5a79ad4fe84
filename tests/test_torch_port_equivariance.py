"""The port's equivariance losses against dram_tpu's on the CPU: every
flip and quarter-turn variant, the one-shot rescale (half-pixel
trilinear and nearest), the rotation about x, the host's rescale draw,
IntRegAffLoss and IntRegAffRefineLoss values and gradients on a narrow
DC3DATGeneric under one transform (dram_tpu's decisions given to the
port), and the port's own draws' distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dram_tpu.losses import equivariance as jeq
from dram_tpu.models import DC3DATGeneric as JaxDC3DATGeneric

from dram_tpu_torch import weights
from dram_tpu_torch.data.synth import train_batch
from dram_tpu_torch.losses import equivariance as eq
from dram_tpu_torch.models import DC3DATGeneric
from dram_tpu_torch.train import trainer


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# Cases of a test are looped inside it: pytest-xdist's loadfile order
# puts files with more test items first, and a file of fewer items than
# tests/test_mesh.py (13) starts after that long file, not before it.


def test_flip_variants_match_jax():
    x = _x((2, 3, 4, 5, 2))
    for variant in range(len(eq.FLIP_VARIANTS)):
        np.testing.assert_array_equal(
            eq.flip3d_oneshot(torch.from_numpy(x), variant).numpy(),
            jeq.flip3d_oneshot(jnp.asarray(x), variant), err_msg=variant)


def test_rot90_variants_match_jax():
    x = _x((2, 4, 4, 4, 2))
    for variant in range(len(eq.ROT_VARIANTS)):
        np.testing.assert_array_equal(
            eq.rot903d_oneshot(torch.from_numpy(x), variant).numpy(),
            jeq.rot903d_oneshot(jnp.asarray(x), variant), err_msg=variant)


def test_shape_preserving_rot_variants_match_jax():
    for spatial in ((4, 4, 4), (4, 6, 4), (3, 5, 7), (6, 4, 4)):
        assert eq.shape_preserving_rot_variants(spatial) == \
            jeq._shape_preserving_rot_variants(spatial)


def test_rescale_matches_jax():
    """Half-pixel trilinear (images) and torch's nearest (references),
    up and down, against dram_tpu's rescale3d_oneshot."""
    for is_reference in (False, True):
        x = _x((2, 6, 8, 5, 1))
        if is_reference:
            x = (x > 0).astype(np.float32)
        for size in ((9, 4, 7), (3, 12, 5)):
            np.testing.assert_allclose(
                eq.rescale3d_oneshot(torch.from_numpy(x), size,
                                     is_reference).numpy(),
                jeq.rescale3d_oneshot(jnp.asarray(x), size, is_reference),
                rtol=1e-6, atol=1e-6)


def test_rotate_x_matches_jax():
    """Order-1 resampling at the rotated coordinates, zeros outside, as
    dram_tpu's map_coordinates(order=1, mode='constant')."""
    x = _x((2, 6, 7, 5, 2))
    for theta in (0.3, -1.2):
        np.testing.assert_allclose(
            eq.rotate3d_x_oneshot(torch.from_numpy(x), theta).numpy(),
            jeq.rotate3d_x_oneshot(jnp.asarray(x), theta), rtol=1e-5,
            atol=1e-5)


def test_rescale_draw_matches_jax():
    pool = [64, 80, 96]
    for seed in range(100):
        assert eq.draw_rescale_static(seed, pool) == \
            jeq.draw_rescale_static(seed, pool)
    assert eq.draw_rescale_static(3, None) is None


# a one-level DC3DATGeneric on 16^3 chunks, rescale sizes that halve
TINY = dict(n_layers=1, base_ch_list=(4, 8, 4), end_ch_list=(8, 16, 8),
            stacking=1, at_spatial_size=(8, 8, 8), at_layers=(-1, 0),
            at_f_dim=4, at_g_dim=4)
POOL = [12, 16, 20]
# f32 against f32, summation order only: the first stack's BatchNorm
# scales (gradients ~1e-2, sums over every voxel of both forwards) differ
# by up to 7e-3 of their largest at this size
GRAD_TOL = 1e-2


def _decisions(jT, spatial):
    allowed = jeq._shape_preserving_rot_variants(spatial)
    return {"keep": np.asarray(jT.keep).tolist(),
            "flip_variant": int(jT.flip_variant),
            "flip_first": bool(jT.flip_first),
            "rot_index": int(jax.random.randint(jT._rot_key, (), 0,
                                                len(allowed)))}


@pytest.mark.parametrize("name", ["IntRegAffLoss", "IntRegAffRefineLoss"])
def test_loss_matches_jax(name):
    """Loss terms (rtol 1e-4) and every parameter's gradient (GRAD_TOL of
    its largest value; the tap heads' conv bias, zero in exact
    arithmetic, below 1e-4 of its kernel's) of the port's loss and
    dram_tpu's, both in f32, on a narrow DC3DATGeneric in train mode, the
    batch statistics chained through both forwards, under the transform
    dram_tpu draws (its decisions handed to the port's
    OneShotTransform), rescaled. (At this size the model's f32 loss sits
    ~0.4% from its float64 one in both packages: the comparison is made
    at one precision.)"""
    seed = next(s for s in range(100)
                if eq.draw_rescale_static(s, POOL) is not None)
    batch = train_batch(1, batch=2, size=16)
    packed = trainer.pack_train_batch(batch)
    freq = np.asarray(batch["ctss_frequency"], np.float32)
    kw = {"rescale_jitter": POOL, "band_width": 1e-2}
    jloss, loss = getattr(jeq, name)(**kw), getattr(eq, name)(**kw)
    jloss.epoch_reseed(seed)
    loss.epoch_reseed(seed)
    size = loss._static_rescale_size
    assert size is not None and size == jloss._static_rescale_size
    jT = jloss._transform(jax.random.PRNGKey(4), (16, 16, 16))
    T = eq.OneShotTransform(rescale_size=size,
                            decisions=_decisions(jT, size))
    factors = [2.0, 1.0, 0.5]
    jm32 = JaxDC3DATGeneric(train=True, **TINY)
    v = jax.jit(jm32.init)(jax.random.PRNGKey(0),
                           jnp.asarray(packed["images"][:1]))
    model = weights.load_into(DC3DATGeneric(fused_stack=False, **TINY),
                              v["params"], v["batch_stats"])
    params, bs = v["params"], v["batch_stats"]
    jargs = [jnp.asarray(packed[k]) for k in ("images", "lobes", "lesions")]

    @jax.jit
    def jtotal(p):
        carry = {"bs": bs}

        def model_fn(im, lo):
            out, mut = jm32.apply({"params": p, "batch_stats": carry["bs"]},
                                  im, lo, mutable=["batch_stats"])
            carry["bs"] = mut["batch_stats"]
            return out
        losses = jloss(model_fn, *jargs, jnp.asarray(packed["ctss"]),
                       ctss_frequency=jnp.asarray(freq),
                       rng=jax.random.PRNGKey(4),
                       sample_weight=jnp.ones(2, jnp.float32))
        return sum(l * f for l, f in zip(losses, factors)), \
            jnp.stack(losses)
    (_, jl), jg = jax.value_and_grad(jtotal, has_aux=True)(params)
    tb = trainer.batch_tensors(batch, torch.device("cpu"))
    model.train()
    losses = loss(lambda im, lo: model(im), trainer.unpack_image_wire(
        tb["images"], tb["span"]), tb["lobes"], tb["lesions"], tb["ctss"],
        ctss_frequency=tb["freq"], transform=T,
        sample_weight=torch.ones(2))
    sum(l * f for l, f in zip(losses, factors)).backward()
    np.testing.assert_allclose(torch.stack(losses).detach().numpy(),
                               np.asarray(jl), rtol=1e-4)
    # IntRegAffLoss does not reach the PCM: no gradient on the port's
    # side, zeros on dram_tpu's
    got = dict(_flat(weights.to_jax(
        {n: p.grad if p.grad is not None else torch.zeros_like(p)
         for n, p in model.named_parameters()})[0]))
    want = dict(_flat(jg))
    assert set(got) == set(want)
    for k, w in want.items():
        if k.startswith("reshape_") and k.endswith("conv/bias"):
            kernel = np.abs(want[k[:-len("bias")] + "kernel"]).max()
            assert np.abs(got[k]).max() <= 1e-4 * kernel, k
            continue
        np.testing.assert_allclose(got[k], w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=k)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_port_draws_distribution():
    """The port's own draws from a torch.Generator: each op kept with
    p = 0.6, the flip variants and orders uniform, every shape-preserving
    quarter turn reachable; the same seed, the same transform."""
    n = 4000
    g = torch.Generator().manual_seed(0)
    Ts = [eq.OneShotTransform(g) for _ in range(n)]
    keep = np.array([T.keep for T in Ts], float).mean(0)
    assert np.all(np.abs(keep - 0.6) < 0.03)
    flips = np.bincount([T.flip_variant for T in Ts], minlength=7) / n
    assert np.all(np.abs(flips - 1 / 7) < 0.03)
    assert abs(np.mean([T.flip_first for T in Ts]) - 0.5) < 0.03
    rots = np.bincount([T.rot_variant((4, 4, 4)) for T in Ts],
                       minlength=18) / n
    assert np.all(np.abs(rots - 1 / 18) < 0.02)
    assert {T.rot_variant((4, 6, 4)) for T in Ts} == \
        set(eq.shape_preserving_rot_variants((4, 6, 4)))
    a = eq.OneShotTransform(torch.Generator().manual_seed(5))
    b = eq.OneShotTransform(torch.Generator().manual_seed(5))
    assert repr(a) == repr(b)
    kept = np.mean([eq.draw_rescale_static(s, [64]) is not None
                    for s in range(2000)])
    assert abs(kept - 0.6) < 0.04
