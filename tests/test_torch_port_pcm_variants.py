"""The port's whole PCM against dram_tpu's on the CPU: stencil_offsets for
every (k, connectivity, self loop) of the table, every merge type's
forward and gradients, the positional encoding, identity projections,
the residual and several iterations, and the plain versions of the three
stencil-attention passes against dram_tpu's Pallas kernel in interpret
mode on an asymmetric stencil with widths other than 8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dram_tpu.core.pallas.window_attention import stencil_attention as jax_att
from dram_tpu.models.pcm import PCM as JaxPCM
from dram_tpu.models.pcm import build_geo_feature as jax_geo
from dram_tpu.models.pcm import stencil_offsets as jax_offsets

from dram_tpu_torch import weights
from dram_tpu_torch.kernels import window_attention as wa
from dram_tpu_torch.models.pcm import MERGE_TYPES, PCM, build_geo_feature

SHAPE = (2, 6, 8, 8)
# float64 against float64 (the PCM cases), f32 against f32 (the attention
# passes): summation order and exp rounding
RTOL, ATOL_FRAC = 1e-5, 1e-5
# a gradient zero in exact arithmetic: below this share of its layer's
# kernel gradient on both sides
ZERO = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _close(a, b, what):
    """Within RTOL and ATOL_FRAC of the largest; NaN where dram_tpu has
    NaN (l2smrelu: the norm of an all-zero row has a NaN gradient in
    both packages)."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    big = np.nanmax(np.abs(b)) if np.isfinite(b).any() else 0.0
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL_FRAC * max(big,
                                                                     1e-30),
                               err_msg=what)


# Cases of a test are looped inside it: pytest-xdist's loadfile order
# puts files with more test items first, and a file of fewer items than
# tests/test_mesh.py (13) starts after that long file, not before it.


@pytest.mark.parametrize("k_size", [3, 5, 7])
def test_stencil_offsets_match_jax(k_size):
    """The numpy stencil equals scipy's zoomed binary structure (dram_tpu)
    as an ordered tuple, for connectivity 1-3 with and without the
    centre."""
    counts = {3: (7, 19, 27), 5: (44, 98, 125), 7: (135, 279, 343)}
    for connectivity in (1, 2, 3):
        for self_loop in (False, True):
            got = wa.stencil_offsets(k_size, connectivity, self_loop)
            assert got == jax_offsets(k_size, connectivity, self_loop)
            assert len(got) == \
                counts[k_size][connectivity - 1] - (not self_loop)


def test_k5_stencils_are_asymmetric():
    """k = 5 at connectivity 1 and 2 holds offsets whose mirror image it
    does not hold (scipy's rounding of half-way coordinates); the other
    stencils of the table are symmetric."""
    for k, c in [(5, 1), (5, 2), (3, 2), (5, 3), (7, 1)]:
        s = set(wa.stencil_offsets(k, c, True))
        asym = [o for o in s if tuple(-a for a in o) not in s]
        assert bool(asym) == (k == 5 and c < 3), (k, c)


def _pcm_case(merge_type, k=3, c=1, self_loop=True, f_dim=8, g_dim=8,
              p_enc_dim=0, geo_f_dim=0, residual=False, iters=1, seed=0):
    """Forward and gradients (parameters, cam, f) of the port's PCM and
    dram_tpu's PCM (use_pallas=False, the XLA path) on the same numpy
    inputs and the same parameters, for the loss sum(out * w), in float64
    on both sides: in f32 the dense layers' gradients (sums over every
    voxel and edge) differ by summation order alone by up to 6e-5, and
    smscaled (logits x 100) and cosine (a division by a sum of cosines
    that may come near 0) amplify f32 rounding further."""
    with jax.enable_x64(True):
        return _pcm_case_in(np.float64, merge_type, k, c, self_loop, f_dim,
                            g_dim, p_enc_dim, geo_f_dim, residual, iters,
                            seed)


def _pcm_case_in(dt, merge_type, k, c, self_loop, f_dim, g_dim, p_enc_dim,
                 geo_f_dim, residual, iters, seed):
    rng = np.random.default_rng(seed)
    cam = rng.normal(size=SHAPE + (1,)).astype(dt)
    f = rng.normal(size=SHAPE + (9,)).astype(dt)
    wout = rng.normal(size=SHAPE + (1,)).astype(dt)
    kw = dict(g_ch=1, f_dim=f_dim, geo_f_dim=geo_f_dim, g_dim=g_dim,
              non_local_iter=iters, k_size=k, merge_type=merge_type,
              self_loop=self_loop, connectivity=c, residual=residual,
              p_enc_dim=p_enc_dim)
    jm = JaxPCM(pool_size=SHAPE[1:], use_pallas=False, dtype=dt, **kw)
    # parameters drawn with numpy from the tree's shapes (no init compile):
    # torch Linear's U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for kernels and
    # biases alike
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(seed),
                            jnp.asarray(cam), jnp.asarray(f)).get("params",
                                                                 {})
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(-1, 1, a.shape), dt), shapes)

    def jloss(p, cm, x):
        out = jm.apply({"params": p}, cm, x)
        return jnp.sum(out * wout), out
    (_, jout), (jg, jgc, jgf) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(params, jnp.asarray(cam),
                                                 jnp.asarray(f))
    m = PCM(in_ch=9, **kw).to(torch.float64 if dt == np.float64
                               else torch.float32)
    weights.load_into(m, params, {})
    tc = torch.tensor(cam, requires_grad=True)
    tf = torch.tensor(f, requires_grad=True)
    out = m(tc, tf)
    (out * torch.from_numpy(wout)).sum().backward()
    got = dict(_flat(weights.to_jax(
        {n: p.grad for n, p in m.named_parameters()})[0]))
    want = dict(_flat(jg))
    assert set(got) == set(want)
    _close(out.detach().numpy(), jout, f"{merge_type} forward")
    for key, w in want.items():
        kernel = np.abs(want[key.replace("/bias", "/kernel")]).max()
        if key.endswith("/bias") and np.abs(w).max() < ZERO * kernel:
            # phi's bias adds the same theta_i . b to every logit of row
            # i: under a softmax its gradient is zero in exact arithmetic
            # and each side holds only its rounding
            assert np.abs(got[key]).max() < ZERO * kernel, key
            continue
        _close(got[key], w, f"{merge_type} d{key}")
    _close(tc.grad.numpy(), jgc, f"{merge_type} dcam")
    _close(tf.grad.numpy(), jgf, f"{merge_type} df")
    return set(want)


# the merge types that read the positional encoding: geo widths 4; the
# sum of projected and positional features needs equal widths
GEO = {"scaled_dot_product_geo": dict(p_enc_dim=12, geo_f_dim=4),
       "scaled_dot_product_geo_relu": dict(p_enc_dim=12, geo_f_dim=4),
       "att_is_all": dict(p_enc_dim=12, geo_f_dim=8)}


@pytest.mark.parametrize("group", range(4))
def test_merge_type_matches_jax(group):
    """Every merge type of dram_tpu's merge_weights (a quarter of them a
    case): forward and the gradients of theta, phi, G, r (and geo_theta,
    geo_phi), cam and f, at 1e-5 (float64). 'scaled_dot_product_relu'
    without the encoding is the kernel path (plain on the CPU) against
    dram_tpu's XLA path."""
    for merge_type in MERGE_TYPES[group::4]:
        names = _pcm_case(merge_type, **GEO.get(merge_type, {}))
        assert {"theta/kernel", "phi/bias", "G/kernel", "r/bias"} <= names
        if merge_type in GEO:
            assert "geo_theta/kernel" in names


OPTIONS = [
    dict(merge_type="scaled_dot_product_geo_relu", p_enc_dim=12,
         geo_f_dim=0),
    dict(merge_type="scaled_dot_product_relu", f_dim=0, self_loop=False),
    dict(merge_type="scaled_dot_product_relu", g_dim=0, self_loop=False),
    dict(merge_type="scaled_dot_product_relu", residual=True, iters=2),
    dict(merge_type="sm", residual=True, iters=2, f_dim=0, g_dim=0)]


def test_pcm_options_match_jax():
    """Raw positional features (geo_f_dim 0), identity projections
    (f_dim 0, g_dim 0), the residual and two iterations; the
    'scaled_dot_product_relu' cases through the kernel path (its plain
    versions on the CPU) at widths other than 8. (dram_tpu's XLA path
    compiles for ~50 s on a k = 5 stencil: the stencils here are k = 3;
    k = 5 is held by test_plain_passes_match_pallas_interpret.)"""
    for case in OPTIONS:
        _pcm_case(**case)


def test_geo_feature_matches_jax():
    got = build_geo_feature((6, 8, 10), 12).numpy()
    np.testing.assert_allclose(got, jax_geo((6, 8, 10), 12), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError):
        build_geo_feature((4, 4, 4), 10)


# offsets of the k = 5, connectivity-2 stencil (self loop) whose mirror
# images it lacks, and the centre: dram_tpu's Pallas kernels take about
# half a second an offset a pass in interpret mode (46 s for the forward
# of all 98), so the comparison takes this asymmetric sub-stencil, halo 2;
# chip_smoke holds the generic kernels against the plain versions on the
# whole stencil
ASYM = ((-2, -2, -1), (-1, 2, -1), (0, 0, 0), (1, -1, 2), (2, -1, -2),
        (2, 2, -1))


def test_plain_passes_match_pallas_interpret():
    """The plain forward, statistics and gradient passes (the generic
    kernels' plain versions) against dram_tpu's stencil_attention (its
    Pallas kernels in interpret mode, forward and custom_vjp) on an
    asymmetric sub-stencil of k = 5 connectivity 2 (ASYM) at 1 x 6 x 8 x
    8, at widths (16, 4) and (5, 1): the -o gathers of dphi and dg sum
    other edges than +o gathers would."""
    full = set(wa.stencil_offsets(5, 2, True))
    assert set(ASYM) <= full
    assert [o for o in ASYM if tuple(-a for a in o) not in full]
    for widths in ((16, 4), (5, 1)):
        _passes_match_pallas(*widths)


def _passes_match_pallas(F, G):
    offs = ASYM
    rng = np.random.default_rng(7)
    theta, phi = (rng.normal(size=(1, 6, 8, 8, F)).astype(np.float32)
                  for _ in range(2))
    g, ybar = (rng.normal(size=(1, 6, 8, 8, G)).astype(np.float32)
               for _ in range(2))
    jout, vjp = jax.vjp(lambda t, p, c: jax_att(t, p, c, offs, 6, True),
                        *(jnp.asarray(a) for a in (theta, phi, g)))
    want = vjp(jnp.asarray(ybar))
    t = [torch.from_numpy(a) for a in (theta, phi, g, ybar)]
    _close(wa.stencil_attention_plain(*t[:3], offs).numpy(), jout,
           "forward")
    scal = wa.stencil_attention_scal_plain(*t, offs)
    got = wa.stencil_attention_bwd_plain(*t, scal, offs)
    for name, a, b in zip(("dtheta", "dphi", "dg"), got, want):
        _close(a.numpy(), b, name)
    # the same through StencilAttentionFunction (CPU tensors: plain)
    leaves = [x.clone().requires_grad_() for x in t[:3]]
    got2 = torch.autograd.grad(wa.stencil_attention(*leaves, offs), leaves,
                               t[3])
    for name, a, b in zip(("dtheta", "dphi", "dg"), got2, want):
        _close(a.numpy(), b, name + " (Function)")
    # gathering dphi over +o instead of -o is wrong on this stencil
    bad = _plus_side_dphi(t, scal, offs) - got[1]
    assert bad.abs().max() > 1e-2 * got[1].abs().max()


def _plus_side_dphi(t, scal, offs):
    """dphi from +o gathers (what a sign slip computes): the edge o of
    voxel j + o credited to j."""
    theta, phi, g, ybar = t
    r, m, den, c = (scal[..., k:k + 1] for k in range(4))
    logits, dots, _ = wa._edge_logits(theta, phi, offs)
    a = torch.exp(logits - m) / torch.clamp(den, min=1e-12)
    dphi = torch.zeros_like(phi)
    fwd = wa.valid_masks(theta.shape[1:4], offs)
    for k, off in enumerate(offs):
        u = (ybar * wa._shift(g, off)).sum(-1, keepdim=True)
        ds = torch.where(dots[..., k:k + 1] > 0, a[..., k:k + 1] * (u - c)
                         * r, 0.0)
        dphi = dphi + torch.where(fwd[..., k:k + 1],
                                  wa._shift(ds * theta, off), 0.0)
    return dphi


def test_dispatch_by_operands():
    """The plane ring takes only the shipped stencil at F = G = 8; the
    generic kernels any stencil within 343 offsets and halo 3 at widths
    1..64; a CUDA-bound check raises for what neither takes."""
    ship, k5 = wa.KERNEL_OFFSETS, wa.stencil_offsets(5, 2, True)
    assert wa.ring_takes(ship, 8, 8)
    assert not wa.ring_takes(ship, 16, 8) and not wa.ring_takes(k5, 8, 8)
    assert wa.generic_takes(k5, 16, 4) and wa.generic_takes(ship, 33, 1)
    assert wa.generic_takes(wa.stencil_offsets(7, 3, True), 64, 64)
    assert not wa.generic_takes(k5, 65, 4)
    assert not wa.generic_takes(wa.stencil_offsets(9, 1, True), 8, 8)
    t = torch.zeros(1, 4, 4, 4, 65)
    g = torch.zeros(1, 4, 4, 4, 4)
    with pytest.raises(ValueError, match="widths"):
        wa._check_generic("x", k5, (t, t), (g,))
    with pytest.raises(ValueError, match="plane-ring"):
        wa._check_ring("x", k5, g, g, g)
