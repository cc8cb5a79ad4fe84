"""The port's backbone options against dram_tpu's on the CPU, in f32: a
ConvStack for each norm and activation (train mode: forward, gradients
and batch statistics; eval mode with dropout), k = 5 SAME and VALID
stacks (VALID crops the skips), the local and the non-2 upsampling, a
narrow DC3DATGeneric with those options and a decoder tap, the shared
PReLU slope, dropout's masks, and from_jax / to_jax on the new trees."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dram_tpu.models import DC3DATGeneric as JaxDC3DATGeneric
from dram_tpu.models.blocks import ConvStack as JaxConvStack
from dram_tpu.models.unet3d import DC3D as JaxDC3D

from dram_tpu_torch import weights
from dram_tpu_torch.models import DC3D, DC3DATGeneric
from dram_tpu_torch.models.blocks import ConvStack, Dropout, PReLU

# f32 on both sides (XLA's convs and flax's norms against F.conv3d, the
# port's conv kernel's plain version and its norms), the tolerance of
# tests/test_reference_parity.py:245-248
TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_GroupNorm = fnn.GroupNorm


def _instance_norm(*args, **kw):
    """dram_tpu's make_norm builds 'in' as nn.GroupNorm(group_size=1),
    which flax 0.12 refuses unless num_groups=None is passed as well (its
    default is 32): the reference's InstanceNorm, one group per channel,
    is what the port computes and what this builds."""
    if "group_size" in kw and "num_groups" not in kw:
        kw["num_groups"] = None
    return _GroupNorm(*args, **kw)


@pytest.fixture(autouse=True)
def flax_instance_norm(monkeypatch):
    monkeypatch.setattr(fnn, "GroupNorm", _instance_norm)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _close(a, b, what, tol=TOL):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=tol,
                               atol=tol * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def _variables(jm, x, seed):
    """Random variables of flax module `jm` on input `x`, drawn with numpy
    from the tree's shapes (jax.eval_shape: no init compile): conv and
    dense kernels N(0, 2 / fan_in), scales near 1, biases and PReLU
    slopes near 0, running means near 0 and variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def draw(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        n = rng.normal(size=a.shape)
        if name == "kernel":
            v = n * np.sqrt(2.0 / max(np.prod(a.shape[:-1]), 1))
        elif name == "scale":
            v = 1.0 + 0.1 * n
        elif name == "var":
            v = rng.uniform(0.5, 1.5, a.shape)
        else:  # bias, negative_slope, mean
            v = 0.1 * n
        return np.asarray(v, np.float32)
    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _compare(jm, port, x, seed, train=True, grad_tol=None):
    """Forward in train mode (batch statistics, running statistics
    updated) and parameter gradients of sum(out * w) for flax module `jm`
    and the port's `port`, from the same random variables, in f32 on both
    sides; with `grad_tol` dram_tpu runs in float64 and the gradients are
    held within grad_tol of each tensor's largest."""
    v = _variables(jm, x, seed)
    bs = v.get("batch_stats", {})
    weights.load_into(port, v["params"], bs)
    out_shape = jax.eval_shape(
        lambda: jm.apply(v, jnp.asarray(x), mutable=["batch_stats"])[0])
    rng = np.random.default_rng(seed + 1)
    w = _outputs(out_shape, rng)

    def run(module, variables, xx, ww):
        def loss(p):
            out, mut = module.apply({"params": p, "batch_stats":
                                     variables.get("batch_stats", {})},
                                    xx, mutable=["batch_stats"])
            return _dot(out, ww, jnp), (out, mut.get("batch_stats", {}))
        return jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
    if grad_tol is None:
        (_, (jout, jbs)), jg = run(jm, v, jnp.asarray(x), w)
    else:
        with jax.enable_x64(True):
            f64 = jnp.float64
            v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, f64), v)
            (_, (jout, jbs)), jg = jax.tree_util.tree_map(np.asarray, run(
                jm.clone(dtype=f64), v64, jnp.asarray(x, f64),
                [jnp.asarray(a, f64) for a in w]))
    port.train(train)
    out = port(torch.from_numpy(x))
    _dot(out, [torch.from_numpy(a) for a in w], torch).backward()
    _close(_np(out), _np(jout), "forward")
    got = dict(_flat(weights.to_jax(
        {n: p.grad for n, p in port.named_parameters()})[0]))
    want = dict(_flat(jg))
    assert set(got) == set(want)
    for k, a in want.items():
        kernel = np.abs(want.get(k[:-len("bias")] + "kernel", a)).max()
        if k.endswith("/bias") and np.abs(a).max() < 1e-4 * kernel:
            # a bias that a normalization or a softmax cancels (the tap
            # heads' conv bias before their BatchNorm, a phi bias adding
            # the same term to every logit of a row): zero gradient in
            # exact arithmetic, rounding on each side
            assert np.abs(got[k]).max() < 1e-4 * kernel, k
            continue
        _close(got[k], a, f"d{k}", tol=grad_tol or TOL)
    gbs = dict(_flat(weights.to_jax(dict(port.named_buffers()))[1]))
    for k, a in dict(_flat(jbs)).items():
        _close(gbs[k], a, f"batch_stats {k}")
    return v


def _outputs(shape, rng):
    leaves = shape if isinstance(shape, tuple) else (shape,)
    return [rng.normal(size=s.shape).astype(np.float32) for s in leaves]


def _dot(out, w, xp):
    outs = out if isinstance(out, tuple) else (out,)
    return sum(xp.sum(o * a) for o, a in zip(outs, w))


def _np(out):
    outs = out if isinstance(out, tuple) else (out,)
    return np.concatenate([np.asarray(o.detach() if hasattr(o, "detach")
                                      else o).ravel() for o in outs])


NORMS = ["bn", "bnt", "bntna", "ln", "lnna", "in", None]


@pytest.mark.parametrize("norm", NORMS)
def test_conv_stack_matches_jax(norm):
    """ReLU and PReLU stacks under `norm` (_conv_stack_case)."""
    for act in ("relu", "prelu"):
        _conv_stack_case(norm, act)


def _conv_stack_case(norm, act):
    """Two 3x3x3 SAME convs, each followed by the norm and the
    activation, in train mode: forward, gradients (conv biases where
    there is no norm; one PReLU slope for the stack) and the running
    statistics after the batch; then eval mode with dropout 0.1 (the
    identity): forward from the running statistics, where the norm has
    them; under 'bnt' / 'bntna' both packages raise."""
    x = np.random.default_rng(3).normal(size=(2, 6, 6, 6, 4)) \
        .astype(np.float32)
    kw = dict(features=(8, 8), kernel_sizes=(3, 3), paddings=(1, 1),
              strides=(1, 1), use_bias=norm is None, norm_method=norm,
              act_method=act)
    port = ConvStack(4, (8, 8), fused=False, kernel_sizes=3, paddings=1,
                     norm_method=norm, act_method=act)
    v = _compare(JaxConvStack(**kw, train=True), port, x, 5)
    assert ("PReLU_0/negative_slope" in dict(_flat(v["params"]))) == \
        (act == "prelu")
    assert sum(isinstance(m, PReLU) for m in port.modules()) == \
        (act == "prelu")
    je = JaxConvStack(**kw, dropout=0.1, train=False)
    pe = ConvStack(4, (8, 8), fused=False, norm_method=norm,
                   act_method=act, dropout=0.1)
    pe.load_state_dict(port.state_dict())
    pe.eval()
    jv = {"params": v["params"]}
    if "batch_stats" in v:
        jv["batch_stats"] = weights.to_jax(dict(port.named_buffers()))[1]
    if norm in ("bnt", "bntna"):
        with pytest.raises(Exception):
            je.apply(jv, jnp.asarray(x))
        with pytest.raises(RuntimeError):
            pe(torch.from_numpy(x))
        return
    with torch.no_grad():
        _close(pe(torch.from_numpy(x)).numpy(), je.apply(jv, jnp.asarray(x)),
               "eval forward")


NARROW2 = dict(n_layers=2, base_ch_list=(4, 8, 16, 8, 4),
               end_ch_list=(8, 16, 32, 16, 8))


DC3D_OPTIONS = [
    dict(kernel_sizes=[(5, 5)] * 5, padding_list=[(2, 2)] * 5, size=12),
    dict(n_layers=1, base_ch_list=(4, 8, 4), end_ch_list=(8, 16, 8),
         kernel_sizes=[(3, 3)] * 3, padding_list=[(0, 0)] * 3, size=24),
    dict(local_upsample=True, norm_method="in", act_method="prelu",
         size=12),
    dict(upsample_sf=(1.5, 1.5, 1.5), norm_method="ln", size=12),
]


def test_dc3d_options_match_jax():
    """A narrow DC3D in train mode with k = 5 SAME convs, VALID convs
    (the decoder crops the skips), the local 2x upsample and a scale
    factor of 1.5 (align-corners resize3d to int(1.5 n); the skips are
    cropped; a factor above 2 outgrows the skips, where dram_tpu's
    crop_concat fails): forward, gradients and batch statistics."""
    for case in DC3D_OPTIONS:
        case = dict(case)
        size = case.pop("size")
        cfg = dict(NARROW2, stacking=-1)
        cfg.update(case)
        x = np.random.default_rng(4).normal(
            size=(2, size, size, size, 1)).astype(np.float32)
        jm = JaxDC3D(train=True, use_fused_stack=False,
                     use_pallas_conv=False, **cfg)
        _compare(jm, DC3D(fused_stack=False, **cfg), x, 6)


@pytest.mark.parametrize("at", [
    dict(at_k_size=3, at_connectivity=2, at_self_loop=True, at_f_dim=16,
         at_g_dim=4),
    dict(at_merge_type="scaled_dot_product_geo_relu", at_p_enc_dim=12,
         at_geo_f_dim=4, at_f_dim=4)], ids=["pcm_widths", "pcm_geo"])
def test_dc3d_at_generic_with_decoder_tap(at):
    """A narrow DC3DATGeneric with at_layers (-1, 0, 2, 3) (the input, an
    encoder level, the bottleneck and a decoder level) and a PCM of
    widths 16 / 4 on a self-loop stencil, or with the positional
    encoding: the tap heads' widths agree with flax's inferred ones;
    forward, batch statistics and gradients (2e-4) against dram_tpu in
    float64: dram_tpu's own f32 gradients sit up to 5.7e-3 of their
    largest from float64 here (us_0's first BatchNorm scale), the
    port's within 5e-6, so f32 against f32 would hold dram_tpu's
    summation order, not the port."""
    cfg = dict(NARROW2, stacking=2, at_spatial_size=(8, 8, 8),
               at_layers=(-1, 0, 2, 3), **at)
    x = np.random.default_rng(5).normal(size=(2, 16, 16, 16, 1)) \
        .astype(np.float32)
    jm = JaxDC3DATGeneric(train=True, use_fused_stack=False,
                          use_pallas_conv=False, **cfg)
    port = DC3DATGeneric(fused_stack=False, **cfg)
    v = _compare(jm, port, x, 7, grad_tol=TOL)
    heads = {k.split("/")[0] for k, _ in _flat(v["params"])
             if k.startswith("reshape")}
    assert heads == {f"reshape_{i}" for i in range(3)}


def test_dropout_masks_and_eval():
    """flax's nn.Dropout semantics from an explicit generator: a keep
    share near 1 - rate, kept values scaled by 1 / (1 - rate), the same
    mask for the same seed, identity in eval; a train-mode forward
    without a generator raises."""
    d = Dropout(0.25)
    x = torch.ones(200_000)
    with pytest.raises(RuntimeError):
        d(x)
    d.generator = torch.Generator().manual_seed(1)
    y = d(x)
    keep = (y != 0).float().mean().item()
    assert abs(keep - 0.75) < 0.005
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.75))
    d.generator = torch.Generator().manual_seed(1)
    assert torch.equal(d(x), y)
    d.eval()
    assert torch.equal(d(x), x)
    m = DC3D(**NARROW2, dropout=0.1, fused_stack=False)
    gen = torch.Generator()
    m.set_dropout_generator(gen)
    drops = [mod for mod in m.modules() if isinstance(mod, Dropout)]
    assert drops and all(mod.generator is gen for mod in drops)


NEW_TREES = [
    dict(norm_method="in", act_method="prelu"),
    dict(norm_method="bntna", act_method="relu"),
    dict(norm_method=None, act_method="prelu", kernel_sizes=[(5, 5)] * 5,
         padding_list=[(2, 2)] * 5),
    dict(norm_method="lnna", act_method="relu", at_merge_type="sm",
         at_p_enc_dim=12, at_geo_f_dim=4, at_f_dim=4, at_g_dim=0),
]


def test_from_jax_to_jax_identity():
    """to_jax(from_jax(tree)) is the tree itself for each new tree (and
    the port's module tree matches flax's key for key)."""
    for cfg in NEW_TREES:
        _identity_case(cfg)


def _identity_case(cfg):
    cfg = dict(NARROW2, stacking=2, at_spatial_size=(8, 8, 8),
               at_layers=(-1, 0, 3), **cfg)
    jm = JaxDC3DATGeneric(train=True, **cfg)
    v = _variables(jm, np.zeros((1, 8, 8, 8, 1), np.float32), 9)
    port = weights.load_into(DC3DATGeneric(**cfg), v["params"],
                             v.get("batch_stats", {}))
    p, bs = weights.to_jax(port.state_dict())
    for tree, want in ((p, v["params"]), (bs, v.get("batch_stats", {}))):
        got, want = dict(_flat(tree)), dict(_flat(want))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
