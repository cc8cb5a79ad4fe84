"""dram_tpu_torch.weights vs flax on the real bench-weights asset, and the
flagship DC3DATGeneric at its published widths with those weights vs the
JAX package."""

import lzma
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dram_tpu.models import DC3DATGeneric as JaxDC3DATGeneric

from dram_tpu_torch import weights
from dram_tpu_torch.models import DC3DATGeneric

ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "bench_weights.ckpt.xz")


@pytest.fixture(scope="module")
def raw():
    with open(ASSET, "rb") as fp:
        return lzma.decompress(fp.read())


@pytest.fixture(scope="module")
def port_tree():
    return weights.load_bench_weights(ASSET)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class TestMsgpackReader:
    def test_same_tree_as_flax(self, raw):
        """Every key, shape, dtype and value equals flax's restore."""
        want = dict(_leaves(serialization.msgpack_restore(raw)))
        got = dict(_leaves(weights.msgpack_unpackb(raw)))
        assert set(got) == set(want)
        assert len(got) == 92
        for k, w in want.items():
            g = got[k]
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=str(k))

    def test_scalars_and_containers(self):
        # fixint, negative fixint, ints of every width, floats, str, bin,
        # array and map headers
        blob = bytes([0x8a,
                      0xa1, 0x61, 0x05,
                      0xa1, 0x62, 0xff,
                      0xa1, 0x63, 0xcd, 0x12, 0x34,
                      0xa1, 0x64, 0xd2, 0xff, 0xff, 0xff, 0xfe,
                      0xa1, 0x65, 0xcb, 0x3f, 0xf8, 0, 0, 0, 0, 0, 0,
                      0xa1, 0x66, 0xca, 0x40, 0x20, 0, 0,
                      0xa1, 0x67, 0xc4, 0x02, 0x01, 0x02,
                      0xa1, 0x68, 0x93, 0x01, 0xd0, 0x80, 0xcc, 0xff,
                      0xa1, 0x69, 0xd9, 0x01, 0x7a,
                      0xa1, 0x6a, 0xdc, 0x00, 0x01, 0xcf,
                      0, 0, 0, 0, 0, 0, 0, 7])
        assert weights.msgpack_unpackb(blob) == {
            "a": 5, "b": -1, "c": 0x1234, "d": -2, "e": 1.5, "f": 2.5,
            "g": b"\x01\x02", "h": [1, -128, 255], "i": "z", "j": [7]}

    def test_load_casts_params_to_f32(self, port_tree):
        params, batch_stats = port_tree
        p = list(_leaves(params))
        bs = list(_leaves(batch_stats))
        assert len(p) == 60 and len(bs) == 32
        assert all(v.dtype == np.float32 for _, v in p + bs)


def _to_jax(state_dict):
    """The inverse mapping, written out independently of from_jax."""
    stats = {"running_mean": "mean", "running_var": "var"}
    params, batch_stats = {}, {}
    for key, t in state_dict.items():
        *mod, leaf = key.split(".")
        a = t.numpy()
        tree = batch_stats if leaf in stats else params
        if leaf in stats:
            leaf = stats[leaf]
        elif leaf == "weight" and a.ndim == 5:
            a, leaf = a.transpose(2, 3, 4, 1, 0), "kernel"
        elif leaf == "weight" and a.ndim == 2:
            a, leaf = a.T, "kernel"
        elif leaf == "weight":
            leaf = "scale"
        for m in mod:
            tree = tree.setdefault(m, {})
        tree[leaf] = a
    return params, batch_stats


class TestFromJax:
    def test_round_trip_every_array(self, port_tree):
        params, batch_stats = port_tree
        sd = weights.from_jax(params, batch_stats)
        assert len(sd) == 92
        p2, bs2 = _to_jax(sd)
        for tree, back in ((params, p2), (batch_stats, bs2)):
            want, got = dict(_leaves(tree)), dict(_leaves(back))
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=str(k))

    def test_state_dict_fits_flagship(self, port_tree):
        m = weights.load_into(DC3DATGeneric(), *port_tree)
        k = port_tree[0]["backbone"]["us_2"]["convs"]["conv_0"]["kernel"]
        np.testing.assert_array_equal(
            m.backbone.us_2.convs.conv_0.weight.detach().numpy(),
            k.transpose(4, 3, 0, 1, 2))


def test_flagship_widths_bench_weights_match_jax(port_tree):
    """Both heads at the published widths with the trained weights, one
    16^3 chunk and a 16^3 PCM grid, f32 on both sides. Tolerance 2e-3:
    14 convs at up to 768 input channels accumulate in another order
    (the bar of tests/test_reference_parity.py at the reference widths)."""
    params, batch_stats = port_tree
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, size=(1, 16, 16, 16, 1)).astype(np.float32)
    jm = JaxDC3DATGeneric(train=False, at_spatial_size=(16, 16, 16))
    jd, jr = jax.jit(jm.apply)({"params": params,
                                "batch_stats": batch_stats}, jnp.asarray(x))
    m = weights.load_into(DC3DATGeneric(at_spatial_size=(16, 16, 16)),
                          params, batch_stats).eval()
    with torch.no_grad():
        d, r = m(torch.from_numpy(x))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=2e-3,
                               rtol=2e-3)
