"""The port's unfused flagship (USE_FUSED_STACK = False) as a whole vs the
JAX package on the CPU: two TrainSteps of a narrow unfused DC3DATGeneric
against JAX's train step in float64, and a narrow unfused scan through
the port's FastScanPipeline against dram_tpu's. Its modules are held
against the JAX package's in tests/test_torch_port_unfused.py."""

import jax
import jax.numpy as jnp
import numpy as np
from _torch_port_slice import two_train_steps_match_jax

import chip_smoke
from dram_tpu.infer import fast as jfast
from dram_tpu.models import DC3DATGeneric as JaxDC3DATGeneric

from dram_tpu_torch import weights
from dram_tpu_torch.data.synth import synth_scan
from dram_tpu_torch.infer import fast
from dram_tpu_torch.models import DC3DATGeneric


class TestSlice:
    def test_two_train_steps_match_jax(self):
        """Two whole TrainSteps of a narrow unfused DC3DATGeneric (f32)
        against JAX's train step in float64 (its XLA convs: the interpret
        Pallas conv accumulates in f32, which would undo float64), with
        the checks and tolerances of the fused slice test
        (_torch_port_slice.two_train_steps_match_jax), on its -300 HU
        batch."""
        two_train_steps_match_jax(fused_stack=False)

    def test_scan_matches_jax(self):
        """A narrow unfused DC3DATGeneric with random weights through the
        port's FastScanPipeline against dram_tpu's (whose CPU model is
        unfused): mask Dice >= 0.995 and the same Otsu bin, the repo's
        gate."""
        narrow = dict(base_ch_list=(4, 8, 8, 16, 16, 8, 8),
                      end_ch_list=(8, 8, 16, 16, 16, 8, 8),
                      at_spatial_size=(8, 8, 8), at_f_dim=4, at_g_dim=4)
        chunk, span = (16, 16, 16), (-1000, -700)
        jm = JaxDC3DATGeneric(train=False, **narrow)
        v = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, *chunk, 1)))
        rng = np.random.default_rng(1)
        v = jax.tree_util.tree_map_with_path(
            lambda path, a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            if path[-1].key == "var" else np.asarray(a, np.float32), v)
        pm = weights.load_into(DC3DATGeneric(**narrow, fused_stack=False),
                               v["params"], v["batch_stats"])
        scan, lobe, _, vessel, _ = synth_scan(
            np.random.default_rng(11), (40, 48, 44),
            lesion_severity=[3, 4, 2, 5, 3])
        prepc = fast.prep_scan_chunks(scan, lobe, (1.5, 0.9, 0.9),
                                      vessel_u8=vessel, windowing_span=span,
                                      chunk_size=chunk)
        want = jfast.FastScanPipeline(jm, v["params"], v["batch_stats"],
                                      chunk_size=chunk, windowing_span=span) \
            .process_chunks(dict(prepc))
        got = fast.FastScanPipeline(pm, device="cpu").process_chunks(prepc)
        assert got["pred"].any() and got["post"].any()
        assert round(got["threshold"] * 255) == round(want["threshold"] * 255)
        for k in ("pred", "post"):
            assert chip_smoke.dice(got[k], want[k]) >= 0.995, k
