"""The port's flagship training step at the published widths against the
JAX package's: dram_tpu_torch/golden/flagship_train.npz holds one step
of dram_tpu's DC3DATGeneric in float64 (tools/make_port_train_golden.py:
st_dram_ref_att's widths, the whole trained tree, IntRegRefineLoss,
optax adam) on golden.train_golden_batch(), 2 x 48^3 at the -300 HU
window. The port's plain f32 step (train_steps on the CPU) is held
against it: loss terms (rtol 1e-4), per parameter tensor the gradient's
L2 norm and its seeded projections (5e-3 relative), the projections of
the Adam update (the card gate's 3e-2 relative L2), and the BatchNorm
batch statistics (5e-3 of each tensor's largest value). The tap heads'
conv biases, whose gradient is zero in exact arithmetic, are held
absolutely, as in the slice tests."""

import numpy as np
import pytest
import torch

from dram_tpu_torch import golden, weights
from dram_tpu_torch.configs import st_dram_ref_att, with_settings
from dram_tpu_torch.models import DC3DATGeneric
from dram_tpu_torch.train import train_steps


@pytest.fixture(scope="module")
def gold():
    with np.load(golden.TRAIN_GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def step():
    """One plain f32 step of the port on the golden's batch, from the
    trained tree: {"losses", "fields" (golden.summarize), "grads"}."""
    settings = with_settings(st_dram_ref_att, COMPUTE_DTYPE="float32",
                             TRAIN_WIRE="f32")
    initial = {n: t.numpy() for n, t in weights.from_jax(
        *weights.load_bench_weights()).items()}
    got = {}

    def on_step(i, st, r):
        m = st.model
        got["grads"] = {n: p.grad.numpy().copy()
                        for n, p in m.named_parameters()}
        got["params"] = {n: p.detach().numpy().copy()
                         for n, p in m.named_parameters()}
        got["buffers"] = {n: b.numpy().copy() for n, b in m.named_buffers()}
    out = train_steps(settings, 1, [golden.train_golden_batch()],
                      device="cpu", weights_path=weights.DEFAULT_PATH,
                      on_step=on_step)
    got["losses"] = np.asarray(out["losses"][0])
    got["fields"] = golden.summarize(got["grads"], got["buffers"], initial,
                                     got["params"], initial)
    return got


def test_golden_integrity(gold):
    """The batch regenerates to the golden's hash, and the golden holds
    exactly the full-width model's parameter and statistic names."""
    batch = golden.train_golden_batch()
    assert golden.batch_sha256(batch) == str(gold["batch_sha256"])
    assert tuple(gold["batch"]) == (golden.TRAIN_SEED, golden.TRAIN_BATCH,
                                    golden.TRAIN_SIZE)
    with torch.device("meta"):
        m = DC3DATGeneric()
    params = {n for n, _ in m.named_parameters()}
    buffers = {n for n, _ in m.named_buffers()}
    for kind, names in (("grad_norm", params), ("grad_proj", params),
                        ("update_proj", params), ("bn", buffers)):
        assert {k.split("/", 1)[1] for k in gold
                if k.startswith(kind + "/")} == names, kind
    assert len(params) == 60 and len(buffers) == 32
    assert all(gold[f"grad_proj/{n}"].shape == (golden.PROJECTIONS,)
               for n in params)


def test_projections_are_seeded_by_name():
    a = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    p = golden.projections("x.weight", a)
    assert p.shape == (golden.PROJECTIONS,)
    np.testing.assert_array_equal(p, golden.projections("x.weight", a))
    assert not np.allclose(p, golden.projections("y.weight", a))


def _worst(read, i=0):
    k = max(read, key=lambda k: read[k][i])
    return f"worst {read[k][i]:.3g} ({k})"


def test_loss_terms(step, gold):
    print(f"loss terms {step['losses']} vs {gold['losses']}")
    np.testing.assert_allclose(step["losses"], gold["losses"], rtol=1e-4)


def test_gradients(step, gold):
    """Norms and projections of every gradient within 5e-3 relative; the
    tap heads' conv biases below 1e-6 of their conv weight's gradient on
    both sides (their golden norm: float64 rounding only)."""
    read = golden.readings(step["fields"], {
        k: v for k, v in gold.items() if k.startswith("grad_")})
    bad = {}
    for k, (rel, cos, _) in read.items():
        name = k.split("/", 1)[1]
        if golden.zero_in_exact_arithmetic(name):
            w = name[:-len("bias")] + "weight"
            if k.startswith("grad_norm/"):
                assert rel <= 1e-6 * np.linalg.norm(step["grads"][w]), k
                assert float(gold[k]) <= \
                    1e-6 * float(gold[f"grad_norm/{w}"]), k
            continue
        if not rel <= 5e-3:
            bad[k] = rel
    live = {k: v for k, v in read.items()
            if not golden.zero_in_exact_arithmetic(k.split("/", 1)[1])}
    print("gradient norms and projections, relative:", _worst(live))
    assert not bad, bad
    assert len(read) == 120


def test_update(step, gold):
    """The Adam step's projections at the card train gate's limits
    (relative L2 <= 3e-2, cosine >= 0.99), not at the gradients' 5e-3:
    Adam's first step, lr * g / (|g| + eps), is lr * sign(g) wherever
    |g| >> eps, so a gradient element near zero whose sign differs
    between f32 and float64 moves the update by 2 lr (a handful of the
    332k elements of us_2's conv_0 read 9.4e-3). Not for the tap heads'
    conv biases: their gradient is rounding only (f32 ~1e-8, float64
    ~1e-19 here), which Adam turns into steps up to ~lr on one side and
    ~0 on the other; their gradients are held in test_gradients."""
    read = golden.readings(step["fields"], {
        k: v for k, v in gold.items() if k.startswith("update_proj/")
        and not golden.zero_in_exact_arithmetic(k.split("/", 1)[1])})
    bad = {k: (rel, cos) for k, (rel, cos, _) in read.items()
           if not (rel <= 3e-2 and cos >= 0.99)}
    print("update projections, relative L2:", _worst(read))
    assert not bad, bad
    assert len(read) == 58


def test_batch_statistics(step, gold):
    read = golden.readings(step["fields"], {
        k: v for k, v in gold.items() if k.startswith("bn/")})
    bad = {k: m for k, (_, _, m) in read.items() if not m <= 5e-3}
    print("BN statistics, largest |diff| / largest value:", _worst(read, 2))
    assert not bad, bad
    assert len(read) == 32
