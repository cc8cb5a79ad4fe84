"""The rank side of the port's data-parallel tests
(tests/test_torch_port_dist.py, tests/test_torch_port_dist_train.py):

    python tests/_torch_port_dist_worker.py CASE RANK WORLD PORT DIR

joins a gloo process group of WORLD CPU ranks through the environment
torchrun would set (core/mesh.maybe_init_distributed), on one torch
thread, reads DIR/inputs.pkl (numpy arrays and flax-layout trees the
test process drew), runs CASE and writes its results to DIR/rankR.pkl.
`spawn` starts the ranks and returns their results. Not a test module:
it imports neither jax nor dram_tpu, so the import guard can run it."""

import os
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(case, world, out_dir, inputs=None, env=None, prelude=None):
    """Run `case` on `world` gloo ranks (one process each) with `inputs`;
    returns the ranks' result dicts. `prelude`: Python code each rank runs
    first (the import guard's blocker). A rank that fails or outlives
    TIMEOUT_S fails the call with every rank's stderr."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "inputs.pkl"), "wb") as fp:
        pickle.dump(inputs or {}, fp)
    port = str(free_port())
    penv = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                **(env or {}))
    me = os.path.abspath(__file__)
    entry = [me] if prelude is None else [
        "-c", f"{prelude}\nimport runpy\nrunpy.run_path({me!r}, "
        "run_name='__main__')"]
    procs = [subprocess.Popen(
        [sys.executable, *entry, case, str(r), str(world), port, out_dir],
        env=penv, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs, failed = [], False
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = p.communicate()
            failed = True
        failed = failed or p.returncode != 0
        errs.append(f"--- rank {r} (exit {p.returncode}):\n{err[-6000:]}")
    if failed:
        raise RuntimeError(f"{case} on {world} ranks failed:\n"
                           + "\n".join(errs))
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as fp:
            out.append(pickle.load(fp))
    return out


def rows(r, per):
    return slice(r * per, (r + 1) * per)


# --- cases ---------------------------------------------------------------------


def case_library(inp, r, world, group):
    """The fused conv stack, train-mode BatchNorms, halo exchange, the
    sharded stencil apply, the sharded PCM and overlap tiles."""
    import torch
    from dram_tpu_torch import weights
    from dram_tpu_torch.core import mesh
    from dram_tpu_torch.models import DC3D
    from dram_tpu_torch.models.blocks import (BatchNorm, ConvStack,
                                              set_process_group)
    from dram_tpu_torch.models.pcm import PCM, pcm_sharded

    t = torch.from_numpy
    res = {}

    # ConvStack in train mode (ConvStackFunction) on this rank's rows
    c = inp["conv"]
    per = c["x"].shape[0] // world
    ci, c0 = c["w0"].shape[3], c["w0"].shape[4]
    c1 = c["w1"].shape[4]
    m = ConvStack(ci, (c0, c1)).train()
    with torch.no_grad():
        m.conv_0.weight.copy_(t(c["w0"].transpose(4, 3, 0, 1, 2).copy()))
        m.conv_1.weight.copy_(t(c["w1"].transpose(4, 3, 0, 1, 2).copy()))
        for bn, k in ((m.BatchNorm_0, "bn0"), (m.BatchNorm_1, "bn1")):
            g, b, mu, var = c[k]
            for dst, src in ((bn.weight, g), (bn.bias, b),
                             (bn.running_mean, mu), (bn.running_var, var)):
                dst.copy_(t(src))
    set_process_group(m, group)
    x = t(c["x"][rows(r, per)].copy()).requires_grad_()
    y = m(x)
    (y * t(c["cot"][rows(r, per)].copy())).sum().backward()
    grads = [p.grad.clone() for p in (m.conv_0.weight, m.BatchNorm_0.weight,
                                      m.BatchNorm_0.bias, m.conv_1.weight,
                                      m.BatchNorm_1.weight,
                                      m.BatchNorm_1.bias)]
    for g in grads:  # the global objective's gradient: sum of the ranks'
        torch.distributed.all_reduce(g, group=group)
    res["conv"] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                   "grads": [g.numpy() for g in grads],
                   "stats": [b.numpy().copy() for b in (
                       m.BatchNorm_0.running_mean, m.BatchNorm_0.running_var,
                       m.BatchNorm_1.running_mean,
                       m.BatchNorm_1.running_var)]}

    # train-mode BatchNorm: 'bn' / 'sbn' (global), 'bnt' and the tap
    # head's (local)
    b = inp["bn"]
    per = b["x"].shape[0] // world
    res["bn"] = {}
    for kind, kw in (("bn", {}), ("bnt", dict(batch_only=True)),
                     ("head", dict(cross_rank=False))):
        n = BatchNorm(b["x"].shape[-1], **kw).train()
        with torch.no_grad():
            n.weight.copy_(t(b["scale"]))
            n.bias.copy_(t(b["bias"]))
        set_process_group(n, group)
        x = t(b["x"][rows(r, per)].copy()).requires_grad_()
        y = n(x)
        (y * t(b["cot"][rows(r, per)].copy())).sum().backward()
        res["bn"][kind] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                           "mean": n.running_mean.numpy().copy(),
                           "var": n.running_var.numpy().copy()}

    # halo exchange (forward and gradient) and the sharded stencil apply
    h = inp["halo"]
    per = h["vol"].shape[0] // world
    blk = t(h["vol"][rows(r, per)].copy()).requires_grad_()
    ext = mesh.halo_exchange(blk, h["halo"], 0, group)
    per_ext = per + 2 * h["halo"]
    (ext * t(h["cot"][rows(r, per_ext)].copy())).sum().backward()

    def mean3(v):
        z = torch.zeros_like(v[:1])
        return (torch.cat([z, v[:-1]]) + v + torch.cat([v[1:], z])) / 3.0
    res["halo"] = {"ext": ext.detach().numpy(), "grad": blk.grad.numpy(),
                   "stencil": mesh.sharded_stencil_apply(
                       mean3, t(h["vol"]), 1, group).numpy()}

    # the sharded PCM in float64, whole volumes on every rank
    res["pcm"] = []
    for case in inp["pcm"]:
        pm = PCM(in_ch=case["f"].shape[-1], **case["kw"]).double()
        if case["offsets"] is not None:  # a sub-stencil
            pm.offsets = case["offsets"]
        weights.load_into(pm, case["params"], {})
        with torch.no_grad():
            res["pcm"].append(pcm_sharded(pm, t(case["cam"]), t(case["f"]),
                                          group).numpy())

    # overlap tiles of a stencil-local DC3D in eval mode
    o = inp["overlap"]
    dc = weights.load_into(DC3D(**o["cfg"]), o["params"], o["bs"]).eval()
    with torch.no_grad():
        d, ref = mesh.overlap_tile_infer(
            lambda xb, lb: dc(xb), t(o["x"]), t(o["lobe"]), o["n_tiles"],
            o["halo"], group)
    res["overlap"] = {"dense": d.numpy(), "refined": ref.numpy()}
    return res


def case_losses(inp, r, world, group):
    """gsum and the four losses' batch sums with sample weights, each
    loss's value and its gradient in this rank's probabilities."""
    import torch
    from dram_tpu_torch.core.ops import gsum
    from dram_tpu_torch.losses.bootstrap_bce import BootBinCrossEntropy
    from dram_tpu_torch.losses.equivariance import smooth_l1_masked
    from dram_tpu_torch.losses.interval_reg import (
        compute_enc_loss, compute_reg_loss_with_probs)
    from dram_tpu_torch.losses.refine import IntRegRefineLoss

    per = inp["p"].shape[0] // world
    sl = rows(r, per)

    def t(k):
        return torch.from_numpy(inp[k][sl].copy())

    w = t("w")
    fns = {
        "gsum": lambda p: gsum(p, group),
        "enc": lambda p: compute_enc_loss(p, w, group),
        "enc_unweighted": lambda p: compute_enc_loss(p, None, group),
        "reg": lambda p: compute_reg_loss_with_probs(
            p, t("lobes"), t("lesions"), t("ctss"), 1e-2,
            torch.from_numpy(inp["freq"]), w, group),
        "boot": lambda p: BootBinCrossEntropy(0.1)(
            p, t("target"), t("lobes"), sample_weight=w, group=group),
        "seg": lambda p: IntRegRefineLoss(1e-2, 0.1).compute_seg_loss(
            torch.logit(p), p * 2.0 - 0.5, t("lobes"), t("lesions"),
            t("ctss"), w, group),
        "smooth_l1": lambda p: smooth_l1_masked(
            p, t("other"), t("lobes") > 0, sample_weight=w, group=group),
    }
    res = {}
    for name, fn in fns.items():
        p = t("p").requires_grad_()
        v = fn(p)
        v.backward()
        res[name] = (float(v), p.grad.numpy())
    return res


def case_train(inp, r, world, group):
    """Two data-parallel TrainSteps of a narrow DC3D on this rank's rows
    of the padded batch: loss terms, gradients after the cross-rank mean,
    parameters and buffers after each step (flax layout)."""
    import torch
    from dram_tpu_torch import weights
    from dram_tpu_torch.losses.refine import IntRegRefineLoss
    from dram_tpu_torch.models import DC3D
    from dram_tpu_torch.train import trainer
    from dram_tpu_torch.train.checkpoint import optimizer_state_tree

    v = inp["init"]
    model = weights.load_into(DC3D(**inp["narrow"]), v["params"],
                              v["batch_stats"])
    step = trainer.TrainStep(
        model, IntRegRefineLoss(band_width=1e-2, smoothing=0.1),
        trainer.adam(model.parameters(), lr=inp["lr"]), inp["factors"],
        group=group)
    per = inp["packed"]["images"].shape[0] // world
    local = {k: (a[rows(r, per)] if k != "_packed" else a)
             for k, a in inp["packed"].items()}
    local["weights"] = inp["weights"][rows(r, per)]
    local["ctss_frequency"] = inp["freq"]
    args = trainer.batch_tensors(local, torch.device("cpu"))
    steps = []
    for _ in range(2):
        out = step(**args)
        grads, _ = weights.to_jax({n: p.grad for n, p in
                                   model.named_parameters()})
        params, bs = weights.to_jax(model.state_dict())
        steps.append({"losses": out["losses"].numpy(), "grads": grads,
                      "params": params, "batch_stats": bs,
                      "opt": optimizer_state_tree(step.optimizer, model)})
    return {"steps": steps}


TINY = textwrap.dedent("""
    DB_PATH = {db!r}
    VALID_CSV = {db!r} + "/val.csv"
    TEST_CSV = {db!r} + "/test.csv"
    DEBUG_PATH = {out!r} + "/debug/"
    MODEL_ROOT_PATH = {out!r} + "/models/"
    JOB_RUNNER_CLS = "job_runner.LesionSegChunkTrain"
    EXP_NAME = "tiny"
    MODEL_NAME = "DC3D"
    RESAMPLE_MODE = "fixed_size"
    NUM_EPOCHS = 1
    VAL_EPOCHS = 1
    STATE_EPOCHS = 1
    NUM_WORKERS = 0
    LOG_STEPS = 100
    AUG_RATIO = 0.0
    BALANCED_LABEL_COUNT = 2
    TRAIN_BATCH_SIZE = 3
    RESAMPLE_SPACING = 1.0
    TEST_RESAMPLE_SPACING = 2.0
    RESAMPLE_SIZE = (16, 16, 16)
    LOSS_FACTORS = [2.0, 1.0]
    PAD_VALUE = -2048
    WINDOWING_MAX = -300
    WINDOWING_MIN = -1000
    NR_CLASS = 1
    COMPUTE_DTYPE = "float32"
    RELOAD_CHECKPOINT = False
    RELOAD_CHECKPOINT_PATH = None
    RELOAD_DICT_LIST = ["model", "optimizer", "metrics"]
    PER_PROCESS_LOADING = {per_rank}
    DP_BATCH_MODE = {mode!r}
    LOGGING = {{}}
    MODEL = {{
        "method": "models.DC3D",
        "n_layers": 2,
        "base_ch_list": [4, 8, 16, 16, 8],
        "end_ch_list": [8, 16, 32, 16, 8],
        "stacking": 2,
        "out_ch": 1,
    }}
    INITIALIZER = {{"method": "models.HeNorm", "mode": "fan_in"}}
    OPTIMIZER = {{"method": "torch.optim.Adam", "lr": 0.001}}
    SCHEDULER = {{"method": "torch.optim.lr_scheduler.ExponentialLR",
                  "gamma": 0.9}}
    LOSS_FUNC = {{"method": "metrics.IntRegRefineLoss",
                  "band_width": 1e-2, "smoothing": 0.1}}
""")


def case_epochs(inp, r, world, group):
    """One epoch of the training CLI, then a runner reloaded from its
    checkpoint: which files each rank wrote, the final parameters, and
    whether the reload holds them and the Adam state bitwise. With
    per-rank loading the global batch is 3 ("pad": one rank's last row is
    padding); without, TRAIN_BATCH_SIZE 2 a rank ("scale", global 4)."""
    import torch
    from dram_tpu_torch import weights
    from dram_tpu_torch.train import chunk_train, runner
    from dram_tpu_torch.train.__main__ import main
    from dram_tpu_torch.train.checkpoint import optimizer_state_tree
    from dram_tpu_torch.utils import Settings

    writes = []

    def counted(fn, what):
        def wrapped(*a, **k):
            writes.append(what)
            return fn(*a, **k)
        return wrapped
    runner.save_checkpoint = counted(runner.save_checkpoint, "checkpoint")
    chunk_train.write_records = counted(chunk_train.write_records,
                                        "records")
    out = {}
    for per_rank in (True, False):
        root = os.path.join(inp["out"], f"per_rank_{per_rank}")
        smp = os.path.join(inp["out"], f"tiny_{per_rank}.py")
        if r == 0:
            os.makedirs(root, exist_ok=True)
            with open(smp, "w") as fp:
                fp.write(TINY.format(db=inp["db"], out=root,
                                     per_rank=per_rank,
                                     mode="pad" if per_rank else "scale"))
        torch.distributed.barrier(group)
        del writes[:]
        run = main(["0", "0.001", "--batch_size", "3" if per_rank else "2",
                    "--smp", smp, "--device", "cpu"])
        params, bs = weights.to_jax(run.model.state_dict())
        opt = optimizer_state_tree(run.optimizer, run.model)
        s = Settings(smp)
        s.RELOAD_CHECKPOINT = True
        again = chunk_train.LesionSegChunkTrain(s, device="cpu")
        p2, bs2 = weights.to_jax(again.model.state_dict())
        opt2 = optimizer_state_tree(again.optimizer, again.model)
        out[per_rank] = {
            "writes": sorted(writes), "params": params, "bs": bs,
            "global_batch": run.loader_batch_size,
            "epoch_losses": run.history[0]["losses"],
            "val": run.model_metrics_save_dict.get("val_acc_reg_cls"),
            "reload_equal": _tree_equal((params, bs, opt),
                                        (p2, bs2, opt2)),
            "files": sorted(os.listdir(os.path.join(root, "models",
                                                    "tiny")))}
        torch.distributed.barrier(group)
    return out


def _tree_equal(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            _tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_tree_equal(x, y)
                                        for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def case_guard(inp, r, world, group):
    """gsum of the rank's number over the ranks (the import guard)."""
    import torch
    from dram_tpu_torch.core.ops import gsum
    return {"sum": float(gsum(torch.tensor([float(r + 1)]), group))}


CASES = {"library": case_library, "losses": case_losses,
         "train": case_train, "epochs": case_epochs, "guard": case_guard}


def main():
    case, r, world, port, out_dir = sys.argv[1:6]
    os.environ.update(RANK=r, WORLD_SIZE=world, LOCAL_RANK=r,
                      LOCAL_WORLD_SIZE=world, MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port)
    import torch
    torch.set_num_threads(1)
    from dram_tpu_torch.core import mesh
    assert mesh.maybe_init_distributed("cpu")
    group = mesh.data_group()
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as fp:
        inp = pickle.load(fp)
    res = CASES[case](inp, int(r), int(world), group)
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as fp:
        pickle.dump(res, fp)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
