"""Three training steps of the reference: the interval-regression +
refinement loss (IntRegRefineLoss of the configuration), backward by
autograd, Adam (torch.optim.Adam's update, written out), BatchNorm's
running statistics moved by each step's batch statistics."""

import torch

from . import exact_f32
from .nets import forward
from .quant import QUANTS

CTSS_RATIO_LB = (0.0, 0.001, 0.01, 0.05, 0.35, 0.5)
CTSS_RATIO_UB = (0.001, 0.01, 0.05, 0.35, 0.5, 1.00001)


def reg_loss(dense, lobe, cand, ctss, freq, band_width):
    """The squared-hinge loss of the lobe's predicted lesion ratio
    against the CTSS interval intersected with a band around the
    intensity candidates' ratio, weighted by 1 / clamp(freq, 0.2, 0.8),
    summed over the batch."""
    dims = (1, 2, 3, 4)
    probs = torch.sigmoid(dense)
    lob = (lobe > 0).float()
    n = lob.sum(dims).clamp(min=1e-12)
    rub = ((cand > 0).float() * lob).sum(dims) / n
    pred = (probs * lob).sum(dims) / n
    lb = (rub - band_width).clamp(min=0.0)
    ub = (rub + band_width).clamp(max=1.0)
    clb = torch.tensor(CTSS_RATIO_LB, device=dense.device)[ctss]
    cub = torch.tensor(CTSS_RATIO_UB, device=dense.device)[ctss]
    lo, hi = torch.maximum(clb, lb), torch.minimum(cub, ub)
    empty, below = hi < lo, ub <= clb
    lo = torch.where(empty, torch.where(below, lb, clb), lo)
    hi = torch.where(empty, torch.where(below, ub, cub), hi)
    k = (0.5 * (hi - lo)) ** 2
    loss = torch.clamp((pred - (hi + lo) / 2.0) ** 2 - k, min=0.0)
    return (loss / torch.clamp(freq[ctss], 0.2, 0.8)).sum()


def seg_loss(dense, refined, lobe, cand, ctss, smoothing, eps=1e-7):
    """The bootstrapped, class-balanced BCE of the refined head against
    the pseudo labels (first head's sigmoid > 0.5, inside the lobe, an
    intensity candidate, in a chunk of CTSS > 0), pooled over the
    batch."""
    with torch.no_grad():
        pos = (ctss.float() >= 1e-7).reshape(-1, 1, 1, 1, 1)
        t = ((torch.sigmoid(dense) > 0.5) & (lobe > 0) & (cand > 0)
             & pos).float()
    p = torch.sigmoid(refined)
    inside = (lobe > 0).float()
    outside = 1.0 - inside

    def nll_of(tt):
        pt = p * tt + (1.0 - p) * (1.0 - tt)
        return -torch.log(torch.clamp(pt, eps, 1.0 - eps))

    def mean_over(x, m):
        return (x * m).sum() / torch.clamp(m.sum(), min=1e-12)
    nll = nll_of(t)
    bceo = mean_over(nll, outside)
    n_in = inside.sum()
    alpha = torch.clamp(1.0 - (t * inside).sum() / n_in.clamp(min=1e-12),
                        0.25, 0.75)
    w = (alpha * t + (1.0 - alpha) * (1.0 - t)) * inside
    bce = mean_over(nll, w)
    boot = mean_over(nll_of((p > 0.5).float()), inside)
    inside_term = (1.0 - smoothing) * bce + smoothing * boot
    return bceo + torch.where(n_in > 0, inside_term,
                              torch.zeros_like(inside_term))


def steps(P0, batches, cfg, n_steps=3, quant="exact", rows=None):
    """`n_steps` steps from the parameters and buffers P0 ({name: f32
    tensor} on the device) over `batches` ({"image" (B, S, S, S) f32,
    "lobe", "lesion" u8, "ctss" (B,), "freq" (6,)}); `rows` keeps only
    the first rows of every batch (a fault read in the reference's
    place). Returns {"loss": per-step totals, "grads": step 1's
    gradients, "state": parameters and buffers after the last step}."""
    q = QUANTS[quant]
    model_cfg = cfg["MODEL"]
    loss_cfg = cfg["LOSS_FUNC"]
    if loss_cfg["method"] != "metrics.IntRegRefineLoss":
        raise NotImplementedError(loss_cfg["method"])
    factors = cfg["LOSS_FACTORS"]
    opt = cfg["OPTIMIZER"]
    lr = float(opt.get("lr", 1e-4))
    b1, b2 = (float(b) for b in opt.get("betas", (0.9, 0.999)))
    eps = float(opt.get("eps", 1e-8))
    if opt["method"] != "torch.optim.Adam" or opt.get("weight_decay"):
        raise NotImplementedError("the reference's optimizer is Adam")
    names = [k for k in P0 if not k.endswith(("running_mean",
                                              "running_var"))]
    P = {k: v.detach().clone() for k, v in P0.items()}
    m = {k: torch.zeros_like(P[k]) for k in names}
    v = {k: torch.zeros_like(P[k]) for k in names}
    out = {"loss": [], "grads": None}
    with exact_f32():
        for t in range(1, n_steps + 1):
            b = batches[(t - 1) % len(batches)]
            sl = slice(None) if rows is None else slice(0, rows)
            x = b["image"][sl].float()[:, None]
            lobe, cand = b["lobe"][sl][:, None], b["lesion"][sl][:, None]
            ctss = b["ctss"][sl].long()
            for k in names:
                P[k].requires_grad_(True)
            new_stats = {}
            dense, refined = forward(x, P, model_cfg, True, q, new_stats)
            terms = (reg_loss(dense, lobe, cand, ctss, b["freq"],
                              float(loss_cfg["band_width"])),
                     seg_loss(dense, refined, lobe, cand, ctss,
                              float(loss_cfg["smoothing"])))
            total = sum(f * l for f, l in zip(factors, terms))
            grads = torch.autograd.grad(total, [P[k] for k in names],
                                        allow_unused=True)
            del dense, refined
            out["loss"].append(float(total.detach()))
            with torch.no_grad():
                g = {k: (gr if gr is not None else torch.zeros_like(P[k]))
                     for k, gr in zip(names, grads)}
                if t == 1:
                    out["grads"] = {k: gr.clone() for k, gr in g.items()}
                for k in names:
                    P[k] = P[k].detach()
                    m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                    denom = (v[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                    P[k] = P[k] - (lr / (1 - b1 ** t)) * m[k] / denom
                for k, s in new_stats.items():
                    P[k] = s
            del grads, g
    out["state"] = P
    return out
