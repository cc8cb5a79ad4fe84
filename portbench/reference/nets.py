"""DC3D and DC3DATGeneric as functions of a parameter dict, NCDHW,
float32.

DC3D (a 3-level 3-D U-Net regressing a dense lesion logit): per level a
stack of two 3x3x3 zero-padded convs without bias, each followed by
BatchNorm (eps 1e-5) and ReLU; 2x max pooling on the way down; on the
way up an align-corners trilinear 2x upsample concatenated with the
level's pre-pool features [upsampled, skip], then the stack; a 1x1x1
conv with bias to one channel. DC3DATGeneric adds detached taps of the
input and of the first two encoder levels' pre-pool features, each
level's through a 1x1x1 conv (bias) + BatchNorm + ReLU head of 8
channels, all resized (align-corners trilinear) to the attention grid
and concatenated (1 + 8 + 8 = 17 channels); the dense logit resized to
that grid is refined by the PCM: theta and phi dense layers (17 -> 8) of
the features, G (1 -> 8) of the logit, per voxel a softmax over the
valid voxels of its stencil (offsets within L1 distance 2 in the 3^3
cube, no self loop) of relu(theta_i . phi_j) / sqrt(valid count), the
weighted sum of G over them, r (8 -> 1); the result resized back to the
chunk. BatchNorm uses the batch's statistics (biased variance) in
training, and moves the running statistics by 0.1 toward them; in eval
it uses the running statistics.

Parameters are named as the flax tree names them (module names joined
with dots; conv weight (Co, Ci, 3, 3, 3); dense weight (out, in)).
"""

import torch
import torch.nn.functional as F

from .quant import exact

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def _bn(x, P, name, train, new_stats):
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if not train:
        rm, rv = P[f"{name}.running_mean"], P[f"{name}.running_var"]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = (torch.rsqrt(rv + BN_EPS) * w).reshape(shape)
        return (x - rm.reshape(shape)) * mul + b.reshape(shape)
    with torch.no_grad():
        dims = [0] + list(range(2, x.dim()))
        mean = x.mean(dims)
        var = x.var(dims, unbiased=False)
        m = BN_MOMENTUM
        new_stats[f"{name}.running_mean"] = \
            m * P[f"{name}.running_mean"] + (1 - m) * mean
        new_stats[f"{name}.running_var"] = \
            m * P[f"{name}.running_var"] + (1 - m) * var
    return F.batch_norm(x, None, None, w, b, training=True, momentum=0.0,
                        eps=BN_EPS)


def _stack(x, P, name, train, q, st):
    for i in range(2):
        x = F.conv3d(q(x), q(P[f"{name}.convs.conv_{i}.weight"]), padding=1)
        x = torch.relu(_bn(x, P, f"{name}.convs.BatchNorm_{i}", train, st))
    return x


def _dense1x1(x, P, name, q):
    w = P[f"{name}.weight"]
    return F.conv3d(q(x), q(w.reshape(w.shape[0], w.shape[1], 1, 1, 1)),
                    P[f"{name}.bias"])


def resize(x, size):
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="trilinear",
                         align_corners=True)


def backbone(x, P, pre, n_layers, train, q, st):
    """(dense logit (B, 1, D, H, W), pre-pool encoder features)."""
    feats, h = [], x
    for i in range(n_layers):
        f = _stack(h, P, f"{pre}ds_{i}", train, q, st)
        feats.append(f)
        h = F.max_pool3d(f, 2)
    h = _stack(h, P, f"{pre}bg", train, q, st)
    for i in range(n_layers):
        up = F.interpolate(h, scale_factor=2, mode="trilinear",
                           align_corners=True)
        h = _stack(torch.cat([up, feats[n_layers - 1 - i]], 1), P,
                   f"{pre}us_{i}", train, q, st)
    dense = _dense1x1(h, P, f"{pre}top_layer", q)
    return resize(dense, x.shape[2:]), feats


def stencil_offsets():
    """The 3^3 cube's offsets within L1 distance 2 of the centre, the
    centre left out, in (z, y, x) lexicographic order."""
    r = (-1, 0, 1)
    return [(a, b, c) for a in r for b in r for c in r
            if 0 < abs(a) + abs(b) + abs(c) <= 2]


def _shifted(x, off):
    """x[..., i + off] (channels first); positions off the volume wrap
    and are masked by the caller."""
    return torch.roll(x, shifts=(-off[0], -off[1], -off[2]), dims=(2, 3, 4))


def _valid(spatial, off, device):
    out = torch.ones(spatial, dtype=torch.bool, device=device)
    for ax, o in enumerate(off):
        i = torch.arange(spatial[ax], device=device) + o
        ok = (i >= 0) & (i < spatial[ax])
        shape = [1, 1, 1]
        shape[ax] = -1
        out = out & ok.reshape(shape)
    return out


def _linear(x, P, name, q):
    """Dense layer over the channel axis of (B, C, D, H, W)."""
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    y = torch.einsum("bcdhw,oc->bodhw", q(x), q(w))
    return y + b.reshape(1, -1, 1, 1, 1)


def pcm(cam, feat, P, pre, q):
    theta = _linear(feat, P, f"{pre}theta", q)
    phi = _linear(feat, P, f"{pre}phi", q)
    g = _linear(cam, P, f"{pre}G", q)
    spatial = tuple(cam.shape[2:])
    offs = stencil_offsets()
    valid = torch.stack([_valid(spatial, o, cam.device) for o in offs])
    deg = valid.sum(0).clamp(min=1).float()
    logits = torch.stack([(theta * _shifted(phi, o)).sum(1) for o in offs],
                         1)  # (B, K, D, H, W)
    logits = torch.relu(logits) / torch.sqrt(deg)
    logits = logits.masked_fill(~valid[None], float("-inf"))
    w = torch.softmax(logits, dim=1)
    out = sum(w[:, k:k + 1] * _shifted(g, o) for k, o in enumerate(offs))
    return _linear(out, P, f"{pre}r", q)


def forward(x, P, model_cfg, train, q=exact, new_stats=None):
    """x (B, 1, D, H, W) f32 -> (dense, refined) logits (B, 1, D, H, W);
    `new_stats` (a dict) receives the moved running statistics in
    training."""
    st = {} if new_stats is None else new_stats
    n = model_cfg["n_layers"]
    if model_cfg["method"] == "models.DC3D":
        dense, _ = backbone(x, P, "", n, train, q, st)
        return dense, dense
    if model_cfg["method"] != "models.DC3DATGeneric":
        raise NotImplementedError(model_cfg["method"])
    layers = sorted(model_cfg["at_layers"])
    if (layers != [-1, 0, 1] or model_cfg["at_k_size"] != 3
            or model_cfg["at_merge_type"] != "scaled_dot_product_relu"
            or model_cfg["at_self_loop"] or model_cfg["at_g_iter"] != 1
            or model_cfg["at_p_enc_dim"] or model_cfg["at_geo_f_dim"]):
        raise NotImplementedError("the reference covers the flagship's PCM")
    dense, feats = backbone(x, P, "backbone.", n, train, q, st)
    grid = tuple(model_cfg["at_spatial_size"])
    taps = [resize(x, grid)]
    for i in (0, 1):
        t = _dense1x1(feats[i].detach(), P, f"reshape_{i}.conv", q)
        t = torch.relu(_bn(t, P, f"reshape_{i}.bn", train, st))
        taps.append(resize(t, grid))
    refined = pcm(resize(dense, grid), torch.cat(taps, 1), P,
                  "attention_module.", q)
    return dense, resize(refined, x.shape[2:])
