"""3x3x3 convolutions of the DC3D conv stack on NDHWC volumes: the eval
conv with the BatchNorm affine and ReLU in its epilogue, the training
forward (prologue affine+ReLU, per-channel statistics), the input
gradient (flipped weights, split output), the weight gradient, and the
differentiable two-conv stack built from them. The input may come in two
parts that act as one channel concat.

Port of dram_tpu/core/pallas/fused_stack.py: conv_cm (kernel _cbr_kernel)
in its eval, training and dx uses, conv_dw_cm (kernel _dw_kernel_pro), and
the custom VJP of fused_cbr2 (_fused_cbr2_vjp :531-689) as
ConvStackFunction. CUDA sources: csrc/conv3x3x3.cu, csrc/conv3x3x3_dw.cu.
The launchers launch_train, launch_dx and launch_dw are shared with the
unfused stack's raw conv (kernels/conv3d.py); each wrapper counts its own
launches.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build


def fold_bn(gamma, beta, mean, var, eps=1e-5):
    """BatchNorm as one per-channel (scale, shift) in f32
    (dram_tpu fused_stack._affine_from_stats)."""
    s = gamma.float() * torch.rsqrt(var.float() + eps)
    return s, beta.float() - mean.float() * s


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(y, dtype):
    return y.permute(0, 2, 3, 4, 1).to(dtype).contiguous()


def _cat(x1, x2):
    return x1 if x2 is None else torch.cat([x1, x2], dim=-1)


def _prologue_plain(x, prologue):
    """relu(x * s + t) in f32, rounded once to x's dtype (the kernel's
    staged-input prologue); zero padding is added after it by F.conv3d."""
    if prologue is None:
        return x.float()
    s, t = prologue
    return torch.relu(x.float() * s.float() + t.float()).to(x.dtype).float()


def _check_parts(name, x1, x2):
    B, D, H, W, C1 = x1.shape
    _build.check_operand(x1, torch.bfloat16, f"{name} x1")
    if x2 is None:
        return C1, 0
    if tuple(x2.shape[:4]) != (B, D, H, W):
        raise ValueError(f"{name}: part shapes differ {tuple(x1.shape)} vs "
                         f"{tuple(x2.shape)}")
    _build.check_operand(x2, torch.bfloat16, f"{name} x2")
    return C1, x2.shape[-1]


def _kernel_weight(w, Ci, C1, C2, name, device):
    """(Co, Ci, 3, 3, 3) -> the kernels' (27, Ci, Co) bf16 layout."""
    Co = w.shape[0]
    if w.shape[1] != C1 + C2 or tuple(w.shape[2:]) != (3, 3, 3):
        raise ValueError(f"{name}: weight {tuple(w.shape)} does not fit "
                         f"{C1} + {C2} input channels")
    wk = w.permute(2, 3, 4, 1, 0).reshape(27, Ci, Co) \
        .to(device=device, dtype=torch.bfloat16).contiguous()
    _build.check_operand(wk, torch.bfloat16, f"{name} w")
    return wk


def _f32_vec(v, device):
    return v.to(device=device, dtype=torch.float32).contiguous()


def _colsum(src, nrows, ncols):
    """Column sums of a (nrows, ncols) f32 CUDA buffer in two fixed-order
    passes of csrc colsum_f32 (rows split over up to 256 chunks, then the
    chunks added)."""
    nsplit = max(1, min(256, nrows // 64))
    mid = torch.empty((nsplit, ncols), dtype=torch.float32,
                      device=src.device)
    _build.launch("colsum_f32", src.data_ptr(), nrows, ncols, nsplit,
                  mid.data_ptr())
    if nsplit == 1:
        return mid[0]
    out = torch.empty((ncols,), dtype=torch.float32, device=src.device)
    _build.launch("colsum_f32", mid.data_ptr(), nsplit, ncols, 1,
                  out.data_ptr())
    return out


# --- eval mode --------------------------------------------------------------


def conv3x3x3_plain(x1, w, scale, shift, x2=None):
    """relu(conv3d([x1, x2], w) * scale + shift), F.conv3d in f32.

    x1: (B, D, H, W, C1) and optional x2: (B, D, H, W, C2), concatenated
    along channels; w: (Co, C1 + C2, 3, 3, 3), rounded to x1's dtype as
    the kernel rounds it; scale, shift: (Co,) f32. Returns
    (B, D, H, W, Co) in x1's dtype."""
    x = _cat(x1, x2)
    y = F.conv3d(_ncdhw(x).float(), w.to(x1.dtype).float(), padding=1)
    y = torch.relu(y * scale.float()[:, None, None, None]
                   + shift.float()[:, None, None, None])
    return _ndhwc(y, x1.dtype)


def conv3x3x3(x1, w, scale, shift, x2=None):
    """Kernel wrapper of conv3x3x3_plain: CUDA tensors launch
    csrc/conv3x3x3.cu (bf16 activations; w is cast to bf16 in the
    kernel's (27, Ci, Co) layout); CPU tensors take the plain version.

    The eval conv has no gradient on CUDA: with grad enabled and an
    operand that requires grad it raises rather than return a result
    without autograd history. Nothing trains an eval-mode stack (the
    inference pipeline's model stage runs under torch.no_grad); a stack in
    train mode runs ConvStackFunction."""
    if not x1.is_cuda:
        return conv3x3x3_plain(x1, w, scale, shift, x2)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x1, x2, w, scale, shift)):
        raise RuntimeError(
            "conv3x3x3: the CUDA eval conv has no gradient; call it under "
            "torch.no_grad() or put the stack in train mode")
    B, D, H, W, _ = x1.shape
    C1, C2 = _check_parts("conv3x3x3", x1, x2)
    Co = w.shape[0]
    wk = _kernel_weight(w, C1 + C2, C1, C2, "conv3x3x3", x1.device)
    scale, shift = _f32_vec(scale, x1.device), _f32_vec(shift, x1.device)
    y = torch.empty((B, D, H, W, Co), dtype=torch.bfloat16, device=x1.device)
    _build.launch("conv3x3x3_bf16", x1.data_ptr(), C1,
                  x2.data_ptr() if x2 is not None else None, C2,
                  wk.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                  y.data_ptr(), B, D, H, W, Co)
    conv3x3x3.launches += 1
    return y


conv3x3x3.launches = 0


# --- training forward ---------------------------------------------------------


def conv3x3x3_train_plain(x1, w, x2=None, prologue=None, stats=False):
    """Raw conv3d(prologue([x1, x2]), w) in f32 (conv_cm with
    prologue/stats). prologue: optional (s, t) per input channel.

    Returns (y in x1's dtype, stats): stats is the (2, Co) f32 per-channel
    [sum, sum of squares] of the f32 conv output before rounding, or None
    when `stats` is false."""
    x = _prologue_plain(_cat(x1, x2), prologue)
    y = F.conv3d(_ncdhw(x), w.to(x1.dtype).float(), padding=1)
    st = torch.stack([y.sum((0, 2, 3, 4)), (y * y).sum((0, 2, 3, 4))]) \
        if stats else None
    return _ndhwc(y, x1.dtype), st


def conv3x3x3_train(x1, w, x2=None, prologue=None, stats=False):
    """Kernel wrapper of conv3x3x3_train_plain: CUDA tensors launch
    csrc/conv3x3x3.cu in its training modes (the statistics reduce their
    per-block rows in colsum_f32); CPU tensors take the plain version."""
    if not x1.is_cuda:
        return conv3x3x3_train_plain(x1, w, x2, prologue, stats)
    y, st = launch_train(x1, w, x2, prologue, stats, "conv3x3x3_train")
    conv3x3x3_train.launches += 1
    return y, st


def launch_train(x1, w, x2, prologue, stats, name):
    """One launch of conv3x3x3_train_bf16 on CUDA tensors (raw output,
    optional prologue and statistics); the callers count it."""
    B, D, H, W, _ = x1.shape
    C1, C2 = _check_parts(name, x1, x2)
    Co = w.shape[0]
    wk = _kernel_weight(w, C1 + C2, C1, C2, name, x1.device)
    ps = pt = None
    if prologue is not None:
        ps, pt = (_f32_vec(v, x1.device) for v in prologue)
    y = torch.empty((B, D, H, W, Co), dtype=torch.bfloat16, device=x1.device)
    nblk = -(-(B * D * H * W) // 64)
    part = torch.empty((nblk, 2 * Co), dtype=torch.float32,
                       device=x1.device) if stats else None
    _build.launch("conv3x3x3_train_bf16", x1.data_ptr(), C1,
                  x2.data_ptr() if x2 is not None else None, C2,
                  wk.data_ptr(), ps.data_ptr() if ps is not None else None,
                  pt.data_ptr() if pt is not None else None, y.data_ptr(),
                  Co, None, 0, part.data_ptr() if stats else None,
                  B, D, H, W)
    st = _colsum(part, nblk, 2 * Co).view(2, Co) if stats else None
    return y, st


conv3x3x3_train.launches = 0


# --- input gradient -------------------------------------------------------------


def _flip_w(w):
    """Weights of the transposed conv: in/out swapped, taps flipped
    (fused_stack._flip_wk)."""
    return w.transpose(0, 1).flip(2, 3, 4)


def conv3x3x3_dx_plain(dy, w, split=None):
    """Input gradient of a 3x3x3 SAME conv with weight w (Co, Ci, 3, 3, 3)
    from its output cotangent dy (B, D, H, W, Co), in f32, returned in
    dy's dtype: (B, D, H, W, Ci), or its two channel parts when
    split = (C1, C2)."""
    y = F.conv3d(_ncdhw(dy).float(), _flip_w(w).to(dy.dtype).float(),
                 padding=1)
    dx = _ndhwc(y, dy.dtype)
    if split is None:
        return dx
    return dx[..., :split[0]].contiguous(), dx[..., split[0]:].contiguous()


def conv3x3x3_dx(dy, w, split=None):
    """Kernel wrapper of conv3x3x3_dx_plain: CUDA tensors launch
    csrc/conv3x3x3.cu on the flipped weights, writing the two parts of a
    split straight into their own tensors; CPU tensors take the plain
    version."""
    if not dy.is_cuda:
        return conv3x3x3_dx_plain(dy, w, split)
    dx = launch_dx(dy, w, split, "conv3x3x3_dx")
    conv3x3x3_dx.launches += 1
    return dx


def launch_dx(dy, w, split, name):
    """One launch of conv3x3x3_train_bf16 on the flipped weights of w for
    a CUDA cotangent dy; the callers count it."""
    B, D, H, W, Co = dy.shape
    _build.check_operand(dy, torch.bfloat16, f"{name} dy")
    Ci = w.shape[1]
    if w.shape[0] != Co:
        raise ValueError(f"{name}: weight {tuple(w.shape)} does not "
                         f"fit {Co} cotangent channels")
    c1, c2 = split if split is not None else (Ci, 0)
    if c1 + c2 != Ci:
        raise ValueError(f"{name}: split {split} of {Ci} channels")
    wk = _kernel_weight(_flip_w(w), Co, Co, 0, name, dy.device)
    y1 = torch.empty((B, D, H, W, c1), dtype=torch.bfloat16, device=dy.device)
    y2 = torch.empty((B, D, H, W, c2), dtype=torch.bfloat16,
                     device=dy.device) if c2 else None
    _build.launch("conv3x3x3_train_bf16", dy.data_ptr(), Co, None, 0,
                  wk.data_ptr(), None, None, y1.data_ptr(), c1,
                  y2.data_ptr() if c2 else None, c2, None, B, D, H, W)
    return y1 if split is None else (y1, y2)


conv3x3x3_dx.launches = 0


# --- weight gradient ------------------------------------------------------------


def conv3x3x3_dw_plain(x1, dy, x2=None, prologue=None):
    """f32 weight gradient (Co, Ci, 3, 3, 3) of the raw conv of
    prologue([x1, x2]) with output cotangent dy (conv_dw_cm), through
    aten's convolution_backward in f32."""
    x = _prologue_plain(_cat(x1, x2), prologue)
    Co, Ci = dy.shape[-1], x.shape[-1]
    w = torch.zeros((Co, Ci, 3, 3, 3), dtype=torch.float32, device=x.device)
    _, dw, _ = torch.ops.aten.convolution_backward(
        _ncdhw(dy).float(), _ncdhw(x), w, None, [1, 1, 1], [1, 1, 1],
        [1, 1, 1], False, [0, 0, 0], 1, [False, True, False])
    return dw


# split-K target: enough blocks for ~16 resident on each of the 132 SMs
DW_TARGET_BLOCKS = 132 * 16


def dw_split(M, Co, V):
    """(K chunk in voxels, number of chunks) for the weight-gradient
    kernel: enough chunks to fill the card, each a multiple of 32 voxels
    and at least 256 of them."""
    tiles = -(-M // 64) * -(-Co // 64)
    n = max(1, min(-(-DW_TARGET_BLOCKS // tiles), V // 256))
    kchunk = -(-V // n)
    kchunk = -(-kchunk // 32) * 32
    return kchunk, -(-V // kchunk)


def conv3x3x3_dw(x1, dy, x2=None, prologue=None):
    """Kernel wrapper of conv3x3x3_dw_plain: CUDA tensors launch
    csrc/conv3x3x3_dw.cu (split K, f32 partial tiles) and colsum_f32
    (adds the partials in a fixed order); CPU tensors take the plain
    version."""
    if not x1.is_cuda:
        return conv3x3x3_dw_plain(x1, dy, x2, prologue)
    dw = launch_dw(x1, dy, x2, prologue, "conv3x3x3_dw")
    conv3x3x3_dw.launches += 1
    return dw


def launch_dw(x1, dy, x2, prologue, name):
    """One launch of conv3x3x3_dw_bf16 (and its colsum_f32 passes) on CUDA
    tensors: the f32 (Co, Ci, 3, 3, 3) weight gradient; the callers count
    it."""
    B, D, H, W, _ = x1.shape
    C1, C2 = _check_parts(name, x1, x2)
    _build.check_operand(dy, torch.bfloat16, f"{name} dy")
    if tuple(dy.shape[:4]) != (B, D, H, W):
        raise ValueError(f"{name}: dy {tuple(dy.shape)} does not fit "
                         f"x {tuple(x1.shape)}")
    Ci, Co = C1 + C2, dy.shape[-1]
    ps = pt = None
    if prologue is not None:
        ps, pt = (_f32_vec(v, x1.device) for v in prologue)
    M, V = 27 * Ci, B * D * H * W
    kchunk, nsplit = dw_split(M, Co, V)
    part = torch.empty((nsplit, M * Co), dtype=torch.float32,
                       device=x1.device)
    _build.launch("conv3x3x3_dw_bf16", x1.data_ptr(), C1,
                  x2.data_ptr() if x2 is not None else None, C2,
                  ps.data_ptr() if ps is not None else None,
                  pt.data_ptr() if pt is not None else None, dy.data_ptr(),
                  Co, B, D, H, W, kchunk, nsplit, part.data_ptr())
    dw = _colsum(part, nsplit, M * Co) if nsplit > 1 else part[0]
    return dw.view(3, 3, 3, Ci, Co).permute(4, 3, 0, 1, 2).contiguous()


conv3x3x3_dw.launches = 0


# --- the two-conv stack with its gradient ---------------------------------------


def bn_batch_stats(st, n):
    """(sum, sum of squares) over n elements -> flax's batch mean and
    biased variance E[x^2] - E[x]^2, clamped at 0 (fused_stack._bn_stats)."""
    mean = st[0] / n
    return mean, torch.clamp(st[1] / n - mean * mean, min=0.0)


def bn_relu_backward(d_post, out, gamma, beta, mean, var, eps):
    """Backward of relu(BN_train(out)) at batch statistics (mean, var):
    the train branch of fused_stack._bn_back_cm (:600-634), in f32.
    Returns (d_out in out's dtype, dgamma, dbeta)."""
    inv = torch.rsqrt(var + eps)
    s = gamma * inv
    of = out.float()
    dims = tuple(range(of.dim() - 1))
    n = math.prod(of.shape[:-1])
    dp = torch.where(of * s + (beta - mean * s) > 0, d_post.float(), 0.0)
    xhat = (of - mean) * inv
    dbeta = dp.sum(dims)
    dgamma = (dp * xhat).sum(dims)
    d_out = inv * (dp * gamma - (dbeta * gamma) / n
                   - xhat * ((dgamma * gamma) / n))
    return d_out.to(out.dtype), dgamma, dbeta


class ConvStackFunction(torch.autograd.Function):
    """(3x3x3 conv -> train-mode BatchNorm -> ReLU) x 2 on batch
    statistics: the forward and custom VJP of fused_stack.fused_cbr2
    (_fused_fwd :541-589, _vjp_bwd :637-689). Saves the input, the raw
    bf16 conv outputs and the batch statistics, never a normalized
    tensor.

    apply(x1, x2, w0, g0, b0, w1, g1, b1, eps) ->
    (y, mean0, var0, mean1, var1); x2 may be None (one input part)."""

    @staticmethod
    def forward(ctx, x1, x2, w0, g0, b0, w1, g1, b1, eps):
        n = float(math.prod(x1.shape[:4]))
        out0, st0 = conv3x3x3_train(x1, w0, x2=x2, stats=True)
        bm0, bv0 = bn_batch_stats(st0, n)
        s0, t0 = fold_bn(g0, b0, bm0, bv0, eps)
        out1, st1 = conv3x3x3_train(out0, w1, prologue=(s0, t0), stats=True)
        bm1, bv1 = bn_batch_stats(st1, n)
        s1, t1 = fold_bn(g1, b1, bm1, bv1, eps)
        y = torch.relu(out1.float() * s1 + t1).to(x1.dtype)
        ctx.save_for_backward(x1, x2, w0, g0, b0, w1, g1, b1, out0, out1,
                              bm0, bv0, bm1, bv1)
        ctx.eps = eps
        ctx.mark_non_differentiable(bm0, bv0, bm1, bv1)
        return y, bm0, bv0, bm1, bv1

    @staticmethod
    def backward(ctx, dy, *_unused_stat_grads):
        (x1, x2, w0, g0, b0, w1, g1, b1, out0, out1,
         bm0, bv0, bm1, bv1) = ctx.saved_tensors
        eps = ctx.eps
        # cotangents between kernels in the activation dtype
        # (_bn_back_cm returns d_out.astype(dt)); weight gradients in f32
        dout1, dg1, db1 = bn_relu_backward(dy, out1, g1, b1, bm1, bv1, eps)
        s0, t0 = fold_bn(g0, b0, bm0, bv0, eps)
        da = conv3x3x3_dx(dout1, w1)
        dw1 = conv3x3x3_dw(out0, dout1, prologue=(s0, t0))
        dout0, dg0, db0 = bn_relu_backward(da, out0, g0, b0, bm0, bv0, eps)
        dx1 = dx2 = None
        # the network-entry stack's input, the CT chunk, needs no gradient:
        # its dx conv is skipped (JAX zero-pads that stack's input to 8
        # channels and runs it fused, models/blocks.py:235-242; its
        # _vjp_bwd computes the dx and the model drops it)
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            if x2 is None:
                dx1 = conv3x3x3_dx(dout0, w0)
            else:
                dx1, dx2 = conv3x3x3_dx(dout0, w0, split=(x1.shape[-1],
                                                          x2.shape[-1]))
        dw0 = conv3x3x3_dw(x1, dout0, x2=x2)
        return dx1, dx2, dw0, dg0, db0, dw1, dg1, db1, None
