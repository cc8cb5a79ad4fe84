"""The raw 3x3x3 SAME convolution of the unfused conv stack, NDHWC, and its
gradient as an autograd Function.

Port of dram_tpu/core/pallas/conv3d.py: `conv3d_pallas` (:212, forward
`_fwd_impl` :168 -> pallas_call :186) and its custom VJP `_vjp_bwd` (:230:
dx is the forward on flipped, channel-swapped weights; dW the
pallas_call :250, kernel `_dw_kernel` :107, returned in the weight's
dtype). The JAX package reaches it through `PallasConv3d`
(dram_tpu/models/blocks.py:100) on the unfused stack. No new CUDA source:
the raw conv is csrc/conv3x3x3.cu's training kernel with no prologue and no
statistics, and dW is csrc/conv3x3x3_dw.cu with no prologue (the launchers
of kernels/conv_stack.py). Each wrapper here keeps its own launch count.

The input may come in two parts that act as their channel concat (the
decoder's [upsample, skip]); the JAX package materializes that concat
(blocks.py:440) and convolves it, the same function.
"""

from __future__ import annotations

import torch

from . import conv_stack


def conv3d_plain(x1, w, x2=None):
    """conv3d([x1, x2], w), F.conv3d in f32, returned in x1's dtype; w
    (Co, Ci, 3, 3, 3) is rounded to x1's dtype as the kernel rounds it."""
    return conv_stack.conv3x3x3_train_plain(x1, w, x2=x2)[0]


def conv3d(x1, w, x2=None):
    """Kernel wrapper of conv3d_plain: CUDA bf16 tensors launch
    csrc/conv3x3x3.cu's training kernel with no prologue and no
    statistics (other dtypes raise); CPU tensors take the plain
    version."""
    if not x1.is_cuda:
        return conv3d_plain(x1, w, x2)
    y, _ = conv_stack.launch_train(x1, w, x2, None, False, "conv3d")
    conv3d.launches += 1
    return y


conv3d.launches = 0


def conv3d_dx_plain(dy, w, split=None):
    """Input gradient of conv3d from its output cotangent dy, in dy's
    dtype, or its two parts when split = (C1, C2)."""
    return conv_stack.conv3x3x3_dx_plain(dy, w, split)


def conv3d_dx(dy, w, split=None):
    """Kernel wrapper of conv3d_dx_plain: CUDA tensors launch
    csrc/conv3x3x3.cu on the flipped weights (the split written straight
    into its two parts); CPU tensors take the plain version."""
    if not dy.is_cuda:
        return conv3d_dx_plain(dy, w, split)
    dx = conv_stack.launch_dx(dy, w, split, "conv3d_dx")
    conv3d_dx.launches += 1
    return dx


conv3d_dx.launches = 0


def conv3d_dw_plain(x1, dy, x2=None):
    """f32 weight gradient (Co, Ci, 3, 3, 3) of conv3d([x1, x2], w) for
    the output cotangent dy."""
    return conv_stack.conv3x3x3_dw_plain(x1, dy, x2)


def conv3d_dw(x1, dy, x2=None):
    """Kernel wrapper of conv3d_dw_plain: CUDA tensors launch
    csrc/conv3x3x3_dw.cu with no prologue and colsum_f32; CPU tensors
    take the plain version."""
    if not x1.is_cuda:
        return conv3d_dw_plain(x1, dy, x2)
    dw = conv_stack.launch_dw(x1, dy, x2, None, "conv3d_dw")
    conv3d_dw.launches += 1
    return dw


conv3d_dw.launches = 0


class Conv3dFunction(torch.autograd.Function):
    """conv3d with the custom VJP of conv3d_pallas.

    apply(x1, x2, w) -> y in x1's dtype; x2 may be None. w is the f32
    parameter, rounded to the activation dtype inside, as PallasConv3d
    casts it (blocks.py:116). Backward: dx through conv3d_dx in the
    cotangent's dtype (split into the two parts when x2 is given; skipped
    when no input needs a gradient, as for the CT chunk at the network
    entry), dW through conv3d_dw in f32, then rounded to the activation
    dtype and returned in w's dtype: JAX's _vjp_bwd returns
    dw.astype(w.dtype) for the bf16 kernel, and the cast's VJP carries it
    back to the f32 parameter (conv3d.py:271).

    The network-entry conv (Ci = 1) runs here too. The JAX package runs
    it as XLA's nn.Conv there (conv3d.supported needs Ci >= 8), the same
    function with the same rounding points: bf16 output, and dx and dW
    rounded to bf16."""

    @staticmethod
    def forward(ctx, x1, x2, w):
        ctx.save_for_backward(x1, x2, w)
        return conv3d(x1, w, x2)

    @staticmethod
    def backward(ctx, dy):
        x1, x2, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx1 = dx2 = dw = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            if x2 is None:
                dx1 = conv3d_dx(dy, w)
            else:
                dx1, dx2 = conv3d_dx(dy, w, split=(x1.shape[-1],
                                                   x2.shape[-1]))
        if ctx.needs_input_grad[2]:
            dw = conv3d_dw(x1, dy, x2).to(x1.dtype).to(w.dtype)
        return dx1, dx2, dw
