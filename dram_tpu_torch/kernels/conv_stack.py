"""3x3x3 convolutions of the DC3D conv stack on NDHWC volumes: the eval
conv with the BatchNorm affine and ReLU in its epilogue, the training
forward (prologue affine+ReLU, per-channel statistics), the input
gradient (flipped weights, split output), the weight gradient, and the
differentiable two-conv stack built from them. The input may come in two
parts that act as one channel concat.

Port of dram_tpu/core/pallas/fused_stack.py: conv_cm (kernel _cbr_kernel)
in its eval, training and dx uses, conv_dw_cm (kernel _dw_kernel_pro), and
the custom VJP of fused_cbr2 (_fused_cbr2_vjp :531-689) as
ConvStackFunction. CUDA sources: csrc/conv3x3x3.cu, csrc/conv3x3x3_dw.cu
(and csrc/conv_wgmma.cuh), csrc/conv3x3x3_c1.cu. The launchers
launch_train, launch_dx and launch_dw are shared with the unfused stack's
raw conv (kernels/conv3d.py); each wrapper counts its own launches.

On a CUDA tensor every conv runs a Hopper kernel. The network-entry conv
(one input part of one channel, the CT chunk, and no prologue: c1_takes)
runs csrc/conv3x3x3_c1.cu, forward and weight gradient, through
conv3x3x3_c1 / conv3x3x3_c1_dw and their counters: dram_tpu pads that
input to 8 channels for its kernel (models/blocks.py:235-242), which this
card need not do. Every other conv runs the wgmma kernels fed by TMA, whose
strides are multiples of 16 bytes: an input part whose channel count is
not a multiple of 8 is zero-padded to one, with zero weights (pad8; no
shipped conv has one). The launch geometry (conv_plan, dw_plan, c1_plan,
c1_dw_plan) is decided here in plain Python; the C launchers run the plan
they are handed and refuse one that does not cover the output.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ..core.mesh import all_reduce_sum, world_size
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


def _check_weight(w, C1, C2, name):
    if w.shape[1] != C1 + C2 or tuple(w.shape[2:]) != (3, 3, 3):
        raise ValueError(f"{name}: weight {tuple(w.shape)} does not fit "
                         f"{C1} + {C2} input channels")


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


# --- launch geometry of the Hopper kernels (csrc/conv_wgmma.cuh) --------------

BOX_X, BOX_Y = 8, 8   # a tile's x and y extent: an x-row is one swizzle atom
CHUNK = 64            # input channels per K chunk: one 128-byte row
BNS = (32, 64, 128, 256)  # output-channel tiles the conv kernel is built for
DW_BZ = 2             # z extent of a weight-gradient K box
# split-K target of the weight-gradient kernel: one block per SM (~170 KB
# of shared memory), a few waves of the 132 SMs
DW_TARGET_BLOCKS = 132 * 8


def _cdiv(a, b):
    return -(-a // b)


def pad8(t, parts=None, dim=-1):
    """t with zeros appended along `dim` to each of its channel parts
    (default: one part, all of dim) up to a multiple of 8 channels; t
    itself when every part is one already."""
    parts = tuple(parts) if parts is not None else (t.shape[dim],)
    if all(c % 8 == 0 for c in parts):
        return t
    pieces = []
    for p in torch.split(t, list(parts), dim):
        shape = list(p.shape)
        shape[dim] = -p.shape[dim] % 8
        pieces += [p, p.new_zeros(shape)]
    return torch.cat(pieces, dim)


def k_chunks(C1, C2):
    """The K loop's 64-channel chunks of a two-part input, in order:
    (part, first channel in the part, first channel in Ci, valid
    channels); chunk k reads part 1 while k < ceil(C1 / 64)."""
    out = []
    for part, (base, c) in enumerate(((0, C1), (C1, C2))):
        out += [(part, cl, base + cl, min(CHUNK, c - cl))
                for cl in range(0, c, CHUNK)]
    return out


def pack_weight(w):
    """(Co, Ci, 3, 3, 3) -> the conv kernel's K-major (27, Co, Ci) bf16:
    tap (kd, kh, kw) = kd 9 + kh 3 + kw, each output channel's Ci
    contiguous."""
    Co, Ci = w.shape[:2]
    return w.permute(2, 3, 4, 0, 1).reshape(27, Co, Ci) \
        .to(torch.bfloat16).contiguous()


@functools.lru_cache(maxsize=None)
def conv_plan(B, D, H, W, C1, C2, Co):
    """Geometry of one launch of csrc/conv3x3x3.cu's kernel for a (B, D,
    H, W) volume of C1 + C2 input and Co output channels: the N tile (the
    one in BNS that pads Co least, the widest of ties) and the z-planes a
    consumer warpgroup owns (2 up to 128 columns, else 1), the output box,
    the tile grid (x fastest, then y, z, batch element), one statistics
    row per M tile; `args` is the vector the launcher runs."""
    bn = min(BNS, key=lambda n: (_cdiv(Co, n) * n, -n))
    slabs = 2 if bn <= 128 else 1
    bz = 2 * slabs
    tiles = (_cdiv(W, BOX_X), _cdiv(H, BOX_Y), _cdiv(D, bz))
    m_tiles = B * tiles[0] * tiles[1] * tiles[2]
    n_tiles = _cdiv(Co, bn)
    return {"bn": bn, "slabs": slabs, "box": (BOX_X, BOX_Y, bz),
            "tiles": tiles, "m_tiles": m_tiles, "n_tiles": n_tiles,
            "stat_rows": m_tiles,
            "args": (bn, slabs, *tiles, m_tiles, n_tiles)}


def _blocks_split(tiles, nboxes):
    """Splits of K for `tiles` weight-gradient tiles: up to
    DW_TARGET_BLOCKS blocks, the count that fills the last wave of 132
    SMs best (the most splits of ties)."""
    hi = max(1, min(nboxes, DW_TARGET_BLOCKS // tiles))

    def fill(n):
        blocks = tiles * n
        return blocks / (_cdiv(blocks, 132) * 132)
    return max(range(1, hi + 1), key=lambda n: (fill(n), n))


@functools.lru_cache(maxsize=None)
def dw_plan(B, D, H, W, C1, C2, Co):
    """Geometry of one launch of csrc/conv3x3x3_dw.cu's kernel: K boxes of
    8 x 8 x DW_BZ voxels over the batch (numbered as conv_plan's tiles),
    split into runs of `kboxes` boxes, one block per (x-shift, 64-channel
    Ci chunk, 64-channel Co tile, split); `args` is the vector the
    launcher runs."""
    tiles = (_cdiv(W, BOX_X), _cdiv(H, BOX_Y), _cdiv(D, DW_BZ))
    nboxes = B * tiles[0] * tiles[1] * tiles[2]
    n_chunks = len(k_chunks(C1, C2))
    n_co = _cdiv(Co, 64)
    nsplit = _blocks_split(3 * n_chunks * n_co, nboxes)
    kboxes = _cdiv(nboxes, nsplit)
    nsplit = _cdiv(nboxes, kboxes)
    return {"box": (BOX_X, BOX_Y, DW_BZ), "tiles": tiles, "nboxes": nboxes,
            "kboxes": kboxes, "nsplit": nsplit,
            "grid": (3 * n_chunks, n_co, nsplit),
            "args": (*tiles, nboxes, kboxes, nsplit)}


def _args(vals):
    return (ctypes.c_int64 * len(vals))(*vals)


# --- the network-entry conv: csrc/conv3x3x3_c1.cu ---------------------------

C1_BOX = (16, 8, 8)     # the forward's output tile (x, y, z)
C1_DW_BOX = (16, 8, 2)  # the weight gradient's K box
C1_CO = 32              # output channels of a forward chunk, of a dW block
C1_MAX_CO = 256
# blocks in flight: 2 of 256 threads on each of the 132 SMs (the kernels'
# __launch_bounds__: 128 registers, where 3 blocks spilled the forward's
# and ran it ~10% slower); the forward's blocks take equal runs of tiles,
# the weight gradient's splits equal runs of K boxes
C1_BLOCKS = 132 * 2


def c1_takes(x1, x2, prologue):
    """Whether a conv launch runs csrc/conv3x3x3_c1.cu: one input part of
    one channel and no prologue (the network-entry conv on the CT chunk)."""
    return x2 is None and prologue is None and x1.shape[-1] == 1


def _refuse_c1(x1, x2, prologue, name):
    if c1_takes(x1, x2, prologue):
        raise ValueError(f"{name}: a one-channel input runs "
                         "csrc/conv3x3x3_c1.cu (conv3x3x3_c1 / "
                         "conv3x3x3_c1_dw), not the wgmma kernels")


@functools.lru_cache(maxsize=None)
def c1_plan(B, D, H, W):
    """Geometry of one launch of csrc/conv3x3x3_c1.cu's forward: output
    tiles of C1_BOX voxels (x fastest, then y, z, batch element), block i
    computing tiles [i per, (i + 1) per) and writing one statistics row;
    `args` is the vector the launcher runs."""
    tiles = tuple(_cdiv(n, b) for n, b in zip((W, H, D), C1_BOX))
    ntiles = B * math.prod(tiles)
    per = _cdiv(ntiles, C1_BLOCKS)
    blocks = _cdiv(ntiles, per)
    return {"box": C1_BOX, "tiles": tiles, "ntiles": ntiles, "per": per,
            "blocks": blocks, "stat_rows": blocks,
            "args": (*tiles, ntiles, per, blocks)}


@functools.lru_cache(maxsize=None)
def c1_dw_plan(B, D, H, W, Co):
    """Geometry of one launch of csrc/conv3x3x3_c1.cu's weight gradient:
    K boxes of C1_DW_BOX voxels over the batch (numbered as c1_plan's
    tiles), split into runs of `kboxes` boxes, one block per (32-channel
    output chunk, split) writing the split's partial row; `args` is the
    vector the launcher runs."""
    tiles = tuple(_cdiv(n, b) for n, b in zip((W, H, D), C1_DW_BOX))
    nboxes = B * math.prod(tiles)
    n_co = _cdiv(Co, C1_CO)
    kboxes = _cdiv(nboxes, max(1, C1_BLOCKS // n_co))
    nsplit = _cdiv(nboxes, kboxes)
    return {"box": C1_DW_BOX, "tiles": tiles, "nboxes": nboxes,
            "kboxes": kboxes, "nsplit": nsplit, "grid": (n_co, nsplit),
            "args": (*tiles, nboxes, kboxes, nsplit)}


def _check_c1(x, Co, name):
    _build.check_operand(x, torch.bfloat16, f"{name} x")
    if x.shape[-1] != 1:
        raise ValueError(f"{name}: x {tuple(x.shape)} has "
                         f"{x.shape[-1]} channels, the kernel takes 1")
    if Co < 2 or Co % 2:
        raise ValueError(f"{name}: {Co} output channels; the kernel "
                         "takes an even count")


def _check_c1_mode(epilogue, stats):
    if epilogue is not None and stats:
        raise ValueError("conv3x3x3_c1: the eval epilogue and the "
                         "statistics are separate modes")


def conv3x3x3_c1_plain(x, w, epilogue=None, stats=False):
    """The network-entry conv in f32 (Ci = 1): relu(conv * s + t) with
    epilogue = (s, t) (conv3x3x3_plain), else the raw output and, with
    `stats`, its (2, Co) [sum, sum of squares] before rounding
    (conv3x3x3_train_plain). Returns (y in x's dtype, stats or None)."""
    _check_c1_mode(epilogue, stats)
    if epilogue is not None:
        return conv3x3x3_plain(x, w, *epilogue), None
    return conv3x3x3_train_plain(x, w, stats=stats)


def conv3x3x3_c1(x, w, epilogue=None, stats=False):
    """Kernel wrapper of conv3x3x3_c1_plain: CUDA tensors launch
    csrc/conv3x3x3_c1.cu's forward on x (B, D, H, W, 1) bf16 and the f32
    w (Co, 1, 3, 3, 3), which the kernel rounds to bf16 (Co even and <=
    256); the statistics reduce their per-block rows in colsum_f32. CPU
    tensors take the plain version."""
    if not x.is_cuda:
        return conv3x3x3_c1_plain(x, w, epilogue, stats)
    _check_c1_mode(epilogue, stats)
    name = "conv3x3x3_c1"
    B, D, H, W, _ = x.shape
    Co = w.shape[0]
    _check_c1(x, Co, name)
    if tuple(w.shape[1:]) != (1, 3, 3, 3) or Co > C1_MAX_CO:
        raise ValueError(f"{name}: weight {tuple(w.shape)}; the kernel "
                         f"takes (Co <= {C1_MAX_CO}, 1, 3, 3, 3)")
    es = et = None
    if epilogue is not None:
        es, et = (_f32_vec(v, x.device) for v in epilogue)
    wk = _f32_vec(w, x.device)
    plan = c1_plan(B, D, H, W)
    nrows = plan["stat_rows"]
    y = torch.empty((B, D, H, W, Co), dtype=torch.bfloat16, device=x.device)
    part = torch.empty((nrows, 2 * Co), dtype=torch.float32,
                       device=x.device) if stats else None
    _build.launch("conv3x3x3_c1_bf16", x.data_ptr(), wk.data_ptr(), _ptr(es),
                  _ptr(et), y.data_ptr(), Co, _ptr(part), B, D, H, W,
                  _args(plan["args"]))
    conv3x3x3_c1.launches += 1
    return y, _colsum(part, nrows, 2 * Co).view(2, Co) if stats else None


conv3x3x3_c1.launches = 0


def conv3x3x3_c1_dw_plain(x, dy):
    """f32 weight gradient (Co, 1, 3, 3, 3) of the network-entry conv
    (conv3x3x3_dw_plain at Ci = 1)."""
    return conv3x3x3_dw_plain(x, dy)


def conv3x3x3_c1_dw(x, dy):
    """Kernel wrapper of conv3x3x3_c1_dw_plain: CUDA tensors launch
    csrc/conv3x3x3_c1.cu's weight gradient (split K, f32 partial rows) and
    colsum_f32 (adds the rows in a fixed order); CPU tensors take the
    plain version."""
    if not x.is_cuda:
        return conv3x3x3_c1_dw_plain(x, dy)
    name = "conv3x3x3_c1_dw"
    B, D, H, W, _ = x.shape
    Co = dy.shape[-1]
    _check_c1(x, Co, name)
    _build.check_operand(dy, torch.bfloat16, f"{name} dy")
    if tuple(dy.shape[:4]) != (B, D, H, W):
        raise ValueError(f"{name}: dy {tuple(dy.shape)} does not fit "
                         f"x {tuple(x.shape)}")
    plan = c1_dw_plan(B, D, H, W, Co)
    nsplit = plan["nsplit"]
    part = torch.empty((nsplit, 27 * Co), dtype=torch.float32,
                       device=x.device)
    _build.launch("conv3x3x3_c1_dw_bf16", x.data_ptr(), dy.data_ptr(), Co,
                  B, D, H, W, _args(plan["args"]), part.data_ptr())
    dw = _colsum(part, nsplit, 27 * Co) if nsplit > 1 else part[0]
    conv3x3x3_c1_dw.launches += 1
    return dw.view(27, Co).t().reshape(Co, 1, 3, 3, 3).contiguous()


conv3x3x3_c1_dw.launches = 0


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch_conv(x1, x2, w, prologue, epilogue, y1, y2, stats, name):
    """One launch of csrc/conv3x3x3.cu's kernel on CUDA tensors into y1
    (and y2), input parts zero-padded to multiples of 8 channels (pad8);
    returns the (2, Co) statistics when `stats`. w: (Co1 + Co2, C1 + C2,
    3, 3, 3); the output parts must be even (bf16 pairs)."""
    B, D, H, W, C1 = x1.shape
    C2 = x2.shape[-1] if x2 is not None else 0
    Co1, Co2 = y1.shape[-1], (y2.shape[-1] if y2 is not None else 0)
    Co = Co1 + Co2
    _check_weight(w, C1, C2, name)
    if Co1 % 2 or Co2 % 2:
        raise ValueError(f"{name}: output parts of {Co1} and {Co2} channels; "
                         "the kernel writes even ones")
    ps = pt = es = et = None
    if prologue is not None:
        ps, pt = (pad8(_f32_vec(v, x1.device), (C1, C2), 0)
                  for v in prologue)
    if epilogue is not None:
        es, et = (_f32_vec(v, x1.device) for v in epilogue)
    wk = pack_weight(pad8(w.to(x1.device), (C1, C2), 1))
    x1 = pad8(x1)
    x2 = pad8(x2) if x2 is not None else None
    C1, C2 = x1.shape[-1], (x2.shape[-1] if x2 is not None else 0)
    plan = conv_plan(B, D, H, W, C1, C2, Co)
    nrows = plan["stat_rows"]
    part = torch.empty((nrows, 2 * Co), dtype=torch.float32,
                       device=x1.device) if stats else None
    _build.launch("conv3x3x3_wgmma_bf16", x1.data_ptr(), C1, _ptr(x2), C2,
                  wk.data_ptr(), _ptr(ps), _ptr(pt), _ptr(es), _ptr(et),
                  y1.data_ptr(), Co1, _ptr(y2), Co2, _ptr(part), B, D, H, W,
                  _args(plan["args"]))
    return _colsum(part, nrows, 2 * Co).view(2, Co) if stats else None


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
    kernel's layout, pack_weight), or conv3x3x3_c1 for a launch that
    c1_takes; CPU tensors take the plain version.

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
    if c1_takes(x1, x2, None):
        return conv3x3x3_c1(x1, w, epilogue=(scale, shift))[0]
    B, D, H, W, _ = x1.shape
    _check_parts("conv3x3x3", x1, x2)
    y = torch.empty((B, D, H, W, w.shape[0]), dtype=torch.bfloat16,
                    device=x1.device)
    _launch_conv(x1, x2, w, None, (scale, shift), y, None, False,
                 "conv3x3x3")
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
    per-block rows in colsum_f32), or conv3x3x3_c1 for a launch that
    c1_takes; CPU tensors take the plain version."""
    if not x1.is_cuda:
        return conv3x3x3_train_plain(x1, w, x2, prologue, stats)
    if c1_takes(x1, x2, prologue):
        return conv3x3x3_c1(x1, w, stats=stats)
    y, st = launch_train(x1, w, x2, prologue, stats, "conv3x3x3_train")
    conv3x3x3_train.launches += 1
    return y, st


def launch_train(x1, w, x2, prologue, stats, name):
    """One conv launch on CUDA tensors in the training modes (raw output,
    optional prologue and statistics); the callers count it. A launch
    that c1_takes raises: it runs csrc/conv3x3x3_c1.cu."""
    _refuse_c1(x1, x2, prologue, name)
    B, D, H, W, _ = x1.shape
    _check_parts(name, x1, x2)
    y = torch.empty((B, D, H, W, w.shape[0]), dtype=torch.bfloat16,
                    device=x1.device)
    return y, _launch_conv(x1, x2, w, prologue, None, y, None, stats, name)


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
    """One conv launch on the flipped weights of w for a CUDA cotangent
    dy, the split written straight into its two parts; the callers count
    it."""
    B, D, H, W, Co = dy.shape
    _build.check_operand(dy, torch.bfloat16, f"{name} dy")
    Ci = w.shape[1]
    if w.shape[0] != Co:
        raise ValueError(f"{name}: weight {tuple(w.shape)} does not "
                         f"fit {Co} cotangent channels")
    c1, c2 = split if split is not None else (Ci, 0)
    if c1 + c2 != Ci:
        raise ValueError(f"{name}: split {split} of {Ci} channels")
    y1 = torch.empty((B, D, H, W, c1), dtype=torch.bfloat16, device=dy.device)
    y2 = torch.empty((B, D, H, W, c2), dtype=torch.bfloat16,
                     device=dy.device) if c2 else None
    _launch_conv(dy, None, _flip_w(w), None, None, y1, y2, False, name)
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


def conv3x3x3_dw(x1, dy, x2=None, prologue=None):
    """Kernel wrapper of conv3x3x3_dw_plain: CUDA tensors launch
    csrc/conv3x3x3_dw.cu (split K, f32 partial tiles) and colsum_f32
    (adds the partials in a fixed order), or conv3x3x3_c1_dw for a
    launch that c1_takes; CPU tensors take the plain version."""
    if not x1.is_cuda:
        return conv3x3x3_dw_plain(x1, dy, x2, prologue)
    if c1_takes(x1, x2, prologue):
        return conv3x3x3_c1_dw(x1, dy)
    dw = launch_dw(x1, dy, x2, prologue, "conv3x3x3_dw")
    conv3x3x3_dw.launches += 1
    return dw


def launch_dw(x1, dy, x2, prologue, name):
    """One launch of csrc/conv3x3x3_dw.cu's kernel (and its colsum_f32
    passes) on CUDA tensors, channel parts zero-padded to multiples of 8
    (pad8) and their rows dropped: the f32 (Co, Ci, 3, 3, 3) weight
    gradient; the callers count it. A launch that c1_takes raises: it
    runs csrc/conv3x3x3_c1.cu."""
    _refuse_c1(x1, x2, prologue, name)
    B, D, H, W, _ = x1.shape
    C1, C2 = _check_parts(name, x1, x2)
    _build.check_operand(dy, torch.bfloat16, f"{name} dy")
    if tuple(dy.shape[:4]) != (B, D, H, W):
        raise ValueError(f"{name}: dy {tuple(dy.shape)} does not fit "
                         f"x {tuple(x1.shape)}")
    Co = dy.shape[-1]
    ps = pt = None
    if prologue is not None:
        ps, pt = (pad8(_f32_vec(v, x1.device), (C1, C2), 0)
                  for v in prologue)
    x1p, dyp = pad8(x1), pad8(dy)
    x2p = pad8(x2) if x2 is not None else None
    P1, P2 = x1p.shape[-1], (x2p.shape[-1] if x2p is not None else 0)
    Cp, Cop = P1 + P2, dyp.shape[-1]
    plan = dw_plan(B, D, H, W, P1, P2, Cop)
    nsplit = plan["nsplit"]
    part = torch.empty((nsplit, 27 * Cp * Cop), dtype=torch.float32,
                       device=x1.device)
    _build.launch("conv3x3x3_dw_wgmma_bf16", x1p.data_ptr(), P1, _ptr(x2p),
                  P2, _ptr(ps), _ptr(pt), dyp.data_ptr(), Cop, B, D, H, W,
                  _args(plan["args"]), part.data_ptr())
    dw = _colsum(part, nsplit, 27 * Cp * Cop) if nsplit > 1 else part[0]
    return unpad_dw(dw.view(3, 3, 3, Cp, Cop).permute(4, 3, 0, 1, 2), C1,
                    C2, Co)


def unpad_dw(dw, C1, C2, Co):
    """The (Co, C1 + C2, 3, 3, 3) weight gradient out of one of pad8's
    padded channels: the rows of the zero channels dropped."""
    P1 = C1 + (-C1 % 8)
    if tuple(dw.shape[:2]) != (Co, C1 + C2):
        dw = torch.cat([dw[:Co, :C1], dw[:Co, P1:P1 + C2]], 1)
    return dw.contiguous()


conv3x3x3_dw.launches = 0


# --- the two-conv stack with its gradient ---------------------------------------


def bn_batch_stats(st, n, group=None):
    """(sum, sum of squares) over n elements -> flax's batch mean and
    biased variance E[x^2] - E[x]^2, clamped at 0 (fused_stack._bn_stats).
    With a `group` the sums and the count are first summed over its ranks
    (fused_stack._global_stats :455): the global batch's statistics."""
    if group is not None:
        st, n = all_reduce_sum(st, group), n * world_size(group)
    mean = st[0] / n
    return mean, torch.clamp(st[1] / n - mean * mean, min=0.0)


def bn_relu_backward(d_post, out, gamma, beta, mean, var, eps, group=None):
    """Backward of relu(BN_train(out)) at batch statistics (mean, var):
    the train branch of fused_stack._bn_back_cm (:600-634), in f32.
    Returns (d_out in out's dtype, dgamma, dbeta). With a `group` the
    dbeta / dgamma terms that enter d_out are summed over its ranks and
    the count is the global one (the batch statistics couple every
    rank's rows); the returned dgamma / dbeta stay this rank's partial
    sums, which the trainer's gradient mean combines."""
    inv = torch.rsqrt(var + eps)
    s = gamma * inv
    of = out.float()
    dims = tuple(range(of.dim() - 1))
    n = math.prod(of.shape[:-1]) * world_size(group)
    dp = torch.where(of * s + (beta - mean * s) > 0, d_post.float(), 0.0)
    xhat = (of - mean) * inv
    dbeta = dp.sum(dims)
    dgamma = (dp * xhat).sum(dims)
    dbeta_g, dgamma_g = dbeta, dgamma
    if group is not None:
        dbeta_g, dgamma_g = all_reduce_sum(torch.stack([dbeta, dgamma]),
                                           group)
    d_out = inv * (dp * gamma - (dbeta_g * gamma) / n
                   - xhat * ((dgamma_g * gamma) / n))
    return d_out.to(out.dtype), dgamma, dbeta


class ConvStackFunction(torch.autograd.Function):
    """(3x3x3 conv -> train-mode BatchNorm -> ReLU) x 2 on batch
    statistics: the forward and custom VJP of fused_stack.fused_cbr2
    (_fused_fwd :541-589, _vjp_bwd :637-689). Saves the input, the raw
    bf16 conv outputs and the batch statistics, never a normalized
    tensor. With a process `group` (data parallelism; fused_cbr2's
    `axis_name`) the statistics are the global batch's and the backward
    sums the batch-coupled BatchNorm terms over the ranks.

    apply(x1, x2, w0, g0, b0, w1, g1, b1, eps, group) ->
    (y, mean0, var0, mean1, var1); x2 and group may be None."""

    @staticmethod
    def forward(ctx, x1, x2, w0, g0, b0, w1, g1, b1, eps, group=None):
        n = float(math.prod(x1.shape[:4]))
        out0, st0 = conv3x3x3_train(x1, w0, x2=x2, stats=True)
        bm0, bv0 = bn_batch_stats(st0, n, group)
        s0, t0 = fold_bn(g0, b0, bm0, bv0, eps)
        out1, st1 = conv3x3x3_train(out0, w1, prologue=(s0, t0), stats=True)
        bm1, bv1 = bn_batch_stats(st1, n, group)
        s1, t1 = fold_bn(g1, b1, bm1, bv1, eps)
        y = torch.relu(out1.float() * s1 + t1).to(x1.dtype)
        ctx.save_for_backward(x1, x2, w0, g0, b0, w1, g1, b1, out0, out1,
                              bm0, bv0, bm1, bv1)
        ctx.eps, ctx.group = eps, group
        ctx.mark_non_differentiable(bm0, bv0, bm1, bv1)
        return y, bm0, bv0, bm1, bv1

    @staticmethod
    def backward(ctx, dy, *_unused_stat_grads):
        (x1, x2, w0, g0, b0, w1, g1, b1, out0, out1,
         bm0, bv0, bm1, bv1) = ctx.saved_tensors
        eps, group = ctx.eps, ctx.group
        # cotangents between kernels in the activation dtype
        # (_bn_back_cm returns d_out.astype(dt)); weight gradients in f32
        dout1, dg1, db1 = bn_relu_backward(dy, out1, g1, b1, bm1, bv1, eps,
                                           group)
        s0, t0 = fold_bn(g0, b0, bm0, bv0, eps)
        da = conv3x3x3_dx(dout1, w1)
        dw1 = conv3x3x3_dw(out0, dout1, prologue=(s0, t0))
        dout0, dg0, db0 = bn_relu_backward(da, out0, g0, b0, bm0, bv0, eps,
                                           group)
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
        return dx1, dx2, dw0, dg0, db0, dw1, dg1, db1, None, None
