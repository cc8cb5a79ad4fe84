"""Process groups, the batch layout, collectives and halo exchange on
torch.distributed, one process per rank.

Port of dram_tpu/core/mesh.py. The JAX package runs one controller over
a device mesh; here every rank is a process of its own (torchrun's
layout) and the mesh's one axis is the flat rank order:

* `maybe_init_distributed` (:24) joins the process group that torchrun's
  environment announces (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR /
  MASTER_PORT); without it the world is one process and nothing changes.
  `backend_for` is the one place the backend is chosen: NCCL when every
  rank has a GPU of its own, gloo on the CPU and when ranks share a GPU.
  No collective switches backend when it fails.
* the batch layout: `pad_batch` (:80, wrap-around rows of weight 0),
  `local_batch_rows` (:127, contiguous rows per rank in rank order) and
  `check_dcn_size` (`best_mesh` :43-78 with a DCN axis: its (dcn, ici)
  mesh splits the batch row-major, which is the flat rank order, so a
  DCN size only has to divide the world);
* collectives: `all_reduce_sum`, the differentiable cross-rank sum (its
  gradient is the cross-rank sum of the incoming gradient, as psum
  transposes to psum), `all_gather_cat`, `replicate` (rank 0's parameters
  and buffers on every rank);
* context parallelism: `halo_exchange` (:204), differentiable, with zero
  slabs at the volume's ends, `sharded_stencil_apply` (:281) and
  `overlap_tile_infer` (:227) with dram_tpu's clamped windows.

gloo carries CUDA tensors for all_reduce, broadcast and all_gather (torch
2.11 on an H100); its point-to-point send / recv of a CUDA tensor aborts
the process there, so the halo exchange stages CUDA tensors through host
memory under gloo (`_staged`), chosen by the backend's name.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.nn.functional import all_reduce as _all_reduce_fn


def backend_for(device_type, local_world, n_gpus):
    """The backend for ranks on `device_type`: NCCL when each of the
    host's `local_world` ranks has one of its `n_gpus` GPUs, gloo on the
    CPU and when ranks share a GPU (NCCL refuses two ranks on one
    device)."""
    if device_type == "cuda" and 0 < local_world <= n_gpus:
        return "nccl"
    return "gloo"


def local_device(device_type):
    """This process's device: cuda:LOCAL_RANK (modulo the GPUs present,
    so ranks that outnumber the GPUs share them) or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    n = max(torch.cuda.device_count(), 1)
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % n)


def maybe_init_distributed(device_type="cuda"):
    """Join the process group torchrun's environment announces (RANK and
    WORLD_SIZE > 1, MASTER_ADDR / MASTER_PORT); a no-op without it or
    when a group exists. On CUDA the process's device is set to
    local_device first. Returns True when a group of more than one rank
    is active."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or "RANK" not in os.environ:
        return False
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    n_gpus = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda":
        torch.cuda.set_device(local_device("cuda"))
    dist.init_process_group(backend_for(device_type, local_world, n_gpus),
                            init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world)
    return True


def data_group():
    """The data-parallel group (every rank), or None in a world of one."""
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def world_size(group=None):
    return 1 if group is None else dist.get_world_size(group)


def rank(group=None):
    return 0 if group is None else dist.get_rank(group)


def is_writer(group=None):
    """Rank 0 writes the run's files (records, scalars, tiles,
    checkpoints); the other ranks write nothing."""
    return rank(group if group is not None else data_group()) == 0


# --- the batch layout -----------------------------------------------------------


def check_dcn_size(dcn_size, world):
    """best_mesh's (dcn, ici) mesh splits the batch over both axes
    row-major, the flat rank order; a DCN size only has to divide the
    world (else ValueError, as best_mesh raises)."""
    if dcn_size is not None and world % int(dcn_size):
        raise ValueError(f"{world} devices don't split into {dcn_size} DCN "
                         "groups")


def pad_batch(arrays, n_shards):
    """Pad each array's leading axis up to a multiple of `n_shards` with
    wrap-around rows (copies of real samples); `weights` is 1 for real
    rows and 0 for padding. Returns (padded_arrays, weights)."""
    b = int(np.shape(arrays[0])[0])
    pad = (-b) % max(int(n_shards), 1)
    weights = np.ones(b + pad, np.float32)
    if pad == 0:
        return tuple(arrays), weights
    weights[b:] = 0.0
    idx = np.arange(b + pad) % b
    return tuple(np.asarray(a)[idx] for a in arrays), weights


def local_batch_rows(world, rank_, global_batch):
    """((lo, hi), padded_batch): `global_batch` rounded up to the world,
    and the contiguous rows [lo, hi) of the padded batch that rank
    `rank_` owns (rank order)."""
    n = max(int(world), 1)
    padded = -(-int(global_batch) // n) * n
    per = padded // n
    return (rank_ * per, (rank_ + 1) * per), padded


# --- collectives ----------------------------------------------------------------


def _gloo(group):
    return dist.get_backend(group) == "gloo"


def _staged(t, group):
    """(tensor to hand a send / recv, device to bring the result back
    to): a CUDA tensor goes through host memory under gloo."""
    if t.is_cuda and _gloo(group):
        return t.detach().cpu(), t.device
    return t.detach().contiguous(), None


def all_reduce_sum(x, group):
    """The sum of `x` over the ranks of `group` (x itself when None),
    differentiable: its gradient is the sum over the ranks of the
    incoming gradient (psum's transpose)."""
    if group is None:
        return x
    return _all_reduce_fn(x, group=group)


def all_gather_cat(x, group, dim=0):
    """Every rank's `x` (equal shapes) concatenated along `dim` in rank
    order, the same on every rank; no gradient."""
    if group is None:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def average_gradients(params, group):
    """Replace each parameter's gradient by its mean over the ranks: one
    all_reduce over one flat buffer (dram_tpu's single pmean)."""
    if group is None:
        return
    params = [p for p in params if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    i = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[i:i + n].view_as(p.grad))
        i += n


@torch.no_grad()
def replicate(module, group, src=0):
    """Broadcast rank `src`'s parameters and buffers to every rank."""
    if group is None:
        return module
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=dist.get_global_rank(group, src),
                       group=group)
    return module


def broadcast_object(obj, group, src=0):
    """Rank `src`'s picklable `obj` on every rank."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src),
                               group=group)
    return box[0]


def _neighbour_exchange(to_left, to_right, group):
    """Rank i sends `to_right` to rank i + 1 and `to_left` to rank i - 1.
    Returns (what rank i - 1 sent right, what rank i + 1 sent left), zeros
    at the ends of the rank order."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    sl, back = _staged(to_left, group)
    sr, _ = _staged(to_right, group)
    from_left, from_right = torch.zeros_like(sr), torch.zeros_like(sl)
    ops = []
    if r > 0:
        peer = dist.get_global_rank(group, r - 1)
        ops += [dist.P2POp(dist.isend, sl, peer, group),
                dist.P2POp(dist.irecv, from_left, peer, group)]
    if r < n - 1:
        peer = dist.get_global_rank(group, r + 1)
        ops += [dist.P2POp(dist.isend, sr, peer, group),
                dist.P2POp(dist.irecv, from_right, peer, group)]
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if back is not None:
        from_left, from_right = from_left.to(back), from_right.to(back)
    return from_left, from_right


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, axis, group):
        ctx.halo, ctx.axis, ctx.group = halo, axis, group
        size = x.shape[axis]
        left_edge = x.narrow(axis, 0, halo)
        right_edge = x.narrow(axis, size - halo, halo)
        left_halo, right_halo = _neighbour_exchange(left_edge, right_edge,
                                                    group)
        return torch.cat([left_halo, x, right_halo], dim=axis)

    @staticmethod
    def backward(ctx, g):
        halo, axis = ctx.halo, ctx.axis
        size = g.shape[axis] - 2 * halo
        # the halos' gradients go back to the ranks they came from
        from_left, from_right = _neighbour_exchange(
            g.narrow(axis, 0, halo), g.narrow(axis, halo + size, halo),
            ctx.group)
        dx = g.narrow(axis, halo, size).clone()
        dx.narrow(axis, 0, halo).add_(from_left)
        dx.narrow(axis, size - halo, halo).add_(from_right)
        return dx, None, None, None


def halo_exchange(x, halo, axis, group):
    """This rank's block `x` extended by `halo` slabs of its neighbours'
    along `axis` (the rank order is the block order); the ends of the
    volume get zero slabs, as 'same' zero padding. Differentiable: the
    halos' gradients return to the ranks they came from."""
    if halo == 0:
        return x
    if halo > x.shape[axis]:
        raise ValueError(f"halo {halo} exceeds the block's {x.shape[axis]}")
    if group is None:
        z = torch.zeros_like(x.narrow(axis, 0, halo))
        return torch.cat([z, x, z], dim=axis)
    return _HaloExchange.apply(x, halo, axis, group)


def sharded_stencil_apply(fn, volume, halo, group, axis=0):
    """`fn` (shift-invariant, receptive-field radius <= halo, shape
    preserving) on the whole `volume`, computed block-wise: each rank
    takes its block of `axis` (which must divide over the ranks),
    exchanges halos, applies `fn` and crops; the blocks are gathered, so
    every rank returns the full result."""
    n, r = world_size(group), rank(group)
    size = volume.shape[axis]
    if size % n:
        raise ValueError(f"axis {axis} of {size} does not divide over {n} "
                         "ranks")
    d = size // n
    block = volume.narrow(axis, r * d, d).contiguous()
    out = fn(halo_exchange(block, halo, axis, group))
    return all_gather_cat(out.narrow(axis, halo, d).contiguous(), group,
                          dim=axis)


def overlap_tile_infer(apply_fn, x, lobe, n_tiles, halo, group=None):
    """Whole-scan inference by overlap tiles (dram_tpu's windows): the D
    axis (axis 1) cut into `n_tiles` windows of D / n_tiles + 2 halo
    planes clamped inside the volume, stacked on the batch axis, run
    through `apply_fn(x, lobe) -> (dense, refined)` and cropped back.
    With a group each rank runs its contiguous share of the window batch
    (which must divide over the ranks) and the results are gathered, so
    the stitched volumes are the same on every rank. Exact for
    stencil-local networks when `halo` covers the receptive field (eval
    BatchNorm, DC3D with local_upsample)."""
    B, D = x.shape[0], x.shape[1]
    if D % n_tiles:
        raise ValueError("D must divide by n_tiles")
    d_local = D // n_tiles
    win = min(D, d_local + 2 * halo)
    starts = [min(max(i * d_local - halo, 0), D - win)
              for i in range(n_tiles)]
    offs = [i * d_local - s for i, s in enumerate(starts)]
    wx = torch.cat([x.narrow(1, s, win) for s in starts], dim=0)
    wl = torch.cat([lobe.narrow(1, s, win) for s in starts], dim=0)
    n, r = world_size(group), rank(group)
    if wx.shape[0] % n:
        raise ValueError(f"{wx.shape[0]} windows do not divide over {n} "
                         "ranks")
    per = wx.shape[0] // n
    dense, refined = apply_fn(wx[r * per:(r + 1) * per].contiguous(),
                              wl[r * per:(r + 1) * per].contiguous())
    dense, refined = (all_gather_cat(t.contiguous(), group)
                      for t in (dense, refined))

    def stitch(t):
        return torch.cat([t[i * B:(i + 1) * B].narrow(1, offs[i], d_local)
                          for i in range(n_tiles)], dim=1)
    return stitch(dense), stitch(refined)
