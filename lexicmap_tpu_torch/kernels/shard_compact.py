"""The sharded matcher's per-shard hit compaction: the hand-written CUDA
kernel (`csrc/sharded.cu`, `compact_rows`) and its plain PyTorch twin.

Counterpart of the body of
lexicmap_tpu/parallel/sharded.py::ShardedSeedMatcher._bucket_fn's step
after its seed-locate launch: given a shard's per-(query, row) n_hits and
e0 (kernels/seed_locate.py::seed_locate_batch) and the rows' mask ids, for
each query the rows with n_hits > 0 ordered by mask id, the first H of
them as (gid, e0, n_hits), and n, the count of all of them (which may
exceed H: the caller then compacts again at a larger H).  Gids are int32 tensors that
hold the uint32 bits (0xFFFFFFFF, -1, on padding rows, whose n_hits is 0).

The kernel compacts in row order, which is the order of the gids where
they rise with the row, as ShardedSeedMatcher packs them; the plain version
sorts by gid (as jax.lax.sort does), so rows whose gids do not rise show up
as a mismatch between the two.  Output: one int32 buffer [B, 3H + 1],
gid[H] | e0[H] | n_hits[H] | n per query; slots from min(n, H) on hold
(-1, 0, 0).  The wrapper returns its four views.
"""

from __future__ import annotations

import torch

from .seed_locate import _U32, _cuda_ptrs, _on_device
from .seed_match_shard import kernel_lib, raise_on


def _check(nh, e0, gids, H, out):
    for name, t in (("nh", nh), ("e0", e0), ("gids", gids)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
        if t.device != nh.device:
            raise ValueError(f"{name} is on {t.device}, nh on {nh.device}")
    if nh.dim() != 2 or e0.shape != nh.shape:
        raise ValueError(f"nh and e0 must both be [B, mb], got {tuple(nh.shape)} and "
                         f"{tuple(e0.shape)}")
    if tuple(gids.shape) != (nh.shape[1],):
        raise ValueError(f"gids must be [{nh.shape[1]}], got {tuple(gids.shape)}")
    if H < 0:
        raise ValueError(f"H must be at least 0, got {H}")
    shape = (nh.shape[0], 3 * H + 1)
    if out is not None and (out.dtype != torch.int32 or tuple(out.shape) != shape
                            or out.device != nh.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 {shape} tensor on {nh.device}")


def _views(out, H):
    return out[:, :H], out[:, H: 2 * H], out[:, 2 * H: 3 * H], out[:, 3 * H]


def shard_compact_plain(nh, e0, gids, H: int, out=None):
    """The sort of the definition: keys = gid where n_hits > 0, else
    0xFFFFFFFF, sorted stably (int64-widened), the first H kept."""
    _check(nh, e0, gids, H, out)
    B, mb = nh.shape
    hit = nh > 0
    keys = torch.where(hit, gids.to(torch.int64)[None, :] & _U32, _U32)
    order = torch.sort(keys, dim=1, stable=True).indices[:, :H]
    n = hit.sum(1, dtype=torch.int32)
    if out is None:
        out = torch.empty((B, 3 * H + 1), dtype=torch.int32, device=nh.device)
    kk, ke, kn, kc = _views(out, H)
    width = order.shape[1]
    kept = torch.arange(width, device=nh.device)[None, :] < n[:, None]
    kk.fill_(-1)
    ke.zero_()
    kn.zero_()
    kk[:, :width] = torch.where(kept, gids[order], -1)
    ke[:, :width] = torch.where(kept, torch.gather(e0, 1, order), 0)
    kn[:, :width] = torch.where(kept, torch.gather(nh, 1, order), 0)
    kc.copy_(n)
    return kk, ke, kn, kc


def shard_compact(nh, e0, gids, H: int, out=None):
    """The first H hit rows of each query of one shard, by gid.

    nh, e0 int32 [B, mb] (seed_locate_batch's outputs), gids int32 [mb]
    (uint32 bits, rising with the row over the rows that can hit); H >= 0;
    out: an optional contiguous int32 [B, 3H + 1] to write into.  Returns
    (gid, e0, n_hits) int32 [B, H] and n int32 [B], views of one buffer.
    CUDA tensors launch the kernel (`launches` counts the launches); CPU
    tensors run the plain version."""
    _check(nh, e0, gids, H, out)
    if nh.device.type == "cpu":
        return shard_compact_plain(nh, e0, gids, H, out)
    ptrs = _cuda_ptrs(nh=nh, e0=e0, gids=gids)
    B, mb = nh.shape
    if out is None:
        out = torch.empty((B, 3 * H + 1), dtype=torch.int32, device=nh.device)
    if B == 0:
        return _views(out, H)
    lib = kernel_lib()
    err = _on_device(nh.device, lambda stream: lib.shard_compact(
        *ptrs, out.data_ptr(), B, mb, H, stream))
    raise_on(err, lib, "shard_compact")
    shard_compact.launches += 1
    return _views(out, H)


shard_compact.launches = 0
