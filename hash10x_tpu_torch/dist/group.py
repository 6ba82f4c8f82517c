"""The shard group: the port's counterpart of the JAX package's 1-D device
mesh ``"d"`` and of the collectives its ``shard_map`` bodies use.

The JAX package keeps per-shard arrays with a leading shard axis ``(n, C)``
sharded over the mesh.  Here each process holds its shards ``[lo, hi)``
stacked as ``(n_local, ...)`` tensors on its one device, so shard s of the
port lines up with shard s of the JAX package.  Five operations carry the
cross-shard traffic:

=====================  ==================================================
``all_to_all(lanes)``  ``(n_local, n, cap, ...)`` send lanes (row = source
                       shard, column = destination) -> the same shape,
                       row = destination, column = source
                       (``lax.all_to_all`` of fixed-capacity lanes)
``all_reduce(x, op)``  sum / min / max over the shard axis, then over the
                       processes (``psum``, ``pmin``, ``pmax``)
``all_gather_rows(x)`` every shard's rows on every process
``host_allgather(a)``  a numpy array from every process
                       (``process_allgather``)
``barrier()``          synchronise the processes
=====================  ==================================================

With one process every operation is a tensor operation on the device and
no library is involved.  With several, the cross-process part runs over
``torch.distributed`` with the ``gloo`` backend.  Gloo reduces and moves
data in host memory (a CUDA tensor is staged through a host copy either
way), and which collectives take CUDA tensors differs between them and
between torch builds; so every collective here copies its tensor to the
host, runs gloo on the CPU copy and copies the result back: explicitly, on
every call, the same way for every operation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import timing

__all__ = ["ShardGroup"]

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def _dist():
    import torch.distributed as dist
    return dist


class ShardGroup:
    """``n_shards`` shards (a power of two) over ``world`` processes; this
    process (``rank``) holds shards ``[lo, hi)`` on ``device``."""

    def __init__(self, n_shards: int, device, world: int = 1, rank: int = 0):
        if n_shards < 1 or n_shards & (n_shards - 1):
            raise ValueError("mesh size must be a power of two")
        if n_shards % world:
            raise ValueError(f"{n_shards} shards do not divide over {world} "
                             "processes")
        self.n_shards = n_shards
        self.world = world
        self.rank = rank
        self.n_local = n_shards // world
        self.lo = rank * self.n_local
        self.hi = self.lo + self.n_local
        self.device = torch.device(device)
        self.backend = _dist().get_backend() if world > 1 else None

    @classmethod
    def of_process(cls, n_shards: int, device) -> "ShardGroup":
        """The group over every process of the initialised process group
        (one process when there is none)."""
        dist = _dist()
        if dist.is_available() and dist.is_initialized():
            return cls(n_shards, device, dist.get_world_size(),
                       dist.get_rank())
        return cls(n_shards, device)

    @property
    def shard_bits(self) -> int:
        return (self.n_shards - 1).bit_length()

    # -- collectives -----------------------------------------------------------

    def lane_width(self, lanes: torch.Tensor, pad) -> int:
        """The widest lane's entry count over every process, for
        ``(n_local, n, cap)`` lanes, or ``(n_local, n, S, cap)`` (one lane
        per batch of a stacked step), holding their entries first and
        ``pad`` after (a collective); ``cap`` with one process, where
        nothing travels."""
        if self.world == 1:
            return lanes.shape[-1]
        used = torch.tensor([[int((lanes != pad).sum(dim=-1).max())]],
                            device=self.device)
        return max(int(self.all_reduce(used, "max")[0]), 1)

    def all_to_all(self, lanes: torch.Tensor, pad=None,
                   width: Optional[int] = None) -> torch.Tensor:
        """``(n_local, n, ...)`` send lanes -> ``(n_local, n, ...)`` receipts:
        ``out[i, s]`` is what shard ``s`` sent to shard ``lo + i``.

        With ``pad``, the lanes are ``(n_local, n, cap)`` or ``(n_local, n,
        S, cap)`` with their entries first and ``pad`` after: between
        processes only the first ``width`` slots (default ``lane_width``)
        of every lane travel, and the receipts are padded back to ``cap``."""
        if self.world == 1:
            return lanes.transpose(0, 1).contiguous()
        if pad is not None:
            cap = lanes.shape[-1]
            m = width if width is not None else self.lane_width(lanes, pad)
            recv = self.all_to_all(lanes[..., :m].contiguous())
            if m == cap:
                return recv
            return torch.cat([recv, recv.new_full(
                (*recv.shape[:-1], cap - m), pad)], dim=-1)
        nl, w = self.n_local, self.world
        rest = lanes.shape[2:]
        # (src_local, dst_rank, dst_local, ...) -> dst_rank-major send buffer
        send = lanes.reshape(nl, w, nl, *rest).transpose(0, 1).contiguous()
        host = send.cpu()
        recv = torch.empty_like(host)
        _dist().all_to_all_single(recv, host)
        # (src_rank, src_local, dst_local, ...) -> (dst_local, src, ...)
        recv = recv.to(self.device).permute(2, 0, 1, *range(3, 3 + len(rest)))
        return recv.reshape(nl, self.n_shards, *rest).contiguous()

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``(n_local, ...)`` over the shard axis and the processes."""
        if op == "sum":
            r = x.sum(dim=0)
        elif op == "min":
            r = x.amin(dim=0)
        elif op == "max":
            r = x.amax(dim=0)
        else:
            raise ValueError(f"unknown reduction {op!r}")
        if self.world == 1:
            return r
        host = r.cpu()
        _dist().all_reduce(host, op=getattr(_dist().ReduceOp, _OPS[op]))
        return host.to(self.device)

    def all_gather_rows(self, x: torch.Tensor,
                        pad: Optional[int] = None) -> torch.Tensor:
        """``(n_local, W, ...)`` -> ``(n, W', ...)`` on every process.  With
        ``pad`` the processes' widths W may differ: every process pads to the
        largest with ``pad`` first."""
        if self.world == 1:
            return x
        if pad is not None:
            width = int(self.all_reduce(
                torch.tensor([[x.shape[1]]], device=self.device), "max")[0])
            if width > x.shape[1]:
                fill = x.new_full((x.shape[0], width - x.shape[1],
                                   *x.shape[2:]), pad)
                x = torch.cat([x, fill], dim=1)
        host = x.contiguous().cpu()
        parts = [torch.empty_like(host) for _ in range(self.world)]
        _dist().all_gather(parts, host)
        return torch.cat(parts).to(self.device)

    def host_allgather(self, a: np.ndarray) -> np.ndarray:
        """``(world, *a.shape)``: ``a`` from every process (equal shapes)."""
        a = np.ascontiguousarray(a)
        if self.world == 1:
            return a[None]
        t = torch.from_numpy(a)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        _dist().all_gather(parts, t)
        return torch.stack(parts).numpy()

    def barrier(self) -> None:
        if self.world > 1:
            _dist().barrier()

    # -- helpers ---------------------------------------------------------------

    def stack_padded(self, rows, pad, width: int = 0) -> torch.Tensor:
        """``(n_local, W)`` of 1-D tensors padded with ``pad`` to the widest
        (at least ``width``)."""
        w = max([width, 1] + [int(r.shape[0]) for r in rows])
        out = torch.full((len(rows), w), pad, dtype=rows[0].dtype,
                         device=self.device)
        for i, r in enumerate(rows):
            out[i, :r.shape[0]] = r
        return out

    def gather_counts(self, local_counts) -> np.ndarray:
        """``(n,)`` int64 host array of one number per shard."""
        with timing.wait("shard.counts"):
            t = torch.tensor([[int(c)] for c in local_counts],
                             dtype=torch.int64, device=self.device)
        t = self.all_gather_rows(t).reshape(-1)
        with timing.wait("shard.counts"):
            return t.cpu().numpy()
