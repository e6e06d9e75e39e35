"""Compute context for the eager solver loops, on one device or row-partitioned.

The counterpart of :class:`krylov_tpu.context.Context`:

- ``Context()`` (``axis=None``): single-device; reductions are plain tensor
  ops.
- ``Context(axis="rows", group=g)``: the loop runs on this rank's row
  block of a solve partitioned over the ``torch.distributed`` process
  group ``g`` (:mod:`krylov_tpu_torch.dist`).  Each reduction forms its
  local product as the single-device form does, then sums it over the
  group with **one** all-reduce, the JAX package's one ``psum``; the
  operator's matvec makes its own exchange.

``scalar_dtype`` widens the *operands* of every inner product (not just the
result), so the products themselves are exact to the wide precision.
``dot``, ``norm``, ``dot_bundle`` and ``gram`` take a leading batch axis and
reduce each member as a solo solve does, so a batched member's inner
products are its solo ones bit for bit; a batch still makes one all-reduce
a reduction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from krylov_tpu_torch import tracing


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (one collective; ``t`` must be a
    contiguous tensor the caller owns).  ``all_reduce.calls`` counts the
    collectives."""
    with tracing.span("all_reduce"):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    all_reduce.calls += 1
    return t


all_reduce.calls = 0


@dataclasses.dataclass(frozen=True)
class Context:
    axis: Optional[str] = None
    scalar_dtype: Optional[torch.dtype] = None
    # the torch.distributed process group of the rows axis (with ``axis``)
    group: Optional[object] = None

    def __post_init__(self):
        if (self.axis is None) != (self.group is None):
            raise ValueError(
                "Context takes axis= and group= together: the rows axis and its "
                "torch.distributed process group (krylov_tpu_torch.dist.make_mesh)"
            )

    def _wide(self, v: torch.Tensor) -> torch.Tensor:
        return v.to(self.scalar_dtype) if self.scalar_dtype is not None else v

    def _sum(self, local: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' local products (one all-reduce of the fresh
        tensor ``local``); single-device, ``local`` itself."""
        return local if self.group is None else all_reduce(local, self.group)

    def psum(self, v: torch.Tensor) -> torch.Tensor:
        """``v`` summed over the rows group (one all-reduce of a copy)."""
        return v if self.group is None else all_reduce(v.clone(memory_format=torch.contiguous_format), self.group)

    def _local_dot(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        u, v = self._wide(u), self._wide(v)
        if u.ndim == 1:
            return torch.dot(u, v)
        return torch.stack([torch.dot(a, c) for a, c in zip(u, v)])

    def dot(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``<u, v>``; on ``(batch, n)`` blocks one product per member, the
        solo solve's own reduction, as :meth:`gram`."""
        return self._sum(self._local_dot(u, v))

    def norm(self, u: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.dot(u, u))

    def dot_bundle(self, pairs) -> torch.Tensor:
        """Batch of inner products [(u_i, v_i), ...] as one stacked tensor,
        summed over the rows group in one all-reduce."""
        return self._sum(torch.stack([self._local_dot(u, v) for u, v in pairs]))

    def gram(self, B: torch.Tensor) -> torch.Tensor:
        """(m, m) inner products of the rows of ``B``; a ``(batch, m, n)``
        stack gives ``(batch, m, m)``, one product per member: the solo
        solve's own product, so each member's Gram is the solo one bit for
        bit.  One strided-batched product sums the long inner products in
        another order, and the k-skip recurrences amplify that rounding
        (about 1e12-fold at k = 8): on the card it changed the counts of
        batched adaptive k=8 members against their solo solves, as the
        inner products of :meth:`dot` summed in a batched reduction did."""
        Bw = self._wide(B)
        if Bw.ndim == 3:
            return self._sum(torch.stack([self._rows_dot(m, m) for m in Bw]))
        return self._sum(self._rows_dot(Bw, Bw))

    def cross_gram(self, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        """(m_u, m_v) inner products between rows of ``U`` and rows of ``V``."""
        return self._sum(self._rows_dot(self._wide(U), self._wide(V)))

    @staticmethod
    def _rows_dot(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        """``U @ V.T``, one matrix product.  On the card a float32 product
        follows ``torch.backends.cuda.matmul.allow_tf32``; the JAX package
        pins ``Precision.HIGHEST``, so the flag is held off for the call
        and restored after."""
        if not (U.is_cuda and U.dtype == torch.float32):
            return U @ V.T
        flags = torch.backends.cuda.matmul
        previous = flags.allow_tf32
        flags.allow_tf32 = False
        try:
            return U @ V.T
        finally:
            flags.allow_tf32 = previous

    def matvec(self, A, x: torch.Tensor) -> torch.Tensor:
        """Apply the operator; one that needs the context
        (``needs_ctx = True``: :class:`~krylov_tpu_torch.dist.ShardedOperator`
        for its exchanges, :class:`~krylov_tpu_torch.precond.ChebyshevPreconditioner`)
        gets it."""
        if getattr(A, "needs_ctx", False):
            return A.matvec(x, self)
        return A.matvec(x)


DEFAULT_CONTEXT = Context()
