"""Compute context for the eager solver loops (single device).

The counterpart of :class:`krylov_tpu.context.Context` with ``axis=None``:
reductions are plain tensor ops.  ``scalar_dtype`` widens the *operands*
of every inner product (not just the result), so the products themselves
are exact to the wide precision.  ``dot``, ``norm`` and ``gram`` take a
leading batch axis and reduce each member as a solo solve does, so a
batched member's inner products are its solo ones bit for bit.  The mesh
form (``psum`` over a device axis) waits for the distributed port
(ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Context:
    axis: Optional[str] = None
    scalar_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        if self.axis is not None:
            raise NotImplementedError(
                "Context(axis=...) waits for the distributed port "
                "(ROADMAP queue 1, item 11)"
            )

    def _wide(self, v: torch.Tensor) -> torch.Tensor:
        return v.to(self.scalar_dtype) if self.scalar_dtype is not None else v

    def dot(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``<u, v>``; on ``(batch, n)`` blocks one product per member, the
        solo solve's own reduction, as :meth:`gram`."""
        u, v = self._wide(u), self._wide(v)
        if u.ndim == 1:
            return torch.dot(u, v)
        return torch.stack([torch.dot(a, c) for a, c in zip(u, v)])

    def norm(self, u: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.dot(u, u))

    def dot_bundle(self, pairs) -> torch.Tensor:
        """Batch of inner products [(u_i, v_i), ...] as one stacked tensor."""
        return torch.stack([self.dot(u, v) for u, v in pairs])

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
            return torch.stack([self._rows_dot(m, m) for m in Bw])
        return self._rows_dot(Bw, Bw)

    def cross_gram(self, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        """(m_u, m_v) inner products between rows of ``U`` and rows of ``V``."""
        return self._rows_dot(self._wide(U), self._wide(V))

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
        (``needs_ctx = True``, e.g. :class:`~krylov_tpu_torch.precond.ChebyshevPreconditioner`)
        gets it."""
        if getattr(A, "needs_ctx", False):
            return A.matvec(x, self)
        return A.matvec(x)


DEFAULT_CONTEXT = Context()
