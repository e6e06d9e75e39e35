"""Compute context for the eager solver loops (single device).

The counterpart of :class:`krylov_tpu.context.Context` with ``axis=None``:
reductions are plain tensor ops.  ``scalar_dtype`` widens the *operands*
of every inner product (not just the result), so the products themselves
are exact to the wide precision.  ``dot`` and ``norm`` reduce over the last
axis, so a ``(batch, n)`` block gives one value per member.  The mesh form (``psum`` over a device
axis) waits for the distributed port (ROADMAP queue 1, item 11).
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
        u, v = self._wide(u), self._wide(v)
        return torch.dot(u, v) if u.ndim == 1 else (u * v).sum(-1)

    def norm(self, u: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.dot(u, u))

    def dot_bundle(self, pairs) -> torch.Tensor:
        """Batch of inner products [(u_i, v_i), ...] as one stacked tensor."""
        return torch.stack([self.dot(u, v) for u, v in pairs])

    def gram(self, B: torch.Tensor) -> torch.Tensor:
        """(m, m) inner products of the rows of ``B``."""
        Bw = self._wide(B)
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
