"""Parameter carry-over from the JAX package's containers.

:func:`from_jax_operator` reads a ``krylov_tpu`` container's leaves through
``np.asarray`` (so this module never imports jax) and builds the matching
container of this package, which lets one operator feed both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from krylov_tpu_torch.sparse.formats import DiaMatrix, StencilMatrix


def from_jax_operator(A, device="cpu", dtype=None):
    """Convert a ``krylov_tpu`` ``StencilMatrix`` or ``DiaMatrix``.

    ``dtype`` (a torch dtype) defaults to the leaf's own dtype."""
    kind = type(A).__name__
    if kind == "StencilMatrix":
        leaf, build = A.coef, lambda t: StencilMatrix(
            t, tuple(tuple(int(v) for v in d) for d in A.stencil),
            tuple(int(g) for g in A.grid),
        )
    elif kind == "DiaMatrix":
        leaf, build = A.data, lambda t: DiaMatrix(
            t, tuple(int(o) for o in A.offsets), tuple(int(s) for s in A.shape)
        )
    else:
        raise TypeError(
            f"from_jax_operator takes StencilMatrix or DiaMatrix, got {kind}; "
            "ELL/HYB/dense wait for the 'irregular operators and IO' port "
            "(ROADMAP queue 1, item 8)"
        )
    t = torch.as_tensor(np.array(leaf), device=device)
    return build(t if dtype is None else t.to(dtype))
