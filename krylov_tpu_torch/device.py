"""The device on which the entry points put tensors made from host input.

The fixtures, :func:`~krylov_tpu_torch.sparse.as_operator`, the converters
of :mod:`~krylov_tpu_torch.sparse.convert`, the loaders of
:mod:`~krylov_tpu_torch.sparse.io` and ``solve``/``solve_device``/
``solve_batched`` given a numpy or scipy input call :func:`resolve` on
their ``device=None``: the CUDA device unless :func:`set_default_device`
chose another.  A tensor that already lies on a device keeps it.  Nothing
here checks for a card: without one, a tensor made on the default device
raises torch's own error.
"""

from __future__ import annotations

import torch

_default = torch.device("cuda")


def default_device() -> torch.device:
    """The device host input goes to when the caller names none."""
    return _default


def set_default_device(device) -> torch.device:
    """Make ``device`` the default; returns the previous default."""
    global _default
    previous, _default = _default, torch.device(device)
    return previous


def resolve(device) -> torch.device:
    """``device``, or the default when it is None."""
    return _default if device is None else torch.device(device)
