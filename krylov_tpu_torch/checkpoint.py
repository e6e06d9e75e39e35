"""Solve checkpoints: save an iterate and its solve info to disk, and resume.

The counterpart of :mod:`krylov_tpu.checkpoint`, with the same ``.npz``
layout (``x``, ``residual``, ``nosl``, ``khistory``, ``meta_json``), so a
file written by either package loads in the other.  A resumed solve
warm-starts from the saved iterate (restarted-Krylov semantics: the Krylov
space is rebuilt).  Numpy only, apart from taking a tensor ``x`` from any
device.
"""

from __future__ import annotations

import json
import time
from typing import Optional, Tuple

import numpy as np


def _numpy(v) -> np.ndarray:
    """``v`` as a host array (a tensor comes off its device)."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save(path: str, x, info: Optional[dict] = None, **metadata) -> None:
    """Save the iterate ``x`` (an array, or a tensor on any device), the
    traces and counts of ``info`` and the keyword ``metadata`` to ``path``."""
    payload = {"x": _numpy(x)}
    meta = {"saved_at": time.time(), **metadata}
    if info is not None:
        payload["residual"] = np.asarray(info.get("residual", []))
        payload["nosl"] = np.asarray(info.get("nosl", []))
        if "khistory" in info:
            payload["khistory"] = np.asarray(info["khistory"])
        meta["iterations"] = int(info.get("iterations", 0))
        meta["converged"] = bool(info.get("converged", False))
    payload["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **payload)


def load(path: str) -> Tuple[np.ndarray, dict]:
    """``(x, state)`` of a checkpoint: ``state`` holds ``residual``,
    ``nosl``, ``khistory`` (where saved) and ``meta``."""
    with np.load(path) as z:
        x = z["x"]
        state = {key: z[key] for key in ("residual", "nosl", "khistory") if key in z}
        if "meta_json" in z:
            state["meta"] = json.loads(bytes(z["meta_json"].tobytes()).decode())
    return x, state


def resume(A, b, path: str, **solve_kwargs):
    """Warm-start :func:`krylov_tpu_torch.solve` from the iterate saved at
    ``path`` (it lands on the operator's device); returns ``(x, info)``,
    ``info["resumed_from"]`` holding the path and the checkpoint's
    iteration count."""
    from krylov_tpu_torch.api import solve

    x_ckpt, state = load(path)
    x, info = solve(A, b, x0=x_ckpt, **solve_kwargs)
    info["resumed_from"] = {"path": path, "prior_iterations": state.get("meta", {}).get("iterations", None)}
    return x, info
