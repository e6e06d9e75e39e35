"""Run reporting: banner, summary and the info dict (numpy only).

The same banners and ``info`` layout as :mod:`krylov_tpu.diagnostics.report`;
device tensors come to the host here, once per solve.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def start_banner(method_name: str, k: Optional[int] = None) -> None:
    print("# " + "=" * 16 + " INFO " + "=" * 16 + " #")
    print(f"Method:\t\t{method_name}")
    if k is not None:
        print(f"Initial_k:\t{k}")


def finish_banner(
    elapsed_time: float,
    converged: bool,
    num_of_iter: int,
    final_residual: float,
    final_k: Optional[int] = None,
) -> None:
    print(f"Time:\t\t{elapsed_time} s")
    print(f"Status:\t\t{'converged' if converged else 'diverged'}")
    print(f"Iteration:\t{num_of_iter} times")
    print(f"Final_Residual:\t{final_residual}")
    if final_k is not None:
        print(f"Final_k:\t{final_k}")
    print("# " + "=" * 38 + " #")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def build_info(result, elapsed_time: float) -> dict:
    """Info dict: ``time``, ``nosl``, ``residual``, ``converged``,
    ``iterations``, ``khistory``/``final_k`` where the solver adapts k,
    ``true_residual`` after ``restarts=`` defect corrections, and
    ``residual_truncated`` when the fused path's trace ran past its
    capacity."""
    index = int(result.index)
    info = {
        "time": elapsed_time,
        "nosl": _host(result.nosl_trace)[: index + 1],
        "residual": _host(result.residual_trace)[: index + 1],
        "converged": bool(result.converged),
        "iterations": int(result.iterations),
    }
    if result.k_trace is not None:
        info["khistory"] = _host(result.k_trace)[: index + 1]
    if result.final_k is not None:
        info["final_k"] = int(result.final_k)
    if result.true_residual is not None:
        info["true_residual"] = float(result.true_residual)
    if result.trace_truncated is not None and bool(result.trace_truncated):
        # iteration counts stay exact; only residual recording clamps
        info["residual_truncated"] = True
    return info
