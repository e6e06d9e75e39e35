"""fused_roofline: the whole-solve kernels' share of their roofline.

Time: the profiler's device time of the whole-solve kernels (K2/K3
resident or streaming, K5/K6 resident or streaming) in the stretch.
Count: for each request of the stretch, the plain method's operations an
iteration times the plain reference's iteration count on the same ``b``,
and ``b`` read and ``x`` written once (:mod:`perfbench.roofline`).
"""

import re

from perfbench import roofline

KERNELS = re.compile(r"\b(cg|mrr)_(stream|resident)_kernel|\bkskip(cg|mrr)_(fused|resident)_kernel")
FAMILY = {"mrr": "mrr", "pcg": "cg"}


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.seconds(run.trace.kernels(KERNELS))
    if seconds <= 0:
        return None
    family, dtype = FAMILY[run.traffic["reference"]], run.config["dtype"]
    nnz = roofline.nnz(run.grid)
    bound = sum(roofline.whole_solve_bound_s(family, run.n, nnz, m, dtype) for m in run.stretch_ref_iterations)
    return 100.0 * bound / seconds
