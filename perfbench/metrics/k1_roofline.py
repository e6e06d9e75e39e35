"""k1_roofline: the stencil SpMV K1's share of its roofline on rank 0.

Time: the profiler's device time of every K1 launch in the stretch.
Count: for each SpMV, ``2 nnz`` of the rows rank 0 owns, ``x`` read and
``y`` written once (:mod:`perfbench.roofline`).  One device: each K1
launch is one SpMV.  Row-partitioned: an SpMV is the bulk launch on the
rank's slab and its boundary-plane launches, counted by the program's
``sharded_matvec.calls``.
"""

import re

from perfbench import roofline

KERNELS = re.compile(r"\bstencil2d_kernel\b")
COUNTERS = {"sharded_matvec": "krylov_tpu_torch.dist.spmv:sharded_matvec.calls"}


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.kernels(KERNELS)
    seconds = run.trace.seconds(launches)
    if seconds <= 0:
        return None
    planes = run.grid[0] // run.ranks
    rows = planes * (run.n // run.grid[0])
    spmvs = run.stretch_counters["sharded_matvec"] if run.ranks > 1 else len(launches)
    per = roofline.spmv_bound_s(rows, roofline.nnz(run.grid, (0, planes)), run.config["dtype"])
    return 100.0 * spmvs * per / seconds
