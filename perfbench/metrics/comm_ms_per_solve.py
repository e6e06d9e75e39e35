"""comm_ms_per_solve: the device time of NCCL kernels on rank 0's card in
the stretch, a request; it holds the wait for the other ranks."""

import re

KERNELS = re.compile(r"nccl", re.IGNORECASE)


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.kernels(KERNELS)
    if not launches:
        return None
    return run.trace.seconds(launches) * 1e3 / run.stretch_requests
