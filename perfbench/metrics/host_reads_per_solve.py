"""host_reads_per_solve: the program's device-to-host reads inside its
calls (``krylov_tpu_torch.tracing``'s ``host_read`` spans) over the
window, divided by its requests.  The harness's own read of each request's
iteration count is not among them."""

from perfbench import spans

KEYS = ("host_read.calls",)
COUNTERS = spans.counters(*KEYS)


def read(run):
    if not spans.found(run, KEYS):
        return None
    return run.counters["host_read.calls"] / run.requests
