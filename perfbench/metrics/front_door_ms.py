"""front_door_ms: the host time of the front door of the whole-solve
kernels a request, over the window: the self time (less the spans opened
inside) of ``krylov_tpu_torch.tracing``'s spans ``solve_device`` (the
entry point), ``plan`` (options, operator and ``b`` on the device, the
route), ``run_fused`` (``b``'s norm, the 2-D collapse, the result),
``launch`` (plan lookup, workspace, scalars, the C call) and ``restarts``
(the defect corrections).  The host reads are spans of their own and not
in it."""

from perfbench import spans

SPANS = ("solve_device", "plan", "run_fused", "launch", "restarts")
KEYS = tuple(f"{name}.self_ns" for name in SPANS)
COUNTERS = spans.counters(*KEYS)


def read(run):
    if not spans.found(run, KEYS):
        return None
    return sum(run.counters[key] for key in KEYS) * 1e-6 / run.requests
