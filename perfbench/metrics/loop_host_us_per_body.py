"""loop_host_us_per_body: the host time of an eager loop body, over the
window: the ``eager_loop`` spans' time (``krylov_tpu_torch.tracing``) less
that of the host reads inside them, over the bodies they ran
(``eager_bodies``, frozen ones included).  In a host-bound cell this is
the pace the card is fed at."""

from perfbench import spans

KEYS = ("eager_loop.total_ns", "eager_loop.read_ns", "eager_bodies.calls")
COUNTERS = spans.counters(*KEYS)


def read(run):
    if not spans.found(run, KEYS) or run.counters["eager_bodies.calls"] <= 0:
        return None
    c = run.counters
    return (c["eager_loop.total_ns"] - c["eager_loop.read_ns"]) * 1e-3 / c["eager_bodies.calls"]
