"""launches_per_solve: CUDA kernel launches in the profiled stretch (rank
0's card) over the requests in it.  The stretch's right-hand sides are
drawn before it starts, so every kernel in it is the program's."""


def read(run):
    if run.trace is None or not run.trace.kernels():
        return None
    return len(run.trace.kernels()) / run.stretch_requests
