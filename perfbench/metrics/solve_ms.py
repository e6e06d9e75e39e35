"""solve_ms: the whole measured window over the right-hand sides solved in
it (the host clock from the first request's call to the last one's host
read)."""


def read(run):
    return run.window_s * 1e3 / (run.requests * run.rhs_per_request)
