"""iterations_per_solve: the mean ``SolveResult.iterations`` over the
window's requests (read by the host at the end of each request)."""


def read(run):
    return sum(run.iterations) / len(run.iterations)
