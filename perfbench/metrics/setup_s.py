"""setup_s: from the start of the process that prints the result to the end
of the warm-up request (on every rank): imports, the kernels' build or load,
the system, the right-hand-side generator and one request of the cell's own
shapes."""


def read(run):
    return run.setup_s
