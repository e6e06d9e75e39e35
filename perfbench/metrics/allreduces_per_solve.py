"""allreduces_per_solve: the program's all-reduce calls
(``context.all_reduce.calls``) over the window, divided by its requests."""

COUNTERS = {"all_reduce": "krylov_tpu_torch.context:all_reduce.calls"}


def read(run):
    return run.counters["all_reduce"] / run.requests
