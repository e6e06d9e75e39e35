"""Faults planted in the program for the tests that must see ``correct``
come out false: module-level functions, so a world's ranks can take them."""

import dataclasses


def _wrap(change):
    import krylov_tpu_torch

    solve = krylov_tpu_torch.solve_device

    def broken(A, b, **kw):
        res = solve(A, b, **kw)
        return dataclasses.replace(res, x=change(res.x))

    krylov_tpu_torch.solve_device = broken


def unchanged_state():
    """Every solve hands back its starting state, ``x = x0 = 0``."""
    _wrap(lambda x: x.new_zeros(x.shape))


def altered_answer():
    """One entry of every answer altered where the solve produces it."""

    def change(x):
        x = x.clone()
        x[x.numel() // 2] += 1.0
        return x

    _wrap(change)


def no_exchange():
    """The halo exchange between ranks left out of every sharded SpMV."""
    from krylov_tpu_torch.dist import spmv

    spmv._post_halo = lambda x, lo, hi, width, op, ctx: (None, None, None)
