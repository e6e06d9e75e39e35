"""The benchmark's plain reference: a stencil apply, MrR, and preconditioned
CG (CG without a preconditioner) with its own Chebyshev polynomial, in plain
PyTorch.

It imports nothing of the program under test and takes nothing the program
made: the operator, the polynomial's spectral bounds and the residuals are
worked out again here from the configuration's grid and the right-hand sides
the benchmark drew.
"""
