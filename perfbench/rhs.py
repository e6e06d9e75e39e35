"""The right-hand sides of a traffic mix: standard normal entries in
float64, drawn on the device from the run's seed, one ``torch.randn`` call
a ``b``.  The same seed gives the same sequence; no two ``b`` of a run
repeat.  A standard normal ``b`` is what the port's own bench and smoke
solve, and its iteration count varies from ``b`` to ``b`` as a user's
right-hand sides do (190 to 298 adaptive k-skip MrR iterations to 1e-4 at
N = 10.08M on an H100)."""

from __future__ import annotations

import torch


class Generator:
    def __init__(self, n: int, seed: int, device):
        self.n, self.device = n, device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed % 2**64)

    def __call__(self) -> torch.Tensor:
        """The next ``b``: one kernel on the device, no wait for it."""
        return torch.randn(self.n, generator=self.gen, dtype=torch.float64, device=self.device)
