"""The profiled stretch's reduction on a hand-made timeline: busy time is
the union of device work inside the stretch, annotations mirrored on the
card are not work, and idle gaps are named by the innermost host call."""

import pytest
import torch

from perfbench import trace
from perfbench.rhs import Generator
from perfbench.reference import solvers, stencil

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, end, thread=1, index=0):
        self._n, self._d, self._s, self._e, self._t, self._i = name, dev, start, end, thread, index

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def start_thread_id(self):
        return self._t

    def device_index(self):
        return self._i

    def is_user_annotation(self):
        return self._n.startswith("perfbench.")


def test_reduce_hand_made_timeline():
    events = [
        Ev(trace.STRETCH, CPU, 1000, 2000),
        Ev(trace.STRETCH, CUDA, 1000, 2000),  # mirrored annotation: no work
        Ev(trace.REQUEST, CPU, 1000, 1900),
        Ev("cudaLaunchKernel", CPU, 1010, 1050),
        Ev("aten::dot", CPU, 1300, 1400),
        Ev("k_a", CUDA, 900, 1100),  # clipped to the stretch: 100
        Ev("k_b", CUDA, 1050, 1200),  # overlaps k_a: union 1000-1200
        Ev("Memcpy DtoH (Device -> Pinned)", CUDA, 1500, 1600),
        Ev("k_other_card", CUDA, 1200, 1500, index=1),
        Ev("k_after", CUDA, 2100, 2200),
        Ev("other thread", CPU, 1200, 1500, thread=2),
    ]
    t = trace.reduce(events, 0)
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx(300e-9)  # 1000-1200 and 1500-1600
    assert [e.name for e in t.kernels()] == ["k_a", "k_b"]
    assert len(t.events) == 3
    gaps = dict((k, v) for k, v in t.idle_gaps)
    # 1200-1500 (midpoint 1350 in aten::dot), 1600-2000 (midpoint 1800 in the request)
    assert gaps == {"aten::dot": pytest.approx(300e-9), trace.REQUEST: pytest.approx(400e-9)}
    assert dict(t.device_ops)["k_a"] == pytest.approx(100e-9)


def test_normal_rhs_follow_the_seed():
    """The same seed gives the same sequence of b, one b never repeats in a
    run, and a seed past 32 bits is taken."""
    seed = 2**31 + 12345
    g1, g2 = Generator(300, seed, "cpu"), Generator(300, seed, "cpu")
    b1, b2 = g1(), g1()
    assert b1.dtype == torch.float64 and b1.shape == (300,)
    assert torch.equal(b1, g2()) and torch.equal(b2, g2())
    assert not torch.equal(b1, b2)
    assert not torch.equal(b1, Generator(300, seed + 1, "cpu")())


def test_normal_rhs_vary_the_work():
    """A standard normal b carries its own iteration count, as a user's
    right-hand sides do."""
    grid = (40, 30)
    g = Generator(1200, 7, "cpu")
    counts = {solvers.mrr(lambda v: stencil.apply(v, grid), g(), 1e-6, 5000)[0] for _ in range(6)}
    assert len(counts) > 1
