"""The comparison that decides ``correct`` fails what it must: the control
(the program's float32 path in place of the configuration's float64) and
faults planted under a run whose look for a card is skipped.  At the
configurations' test sizes, with the cells' own limits."""

import json

import pytest

from perfbench import calibrate, check, harness
from perfbench.tests import faults
from perfbench.tests._runner import MESH_CELL, ROOT, mesh_root

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in SPEC["workloads"]] + [MESH_CELL]


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    return mesh_root(tmp_path_factory.mktemp("mesh"))


def _root(workload, mesh):
    return mesh if workload == MESH_CELL else ROOT


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_passes_and_control_fails(workload, mesh):
    out = calibrate.calibrate(workload, range(1, 4), range(11, 14), device_type="cpu", test=True,
                              root=_root(workload, mesh))
    assert out["summary"]["program_ok"] is True, out["summary"]
    assert out["summary"]["control_ok"] is False, out["summary"]


def _run(workload, fault, root):
    return harness.run(workload, 77, 0.5, False, device_type="cpu", test=True, fault=fault, root=root)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", [faults.unchanged_state, faults.altered_answer])
def test_fault_makes_correct_false(workload, fault, monkeypatch, mesh):
    import krylov_tpu_torch

    # the planted fault replaces the entry point in this process: undo it
    monkeypatch.setattr(krylov_tpu_torch, "solve_device", krylov_tpu_torch.solve_device)
    line = _run(workload, fault, _root(workload, mesh))
    assert line["correct"] is False, line["checks"]


def test_missing_exchange_makes_correct_false(mesh):
    line = _run(MESH_CELL, faults.no_exchange, mesh)
    assert line["correct"] is False, line["checks"]


def test_judge_limits():
    rows = [{"true_rel": 5e-5, "x_err": 1e-12}, {"true_rel": 9e-5, "x_err": 3e-12}]
    ok, out = check.judge(rows, {"true_rel": "tol", "x_err": 1e-9}, 1e-4)
    assert ok and out == {"true_rel": {"value": 9e-5, "limit": 1e-4}, "x_err": {"value": 3e-12, "limit": 1e-9}}
    assert not check.judge(rows, {"true_rel": "tol"}, 8e-5)[0]
    assert not check.judge([], {"true_rel": "tol"}, 1e-4)[0]
