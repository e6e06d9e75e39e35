"""Every cell of BENCHMARK.json runs end to end on the CPU at its
configuration's test size, through the program's plain versions, and prints
the contract's last line, with ``--trace 0`` and ``--trace 1``."""

import json

import pytest

from perfbench.tests._runner import MESH_CELL, ROOT, mesh_root, run_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    return mesh_root(tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS + [MESH_CELL])
def test_cell_runs_on_cpu(workload, trace, mesh):
    root = mesh if workload == MESH_CELL else ROOT
    spec = json.loads((root / "BENCHMARK.json").read_text())
    code, line, _, err = run_cell(workload, seed=2**31 + 11, trace=trace, root=root)
    assert code == 0, err[-3000:]
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    mine = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    if trace == 0:
        assert set(line["metrics"]) == {m["name"] for m in mine}
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        # off a card no device trace is read: only the counters' metrics
        assert any(m.startswith("iterations_per_solve") for m in line["metrics"])
        assert all(m in {p["name"] for p in spec["per_layer"]} for m in line["metrics"])
    for name, c in line["checks"].items():
        assert f"check {name}: " in err


def test_same_seed_same_requests():
    """The same seed draws the same right-hand sides; another seed others;
    a seed above 2**32 is taken."""
    import torch

    from perfbench import harness

    cell = harness.load_cell("p2d-mrr-1rhs")
    dev = torch.device("cpu")
    a, b, c = (harness.Client(cell, dev, s, test=True) for s in (2**33 + 1, 2**33 + 1, 2**33 + 2))
    for _ in range(3):
        ra, rb, rc = a.rhs(), b.rhs(), c.rhs()
        assert torch.equal(ra, rb) and not torch.equal(ra, rc)
