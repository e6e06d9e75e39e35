"""A configuration, a traffic mix, a check and a metric added as files of
their own, with one new workloads entry and one new per-layer entry, are
found and run with no edit to a file that is there."""

import json
import shutil

from perfbench.tests._runner import ROOT, run_cell


def test_new_files_are_found(tmp_path):
    for sub in ("configs", "traffic", "checks", "metrics"):
        shutil.copytree(ROOT / "perfbench" / sub, tmp_path / "perfbench" / sub)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "perfbench/configs/poisson2d-500.json").read_text())
    cfg.update(name="poisson2d-1000", system={"fixture": "laplace2d", "args": {"nx": 1000, "constant": True}},
               n=1_000_000, test_args={"nx": 20, "ny": 30, "constant": True})
    (tmp_path / "perfbench/configs/poisson2d-1000.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "perfbench/traffic/mrr-1rhs.json").read_text())
    traffic.update(kwargs={"method": "cg"}, reference="pcg")
    (tmp_path / "perfbench/traffic/cg-1rhs.json").write_text(json.dumps(traffic))
    (tmp_path / "perfbench/checks/p2d1k-cg-1rhs.json").write_text(
        json.dumps({"sample": 4, "limits": {"true_rel": "tol", "x_err": 1e-9}}))
    (tmp_path / "perfbench/metrics/stretch_requests.py").write_text(
        "def read(run):\n    return run.stretch_requests\n")
    spec["configs"].append({"name": "poisson2d-1000", "source": "https://example.org/a-new-deployment",
                            "file": "perfbench/configs/poisson2d-1000.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "p2d1k-cg-1rhs", "config": "poisson2d-1000", "traffic": "cg-1rhs",
                              "chips": 1, "why": "test"})
    next(m for m in spec["end_to_end"] if m["name"] == "solve_ms")["workloads"].append("p2d1k-cg-1rhs")
    spec["per_layer"].append({"name": "stretch_requests", "unit": "requests", "better": "higher",
                              "source": "program_counter", "layer": "test", "moves": "solve_ms",
                              "workloads": ["p2d1k-cg-1rhs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    code, line, _, err = run_cell("p2d1k-cg-1rhs", trace=1, root=tmp_path)
    assert code == 0, err[-3000:]
    assert line["correct"] is True
    assert line["metrics"]["stretch_requests"]["value"] == traffic["trace_requests"]
    code, line, _, err = run_cell("p2d1k-cg-1rhs", trace=0, root=tmp_path)
    assert code == 0 and set(line["metrics"]) == {"solve_ms", "setup_s"}, err[-3000:]
