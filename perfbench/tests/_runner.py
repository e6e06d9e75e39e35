"""Test helper: run one cell on the CPU in a fresh interpreter and return
its exit code, result line (or None) and the top-level names of the modules
that interpreter held at its end."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_WRAPPER = """
import json, sys
from perfbench.tests import cpu_cell
code = cpu_cell.main(sys.argv[1:])
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})), file=sys.stderr)
sys.exit(code)
"""


def run_cell(workload, seed=12345678901, seconds=1.0, trace=0, root=None, preamble="", timeout=600):
    args = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    if root is not None:
        args += ["--root", str(root)]
    proc = subprocess.run([sys.executable, "-c", preamble + _WRAPPER, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    line = None
    if lines:
        try:
            line = json.loads(lines[-1])
        except json.JSONDecodeError:
            line = None
    err = proc.stderr.strip().splitlines()
    modules = json.loads(err[-1]) if err and err[-1].startswith("[") else None
    return proc.returncode, line, modules, proc.stderr

MESH_CELL = "p3d4-amrr8-mesh4"


def mesh_root(tmp) -> Path:
    """A checkout root for the four-rank cell, whose files the benchmark
    holds while its entries wait for its runs on four cards: BENCHMARK.json
    with the entries of ``mesh_cell.json`` added, and the data of
    ``perfbench/`` beside it."""
    import shutil

    tmp = Path(tmp)
    for sub in ("configs", "traffic", "checks", "metrics"):
        shutil.copytree(ROOT / "perfbench" / sub, tmp / "perfbench" / sub)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    mesh = json.loads(Path(__file__).with_name("mesh_cell.json").read_text())
    spec["configs"].append(mesh["config"])
    spec["workloads"].append(mesh["workload"])
    spec["per_layer"] += mesh["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in mesh["also_in"]:
            m["workloads"].append(MESH_CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
