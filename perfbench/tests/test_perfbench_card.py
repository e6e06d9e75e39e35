"""The benchmark's command on a card and without one.  The test that needs
the card is marked ``cuda`` and decides in its fixture, never at import."""

import json
import shutil
import subprocess
import sys

import pytest

from perfbench.tests._runner import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with: python -m pytest perfbench/tests -m cuda")


def _command(cwd, *args):
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=1200)


@pytest.mark.cuda
def test_cell_on_card(card):
    out = _command(ROOT, "--workload", "p2d-mrr-1rhs", "--seed", "4000000007", "--seconds", "2", "--trace", "1")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _command(ROOT, "--workload", "p2d-mrr-1rhs", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    has no program to run: no result, and a nonzero exit."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "perfbench.tests.cpu_cell", "--workload", "p2d-mrr-1rhs",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "krylov_tpu_torch" in out.stderr
