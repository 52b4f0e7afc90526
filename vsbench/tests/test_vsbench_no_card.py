"""Without a card the benchmark refuses: a non-zero exit and no result."""
import shutil
import subprocess
import sys

from vsbench.tests.tiny import ROOT


def _run(cwd):
    return subprocess.run(
        [sys.executable, "-m", "vsbench.run", "--workload", "d10m-lib-b512-np8",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "vsbench", tmp_path / "vsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
