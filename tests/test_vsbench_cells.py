"""vsbench/tests/test_vsbench_cells.py, collected with the repository's tests so
that the harness which measures the port is tested where the port is."""
import subprocess
import sys

from vsbench.tests import test_vsbench_cells as cells
from vsbench.tests.test_vsbench_cells import *  # noqa: F401,F403

# tests/conftest.py loads JAX into every test process, and harness.finish
# refuses to print a result in a process that has loaded JAX: this test runs
# in an interpreter of its own, outside tests/conftest.py
del test_finish_prints_checks_last  # noqa: F821


def test_finish_prints_checks_last():
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         f"{cells.__file__}::test_finish_prints_checks_last"],
        cwd=cells.tiny.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and "1 passed" in p.stdout, p.stdout[-3000:] + p.stderr[-3000:]
