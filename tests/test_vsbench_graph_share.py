"""vsbench/tests/test_vsbench_graph_share.py, collected with the repository's tests so
that the harness which measures the port is tested where the port is."""
from vsbench.tests.test_vsbench_graph_share import *  # noqa: F401,F403
