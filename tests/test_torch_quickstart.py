"""The port's quickstart (vectorsearch_tpu_torch/examples/quickstart.py)
runs on the CPU and prints what examples/quickstart.py prints on the JAX
package: the same document ids, hits, categories and chat reply (the noop
embedder is deterministic; similarities within torch_parity's tolerance)."""
import os
import re
import runpy

from vectorsearch_tpu_torch.examples import quickstart
from torch_parity import ATOL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIT = re.compile(r"^  #(\d+) '(\w+)' sim=([-\d.]+) ->")


def lines(out):
    return [ln for ln in out.splitlines() if not ln.startswith("stats:")]


def test_quickstart_matches_the_jax_one(monkeypatch, capsys):
    monkeypatch.setenv("VSTPU_DEVICE", "cpu")
    quickstart.main()
    port = lines(capsys.readouterr().out)
    runpy.run_path(os.path.join(ROOT, "examples", "quickstart.py"), run_name="jax_quickstart")[
        "main"]()
    jax = lines(capsys.readouterr().out)
    assert port[0] == "engine device: cpu"
    port = port[1:]
    assert len(port) == len(jax) == 5
    for ours, theirs in zip(port, jax):
        m, n = HIT.match(ours), HIT.match(theirs)
        if m:
            assert m.groups()[:2] == n.groups()[:2]
            assert abs(float(m.group(3)) - float(n.group(3))) <= max(ATOL, 1e-4)
        else:
            assert ours == theirs
