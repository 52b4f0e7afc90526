"""A later change adds a configuration, a traffic mix and a metric as new
files and entries, and the harness runs them without an edit to any file
it already has."""
import json
import shutil

from vsbench.tests import tiny

METRIC = '''"""Queries a library call answered (a throwaway reader)."""


def read(r):
    calls = r.outcome.layer.get("calls")
    return None if not calls else r.outcome.attempted / calls
'''


def test_new_files_only(tmp_path):
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.ROOT / "vsbench", tmp_path / "vsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    v = tmp_path / "vsbench"
    cfg = json.loads((v / "configs" / "vdbb-768d10m-lib.json").read_text())
    cfg.update(name="throwaway-cfg", rows=4000, dim=32, clusters=12)
    cfg["corpus"]["center_scale"] = 3.0
    (v / "configs" / "throwaway-cfg.json").write_text(json.dumps(cfg))
    traffic = json.loads((v / "traffic" / "lib-b512-np8.json").read_text())
    traffic.update(batch=16, query_pool=64, nprobe=3, refine=16, sample_calls=1)
    (v / "traffic" / "throwaway-mix.json").write_text(json.dumps(traffic))
    (v / "metrics" / "throwaway.queries_per_call.py").write_text(METRIC)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway-cfg", "source": "https://example.org/throwaway",
                            "file": "vsbench/configs/throwaway-cfg.json", "reduced": [],
                            "why": "a throwaway"})
    spec["workloads"].append({"name": "throwaway-cell", "config": "throwaway-cfg",
                              "traffic": "throwaway-mix", "chips": 1, "why": "a throwaway"})
    spec["per_layer"].append({"name": "throwaway.queries_per_call", "unit": "queries",
                              "better": "higher", "source": "host_clock", "layer": "harness",
                              "moves": "search_qps", "workloads": ["throwaway-cell"]})
    for m in spec["end_to_end"]:
        if m["name"] == "search_qps":
            m["workloads"].append("throwaway-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    changed = [p for p, b in before.items() if p.read_bytes() != b]
    assert changed == [tmp_path / "BENCHMARK.json"]

    from vsbench import harness
    import torch

    for trace in (False, True):
        c = harness.load_cell("throwaway-cell", 7, 1, trace, torch.device("cpu"), tmp_path)
        result, check, _ = tiny.run(c)
        assert result["correct"], check
        if trace:
            assert result["metrics"]["throwaway.queries_per_call"]["value"] == 16
        else:
            assert set(result["metrics"]) == {"search_qps", "setup_s"}
