"""The port's build progress tracker (vectorsearch_tpu_torch/build/progress.py,
reference dnc/dnc.go:81-90): the 8 scenarios of tests/test_progress.py,
each run on the port's tracker and on the JAX package's. The snapshots
must agree in everything but their wall times (phase names, details,
category, rows, which phases are done or open, whether an ETA is given)."""
import time

import vectorsearch_tpu.build.progress as jax_progress
import vectorsearch_tpu_torch.build.progress as port_progress

MODULES = (port_progress, jax_progress)
TIMED = ("phase_elapsed_s", "phase_eta_s", "elapsed_s", "s")


def shape(snap):
    """A snapshot with its wall times reduced to their presence."""
    if isinstance(snap, dict):
        return {k: (k in TIMED) or shape(v) for k, v in snap.items()}
    if isinstance(snap, list):
        return [shape(v) for v in snap]
    return snap


def both(scenario):
    port, jax = (scenario(m) for m in MODULES)
    assert port == jax, (port, jax)
    return port


def test_idle_snapshot_is_none():
    assert both(lambda mod: mod.BuildProgress().snapshot()) is None


def test_phase_lifecycle_and_history():
    def scenario(mod):
        t = mod.BuildProgress()
        t.begin(1_000_000, category=3)
        with t.phase("upload", "tiles"):
            inside = t.snapshot()
            assert inside["phase_elapsed_s"] >= 0
        with t.phase("lloyd"):
            pass
        done = t.snapshot()
        t.end()
        return shape(inside), shape(done), t.snapshot()

    inside, done, after = both(scenario)
    assert (inside["phase"], inside["detail"], inside["category"], inside["rows"]) == (
        "upload", "tiles", 3, 1_000_000)
    assert [p["phase"] for p in done["phases_done"]] == ["upload", "lloyd"]
    assert "phase" not in done and after is None


def test_eta_appears_on_second_build_of_same_scale():
    def scenario(mod):
        t = mod.BuildProgress()
        t.begin(500_000)
        with t.phase("lloyd"):
            time.sleep(0.05)
        t.end()
        t.begin(600_000)  # the same order of magnitude: the same EWMA bucket
        with t.phase("lloyd"):
            snap = t.snapshot()
            assert snap["phase_eta_s"] >= 0
        t.end()
        t.begin(5_000)  # another scale bucket: no ETA
        with t.phase("lloyd"):
            other = t.snapshot()
        t.end()
        return "phase_eta_s" in snap, "phase_eta_s" in other

    assert both(scenario) == (True, False)


def test_nested_phases_are_noops():
    def scenario(mod):
        t = mod.BuildProgress()
        t.begin(1000)
        with t.phase("balance", "round 1"):
            with t.phase("lloyd"):  # nested: ignored
                inner = t.snapshot()["phase"]
            outer = t.snapshot()["phase"]
        done = [p["phase"] for p in t.snapshot()["phases_done"]]
        t.end()
        return inner, outer, done

    assert both(scenario) == ("balance", "balance", ["balance"])


def test_phase_without_begin_still_tracks():
    def scenario(mod):
        t = mod.BuildProgress()
        with t.phase("superset"):
            return t.snapshot()["phase"]

    assert both(scenario) == "superset"


def test_exception_inside_phase_still_closes_it():
    def scenario(mod):
        t = mod.BuildProgress()
        t.begin(100)
        try:
            with t.phase("upload"):
                raise RuntimeError("boom")
        except RuntimeError:
            pass
        snap = t.snapshot()
        t.end()
        return "phase" in snap, snap["phases_done"][0]["phase"]

    assert both(scenario) == (False, "upload")


def test_scale_bucket():
    def scenario(mod):
        return [mod._scale_bucket(n) for n in (0, 1_000_000, 9_999_999, 10_000_000)]

    assert both(scenario) == [0, 6, 6, 7]


def test_engine_stats_exposes_build_key():
    """The module singleton is what the port's engine reads into its
    stats' "build" key; idle -> None."""
    from vectorsearch_tpu_torch.engine import Engine
    from vectorsearch_tpu_torch.host import NoopAI, Store

    snap = port_progress.tracker.snapshot()
    assert snap is None or isinstance(snap, dict)
    store = Store(":memory:")
    eng = Engine(store, NoopAI(seed=0), device="cpu")
    assert eng.stats()["build"] == port_progress.tracker.snapshot()
    eng.close()
    store.close()
