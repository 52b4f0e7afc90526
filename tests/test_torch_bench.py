"""The port's bench harness (vectorsearch_tpu_torch/bench.py, bench_build.py,
tools/batch_sweep.py) beside the JAX side's (bench.py, bench_build.py,
tools/r5_batch_sweep.py) on the CPU at N=4,000 rows, D=64, K=16, 64
queries, 2 rounds and the bulk batches 2048 and 1024.

Held: make_corpus, setup()'s packed rows and queries bit-equal, its truth
the same id sets but at ties, the cache round trip; the headline line byte
for byte for the same state; bulk_plan with its repair of bench.py's
custom-NPROBE plan; measure's recall on the JAX build's centroids against
the JAX _scan_refined's; both mains' labels, recalls and last line;
bench_build's corpus bit-equal and its JSON line; batch_sweep's query pool
bit-equal to r5_batch_sweep's, its recall at each point's shape; the deadline
watchdog of `python -m vectorsearch_tpu_torch.bench`; NoDeviceError without
a card. The JAX scripts are loaded as fresh modules with their constants
set (bench_build.py from a copy in tmp_path, so that its cache lands
there); every cache lives in tmp_path, and the JAX config, sys.path and
sys.modules entries the scripts change are put back."""
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorsearch_tpu.index.ivf as jax_ivf_mod
from vectorsearch_tpu.build import build_centroids as jax_build_centroids
from vectorsearch_tpu.index import IVFIndex as JaxIVF
from vectorsearch_tpu_torch import bench, bench_build
from vectorsearch_tpu_torch.device import DEVICE_ENV, NoDeviceError
from vectorsearch_tpu_torch.index import IVFIndex
from vectorsearch_tpu_torch.tools import batch_sweep
from vectorsearch_tpu_torch.tools.scale_corpus import sets_differ

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N, DIM, K, NQ, ROUNDS = 4_000, 64, 16, 64, 2
BULK = [2048, 1024]
FIELDS = ("codes", "scale", "offset", "inv_norm")
# one hit of one query: the recall step of NQ queries at k=10
ONE_HIT = 1.0 / (10 * NQ)
# the IVF rows of the two mains come from each package's own k-means build
MAIN_RECALL_TOL = 0.05
TIE = 1e-6  # f64 cosine gap counted as a tie in the truth
ROW = re.compile(r"bench: (.+) recall@10=([\d.]+) qps/chip=(\d+) \(batch (\d+)\)")
BULK_ROW = re.compile(r"bench: (ivf\+refine nprobe=\d+) B=(\d+) \(bulk\) qps/chip=(\d+)")


def load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def jax_scripts_side_effects():
    """The JAX scripts set the JAX compile cache (enable_compile_cache),
    jax_platforms (bench.py's VSTPU_BENCH_CPU) and extend sys.path and
    sys.modules (r5_batch_sweep.py, ivf_perf_probe.py); put them back for
    the test files that follow in this process."""
    names = ("jax_platforms", "jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    path, modules = list(sys.path), set(sys.modules)
    yield
    for n, v in saved.items():
        jax.config.update(n, v)
    sys.path[:] = path
    if "ivf_perf_probe" not in modules:
        sys.modules.pop("ivf_perf_probe", None)


@pytest.fixture
def port(monkeypatch, tmp_path):
    """The port's bench at the test's sizes on the CPU, its cache in tmp_path."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    monkeypatch.delenv("VSTPU_BENCH_CPU", raising=False)
    torch.set_num_threads(2)
    for name, v in (("N", N), ("DIM", DIM), ("K_CLUSTERS", K), ("N_QUERIES", NQ),
                    ("ROUNDS", ROUNDS), ("FLAT_BATCH", NQ), ("BULK_BATCH", BULK),
                    ("CACHE", str(tmp_path / "port-setup.npz"))):
        monkeypatch.setattr(bench, name, v)
    monkeypatch.setattr(bench, "_state", {"results": [], "build_s": None, "phase": "init",
                                          "emitted": None})
    return bench


@pytest.fixture
def jax_bench(monkeypatch, tmp_path):
    """bench.py as a fresh module at the same sizes, its cache in tmp_path;
    the variables its main() reads at call time set to the same values."""
    mod = load(os.path.join(ROOT, "bench.py"), "jax_bench_script")
    for name, v in (("N", N), ("DIM", DIM), ("K_CLUSTERS", K), ("N_QUERIES", NQ),
                    ("CACHE", str(tmp_path / "jax-setup.npz"))):
        setattr(mod, name, v)
    mod.enable_compile_cache = mod.warm_device_transfer = lambda: None
    for name, v in (("VSTPU_BENCH_CPU", "1"), ("VSTPU_BENCH_ROUNDS", str(ROUNDS)),
                    ("VSTPU_BENCH_FLAT_BATCH", str(NQ)),
                    ("VSTPU_BENCH_BULK_BATCH", ",".join(map(str, BULK)))):
        monkeypatch.setenv(name, v)
    return mod


@pytest.fixture
def setups(port, jax_bench):
    """Both setups from scratch, and the port's again from its cache."""
    fresh = port.setup(CPU)
    cached = port.setup(CPU)
    return fresh, cached, jax_bench.setup()


def test_make_corpus_bit_equal_to_bench_py(jax_bench):
    for shape in ((N, DIM, K), (150_001, 8, 5)):  # one 100,000-row noise chunk and more
        np.testing.assert_array_equal(bench.make_corpus(*shape), jax_bench.make_corpus(*shape))


def test_setup_matches_bench_py(setups):
    """Packed rows and queries bit-equal; the truth the same id sets but at
    a tie within TIE of the tenth f64 cosine; the cache gives the same
    arrays back under a file name of the port's own."""
    (packed, queries, truth), cached, (jpacked, jqueries, jtruth) = setups
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(packed, f), np.asarray(getattr(jpacked, f)), f)
    np.testing.assert_array_equal(queries, jqueries)
    data = bench.make_corpus(N, DIM, K).astype(np.float64)
    sims = (queries / np.linalg.norm(queries, axis=1, keepdims=True)) @ (
        data / np.linalg.norm(data, axis=1, keepdims=True)).T
    score = lambda ids: np.take_along_axis(sims, ids, 1)  # noqa: E731
    assert truth.shape == (NQ, bench.TOPK) and truth.dtype == np.int64
    assert sets_differ(score(truth), truth, score(jtruth), jtruth, TIE) == 0
    for got, want in zip((*cached[0], *cached[1:]), (*packed, queries, truth)):
        np.testing.assert_array_equal(got, want)


def test_cache_name_is_the_ports_own():
    """The default cache sits under the checkout's .cache/ like bench.py's,
    keyed alike, under a name bench.py never reads."""
    name = f"torch-bench-setup-{bench.N}x{bench.DIM}-k{bench.K_CLUSTERS}-q{bench.N_QUERIES}.npz"
    assert os.path.basename(bench.CACHE) == name
    if not os.environ.get("VSTPU_BENCH_CACHE"):
        assert os.path.dirname(bench.CACHE) == os.path.join(ROOT, ".cache")
    assert os.path.basename(bench_build.CACHE).startswith("torch-build-corpus-")


HEADLINE_STATES = {
    "empty": ([], None, "setup:corpus"),
    "partial": ([("ivf+refine nprobe=1", 123456.78, 0.9453),
                 ("ivf+refine nprobe=2", 99999.95, 0.9672)], 12.3, "measure:bulk"),
    "done": ([("ivf+refine nprobe=1", 123456.78, 0.9453),
              ("ivf+refine nprobe=2 B=65536 (bulk)", 400123.4, 0.9672),
              ("flat+refine B=512", 1234.5, 0.97)], 3.6, "done"),
    "no build seconds": ([("ivf+refine nprobe=8", 5000.0, 0.96)], 0.0, "done"),
    "below the floor": ([("ivf+refine nprobe=1", 7.25, 0.5)], None, "done"),
}


@pytest.mark.parametrize("case", sorted(HEADLINE_STATES))
def test_headline_line_byte_identical(jax_bench, monkeypatch, case):
    results, build_s, phase = HEADLINE_STATES[case]
    t0 = time.monotonic() - 100.2  # the empty form prints the whole seconds since start
    lines = []
    for mod in (bench, jax_bench):
        monkeypatch.setattr(mod, "_state", {"results": list(results), "build_s": build_s,
                                            "phase": phase, "emitted": None})
        for name, v in (("N", N), ("DIM", DIM), ("_T0", t0)):
            monkeypatch.setattr(mod, name, v)
        lines.append(mod._headline_line())
    assert lines[0] == lines[1]
    assert set(json.loads(lines[0])) == {"metric", "value", "unit", "vs_baseline"}


@pytest.mark.parametrize("nprobe_env, n, base, want", [
    # bench.py's default plan, as the TPU ran it: four base points at nprobe 1 and 2
    (8, 1_000_000, [65536, 16384], {1: [65536, 16384], 2: [65536, 16384], 8: [8192, 4096],
                                    64: [2048, 1024]}),
    # ADVICE r5 (a): bench.py gives a custom NPROBE of 64 nprobe 8's list;
    # here 64 keeps [2048, 1024] whatever NPROBE is
    (64, 1_000_000, [65536, 16384], {1: [65536, 16384], 2: [65536, 16384],
                                     64: [2048, 1024]}),
    (4, 1_000_000, [65536, 16384], {1: [65536, 16384], 2: [65536, 16384], 4: [8192, 4096],
                                    64: [2048, 1024]}),
    (16, 1_000_000, [16384, 65536], {1: [65536, 16384], 2: [65536, 16384], 16: [2048, 1024],
                                     64: [2048, 1024]}),
    # every batch cut to b <= n; no base batch left turns the bulk points off
    (8, 4_000, BULK, {1: BULK, 2: BULK, 8: [], 64: BULK}),
    (8, 4_000, [65536, 16384], {}),
    (8, 1_000_000, [], {}),
])
def test_bulk_plan(monkeypatch, nprobe_env, n, base, want):
    monkeypatch.setattr(bench, "BULK_BATCH", base)
    nprobes = list(dict.fromkeys((1, 2, nprobe_env, 64)))
    assert bench.bulk_plan(nprobes, n) == want


@pytest.fixture
def jax_build(setups):
    """bench.py's k-means build on the JAX package, over bench.py's setup."""
    _, _, (jpacked, queries, truth) = setups
    packed = type(setups[0][0])(*(np.asarray(a) for a in jpacked))
    res = jax_build_centroids(jpacked, k=K, min_cluster_size=max(1, (N // K) // 10),
                              max_iters=10, superset_iters=4, chunk=65_536)
    centroids, assignments = np.asarray(res.centroids), np.asarray(res.assignments)
    ids = np.arange(1, N + 1, dtype=np.int64)
    return packed, queries, ids[truth], ids, centroids, assignments


def jax_recall(jivf, queries, truth_ids, nprobe):
    """bench.py's measure() recall through the JAX _scan_refined (XLA on the CPU)."""
    flat_ids = jivf.ids.reshape(-1)
    got = np.empty((len(queries), bench.TOPK), np.int64)
    for i in range(0, len(queries), 512):
        _, idx = jax_ivf_mod._scan_refined(
            jnp.asarray(queries[i : i + 512]), jivf.centroids_n, jivf.buckets,
            jivf.counts_dev, jivf.bucket_mask, nprobe=nprobe, k_coarse=32, k=bench.TOPK,
            use_pallas=False)
        got[i : i + 512] = flat_ids[np.clip(np.asarray(idx), 0, flat_ids.size - 1)]
    return float(np.mean([len(set(got[i]) & set(truth_ids[i])) / bench.TOPK
                          for i in range(len(queries))]))


@pytest.mark.parametrize("nprobe", [1, 2, 8])
def test_measure_recall_matches_jax_scan_refined(jax_build, port, nprobe):
    """measure() through the port's _scan_refined on the JAX build's
    centroids gives the JAX _scan_refined's recall, within one hit."""
    packed, queries, truth_ids, ids, centroids, assignments = jax_build
    ivf = IVFIndex.build(packed, ids, centroids, assignments=assignments, device="cpu")
    jivf = JaxIVF.build(packed, ids, centroids, assignments=assignments)
    qps, recall = port.measure(f"ivf+refine nprobe={nprobe}", port.ivf_search(ivf, nprobe),
                               NQ, port.slot_ids(ivf), queries, truth_ids, CPU)
    assert qps > 0
    assert abs(recall - jax_recall(jivf, queries, truth_ids, nprobe)) <= ONE_HIT + 1e-12
    assert port._state["results"][-1] == (f"ivf+refine nprobe={nprobe}", qps, recall)


def rows(err):
    """{label: recall} of a bench log; the bulk rows' recall is reused."""
    out = {m[1]: float(m[2]) for m in ROW.finditer(err)}
    for m in BULK_ROW.finditer(err):
        out[f"{m[1]} B={m[2]} (bulk)"] = out[m[1]]
    return out


def wide(label):
    """The label with a probe wider than NPROBE named `wide`: each
    package's own build settles on its own K, and nprobe 64 is clamped to K."""
    return re.sub(r"nprobe=(\d+)", lambda m: "nprobe=wide" if int(m[1]) > 8 else m[0], label)


def test_both_mains(jax_bench, port, capsys):
    """Both mains at the test's sizes: the same labels but the widest
    probe's bulk points (bench.py looks them up under nprobe=64, which K=16
    clamps away); recall per row within MAIN_RECALL_TOL (each main builds
    its own centroids), flat+refine within one hit; a last line with the
    contract's keys and no partial mark; the launch line before HEADLINE."""
    jax_bench.main()
    jout, jerr = capsys.readouterr()
    assert port.main() == 0
    out, err = capsys.readouterr()
    got, want = rows(err), rows(jerr)
    extra = {wide(k) for k in got} - {wide(k) for k in want}
    assert extra == {f"ivf+refine nprobe=wide B={b} (bulk)" for b in BULK}, extra
    assert {wide(k) for k in want} <= {wide(k) for k in got}
    for k in got.keys() & want.keys():
        tol = ONE_HIT + 1e-4 if k.startswith("flat") else MAIN_RECALL_TOL
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    for text in (out, jout):
        line = json.loads(text.strip().splitlines()[-1])
        assert set(line) == {"metric", "value", "unit", "vs_baseline"}
        assert "partial" not in line["metric"] and line["value"] > 0
    tail = err.strip().splitlines()
    launch = next(i for i, s in enumerate(tail) if "bench: kernel launches" in s)
    assert "HEADLINE" in tail[launch + 1]
    counts = json.loads(tail[launch].split("kernel launches ", 1)[1])
    assert counts == {"grouped_scores": 0, "kmeans_assign": 0, "kmeans_accumulate": 0}


def test_bench_build_corpus_and_line(monkeypatch, tmp_path, capsys):
    """bench_build.py from a copy in tmp_path (its cache then lands there)
    and the port's main() at N rows: the packed corpus bit-equal, and
    JSON lines with the same keys and unit."""
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    for name, v in (("N", N), ("DIM", DIM), ("K", K), ("ITERS", 2)):
        monkeypatch.setenv(f"VSTPU_BUILD_{name}", str(v))
        monkeypatch.setattr(bench_build, name, v)
    monkeypatch.setattr(bench_build, "CACHE", str(tmp_path / "port-build.npz"))
    shutil.copy(os.path.join(ROOT, "bench_build.py"), tmp_path / "bench_build.py")
    load(str(tmp_path / "bench_build.py"), "jax_bench_build_script").main()
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert bench_build.main() == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == set(jline) == {"metric", "value", "unit"}
    assert line["unit"] == jline["unit"] == "s"
    assert line["metric"].startswith(f"k-means build {N}x{DIM} -> ")
    assert re.search(r"max/mean cluster \d+/\d+", err)
    with np.load(tmp_path / ".cache" / f"build-corpus-{N}.npz") as z, \
            np.load(bench_build.CACHE) as mine:
        for f in FIELDS:
            np.testing.assert_array_equal(mine[f], z[f], f)
    # the cache round trip
    for got, want in zip(bench_build.corpus(), bench_build.make_packed(N, DIM, K)):
        np.testing.assert_array_equal(got, want)


def test_batch_sweep_matches_r5(jax_build, monkeypatch, capsys):
    """tools/r5_batch_sweep.py's main() on the JAX build (its setup
    replaced by the same arrays) beside the port's sweep() on those
    centroids: the query pool of the widest batch bit-equal (read from the
    queries the JAX _scan_refined was called with), the port's recall at
    each (nprobe, B) within one hit of r5's recall at that nprobe, and a
    row per (nprobe, B)."""
    packed, queries, truth_ids, ids, centroids, assignments = jax_build
    batches, nprobes = (256, 512), (1, 2)
    monkeypatch.setenv("VSTPU_SWEEP_BATCHES", ",".join(map(str, batches)))
    monkeypatch.setenv("VSTPU_SWEEP_NPROBES", ",".join(map(str, nprobes)))
    monkeypatch.setenv("VSTPU_SWEEP_ROUNDS", "1")
    r5 = load(os.path.join(ROOT, "tools", "r5_batch_sweep.py"), "jax_r5_batch_sweep")
    arrays = dict(zip(FIELDS, packed), centroids=centroids, assignments=assignments,
                  queries=queries, truth=truth_ids - 1)
    monkeypatch.setattr(r5, "setup", lambda: arrays)
    monkeypatch.setattr(r5, "N", N)
    monkeypatch.setattr(r5, "DIM", DIM)
    seen = []
    real = jax_ivf_mod._scan_refined

    def recording(q, *args, **kw):
        seen.append(np.asarray(q))
        return real(q, *args, **kw)

    monkeypatch.setattr(jax_ivf_mod, "_scan_refined", recording)
    r5.main()
    jerr = capsys.readouterr().err
    pool = next(q for q in seen if q.shape[0] == max(batches))
    np.testing.assert_array_equal(bench.query_pool(packed, max(batches)), pool)

    ivf = IVFIndex.build(packed, ids, centroids, assignments=assignments, device="cpu")
    for name, v in (("BATCHES", batches), ("NPROBES", nprobes), ("ROUNDS", 1)):
        monkeypatch.setattr(batch_sweep, name, v)
    got = batch_sweep.sweep(ivf, packed, queries, truth_ids, CPU)
    assert [(r["nprobe"], r["batch"]) for r in got] == [(p, b) for p in nprobes for b in batches]
    want = {int(m[1]): float(m[2])
            for m in re.finditer(r"batchsweep: nprobe=(\d+) recall@10=([\d.]+)", jerr)}
    for r in got:
        assert abs(r["recall"] - want[r["nprobe"]]) <= ONE_HIT + 5e-5, (r, want)
        assert r["qps"] > 0 and r["ms"] == pytest.approx(1e3 * r["batch"] / r["qps"])


@pytest.mark.parametrize("nq, batch", [(5, 4), (5, 8), (8, 4)])
def test_batch_sweep_recall_at_the_timed_shape(nq, batch):
    """recall_at searches the queries in calls of exactly `batch` rows, the
    last call filled up with pool rows, and scores the queries' rows only."""
    shapes = []

    def fn(q):
        shapes.append(q.shape[0])
        return torch.zeros(q.shape[0], 10), q.long()

    queries = np.arange(nq * 10, dtype=np.float32).reshape(nq, 10)
    pool = np.full((batch, 10), -1, np.float32)
    truth = queries.astype(np.int64)
    truth[0, :5] = -7  # half of query 0's ten found
    got = batch_sweep.recall_at(fn, queries, truth, lambda idx: idx, pool, batch, CPU)
    assert shapes == [batch] * -(-nq // batch)
    assert got == pytest.approx(1.0 - 0.5 / nq)


def test_batch_sweep_main(port, monkeypatch, capsys):
    """main(): bench's setup and build at the test's sizes, the sweep at
    the module's batches, widths and rounds, one JSON line."""
    for name, v in (("BATCHES", (128,)), ("NPROBES", (1, 2)), ("ROUNDS", 1)):
        monkeypatch.setattr(batch_sweep, name, v)
    assert batch_sweep.main() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["tool"], line["n"], line["dim"], line["device"]) == ("batch_sweep", N, DIM,
                                                                       "cpu")
    assert [(r["nprobe"], r["batch"]) for r in line["rows"]] == [(1, 128), (2, 128)]


def test_deadline_prints_a_line_and_exits_0(tmp_path):
    """`python -m vectorsearch_tpu_torch.bench` at a size that outlasts a 2 s
    deadline: exit 0, the watchdog's reason on stderr, and a last line with
    the contract's keys that says the run was cut."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2", VSTPU_DEVICE="cpu",
               VSTPU_BENCH_DEADLINE="2", VSTPU_BENCH_CACHE=str(tmp_path),
               VSTPU_BENCH_N="200000", VSTPU_BENCH_DIM="64", VSTPU_BENCH_K="64")
    env.pop("VSTPU_BENCH_CPU", None)
    out = subprocess.run([sys.executable, "-m", "vectorsearch_tpu_torch.bench"],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "deadline 2s expired" in out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert "NO MEASUREMENT COMPLETED" in line["metric"] or "[partial: " in line["metric"]


@pytest.mark.parametrize("main", [bench.main, bench_build.main, batch_sweep.main],
                         ids=["bench", "bench_build", "batch_sweep"])
def test_entries_refuse_without_a_card(monkeypatch, main):
    """No card, no VSTPU_DEVICE and no VSTPU_BENCH_CPU: NoDeviceError before
    any work (never a silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    monkeypatch.delenv(DEVICE_ENV, raising=False)
    monkeypatch.delenv("VSTPU_BENCH_CPU", raising=False)
    monkeypatch.setattr(bench, "_state", {"results": [], "build_s": None, "phase": "init",
                                          "emitted": None})
    with pytest.raises(NoDeviceError, match="no CUDA card"):
        main()
