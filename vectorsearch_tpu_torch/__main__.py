"""Process entry point of the port (counterpart of main.py).

    python -m vectorsearch_tpu_torch [config.json]

It reads main.py's config file. Boot order as there: config (a sample is
written on first run), logger, AI providers (VSTPU_NOOP_AI=1 takes the
deterministic fake), the device, store, preftest, the engine, a startup
thread that builds the kernels and rebuilds every category's centroids,
the store-sync loop, the HTTP and HTTPS/h2 listeners, and a graceful
shutdown on SIGINT/SIGTERM.

The device is the CUDA card, or what VSTPU_DEVICE asks for (`cpu`, `cuda`,
`cuda:N`). With no card and no such ask the entry prints one line that
names the variable and exits non-zero before it opens the store: it never
carries on on the CPU because it found no GPU.

The config's `mesh` section (main.py:192-222): with `mesh.coordinator`
the process joins the process group (parallel/distributed.py) before its
first device use; with `mesh.shard_serving` the engine gets
`global_mesh(mesh.devices or None)`: this process's first `devices` cards
(all for 0), or that many CPU shards (1 for 0) when the CPU is asked for,
joined to the other ranks by the group. Rebuilds then run on the mesh and
install a sharded read replica that searches use until the next write.
Sharded serving over several processes is refused (exit 2): each process
answers its own HTTP requests, while every sharded search and rebuild is
a collective that all ranks must enter in the same order.

With VSTPU_TRACE_DIR=<dir> the entry serves inside a torch profiler
(utils/profiling.device_trace): the program's spans and counters record,
/api/stats shows them under "trace", and a Chrome trace of the whole
session (host ops and spans of every thread, the card's kernels) is
written into <dir> at shutdown. The trace grows with the session: this
is for a bounded debugging session.
"""
from __future__ import annotations

import asyncio
import contextlib
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from . import config as config_mod
from .api import TLSManager, build_app
from .api.http import HTTPServer
from .device import DEVICE_ENV, NoDeviceError, resolve, to_device
from .embed import AI
from .engine import Engine
from .kernels import cosine
from .logger import configure, sugar
from .parallel.distributed import global_mesh, maybe_initialize
from .quant import codec, layout
from .store import Store
from .utils import device_trace

NO_CARD = (
    "no CUDA card ({asked}): vectorsearch_tpu_torch serves on an NVIDIA GPU; "
    "set VSTPU_DEVICE=cpu to serve on the CPU"
)
TRACE_ENV = "VSTPU_TRACE_DIR"
MESH_ACROSS_PROCESSES = (
    "mesh.shard_serving with mesh.num_processes {n} is not supported: each "
    "process answers its own requests, and a sharded search is a collective "
    "that every rank must enter together; serve sharded from one process "
    "(num_processes 1) over its local cards"
)


def preftest(device: torch.device) -> None:
    """Startup micro-benchmark (reference: main.go:247-286): times the
    matrix cosine scores and quantize/dequantize round trips, logging wall
    times as a smoke/perf check."""
    rng = np.random.default_rng(0)
    packed = layout.pack_float(rng.normal(size=(500, 512)).astype(np.float32))
    corpus = layout.PackedVectors(*[to_device(a, device) for a in packed])
    q = to_device(rng.normal(size=(500, 512)).astype(np.float32), device)
    t0 = time.perf_counter()
    for _ in range(10):
        cosine.scores_packed(q, corpus)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sugar().info(
        "preftest matrix cosine 500x500@512 x10: %.1fms",
        (time.perf_counter() - t0) * 1e3,
    )

    big = rng.normal(size=(1000, 512)).astype(np.float32)
    t0 = time.perf_counter()
    for _ in range(50):
        wire = codec.quantize(big)
    sugar().info("preftest quantize 1000x512 x50: %.1fms", (time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(50):
        codec.dequantize(wire)
    sugar().info("preftest dequantize 1000x512 x50: %.1fms", (time.perf_counter() - t0) * 1e3)


def build_store(cfg: config_mod.Config):
    """Store selection (reference: database/database.go:25-103).

    Priority: postgres DSNs (primary + strict-round-robin read replicas)
    > database.remote (another instance's store server) > local SQLite."""
    if cfg.database.postgres:
        from .store.pg import PgStore

        store = PgStore(
            list(cfg.database.postgres), list(cfg.database.postgres_readonly)
        )
        sugar().info(
            "using postgres primary (+%d write failover DSNs, "
            "%d read replicas)",
            len(cfg.database.postgres) - 1,
            len(cfg.database.postgres_readonly),
        )
        return store
    if cfg.database.remote:
        from .store.remote import RemoteStore

        store = RemoteStore(cfg.database.remote, token=cfg.database.store_token)
        sugar().info("using remote store %s", cfg.database.remote)
        return store
    return Store(cfg.database.sqlite)


def _addr(spec: str) -> tuple[str | None, int]:
    """Parse ':7500', 'host:7500', or '[::1]:7500' address specs."""
    host, sep, port = spec.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(
            f"invalid listen address {spec!r}: expected [host]:port"
        )
    host = host.strip("[]")  # bracketed IPv6
    return (host or None), int(port)


def _serve_store(cfg: config_mod.Config, store):
    """database.serve_store: export this instance's SQLite store to other
    hosts (store/remote.py). Returns the StoreServer, or None."""
    if not isinstance(store, Store):
        # serving while mounted on a remote/postgres store would export a
        # fresh empty sqlite file, diverging from the store in use
        sugar().error(
            "database.serve_store ignored: this instance's store is "
            "%s, not a local sqlite file; other hosts should share "
            "that store directly", type(store).__name__,
        )
        return None
    from .store.remote import StoreServer

    host, port = _addr(cfg.database.serve_store)
    server = StoreServer(
        store, host or "0.0.0.0", port, token=cfg.database.store_token
    ).start()
    if not cfg.database.store_token:
        sugar().warning(
            "store server has NO auth token (database.store_token): "
            "any peer that can reach the port can call every store "
            "method including deletes"
        )
    sugar().info("store server listening on %s", server.address)
    return server


async def serve(cfg: config_mod.Config, engine: Engine,
                stop: threading.Event | None = None) -> None:
    """Serve until SIGINT/SIGTERM (in the main thread) or `stop` is set."""
    http_host, http_port = _addr(cfg.server.http_address)
    server = await HTTPServer(build_app(engine)).start(http_host, http_port)

    tls = tls_mux = None
    if cfg.server.https_address:
        try:
            from .api.h2 import serve_tls_mux

            tls = TLSManager(cfg.tls)
            tls.start()
            https_host, https_port = _addr(cfg.server.https_address)
            # h2 + http/1.1 over one TLS port (reference main.go:104-115);
            # both ALPN branches reach the router via the plaintext listener
            tls_mux = await serve_tls_mux(
                https_host, https_port, tls.context(),
                (http_host or "127.0.0.1", server.port),
            )
        except Exception as e:
            sugar().error("HTTPS disabled: %s", e)
            if tls is not None:
                tls.close()  # stop the hourly reload thread start() spawned
            tls = None
    sugar().info(
        "listening on http %s%s",
        cfg.server.http_address,
        f" / https {cfg.server.https_address} (h2, http/1.1)" if tls else "",
    )

    done = asyncio.Event()
    if threading.current_thread() is threading.main_thread():
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, done.set)
    while not done.is_set() and not (stop is not None and stop.is_set()):
        try:
            await asyncio.wait_for(done.wait(), 0.1)
        except TimeoutError:
            pass
    sugar().info("shutting down")
    if tls_mux is not None:
        await tls_mux.close()
    await server.close()
    if tls:
        tls.close()


def run(cfg: config_mod.Config, ai=None, stop: threading.Event | None = None) -> int:
    """Boot the engine behind the HTTP API and serve until a signal or
    `stop`; returns the exit code. `ai` defaults to the config's providers
    (the deterministic fake with VSTPU_NOOP_AI=1)."""
    configure(cfg.log_level)
    if cfg.mesh.shard_serving and cfg.mesh.num_processes > 1:
        print(MESH_ACROSS_PROCESSES.format(n=cfg.mesh.num_processes), file=sys.stderr)
        return 2
    if ai is None:
        ai = AI.from_config(cfg, use_noop=os.environ.get("VSTPU_NOOP_AI") == "1")
    asked = os.environ.get(DEVICE_ENV)
    try:
        device = resolve(None)
    except NoDeviceError:
        device = None
    # the CPU serves only when asked for by name, and a card only when
    # there is one: the entry never carries on where it found no GPU
    if device is None or (device.type == "cuda" and not torch.cuda.is_available()):
        refusal = NO_CARD.format(asked=f"{DEVICE_ENV}={asked}" if asked else f"{DEVICE_ENV} unset")
        print(refusal, file=sys.stderr)
        return 3
    if cfg.mesh.coordinator:
        # join the process group before any device use
        maybe_initialize(
            cfg.mesh.coordinator, cfg.mesh.num_processes, cfg.mesh.process_id
        )
        sugar().info(
            "process group: rank %d of %d via %s",
            cfg.mesh.process_id, cfg.mesh.num_processes, cfg.mesh.coordinator,
        )
    sugar().info(
        "device %s (%s)", device,
        torch.cuda.get_device_name(device) if device.type == "cuda"
        else f"asked for with {DEVICE_ENV}",
    )
    mesh = None
    if cfg.mesh.shard_serving:
        mesh = global_mesh(cfg.mesh.devices or None)
        sugar().info(
            "sharded serving over %d shards (%d on this process, %d ranks)",
            mesh.size, mesh.n_local, mesh.world,
        )

    store = build_store(cfg)
    store_server = _serve_store(cfg, store) if cfg.database.serve_store else None
    engine = None
    stopping = threading.Event()
    workers = []
    try:
        preftest(device)
        engine = Engine(
            store, ai, snapshot_dir=cfg.database.snapshots, mesh=mesh, device=device,
            warm_nprobes=cfg.server.warm_nprobes,
        )

        # one-shot background work at startup (reference: main.go:92): the
        # kernel build and a warm search, then the centroid rebuild
        def _startup():
            engine.warmup()
            engine.refresh_centroids()

        workers.append(threading.Thread(target=_startup, name="vstpu-startup", daemon=True))

        if cfg.database.sync_interval > 0:
            # multi-instance deployments: poll the shared store for divergence
            def _sync_loop():
                while not stopping.wait(cfg.database.sync_interval):
                    try:
                        engine.sync_with_store()
                    except Exception as e:
                        sugar().warning("store sync failed: %s", e)

            workers.append(
                threading.Thread(target=_sync_loop, name="vstpu-sync", daemon=True)
            )
        for worker in workers:
            worker.start()

        trace_dir = os.environ.get(TRACE_ENV)
        with device_trace(trace_dir) if trace_dir else contextlib.nullcontext():
            asyncio.run(serve(cfg, engine, stop))
    finally:
        stopping.set()
        # the workers run torch ops; an interpreter that exits under one
        # aborts in torch's thread pools, so a rebuild still running is
        # waited for (and then snapshotted by engine.close). They stay
        # daemons, so an interrupt of this wait still ends the process.
        for worker in workers:
            if worker.is_alive():
                sugar().info("waiting for %s to finish", worker.name)
                worker.join()
        if engine is not None:
            engine.close()
        store.close()
        if store_server is not None:
            store_server.close()
    return 0


def main(argv: list[str]) -> int:
    config_path = argv[1] if len(argv) > 1 else "config.json"
    if not os.path.exists(config_path):
        config_mod.create_sample(config_path)
        print(
            f"sample configuration created at {config_path}; edit it and rerun",
            file=sys.stderr,
        )
        return 1
    return run(config_mod.load(config_path))


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
