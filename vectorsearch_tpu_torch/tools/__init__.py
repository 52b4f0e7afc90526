"""The port's scale checks (counterparts of the JAX side's scripts under
tools/):

  scale_corpus        clustered rows made on a device from a seed, the
                      queries and the exact-f32 truth over the original rows
  bench_10m_serving   the 10M x 768 index served at nprobe 1 / 8 / 64, and
                      the flat path on the same rows
  engine_10m_check    the whole engine booted from SQL and from its
                      snapshot, then served over HTTP with streaming writes
  host_profile        one engine search split into its host layers (embed,
                      the batcher's device dispatch, SQL, the rest) and
                      the HTTP layer on top
  bench_http_concurrent  served requests/s, dispatches and rows a dispatch,
                      p50/p99 under 1, 8 and 32 concurrent HTTP clients
  http_driver         the HTTP helpers those checks and chip_smoke.py drive
                      the entry with (a free port, a client, a fan-out, the
                      entry or one engine's router served from a thread)
  batch_sweep         QPS of the IVF search over batch sizes on distinct
                      queries at nprobe 1 and 2, on the bench harness's
                      setup and build (vectorsearch_tpu_torch.bench)

Each check runs alone with `python -m vectorsearch_tpu_torch.tools.<name>` and
exposes the functions chip_smoke.py calls with the rows it already holds.
"""
