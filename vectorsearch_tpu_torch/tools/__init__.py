"""The port's scale checks (counterparts of the JAX side's scripts under
tools/):

  scale_corpus        clustered rows made on a device from a seed, the
                      queries and the exact-f32 truth over the original rows
  bench_10m_serving   the 10M x 768 index served at nprobe 1 / 8 / 64, and
                      the flat path on the same rows
  engine_10m_check    the whole engine booted from SQL and from its
                      snapshot, then served over HTTP with streaming writes
  http_driver         the HTTP helpers those checks and chip_smoke.py drive
                      the entry with (a free port, a client, a fan-out, the
                      entry served from a thread)

Each check runs alone with `python -m vectorsearch_tpu_torch.tools.<name>` and
exposes the functions chip_smoke.py calls with the rows it already holds.
"""
