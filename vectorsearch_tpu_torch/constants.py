"""Engine tuning constants.

Mirrors the reference's compile-time constants (reference:
config/constants.go:5-19) with TPU-appropriate additions. The reference bakes
these into the binary; we keep them module-level so tests can monkeypatch.
"""

# Reference parity constants (config/constants.go:5-13).
BATCH_SIZE_DATABASE = 1_000      # SQL batch size for streaming reads/writes
BATCH_SIZE_CACHE = 10_000        # compute minibatch for builder scans
CENTROID_SIZE = 10_000           # target vectors per cluster (leaf size)
SAMPLE_SIZE = 5 * BATCH_SIZE_CACHE   # k-means sample size (50k)
SPLIT_SIZE = 5                   # max k per divide step in the reference D&C
SUPERSET_MUL = 5                 # k-means superset oversampling factor
KMEANS_ITERATION_LIMIT = 1_000   # Lloyd's iteration cap

# Cache behaviour (config/constants.go:15-16).
CACHE_DURATION_S = 5.0           # TTL for owner/category/centroid cache
CACHE_CLEANUP_S = 15.0           # background sweep interval

# HTTP client recycling (config/constants.go:18).
HTTP_CLIENT_MAX_REQUESTS = 500

# --- TPU-native additions (no reference equivalent) ---

# Cluster bucket capacities are rounded up to a multiple of this so XLA sees a
# small set of static shapes (MXU sublane granularity for int8 is 32).
BUCKET_ROUND = 1_024

# Default max queries per device batch for the serving path.
MAX_QUERY_BATCH = 256

# Scan tile: rows of the corpus processed per grid step in fused kernels.
SCAN_TILE_N = 2_048
