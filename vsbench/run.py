"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m vsbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on stdout (correct, attempted, failed, metrics,
device; traced: breakdown; then the numbers compared, with their
limits, under `checks`) and those numbers again as the last lines on
stderr. Exits 3 without a result where the card (or the cards the cell
asks for) is missing, and 4 where JAX or the JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

if __name__ == "__main__":
    import sys

    from vsbench.harness import main

    sys.exit(main(t_process=T_PROCESS))
