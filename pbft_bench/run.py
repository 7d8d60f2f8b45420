"""python -m pbft_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one benchmark cell: set-up, a measured window of `--seconds`,
the check of what the window produced against the plain reference, and
one JSON result line as the last line of standard output. With
`--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a traced run. Exits with a
nonzero code, and prints no result, without a CUDA card.
"""

import time

T_START = time.monotonic()  # set-up counts from here

if __name__ == "__main__":
    import sys

    from pbft_bench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
