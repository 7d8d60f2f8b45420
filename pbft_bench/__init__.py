"""The benchmark of the PyTorch and CUDA port, `simple_pbft_tpu_torch`.

Run one cell: `python -m pbft_bench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the repository's root (BENCHMARK.json
names the cells). Nothing here imports JAX or the JAX package; the
references under `reference/` import nothing of the program either.
"""
