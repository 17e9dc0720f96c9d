"""The benchmark of `vaeplay_torch` on one NVIDIA H100.

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON result line.
README.md beside this file says how cells, configurations and per-layer
metrics are found by name.
"""
