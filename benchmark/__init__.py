"""The benchmark of vearch_tpu_torch, the PyTorch and CUDA port.

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once on one NVIDIA GPU and
prints one JSON object as its last line of output. Everything a cell
needs is found by name: its configuration (`configs/`), traffic mix
(`traffic/`), data recipe (`data/`), end-to-end and per-layer metric
readers (`end_to_end/`, `metrics/`) and the work of each kernel
(`roofline/`). `reference/` is the plain yardstick that decides
`correct`; it imports nothing of the program.
"""
