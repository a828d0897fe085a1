"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``;
see ``bench/README.md``."""
