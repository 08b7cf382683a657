"""The benchmark of the PyTorch and CUDA port (``recsys_tpu_torch``) on one
NVIDIA H100: graphed Criteo training of DeepFM and xDeepFM on a dataset of
Criteo's size held on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository's root names the cells; every cell,
configuration, traffic mix, limit and per-layer metric is a file of its
own under this directory, found by its name (`spec`).
"""
