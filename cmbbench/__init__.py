"""The benchmark of ``orphics_tpu_torch`` on an NVIDIA GPU: ``python3 -m
cmbbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
(see ``run.py``). Its cells, metrics and bounds are in ``BENCHMARK.json``
at the root of the repository."""
