"""The benchmark of ``dgl_tpu_torch``, the PyTorch / CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. See
``portbench/README.md``.
"""
