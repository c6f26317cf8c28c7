"""The repo's example programs on the port (counterparts of ``examples/``).

Each module has the file name, the arguments, the defaults and the printed
lines of its JAX twin, and runs as ``python -m
dgl_tpu_torch.examples.<name>``. Inside they are PyTorch programs:
``nn.Module`` models, ``torch.optim`` optimisers with optax's
hyperparameters, an explicit ``torch.Generator`` for the weights, and eager
loops where the JAX scripts compile one step or scan an epoch.

Every script takes ``--device`` (default ``cuda``) and stops with an error
naming CUDA when no card answers; it runs on the CPU only when asked with
``--device cpu``. ``main(argv=None)`` returns the numbers it prints, and
each script's setup (data, graph, plans, model, step) is a function of
its own, which the tests and ``chip_smoke.py`` call.
"""
