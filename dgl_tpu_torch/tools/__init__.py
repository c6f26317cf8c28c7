"""The repo's data tools on the port (counterparts of ``tools/``): run as
``python -m dgl_tpu_torch.tools.<name>`` with the JAX tools' arguments.

- ``partition_cli``: partition a saved graph into per-part files;
- ``dispatch_partitions``: split feature arrays into the parts' feature
  files, and verify a partition directory;
- ``chunked_dispatch``: write the chunked layout and stream it into parts;
- ``ogb_to_ondisk``: write a graph or an OGB dataset as an OnDiskDataset.

The files they write have the JAX tools' layout, and each package loads
what the other wrote. ``tools/launch.py`` imports neither package and
starts the port's programs as it starts the JAX package's:
``distributed.initialize`` reads the variables it sets.

The tools take ``--device`` (default ``cuda``): the device the graphs are
loaded on while the tool works. The partitioning, splitting and writing
are host work.
"""
