"""The plain references, one module a configuration family.

Plain PyTorch in float32 (TF32 off) over the edge lists that the benchmark
made: ``index_add_`` sums, no plan, no relabelled graph, nothing imported
from the program. Each family module gives ``param_shapes``, ``forward``,
``dropout_masks`` and ``work`` (the model's operations and its
aggregations).
"""
