"""KVStore and partition policies (counterpart of
``dgl_tpu/distributed/kvstore.py``; reference
``python/dgl/distributed/kvstore.py:732,962``,
``graph_partition_book.py:1100-1260``, ``id_map.py:14``).

The device plane is the mesh's: ``DistTensor`` reads and writes and the
masked all-to-all pull (``dist_minibatch.pull_rows_in_shard_map``). This
module keeps the reference's HOST-side surface: policies, id maps, and a
KVServer/KVClient pair whose data plane is process-local numpy (tensors
pushed from a card are copied to the host), shared with co-located
clients as numpy views (the reference's shared-memory plane,
``dist_graph.py:488-647``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..graph import _asnumpy

from .graph_partition_book import RangePartitionBook

__all__ = [
    "PartitionPolicy",
    "NodePartitionPolicy",
    "EdgePartitionPolicy",
    "HeteroDataName",
    "parse_hetero_data_name",
    "IdMap",
    "KVServer",
    "KVClient",
    "DistConnectError",
]

NODE_PART_POLICY = "node"
EDGE_PART_POLICY = "edge"
POLICY_DELIMITER = "~"


class DistConnectError(Exception):
    """Raised when a KV peer is unreachable (reference
    ``dist_context.py`` DistConnectError)."""


class PartitionPolicy:
    """Maps global ids to owner partitions / local ids (reference
    ``graph_partition_book.py:1100`` PartitionPolicy). ``ranges``
    overrides the id ranges the policy operates on (node policies use the
    book's node ranges; edge policies must supply EDGE ranges)."""

    def __init__(self, policy_str: str, partition_book: RangePartitionBook,
                 ranges=None):
        assert policy_str.split(POLICY_DELIMITER)[0] in (
            NODE_PART_POLICY, EDGE_PART_POLICY,
        ), f"bad policy {policy_str!r}"
        self._policy_str = policy_str
        self._book = partition_book
        self._ranges = (
            np.asarray(ranges, dtype=np.int64)
            if ranges is not None else partition_book._ranges
        )

    @property
    def policy_str(self) -> str:
        return self._policy_str

    @property
    def part_id(self) -> int:
        return self._book.partid

    @property
    def partition_book(self) -> RangePartitionBook:
        return self._book

    def to_partid(self, ids):
        ids = _asnumpy(ids)
        return np.searchsorted(self._ranges, ids, side="right") - 1

    def to_local(self, ids):
        """Global -> local ids on their owner part."""
        ids = _asnumpy(ids)
        return ids - self._ranges[self.to_partid(ids)]

    def get_part_size(self) -> int:
        p = self._book.partid
        return int(self._ranges[p + 1] - self._ranges[p])

    def get_size(self) -> int:
        return int(self._ranges[-1])


class NodePartitionPolicy(PartitionPolicy):
    """(reference ``graph_partition_book.py`` NodePartitionPolicy)."""

    def __init__(self, partition_book, ntype: str = "_N"):
        super().__init__(
            NODE_PART_POLICY + POLICY_DELIMITER + ntype, partition_book
        )


class EdgePartitionPolicy(PartitionPolicy):
    """(reference ``graph_partition_book.py`` EdgePartitionPolicy).

    Edge ids live in their own range space: pass ``edge_ranges``
    explicitly, or store them in the book's ``meta['edge_ranges']``
    (``partition_graph`` writes per-part edge counts there)."""

    def __init__(self, partition_book, etype=("_N", "_E", "_N"),
                 edge_ranges=None):
        from ..graphbolt.base import etype_tuple_to_str

        key = (
            etype_tuple_to_str(etype) if isinstance(etype, tuple) else etype
        )
        if edge_ranges is None:
            edge_ranges = partition_book.meta.get("edge_ranges")
        if edge_ranges is None:
            raise ValueError(
                "EdgePartitionPolicy needs edge_ranges (per-part edge id "
                "range starts); the book only carries node ranges"
            )
        super().__init__(
            EDGE_PART_POLICY + POLICY_DELIMITER + key, partition_book,
            ranges=edge_ranges,
        )


class HeteroDataName:
    """KV key naming (reference ``graph_partition_book.py:1162``)."""

    def __init__(self, is_node: bool, entity_type, data_name: str):
        self._policy = NODE_PART_POLICY if is_node else EDGE_PART_POLICY
        self._entity_type = entity_type
        self.data_name = data_name

    @property
    def policy_str(self) -> str:
        entity = self._entity_type
        if self.is_edge() and isinstance(entity, tuple):
            from ..graphbolt.base import etype_tuple_to_str

            entity = etype_tuple_to_str(entity)
        return self._policy + POLICY_DELIMITER + str(entity)

    def is_node(self) -> bool:
        return self._policy == NODE_PART_POLICY

    def is_edge(self) -> bool:
        return self._policy == EDGE_PART_POLICY

    def get_type(self):
        return self._entity_type

    def get_name(self) -> str:
        return self.data_name

    def __str__(self):
        return self.policy_str + POLICY_DELIMITER + self.data_name


def parse_hetero_data_name(name: str) -> HeteroDataName:
    """(reference ``graph_partition_book.py:1226``)."""
    parts = name.split(POLICY_DELIMITER)
    assert len(parts) == 3, f"bad data name {name!r}"
    policy, entity, data_name = parts
    is_node = policy == NODE_PART_POLICY
    if not is_node and ":" in entity:
        from ..graphbolt.base import etype_str_to_tuple

        entity = etype_str_to_tuple(entity)
    return HeteroDataName(is_node, entity, data_name)


class IdMap:
    """Homogeneous id -> (type_id, type_wise_id) (reference
    ``id_map.py:14``). ``id_ranges``: {type: (K, 2) start/end per
    partition}."""

    def __init__(self, id_ranges: Dict[str, np.ndarray]):
        vals = list(id_ranges.values())
        assert isinstance(vals[0], np.ndarray), \
            "id_ranges should be a dict of numpy arrays."
        self.num_parts = vals[0].shape[0]
        self.num_types = len(id_ranges)
        # order types by their first range start so the interleaved range
        # table is sorted (the reference does the same)
        items = sorted(id_ranges.items(), key=lambda kv: kv[1][0, 0])
        self.type_names = [k for k, _ in items]
        ranges = np.zeros((self.num_parts * self.num_types, 2), np.int64)
        typed_map = []
        for i, (_, id_range) in enumerate(items):
            ranges[i::self.num_types] = id_range
            typed_map.append(
                np.cumsum(id_range[:, 1] - id_range[:, 0], dtype=np.int64)
            )
        assert np.all(np.diff(ranges[:, 0]) >= 0)
        self.range_start = np.ascontiguousarray(ranges[:, 0])
        self.range_end = np.ascontiguousarray(ranges[:, 1]) - 1
        self.typed_map = np.stack(typed_map)  # (T, K) cumulative sizes

    def __call__(self, ids):
        ids = np.asarray(_asnumpy(ids), dtype=np.int64)
        pos = np.searchsorted(self.range_end, ids, side="left")
        type_ids = pos % self.num_types
        part_ids = pos // self.num_types
        offset_in_range = ids - self.range_start[pos]
        prev = np.where(
            part_ids > 0,
            self.typed_map[type_ids, np.maximum(part_ids - 1, 0)],
            0,
        )
        return type_ids, prev + offset_in_range


class KVServer:
    """Host KV store of one partition's data (reference
    ``kvstore.py:732``). Data lives in process RAM; co-located clients
    attach via ``get_shared_data`` (numpy views), matching the reference's
    shared-memory plane. Cross-process traffic rides the mesh's
    collectives instead of RPC."""

    def __init__(self, server_id: int, num_clients: int = 0,
                 ip_config: Optional[str] = None):
        self.server_id = server_id
        self.num_clients = num_clients
        self._data: Dict[str, np.ndarray] = {}
        self._policies: Dict[str, PartitionPolicy] = {}
        self._push_handlers: Dict[str, callable] = {}
        self._pull_handlers: Dict[str, callable] = {}

    def init_data(self, name: str, policy_str, data_tensor=None,
                  shape=None, dtype=np.float32):
        policy = (
            policy_str if isinstance(policy_str, PartitionPolicy) else None
        )
        if policy is not None:
            self._policies[name] = policy
        if data_tensor is not None:
            self._data[name] = np.array(_asnumpy(data_tensor))
        else:
            self._data[name] = np.zeros(shape, dtype)

    @property
    def data_store(self):
        return self._data

    def get_shared_data(self, name: str) -> np.ndarray:
        return self._data[name]

    def register_push_handler(self, name: str, func):
        """UDF push (reference ``kvstore.py`` register_push_handler)."""
        self._push_handlers[name] = func

    def register_pull_handler(self, name: str, func):
        self._pull_handlers[name] = func

    def push(self, name: str, ids, vals):
        ids, vals = _asnumpy(ids), _asnumpy(vals)
        handler = self._push_handlers.get(name)
        if handler is not None:
            handler(self._data, name, ids, vals)
        else:
            self._data[name][ids] = vals

    def pull(self, name: str, ids):
        ids = _asnumpy(ids)
        handler = self._pull_handlers.get(name)
        if handler is not None:
            return handler(self._data, name, ids)
        return self._data[name][ids]


class KVClient:
    """Client handle over a KVServer (reference ``kvstore.py:962``):
    push/pull with optional partition policies. Single-host direct calls;
    the device data plane is ``pull_rows_in_shard_map`` /
    ``sparse_all_to_all_pull`` over a mesh."""

    def __init__(self, server: KVServer, role: str = "default"):
        if server is None:
            raise DistConnectError("no KVServer to connect to")
        self._server = server
        self.role = role

    def init_data(self, name: str, shape, dtype=np.float32,
                  part_policy=None, init_func=None):
        data = None
        if init_func is not None:
            data = init_func(shape, dtype)
        self._server.init_data(
            name, part_policy, data_tensor=data, shape=shape, dtype=dtype
        )

    def data_name_list(self):
        return list(self._server.data_store.keys())

    def get_data_meta(self, name: str):
        arr = self._server.data_store[name]
        return arr.dtype, arr.shape, self._server._policies.get(name)

    def push(self, name: str, ids, vals):
        """(reference ``kvstore.py:1393``)."""
        self._server.push(name, ids, vals)

    def pull(self, name: str, ids):
        """(reference ``kvstore.py:1445``)."""
        return self._server.pull(name, ids)

    def register_push_handler(self, name: str, func):
        self._server.register_push_handler(name, func)

    def register_pull_handler(self, name: str, func):
        self._server.register_pull_handler(name, func)

    def delete_data(self, name: str):
        self._server.data_store.pop(name, None)
        self._server._policies.pop(name, None)
