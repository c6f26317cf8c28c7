"""Pipeline stages (counterpart of ``dgl_tpu/graphbolt/neighbor_sampler_gb.py``;
reference ``python/dgl/graphbolt/impl/neighbor_sampler.py``,
``feature_fetcher.py:49``, ``copy_to.py``): each stage maps an iterator of
MiniBatches to an iterator of MiniBatches.

Host stages keep ids as numpy arrays; ``CopyTo`` moves a batch's seeds,
labels, features and blocks to the device (``"cuda"`` unless given), with
copies on the calling thread's current stream. The device stages sample
and gather on the card from a ``torch.Generator`` of the device.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..graph import _asnumpy
from .minibatch import MiniBatch

__all__ = [
    "NeighborSamplerStage",
    "DeviceNeighborSamplerStage",
    "DeviceFeatureFetcher",
    "LayerNeighborSampler",
    "UniformNegativeSampler",
    "MiniBatchTransformer",
    "FeatureFetcher",
    "CooperativeFeatureFetcher",
    "InSubgraphSampler",
    "CopyTo",
]


class _Stage:
    def __init__(self, source: Iterable[MiniBatch]):
        self.source = source

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        raise NotImplementedError

    def __iter__(self) -> Iterator[MiniBatch]:
        for mb in self.source:
            yield self._apply(mb)

    def __len__(self):
        return len(self.source)


class NeighborSamplerStage(_Stage):
    """Attach fixed-shape MFG blocks for the seed nodes (reference
    ``impl/neighbor_sampler.py:640`` over FusedCSCSamplingGraph; here the
    host fixed-shape sampler, ``csrc/host_ops.cpp``). The blocks go to
    ``device``; ``mb.input_nodes`` is the innermost frontier's
    ``srcdata[NID]`` as a host array (padding slots read node 0), which the
    host feature stores take."""

    def __init__(self, source, graph, fanouts: Sequence[int],
                 batch_size: int, replace: bool = False, prob=None,
                 seed: Optional[int] = None, device="cuda"):
        super().__init__(source)
        from ..dataloading import FixedShapeNeighborSampler

        self.graph = graph
        self.sampler = FixedShapeNeighborSampler(
            list(fanouts), batch_size=batch_size, replace=replace,
            prob=prob, seed=seed, device=device,
        )

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        input_ids, _, blocks = self.sampler.sample_host_blocks(
            self.graph, _asnumpy(mb.seeds)
        )
        mb.blocks = blocks
        # blocks[0].srcdata[NID], read on the host: -1 padding -> node 0
        mb.input_nodes = np.where(input_ids >= 0, input_ids, 0)
        return mb


class DeviceNeighborSamplerStage(_Stage):
    """On-device sampling backend for the GraphBolt pipeline. The graph's
    CSC (int32) lives on ``device``; ``_apply`` runs the fixed-shape
    frontier expansion (``sampling/device_sampler.py``) with draws from a
    ``torch.Generator`` of the device seeded with ``seed`` (the reference
    splits a JAX key a batch) and attaches the :class:`DeviceMFG` as
    ``mb.device_mfg``.

    Downstream stages: :class:`DeviceFeatureFetcher` gathers features on
    the device; models consuming ``DeviceMFG`` (``models.DeviceSAGE``)
    train directly."""

    def __init__(self, source, graph, fanouts: Sequence[int],
                 mode: str = "unique", seed: Optional[int] = None,
                 device="cuda"):
        super().__init__(source)
        from ..sampling.device_sampler import DeviceNeighborSampler

        self.device = torch.device(device)
        rel = graph._relation(None)
        self.indptr = rel.csc_indptr.to(self.device, torch.int32)
        self.indices = rel.csc_indices.to(self.device, torch.int32)
        self.sampler = DeviceNeighborSampler(list(fanouts), mode=mode)
        self.generator = torch.Generator(device=self.device).manual_seed(
            0 if seed is None else seed)

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        seeds = torch.as_tensor(_asnumpy(mb.seeds)).to(self.device,
                                                        torch.int32)
        mfg = self.sampler.sample(self.generator, self.indptr, self.indices,
                                  seeds)
        mb.device_mfg = mfg
        mb.input_nodes = mfg.input_nodes()
        return mb


class DeviceFeatureFetcher(_Stage):
    """Feature fetch for the device backend: one gather a feature from a
    table on ``device``, keyed by ``mb.device_mfg.input_nodes()`` (no host
    round trip; the device analog of ``FeatureFetcher``)."""

    def __init__(self, source, node_features: dict, device="cuda"):
        super().__init__(source)
        device = torch.device(device)
        self.tables = {k: torch.as_tensor(_asnumpy(v) if not isinstance(
            v, torch.Tensor) else v).to(device)
            for k, v in node_features.items()}

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        ids = mb.device_mfg.input_nodes()
        mb.node_features = {k: t.index_select(0, ids)
                            for k, t in self.tables.items()}
        return mb


class LayerNeighborSampler(_Stage):
    """Layer-dependent (LABOR) sampling stage (reference
    ``impl/neighbor_sampler.py:640`` LayerNeighborSampler): consecutive
    layers share per-node uniforms so the union frontier is much smaller
    than independent per-seed sampling at equal variance.

    ``importance_sampling`` > 0 enables LABOR-i c-optimization
    iterations (-1 iterates to convergence) as in the reference's
    ``layer_dependency``/``num_iterations`` knobs."""

    def __init__(self, source, graph, fanouts: Sequence[int],
                 prob=None, importance_sampling: int = 0,
                 seed: Optional[int] = None):
        super().__init__(source)
        from ..dataloading import LaborSampler

        self.graph = graph
        self.sampler = LaborSampler(
            list(fanouts), prob=prob,
            importance_sampling=importance_sampling, seed=seed,
        )

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        input_nodes, output_nodes, blocks = self.sampler.sample_blocks(
            self.graph, _asnumpy(mb.seeds)
        )
        mb.blocks = blocks
        mb.input_nodes = input_nodes
        return mb


class MiniBatchTransformer(_Stage):
    """Apply an arbitrary per-minibatch function (reference
    ``python/dgl/graphbolt/minibatch_transformer.py:15``)."""

    def __init__(self, source, transformer=None):
        super().__init__(source)
        self.transformer = transformer or (lambda mb: mb)

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        out = self.transformer(mb)
        if out is None:
            raise ValueError("transformer must return the MiniBatch")
        return out


class UniformNegativeSampler(_Stage):
    """Append uniform negatives to (src, dst) seed pairs (reference
    ``python/dgl/graphbolt/negative_sampler.py:15`` +
    ``impl/uniform_negative_sampler.py:64``): corrupt the dst of each
    positive ``negative_ratio`` times, emit 1/0 labels and the
    positive-pair index of every row. Static output shape:
    ``num_seeds * (1 + negative_ratio)`` rows."""

    def __init__(self, source, graph, negative_ratio: int = 1,
                 seed: Optional[int] = None):
        super().__init__(source)
        self.num_nodes = graph.num_nodes()
        self.negative_ratio = int(negative_ratio)
        self._rng = np.random.default_rng(seed)

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        seeds = _asnumpy(mb.seeds)
        if seeds.ndim != 2 or seeds.shape[1] != 2:
            raise ValueError(
                f"negative sampling needs (N, 2) seed pairs, got {seeds.shape}"
            )
        pos = seeds.shape[0]
        r = self.negative_ratio
        neg_src = np.repeat(seeds[:, 0], r)
        neg_dst = self._rng.integers(0, self.num_nodes, pos * r)
        neg = np.stack([neg_src, neg_dst], axis=1)
        mb.seeds = np.concatenate([seeds, neg], axis=0)
        mb.negative_srcs = neg[:, 0]
        mb.negative_dsts = neg[:, 1]
        labels = np.zeros(pos * (1 + r), np.float32)
        labels[:pos] = 1.0
        mb.labels = labels
        mb.indexes = np.concatenate(
            [np.arange(pos), np.repeat(np.arange(pos), r)]
        )
        return mb


class FeatureFetcher(_Stage):
    """Gather features for input nodes (reference ``feature_fetcher.py:49``).

    ``node_feature_keys=None`` reads ``LazyFeature`` markers from ``graph``
    (set with ``dgl.set_node_lazy_features``) to decide what to fetch —
    the reference's lazy-feature prefetch contract."""

    def __init__(self, source, feature_store, node_feature_keys=None,
                 domain: str = "node", type_name: str = "_N", graph=None):
        super().__init__(source)
        self.store = feature_store
        if node_feature_keys is None:
            from .lazy import LazyFeature

            if graph is None:
                raise ValueError(
                    "node_feature_keys=None requires graph= to read "
                    "LazyFeature markers"
                )
            frame = graph._node_frames.get(type_name, {})
            node_feature_keys = [
                k for k, v in frame.items() if isinstance(v, LazyFeature)
            ]
        self.keys = list(node_feature_keys)
        self.domain = domain
        self.type_name = type_name

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        ids = mb.input_nodes if mb.input_nodes is not None else mb.seeds
        for k in self.keys:
            mb.node_features[k] = self.store.read(
                self.domain, self.type_name, k, ids
            )
        return mb


def shard_feature_table(mesh, feat, axis: str = "gp"):
    """Row-shard a global feature array over a mesh axis for
    :class:`CooperativeFeatureFetcher`.

    Returns ``(ranges, table)``: ``ranges`` the (P+1,) global row range of
    each part (int64), ``table`` the (L, rows_max, F) part-major local rows
    held here (zero-padded tails), both on the mesh's device."""
    feat = torch.as_tensor(feat)
    nparts = mesh.shape[axis]
    n = feat.shape[0]
    rows_max = -(-n // nparts)
    ranges = np.minimum(np.arange(nparts + 1) * rows_max, n)
    table = feat.new_zeros((nparts * rows_max,) + tuple(feat.shape[1:]))
    table[:n] = feat
    table = table.reshape((nparts, rows_max) + tuple(feat.shape[1:]))
    return (torch.from_numpy(ranges.astype(np.int64)).to(mesh.device),
            mesh.local(table, axis))


class CooperativeFeatureFetcher(_Stage):
    """Cooperative-minibatching feature fetch (reference
    ``impl/neighbor_sampler.py:555-639`` + ``impl/cooperative_conv.py:12``):
    features live row-sharded over the mesh; a minibatch's input nodes are
    split evenly over the parts, and each part fetches its share by owner
    with the sparse all-to-all pull, so every row moves once, from the
    part that owns it. No part holds the whole table. The features come
    out on the mesh's device, in the batch's id order (across processes
    the parts' shares are gathered).

    ``tables``: dict key -> (ranges, table), from
    :func:`shard_feature_table`."""

    def __init__(self, source, mesh, tables, axis: str = "gp"):
        super().__init__(source)
        self.mesh = mesh
        self.tables = tables
        self.axis = axis

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        from ..distributed.cooperative import sparse_all_to_all_pull

        ids = torch.as_tensor(
            mb.input_nodes if mb.input_nodes is not None else mb.seeds)
        ids = ids.to(self.mesh.device, torch.int64)
        n = ids.shape[0]
        nparts = self.mesh.shape[self.axis]
        per = -(-max(n, 1) // nparts)
        padded = ids.new_zeros(nparts * per)
        padded[:n] = ids
        id_blocks = self.mesh.local(padded.reshape(nparts, per), self.axis)
        for k, (ranges, table) in self.tables.items():
            rows = sparse_all_to_all_pull(self.mesh, ranges, table,
                                          id_blocks, axis=self.axis)
            rows = self.mesh.all_gather(rows, self.axis)
            mb.node_features[k] = rows.reshape(
                (nparts * per,) + tuple(rows.shape[2:]))[:n]
        return mb


def _to_device(x, device: torch.device):
    """A numpy array, tensor or graph on ``device``; None stays None."""
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


class CopyTo(_Stage):
    """Move a batch's seeds, labels, node features and blocks to ``device``
    (reference ``copy_to.py``; ``"cuda"`` when ``device`` is None). The
    copies are blocking and go on the calling thread's current stream, so
    whatever the consumer runs after taking the batch is ordered after
    them."""

    def __init__(self, source, device=None):
        super().__init__(source)
        self.device = torch.device("cuda" if device is None else device)

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        mb.seeds = _to_device(mb.seeds, self.device)
        mb.labels = _to_device(mb.labels, self.device)
        mb.node_features = {k: _to_device(v, self.device)
                            for k, v in mb.node_features.items()}
        if mb.blocks is not None:
            mb.blocks = [b.to(self.device) for b in mb.blocks]
        return mb


def exclude_seed_edges(mb: MiniBatch, include_reverse_edges: bool = False):
    """Mask the minibatch's seed (src, dst) edges out of its sampled blocks
    (reference ``python/dgl/graphbolt/external_utils.py:128``).

    Fixed-shape friendly: edges stay in place, their ``_mask`` is cleared
    (and endpoints rerouting is unnecessary because every masked consumer
    multiplies by ``_mask``). Use inside a ``MiniBatchTransformer`` after
    the sampler stage.
    """
    from ..base import NID

    seeds = _asnumpy(mb.seeds)
    if seeds.ndim != 2 or seeds.shape[1] != 2:
        raise ValueError("exclude_seed_edges needs (N, 2) seed pairs")
    # (u, v) pairs packed into one int64 key (ids are < 2^31): vectorized
    # membership instead of a per-edge Python loop
    key = seeds[:, 0].astype(np.int64) * (1 << 32) + seeds[:, 1]
    if include_reverse_edges:
        key = np.concatenate(
            [key, seeds[:, 1].astype(np.int64) * (1 << 32) + seeds[:, 0]]
        )
    for blk in mb.blocks or ():
        rel = blk._relation(None)
        src_nid = _asnumpy(blk.srcdata[NID])
        dst_nid = _asnumpy(blk.dstdata[NID])
        esrc = _asnumpy(rel.src)
        edst = _asnumpy(rel.dst)
        mask = blk.edata["_mask"]
        ekey = (
            src_nid[esrc].astype(np.int64) * (1 << 32) + dst_nid[edst]
        )
        banned = torch.from_numpy(np.isin(ekey, key)).to(mask.device)
        blk.edata["_mask"] = mask & ~banned
    return mb


__all__.append("exclude_seed_edges")


class InSubgraphSampler(_Stage):
    """Full in-neighborhood sampler (reference
    ``impl/in_subgraph_sampler.py``): attaches the seeds' complete 1-hop
    in-subgraph as a :class:`SampledSubgraphImpl` (no fanout cap)."""

    def __init__(self, source, graph):
        super().__init__(source)
        from .impl.fused_csc_sampling_graph import (
            FusedCSCSamplingGraph, from_dglgraph,
        )

        self.graph = (graph if isinstance(graph, FusedCSCSamplingGraph)
                      else from_dglgraph(graph))

    def _apply(self, mb: MiniBatch) -> MiniBatch:
        seeds = _asnumpy(mb.seeds)
        sub = self.graph.in_subgraph(seeds)
        mb.sampled_subgraphs = [sub]
        mb.input_nodes = np.unique(
            np.concatenate([seeds, sub.sampled_csc.indices])
        )
        return mb
