"""Synthetic explainability benchmark datasets (counterpart of
``dgl_tpu/data/generators.py``; reference ``python/dgl/data/synthetic.py``:
BAShapeDataset, TreeCycleDataset, TreeGridDataset — graphs with planted
motifs and ground-truth labels), MiniGC, the karate club and the SBM
mixture.

The JAX package builds MiniGC's topologies and the karate club with
networkx. The port needs no networkx: ``_NxGraph`` replays networkx's
undirected-graph bookkeeping (nodes and each node's neighbours in
insertion order, ``edges()`` each edge once from its first-seen end), and
each topology is built by the same sequence of insertions as its networkx
generator, so the node numbering and the edge order of
``from_networkx(nx.DiGraph(g))`` (adjacency order) come out the same.
Graphs and frames lie on ``device``; labels are int64.
"""
from __future__ import annotations

from itertools import combinations, product

import numpy as np
import torch

from .dgl_dataset import DGLDataset
from .utils import to_tensor

__all__ = ["BAShapeDataset", "TreeCycleDataset", "TreeGridDataset", "MiniGCDataset", "KarateClubDataset", "SBMMixtureDataset"]


def _barabasi_albert(n: int, m: int, rng) -> list:
    edges = []
    targets = list(range(m))
    repeated = []
    for v in range(m, n):
        for t in targets:
            edges.append((v, t))
        repeated.extend(targets)
        repeated.extend([v] * m)
        targets = [repeated[i] for i in rng.integers(0, len(repeated), m)]
    return edges


def _tree(height: int) -> list:
    edges = []
    n = 2 ** (height + 1) - 1
    for v in range(1, n):
        edges.append((v, (v - 1) // 2))
    return edges


class _MotifDataset(DGLDataset):
    def __init__(self, name, seed=0, transform=None, device="cuda",
                 **kwargs):
        self._seed = seed
        super().__init__(name=name, transform=transform, device=device)

    def _base_graph(self, rng):
        raise NotImplementedError

    def _motif(self):
        raise NotImplementedError

    def process(self):
        from .. import convert

        device = self.device
        rng = np.random.default_rng(self._seed)
        base_edges, num_base = self._base_graph(rng)
        motif_edges, motif_size, motif_labels = self._motif()
        edges = list(base_edges)
        labels = [0] * num_base
        n = num_base
        for _ in range(self.num_motifs):
            attach = int(rng.integers(0, num_base))
            for a, b in motif_edges:
                edges.append((n + a, n + b))
            edges.append((n, attach))
            labels.extend(motif_labels)
            n += motif_size
        src = np.array([a for a, b in edges] + [b for a, b in edges])
        dst = np.array([b for a, b in edges] + [a for a, b in edges])
        g = convert.graph((src, dst), num_nodes=n, device=device)
        g.ndata["label"] = to_tensor(np.array(labels), device)
        g.ndata["feat"] = torch.ones((n, 10), dtype=torch.float32,
                                     device=device)
        self._g = g

    def __getitem__(self, idx):
        assert idx == 0
        return self._apply_transform(self._g)

    def __len__(self):
        return 1


class BAShapeDataset(_MotifDataset):
    """BA graph + house motifs (reference ``data/synthetic.py`` BAShape)."""

    num_motifs = 80

    def __init__(self, **kwargs):
        super().__init__("ba_shape", **kwargs)

    def _base_graph(self, rng):
        return _barabasi_albert(300, 5, rng), 300

    def _motif(self):
        house = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (1, 4)]
        return house, 5, [1, 1, 2, 2, 3]

    @property
    def num_classes(self):
        return 4


class TreeCycleDataset(_MotifDataset):
    """Balanced tree + cycle motifs (reference TreeCycle)."""

    num_motifs = 60

    def __init__(self, **kwargs):
        super().__init__("tree_cycle", **kwargs)

    def _base_graph(self, rng):
        e = _tree(8)
        return e, 2**9 - 1

    def _motif(self):
        cyc = [(i, (i + 1) % 6) for i in range(6)]
        return cyc, 6, [1] * 6

    @property
    def num_classes(self):
        return 2


class TreeGridDataset(_MotifDataset):
    """Balanced tree + 3x3 grid motifs (reference TreeGrid)."""

    num_motifs = 60

    def __init__(self, **kwargs):
        super().__init__("tree_grid", **kwargs)

    def _base_graph(self, rng):
        e = _tree(8)
        return e, 2**9 - 1

    def _motif(self):
        grid = []
        for r in range(3):
            for c in range(3):
                v = r * 3 + c
                if c < 2:
                    grid.append((v, v + 1))
                if r < 2:
                    grid.append((v, v + 3))
        return grid, 9, [1] * 9

    @property
    def num_classes(self):
        return 2


# -- networkx's undirected graphs, without networkx ---------------------------


class _NxGraph:
    """The bookkeeping of ``networkx.Graph`` that fixes node numbering and
    edge order: nodes in insertion order, each node's neighbours in
    insertion order (an edge inserts both ends at once; a repeat changes
    nothing)."""

    def __init__(self, nodes=()):
        self.adj = {}
        self.add_nodes(nodes)

    def add_nodes(self, nodes):
        for v in nodes:
            self.adj.setdefault(v, {})

    def add_edges(self, edges):
        for u, v in edges:
            self.adj.setdefault(u, {})[v] = None
            self.adj.setdefault(v, {})[u] = None
        return self

    def edges(self):
        """Each edge once, from the end met first (``Graph.edges()``)."""
        seen = set()
        for u, nbrs in self.adj.items():
            for v in nbrs:
                if v not in seen:
                    yield u, v
            seen.add(u)

    def relabel(self, mapping) -> "_NxGraph":
        """``relabel_nodes(g, mapping)`` with ``copy=True``: nodes in
        order, then the edges in ``edges()`` order."""
        return _NxGraph(mapping[v] for v in self.adj).add_edges(
            (mapping[u], mapping[v]) for u, v in self.edges())

    def to_integers(self) -> "_NxGraph":
        """``convert_node_labels_to_integers`` (default ordering)."""
        return self.relabel({v: i for i, v in enumerate(self.adj)})

    def directed_edges(self):
        """(src, dst) of ``from_networkx(nx.DiGraph(g))``: every node's
        neighbours in adjacency order, nodes numbered in order."""
        index = {v: i for i, v in enumerate(self.adj)}
        src = [index[u] for u, nbrs in self.adj.items() for _ in nbrs]
        dst = [index[v] for nbrs in self.adj.values() for v in nbrs]
        return (np.array(src, np.int64), np.array(dst, np.int64),
                len(self.adj))


def _pairwise(nodes, cyclic=False):
    nodes = list(nodes)
    pairs = list(zip(nodes, nodes[1:]))
    if cyclic and nodes:
        pairs.append((nodes[-1], nodes[0]))
    return pairs


def _cycle_graph(n):
    return _NxGraph(range(n)).add_edges(_pairwise(range(n), cyclic=True))


def _path_graph(n):
    return _NxGraph(range(n)).add_edges(_pairwise(range(n)))


def _star_graph(n):
    """n + 1 nodes, the hub 0."""
    return _NxGraph(range(n + 1)).add_edges(
        (0, v) for v in range(1, n + 1))


def _wheel_graph(n):
    g = _NxGraph(range(n))
    if n > 1:
        rim = list(range(1, n))
        g.add_edges((0, v) for v in rim)
        if len(rim) > 1:
            g.add_edges(_pairwise(rim, cyclic=True))
    return g


def _complete_graph(n):
    return _NxGraph(range(n)).add_edges(combinations(range(n), 2))


def _lollipop_graph(m, n):
    g = _complete_graph(m)
    stick = list(range(m, m + n))
    g.add_nodes(stick)
    if n > 1:
        g.add_edges(_pairwise(stick))
    if m > 0 and n > 0:
        g.add_edges([(m - 1, stick[0])])
    return g


def _cartesian_product(g, h):
    """``networkx.cartesian_product(g, h)``: nodes (u, v), then g's edges
    across h's nodes, then h's edges across g's nodes."""
    p = _NxGraph((u, v) for u, v in product(g.adj, h.adj))
    p.add_edges(((u, x), (v, x)) for u, v in g.edges() for x in h.adj)
    p.add_edges(((x, u), (x, v)) for x in g.adj for u, v in h.edges())
    return p


def _flatten(obj):
    if not isinstance(obj, tuple):
        return (obj,)
    return tuple(x for item in obj for x in _flatten(item))


def _hypercube_graph(d):
    """``grid_graph([2] * d)``: products of paths, relabelled to flat
    tuples."""
    g = _path_graph(2)
    for _ in range(d - 1):
        g = _cartesian_product(_path_graph(2), g)
    return g.relabel({v: _flatten(v) for v in g.adj})


def _grid_2d_graph(m, n):
    g = _NxGraph((i, j) for i in range(m) for j in range(n))
    g.add_edges(((i, j), (pi, j)) for pi, i in _pairwise(range(m))
                for j in range(n))
    g.add_edges(((i, j), (i, pj)) for i in range(m)
                for pj, j in _pairwise(range(n)))
    return g


def _circular_ladder_graph(n):
    g = _NxGraph(range(2 * n))
    g.add_edges(_pairwise(range(n)))
    g.add_edges(_pairwise(range(n, 2 * n)))
    g.add_edges((v, v + n) for v in range(n))
    return g.add_edges([(0, n - 1), (n, 2 * n - 1)])


def minigc_topology(label: int, n: int) -> _NxGraph:
    """MiniGC's graph of class ``label`` for a drawn size ``n`` (the JAX
    package's ``MiniGCDataset.process.build``)."""
    n = max(n, 4)
    if label == 0:
        return _cycle_graph(n)
    if label == 1:
        return _star_graph(n - 1)
    if label == 2:
        return _wheel_graph(n - 1)
    if label == 3:
        m = max(2, n // 2)
        return _lollipop_graph(m, n - m)
    if label == 4:
        d = max(2, int(np.log2(n)))
        return _hypercube_graph(d).to_integers()
    if label == 5:
        r = max(2, int(np.sqrt(n)))
        return _grid_2d_graph(r, r).to_integers()
    if label == 6:
        return _complete_graph(min(n, 20))
    return _circular_ladder_graph(max(2, n // 2))


class MiniGCDataset(DGLDataset):
    """Mini graph classification dataset (reference ``data/minigc.py``):
    8 topology classes — cycle, star, wheel, lollipop, hypercube, grid,
    clique, circular ladder."""

    def __init__(self, num_graphs: int, min_num_v: int, max_num_v: int,
                 seed=0, transform=None, device="cuda", **kwargs):
        self.num_graphs = num_graphs
        self.min_num_v = min_num_v
        self.max_num_v = max_num_v
        self._seed = seed
        super().__init__(name="minigc", transform=transform, device=device)

    def process(self):
        from .. import convert

        rng = np.random.default_rng(self._seed)
        self.graphs = []
        self.labels = []
        per = self.num_graphs // 8
        for label in range(8):
            cnt = per if label < 7 else self.num_graphs - 7 * per
            for _ in range(cnt):
                n = int(rng.integers(self.min_num_v, self.max_num_v))
                src, dst, num = minigc_topology(label, n).directed_edges()
                self.graphs.append(convert.graph((src, dst), num_nodes=num,
                                                 device=self.device))
                self.labels.append(label)
        self.labels = to_tensor(np.array(self.labels), self.device)

    def __getitem__(self, idx):
        return self._apply_transform(self.graphs[idx]), self.labels[idx]

    def __len__(self):
        return len(self.graphs)

    @property
    def num_classes(self):
        return 8


# Zachary's karate club as networkx's ``karate_club_graph()`` builds it:
# its 78 edges in the order they first appear in the row-major scan of the
# adjacency data (the last, 33-22, only in row 33), and the members of
# Mr. Hi's club
_KARATE_EDGES = (
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10),
    (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2),
    (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3),
    (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32), (3, 7),
    (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16), (6, 16),
    (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33),
    (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
    (22, 32), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33), (24, 25),
    (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33), (28, 31),
    (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32), (31, 33),
    (32, 33), (33, 22),
)
_KARATE_MR_HI = frozenset({0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12, 13, 16,
                           17, 19, 21})


class KarateClubDataset(DGLDataset):
    """Zachary's karate club (reference ``data/karate.py``) — the real
    34-node graph, labels = the two factions."""

    def __init__(self, transform=None, device="cuda", **kwargs):
        super().__init__(name="karate_club", transform=transform,
                         device=device)

    def process(self):
        from .. import convert

        src, dst, n = _NxGraph(range(34)).add_edges(
            _KARATE_EDGES).directed_edges()
        g = convert.graph((src, dst), num_nodes=n, device=self.device)
        labels = np.array([0 if i in _KARATE_MR_HI else 1 for i in range(n)])
        g.ndata["label"] = to_tensor(labels, self.device)
        self._g = g

    def __getitem__(self, idx):
        assert idx == 0
        return self._apply_transform(self._g)

    def __len__(self):
        return 1

    @property
    def num_classes(self):
        return 2


class SBMMixtureDataset(DGLDataset):
    """Symmetric stochastic-block-model mixture (reference
    ``data/sbm.py``): graphs drawn from SBM(n_blocks, p, q) with community
    labels — the line-graph community-detection benchmark."""

    def __init__(self, n_graphs=16, n_nodes=200, n_communities=4,
                 p=0.2, q=0.02, seed=0, transform=None, device="cuda",
                 **kwargs):
        self._cfg = (n_graphs, n_nodes, n_communities, p, q, seed)
        super().__init__(name="sbm_mixture", transform=transform,
                         device=device)

    def process(self):
        from .. import convert

        ng, n, k, p, q, s = self._cfg
        device = self.device
        rng = np.random.default_rng(s)
        self._graphs = []
        self._labels = []
        size = n // k
        for gi in range(ng):
            labels = np.repeat(np.arange(k), size)
            labels = np.concatenate([labels, rng.integers(0, k, n - labels.size)])
            rng.shuffle(labels)
            src, dst = [], []
            # upper-triangle Bernoulli draws, then symmetrize
            for i in range(n):
                prob = np.where(labels == labels[i], p, q)
                draws = rng.random(n) < prob
                draws[: i + 1] = False
                js = np.nonzero(draws)[0]
                src.extend([i] * js.size)
                dst.extend(js.tolist())
            a = np.array(src, np.int64)
            b = np.array(dst, np.int64)
            g = convert.graph(
                (np.concatenate([a, b]), np.concatenate([b, a])), num_nodes=n,
                device=device,
            )
            g.ndata["label"] = to_tensor(labels, device)
            self._graphs.append(g)
            self._labels.append(labels)

    def __getitem__(self, idx):
        return self._apply_transform(self._graphs[idx])

    def __len__(self):
        return len(self._graphs)


class BACommunityDataset(_MotifDataset):
    """Two BA-shape communities joined by random inter-community edges
    (reference ``data/synthetic.py`` BACommunityDataset): 8 classes —
    the 4 BAShape roles per community — and community-indicating
    features."""

    num_motifs = 80

    def __init__(self, **kwargs):
        super().__init__("ba_community", **kwargs)

    def process(self):
        from .. import convert

        rng = np.random.default_rng(self._seed)
        halves = []
        offset = 0
        all_src, all_dst, labels = [], [], []
        for comm in range(2):
            base_edges = _barabasi_albert(300, 5, rng)
            num_base = 300
            edges = list(base_edges)
            comm_labels = [0] * num_base
            n = num_base
            house = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (1, 4)]
            for _ in range(self.num_motifs):
                attach = int(rng.integers(0, num_base))
                for a, b in house:
                    edges.append((n + a, n + b))
                edges.append((n, attach))
                comm_labels.extend([1, 1, 2, 2, 3])
                n += 5
            src = np.array(
                [a for a, b in edges] + [b for a, b in edges]
            ) + offset
            dst = np.array(
                [b for a, b in edges] + [a for a, b in edges]
            ) + offset
            all_src.append(src)
            all_dst.append(dst)
            labels.extend([l + 4 * comm for l in comm_labels])
            halves.append((offset, offset + n))
            offset += n
        # sparse random inter-community edges (reference: 0.01 * N)
        k = max(offset // 100, 1)
        inter_a = rng.integers(halves[0][0], halves[0][1], k)
        inter_b = rng.integers(halves[1][0], halves[1][1], k)
        all_src.append(np.concatenate([inter_a, inter_b]))
        all_dst.append(np.concatenate([inter_b, inter_a]))
        g = convert.graph(
            (np.concatenate(all_src), np.concatenate(all_dst)),
            num_nodes=offset, device=self.device,
        )
        g.ndata["label"] = to_tensor(np.asarray(labels), self.device)
        # community-indicating gaussian features (reference uses two
        # means)
        feat = rng.normal(size=(offset, 10)).astype(np.float32)
        feat[halves[1][0]:] += 1.0
        g.ndata["feat"] = to_tensor(feat, self.device)
        self._g = g

    @property
    def num_classes(self):
        return 8


class BA2MotifDataset(DGLDataset):
    """Graph-classification BA-2motif (reference ``data/synthetic.py``
    BA2MotifDataset): 1000 BA base graphs, half attached with a house
    motif, half with a 5-cycle; label = motif type."""

    def __init__(self, num_graphs: int = 1000, seed: int = 0,
                 transform=None, device="cuda", **kwargs):
        self._cfg = (num_graphs, seed)
        super().__init__(name="ba_2motif", transform=transform,
                         device=device)

    def process(self):
        from .. import convert

        num_graphs, seed = self._cfg
        rng = np.random.default_rng(seed)
        house = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 4), (1, 4)]
        cycle = [(i, (i + 1) % 5) for i in range(5)]
        self._graphs = []
        self._labels = np.zeros(num_graphs, np.int64)
        for i in range(num_graphs):
            label = int(rng.integers(0, 2))
            motif = house if label == 0 else cycle
            base = _barabasi_albert(20, 1, rng)
            edges = list(base)
            n = 20
            attach = int(rng.integers(0, 20))
            for a, b in motif:
                edges.append((n + a, n + b))
            edges.append((n, attach))
            n += 5
            src = np.array([a for a, b in edges] + [b for a, b in edges])
            dst = np.array([b for a, b in edges] + [a for a, b in edges])
            g = convert.graph((src, dst), num_nodes=n, device=self.device)
            g.ndata["feat"] = to_tensor(
                rng.normal(size=(n, 10)).astype(np.float32), self.device
            )
            self._graphs.append(g)
            self._labels[i] = label

    def __getitem__(self, idx):
        return self._apply_transform(self._graphs[idx]), self._labels[idx]

    def __len__(self):
        return len(self._graphs)

    @property
    def num_classes(self):
        return 2


__all__ += ["BACommunityDataset", "BA2MotifDataset"]
