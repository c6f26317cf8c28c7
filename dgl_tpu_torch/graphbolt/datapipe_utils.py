"""Datapipe-graph utilities and pipeline stages (counterpart of
``dgl_tpu/graphbolt/datapipe_utils.py``; reference
``python/dgl/graphbolt/internal/datapipe_utils.py`` and
``dataloader.py:24-77`` Bufferer/Waiter/EndMarker/MultiprocessingWrapper).

Our pipeline is a singly-linked chain of stages (each holds ``.source``);
the reference's torchdata graph-walk API maps onto walking that chain.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List

from .neighbor_sampler_gb import _Stage

__all__ = [
    "traverse_dps",
    "find_dps",
    "replace_dp",
    "datapipe_graph_to_adjlist",
    "EndMarker",
    "FeatureFetcherStartMarker",
    "Bufferer",
    "Waiter",
    "PrefetcherIterDataPipe",
    "MultiprocessingWrapper",
]


def traverse_dps(datapipe):
    """Walk the stage chain into the reference's graph dict form:
    ``{id(dp): (dp, [ids of inputs])}`` (reference
    ``internal/datapipe_utils.py`` traverse_dps)."""
    graph = {}
    node = datapipe
    while True:
        src = getattr(node, "source", None)
        graph[id(node)] = (node, [id(src)] if src is not None else [])
        if src is None or not hasattr(src, "__iter__"):
            break
        node = src
        if id(node) in graph:  # cycle guard
            break
    return graph


def find_dps(graph, dp_type) -> List:
    """All stages of a given type in a traverse_dps graph (reference
    ``internal/datapipe_utils.py`` find_dps)."""
    return [dp for dp, _ in graph.values() if isinstance(dp, dp_type)]


def replace_dp(graph, old_dp, new_dp):
    """Replace ``old_dp`` with ``new_dp`` by rewiring every consumer's
    ``.source`` (reference ``internal/datapipe_utils.py`` replace_dp).
    Returns the updated graph."""
    for dp, inputs in graph.values():
        if getattr(dp, "source", None) is old_dp:
            dp.source = new_dp
    return traverse_dps(_head_of(graph))


def _head_of(graph):
    sources = {inp for _, inputs in graph.values() for inp in inputs}
    for key, (dp, _) in graph.items():
        if key not in sources:
            return dp
    # fallback: any node
    return next(iter(graph.values()))[0]


def datapipe_graph_to_adjlist(graph) -> dict:
    """{id: [input ids]} adjacency form (reference
    ``internal/datapipe_utils.py``)."""
    return {key: inputs for key, (dp, inputs) in graph.items()}


class EndMarker(_Stage):
    """Identity marker closing a pipe segment (reference
    ``dataloader.py:24`` EndMarker)."""

    def _apply(self, mb):
        return mb


class FeatureFetcherStartMarker(_Stage):
    """Identity marker opening the feature-fetch segment (reference
    ``feature_fetcher.py`` FeatureFetcherStartMarker) — the DataLoader's
    graph rewrite anchors the prefetcher between the markers."""

    def _apply(self, mb):
        return mb


class Bufferer(_Stage):
    """Prefetch up to ``buffer_size`` items in a background thread
    (reference ``dataloader.py:33`` Bufferer)."""

    def __init__(self, source: Iterable, buffer_size: int = 1):
        super().__init__(source)
        self.buffer_size = int(buffer_size)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.buffer_size)
        _END = object()
        err = []

        def worker():
            try:
                for item in self.source:
                    q.put(item)
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(_END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _END:
                break
            yield item
        t.join()
        if err:
            raise err[0]


class Waiter(_Stage):
    """Wait on future-like items (reference ``dataloader.py:57`` Waiter):
    anything with a ``.wait()`` is resolved, everything else passes
    through."""

    def _apply(self, item):
        return item.wait() if hasattr(item, "wait") else item


class PrefetcherIterDataPipe(Bufferer):
    """Reference name for the thread prefetcher the DataLoader inserts
    (torchdata ``Prefetcher``); identical to :class:`Bufferer`."""


class MultiprocessingWrapper(_Stage):
    """Parallel per-item execution of the WRAPPED stage's ``_apply`` over a
    worker pool, preserving order (reference ``dataloader.py:77``
    MultiprocessingWrapper).

    The reference forks processes; the samplers here are numpy and the
    host library (both release the GIL), so an ordered thread pool gives
    the overlap without fork or pickle costs. Wraps a
    stage: its ``.source`` items are mapped through ``stage._apply`` with
    ``num_workers`` threads.
    """

    def __init__(self, datapipe, num_workers: int = 0):
        super().__init__(datapipe)
        self.num_workers = int(num_workers)

    def __iter__(self):
        dp = self.source
        if self.num_workers <= 0 or not isinstance(dp, _Stage):
            yield from dp
            return
        # bounded submit-ahead window: Executor.map would drain the whole
        # upstream eagerly and buffer every sampled batch in RAM; keeping
        # at most 2*num_workers futures in flight streams the epoch with
        # the same parallelism
        from collections import deque

        window = 2 * self.num_workers
        with ThreadPoolExecutor(self.num_workers) as pool:
            futures = deque()
            upstream = iter(dp.source)
            exhausted = False
            while True:
                while not exhausted and len(futures) < window:
                    try:
                        item = next(upstream)
                    except StopIteration:
                        exhausted = True
                        break
                    futures.append(pool.submit(dp._apply, item))
                if not futures:
                    return
                yield futures.popleft().result()


class Node:
    """Visualization node for a pipeline stage (reference
    ``datapipes/visualization.py:26``)."""

    def __init__(self, dp):
        self.dp = dp
        self.name = type(dp).__name__
        self.childs = set()

    def add_child(self, child):
        self.childs.add(child)

    def __eq__(self, other):
        return isinstance(other, Node) and other.dp is self.dp

    def __hash__(self):
        return id(self.dp)

    def __str__(self):
        return self.name

    def __repr__(self):
        return f"{self}-{hash(self)}"


def to_nodes(dp, *, debug: bool = False):
    """Set of visualization nodes of a pipeline (reference
    ``datapipes/visualization.py:67``)."""
    graph = traverse_dps(dp)
    by_id = {key: Node(stage) for key, (stage, _) in graph.items()}
    for key, (stage, inputs) in graph.items():
        for inp in inputs:
            if inp in by_id:
                by_id[inp].add_child(by_id[key])
    return set(by_id.values())


def to_graph(dp, *, debug: bool = False):
    """Graphviz digraph of a pipeline (reference
    ``datapipes/visualization.py:140``); a DOT source string when the
    graphviz package is absent."""
    nodes = to_nodes(dp, debug=debug)
    edges = [
        (str(n), str(c)) for n in nodes for c in n.childs
    ]
    try:
        import graphviz

        dot = graphviz.Digraph()
        for n in nodes:
            dot.node(repr(n), str(n))
        for n in nodes:
            for c in n.childs:
                dot.edge(repr(n), repr(c))
        return dot
    except ImportError:
        lines = ["digraph pipeline {"]
        lines += [f'  "{a}" -> "{b}";' for a, b in sorted(edges)]
        lines.append("}")
        return "\n".join(lines)


__all__ += ["Node", "to_nodes", "to_graph"]
