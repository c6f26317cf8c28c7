"""Offline partitioning CLI (counterpart of ``tools/partition_cli.py``;
reference ``tools/partition_graph.py`` + ``tools/dispatch_data.py``):
partition a saved graph into per-part files.

Usage:
    python -m dgl_tpu_torch.tools.partition_cli --graph graph.npz \
        --num-parts 8 --out parts/ [--method metis|random]
"""
import argparse
import json
import time

from ..data.serialize import load_graphs
from ..distributed import partition_graph
from ..examples._common import add_device_argument, device_of


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--graph", required=True, help=".npz from save_graphs")
    p.add_argument("--name", default="graph")
    p.add_argument("--num-parts", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--method", default="metis", choices=["metis", "random"])
    p.add_argument("--num-hops", type=int, default=1)
    add_device_argument(p)
    args = p.parse_args(argv)
    device = device_of(args.device)

    graphs, _ = load_graphs(args.graph, device=device)
    g = graphs[0]
    print(f"graph: {g.num_nodes()} nodes, {g.num_edges()} edges")
    t0 = time.time()
    partition_graph(g, args.name, args.num_parts, args.out,
                    part_method=args.method, num_hops=args.num_hops)
    with open(f"{args.out}/{args.name}.json") as f:
        book = json.load(f)
    print(f"partitioned into {args.num_parts} parts in "
          f"{time.time() - t0:.1f}s; edge cut {book['edge_cut']} "
          f"({100 * book['edge_cut'] / max(g.num_edges(), 1):.1f}%)")
    return book


if __name__ == "__main__":
    main()
