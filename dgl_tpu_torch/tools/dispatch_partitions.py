"""Shard dispatch and verification (counterpart of
``tools/dispatch_partitions.py``; reference ``tools/distpartitioning/``:
``convert_partition.py``, ``data_proc_pipeline.py`` and
``verify_partitions.py``).

``dispatch``: split full-graph node feature arrays (.npz) into per-part
feature files beside each ``part{p}.npz``, keyed by the partition book,
so that trainers load only their own slice.

``verify``: load every part and check what the reference's pipeline
asserts after conversion: each node owned by exactly one part, the book's
contiguous ranges matching the assignment's counts, the inner-node
counts, edge endpoints in range, and the feature files' row counts and
ids.

Usage:
    python -m dgl_tpu_torch.tools.dispatch_partitions dispatch \
        --parts parts/ --node-feats feats.npz
    python -m dgl_tpu_torch.tools.dispatch_partitions verify --parts parts/
"""
import argparse
import os

import numpy as np

from ..distributed.partition import (load_assignment, load_partition,
                                     load_partition_book)
from ..examples._common import add_device_argument, device_of


def cmd_dispatch(args):
    book = load_partition_book(args.parts)
    assign = load_assignment(args.parts)
    feats = dict(np.load(args.node_feats))
    n = book.num_nodes()
    for name, arr in feats.items():
        if arr.shape[0] != n:
            raise SystemExit(
                f"feature {name!r} has {arr.shape[0]} rows, book says {n}")
    paths = []
    for p in range(book.num_partitions):
        owned = np.nonzero(assign == p)[0]
        out = {name: arr[owned] for name, arr in feats.items()}
        out["_global_ids"] = owned
        path = os.path.join(args.parts, f"part{p}_feats.npz")
        np.savez(path, **out)
        paths.append(path)
        print(f"part {p}: {owned.size} rows -> {path}")
    return paths


def cmd_verify(args):
    book = load_partition_book(args.parts)
    assign = load_assignment(args.parts)
    n = book.num_nodes()
    k = book.num_partitions
    errors = []

    counts = np.bincount(assign, minlength=k)
    ranges = np.asarray(book.meta["node_ranges"])
    # the ranges are ordered by part id: the counts must match directly
    if not np.array_equal(np.diff(ranges), counts):
        errors.append(f"book ranges {np.diff(ranges)} != assignment "
                      f"counts {counts}")

    total_inner = 0
    for p in range(k):
        pg, _ = load_partition(args.parts, p, device=args.device)
        inner = pg.ndata["inner_node"].cpu().numpy().astype(bool)
        gids = (pg.ndata["_new_id"].cpu().numpy()
                if "_new_id" in pg.ndata else None)
        total_inner += int(inner.sum())
        if int(inner.sum()) != counts[p]:
            errors.append(f"part {p}: {int(inner.sum())} inner nodes, "
                          f"assignment says {counts[p]}")
        # every edge's source is in the part by construction of the halo
        # subgraph: check the endpoints are in range
        src, dst = (t.cpu().numpy() for t in pg.edges())
        E = src.shape[0]
        if E and (src.max() >= pg.num_nodes()
                  or dst.max() >= pg.num_nodes()):
            errors.append(f"part {p}: edge endpoint out of range")
        fpath = os.path.join(args.parts, f"part{p}_feats.npz")
        if os.path.exists(fpath):
            fz = np.load(fpath)
            rows = fz["_global_ids"].shape[0]
            if rows != counts[p]:
                errors.append(f"part {p}: feature shard has {rows} rows, "
                              f"expected {counts[p]}")
            if gids is not None and not np.array_equal(
                    np.sort(fz["_global_ids"]),
                    np.sort(np.nonzero(assign == p)[0])):
                errors.append(f"part {p}: feature shard global ids "
                              "mismatch")
        print(f"part {p}: {pg.num_nodes()} nodes ({int(inner.sum())} "
              f"inner), {E} edges ok")

    if total_inner != n:
        errors.append(f"inner nodes {total_inner} != num_nodes {n}")
    if errors:
        print("FAILED:")
        for e in errors:
            print(" -", e)
        raise SystemExit(1)
    print(f"verified {k} parts, {n} nodes: OK")
    return k


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dispatch")
    d.add_argument("--parts", required=True)
    d.add_argument("--node-feats", required=True,
                   help=".npz of (N, ...) arrays")
    v = sub.add_parser("verify")
    v.add_argument("--parts", required=True)
    add_device_argument(v)
    args = p.parse_args(argv)
    if args.cmd == "dispatch":
        return cmd_dispatch(args)
    args.device = device_of(args.device)
    return cmd_verify(args)


if __name__ == "__main__":
    main()
