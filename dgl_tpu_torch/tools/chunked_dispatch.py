"""Chunked-graph dispatch: the memory-bounded partition pipeline
(counterpart of ``tools/chunked_dispatch.py``).

The reference preprocesses giant graphs into a chunked on-disk layout
(``tools/chunk_graph.py``: ``metadata.json``, edge CSV chunks and
node-feature ``.npy`` chunks) and then shuffles the chunks into
per-partition shards (``tools/distpartitioning/data_shuffle.py``,
``tools/dispatch_data.py``).

- :func:`write_chunked` writes that chunked layout from a graph in
  memory (for tests and small graphs).
- :func:`dispatch` streams the edge chunks one at a time, appending each
  edge to its destination owner's raw binary file, then builds each
  part's graph one part at a time: the peak memory is that of a chunk or
  of the largest part, never of the whole graph.

The output has ``partition_graph``'s layout (``part{p}.npz``, the
``{name}.json`` book and ``assignment.npy``), so ``load_partition`` and
``DistGraph`` read it, in either package.

Usage:
    python -m dgl_tpu_torch.tools.chunked_dispatch \
        --meta chunked/metadata.json --assignment parts.npy \
        --num-parts 8 --out shards/
"""
import argparse
import json
import os

import numpy as np
import torch

from .. import convert
from ..data.serialize import save_graphs
from ..examples._common import add_device_argument, device_of


def write_chunked(g, name: str, out_dir: str, num_chunks: int = 4):
    """Write the reference's chunked layout (``tools/chunk_graph.py``'s
    schema: ``metadata.json``, per-etype edge CSV chunks, per-ntype
    feature ``.npy`` chunks); returns the metadata's path."""
    os.makedirs(out_dir, exist_ok=True)
    src, dst = (t.cpu().numpy() for t in g.edges())
    n, e = g.num_nodes(), src.shape[0]
    meta = {
        "graph_name": name,
        "node_type": ["_N"],
        "num_nodes_per_chunk": [
            [n // num_chunks + (i < n % num_chunks)
             for i in range(num_chunks)]
        ],
        "edge_type": ["_N:_E:_N"],
        "num_edges_per_chunk": [
            [e // num_chunks + (i < e % num_chunks)
             for i in range(num_chunks)]
        ],
        "edges": {"_N:_E:_N": {
            "format": {"name": "csv", "delimiter": " "},
            "data": [],
        }},
        "node_data": {"_N": {}},
    }
    lo = 0
    for i, cnt in enumerate(meta["num_edges_per_chunk"][0]):
        path = os.path.join(out_dir, f"edges-{i}.txt")
        np.savetxt(path, np.stack([src[lo:lo + cnt], dst[lo:lo + cnt]], 1),
                   fmt="%d")
        meta["edges"]["_N:_E:_N"]["data"].append(path)
        lo += cnt
    for key, arr in g.ndata.items():
        arr = arr.cpu().numpy()
        paths = []
        lo = 0
        for i, cnt in enumerate(meta["num_nodes_per_chunk"][0]):
            path = os.path.join(out_dir, f"node-{key}-{i}.npy")
            np.save(path, arr[lo:lo + cnt])
            paths.append(path)
            lo += cnt
        meta["node_data"]["_N"][key] = {
            "format": {"name": "numpy"}, "data": paths}
    with open(os.path.join(out_dir, "metadata.json"), "w") as f:
        json.dump(meta, f)
    return os.path.join(out_dir, "metadata.json")


def dispatch(meta_path: str, assignment: np.ndarray, num_parts: int,
             out_dir: str, device="cuda"):
    """Stream the chunked layout into per-part files (see the module's
    docstring); the parts' graphs are built on ``device``. Returns the
    partition book."""
    with open(meta_path) as f:
        meta = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    name = meta["graph_name"]
    assignment = np.asarray(assignment).astype(np.int64)
    n = assignment.shape[0]
    # contiguous relabeling per part (RangePartitionBook convention)
    order = np.argsort(assignment, kind="stable")
    new_of_old = np.empty(n, np.int64)
    new_of_old[order] = np.arange(n)
    counts = np.bincount(assignment, minlength=num_parts)
    ranges = np.concatenate([[0], np.cumsum(counts)])

    # pass 1: stream edge chunks, append each edge to its dst owner's file
    tmp = [open(os.path.join(out_dir, f".edges-part{p}.bin"), "wb")
           for p in range(num_parts)]
    total_edges = 0
    for espec in meta["edges"].values():
        delim = espec["format"].get("delimiter", " ")
        for path in espec["data"]:
            chunk = np.loadtxt(path, dtype=np.int64,
                               delimiter=None if delim == " " else delim,
                               ).reshape(-1, 2)
            total_edges += chunk.shape[0]
            owner = assignment[chunk[:, 1]]
            for p in range(num_parts):
                rows = chunk[owner == p]
                if rows.size:
                    rows.tofile(tmp[p])
    for f in tmp:
        f.close()

    # pass 2: stream node-feature chunks into the parts' pieces
    feat_names = list(meta.get("node_data", {}).get("_N", {}))
    part_feats = {key: [[] for _ in range(num_parts)] for key in feat_names}
    for key in feat_names:
        lo = 0
        for path in meta["node_data"]["_N"][key]["data"]:
            arr = np.load(path)
            owner = assignment[lo:lo + arr.shape[0]]
            pos = new_of_old[lo:lo + arr.shape[0]]
            for p in range(num_parts):
                m = owner == p
                if m.any():
                    # keep (local position, rows): the parts assemble in
                    # relabeled order whatever the chunks' interleaving
                    part_feats[key][p].append((pos[m] - ranges[p], arr[m]))
            lo += arr.shape[0]

    # pass 3: build each part's graph (one part in memory at a time)
    cut = 0
    for p in range(num_parts):
        epath = os.path.join(out_dir, f".edges-part{p}.bin")
        edges = np.fromfile(epath, dtype=np.int64).reshape(-1, 2)
        os.remove(epath)
        owned_old = order[ranges[p]:ranges[p + 1]]
        cut += int((assignment[edges[:, 0]] != p).sum())
        # local id space: the owned nodes first (relabeled order), then
        # the halo sources
        halo = np.unique(edges[:, 0][assignment[edges[:, 0]] != p])
        all_old = np.concatenate([owned_old, halo])
        local = np.full(n, -1, np.int64)
        local[all_old] = np.arange(all_old.shape[0])
        sub = convert.graph((local[edges[:, 0]], local[edges[:, 1]]),
                            num_nodes=all_old.shape[0], device=device)
        sub.ndata["_new_id"] = torch.from_numpy(
            new_of_old[all_old]).to(device)
        inner = np.zeros(all_old.shape[0], bool)
        inner[: owned_old.shape[0]] = True
        sub.ndata["inner_node"] = torch.from_numpy(inner).to(device)
        for key in feat_names:
            pieces = part_feats[key][p]
            if not pieces:
                continue
            width = pieces[0][1].shape[1:]
            owned_arr = np.zeros((owned_old.shape[0],) + width,
                                 pieces[0][1].dtype)
            for pos, rows in pieces:
                owned_arr[pos] = rows
            full = np.zeros((all_old.shape[0],) + width, owned_arr.dtype)
            full[: owned_old.shape[0]] = owned_arr
            sub.ndata[key] = torch.from_numpy(full).to(device)
        save_graphs(os.path.join(out_dir, f"part{p}.npz"), [sub])

    book = {
        "graph_name": name,
        "num_parts": num_parts,
        "node_ranges": ranges.tolist(),
        "num_nodes": int(n),
        "num_edges": int(total_edges),
        "part_method": "chunked-dispatch",
        "edge_cut": cut,
    }
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(book, f)
    np.save(os.path.join(out_dir, "assignment.npy"), assignment)
    return book


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--meta", required=True)
    p.add_argument("--assignment", required=True,
                   help=".npy part assignment (from partition_cli)")
    p.add_argument("--num-parts", type=int, required=True)
    p.add_argument("--out", required=True)
    add_device_argument(p)
    args = p.parse_args(argv)
    device = device_of(args.device)
    book = dispatch(args.meta, np.load(args.assignment), args.num_parts,
                    args.out, device=device)
    print(json.dumps(book))
    return book


if __name__ == "__main__":
    main()
