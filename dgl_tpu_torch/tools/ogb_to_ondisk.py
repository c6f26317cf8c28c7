"""Preprocess a dataset into the OnDiskDataset layout (counterpart of
``tools/ogb_to_ondisk.py``; reference
``python/dgl/graphbolt/impl/ondisk_dataset.py:321`` preprocess and
``tools/dispatch_data.py``).

Sources:
  --ogb <name>        an OGB node-prediction dataset: through the ``ogb``
                      package, or, without it, OGB's raw layout under
                      ``--root`` (``from_ogb`` raises when neither is there)
  --graph <file.npz>  a graph saved with ``save_graphs`` (features, labels
                      and masks read from its node data)

Usage:
    python -m dgl_tpu_torch.tools.ogb_to_ondisk --graph g.npz --out ds_dir/
"""
import argparse

import numpy as np

from ..graphbolt import OnDiskDataset
from ..examples._common import add_device_argument, device_of


def graph_arrays(g):
    """The node features, labels and split ids of ``g``'s one node type,
    as ``OnDiskDataset.write`` takes them."""
    feats, labels, masks = {}, None, {}
    for k, v in g.ndata.items():
        arr = v.cpu().numpy()
        if k == "label":
            labels = arr
        elif k.endswith("_mask"):
            masks[k] = np.nonzero(arr)[0]
        elif not k.startswith("_"):
            feats[k] = arr
    return feats, labels, masks


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ogb")
    src.add_argument("--graph")
    p.add_argument("--out", required=True)
    p.add_argument("--name", default=None)
    p.add_argument("--root", default=None,
                   help="directory holding OGB's raw layout (--ogb only)")
    add_device_argument(p)
    args = p.parse_args(argv)
    device = device_of(args.device)

    if args.ogb:
        from ..data.adapter import from_ogb

        g = from_ogb(args.ogb, root=args.root, device=device)
        name = args.name or args.ogb
    else:
        from ..data.serialize import load_graphs

        graphs, _ = load_graphs(args.graph, device=device)
        g = graphs[0]
        name = args.name or "graph"

    src_ids, dst_ids = (t.cpu().numpy() for t in g.edges())
    feats, labels, masks = graph_arrays(g)
    ds = OnDiskDataset.write(
        args.out, name=name, src=src_ids, dst=dst_ids,
        num_nodes=g.num_nodes(), features=feats, labels=labels,
        train_ids=masks.get("train_mask"), val_ids=masks.get("val_mask"),
        test_ids=masks.get("test_mask"), device=device)
    print(f"wrote {args.out}: {ds.graph.num_nodes()} nodes, "
          f"{ds.graph.num_edges()} edges, features {list(feats)}")
    return ds


if __name__ == "__main__":
    main()
