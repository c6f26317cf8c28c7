"""A worker for ``test_torch_remainder.py``'s shared-memory case, run in a
process that ``dgl_tpu_torch.multiprocessing_mod.Process`` spawns. Imports
no JAX."""
import numpy as np


def attach_and_report(name, queue):
    """Attach the graph published under ``name`` on the CPU and put its
    arrays (edges and frames, as numpy) on ``queue``."""
    import dgl_tpu_torch as dt

    g = dt.hetero_from_shared_memory(name, device="cpu")
    out = {"num_nodes": {nt: g.num_nodes(nt) for nt in g.ntypes}}
    for cet in g.canonical_etypes:
        out[f"edges {cet}"] = np.stack([a.numpy() for a in g.edges(
            etype=cet)])
        for k, v in g._edge_frames.get(cet, {}).items():
            out[f"edata {cet} {k}"] = v.numpy()
    for nt, frame in g._node_frames.items():
        for k, v in frame.items():
            out[f"ndata {nt} {k}"] = v.numpy()
    queue.put(out)
