"""Negative sampling (counterpart of ``dgl_tpu/sampling/negative.py``;
reference ``python/dgl/sampling/negative.py:39``): uniform global pairs,
rejecting existing edges."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..graph import Graph

__all__ = ["global_uniform_negative_sampling"]


def global_uniform_negative_sampling(
        g: Graph, num_samples: int, exclude_self_loops: bool = True,
        replace: bool = False, etype=None, redundancy: float = 1.3,
        seed: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``num_samples`` (src, dst) pairs that are not edges, as int64
    tensors on ``g``'s device (reference ``negative.py:39``; fewer on a
    dense graph). Each round draws ``int(want * redundancy) + 1``
    candidate sources, then as many destinations, and takes them in order,
    skipping self-loops (``exclude_self_loops``), edges of the graph and
    (without ``replace``) pairs taken before, as the reference's loop
    does; at most 10 rounds. Edge membership is one sorted search over the
    relation's ``src * num_dst + dst`` keys (``Relation.first_eids``),
    which answers as the reference's set of pairs does."""
    rng = np.random.default_rng(seed)
    rel = g._relation(etype)
    ns, nd = rel.num_src, rel.num_dst
    taken_s, taken_d = [], []
    seen = np.zeros(0, np.int64)  # sorted keys of the pairs taken
    count, tries, want = 0, 0, num_samples
    while count < num_samples and tries < 10:
        k = int(want * redundancy) + 1
        cs = rng.integers(0, ns, k)
        cd = rng.integers(0, nd, k)
        ok = rel.first_eids(cs, cd) < 0
        if exclude_self_loops:
            ok &= cs != cd
        idx = np.nonzero(ok)[0]
        if not replace:
            keys = cs[idx] * nd + cd[idx]
            _, first = np.unique(keys, return_index=True)
            fresh = np.zeros(idx.shape[0], bool)
            fresh[first] = True
            if seen.size:
                pos = np.minimum(np.searchsorted(seen, keys),
                                 seen.shape[0] - 1)
                fresh &= seen[pos] != keys
            idx = idx[fresh]
        idx = idx[:num_samples - count]
        taken_s.append(cs[idx])
        taken_d.append(cd[idx])
        if not replace:
            seen = np.union1d(seen, cs[idx] * nd + cd[idx])
        count += idx.shape[0]
        tries += 1
        want = num_samples - count
    src = np.concatenate(taken_s) if taken_s else np.zeros(0, np.int64)
    dst = np.concatenate(taken_d) if taken_d else np.zeros(0, np.int64)
    return (torch.from_numpy(src.astype(np.int64)).to(g.device),
            torch.from_numpy(dst.astype(np.int64)).to(g.device))
