"""Shared helpers of the benchmark's CPU tests: a cell cut to a size the
CPU runs in seconds (the published widths kept), and the card fixture of
the tests marked ``gpu``."""
import copy

import pytest

from portbench import spec


def tiny(r: dict) -> dict:
    """The resolved cell ``r`` on a small graph of the same kind: 10,000
    nodes and 40,000 edges for a zipf graph (density under the bitmap
    plan's threshold, too many cells for a dense mask), the typed graph at
    1/200 of its counts; 128 hubs."""
    r = copy.deepcopy(r)
    g = r["cfg"]["graph"]
    if g["kind"] == "zipf":
        g.update(nodes=10_000, edges=40_000, train_nodes=5_000)
    else:
        g["nodes"] = {k: max(v // 200, 50) for k, v in g["nodes"].items()}
        g["relations"] = [[a, b, c, n // 200] for a, b, c, n in g["relations"]]
    r["cfg"]["plan"]["num_hubs"] = 128
    return r


def cells() -> list:
    return [w["name"] for w in spec.load_spec()["workloads"]]


def tiny_cell(name: str) -> dict:
    return tiny(spec.resolve(spec.load_spec(), name))


@pytest.fixture
def card():
    """The card's device name; skips where CUDA has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return "cuda"
