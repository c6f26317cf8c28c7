"""What the example programs and the tools share: the ``--device``
argument, the seeded generators, the masked losses and the mesh of
parts."""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from ..cli import NoCUDA, _device


def add_device_argument(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu only "
                        "when asked)")


def device_of(name) -> torch.device:
    """``name`` as a device; ``cuda`` without a card stops the program
    with an error that names CUDA."""
    try:
        return _device(name)
    except NoCUDA as exc:
        raise SystemExit(str(exc)) from None


def parser(description: str = None) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    add_device_argument(p)
    return p


def parse(p: argparse.ArgumentParser, argv=None):
    """Parse ``argv``; ``args.device`` becomes a ``torch.device``
    (:func:`device_of`). A ``--cpu`` flag, where a script has one, means
    ``--device cpu``."""
    args = p.parse_args(argv)
    if getattr(args, "cpu", False):
        args.device = "cpu"
    args.device = device_of(args.device)
    return args


def generator(seed: int) -> torch.Generator:
    """A CPU generator: the port's modules draw their weights on the CPU."""
    return torch.Generator().manual_seed(seed)


def seed_dropout(seed: int) -> None:
    """Seed the default generators (CPU and every card), which
    ``nn.Dropout`` draws its masks from."""
    torch.manual_seed(seed)


def masked_cross_entropy(logits, labels, mask):
    """optax's ``softmax_cross_entropy_with_integer_labels`` weighted by
    ``mask`` and divided by its sum, as the JAX scripts write it."""
    mask = mask.to(logits.dtype)
    ls = F.cross_entropy(logits, labels.long(), reduction="none")
    return (ls * mask).sum() / mask.sum()


def masked_mean_loss(logits, labels, mask):
    """The same with the sum clamped at 1 (``jnp.maximum(m.sum(), 1)``)."""
    mask = mask.to(logits.dtype)
    ls = F.cross_entropy(logits, labels.long(), reduction="none")
    return (ls * mask).sum() / torch.clamp(mask.sum(), min=1)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def dist_mesh(num_parts: int, axis: str, device):
    """The parts' mesh. Under ``tools/launch.py`` (its ``DGL_TPU_*``
    variables set) this process joins the group through
    ``distributed.initialize`` and holds one part, the world size being
    the part count; otherwise this process holds all ``num_parts`` on
    ``device``."""
    from ..distributed import get_world_size, initialize
    from ..parallel import create_mesh

    initialize(device=device)
    world = get_world_size()
    if world > 1:
        return create_mesh((world,), (axis,), group=True, device=device)
    return create_mesh((num_parts,), (axis,), device=device)


def parts_here(mesh, axis: str) -> range:
    """The parts this process holds, by their index on ``axis``."""
    lo = mesh.coord(axis)
    return range(lo, lo + mesh.parts(axis))


def total(mesh, x, axis: str):
    """The sum over every part of a per-part value held here (no
    gradient)."""
    x = x.detach()
    if mesh.one_process:
        return x.sum(0)
    return mesh.psum(x, axis)[0]


def add_parts_argument(p) -> None:
    p.add_argument("--num-parts", type=int, default=8,
                   help="parts held by this one process (ignored under "
                        "tools/launch.py: one part a process)")
