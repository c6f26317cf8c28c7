"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``gpu`` and skips where there is no CUDA card: a
CUDA kernel has no CPU mode. The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
"""
import numpy as np
import pytest
import torch

import dgl_tpu_torch as dt
from dgl_tpu_torch import _kernels
from dgl_tpu_torch.ops.hub_spmm import build_hub_plan, hub_copy_u_sum
from dgl_tpu_torch.ops.shell_prefix import (
    flat_shell_indices, shell_prefix_sum, shell_prefix_sum_plain)

pytestmark = pytest.mark.gpu

LEVELS = [1500, 1104, 600, 17, 8]  # non-increasing, as the shells are
N_TABLE = 2000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _shell_inputs(feat, seed):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(N_TABLE, feat)).astype(
        np.float32)).to(torch.bfloat16)
    idx = [torch.from_numpy(rng.integers(0, N_TABLE + 1, m).astype(np.int32))
           for m in LEVELS]
    base = torch.from_numpy(rng.normal(size=(LEVELS[0] + 8, feat)).astype(
        np.float32))
    return table, idx, base


@pytest.mark.parametrize("n_out", [LEVELS[0] + 5, 1000])
@pytest.mark.parametrize("feat", [40, 128, 256, 13])
def test_kernel_matches_plain(card, feat, n_out):
    """Both sum the same f32 values in the same order: rtol = atol = 1e-5.
    F = 13 takes the scalar path; n_out = 1000 cuts the deeper levels."""
    table, idx, base = _shell_inputs(feat, 3)
    flat, rows = flat_shell_indices(idx, n_out, oob_index=N_TABLE)
    table_c, flat_c = table.to(card), flat.to(card)
    rows_b = base.shape[0] - 1
    # a contiguous view one element in: not 16-byte aligned, scalar path
    shifted = base.to(card).reshape(-1)[1:1 + rows_b * feat].view(rows_b, feat)
    for b in (None, base.to(card), shifted):
        before = _kernels.launch_counts["shell_prefix_sum"]
        out = shell_prefix_sum(table_c, flat_c, rows, n_out, base=b)
        torch.cuda.synchronize()
        assert _kernels.launch_counts["shell_prefix_sum"] == before + 1
        ref = shell_prefix_sum_plain(table_c, flat_c, rows, n_out, base=b)
        assert out.shape == (n_out, feat) and out.dtype == torch.float32
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        cpu = shell_prefix_sum_plain(table, flat, rows, n_out,
                                     base=None if b is None else b.cpu())
        torch.testing.assert_close(out.cpu(), cpu, rtol=1e-5, atol=1e-5)


def test_kernel_rejects_wrong_inputs(card):
    table, idx, _ = _shell_inputs(40, 4)
    flat, rows = flat_shell_indices(idx, LEVELS[0], oob_index=N_TABLE)
    with pytest.raises(ValueError, match="bf16"):
        shell_prefix_sum(table.float().to(card), flat.to(card), rows,
                         LEVELS[0])
    with pytest.raises(ValueError, match="int32"):
        shell_prefix_sum(table.to(card), flat.long().to(card), rows,
                         LEVELS[0])
    with pytest.raises(ValueError, match="shorter"):
        shell_prefix_sum(table.to(card), flat[:100].to(card), rows,
                         LEVELS[0])


def test_hub_copy_u_sum_on_card_matches_cpu(card):
    """The whole hub SpMM on the card (bf16 tensor-core matmul with an f32
    result, the CUDA kernel) against the same plan on the CPU."""
    rng = np.random.default_rng(7)
    n, e = 6000, 48000
    w = 1.0 / np.arange(1, n + 1)
    src = rng.choice(n, e, p=w / w.sum())
    dst = rng.choice(n, e, p=(w ** 0.7) / (w ** 0.7).sum())  # a residual
    rel = dt.graph((src, dst), num_nodes=n, device="cpu")._relation()
    plan = build_hub_plan(rel, 256, "int8")
    assert plan.res_dst is not None and plan.unrank_dst is not None
    x = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32))
    ref = hub_copy_u_sum(plan, x)
    before = _kernels.launch_counts["shell_prefix_sum"]
    out = hub_copy_u_sum(plan.to(card), x.to(card))
    torch.cuda.synchronize()
    assert _kernels.launch_counts["shell_prefix_sum"] == before + 1
    # same bf16 products and f32 sums, in another order on the card
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-4)
