"""The port's CUDA kernel and its GPU runs, on a card.

This file imports no JAX, so it runs on a GPU host that has only the
port installed:

    python -m pytest -q tests/test_torch_cuda.py

Without a CUDA device every test skips.  The kernel is held to its
plain PyTorch version on the same card (bitwise in float32, 2e-2 in
bfloat16), and PageRank on the GPU to the same PageRank on the CPU,
bitwise: the kernel's products and adds are unfused, as the CPU's eager
slot loop is.
"""
import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.apps import pagerank
from repro_torch.core.graph import zipf_edges
from repro_torch.kernels import ell_spmv as port

SHAPES = [                       # (nv, deg, rows, feat)
    (1, 1, 1, 1),
    (7, 3, 11, 5),
    (128, 8, 128, 32),
    (200, 7, 300, 20),
    (513, 16, 300, 129),
    (200, 8, 300, 1),
    (64, 32, 100, 1),
    (300, 2, 300, 1),
    (1000, 62, 3000, 1),         # a last bucket's non-power-of-two width
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _inputs(nv, deg, rows, feat, dtype, device):
    rng = np.random.default_rng(nv * 7 + deg)
    nbrs = torch.from_numpy(rng.integers(0, rows, (nv, deg)).astype(np.int32))
    w = torch.from_numpy(rng.random((nv, deg)) * (rng.random((nv, deg)) < 0.7))
    x = torch.from_numpy(rng.normal(size=(rows, feat)))
    mask = torch.from_numpy(rng.random(nv) < 0.8)
    return (nbrs.to(device), w.to(dtype).to(device), x.to(dtype).to(device),
            mask.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nv,deg,rows,feat", SHAPES)
def test_kernel_matches_plain_version_on_card(cuda, nv, deg, rows, feat,
                                              dtype):
    args = _inputs(nv, deg, rows, feat, dtype, cuda)
    want = port.ell_spmv_plain(*args)
    before = port.ell_spmv.launches
    got = port.ell_spmv(*args)
    torch.cuda.synchronize()
    assert port.ell_spmv.launches == before + 1
    assert got.dtype == dtype and got.shape == (nv, feat)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
    # the same call on the CPU runs the plain version: bitwise in float32
    cpu = port.ell_spmv(*(a.cpu() for a in args))
    if dtype == torch.float32:
        assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
def test_entry_points_share_the_launch(cuda):
    nbrs, w, x, mask = _inputs(300, 8, 400, 1, torch.float32, cuda)
    before = port.ell_spmv.launches
    y = port.ell_spmv_bucketed([nbrs[:100], nbrs[100:]], [w[:100], w[100:]],
                               x, [mask[:100], mask[100:]])
    assert torch.equal(y, port.ell_spmv(nbrs, w, x, mask))
    vals = x[nbrs.long()]                               # [Nv, W, 1]
    assert torch.equal(port.ell_fold(w, vals, mask), y)
    assert torch.equal(port.ell_spmv_batched(nbrs, w, x, mask), y)
    assert port.ell_spmv.launches == before + 5


@pytest.mark.cuda
def test_wrapper_raises_on_cuda_arguments_it_does_not_take(cuda):
    nbrs, w, x, mask = _inputs(10, 4, 20, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="dtype"):
        port.ell_spmv(nbrs, w, x.double(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        port.ell_spmv(nbrs, w, torch.cat([x, x], 1)[:, ::2], mask)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [True, False])
def test_gpu_pagerank_equals_cpu_pagerank_bitwise(cuda, use_kernel):
    edges = zipf_edges(2000, alpha=2.0, max_deg=64, seed=1)
    g, upd, syncs = pagerank.build(edges, 2000, eps=1e-4, device="cpu")
    cpu = api.run(g, upd, syncs=syncs, device="cpu")
    before = port.ell_spmv.launches
    gpu = api.run(g, upd, syncs=syncs, device=cuda, use_kernel=use_kernel)
    assert port.ell_spmv.launches > before
    assert torch.equal(gpu.vertex_data["rank"].cpu(), cpu.vertex_data["rank"])
    assert (gpu.superstep, gpu.n_updates) == (cpu.superstep, cpu.n_updates)
    assert gpu.globals["total_rank"].item() == cpu.globals["total_rank"].item()
