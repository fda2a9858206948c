"""The port's CUDA kernels on the card (marker ``cuda``).

Every test here needs a CUDA device and ``nvcc``, and skips without
them.  It imports neither JAX nor ``repro``, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The kernels are held against their plain versions on the same inputs:
K1/K2 min, max and int32 sum bit-equal, the float32 sum to
rtol=atol=1e-5, since the kernel's shared-memory atomics add in an order
that changes from run to run; K3 bit-equal at P = 1 and to 1e-5 for
P > 1 and the mean (another order of the sum); K4 to atol 2e-3 in f32
and, in bf16, to one bf16 step of the output (rtol 2**-7) plus atol 1e-2
(online softmax against one pass, p rounded to bf16 at another running
max).
"""
import numpy as np
import pytest
import torch

from repro_torch.algorithms import bfs, pagerank, sssp
from repro_torch.core import SystemConfig, run
from repro_torch.graph import powerlaw_graph
from repro_torch.kernels.embedding_bag import embag, embedding_bag_ref
from repro_torch.kernels.flash_attention import (attention, flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.segment_reduce import (seg_minmax, seg_minmax_plain,
                                                seg_sum, seg_sum_plain)

SWEEP = [(1000, 300, 64, 1), (4096, 512, 128, 8), (777, 100, 32, 5),
         (64, 512, 128, 1), (2048, 64, 64, 16)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _binned(rng, e, v, b):
    raw = rng.integers(0, v, e)
    ids = raw[np.argsort(raw // b, kind="stable")]
    bp = np.zeros((v + b - 1) // b + 1, np.int64)
    np.add.at(bp, raw // b + 1, 1)
    return ids.astype(np.int32), np.cumsum(bp).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("e,v,b,d", SWEEP)
@pytest.mark.parametrize("case", ["sum", "isum", "min", "max", "imin",
                                  "imax"])
def test_kernels_match_plain_on_the_card(cuda_device, e, v, b, d, case):
    rng = np.random.default_rng(e + v + d)
    ids, bp = _binned(rng, e, v, b)
    if case.startswith("i"):
        vals = rng.integers(-10**6, 10**6, (e, d)).astype(np.int32)
    else:
        vals = rng.standard_normal((e, d)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (vals, ids, bp)]
    kw = dict(block_size=b, num_segments=v, tile_e=256)
    if case.endswith("sum"):
        launches = seg_sum.launches
        got = seg_sum(*args, **kw)
        want = seg_sum_plain(*args, **kw)
        assert seg_sum.launches == launches + 1
        torch.cuda.synchronize()
        if case == "isum":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        is_min = case.endswith("min")
        launches = seg_minmax.launches
        got = seg_minmax(*args, is_min=is_min, **kw)
        want = seg_minmax_plain(*args, is_min=is_min, **kw)
        assert seg_minmax.launches == launches + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ["SD1", "TG0", "DD1"])
def test_main_path_on_the_card_matches_the_cpu(cuda_device, cfg):
    g = powerlaw_graph(3000, 20000, alpha=1.2, seed=7, weighted=True,
                       block_size=64)
    config = SystemConfig.from_name(cfg)
    for app in (bfs, sssp, pagerank):
        before = seg_sum.launches + seg_minmax.launches
        gpu = run(app(), g, config, use_kernels=True, device=cuda_device)
        assert seg_sum.launches + seg_minmax.launches > before
        cpu = run(app(), g, config, use_kernels=True, device="cpu")
        for key, want in cpu.state.items():
            got = gpu.state[key].cpu()
            if app is pagerank and key == "rank":
                torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
            else:
                assert torch.equal(got, want), (app, key)
        if app is not pagerank:
            assert gpu.iterations == cpu.iterations
            assert gpu.direction_trace == cpu.direction_trace
            assert gpu.occupancy_trace == cpu.occupancy_trace


@pytest.mark.cuda
@pytest.mark.parametrize("r,d,b,p,mode", [
    (1000, 32, 16, 4, "sum"), (5000, 128, 33, 1, "sum"),
    (200, 64, 8, 8, "mean"), (50, 8, 3, 2, "sum"), (50, 6, 9, 3, "sum"),
    (100_000, 128, 4096, 1, "sum"), (100_000, 128, 1000, 8, "mean")])
def test_embedding_bag_matches_plain_on_the_card(cuda_device, r, d, b, p,
                                                 mode):
    rng = np.random.default_rng(r + b)
    table = torch.from_numpy(
        rng.standard_normal((r, d)).astype(np.float32)).to(cuda_device)
    idx = rng.integers(0, r, (b, p)).astype(np.int32)
    idx[0, 0] = -1       # wraps to the last row
    idx[-1, -1] = r      # out of range: a NaN row
    idx = torch.from_numpy(idx).to(cuda_device)
    launches = embag.launches
    got = embag(table, idx, mode=mode)
    assert embag.launches == launches + 1
    want = embedding_bag_ref(table, idx, mode=mode)
    torch.cuda.synchronize()
    assert torch.isnan(got[-1]).all() and not torch.isnan(got[:-1]).any()
    if p == 1:
        assert torch.equal(got[:-1], want[:-1])
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (1, 2, 2, 128, 128, 64, True), (2, 4, 2, 256, 256, 64, True),
    (1, 8, 2, 128, 256, 128, True), (1, 2, 1, 64, 64, 32, False),
    (1, 2, 1, 128, 64, 32, True), (1, 4, 2, 100, 100, 16, True),
    (2, 6, 3, 72, 200, 128, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_on_the_card(cuda_device, b, hq, hkv,
                                                   sq, sk, d, causal, dtype):
    rng = np.random.default_rng(b + sq + sk)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, dtype)
        for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    launches = flash_attention.launches
    got = attention(q, k, v, causal=causal, device=cuda_device)
    assert flash_attention.launches == launches + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = (dict(rtol=0.0, atol=2e-3) if dtype == torch.float32
           else dict(rtol=2**-7, atol=1e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)
