"""The port's CUDA kernels on the card (marker ``cuda``).

Every test here needs a CUDA device and ``nvcc``, and skips without
them.  It imports neither JAX nor ``repro``, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The kernels are held against their plain versions on the same inputs:
min and max bit-equal, the float32 sum to rtol=atol=1e-5, since the
kernel's shared-memory atomics add in an order that changes from run to
run.
"""
import numpy as np
import pytest
import torch

from repro_torch.algorithms import bfs, pagerank, sssp
from repro_torch.core import SystemConfig, run
from repro_torch.graph import powerlaw_graph
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
@pytest.mark.parametrize("case", ["sum", "min", "max", "imin", "imax"])
def test_kernels_match_plain_on_the_card(cuda_device, e, v, b, d, case):
    rng = np.random.default_rng(e + v + d)
    ids, bp = _binned(rng, e, v, b)
    if case.startswith("i"):
        vals = rng.integers(-10**6, 10**6, (e, d)).astype(np.int32)
    else:
        vals = rng.standard_normal((e, d)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (vals, ids, bp)]
    kw = dict(block_size=b, num_segments=v, tile_e=256)
    if case == "sum":
        launches = seg_sum.launches
        got = seg_sum(*args, **kw)
        want = seg_sum_plain(*args, **kw)
        assert seg_sum.launches == launches + 1
        torch.cuda.synchronize()
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
