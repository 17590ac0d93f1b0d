"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips, with its reason, where torch sees no
CUDA device (a CUDA kernel has no interpret mode). On a Hopper card:
``python -m pytest tests/test_torch_cuda.py -p no:xdist -q``."""

import numpy as np
import pytest
import torch

from aligntools_tpu.params import AlignParams
from aligntools_tpu.utils.synth import clustered_pairs
from aligntools_tpu_torch import batch as tbatch
from aligntools_tpu_torch import convert
from aligntools_tpu_torch.ops import scan

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _inputs(seed, B=16, m_pad=128, n_pad=1024):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)
    ms = rng.integers(1, m_pad + 1, (B, 1)).astype(np.int32)
    ns = np.maximum(rng.integers(1, n_pad + 1, (B, 1)), ms).astype(np.int32)
    qs = rng.choice(alpha, (B, m_pad))
    ts = rng.choice(alpha, (B, n_pad))
    qs[np.arange(m_pad)[None, :] >= ms] = -1
    ts[np.arange(n_pad)[None, :] >= ns] = -2
    allow = (rng.random((B, n_pad)) > 0.1).astype(np.float32)
    pm = np.array([[2, 3, -4, -1, -7, 0, 0, 0]], np.float32)
    return (m_pad, n_pad), (qs, ts, allow, ns, ms, pm)


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "edit"])
def test_scores_kernel_equals_plain(cuda, mode):
    (m_pad, n_pad), arrs = _inputs(3)
    qs, ts, _, ns, ms, pm = convert.kernel_inputs_from_numpy(*arrs, cuda)
    before = dict(scan.launches)
    got = scan.scores(mode, m_pad, n_pad, qs, ts, ns, ms, pm)
    torch.cuda.synchronize()
    want = scan.scores_plain(mode, m_pad, n_pad, qs, ts, ns, ms, pm)
    assert torch.equal(got, want)
    kernel = {"global": "affine", "local": "affine"}.get(mode, mode)
    assert scan.launches[kernel] == before[kernel] + 1


@pytest.mark.parametrize("use_jump", [False, True])
def test_fit_kernel_equals_plain(cuda, use_jump):
    (m_pad, n_pad), arrs = _inputs(5)
    args = convert.kernel_inputs_from_numpy(*arrs, cuda)
    got = scan.fit_scores(use_jump, m_pad, n_pad, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, scan.fit_scores_plain(use_jump, m_pad, n_pad,
                                                  *args))


@pytest.mark.parametrize("mode", ["local", "edit"])
def test_batch_on_card_equals_cpu(cuda, mode):
    pairs = clustered_pairs(64, seed=3)
    p = AlignParams()
    got = tbatch.batch_scores(mode, pairs, p, device="cuda")
    assert np.array_equal(got, tbatch.batch_scores(mode, pairs, p,
                                                   device="cpu"))
