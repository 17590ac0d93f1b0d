"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips, with its reason, where torch sees no
CUDA device (a CUDA kernel has no interpret mode). On a Hopper card:
``ALIGNTOOLS_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -o
addopts="" -q`` (the variable keeps tests/conftest.py from importing jax)."""

import numpy as np
import pytest
import torch

from aligntools_tpu_torch import batch as tbatch
from aligntools_tpu_torch import convert
from aligntools_tpu_torch.engine import device_tb
from aligntools_tpu_torch.ops import ptr, scan
from aligntools_tpu_torch.params import AlignParams
from aligntools_tpu_torch.utils.synth import clustered_pairs

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
    ms[0], ns[0] = 1, 1
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


PTR_CASES = [
    ("global", False, 1), ("local", False, 1), ("overlap", False, 1),
    ("fit", False, 1), ("fit", True, 1), ("global", False, 2),
    ("local", False, 2), ("overlap", False, 2), ("fit", False, 2),
    ("overlap", False, 4),
]


@pytest.mark.parametrize("n_pad", [1024, 4224])
@pytest.mark.parametrize("mode,use_jump,rpb", PTR_CASES)
def test_ptr_and_walk_kernels_equal_plain(cuda, mode, use_jump, rpb, n_pad):
    """Pointer kernel == plain (score, a, b, every pointer byte), then the
    walk kernel == plain on those pointers (columns and scalars)."""
    (m_pad, _), arrs = _inputs(7, m_pad=128, n_pad=n_pad)
    qs, ts, allow, ns, ms, pm = convert.kernel_inputs_from_numpy(*arrs, cuda)
    before = ptr.launches
    got = ptr.ptr_fill(mode, use_jump, m_pad, n_pad, qs, ts, allow, ns, ms,
                       pm, rpb)
    torch.cuda.synchronize()
    want = ptr.ptr_fill_plain(mode, use_jump, m_pad, n_pad, qs, ts, allow,
                              ns, ms, pm, rpb)
    assert ptr.launches == before + 1
    for name, g, w in zip(("score", "a", "b", "ptrs"), got, want):
        assert torch.equal(g, w), name
    starts = device_tb.walk_starts(mode, *got[:3], ms, ns)
    wk = device_tb.walk(mode, rpb, got[3], qs, ts, starts)
    torch.cuda.synchronize()
    wp = device_tb.walk_plain(mode, rpb, got[3], qs, ts, starts)
    for name, g, w in zip(("cols1", "cols2", "scal"), wk, wp):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("mode", ["local", "edit"])
def test_batch_on_card_equals_cpu(cuda, mode):
    pairs = clustered_pairs(64, seed=3)
    p = AlignParams()
    got = tbatch.batch_scores(mode, pairs, p, device="cuda")
    assert np.array_equal(got, tbatch.batch_scores(mode, pairs, p,
                                                   device="cpu"))


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "fit",
                                  "fit-s"])
def test_rows_on_card_equal_cpu(cuda, mode):
    rng = np.random.default_rng(11)
    pairs = clustered_pairs(48, seed=5)
    pairs = [(q[: len(q) // 4], t[: len(t) // 8]) for q, t in pairs]
    sites = None
    if mode == "fit-s":
        sites = [sorted(int(x) for x in rng.integers(0, len(t), 3))
                 for _, t in pairs]
    jmode = mode[:3] if mode.startswith("fit") else mode
    got = tbatch.align_batch(jmode, pairs, AlignParams(), sites,
                             traceback=True, device="cuda")
    want = tbatch.align_batch(jmode, pairs, AlignParams(), sites,
                              traceback=True, device="cpu")
    assert got == want
