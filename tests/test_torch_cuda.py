"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips, with its reason, where torch sees no
CUDA device (a CUDA kernel has no interpret mode). On a Hopper card:
``ALIGNTOOLS_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -o
addopts="" -q`` (the variable keeps tests/conftest.py from importing jax)."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import os

import banded_ties
import blocked_ties as ties
import numpy as np
import ptr_ties
import pytest
import torch
import walk_cases

from aligntools_tpu_torch import batch as tbatch
from aligntools_tpu_torch import convert
from aligntools_tpu_torch.engine import device_tb, select
from aligntools_tpu_torch.ops import banded, blocked, ptr, scan
from aligntools_tpu_torch.params import AlignParams
from aligntools_tpu_torch.tools import vpu_probe
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


def _score_instance_equals_plain(variant, m_pad, n_pad, qs, ts, allow, ns,
                                 ms, pm):
    """The register-strip score instance of ``variant`` (global, local,
    overlap, fit, fit+jump) against plain, and the counter it moves."""
    mode, jump = variant.split("+")[0], variant.endswith("+jump")
    kernel = "affine" if mode in ("global", "local") else mode
    before = dict(scan.launches)
    if mode == "fit":
        got = scan.fit_scores(jump, m_pad, n_pad, qs, ts, allow, ns, ms, pm)
        torch.cuda.synchronize()
        want = scan.fit_scores_plain(jump, m_pad, n_pad, qs, ts, allow, ns,
                                     ms, pm)
    else:
        got = scan.scores(mode, m_pad, n_pad, qs, ts, ns, ms, pm)
        torch.cuda.synchronize()
        want = scan.scores_plain(mode, m_pad, n_pad, qs, ts, ns, ms, pm)
    assert scan.launches == {**before, kernel: before[kernel] + 1}
    bad = (got != want).nonzero()
    assert torch.equal(got, want), (bad[:8].tolist(), len(bad))


SCORE_INSTANCES = ["global", "local", "overlap", "fit", "fit+jump"]


@pytest.mark.parametrize("n_pad", [128, 384, 2048, 4224,
                                   ptr.FLAT_REG_MAX_N_PAD])
@pytest.mark.parametrize("mode", SCORE_INSTANCES)
def test_affine_score_instance_equals_plain(cuda, mode, n_pad):
    """The register-strip score instances (csrc/ptr_fill.cu) from one warp
    (128 columns) to the cap, ragged pairs with m = n = 1 and n = 1, and
    one pair with m = 0 and one with n = 0."""
    qs, ts, allow, ns, ms, pm = _flat_inputs(97 + n_pad, n_pad=n_pad)
    ms[3, 0], ns[4, 0] = 0, 0
    qs[3, :], ts[4, :] = -1, -2
    args = convert.kernel_inputs_from_numpy(qs, ts, allow, ns, ms, pm, cuda)
    _score_instance_equals_plain(mode, 64, n_pad, *args)


@pytest.mark.parametrize("mode", SCORE_INSTANCES)
def test_affine_score_instance_on_ties_equals_plain(cuda, mode):
    """tests/ptr_ties.py's pairs (maxima on both sides of strip and warp
    edges, end cells past them, overlap's zero pair): the once-reduced
    value gives the plain version's score."""
    args = convert.kernel_inputs_from_numpy(
        *ptr_ties.tie_inputs(3), ptr_ties.pmat(mode.split("+")[0]), cuda)
    _score_instance_equals_plain(mode, ptr_ties.M_PAD, ptr_ties.N_PAD, *args)


def test_affine_score_entry_refuses_a_shape_it_lacks(cuda):
    """No instance, no launch: an n_pad off the 16-column grid through the
    wrappers, and a strip width, CTA, mode or jump the entry has no
    instance for (edit's CTA may run 1,024 threads, the others' 512)."""
    arrs = _flat_inputs(103, B=3, m_pad=8, n_pad=136)
    qs, ts, allow, ns, ms, pm = convert.kernel_inputs_from_numpy(*arrs, cuda)
    for mode in ("global", "local", "overlap", "edit"):
        with pytest.raises(RuntimeError, match="score fill kernel launch"):
            scan.scores(mode, 8, 136, qs, ts, ns, ms, pm)
    for jump in (False, True):
        with pytest.raises(RuntimeError, match="score fill kernel launch"):
            scan.fit_scores(jump, 8, 136, qs, ts, allow, ns, ms, pm)
    out = torch.empty(3, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    for mode, jump, threads, width in (
            (1, 0, 32, 8), (1, 0, 1024, 16), (1, 0, 48, 16), (2, 1, 32, 8),
            (3, 0, 1024, 16), (0, 1, 32, 16), (3, 1, 32, 16), (4, 0, 32, 8),
            (4, 0, 1056, 16), (4, 0, 48, 16), (4, 1, 32, 16), (5, 0, 32, 16),
            (-1, 0, 32, 16)):
        err = scan._kernels().at_score_fill(
            mode, jump, qs.data_ptr(), ts.data_ptr(), allow.data_ptr(),
            ns.data_ptr(), ms.data_ptr(), pm.data_ptr(), out.data_ptr(), 3, 8,
            128, threads, width, stream)
        assert err != 0, (mode, jump, threads, width)


def _edit_equals_plain(m_pad, n_pad, qs, ts, ns, ms, pm):
    """The edit score fill against plain: its launch moves
    scan.launches["edit"] alone and runs no plain version."""
    before, plain = dict(scan.launches), scan.plain_calls
    got = scan.scores("edit", m_pad, n_pad, qs, ts, ns, ms, pm)
    torch.cuda.synchronize()
    assert scan.launches == {**before, "edit": before["edit"] + 1}
    assert scan.plain_calls == plain
    want = scan.scores_plain("edit", m_pad, n_pad, qs, ts, ns, ms, pm)
    bad = (got != want).nonzero()
    assert got.dtype == torch.int32
    assert torch.equal(got, want), (bad[:8].tolist(), len(bad))


# every launch shape of the edit score fill: 32 to EDIT_MAX_THREADS
# threads, one n_pad each (the widest it covers), and 128 and 384 columns
EDIT_N_PADS = sorted({128, 384} | {512 * k for k in range(
    1, scan.EDIT_MAX_THREADS // 32 + 1)})


@pytest.mark.parametrize("u", [1, -2])
@pytest.mark.parametrize("n_pad", EDIT_N_PADS)
def test_edit_score_fill_equals_plain(cuda, n_pad, u):
    """The int32 min-plus register-strip fill at every launch shape from
    one warp to its cap, ragged pairs with m = n = 1 and n = 1, one pair
    with m = 0 (0, the latch) and one with n = 0 (INT32_MAX); a
    substitution cost of 1 and the default -2 (distances below 0)."""
    qs, ts, allow, ns, ms, pm = _flat_inputs(107 + n_pad, n_pad=n_pad)
    ms[3, 0], ns[4, 0] = 0, 0
    qs[3, :], ts[4, :] = -1, -2
    pm[0, 1] = u
    assert scan.flat_shape("edit", n_pad)[0] == max(32, -(-n_pad // 512) * 32)
    args = convert.kernel_inputs_from_numpy(qs, ts, None, ns, ms, pm, cuda)
    tq, tt, _, tn, tm, tp = args
    _edit_equals_plain(64, n_pad, tq, tt, tn, tm, tp)


@pytest.mark.parametrize("u", [1, -2])
def test_edit_score_fill_on_ties_equals_plain(cuda, u):
    """tests/ptr_ties.py's pairs (equal values on both sides of strip and
    warp edges, m = n = 1, n = 1) through the edit score fill."""
    qs, ts, _, ns, ms = ptr_ties.tie_inputs(5)
    pm = np.zeros((1, 8), np.float32)
    pm[0, 1] = u
    tq, tt, _, tn, tm, tp = convert.kernel_inputs_from_numpy(
        qs, ts, None, ns, ms, pm, cuda)
    _edit_equals_plain(ptr_ties.M_PAD, ptr_ties.N_PAD, tq, tt, tn, tm, tp)


@pytest.mark.parametrize("n_pad", [scan.flat_cap("edit") + 128, 32768])
def test_wide_edit_routes_to_the_blocked_fill(cuda, n_pad):
    """Past its cap scan.scores("edit") runs the blocked score fill at
    select.blocked_c_blk(), with a ragged last block one bucket past the
    cap: the flat plain version's distances, and no launch of the flat
    fill."""
    assert scan.blocked_c_blk("edit", n_pad) == select.blocked_c_blk()
    qs, ts, _, ns, ms, pm = convert.kernel_inputs_from_numpy(
        *_flat_inputs(109, B=6, m_pad=64, n_pad=n_pad), cuda)
    before = dict(blocked.launches), dict(scan.launches)
    got = scan.scores("edit", 64, n_pad, qs, ts, ns, ms, pm)
    torch.cuda.synchronize()
    assert blocked.launches["blocked_scores"] == (
        before[0]["blocked_scores"] + 1)
    assert scan.launches == before[1]
    assert torch.equal(got, scan.scores_plain("edit", 64, n_pad, qs, ts, ns,
                                              ms, pm))


@pytest.mark.parametrize("n_pad", [ptr.FLAT_REG_MAX_N_PAD + 128, 32768])
@pytest.mark.parametrize("mode", SCORE_INSTANCES)
def test_wide_scores_route_to_the_blocked_fill(cuda, mode, n_pad):
    """Past the cap scan.scores / fit_scores run the blocked score fill at
    select.blocked_c_blk() with a ragged last block (8,320) or whole blocks
    (32,768): the flat plain version's scores."""
    arrs = _flat_inputs(101, B=6, m_pad=64, n_pad=n_pad)
    qs, ts, allow, ns, ms, pm = convert.kernel_inputs_from_numpy(*arrs, cuda)
    base, jump = mode.split("+")[0], mode.endswith("+jump")
    before = dict(blocked.launches), dict(scan.launches)
    if base == "fit":
        got = scan.fit_scores(jump, 64, n_pad, qs, ts, allow, ns, ms, pm)
        plain = scan.fit_scores_plain(jump, 64, n_pad, qs, ts, allow, ns, ms,
                                      pm)
    else:
        got = scan.scores(base, 64, n_pad, qs, ts, ns, ms, pm)
        plain = scan.scores_plain(base, 64, n_pad, qs, ts, ns, ms, pm)
    torch.cuda.synchronize()
    assert blocked.launches["blocked_scores"] == (
        before[0]["blocked_scores"] + 1)
    assert scan.launches == before[1]
    assert torch.equal(got, plain)


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


# (n_pad, threads, W): the kernel's launch shape at every n_pad of the
# list, from 32 threads (n_pad 128) to 512 (the rows path's cap); and
# launches with whole warps past n_pad
PTR_KERNEL_SHAPES = sorted(
    {(n, *ptr.launch_shape(n)) for n in (128, 384, 2048, 3072, 4096,
                                         ptr.FLAT_REG_MAX_N_PAD)}
    | {(384, ptr.MAX_THREADS, ptr.WIDTH), (2048, 256, ptr.WIDTH)})


def _flat_inputs(seed, B=12, m_pad=64, n_pad=1024):
    """Ragged pairs: m = n = 1, m = m_pad with n = 1, a full pair, the rest
    drawn."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)
    ms = rng.integers(1, m_pad + 1, (B, 1)).astype(np.int32)
    ns = rng.integers(1, n_pad + 1, (B, 1)).astype(np.int32)
    ms[:3, 0], ns[:3, 0] = [1, m_pad, m_pad], [1, 1, n_pad]
    qs = rng.choice(alpha, (B, m_pad))
    ts = rng.choice(alpha, (B, n_pad))
    qs[np.arange(m_pad)[None, :] >= ms] = -1
    ts[np.arange(n_pad)[None, :] >= ns] = -2
    allow = (rng.random((B, n_pad)) > 0.1).astype(np.float32)
    pm = np.array([[2, 3, -4, -1, -7, 0, 0, 0]], np.float32)
    return qs, ts, allow, ns, ms, pm


def _ptr_equals_plain(mode, use_jump, rpb, m_pad, n_pad, args, shape):
    before = ptr.launches
    got = ptr._launch(mode, use_jump, m_pad, n_pad, rpb, args, shape)
    torch.cuda.synchronize()
    assert ptr.launches == before + 1
    want = ptr.ptr_fill_plain(mode, use_jump, m_pad, n_pad, *args, rpb)
    for name, g, w in zip(("score", "a", "b", "ptrs"), got, want):
        bad = (g != w).nonzero()
        assert torch.equal(g, w), (name, bad[:8].tolist(), len(bad))


@pytest.mark.parametrize("n_pad,threads,width", PTR_KERNEL_SHAPES)
@pytest.mark.parametrize("mode,use_jump,rpb", PTR_CASES)
def test_ptr_kernel_every_instance_equals_plain(cuda, mode, use_jump, rpb,
                                                n_pad, threads, width):
    """The kernel at thread counts from 32 to 512, n_pad up to the rows
    path's cap, every layout: score, a, b and every pointer byte."""
    arrs = _flat_inputs(71 + n_pad, n_pad=n_pad)
    _ptr_equals_plain(mode, use_jump, rpb, 64, n_pad,
                      convert.kernel_inputs_from_numpy(*arrs, cuda),
                      (threads, width))


@pytest.mark.parametrize("threads", [ptr.launch_shape(ptr_ties.N_PAD)[0],
                                     ptr.MAX_THREADS])
@pytest.mark.parametrize("mode,use_jump,rpb", PTR_CASES)
def test_ptr_kernel_on_ties_equals_plain(cuda, mode, use_jump, rpb, threads):
    """Start info that ties within a strip, across strips and across a
    warp boundary (tests/ptr_ties.py; held against the JAX package's kernel
    on the CPU), at the launch shape and with whole warps past n_pad: the
    once-reduced latches give the plain version's."""
    args = convert.kernel_inputs_from_numpy(
        *ptr_ties.tie_inputs(3), ptr_ties.pmat(mode), cuda)
    _ptr_equals_plain(mode, use_jump, rpb, ptr_ties.M_PAD, ptr_ties.N_PAD,
                      args, (threads, ptr.WIDTH))


@pytest.mark.parametrize("mode,use_jump,rpb", [
    ("global", False, 1), ("local", False, 2), ("fit", True, 1),
    ("overlap", False, 4)])
def test_ptr_kernel_more_ctas_than_resident(cuda, mode, use_jump, rpb):
    """5,000 pairs of one warp each: more CTAs than the card holds at once
    (32 an SM, 132 SMs)."""
    arrs = _flat_inputs(83, B=5000, n_pad=128)
    args = convert.kernel_inputs_from_numpy(*arrs, cuda)
    _ptr_equals_plain(mode, use_jump, rpb, 64, 128, args,
                      ptr.launch_shape(128))


WALK_CASES = walk_cases.flat_cases() + walk_cases.window_cases()


@pytest.mark.parametrize("tile_cols", [128, 256])
@pytest.mark.parametrize("case", WALK_CASES,
                         ids=lambda c: f"{c.name}-{c.mode}-rpb{c.rpb}")
def test_walk_kernel_on_drawn_cases(cuda, case, tile_cols, monkeypatch):
    """The walk kernel == plain (columns and all four scalars) on walks
    drawn across its tiles (tests/walk_cases.py), at its own 128-column
    tiles and at 256-column ones."""
    monkeypatch.setattr(device_tb, "TILE_COLS", tile_cols)
    ptrs, qs, ts, starts = (torch.from_numpy(x).to(cuda) for x in (
        case.ptrs, case.qs, case.ts, case.starts))
    before = device_tb.launches
    got = device_tb.walk(case.mode, case.rpb, ptrs, qs, ts, starts,
                         case.band)
    torch.cuda.synchronize()
    assert device_tb.launches == before + 1
    want = device_tb.walk_plain(case.mode, case.rpb, ptrs, qs, ts, starts,
                                case.band)
    for name, g, w in zip(("cols1", "cols2", "scal"), got, want):
        assert torch.equal(g, w), (name, (g != w).nonzero()[:4].tolist())


def test_walk_kernel_refusals_raise(cuda, monkeypatch):
    """No fallback on the card: pointer rows the kernel cannot copy in
    16-byte chunks, and a launch the kernel refuses, raise."""
    case = walk_cases.flat_cases()[0]
    ptrs, qs, ts, starts = (torch.from_numpy(x).to(cuda) for x in (
        case.ptrs, case.qs, case.ts, case.starts))
    before = (device_tb.launches, device_tb.plain_calls)
    with pytest.raises(ValueError, match="16-byte"):
        device_tb.walk(case.mode, case.rpb, ptrs[:, :, :1000].contiguous(),
                       qs, ts[:, :1000].contiguous(), starts)
    monkeypatch.setattr(device_tb, "TILE_COLS", 8)
    with pytest.raises(RuntimeError, match="launch failed"):
        device_tb.walk(case.mode, case.rpb, ptrs, qs, ts, starts)
    assert (device_tb.launches, device_tb.plain_calls) == before


def test_walk_behind_runs_on_the_walk_stream(cuda):
    """walk_behind queues the walk on the walk stream behind the current
    stream's work, and join_walks makes the current stream wait: the
    result equals plain while the current stream goes on with other
    work."""
    case = walk_cases.flat_cases()[1]
    ptrs, qs, ts, starts = (torch.from_numpy(x).to(cuda) for x in (
        case.ptrs, case.qs, case.ts, case.starts))
    extra = torch.arange(qs.shape[0], dtype=torch.int32, device=cuda)
    main = torch.cuda.current_stream()
    cols1, cols2, scal = device_tb.walk_behind(case.mode, case.rpb, ptrs, qs,
                                               ts, starts, ride=(extra,))
    assert torch.cuda.current_stream() == main
    busy = torch.randn(2048, 2048, device=cuda)
    for _ in range(8):
        busy = busy @ busy / 64
    device_tb.join_walks(cuda)
    want = device_tb.walk_plain(case.mode, case.rpb, ptrs, qs, ts, starts)
    assert torch.equal(cols1, want[0]) and torch.equal(cols2, want[1])
    assert torch.equal(scal, torch.cat([want[2], extra[None]]))


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


BLOCKED_SCORE_CASES = [("global", False), ("local", False), ("fit", False),
                       ("fit", True), ("overlap", False), ("edit", False)]
BLOCKED_PTR_CASES = [
    ("global", False, 1), ("local", False, 1), ("fit", True, 1),
    ("overlap", False, 1), ("global", False, 2), ("local", False, 2),
    ("fit", False, 2), ("overlap", False, 2), ("overlap", False, 4),
]


def _blocked_inputs(seed, c_blk, fit, B=8, m_pad=64, n_pad=16384):
    """Ragged pairs over several column blocks: one full pair, one target
    ending on a block edge, one inside the first block."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)
    ms = rng.integers(1, m_pad + 1, (B, 1)).astype(np.int32)
    ns = rng.integers(1, n_pad + 1, (B, 1)).astype(np.int32)
    ms[0], ns[0] = m_pad, n_pad
    ns[1:3, 0] = [c_blk, c_blk // 2 + 1][: B - 1]
    if fit:
        ns = np.maximum(ns, ms)
    qs = rng.choice(alpha, (B, m_pad))
    ts = rng.choice(alpha, (B, n_pad))
    qs[np.arange(m_pad)[None, :] >= ms] = -1
    ts[np.arange(n_pad)[None, :] >= ns] = -2
    allow = (rng.random((B, n_pad)) > 0.1).astype(np.float32)
    pm = np.array([[2, 3, -4, -1, -7, 0, 0, 0]], np.float32)
    return m_pad, n_pad, (qs, ts, allow, ns, ms, pm)


@pytest.mark.parametrize("c_blk",
                         sorted({128, 2048, 8192, select.blocked_c_blk()}))
@pytest.mark.parametrize("mode,use_jump", BLOCKED_SCORE_CASES)
def test_blocked_scores_kernel_equals_plain(cuda, mode, use_jump, c_blk):
    m_pad, n_pad, arrs = _blocked_inputs(13, c_blk, mode == "fit")
    qs, ts, allow, ns, ms, pm = convert.kernel_inputs_from_numpy(*arrs, cuda)
    before = blocked.launches["blocked_scores"]
    got = blocked.blocked_scores(mode, use_jump, m_pad, n_pad, c_blk, qs, ts,
                                 allow, ns, ms, pm)
    torch.cuda.synchronize()
    assert blocked.launches["blocked_scores"] == before + 1
    if mode == "fit":
        want = scan.fit_scores_plain(use_jump, m_pad, n_pad, qs, ts, allow,
                                     ns, ms, pm)
    else:
        want = scan.scores_plain(mode, m_pad, n_pad, qs, ts, ns, ms, pm)
    assert torch.equal(got, want), (got, want)


@pytest.mark.parametrize("c_blk",
                         sorted({128, 2048, 8192, select.blocked_c_blk()}))
@pytest.mark.parametrize("mode,use_jump,rpb", BLOCKED_PTR_CASES)
def test_blocked_ptr_kernel_equals_plain(cuda, mode, use_jump, rpb, c_blk):
    """Score, a, b and every pointer byte, pad rows and columns included."""
    m_pad, n_pad, arrs = _blocked_inputs(17, c_blk, mode == "fit")
    qs, ts, allow, ns, ms, pm = convert.kernel_inputs_from_numpy(*arrs, cuda)
    before = blocked.launches["blocked_ptr"]
    got = blocked.blocked_ptr_fill(mode, use_jump, m_pad, n_pad, c_blk, qs,
                                   ts, allow, ns, ms, pm, rpb)
    torch.cuda.synchronize()
    assert blocked.launches["blocked_ptr"] == before + 1
    want = ptr.ptr_fill_plain(mode, use_jump, m_pad, n_pad, qs, ts, allow,
                              ns, ms, pm, rpb)
    for name, g, w in zip(("score", "a", "b", "ptrs"), got, want):
        bad = (g != w).nonzero()
        assert torch.equal(g, w), (name, bad[:8].tolist(), len(bad))


# every blocked variant: ("scores", mode, jump, None) or ("ptr", mode, jump,
# rows per byte)
BLOCKED_CASES = ([("scores", m, j, None) for m, j in BLOCKED_SCORE_CASES]
                 + [("ptr", *c) for c in BLOCKED_PTR_CASES])


def _blocked_run(kind, mode, use_jump, rpb, m_pad, n_pad, c_blk, args,
                 plain=False):
    """The blocked kernel at ``c_blk`` (or, ``plain``, its plain version) as
    a tuple of outputs."""
    qs, ts, allow, ns, ms, pm = args
    if kind == "ptr":
        if plain:
            return ptr.ptr_fill_plain(mode, use_jump, m_pad, n_pad, qs, ts,
                                      allow, ns, ms, pm, rpb)
        return blocked.blocked_ptr_fill(mode, use_jump, m_pad, n_pad, c_blk,
                                        qs, ts, allow, ns, ms, pm, rpb)
    if not plain:
        return (blocked.blocked_scores(mode, use_jump, m_pad, n_pad, c_blk,
                                       qs, ts, allow, ns, ms, pm),)
    if mode == "fit":
        return (scan.fit_scores_plain(use_jump, m_pad, n_pad, qs, ts, allow,
                                      ns, ms, pm),)
    return (scan.scores_plain(mode, m_pad, n_pad, qs, ts, ns, ms, pm),)


def _blocked_equals_plain(kind, mode, use_jump, rpb, m_pad, n_pad, c_blk,
                          args):
    key = "blocked_ptr" if kind == "ptr" else "blocked_scores"
    before = blocked.launches[key]
    got = _blocked_run(kind, mode, use_jump, rpb, m_pad, n_pad, c_blk, args)
    torch.cuda.synchronize()
    assert blocked.launches[key] == before + 1
    want = _blocked_run(kind, mode, use_jump, rpb, m_pad, n_pad, c_blk, args,
                        plain=True)
    for name, g, w in zip(("score", "a", "b", "ptrs"), got, want):
        bad = (g != w).nonzero()
        assert torch.equal(g, w), (name, bad[:8].tolist(), len(bad))
    return got


@pytest.mark.parametrize("c_blk,n_pad", [(128, 4096), (1024, 16384)])
@pytest.mark.parametrize("kind,mode,use_jump,rpb", BLOCKED_CASES)
def test_blocked_wavefront_one_pair_many_blocks(cuda, kind, mode, use_jump,
                                                rpb, c_blk, n_pad):
    """B = 1 over 32 and 16 column blocks: the longest chain of waits,
    each block on the one before."""
    m_pad, _, arrs = _blocked_inputs(43, c_blk, mode == "fit", B=1,
                                     m_pad=256, n_pad=n_pad)
    _blocked_equals_plain(kind, mode, use_jump, rpb, m_pad, n_pad, c_blk,
                          convert.kernel_inputs_from_numpy(*arrs, cuda))


@pytest.mark.parametrize("kind,mode,use_jump,rpb", [
    ("scores", "fit", True, None), ("scores", "edit", False, None),
    ("ptr", "local", False, 2), ("ptr", "fit", True, 1),
    ("ptr", "overlap", False, 4)])
def test_blocked_wavefront_more_ctas_than_resident(cuda, kind, mode,
                                                   use_jump, rpb):
    """64 pairs over 128 blocks of 128 columns: 8,192 CTAs, more than the
    card holds at once (32 a SM, 132 SMs), so later tickets start only as
    earlier CTAs finish; no CTA may wait on one that has not started."""
    m_pad, n_pad, arrs = _blocked_inputs(47, 128, mode == "fit", B=64,
                                         m_pad=64, n_pad=16384)
    _blocked_equals_plain(kind, mode, use_jump, rpb, m_pad, n_pad, 128,
                          convert.kernel_inputs_from_numpy(*arrs, cuda))


@pytest.mark.parametrize("kind,mode,use_jump,rpb", BLOCKED_CASES)
def test_blocked_wavefront_relaunch_equal(cuda, kind, mode, use_jump, rpb):
    """Two launches on the same inputs give the same outputs: every launch
    starts from zeroed tickets, progress and done counters."""
    m_pad, n_pad, arrs = _blocked_inputs(53, 128, mode == "fit", B=8,
                                         m_pad=64, n_pad=2048)
    args = convert.kernel_inputs_from_numpy(*arrs, cuda)
    first = _blocked_equals_plain(kind, mode, use_jump, rpb, m_pad, n_pad,
                                  128, args)
    again = _blocked_run(kind, mode, use_jump, rpb, m_pad, n_pad, 128, args)
    torch.cuda.synchronize()
    for g, w in zip(again, first):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode,use_jump", BLOCKED_SCORE_CASES)
def test_blocked_scores_ragged_trailing_blocks(cuda, mode, use_jump):
    """Targets ending inside, on and one past block edges: the score
    fills' CTAs for blocks past n exit at once, and none waits on them."""
    c_blk, n_pad = 128, 2048
    m_pad, _, arrs = _blocked_inputs(59, c_blk, mode == "fit", B=8,
                                     m_pad=64, n_pad=n_pad)
    qs, ts, allow, ns, ms, pm = arrs
    ns[:, 0] = [1, 17, c_blk - 1, c_blk, c_blk + 1, 2 * c_blk + 5,
                n_pad - 1, n_pad]
    if mode == "fit":
        ms[:, 0] = np.minimum(ms[:, 0], ns[:, 0])
    qs[np.arange(m_pad)[None, :] >= ms] = -1
    ts[:] = np.where(np.arange(n_pad)[None, :] >= ns, -2,
                     np.where(ts < 0, ALPHA_I32[0], ts))
    _blocked_equals_plain("scores", mode, use_jump, None, m_pad, n_pad,
                          c_blk, convert.kernel_inputs_from_numpy(
                              qs, ts, allow, ns, ms, pm, cuda))


@pytest.mark.parametrize("c_blk", sorted({128, select.blocked_c_blk()}))
@pytest.mark.parametrize("kind,mode,use_jump,rpb", BLOCKED_CASES)
def test_blocked_kernels_on_ties_equal_plain(cuda, kind, mode, use_jump, rpb,
                                             c_blk):
    """Start-info candidates that tie across blocks (tests/blocked_ties.py;
    held against the JAX package's kernels on the CPU): the merge in block
    order keeps the plain version's."""
    arrs = ties.tie_inputs(c_blk, 61)
    _blocked_equals_plain(kind, mode, use_jump, rpb, ties.M_PAD,
                          ties.BLOCKS * c_blk, c_blk,
                          convert.kernel_inputs_from_numpy(*arrs, cuda))


@pytest.mark.parametrize("n_pad,c_blk", [
    (8576, 2048), (8576, 4096),
    (ptr.FLAT_REG_MAX_N_PAD + 128, select.blocked_c_blk())])
@pytest.mark.parametrize("mode,use_jump,rpb", BLOCKED_PTR_CASES)
def test_blocked_ptr_ragged_last_block_equals_plain(cuda, mode, use_jump,
                                                    rpb, n_pad, c_blk):
    """Flat n_pads that the column block does not divide: the last block
    is narrower, and every byte is the flat plain version's."""
    arrs = _flat_inputs(89, B=4, n_pad=n_pad)
    _blocked_equals_plain("ptr", mode, use_jump, rpb, 64, n_pad, c_blk,
                          convert.kernel_inputs_from_numpy(*arrs, cuda))


def test_rows_route_on_card_equals_cpu(cuda):
    """Rows of one bucket at the cap and one past it: the flat kernel and
    the blocked one each launched, the rows the CPU run's."""
    cap = ptr.FLAT_REG_MAX_N_PAD
    rng = np.random.default_rng(31)
    pairs = [(bytes(rng.choice(list(b"ACGT"), 300).tolist()),
              bytes(rng.choice(list(b"ACGT"), n).tolist()))
             for n in (cap - 5, cap + 100, cap - 300, cap + 60)]
    n_pads = {key[1] for key in tbatch._bucket_keys(pairs, 64, 128)}
    wide = sum(n > cap for n in n_pads)
    assert 0 < wide < len(n_pads)
    before = (ptr.launches, blocked.launches["blocked_ptr"])
    got = tbatch.align_batch("global", pairs, AlignParams(), traceback=True,
                             device="cuda")
    assert (ptr.launches, blocked.launches["blocked_ptr"]) == (
        before[0] + len(n_pads) - wide, before[1] + wide)
    assert got == tbatch.align_batch("global", pairs, AlignParams(),
                                     traceback=True, device="cpu")


def _long_pairs(seed, count=6, fit=False):
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(count):
        m = int(rng.integers(20, 200))
        lo, hi = (33000, 60000) if k % 2 == 0 else (m if fit else 1, 900)
        pairs.append((bytes(rng.choice(list(b"ACGT"), m).tolist()),
                      bytes(rng.choice(list(b"ACGT"), int(rng.integers(lo, hi)))
                            .tolist())))
    return pairs


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "fit-s",
                                  "edit"])
def test_long_targets_on_card_equal_cpu(cuda, mode):
    """A batch with targets past 32,768 columns (blocked fills) beside short
    ones (flat fills): scores and rows on the card equal the CPU run."""
    fit = mode.startswith("fit")
    pairs = _long_pairs(19, fit=fit)
    sites = None
    if fit:
        rng = np.random.default_rng(20)
        sites = [sorted(int(x) for x in rng.integers(0, len(t), 3))
                 for _, t in pairs]
    jmode = mode[:3] if fit else mode
    before = dict(blocked.launches)
    for traceback in (False,) if mode == "edit" else (False, True):
        got = tbatch.align_batch(jmode, pairs, AlignParams(), sites,
                                 traceback=traceback, device="cuda")
        want = tbatch.align_batch(jmode, pairs, AlignParams(), sites,
                                  traceback=traceback, device="cpu")
        assert got == want
    assert blocked.launches["blocked_scores"] > before["blocked_scores"]
    if mode != "edit":
        assert blocked.launches["blocked_ptr"] > before["blocked_ptr"]


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "fit", "edit"])
def test_empty_pairs_on_card_equal_cpu(cuda, mode):
    pairs = [(b"", b"ACGT"), (b"ACGTA", b"ACGTT"), (b"", b"")]
    if mode != "fit":
        pairs.append((b"ACG", b""))
    for traceback in (False, True):
        if mode == "fit" and traceback:
            pairs = pairs[:2]  # (b"", b"") has no traceback start
        got = tbatch.align_batch(mode, pairs, AlignParams(),
                                 traceback=traceback, device="cuda")
        assert got == tbatch.align_batch(mode, pairs, AlignParams(),
                                         traceback=traceback, device="cpu")


BANDED_VARIANTS = [("global", True), ("local", True), ("fit", True),
                   ("overlap", True), ("global", False), ("local", False),
                   ("fit", False), ("overlap", False), ("edit", False)]


def _banded_inputs(seed, band, fit, B=13, m_pad=96):
    """Ragged similar pairs in the banded kernel's layout: an empty query,
    a full-height one, |n - m| == band exactly, the rest within the band
    (fit: n >= m)."""
    rng = np.random.default_rng(seed)
    V = 2 * band + 1
    ms = rng.integers(0, m_pad + 1, B)
    ms[0], ms[1] = 0, m_pad
    ns = np.maximum(ms + rng.integers(-band, band + 1, B), 0)
    ns[2] = ms[2] + band
    if fit:
        ns = np.maximum(ns, ms)
    n_max = int(ns.max())
    qs = np.full((B, m_pad), -1, np.int32)
    te = np.full((B, band + max(n_max, m_pad) + V + 1), -2, np.int32)
    for k in range(B):
        q = rng.choice(ALPHA_I32, ms[k])
        t = np.concatenate([q, rng.choice(ALPHA_I32, max(0, ns[k] - ms[k]))])
        t = t[: ns[k]].copy()
        mut = rng.random(len(t)) < 0.05
        t[mut] = rng.choice(ALPHA_I32, int(mut.sum()))
        qs[k, : ms[k]] = q
        te[k, band : band + ns[k]] = t
    pm = np.array([[2, -3, -4, -1, 0, 0, 0, 0]], np.float32)
    return [torch.from_numpy(x).cuda() for x in (
        qs, te, ns[:, None].astype(np.int32), ms[:, None].astype(np.int32),
        pm)]


ALPHA_I32 = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)


@pytest.mark.parametrize("band", [1, 17, 128, 1000])
@pytest.mark.parametrize("mode,emit", BANDED_VARIANTS)
def test_banded_kernel_equals_plain(cuda, mode, emit, band):
    """best, edge (and a, b, every pointer byte, pad lanes included); at
    W = 1,000 the window's 2,001 lanes take the CTA path's team of sixteen
    4-lane warps, a cluster of two CTAs."""
    args = _banded_inputs(23 + band, band, mode == "fit")
    before = banded.launches
    fn = banded.banded_full if emit else banded.banded_scores
    plain = banded.banded_full_plain if emit else banded.banded_scores_plain
    got = fn(mode, band, *args)
    torch.cuda.synchronize()
    assert banded.launches == before + 1
    want = plain(mode, band, *args)
    for name, g, w in zip(("best", "edge", "a", "b", "ptrs"), got, want):
        bad = (g != w).nonzero()
        assert torch.equal(g, w), (name, bad[:8].tolist(), len(bad))


def _banded_equals_plain(mode, emit, band, args, shape=None):
    before = banded.launches
    got = banded._launch(mode, emit, band, *args, shape=shape)
    torch.cuda.synchronize()
    assert banded.launches == before + 1
    plain = banded.banded_full_plain if emit else banded.banded_scores_plain
    want = plain(mode, band, *args)
    for name, g, w in zip(("best", "edge", "a", "b", "ptrs"), got, want):
        if w is None:
            continue
        bad = (g != w).nonzero()
        assert torch.equal(g, w), (name, bad[:8].tolist(), len(bad))


# bands at each warp-path strip's widest window and one past it: W 79
# (S 5) and 80 (S 9), 143 and 144 (S 16), 255 (the widest warp) and 256
# (the CTA path); W 63 and 64 (S 5) put V one lane each side of 128
WARP_EDGE_BANDS = [63, 64, 79, 80, 143, 144, 255, 256]


@pytest.mark.parametrize("band", WARP_EDGE_BANDS)
@pytest.mark.parametrize("mode,emit", BANDED_VARIANTS)
def test_banded_kernel_at_strip_edges_equals_plain(cuda, mode, emit, band):
    """The band's own path (the warp path at any batch up to W 255): 13
    pairs (not a multiple of the 4 a CTA holds, so a CTA has spare warps)
    of ragged m, one CTA's warps running different row counts, at each
    strip's widest window and one lane past it."""
    _banded_equals_plain(mode, emit, band,
                         _banded_inputs(41 + band, band, mode == "fit"),
                         banded.launch_shape(band))


@pytest.mark.parametrize("band", [32, 128, 255])
@pytest.mark.parametrize("mode,emit", BANDED_VARIANTS)
def test_banded_kernel_fast_rows_equal_plain(cuda, mode, emit, band):
    """Pairs of up to 640 rows, so that most rows run the warp path's FAST
    instance (every lane at a column in [2, n]) between border rows."""
    _banded_equals_plain(mode, emit, band,
                         _banded_inputs(53 + band, band, mode == "fit", B=6,
                                        m_pad=640),
                         banded.launch_shape(band))


@pytest.mark.parametrize("band,edge", [(128, None), (256, None), (4096, 1024),
                                       (4096, 128)],
                         ids=["128", "256", "4096-cta", "4096-warp"])
@pytest.mark.parametrize("mode,emit", BANDED_VARIANTS)
def test_banded_kernel_on_ties_equals_plain(cuda, mode, emit, band, edge):
    """tests/banded_ties.py's pairs (held against the JAX routes on the
    CPU): ties on both sides of a strip edge, a warp edge and the band's
    last lane, end cells on them; W 128 the warp path, W 256 the CTA
    path's team of five warps, W 4,096 a cluster of nine CTAs of 8 warps,
    the tie across its CTA edge (lane 1,024) or a warp edge."""
    _, _, strip = banded.launch_shape(band)
    (qs, te, ns, ms), _ = banded_ties.tie_inputs(band, strip,
                                                 edge or 32 * strip, 7)
    pm = banded_ties.pmat("local" if mode == "edit" else mode)
    if mode == "edit":
        pm[0, 1] = 1.0  # the substitution cost
    args = [torch.from_numpy(x).cuda() for x in (qs, te, ns, ms, pm)]
    _banded_equals_plain(mode, emit, band, args, banded.launch_shape(band))


@pytest.mark.parametrize("mode,emit", [("local", True), ("overlap", True),
                                       ("global", False), ("edit", False)])
def test_banded_kernel_more_ctas_than_resident(cuda, mode, emit):
    """20,000 pairs, 5,000 CTAs of four warps: more than the card holds
    at once (16 such CTAs an SM, 132 SMs)."""
    _banded_equals_plain(mode, emit, 8,
                         _banded_inputs(43, 8, mode == "fit", B=20000,
                                        m_pad=16))


@pytest.mark.parametrize("mode,emit", [("local", True), ("edit", False)])
def test_banded_entry_refuses_a_shape_it_lacks(cuda, mode, emit):
    """No instance, no launch: a strip the warp path lacks, a warp too
    narrow for the window, a CTA too large, a strip the CTA path lacks,
    threads no whole number of teams, a cluster past 16 CTAs."""
    args = _banded_inputs(47, 128, False, B=4, m_pad=8)
    for shape in (("warp", 128, 8), ("warp", 128, 5), ("warp", 256, 9),
                  ("cta", 96, 9), ("cta", 128, 5), ("cta", 288, 16)):
        with pytest.raises(RuntimeError, match="banded fill kernel launch"):
            banded._launch(mode, emit, 128, *args, shape=shape)
    for band, shape in ((256, ("cta", 96, 16)), (8191, ("cta", 32, 16))):
        args = _banded_inputs(47, band, False, B=3, m_pad=8)
        with pytest.raises(RuntimeError, match="banded fill kernel launch"):
            banded._launch(mode, emit, band, *args, shape=shape)
    # a strip of 4 would hold W 8's 17 lanes, but the warp path has none
    args = _banded_inputs(47, 8, False, B=4, m_pad=8)
    with pytest.raises(RuntimeError, match="banded fill kernel launch"):
        banded._launch(mode, emit, 8, *args, shape=("warp", 128, 4))


# the CTA path at the bands only it serves: a team of 5 warps in a CTA (W
# 256), clusters of 2, 4 and 5 CTAs (W 1,000, 2,047, 2,048), of 16 at
# W 8,191, 8-lane ones past it (9 CTAs at W 8,192, 12 at 12,000), 16-lane
# ones at the one-pass width (16 CTAs at W 32,767), and past it in chunks:
# 2 a warp (9 CTAs at W 32,768, 10 at 40,000) and 4 (16 CTAs at 131,071)
CTA_BANDS = [256, 1000, 2047, 2048, 8191, 8192, 12000, 32767, 32768, 40000,
             131071]


@pytest.mark.parametrize("band", CTA_BANDS)
@pytest.mark.parametrize("mode,emit", BANDED_VARIANTS)
def test_banded_cta_path_equals_plain(cuda, mode, emit, band):
    """Ragged pairs (an empty query, |n - m| == W, rows past m) at the
    band's own launch, every variant bit-equal to plain; CTA launches
    counted, and past W 32,767 the chunked ones."""
    shape = banded.launch_shape(band)
    assert shape[0] == "cta"
    before = banded.launches_cta, banded.launches_chunked
    _banded_equals_plain(mode, emit, band, _banded_inputs(
        61 + band, band, mode == "fit", B=7 if band < 4096 else 4,
        m_pad=96 if band < 16384 else 48), shape)
    assert banded.launches_cta == before[0] + 1
    assert banded.launches_chunked == before[1] + (banded.chunks(band) > 1)


# (band, threads) at the CTA path's own edges: one warp a team, 8 pairs a
# CTA with a partial last CTA (13 pairs); two pairs a CTA (255); a CTA of 8
# warps (511) and a cluster of two one past it (512); clusters with pad
# warps (2,048: 5 x 7 warps for 33; 4,096: 9 x 8 for 65), of one-warp CTAs
# (256 at 32 threads: 5; 1,023 at 64: 8 CTAs of 2), of 8 and 9 CTAs
# (4,095 and 4,096: the portable size and one past), of 16 (8,191); the
# 8-lane and 16-lane strips from their first band (8,192, 16,384)
CTA_EDGES = [(20, None), (255, None), (256, 32), (511, None), (512, None),
             (600, 64), (1023, 64), (2048, None), (4095, None), (4096, None),
             (8191, None), (8192, None), (16384, None)]


@pytest.mark.parametrize("band,threads", CTA_EDGES)
@pytest.mark.parametrize("mode,emit", BANDED_VARIANTS)
def test_banded_cta_path_at_its_edges_equals_plain(cuda, mode, emit, band,
                                                   threads):
    _, own, strip = banded.cta_shape(band)
    shape = ("cta", threads or own, strip)
    banded.cta_geometry(band, shape[1], strip)  # an instance takes it
    _banded_equals_plain(mode, emit, band, _banded_inputs(
        67 + band, band, mode == "fit", B=13 if band < 4096 else 3,
        m_pad=96 if band < 4096 else 64), shape)


@pytest.mark.parametrize("band", [256, 1000])
@pytest.mark.parametrize("mode,emit", [("local", True), ("overlap", True),
                                       ("fit", False), ("edit", False)])
def test_banded_cta_path_more_ctas_than_resident(cuda, mode, emit, band):
    """5,000 pairs of ragged rows on teams sharing CTAs, long enough rows
    (640) for FAST rows on every warp between border rows."""
    _banded_equals_plain(mode, emit, band, _banded_inputs(
        71 + band, band, mode == "fit", B=5000 if band == 256 else 1200,
        m_pad=640), banded.launch_shape(band))


@pytest.mark.parametrize("mode", ["local", "fit", "overlap"])
def test_banded_score_auto_past_the_old_cap(cuda, mode):
    """An unrelated ~10,000-base pair: the band doubles past 8,191 (a
    cluster of CTAs) before it is certified (these modes' certificate is
    the perfect score, so the band grows to cover the matrix), and the
    score equals the unbanded route's."""
    from aligntools_tpu_torch.engine import banded as ebanded

    rng = np.random.default_rng(73)
    q = bytes(rng.choice(list(b"ACGT"), 9800).tolist())
    t = bytes(rng.choice(list(b"ACGT"), 10100).tolist())
    banded.reset_counts()
    score, band, cert = ebanded.banded_score_auto(mode, q, t, device="cuda")
    assert cert and band > 8191
    assert banded.launches_cta > 0 and banded.plain_calls == 0
    want = tbatch.batch_scores(mode, [(q, t)], AlignParams(), device="cuda")
    assert score == float(want[0])


@pytest.mark.parametrize("mode", ["local", "fit", "overlap"])
def test_banded_score_auto_past_the_one_pass_width(cuda, mode):
    """An unrelated 64 x 40,064 pair: the band doubles from 40,016 to
    cover the matrix (W 40,064, two chunks a warp); the score equals the
    unbanded route's, and (score, band, certified) the plain route's."""
    from aligntools_tpu_torch.engine import banded as ebanded

    rng = np.random.default_rng(83)
    q = bytes(rng.choice(list(b"ACGT"), 64).tolist())
    t = bytes(rng.choice(list(b"ACGT"), 40064).tolist())
    banded.reset_counts()
    got = ebanded.banded_score_auto(mode, q, t, device="cuda")
    assert got[1] == 40064 and got[2]
    assert banded.launches_chunked == 2 and banded.plain_calls == 0
    assert got == ebanded.banded_score_auto(mode, q, t, device="cpu")
    want = tbatch.batch_scores(mode, [(q, t)], AlignParams(), device="cuda")
    assert got[0] == float(want[0])


def uncapped_fasta(path, seed, pairs=4):
    """Reads of 200-400 bases (5% of them mutated) inside targets of
    40,100-40,500 bases, each read near the target's end: the diagonal
    offset ~40,000 - m fits a band of 40,000."""
    rng = np.random.default_rng(seed)
    lines = []
    for k in range(pairs):
        m = int(rng.integers(200, 401))
        q = rng.choice(list(b"ACGT"), m)
        r = q.copy()
        r[rng.random(m) < 0.05] = ord("A")
        t = np.concatenate([rng.choice(list(b"ACGT"), 40000 - m - int(
            rng.integers(0, 200))), r, rng.choice(list(b"ACGT"), 500)])
        lines += [f">q{k}", bytes(q.tolist()).decode(), f">t{k}",
                  bytes(t.tolist()).decode()]
    path.write_text("\n".join(lines) + "\n")


def test_batch_local_band_40000_on_card_equals_cpu(cuda, tmp_path):
    """`aligntools-torch batch local --band 40000` on reads inside targets
    past 40,000 bases: the fill in chunks (two a warp of a 10-CTA
    cluster's team), the window walk over 80,001-lane pointer rows; the
    TSV equals the same command's on --device cpu."""
    from aligntools_tpu_torch.cli import main

    fasta = tmp_path / "uncapped.fa"
    uncapped_fasta(fasta, 89)
    out = {}
    banded.reset_counts()
    for dev in ("cuda", "cpu"):
        out[dev] = tmp_path / f"{dev}.tsv"
        assert main(["batch", "local", str(fasta), "--band", "40000",
                     "--device", dev, "--out", str(out[dev])]) == 0
        if dev == "cuda":
            assert banded.launches_chunked > 0 and banded.plain_calls == 0
    assert out["cuda"].read_bytes() == out["cpu"].read_bytes()
    assert len(out["cuda"].read_bytes().splitlines()) == 4


def test_batch_local_band_9000_on_card_equals_cpu(cuda, tmp_path):
    """`aligntools-torch batch local --band 9000`: a cluster of CTAs a pair
    for the fill, the window walk over 18,001-lane pointer rows; the TSV
    equals the same command's on --device cpu."""
    from aligntools_tpu_torch.cli import main

    rng = np.random.default_rng(79)
    lines = []
    for k in range(4):
        m = int(rng.integers(1000, 2000))
        q = rng.choice(list(b"ACGT"), m)
        t = np.concatenate([rng.choice(list(b"ACGT"), int(rng.integers(
            0, 7000))), q, rng.choice(list(b"ACGT"), 500)])
        t[rng.random(len(t)) < 0.05] = ord("A")
        lines += [f">q{k}", bytes(q.tolist()).decode(), f">t{k}",
                  bytes(t.tolist()).decode()]
    fasta = tmp_path / "wide.fa"
    fasta.write_text("\n".join(lines) + "\n")
    out = {}
    banded.reset_counts()
    for dev in ("cuda", "cpu"):
        out[dev] = tmp_path / f"{dev}.tsv"
        assert main(["batch", "local", str(fasta), "--band", "9000",
                     "--device", dev, "--out", str(out[dev])]) == 0
        if dev == "cuda":
            assert banded.launches_cta > 0 and banded.plain_calls == 0
    assert out["cuda"].read_bytes() == out["cpu"].read_bytes()
    assert len(out["cuda"].read_bytes().splitlines()) == 4


@pytest.mark.parametrize("m_pad", [0, 1])
@pytest.mark.parametrize("mode,emit", [("local", True), ("overlap", True),
                                       ("edit", False)])
def test_banded_kernel_on_flat_slabs(cuda, mode, emit, m_pad):
    args = _banded_inputs(29, 8, False, B=5, m_pad=m_pad)
    fn = banded.banded_full if emit else banded.banded_scores
    plain = banded.banded_full_plain if emit else banded.banded_scores_plain
    got = fn(mode, 8, *args)
    torch.cuda.synchronize()
    for g, w in zip(got, plain(mode, 8, *args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("band", [17, 128])
@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_banded_walk_kernel_equals_plain(cuda, mode, band):
    """The window walk on the kernel's pointers, and on pointers that send
    every walk out of the band."""
    qs, te, ns, ms, pm = _banded_inputs(31, band, mode == "fit")
    best, edge, a, b, ptrs = banded.banded_full(mode, band, qs, te, ns, ms,
                                                pm)
    starts = device_tb.walk_starts(mode, best, a, b, ms, ns)
    for p in (ptrs, torch.full_like(ptrs, 0x02 if mode == "overlap"
                                    else 0x00)):
        before = device_tb.launches
        wk = device_tb.walk(mode, 1, p, qs, te, starts, band)
        torch.cuda.synchronize()
        assert device_tb.launches == before + 1
        wp = device_tb.walk_plain(mode, 1, p, qs, te, starts, band)
        for name, g, w in zip(("cols1", "cols2", "scal"), wk, wp):
            assert torch.equal(g, w), name


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap",
                                  "edit"])
def test_banded_engine_on_card_equals_cpu(cuda, mode, monkeypatch):
    """Scores and rows of similar pairs (and empty sequences) on the card
    equal the CPU run, in groups of 16, and a CUDA tensor never reaches a
    plain version."""
    from aligntools_tpu_torch.engine import banded as ebanded

    monkeypatch.setattr(ebanded, "GROUP_PAIRS_MIN", 16)
    rng = np.random.default_rng(37)
    pairs = []
    for _ in range(40):
        q = bytes(rng.choice(list(b"ACGT"), int(rng.integers(50, 400)))
                  .tolist())
        t = bytearray(q)
        for _ in range(len(t) // 50):
            t[int(rng.integers(0, len(t)))] = int(rng.choice(list(b"ACGT")))
        pairs.append((q, bytes(t) + b"ACGT"[: int(rng.integers(0, 4))]))
    pairs += [(b"", b"AC"), (b"", b"")]
    band = 32
    banded.reset_counts()
    device_tb.reset_counts()
    got_s = ebanded.banded_batch_scores(mode, pairs, band, device="cuda")
    got_r = (ebanded.banded_align_batch(mode, pairs[:-2], band,
                                        device="cuda")
             if mode != "edit" else None)
    assert banded.plain_calls == 0 and device_tb.plain_calls == 0
    assert banded.launches > 1
    want_s = ebanded.banded_batch_scores(mode, pairs, band, device="cpu")
    for g, w in zip(got_s, want_s):
        assert np.array_equal(g, w)
    if got_r is not None:
        want_r = ebanded.banded_align_batch(mode, pairs[:-2], band,
                                            device="cpu")
        assert got_r[0] == want_r[0]
        assert np.array_equal(got_r[1], want_r[1])


# the probe's JAX shapes at a short chain, and an odd element count (the
# packed forms' scalar tail)
PROBE_SHAPES = [(64, 2048), (7, 13)]


@pytest.mark.parametrize("shape", PROBE_SHAPES, ids=str)
@pytest.mark.parametrize("dtype,form,width", vpu_probe.VARIANTS, ids=str)
def test_probe_kernel_equals_plain(cuda, dtype, form, width, shape):
    tdt = vpu_probe.DTYPES[dtype][0]
    rng = np.random.default_rng(41)
    a = torch.from_numpy(rng.integers(-8, 9, shape)).to(cuda, tdt)
    b = torch.from_numpy(rng.integers(-8, 9, shape)).to(cuda, tdt)
    key = "probe_chain" if width == 1 else "probe_ilp"
    before = vpu_probe.launches[key]
    got = vpu_probe.chain(a, b, 64, width, form)
    torch.cuda.synchronize()
    assert vpu_probe.launches[key] == before + 1
    want = vpu_probe.chain_plain(a, b, 64, width)
    assert got.dtype == tdt and torch.equal(got, want)


def test_probe_kernel_refuses_what_it_lacks(cuda):
    x = torch.zeros((4, 8), dtype=torch.int16, device=cuda)
    for dtype, form, width in (("int16", "x2", 8), ("int16", "dpx", 1),
                               ("int16", "plain", 4)):
        with pytest.raises(ValueError, match="no kernel variant"):
            vpu_probe.chain(x, x, 3, width, form)
    with pytest.raises(ValueError, match="unsupported dtype"):
        vpu_probe.chain(x.half(), x.half(), 3, 1)
    with pytest.raises(ValueError, match="4-byte aligned"):
        vpu_probe.chain(x.view(-1)[1:], x.view(-1)[1:], 3, 8, "dpx")
    # the C entry point refuses an uninstantiated (dtype, form, width)
    lib = vpu_probe._kernel()
    stream = torch.cuda.current_stream().cuda_stream
    assert lib.at_vpu_chain(2, 2, 8, x.data_ptr(), x.data_ptr(),
                            x.data_ptr(), x.numel(), 3, stream) != 0


def test_probe_main_quick_on_card(cuda, capsys):
    assert vpu_probe.main(["--quick"]) == 0
    out = capsys.readouterr().out
    assert out.count("Tops/s") == 4 + 7  # elementwise dtypes, roofline forms
    assert "exact=True" in out


def _single_pair(seed, m, n, alphabet=b"ACGT"):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(alphabet, dtype=np.uint8)
    return (alpha[rng.integers(0, len(alpha), m)].tobytes(),
            alpha[rng.integers(0, len(alpha), n)].tobytes())


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap",
                                  "edit"])
def test_align_pair_on_card_equals_cpu(cuda, mode):
    """api.align_pair on the card against its CPU route: a short pair, a
    tie-heavy binary one, one past ops/ptr.FLAT_REG_MAX_N_PAD columns (the
    blocked pointer fill) and, for edit, one past its score fill's cap
    (the blocked score fill); fit with and without sites."""
    from aligntools_tpu_torch import api

    wide = ptr.FLAT_REG_MAX_N_PAD + 700
    cases = [_single_pair(1, 300, 2000), _single_pair(2, 150, 400, b"AC"),
             _single_pair(3, 200, wide)]
    if mode == "edit":
        cases.append(_single_pair(4, 100, scan.flat_cap("edit") + 300))
    before = ({**scan.launches, **blocked.launches}, ptr.launches,
              device_tb.launches)
    for q, t in cases:
        for sites in ((None, [5, 17, 17, len(t) + 3]) if mode == "fit"
                      else (None,)):
            got = api.align_pair(mode, q, t, AlignParams(), sites,
                                 device="cuda")
            want = api.align_pair(mode, q, t, AlignParams(), sites,
                                  device="cpu")
            assert got == want and type(got) is type(want)
    if mode == "edit":
        assert scan.launches["edit"] > before[0]["edit"]
        assert blocked.launches["blocked_scores"] > before[0][
            "blocked_scores"]
    else:
        assert ptr.launches > before[1] and device_tb.launches > before[2]
        assert blocked.launches["blocked_ptr"] > before[0]["blocked_ptr"]


@pytest.mark.parametrize("args", [
    ("global", "test_global.fa"), ("local", "test_local.fa"),
    ("overlap", "test_overlap.fa"), ("edit", "-u", "1", "test_edit.fa"),
    ("fit", "-m", "2", "-u", "-2", "-s", "test_fit.fa")], ids=" ".join)
def test_per_mode_cli_on_card_equals_cpu(cuda, capsys, monkeypatch, args):
    from aligntools_tpu_torch.cli import main

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "test", args[-1])
    outs = []
    for device in (None, "cpu"):  # unset: the card
        if device is None:
            monkeypatch.delenv("ALIGNTOOLS_DEVICE", raising=False)
        else:
            monkeypatch.setenv("ALIGNTOOLS_DEVICE", device)
        assert main([*args[:-1], path]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] and outs[0] == outs[1]


# the checkpoint-rescan instances (variant, S): rpb 1 at S 8 (and fit+jump),
# 2 at S 16, overlap's 4 at S 32
RESCAN_CASES = [("global", 8), ("global", 16), ("local", 16), ("fit", 16),
                ("fit+jump", 8), ("fit+jump", 16), ("overlap", 16),
                ("overlap", 32)]


@pytest.mark.parametrize("c_blk", [128, 2048])
@pytest.mark.parametrize("variant,S", RESCAN_CASES)
def test_ckpt_and_refill_kernels_equal_plain(cuda, variant, S, c_blk):
    """The checkpoint forward (score, a, b, every checkpoint float) and the
    refill of every row block (every pointer byte) against their plain
    versions, over several column blocks with a ragged last one (n_pad
    2,096), and the refills against the whole-matrix pointer fill; then the
    paused walk against plain on each refilled block."""
    from aligntools_tpu_torch import layout

    mode, jump = variant.split("+")[0], variant.endswith("+jump")
    m_pad, n_pad, arrs = _blocked_inputs(41, c_blk, mode == "fit", B=3,
                                         m_pad=4 * S, n_pad=2096)
    qs, ts, allow, ns, ms, pm = convert.kernel_inputs_from_numpy(*arrs, cuda)
    allow = allow if jump else None
    rpb = layout.rows_per_byte(mode, jump, S)
    before = dict(blocked.launches)
    got = blocked.blocked_ckpt_fill(mode, jump, S, m_pad, n_pad, c_blk, qs,
                                    ts, allow, ns, ms, pm)
    torch.cuda.synchronize()
    want = ptr.ptr_fill_plain(mode, jump, m_pad, n_pad, qs, ts, allow, ns,
                              ms, pm, stride=S)
    for name, g, w in zip(("score", "a", "b", "cks"), got, want):
        assert torch.equal(g, w), name
    whole = ptr.ptr_fill_plain(mode, jump, m_pad, n_pad, qs, ts, allow, ns,
                               ms, pm, rpb)[3]
    rng = np.random.default_rng(42)
    for k in range(m_pad // S):
        ck = got[3][:, k].contiguous()
        q_blk = qs[:, k * S : (k + 1) * S].contiguous()
        ptrs = blocked.blocked_refill(mode, jump, S, n_pad, c_blk, ck, k * S,
                                      q_blk, ts, allow, ns, ms, pm, rpb)
        torch.cuda.synchronize()
        plain = ptr.ptr_fill_plain(mode, jump, S, n_pad, q_blk, ts, allow,
                                   ns, ms, pm, rpb, seed=ck, i0=k * S)
        assert torch.equal(ptrs, plain), k
        r = S // rpb
        assert torch.equal(ptrs, whole[:, k * r : (k + 1) * r]), k
        states = ([0] if mode == "overlap" else [0, 1, 2] + [3] * jump)
        starts = torch.tensor(np.stack([
            rng.choice(states, 3), np.full(3, S),
            rng.integers(1, n_pad + 1, 3)]).astype(np.int32), device=cuda)
        wk = device_tb.walk(mode, rpb, ptrs, q_blk, ts, starts, pause=True)
        torch.cuda.synchronize()
        wp = device_tb.walk_plain(mode, rpb, ptrs, q_blk, ts, starts,
                                  pause=True)
        for name, g, w in zip(("cols1", "cols2", "scal"), wk, wp):
            assert torch.equal(g, w), (k, name)
    assert blocked.launches["blocked_ckpt"] == before["blocked_ckpt"] + 1
    assert blocked.launches["blocked_refill"] == (
        before["blocked_refill"] + m_pad // S)


@pytest.mark.parametrize("case", walk_cases.flat_cases(),
                         ids=lambda c: f"{c.name}-{c.mode}-rpb{c.rpb}")
def test_paused_walk_kernel_on_drawn_cases(cuda, case):
    """The walk kernel's pause (row 0 stops the walk; the fifth scalar is
    the final state) against plain on tests/walk_cases.py's flat walks."""
    ptrs, qs, ts, starts = (torch.from_numpy(x).to(cuda) for x in (
        case.ptrs, case.qs, case.ts, case.starts))
    got = device_tb.walk(case.mode, case.rpb, ptrs, qs, ts, starts,
                         pause=True)
    torch.cuda.synchronize()
    want = device_tb.walk_plain(case.mode, case.rpb, ptrs, qs, ts, starts,
                                pause=True)
    assert got[2].shape[0] == 5
    for name, g, w in zip(("cols1", "cols2", "scal"), got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_forced_rescan_through_align_batch(cuda, monkeypatch, mode):
    """A budget below one pair's pointer bytes sends the pairs through the
    rescan on the card: the rows equal the normal route's on the card and
    the rescan's on the CPU; the rescan's kernels launched."""
    from aligntools_tpu_torch.engine import rescan

    rng = np.random.default_rng(43)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    pairs, sites = [], []
    for m, n in ((300, 2500), (77, 9000), (513, 4100)):
        pairs.append((alpha[rng.integers(0, 4, m)].tobytes(),
                      alpha[rng.integers(0, 4, n)].tobytes()))
        sites.append([5, n // 2, n - 7])
    s = sites if mode == "fit" else None
    p = AlignParams()
    want = tbatch.align_batch(mode, pairs, p, s, traceback=True, device=cuda)
    monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET", "20000")
    before = (dict(blocked.launches), device_tb.launches)
    got = tbatch.align_batch(mode, pairs, p, s, traceback=True, device=cuda)
    torch.cuda.synchronize()
    assert blocked.launches["blocked_ckpt"] == before[0]["blocked_ckpt"] + 3
    assert blocked.launches["blocked_refill"] > before[0]["blocked_refill"]
    assert device_tb.launches > before[1]
    for g, w in zip(got, want):
        assert (g.score, g.row1, g.row2) == (w.score, w.row1, w.row2)
    q, t = pairs[1]
    cpu = rescan.rescan_align(mode, q, t, p, s[1] if s else None, stride=32,
                              device="cpu")
    assert (cpu.score, cpu.row1, cpu.row2) == (got[1].score, got[1].row1,
                                               got[1].row2)


# ---------------------------------------------------------------------------
# The double instances: a single pair past float32's exact integers
# ---------------------------------------------------------------------------

# odd params near 2^20: every pair below passes 2^24 (max|param| * (m+n+1))
BIG = AlignParams(match=1048573, mismatch=-1048571, gap_open=-3145739,
                  gap_extend=-1048577, jump=-2097143)


def _double_args(seed, B, m_pad, n_pad, cuda):
    (m_pad, n_pad), arrs = _inputs(seed, B, m_pad, n_pad)
    qs, ts, allow, ns, ms, _ = convert.kernel_inputs_from_numpy(*arrs, cuda)
    pm = convert.params_matrix(BIG, cuda, torch.float64)
    return qs, ts, allow, ns, ms, pm


PTR_LAYOUTS = [("global", False, 1), ("global", False, 2),
               ("local", False, 1), ("local", False, 2), ("fit", False, 1),
               ("fit", False, 2), ("fit", True, 1), ("overlap", False, 1),
               ("overlap", False, 2), ("overlap", False, 4)]


@pytest.mark.parametrize("n_pad", [128, 1040, ptr.FLAT64_MAX_N_PAD])
@pytest.mark.parametrize("mode,use_jump,rpb", PTR_LAYOUTS, ids=str)
def test_double_ptr_kernel_equals_plain(cuda, mode, use_jump, rpb, n_pad):
    """The flat pointer fill's double instance (W 8) against the float64
    plain version at 32 to 512 threads, ragged pairs, m = n = 1 among
    them."""
    qs, ts, allow, ns, ms, pm = _double_args(11, 16, 64, n_pad, cuda)
    allow = allow if use_jump else None
    before = (ptr.launches64, ptr.launches)
    got = ptr.ptr_fill(mode, use_jump, 64, n_pad, qs, ts, allow, ns, ms, pm,
                       rpb)
    torch.cuda.synchronize()
    want = ptr.ptr_fill_plain(mode, use_jump, 64, n_pad, qs, ts, allow, ns,
                              ms, pm, rpb)
    assert got[0].dtype == torch.float64
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (ptr.launches64, ptr.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("n_pad", [128, 4224, 8192])
def test_double_edit_kernel_equals_plain(cuda, n_pad):
    qs, ts, _, ns, ms, _ = _double_args(13, 8, 64, n_pad, cuda)
    pm = convert.params_matrix(AlignParams(mismatch=-16777217), cuda,
                               torch.float64)
    before = scan.launches64
    got = scan.scores("edit", 64, n_pad, qs, ts, ns, ms, pm)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64
    assert torch.equal(got, scan.scores_plain("edit", 64, n_pad, qs, ts, ns,
                                              ms, pm))
    assert scan.launches64 == before + 1


@pytest.mark.parametrize("c_blk", [128, 2048, blocked.C_BLK_MAX64])
@pytest.mark.parametrize("mode,use_jump,rpb", [
    ("global", False, 2), ("local", False, 1), ("fit", True, 1),
    ("fit", False, 2), ("overlap", False, 4)], ids=str)
def test_double_blocked_kernels_equal_plain(cuda, mode, use_jump, rpb,
                                            c_blk):
    """The blocked pointer fill's double FILL, CKPT and SEED instances and
    edit's double blocked score fill against the float64 plain versions, a
    ragged last block among them."""
    n_pad, S = 9216 + 128, 32
    qs, ts, allow, ns, ms, pm = _double_args(17, 3, 64, n_pad, cuda)
    allow = allow if use_jump else None
    got = blocked.blocked_ptr_fill(mode, use_jump, 64, n_pad, c_blk, qs, ts,
                                   allow, ns, ms, pm, rpb)
    torch.cuda.synchronize()
    want = ptr.ptr_fill_plain(mode, use_jump, 64, n_pad, qs, ts, allow, ns,
                              ms, pm, rpb)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    fwd = blocked.blocked_ckpt_fill(mode, use_jump, S, 64, n_pad, c_blk, qs,
                                    ts, allow, ns, ms, pm)
    torch.cuda.synchronize()
    want = ptr.ptr_fill_plain(mode, use_jump, 64, n_pad, qs, ts, allow, ns,
                              ms, pm, stride=S)
    for g, w in zip(fwd, want):
        assert torch.equal(g, w)
    ck = want[3][:, 1].contiguous()
    q_blk = qs[:, S : 2 * S].contiguous()
    got = blocked.blocked_refill(mode, use_jump, S, n_pad, c_blk, ck, S,
                                 q_blk, ts, allow, ns, ms, pm, rpb)
    torch.cuda.synchronize()
    assert torch.equal(got, ptr.ptr_fill_plain(
        mode, use_jump, S, n_pad, q_blk, ts, allow, ns, ms, pm, rpb,
        seed=ck, i0=S))
    pe = convert.params_matrix(AlignParams(mismatch=-16777217), cuda,
                               torch.float64)
    got = blocked.blocked_scores("edit", False, 64, n_pad, c_blk, qs, ts,
                                 None, ns, ms, pe)
    torch.cuda.synchronize()
    assert torch.equal(got, scan.scores_plain("edit", 64, n_pad, qs, ts, ns,
                                              ms, pe))


def test_double_instances_refuse_what_they_lack(cuda):
    qs, ts, allow, ns, ms, pm = _double_args(19, 2, 64, 4224, cuda)
    with pytest.raises(ValueError, match="blocked fill"):
        ptr.launch_shape(ptr.FLAT64_MAX_N_PAD + 128, torch.float64)
    with pytest.raises(ValueError, match="no kernel instance"):
        ptr._launch("local", False, 64, 1024, 1, (qs, ts[:, :1024], None, ns,
                                                  ms, pm), (64, 16))
    with pytest.raises(ValueError, match="no double-precision instance"):
        scan.scores("global", 64, 1024, qs, ts[:, :1024].contiguous(), ns,
                    ms, pm)
    with pytest.raises(ValueError, match="C_BLK_MAX64"):
        blocked.blocked_ptr_fill("local", False, 64, 4224, 8192, qs, ts,
                                 None, ns, ms, pm, 1)


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap",
                                  "edit"])
def test_align_pair_past_f32_on_card_equals_cpu(cuda, mode, monkeypatch):
    """api.align_pair past float32's range on the card against its CPU
    route (the float64 plain versions, which tests/test_torch_exact64.py
    holds against the JAX spec engine): a flat pair, one past the double
    pointer fill's cap (the blocked fill; edit past its own) and, but for
    edit, one through the rescan under a small ALIGNTOOLS_HBM_BUDGET."""
    from aligntools_tpu_torch import api

    wide = (scan.flat_cap("edit", torch.float64) if mode == "edit"
            else ptr.FLAT64_MAX_N_PAD) + 700
    cases = [_single_pair(21, 300, 2000), _single_pair(22, 200, wide)]
    before = (ptr.launches, dict(blocked.launches), dict(scan.launches))
    for q, t in cases:
        got = api.align_pair(mode, q, t, BIG, device="cuda")
        assert got == api.align_pair(mode, q, t, BIG, device="cpu")
    if mode != "edit":
        q, t = cases[0]
        monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET", "200000")
        got = api.align_pair(mode, q, t, BIG, device="cuda")
        monkeypatch.delenv("ALIGNTOOLS_HBM_BUDGET")
        assert got == api.align_pair(mode, q, t, BIG, device="cpu")
        assert blocked.launches["blocked_ckpt64"] > before[1][
            "blocked_ckpt64"]
    # no float32 instance ran
    assert ptr.launches == before[0] and scan.launches == before[2]
    assert all(blocked.launches[k] == before[1][k] for k in
               ("blocked_scores", "blocked_ptr", "blocked_ckpt",
                "blocked_refill"))


def test_calibrate_on_card(cuda, tmp_path, monkeypatch):
    """calibrate(force=True) measures every key on the card in under 60 s
    and writes a valid table, with its timings, under the cache
    directory; the routes read it from then on."""
    from aligntools_tpu_torch.engine import autotune, select

    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path))
    was = autotune.set_table(None)
    try:
        lines = []
        t = autotune.calibrate(force=True, log=lines.append)
        path = autotune.cache_path(torch.cuda.get_device_name(0))
        assert os.path.exists(path) and t["seconds"] < 60
        assert set(t["measured"]) == set(autotune.DEFAULTS)
        for key, value in autotune._leaves(t):
            assert select.problem(key, value) is None, key
        assert autotune.calibrate(log=lines.append) == t  # cached
    finally:
        autotune.set_table(was)


# ---------------------------------------------------------------------------
# The EDGE phase of the blocked fills and the column-paused walk
# (parallel/seqpar.py)
# ---------------------------------------------------------------------------

EDGE_VARIANTS = ["global", "local", "fit", "fit+jump", "overlap", "edit"]
INT32 = 2**31 - 1


def _edge_inputs(mode, jump, kind, col0, seed, B=5, R=40, i0=64, n_loc=1040):
    """One chunk's inputs on the CPU: pairs whose m and n fall before,
    inside and past the chunk's rows and the slice's columns, and top rows
    and left edges of random integers (-inf among them)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)
    ms = rng.integers(i0 - 4, i0 + R + 6, (B, 1)).astype(np.int32)
    ns = rng.integers(max(1, col0 - 8), col0 + n_loc + 24, (B, 1)).astype(
        np.int32)
    qs = rng.choice(alpha, (B, R))
    qs[np.arange(R)[None, :] + i0 >= ms] = -1
    ts = rng.choice(alpha, (B, n_loc))
    ts[np.arange(n_loc)[None, :] + col0 >= ns] = -2
    allow = (rng.random((B, n_loc)) > 0.1).astype(np.float32)
    n_top = (scan.EDGE_TOP[mode] if kind == "scores"
             else ptr.TOP_STATES[mode])
    n_edge = (scan.edge_states(mode, jump) if kind == "scores"
              else ptr.edge_states(mode, jump))
    dt = np.int32 if mode == "edit" else np.float32
    top = rng.integers(-60, 60, (B, n_top, n_loc)).astype(dt)
    ledge = rng.integers(-60, 60, (B, n_edge, R + 1)).astype(dt)
    if mode != "edit":
        top[rng.random(top.shape) < 0.05] = -np.inf
        ledge[rng.random(ledge.shape) < 0.05] = -np.inf
    pm = np.array([[2, -3, -4, -1, -7, 0, 0, 0]], np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(qs), t(ts), t(allow) if jump else None, t(ns), t(ms), t(pm),
            t(top), t(ledge))


@pytest.mark.parametrize("col0", [0, 2048])
@pytest.mark.parametrize("variant", EDGE_VARIANTS)
def test_edge_score_kernel_equals_plain(cuda, variant, col0):
    """The EDGE instance of each score fill against its plain version on
    one chunk of a ragged slice (five column blocks of 256, the last 16
    wide): the bottom state rows, the right edge and the candidate."""
    mode, jump = variant.split("+")[0], variant.endswith("+jump")
    i0 = 64
    args = _edge_inputs(mode, jump, "scores", col0, 11, i0=i0)
    acc0 = torch.tensor([5, -3, 0, INT32 if mode == "edit" else -1, 7],
                        dtype=scan.edge_dtype(mode))
    if mode != "edit":
        acc0[3] = float("-inf")
    outs = []
    for dev in (cuda, torch.device("cpu")):
        acc = acc0.clone().to(dev)
        before = blocked.launches["edge_scores"]
        bottom, redge = blocked.edge_scores(
            mode, jump, col0, i0, 256, *(None if x is None else x.to(dev)
                                         for x in args), acc)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert blocked.launches["edge_scores"] == before + 1
        outs.append([x.cpu() for x in (bottom, redge, acc)])
    for got, want in zip(*outs):
        assert torch.equal(got, want)


EDGE_PTR_VARIANTS = [("global", False, 1), ("global", False, 2),
                     ("local", False, 2), ("fit", False, 2),
                     ("fit", True, 1), ("overlap", False, 4),
                     ("overlap", False, 1)]


@pytest.mark.parametrize("col0", [0, 2048])
@pytest.mark.parametrize("mode,jump,rpb", EDGE_PTR_VARIANTS)
def test_edge_ptr_kernel_equals_plain(cuda, mode, jump, rpb, col0):
    """The EDGE instance of each pointer fill against its plain version on
    one chunk: the chunk's pointer bytes in the slab (the rows around them
    untouched), the bottom state rows, the right edge and the start
    candidate."""
    i0, R = 64, 64
    args = _edge_inputs(mode, jump, "ptr", col0, 13, R=R, i0=i0)
    B, n_loc = args[1].shape
    cand0 = torch.tensor([[torch.tensor(3.0).view(torch.int32).item(), 70,
                           2100, 0]] * B, dtype=torch.int32)
    cand0[1, 0] = torch.tensor(float("-inf")).view(torch.int32)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        slab = torch.full((B, (i0 + R) // rpb + 8, n_loc), 0xAB,
                          dtype=torch.uint8, device=dev)
        cand = cand0.clone().to(dev)
        before = blocked.launches["edge_ptr"]
        bottom, redge = blocked.edge_ptr_fill(
            mode, jump, col0, i0, 256, *(None if x is None else x.to(dev)
                                         for x in args), cand, slab, rpb)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert blocked.launches["edge_ptr"] == before + 1
        outs.append([x.cpu() for x in (slab, bottom, redge, cand)])
    for got, want in zip(*outs):
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode,rpb", [("global", 1), ("global", 2),
                                      ("local", 2), ("fit", 1), ("fit", 2),
                                      ("overlap", 4), ("overlap", 1)])
def test_col_paused_walk_kernel_equals_plain(cuda, mode, rpb):
    """The column-paused walk against its plain version on a rank's slab of
    a whole fill's pointers (the slice past column 272 of a 64 x 1,024
    fill), from starts all over the slab, tiles of 128 columns."""
    (m_pad, n_pad), arrs = _inputs(17, B=12, m_pad=64, n_pad=1024)
    qs, ts, allow, ns, ms, pm = convert.kernel_inputs_from_numpy(
        *arrs, torch.device("cpu"))
    _, _, _, ptrs = ptr.ptr_fill_plain(mode, False, m_pad, n_pad, qs, ts,
                                       allow, ns, ms, pm, rpb)
    col0, n_loc = 272, 512
    slab = ptrs[:, :, col0 : col0 + n_loc].contiguous()
    tloc = ts[:, col0 : col0 + n_loc].contiguous()
    rng = np.random.default_rng(5)
    starts = torch.tensor(np.stack([
        rng.integers(0, 3 if mode != "overlap" else 1, 12),
        rng.integers(0, m_pad + 1, 12),
        rng.integers(col0 + 1, col0 + n_loc + 1, 12)]), dtype=torch.int32)
    want = device_tb.walk_plain(mode, rpb, slab, qs, tloc, starts, col0=col0)
    before = device_tb.col_pause_launches
    got = device_tb.walk(mode, rpb, slab.to(cuda), qs.to(cuda),
                         tloc.to(cuda), starts.to(cuda), col0=col0)
    torch.cuda.synchronize()
    assert device_tb.col_pause_launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap",
                                  "edit"])
def test_seqpar_loopback_kernels_equal_plain(cuda, mode):
    """seqpar_score, seqpar_batch_scores and seqpar_align in loopback over
    three slices on the card's kernels equal their CPU run (the plain
    versions), and the single-device route."""
    from aligntools_tpu_torch.parallel import seqpar

    rng = np.random.default_rng(21)
    pairs = []
    for _ in range(3):
        m = int(rng.integers(40, 300))
        n = int(rng.integers(m, 3000))
        pairs.append((bytes(rng.choice(list(b"ACGT"), m).tolist()),
                      bytes(rng.choice(list(b"ACGT"), n).tolist())))
    p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    sites = [[5, 90, 400]] * 3 if mode == "fit" else None
    for k, (q, t) in enumerate(pairs):
        s = None if sites is None else sites[k]
        got = seqpar.seqpar_score(mode, q, t, p, s, device="cuda",
                                  loopback=3, chunk=96)
        assert got == seqpar.seqpar_score(mode, q, t, p, s, device="cpu",
                                          loopback=3, chunk=96)
        if mode != "edit":
            a = seqpar.seqpar_align(mode, q, t, p, s, device="cuda",
                                    loopback=3, chunk=96)
            b = tbatch.align_batch(mode, [(q, t)], p,
                                   None if s is None else [s],
                                   traceback=True, device="cuda")[0]
            assert (a.score, a.row1, a.row2) == (b.score, b.row1, b.row2)
    got = seqpar.seqpar_batch_scores(mode, pairs, p, sites, device="cuda",
                                     loopback=(2, 2))
    want = tbatch.batch_scores(mode, pairs, p, sites, device="cuda")
    assert np.array_equal(got, want)


def test_validate_main_section_on_card(cuda):
    """The differential campaign's main section on the card's kernels
    against the native C++ CLI: align_pair per case, then batches."""
    from aligntools_tpu_torch.tools import validate

    out = validate.run_sections(12, ["main"], "cuda", log=lambda s: None)
    stats = out["sections"]["main"]
    assert stats["cases"] == 60 and stats["oracle_rc"] == 0
    launches = out["launches"]
    assert launches["plain"] == 0
    for name in ("affine", "overlap", "edit", "fit", "ptr", "walk"):
        assert launches[name] > 0, name


def test_trace_records_the_card(cuda, tmp_path, capsys):
    """``batch --trace DIR`` on the card: the trace holds the pointer fill's
    and the walk's kernels, and the TSV is the untraced run's."""
    import json

    from aligntools_tpu_torch.cli import main

    pairs = clustered_pairs(64, seed=5)
    fa = tmp_path / "pairs.fa"
    fa.write_text("".join(f">q{k}\n{q.decode()}\n>t{k}\n{t.decode()}\n"
                          for k, (q, t) in enumerate(pairs)))
    d = tmp_path / "trace"
    assert main(["batch", "global", str(fa), "--trace", str(d)]) == 0
    traced = capsys.readouterr().out
    assert main(["batch", "global", str(fa)]) == 0
    assert capsys.readouterr().out == traced
    with open(d / "trace.json") as f:
        names = [ev.get("name", "") for ev in json.load(f)["traceEvents"]
                 if ev.get("cat") == "kernel"]
    assert any("ptr_affine" in n for n in names)
    assert any("walk_kernel" in n for n in names)
