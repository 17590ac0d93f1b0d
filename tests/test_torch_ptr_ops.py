"""The port's pointer fill against the JAX package's Pallas pointer kernel.

The same seeded numpy inputs go through ``pallas_ptr_fill`` (interpret
mode on the CPU) and through the port's ``ptr_fill`` on CPU tensors, which
runs its plain PyTorch version. Scores are integer-valued float32 and
pointers are bytes, so everything is compared exactly: score, the start
info a/b, and every byte of the (B, m_pad/rpb, n_pad) pointer tensor, pad
rows and pad columns included. The tie inputs of tests/ptr_ties.py (start
info the kernel's per-thread latches must resolve as the plain version's
running row maximum does) are checked to tie and held to the Pallas kernel
too; the kernel's launch shapes are checked for every flat bucket."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import jax.numpy as jnp
import numpy as np
import ptr_ties as ties
import pytest
import torch

from aligntools_tpu.engine import scan as jscan
from aligntools_tpu.ops import pallas_ptr as pp
from aligntools_tpu_torch import convert, layout
from aligntools_tpu_torch.ops import ptr

B, M_PAD, N_PAD = 8, 64, 128
ALPHA = list(b"ACGT")
# the (mode, jump, rpb) cases of tests/test_batch.py's Pallas parity test
CASES = [
    ("global", False, 1), ("local", False, 1), ("overlap", False, 1),
    ("fit", False, 1), ("fit", True, 1), ("global", False, 2),
    ("local", False, 2), ("overlap", False, 2), ("fit", False, 2),
    ("overlap", False, 4),
]


def ptr_inputs(seed, fit, B=B, m_pad=M_PAD, n_pad=N_PAD):
    """Ragged pairs in the kernels' int32 sentinel layout, three junction
    sites per target (allow = 0 there, as _bucketize sets it); pair 0 has
    m = n = 1 and pair 1 a one-column target."""
    rng = np.random.default_rng(seed)
    ms = rng.integers(1, m_pad + 1, B)
    ns = rng.integers(1, n_pad + 1, B)
    ms[0], ns[0] = 1, 1
    ms[1], ns[1] = (1, 1) if fit else (m_pad // 2, 1)
    ms[2], ns[2] = m_pad, n_pad
    if fit:
        ns = np.maximum(ns, ms)
    qs = np.full((B, m_pad), -1, np.int32)
    ts = np.full((B, n_pad), -2, np.int32)
    allow = np.ones((B, n_pad), np.float32)
    for k in range(B):
        qs[k, : ms[k]] = rng.choice(ALPHA, ms[k])
        ts[k, : ns[k]] = rng.choice(ALPHA, ns[k])
        allow[k, rng.integers(0, ns[k], 3)] = 0.0
    return (qs, ts, allow, ns[:, None].astype(np.int32),
            ms[:, None].astype(np.int32))


def pmat(match=2, mismatch=-3, gap_open=-4, gap_extend=-1, jump=-10):
    pm = np.zeros((1, 8), np.float32)
    pm[0, :5] = [match, mismatch, gap_open, gap_extend, jump]
    return pm


@pytest.mark.parametrize("mode,use_jump,rpb", CASES)
def test_ptr_fill_matches_pallas(mode, use_jump, rpb):
    arrs = ptr_inputs(71, mode == "fit")
    pm = pmat()
    want = [np.asarray(x) for x in pp.pallas_ptr_fill(
        mode, use_jump, M_PAD, N_PAD, True,
        *(jnp.asarray(x) for x in (*arrs, pm)), rows_per_byte=rpb)]
    args = convert.kernel_inputs_from_numpy(*arrs, pm, "cpu")
    got = [x.numpy() for x in ptr.ptr_fill(mode, use_jump, M_PAD, N_PAD,
                                           *args, rows_per_byte=rpb)]
    assert got[0].dtype == np.float32 and got[3].dtype == np.uint8
    assert got[3].shape == (B, M_PAD // rpb, N_PAD)
    for name, g, w in zip(("score", "a", "b", "ptrs"), got, want):
        assert np.array_equal(g, w), name


def test_cpu_tensors_take_the_plain_version():
    args = convert.kernel_inputs_from_numpy(*ptr_inputs(3, True), pmat(),
                                            "cpu")
    ptr.reset_counts()
    ptr.ptr_fill("fit", True, M_PAD, N_PAD, *args)
    assert (ptr.plain_calls, ptr.launches) == (1, 0)
    ptr.reset_counts()


def test_ptr_fill_rejects_bad_layouts():
    qs, ts, allow, ns, ms, pm = convert.kernel_inputs_from_numpy(
        *ptr_inputs(5, False), pmat(), "cpu")
    with pytest.raises(ValueError, match="rows_per_byte 1"):
        ptr.ptr_fill("fit", True, M_PAD, N_PAD, qs, ts, allow, ns, ms, pm, 2)
    with pytest.raises(ValueError, match="overlap's 2-bit"):
        ptr.ptr_fill("local", False, M_PAD, N_PAD, qs, ts, allow, ns, ms, pm,
                     4)
    with pytest.raises(ValueError, match="does not divide"):
        ptr.ptr_fill("local", False, M_PAD, N_PAD, qs, ts, allow, ns, ms, pm,
                     3)
    with pytest.raises(ValueError, match="fit mode only"):
        ptr.ptr_fill("global", True, M_PAD, N_PAD, qs, ts, allow, ns, ms, pm)
    with pytest.raises(ValueError, match="mode"):
        ptr.ptr_fill("edit", False, M_PAD, N_PAD, qs, ts, allow, ns, ms, pm)
    with pytest.raises(ValueError, match="ts"):
        ptr.ptr_fill("local", False, M_PAD, N_PAD + 128, qs, ts, allow, ns,
                     ms, pm)


def test_layout_constants_match_the_jax_package():
    assert (layout.PK_LOW, layout.PK_MID, layout.PK_UPP, layout.PK_JUMP,
            layout.PK_HOME, layout.PK_UNSET) == (
        jscan.PK_M_LOW, jscan.PK_M_MID, jscan.PK_M_UPP, jscan.PK_M_JUMP,
        jscan.PK_M_HOME, jscan.PK_M_UNSET) == (
        pp.PK_LOW, pp.PK_MID, pp.PK_UPP, pp.PK_JUMP, pp.PK_HOME, pp.PK_UNSET)
    for name in ("PK_L_IS_MID", "PK_U_IS_UPP", "PK_J_IS_JUMP"):
        assert getattr(layout, name) == getattr(jscan, name) == getattr(
            pp, name)
    assert (layout.OV_LEFT, layout.OV_DIAG, layout.OV_RIGHT,
            layout.OV_UNSET) == (jscan.PK_OV_LEFT, jscan.PK_OV_DIAG,
                                 jscan.PK_OV_RIGHT, jscan.PK_OV_UNSET)


@pytest.mark.parametrize("mode,use_jump,m_pad,want", [
    ("fit", True, 64, 1), ("overlap", False, 64, 4), ("overlap", False, 48, 2),
    ("local", False, 48, 2), ("global", False, 40, 1), ("fit", False, 64, 2),
])
def test_rows_per_byte_rule(mode, use_jump, m_pad, want):
    assert layout.rows_per_byte(mode, use_jump, m_pad) == want


def _tie_fill(mode, arrs, rpb=1, use_jump=False):
    args = convert.kernel_inputs_from_numpy(*arrs, ties.pmat(mode), "cpu")
    return ptr.ptr_fill(mode, use_jump, ties.M_PAD, ties.N_PAD, *args,
                        rows_per_byte=rpb)


def test_ptr_tie_inputs_really_tie():
    """Each tie pair of tests/ptr_ties.py gives the (a, b) it names, and
    each of its two candidates, read alone (the other blanked), the same
    score at its own (a, b); overlap's bottom rows hold exactly 0 at column
    5 (which the j = 0 candidate wins) and their maximum at columns 7 and
    13."""
    arrs = ties.tie_inputs(0)
    for mode in ("local", "fit", "overlap"):
        full = _tie_fill(mode, arrs)
        for k, (tie_mode, ab, halves) in ties.TIES.items():
            if tie_mode != mode:
                continue
            assert (int(full[1][k]), int(full[2][k])) == ab, k
            for which, (_, ab_alone) in enumerate(halves):
                alone = _tie_fill(mode, ties.half(arrs, k, which))
                assert float(alone[0][k]) == float(full[0][k]), (k, which)
                assert (int(alone[1][k]), int(alone[2][k])) == ab_alone, (
                    k, which)
    qs, ts, _, ns, _ = arrs
    pm = ties.pmat("overlap")
    zero = ties.ZERO_PAIR
    row = ties.overlap_bottom_row(qs[zero], ts[zero], int(ns[zero, 0]), pm)
    assert row.max() == 0.0 and list(np.flatnonzero(row == 0.0) + 1) == [5]
    assert (float(full[0][zero]), int(full[1][zero])) == (0.0, 0)
    row = ties.overlap_bottom_row(qs[11], ts[11], int(ns[11, 0]), pm)
    assert row.max() > 0.0
    assert tuple(np.flatnonzero(row == row.max()) + 1) == (
        ties.OV_TIE_COLUMNS)


@pytest.mark.parametrize("mode,use_jump,rpb", CASES)
def test_ptr_fill_on_ties_matches_pallas(mode, use_jump, rpb):
    """The plain version equals the Pallas kernel (interpret mode) on the
    tie inputs: score, a, b and every pointer byte."""
    arrs = ties.tie_inputs(5)
    pm = ties.pmat(mode)
    want = [np.asarray(x) for x in pp.pallas_ptr_fill(
        mode, use_jump, ties.M_PAD, ties.N_PAD, True,
        *(jnp.asarray(x) for x in (*arrs, pm)), rows_per_byte=rpb)]
    got = [x.numpy() for x in _tie_fill(mode, arrs, rpb, use_jump)]
    for name, g, w in zip(("score", "a", "b", "ptrs"), got, want):
        assert np.array_equal(g, w), name


def test_launch_shape_covers_every_flat_bucket():
    """Every multiple of 128 up to the rows path's cap gets the kernel's
    instance: W = WIDTH, threads a multiple of 32 up to MAX_THREADS (1,024
    at most), threads * W >= n_pad, the fewest warps; wider targets are
    refused, and ptr_fill hands them to the blocked fill."""
    for n_pad in range(128, ptr.FLAT_REG_MAX_N_PAD + 1, 128):
        threads, w = ptr.launch_shape(n_pad)
        assert w == ptr.WIDTH and threads % 32 == 0, n_pad
        assert 32 <= threads <= ptr.MAX_THREADS <= 1024, n_pad
        assert threads * w >= n_pad, n_pad
        assert threads // 32 == -(-n_pad // (32 * w)), n_pad
        assert ptr.blocked_c_blk(n_pad) is None, n_pad
    assert ptr.launch_shape(128) == (32, 16)
    assert ptr.launch_shape(2048) == (128, 16)
    assert ptr.launch_shape(4224) == (288, 16)
    with pytest.raises(ValueError, match="blocked fill"):
        ptr.launch_shape(ptr.FLAT_REG_MAX_N_PAD + 128)


@pytest.mark.parametrize("mode,use_jump,rpb", [("local", False, 2),
                                               ("fit", True, 1)])
def test_ptr_fill_hands_wide_targets_to_the_blocked_fill(mode, use_jump,
                                                         rpb):
    """Past FLAT_REG_MAX_N_PAD columns ptr_fill runs the blocked pointer
    fill at blocked_c_blk (its plain version on CPU tensors, counted
    there), as it does on the card: the same outputs as the flat plain
    version; at the cap it keeps the flat route."""
    from aligntools_tpu_torch.ops import blocked

    cap = ptr.FLAT_REG_MAX_N_PAD
    assert ptr.blocked_c_blk(cap) is None
    assert (cap + 128) % ptr.blocked_c_blk(cap + 128)  # a ragged last block
    for n_pad, blocked_calls in ((cap + 128, 1), (cap, 0)):
        args = convert.kernel_inputs_from_numpy(
            *ptr_inputs(43, mode == "fit", B=3, m_pad=16, n_pad=n_pad),
            pmat(), "cpu")
        blocked.reset_counts()
        got = ptr.ptr_fill(mode, use_jump, 16, n_pad, *args,
                           rows_per_byte=rpb)
        assert blocked.plain_calls == blocked_calls, n_pad
        want = ptr.ptr_fill_plain(mode, use_jump, 16, n_pad, *args, rpb)
        for name, g, w in zip(("score", "a", "b", "ptrs"), got, want):
            assert torch.equal(g, w), (n_pad, name)
    blocked.reset_counts()
