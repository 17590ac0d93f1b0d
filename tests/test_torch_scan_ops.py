"""The port's score fills against the JAX package's Pallas kernels.

The same seeded numpy inputs go through ``pallas_scores`` /
``pallas_fit_scores`` (interpret mode on the CPU) and through the port's
``scores`` / ``fit_scores`` on CPU tensors, which run the kernels' plain
PyTorch versions. Scores are integer-valued float32 with -inf borders, so
the comparison is exact (``np.array_equal``; edit as integers)."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligntools_tpu import batch as jbatch
from aligntools_tpu.ops import pallas_scan as ps
from aligntools_tpu.params import AlignParams
from aligntools_tpu_torch import batch as tbatch
from aligntools_tpu_torch import convert
from aligntools_tpu_torch.engine import select
from aligntools_tpu_torch.ops import blocked, ptr, scan

B, M_PAD, N_PAD = 8, 64, 256
PARAMS = {
    "default": AlignParams(),
    "posmis": AlignParams(match=2, mismatch=3, gap_open=-4, gap_extend=-1,
                          jump=-7),
}


def _inputs(seed, fit=False):
    """Ragged pairs in the kernels' int32 sentinel layout; pair 0 forces a
    gap spanning most of its row (deep in-row propagation)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)
    ms = rng.integers(1, M_PAD + 1, B).astype(np.int32)
    ns = rng.integers(1, N_PAD + 1, B).astype(np.int32)
    ms[0], ns[0] = M_PAD, N_PAD
    if fit:
        ns = np.maximum(ns, ms)
    qs = rng.choice(alpha, (B, M_PAD))
    ts = rng.choice(alpha, (B, N_PAD))
    ts[0, :] = ord("C")
    ts[0, :16] = qs[0, :16]
    ts[0, -48:] = qs[0, 16:]
    qs[np.arange(M_PAD)[None, :] >= ms[:, None]] = -1
    ts[np.arange(N_PAD)[None, :] >= ns[:, None]] = -2
    allow = (rng.random((B, N_PAD)) > 0.1).astype(np.float32)
    return qs, ts, allow, ns[:, None], ms[:, None]


def _pmat(p):
    """The JAX entry points' params row, built independently of convert."""
    pm = np.zeros((1, 8), np.float32)
    pm[0, :5] = [p.match, p.mismatch, p.gap_open, p.gap_extend, p.jump]
    return pm


@pytest.mark.parametrize("pname", sorted(PARAMS))
def test_params_matrix_layout(pname):
    got = convert.params_matrix(PARAMS[pname], "cpu")
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), _pmat(PARAMS[pname]))


@pytest.mark.parametrize("pname", sorted(PARAMS))
@pytest.mark.parametrize("mode", ["global", "local", "overlap", "edit"])
def test_scores_match_pallas(mode, pname):
    qs, ts, _, ns, ms = _inputs(11)
    pm = _pmat(PARAMS[pname])
    want = np.asarray(ps.pallas_scores(
        mode, M_PAD, N_PAD, True, *(jnp.asarray(a) for a in (qs, ts, ns, ms,
                                                               pm))))
    tq, tt, _, tn, tm, tp = convert.kernel_inputs_from_numpy(
        qs, ts, None, ns, ms, pm, "cpu")
    got = scan.scores(mode, M_PAD, N_PAD, tq, tt, tn, tm, tp).numpy()
    if mode == "edit":
        assert got.dtype == np.int32
        assert np.array_equal(got.astype(np.int64), want.astype(np.int64))
    else:
        assert got.dtype == np.float32
        assert np.array_equal(got, want)


@pytest.mark.parametrize("pname", sorted(PARAMS))
@pytest.mark.parametrize("use_jump", [False, True])
def test_fit_scores_match_pallas(use_jump, pname):
    qs, ts, allow, ns, ms = _inputs(13, fit=True)
    pm = _pmat(PARAMS[pname])
    want = np.asarray(ps.pallas_fit_scores(
        use_jump, M_PAD, N_PAD, True,
        *(jnp.asarray(a) for a in (qs, ts, allow, ns, ms, pm))))
    args = convert.kernel_inputs_from_numpy(qs, ts, allow, ns, ms, pm, "cpu")
    got = scan.fit_scores(use_jump, M_PAD, N_PAD, *args).numpy()
    assert np.array_equal(got, want)


def test_cpu_tensors_take_the_plain_version():
    qs, ts, allow, ns, ms = _inputs(17, fit=True)
    args = convert.kernel_inputs_from_numpy(qs, ts, allow, ns, ms,
                                            _pmat(AlignParams()), "cpu")
    scan.reset_counts()
    scan.scores("local", M_PAD, N_PAD, *args[:2], *args[3:])
    scan.fit_scores(True, M_PAD, N_PAD, *args)
    assert scan.plain_calls == 2
    assert all(v == 0 for v in scan.launches.values())
    scan.reset_counts()


def test_wrapper_rejects_bad_inputs():
    qs, ts, _, ns, ms = _inputs(19)
    tq, tt, _, tn, tm, tp = convert.kernel_inputs_from_numpy(
        qs, ts, None, ns, ms, _pmat(AlignParams()), "cpu")
    with pytest.raises(ValueError, match="qs"):
        scan.scores("global", M_PAD, N_PAD, tq.to(torch.int64), tt, tn, tm, tp)
    with pytest.raises(ValueError, match="ts"):
        scan.scores("global", M_PAD, N_PAD + 128, tq, tt, tn, tm, tp)
    with pytest.raises(ValueError, match="contiguous"):
        scan.scores("global", M_PAD, N_PAD, tq,
                    torch.cat([tt, tt], dim=1)[:, ::2], tn, tm, tp)
    with pytest.raises(ValueError, match="mode"):
        scan.scores("fit", M_PAD, N_PAD, tq, tt, tn, tm, tp)


@pytest.mark.parametrize("mode,c_blk,dtype,shape", [
    ("global", 32, torch.float32, (32, 16)),
    ("fit", 2048, torch.float32, (128, 16)),
    ("local", blocked.C_BLK_MAX, torch.float32, (512, 16)),
    ("edit", blocked.C_BLK_MAX, torch.float32, (512, 16)),
    ("edit", 16384, torch.float32, (1024, 16)),
    ("edit", 2048, torch.float64, (256, 8)),
    ("edit", blocked.C_BLK_MAX64, torch.float64, (512, 8))])
def test_blocked_score_launch_shape(mode, c_blk, dtype, shape):
    """The blocked score fills' launch shape: the register-strip score
    fill's rule (scan.flat_shape) on the column block, the fewest whole
    warps of W-column strips (W 16; 8 for edit's double instance), edit's
    CTA up to 1,024 threads."""
    assert scan.flat_shape(mode, c_blk, dtype) == shape
    threads, width = shape
    assert threads * width >= c_blk > (threads - 32) * width


@pytest.mark.parametrize("mode,c_blk,dtype", [
    ("overlap", blocked.C_BLK_MAX + 16, torch.float32),
    ("edit", 16384 + 16, torch.float32),
    ("edit", 8192 + 16, torch.float64)])
def test_blocked_score_launch_shape_refuses_past_its_cta(mode, c_blk, dtype):
    """No shape covers a column block past a CTA's strips: 512 threads (edit
    1,024) of W columns."""
    with pytest.raises(ValueError, match="blocked fill"):
        scan.flat_shape(mode, c_blk, dtype)


def _wide_inputs(seed, n_pad, B=8, m_pad=16):
    """Ragged pairs over n_pad columns (pair 0 the full width, pair 1 one
    column past FLAT_REG_MAX_N_PAD where n_pad allows), in the sentinel
    layout, with fit's allow mask."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)
    ms = rng.integers(1, m_pad + 1, B).astype(np.int32)
    ns = rng.integers(1, n_pad + 1, B).astype(np.int32)
    ns[0] = n_pad
    ns[1] = min(n_pad, ptr.FLAT_REG_MAX_N_PAD + 1)
    qs = rng.choice(alpha, (B, m_pad))
    ts = rng.choice(alpha, (B, n_pad))
    qs[np.arange(m_pad)[None, :] >= ms[:, None]] = -1
    ts[np.arange(n_pad)[None, :] >= ns[:, None]] = -2
    allow = (rng.random((B, n_pad)) > 0.1).astype(np.float32)
    return qs, ts, ns[:, None], ms[:, None], allow


def _port_scores(variant, m_pad, n_pad, tq, tt, ta, tn, tm, tp):
    """``variant``'s scores through the port's route (scan.scores, or
    scan.fit_scores for fit and fit+jump)."""
    mode, jump = variant.split("+")[0], variant.endswith("+jump")
    if mode == "fit":
        return scan.fit_scores(jump, m_pad, n_pad, tq, tt, ta, tn, tm, tp)
    return scan.scores(mode, m_pad, n_pad, tq, tt, tn, tm, tp)


def _pallas_scores(variant, m_pad, n_pad, qs, ts, allow, ns, ms, pm):
    """``variant``'s scores from the JAX Pallas kernels (interpret mode)."""
    mode, jump = variant.split("+")[0], variant.endswith("+jump")
    if mode == "fit":
        return np.asarray(ps.pallas_fit_scores(
            jump, m_pad, n_pad, True,
            *(jnp.asarray(a) for a in (qs, ts, allow, ns, ms, pm))))
    return np.asarray(ps.pallas_scores(
        mode, m_pad, n_pad, True,
        *(jnp.asarray(a) for a in (qs, ts, ns, ms, pm))))


@pytest.mark.parametrize("n_pad", [8192, 8320, 16384])
@pytest.mark.parametrize("mode", ["global", "local", "overlap", "fit",
                                  "fit+jump"])
def test_wide_scores_through_the_route_match_pallas(mode, n_pad):
    """Global, local, overlap, fit and fit+jump scores at the register-strip
    kernel's cap and past it (8,320: a ragged last column block; 16,384)
    through the port's route equal the JAX Pallas kernel's (interpret
    mode): the flat plain version up to the cap, the blocked fill's past
    it."""
    qs, ts, ns, ms, allow = _wide_inputs(23, n_pad)
    pm = _pmat(AlignParams())
    m_pad = qs.shape[1]
    want = _pallas_scores(mode, m_pad, n_pad, qs, ts, allow, ns, ms, pm)
    args = convert.kernel_inputs_from_numpy(qs, ts, allow, ns, ms, pm, "cpu")
    scan.reset_counts()
    blocked.reset_counts()
    got = _port_scores(mode, m_pad, n_pad, *args).numpy()
    wide = n_pad > ptr.FLAT_REG_MAX_N_PAD
    assert (blocked.plain_calls, scan.plain_calls) == (
        (1, 1) if wide else (0, 1))  # the blocked entry runs the plain fill
    assert np.array_equal(got, want)
    scan.reset_counts()
    blocked.reset_counts()


@pytest.mark.parametrize("mode", ["overlap", "fit", "fit+jump"])
@pytest.mark.parametrize("edge", ["m0", "n1"])
def test_scores_of_an_empty_query_or_a_one_column_target_match_pallas(
        mode, edge):
    """m = 0 (overlap's score is 0, fit's -inf) and n = 1 (no column <=
    n-1: overlap 0, fit -inf) beside ordinary pairs, through scan.scores /
    fit_scores on the CPU, equal the JAX Pallas kernel's."""
    qs, ts, allow, ns, ms = _inputs(41, fit=True)
    for k in (1, 2):
        if edge == "m0":
            ms[k, 0] = 0
            qs[k, :] = -1
        else:
            ns[k, 0] = 1
            ts[k, 1:] = -2
    pm = _pmat(PARAMS["posmis"])
    want = _pallas_scores(mode, M_PAD, N_PAD, qs, ts, allow, ns, ms, pm)
    args = convert.kernel_inputs_from_numpy(qs, ts, allow, ns, ms, pm, "cpu")
    got = _port_scores(mode, M_PAD, N_PAD, *args).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[1:3], [0.0, 0.0] if mode == "overlap"
                          else [-np.inf, -np.inf])


@pytest.mark.parametrize("n_pad", [128, 8192, 8320, 16384])
@pytest.mark.parametrize("pname", sorted(PARAMS))
def test_edit_scores_match_pallas(pname, n_pad):
    """Edit distances through scan.scores (the plain version on the CPU)
    equal the JAX Pallas kernel's (interpret mode), exactly as integers,
    on ragged pairs with m = 0, n = 1 and n = n_pad among them, at one
    warp's width (128), at the other modes' cap (8,192), one bucket past
    it (8,320) and at 16,384; the default params' mismatch of -2 makes
    substitutions lower the distance, so values go below 0."""
    qs, ts, ns, ms, _ = _wide_inputs(43, n_pad)
    ms[2, 0], ns[3, 0] = 0, 1
    qs[2, :] = -1
    ts[3, 1:] = -2
    pm = _pmat(PARAMS[pname])
    m_pad = qs.shape[1]
    want = _pallas_scores("edit", m_pad, n_pad, qs, ts, None, ns, ms, pm)
    tq, tt, _, tn, tm, tp = convert.kernel_inputs_from_numpy(
        qs, ts, None, ns, ms, pm, "cpu")
    got = scan.scores("edit", m_pad, n_pad, tq, tt, tn, tm, tp).numpy()
    assert got.dtype == np.int32 and ns[0, 0] == n_pad
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))
    assert got[2] == 0  # m = 0: the Pallas kernel's latch, not n
    if pname == "default":
        assert got.min() < 0


def test_bucket_snap_stays_the_jax_packages():
    """The bucket snap is the JAX package's, not a kernel's cap: targets
    past 8,192 columns (the register-strip fills' cap) and past 16,384
    (edit's) get the JAX package's bucket keys, and only those past
    32,768 snap to BLOCKED_C_BLK multiples."""
    assert tbatch.PALLAS_FLAT_MAX_N_PAD == 32768
    assert tbatch.BLOCKED_C_BLK == 16384
    rng = np.random.default_rng(47)
    pairs = [(bytes(rng.choice(list(b"ACGT"), m).tolist()),
              bytes(rng.choice(list(b"ACGT"), n).tolist()))
             for m, n in ((40, 8193), (64, 9000), (33, 16385), (80, 20000),
                          (17, 32768), (50, 32769), (90, 40000))]
    for floors in ((64, 128), (16, 128)):
        want = jbatch._bucket_keys(pairs, *floors)
        got = tbatch._bucket_keys(pairs, *floors)
        assert got == want, floors
    assert sorted(n for _, n in got) == [8320, 9088, 16512, 20096, 32768,
                                         49152, 49152]


def test_scores_route_picks_flat_or_blocked_at_the_cap():
    """Global, local, overlap and fit go to the blocked fill one bucket past
    FLAT_REG_MAX_N_PAD, at select.blocked_c_blk() (ragged there); edit
    keeps its register-strip fill there, up to its own cap, and goes past
    that."""
    cap = ptr.FLAT_REG_MAX_N_PAD
    for mode in ("global", "local", "overlap", "fit"):
        assert scan.flat_cap(mode) == cap
        assert scan.blocked_c_blk(mode, cap) is None
        assert scan.blocked_c_blk(mode, cap + 128) == select.blocked_c_blk()
    edit_cap = scan.flat_cap("edit")
    assert edit_cap == scan.EDIT_MAX_THREADS * ptr.WIDTH > cap
    assert scan.blocked_c_blk("edit", cap + 128) is None
    assert scan.blocked_c_blk("edit", edit_cap) is None
    assert scan.blocked_c_blk("edit", edit_cap + 128) == select.blocked_c_blk()
    assert scan.flat_shape("edit", edit_cap) == (scan.EDIT_MAX_THREADS,
                                                 ptr.WIDTH)
    assert scan.flat_shape("edit", cap + 128) == (544, ptr.WIDTH)
    with pytest.raises(ValueError, match="blocked fill"):
        scan.flat_shape("edit", edit_cap + 128)
    assert (cap + 128) % select.blocked_c_blk()  # a ragged last block
    qs, ts, ns, ms, allow = _wide_inputs(29, cap + 128, B=2, m_pad=4)
    args = convert.kernel_inputs_from_numpy(qs, ts, allow, ns, ms,
                                            _pmat(AlignParams()), "cpu")
    tq, tt, ta, tn, tm, tp = args
    for mode, blocked_calls in (("global", 1), ("local", 1), ("overlap", 1),
                                ("fit", 1), ("fit+jump", 1), ("edit", 0)):
        blocked.reset_counts()
        got = _port_scores(mode, 4, cap + 128, *args)
        assert blocked.plain_calls == blocked_calls, mode
        if mode.startswith("fit"):
            want = scan.fit_scores_plain(mode == "fit+jump", 4, cap + 128, tq,
                                         tt, ta, tn, tm, tp)
        else:
            want = scan.scores_plain(mode, 4, cap + 128, tq, tt, tn, tm, tp)
        assert torch.equal(got, want), mode
    blocked.reset_counts()
    scan.reset_counts()


@pytest.mark.parametrize("mode", ["overlap", "edit", "fit", "fit+jump"])
def test_scores_route_past_the_flat_ceiling(mode):
    """Edit keeps its register-strip fill up to its cap, flat_cap("edit")
    (16,384 columns), and goes to the blocked fill one bucket past it
    (ragged there); overlap and fit go there at either width (past
    FLAT_REG_MAX_N_PAD), through ``scan.scores`` / ``scan.fit_scores`` (the
    batch path's one route): the scores equal the flat plain version's.
    Fit without the jump takes no allow mask on either side of the
    ceiling."""
    cap = scan.flat_cap("edit")
    base, jump = mode.split("+")[0], mode.endswith("+jump")
    assert scan.blocked_c_blk(base, cap + 128) == select.blocked_c_blk()
    assert (scan.blocked_c_blk(base, cap) is None) == (base == "edit")
    rng = np.random.default_rng(31)
    for n_pad in (cap, cap + 128):
        qs, ts, ns, ms, _ = _wide_inputs(37, n_pad, B=2, m_pad=4)
        ns[1] = n_pad - 3
        allow = (rng.random((2, n_pad)) > 0.1).astype(np.float32)
        args = convert.kernel_inputs_from_numpy(qs, ts, allow, ns, ms,
                                                _pmat(AlignParams()), "cpu")
        tq, tt, ta, tn, tm, tp = args
        blocked.reset_counts()
        if base == "fit":
            got = scan.fit_scores(jump, 4, n_pad, tq, tt, ta if jump else None,
                                  tn, tm, tp)
            want = scan.fit_scores_plain(jump, 4, n_pad, tq, tt,
                                         ta if jump else torch.ones_like(ta),
                                         tn, tm, tp)
        else:
            got = scan.scores(base, 4, n_pad, tq, tt, tn, tm, tp)
            want = scan.scores_plain(base, 4, n_pad, tq, tt, tn, tm, tp)
        wide = base != "edit" or n_pad > cap
        assert blocked.plain_calls == int(wide), n_pad
        assert torch.equal(got, want), n_pad
    blocked.reset_counts()
    scan.reset_counts()
