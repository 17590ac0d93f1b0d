"""Sequence parallelism of the port (``parallel/seqpar.py``) on the CPU: D
column slices in loopback (one process, no group) through the plain
versions of the EDGE phase and the column-paused walk, against the JAX
``seqpar_score``, ``seqpar_batch_scores`` and ``seqpar_align`` on the
8-device CPU mesh (tests/conftest.py) and against the port's
single-device route, exactly: scores bit-equal, rows byte-equal."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import functools

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from aligntools_tpu.params import AlignParams as JParams
from aligntools_tpu.parallel import seqpar as jsp
from aligntools_tpu_torch import batch as tbatch
from aligntools_tpu_torch.params import AlignParams
from aligntools_tpu_torch.parallel import seqpar as sp

P = dict(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
SCORE_VARIANTS = ["global", "local", "overlap", "edit", "fit", "fit+sites"]
ALIGN_VARIANTS = ["global", "local", "overlap", "fit", "fit+sites"]


def _pairs(seed, k, m_hi, n_lo, n_hi, alpha=b"ACGT"):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        m = int(rng.integers(1, m_hi))
        n = int(rng.integers(max(m, n_lo), n_hi))
        out.append((bytes(rng.choice(list(alpha), m).tolist()),
                    bytes(rng.choice(list(alpha), n).tolist()),
                    tuple(sorted(int(x) for x in rng.integers(0, n, 4)))))
    return out


# pairs of every case: several slices wide, one too narrow to reach rank 2
# (ranks past n at D 4 and 8), m past and below the chunks' rows
CASES = _pairs(47, 3, 90, 300, 1500) + [(b"ACGTTGCA" * 2, b"ACGGTCA" * 4,
                                        (2, 9))]


@functools.lru_cache(maxsize=None)
def _jax_score(mode, q, t, sites, p=tuple(P.items())):
    return jsp.seqpar_score(mode, q, t, JParams(**dict(p)),
                            sites=list(sites) if sites is not None else None)


@functools.lru_cache(maxsize=None)
def _jax_align(mode, q, t, sites, p=tuple(P.items())):
    r = jsp.seqpar_align(mode, q, t, JParams(**dict(p)),
                         sites=list(sites) if sites is not None else None)
    return r.score, r.row1, r.row2


def _split(variant, case):
    mode = variant.split("+")[0]
    q, t, sites = case
    return mode, q, t, (sites if variant == "fit+sites" else None)


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", SCORE_VARIANTS)
def test_seqpar_score_loopback_equals_jax(variant, D):
    """Every case at the default chunk (R >= m) and at R = 7 (R does not
    divide m): the JAX seqpar_score's and the single-device route's
    score."""
    for case in CASES:
        mode, q, t, sites = _split(variant, case)
        want = _jax_score(mode, q, t, sites)
        single = tbatch.batch_scores(mode, [(q, t)], AlignParams(**P),
                                     None if sites is None else [sites],
                                     device="cpu")[0]
        for chunk in (None, 7):
            got = sp.seqpar_score(mode, q, t, AlignParams(**P), sites,
                                  device="cpu", loopback=D, chunk=chunk)
            assert got == want == single, (mode, len(q), len(t), chunk)
            assert isinstance(got, int if mode == "edit" else float)


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", ALIGN_VARIANTS)
def test_seqpar_align_loopback_equals_jax(variant, D):
    """Rows byte-equal to the JAX seqpar_align's and the single-device
    route's, at the default chunk and at 32 rows (several chunks; D 4 and
    8 at 32 alone)."""
    for case in CASES:
        mode, q, t, sites = _split(variant, case)
        want = _jax_align(mode, q, t, sites)
        r = tbatch.align_batch(mode, [(q, t)], AlignParams(**P),
                               None if sites is None else [sites],
                               traceback=True, device="cpu")[0]
        assert want == (r.score, r.row1, r.row2)
        for chunk in (None, 32) if D < 4 else (32,):
            got = sp.seqpar_align(mode, q, t, AlignParams(**P), sites,
                                  device="cpu", loopback=D, chunk=chunk)
            assert (got.score, got.row1, got.row2) == want, (mode, chunk)


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_seqpar_tie_heavy(mode, D):
    """A binary alphabet under the default params maximizes DP ties (the
    cases of tests/test_seqpar.py:84-101): the start merged across ranks
    and chunks and the walk across rank boundaries keep the reference's
    tie-breaks."""
    for q, t, _ in _pairs(74, 3, 24, 300, 900, alpha=b"AB"):
        want = _jax_align(mode, q, t, None, ())  # the default params
        got = sp.seqpar_align(mode, q, t, AlignParams(), device="cpu",
                              loopback=D, chunk=32)
        assert (got.score, got.row1, got.row2) == want
        assert sp.seqpar_score(mode, q, t, AlignParams(), device="cpu",
                               loopback=D, chunk=32) == want[0]


@pytest.mark.parametrize("variant", SCORE_VARIANTS)
def test_seqpar_batch_scores_loopback_equals_jax(variant):
    """data x seq: the loopback at (2, 4) against the JAX
    seqpar_batch_scores on Mesh((2, 4), ("data", "seq")), five pairs (not a
    multiple of the data axis), and the single-device route."""
    mode = variant.split("+")[0]
    cases = _pairs(91, 5, 40, 1, 700)
    pairs = [(q, t) for q, t, _ in cases]
    sites = [list(s) for _, _, s in cases] if variant == "fit+sites" else None
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "seq"))
    want = jsp.seqpar_batch_scores(mode, pairs, JParams(**P), sites, mesh)
    got = sp.seqpar_batch_scores(mode, pairs, AlignParams(**P), sites,
                                 device="cpu", loopback=(2, 4), chunk=16)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, tbatch.batch_scores(
        mode, pairs, AlignParams(**P), sites, device="cpu"))


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "edit",
                                  "fit"])
def test_empty_sides_take_the_single_device_result(mode):
    """m = 0 or n = 0: the port answers as its single-device route
    (batch._empty_result); the JAX seqpar differs there (ROADMAP queue 3):
    its global, overlap and fit scores latch nothing, its edit distance
    raises OverflowError."""
    p = AlignParams(**P)
    for q, t in [(b"", b"ACGT"), (b"ACG", b""), (b"", b"")]:
        if mode == "fit" and len(q) > len(t):
            with pytest.raises(ValueError, match="shorter than the second"):
                sp.seqpar_score(mode, q, t, p, device="cpu", loopback=2)
            continue
        got = sp.seqpar_score(mode, q, t, p, device="cpu", loopback=2)
        single = tbatch.batch_scores(mode, [(q, t)], p, device="cpu")[0]
        assert got == single
        if mode != "edit" and not (mode == "fit" and not t):
            r = tbatch.align_batch(mode, [(q, t)], p, traceback=True,
                                   device="cpu")[0]
            a = sp.seqpar_align(mode, q, t, p, device="cpu", loopback=2)
            assert (a.score, a.row1, a.row2) == (r.score, r.row1, r.row2)
    if mode == "edit":
        with pytest.raises(OverflowError):
            _jax_score(mode, b"", b"ACGT", None)
    elif mode in ("global", "fit"):
        assert _jax_score(mode, b"", b"ACGT", None) == float("-inf")
        assert sp.seqpar_score(mode, b"", b"ACGT", AlignParams(**P),
                               device="cpu", loopback=2) > float("-inf")


def test_refusals():
    """The JAX seqpar_align's refusals, worded as it words them, and a
    pair past float32's exact integers (refused as batch refuses it)."""
    p = AlignParams(**P)
    with pytest.raises(ValueError, match="edit mode has no traceback"):
        sp.seqpar_align("edit", b"ACGT", b"ACGT", p, device="cpu",
                        loopback=2)
    with pytest.raises(ValueError, match="first sequence must be shorter"):
        sp.seqpar_align("fit", b"ACGTA", b"ACGT", p, device="cpu",
                        loopback=2)
    with pytest.raises(RuntimeError, match="fit: no finite traceback start"):
        sp.seqpar_align("fit", b"A", b"A", p, device="cpu", loopback=2)
    with pytest.raises(RuntimeError, match="fit: no finite traceback start"):
        _jax_align("fit", b"A", b"A", None)
    with pytest.raises(ValueError, match="float32 exact-integer range"):
        sp.seqpar_score("global", b"ACGT", b"ACGT",
                        AlignParams(match=1 << 23), device="cpu", loopback=2)
    with pytest.raises(ValueError, match="multiple of 32"):
        sp.seqpar_align("global", b"ACGT", b"ACGT", p, device="cpu",
                        loopback=2, chunk=40)
    with pytest.raises(ValueError, match="a mesh or loopback"):
        sp.seqpar_score("global", b"ACGT", b"ACGT", p, mesh=object(),
                        device="cpu", loopback=2)


def test_slices_and_chunks():
    """n_loc is a multiple of 16 covering n; the default chunk keeps the
    ramp (one row a column block) under a tenth of it, a multiple of 32."""
    assert sp.slice_width(1, 8) == 16 and sp.slice_width(114491, 4) == 28624
    assert sp.slice_width(20480, 4) == 5120
    assert sp.chunk_rows(28624, 2048) == 256
    assert sp.chunk_rows(28624 * 8, 2048) == 1120
    for n_loc, c_blk in [(28624, 2048), (5120, 2048), (16, 16)]:
        R = sp.chunk_rows(n_loc, c_blk)
        assert R % 32 == 0 and -(-n_loc // c_blk) * 10 <= R
