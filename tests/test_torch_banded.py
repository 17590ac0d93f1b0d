"""The port's banded path against the JAX package's banded engine: the
plain scores, the kernel entries' checks, the engines and the launch
shapes.

The same seeded numpy inputs go through the JAX package's two banded
routes, ``pallas_banded.banded_pallas_scores`` / ``banded_pallas_full``
(interpret mode on the CPU) and the vmapped XLA ``banded_fill``, and
through the port's ``ops/banded.py`` on CPU tensors (its plain version):
best and edge must be equal. Then the engines (scores, rows, the
certificate, the input checks and the empty-sequence results) and the
launch shapes and CTA geometry of the card's kernel. The pointer fill, its
tie inputs and the window walk are in tests/test_torch_banded_full.py; the
single-pair entries and ``aligntools-torch batch MODE --band W --device
cpu`` in tests/test_torch_banded_entries.py. Three files, so that a test
run with workers takes them side by side; the helpers are this file's."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligntools_tpu.engine import banded as jbanded
from aligntools_tpu.ops import pallas_banded as jpb
from aligntools_tpu.params import AlignParams as JParams
from aligntools_tpu_torch.engine import banded as tbanded
from aligntools_tpu_torch.ops import banded as tops
from aligntools_tpu_torch.params import AlignParams

ALPHA = list(b"ACGT")
# tests/test_banded.py's parameter sets (the second has o > e) and bands
PARAM_SETS = [(dict(match=2, mismatch=-2, gap_open=-4, gap_extend=-1), 32),
              (dict(match=2, mismatch=-3, gap_open=-1, gap_extend=-2), 17)]
SET_IDS = ["o<e-W32", "o>e-W17"]


def _similar_pair(rng, n, mutations, indels, alpha=ALPHA):
    """A pair differing by point mutations and small indels."""
    q = rng.choice(alpha, n).astype(np.uint8)
    t = list(q.tolist())
    for _ in range(mutations):
        t[int(rng.integers(0, len(t)))] = int(rng.choice(alpha))
    for _ in range(indels):
        pos = int(rng.integers(0, len(t)))
        if rng.random() < 0.5 and len(t) > 2:
            del t[pos]
        else:
            t.insert(pos, int(rng.choice(alpha)))
    return bytes(q.tolist()), bytes(t)


def _pairs(mode, band, seed, count=12):
    """Similar pairs of 20-150 (tests/test_banded.py's mix), the end cell in
    band for global and edit, m <= n for fit."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(count):
        q, t = _similar_pair(rng, int(rng.integers(20, 150)), 6, 3)
        if mode in ("global", "edit") and abs(len(t) - len(q)) > band:
            q = q[: len(t)]
        if mode == "fit" and len(q) > len(t):
            q, t = t, q
        pairs.append((q, t))
    return pairs


def _encode(pairs, band, params):
    """The JAX engine's batch encoding, m_pad a multiple of the Pallas
    kernel's 8 rows: (qs, te, ns, ms, pm, ps)."""
    B, V = len(pairs), 2 * band + 1
    m_pad = -(-max(max(len(q) for q, _ in pairs), 1) // 8) * 8
    n_max = max(len(t) for _, t in pairs)
    qs = np.full((B, m_pad), -1, np.int32)
    te = np.full((B, band + n_max + V + 1), -2, np.int32)
    ns = np.zeros((B, 1), np.int32)
    ms = np.zeros((B, 1), np.int32)
    for k, (q, t) in enumerate(pairs):
        qs[k, : len(q)] = np.frombuffer(q, np.uint8)
        te[k, band : band + len(t)] = np.frombuffer(t, np.uint8)
        ns[k], ms[k] = len(t), len(q)
    pm = np.zeros((1, 8), np.float32)
    pm[0, :4] = [params.match, params.mismatch, params.gap_open,
                 params.gap_extend]
    ps = np.repeat(pm, B, axis=0)
    ps[:, 5] = ms[:, 0]
    return qs, te, ns, ms, pm, ps


def _jax_pallas(mode, band, enc, emit):
    qs, te, ns, ms, pm, _ = enc
    m_pad, V_pad = qs.shape[1], -(-(2 * band + 1) // 128) * 128
    t_win = jpb.build_t_win(jnp.asarray(te), m_pad, V_pad)
    fn = jpb.banded_pallas_full if emit else jpb.banded_pallas_scores
    out = fn(mode, band, m_pad, True, qs.shape[0], jnp.asarray(qs), t_win,
             jnp.asarray(ns), jnp.asarray(ms), jnp.asarray(pm))
    return [np.asarray(x) for x in out]


def _jax_xla(mode, band, enc, emit):
    qs, te, ns, _, _, ps = enc
    out = jax.jit(jax.vmap(
        lambda q, t, n, p: jbanded.banded_fill(mode, q, t, n, band, p, emit)
    ))(jnp.asarray(qs), jnp.asarray(te), jnp.asarray(ns[:, 0]),
       jnp.asarray(ps))
    return [np.asarray(x) for x in out]


def _port(mode, band, enc, emit):
    qs, te, ns, ms, pm, _ = enc
    args = [torch.from_numpy(x) for x in (qs, te, ns, ms, pm)]
    fn = tops.banded_full if emit else tops.banded_scores
    before = tops.plain_calls
    out = fn(mode, band, *args)
    assert tops.plain_calls == before + 1
    return [x.numpy() for x in out]


def _same(got, want, name):
    assert got.shape == want.shape, name
    assert np.array_equal(got.astype(np.float64), want.astype(np.float64)), (
        name, got, want)


@pytest.mark.parametrize("pset", range(2), ids=SET_IDS)
@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap",
                                  "edit"])
def test_plain_scores_match_jax(mode, pset):
    pd, band = PARAM_SETS[pset]
    enc = _encode(_pairs(mode, band, 211 + pset), band, AlignParams(**pd))
    got = _port(mode, band, enc, False)
    assert got[0].dtype == np.float32
    for want in (_jax_pallas(mode, band, enc, False),
                 _jax_xla(mode, band, enc, False)):
        _same(got[0], want[0], "best")
        _same(got[1], want[1], "edge")


def test_kernel_entries_check_their_inputs():
    enc = _encode(_pairs("local", 8, 5, 3), 8, AlignParams())
    args = [torch.from_numpy(x) for x in enc[:5]]
    with pytest.raises(ValueError, match="unknown banded mode"):
        tops.banded_full("edit", 8, *args)
    with pytest.raises(ValueError, match="negative"):
        tops.banded_scores("local", -1, *args)
    with pytest.raises(ValueError, match="te"):
        tops.banded_scores("local", 8, args[0], args[1][:, :0], *args[2:])
    with pytest.raises(ValueError, match="ns"):
        tops.banded_scores("local", 8, args[0], args[1], args[2].long(),
                           *args[3:])
    assert tops.launch_shape(1000) == ("cta", 256, 4)  # V = 2,001: 2 CTAs
    assert tops.launch_shape(8192) == ("cta", 256, 8)  # 9 CTAs of 8 lanes
    assert tops.launch_shape(32767) == ("cta", 256, 16)  # of 16: one pass
    assert tops.launch_shape(32768) == ("cta", 256, 16)  # 2 chunks a warp
    assert (tops.chunks(32767), tops.chunks(32768)) == (1, 2)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

# the empty-sequence cases of the JAX banded routes at band 4
EMPTY = [(b"", b"AC"), (b"ACGT", b"ACGA"), (b"ACG", b""), (b"", b"")]


def _engine_pairs(mode, band=24):
    pairs = _pairs(mode, band, 401, 8) + EMPTY
    if mode == "fit":
        pairs = [(q, t) for q, t in pairs if len(q) <= len(t)]
    return pairs


@pytest.mark.parametrize("band", [4, 24])
@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap",
                                  "edit"])
def test_engine_scores_match_jax(mode, band):
    pairs = _engine_pairs(mode, band) if band > 4 else [
        p for p in EMPTY if mode != "fit" or len(p[0]) <= len(p[1])]
    p = dict(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    want = jbanded.banded_batch_scores(mode, pairs, band, JParams(**p),
                                       engine="xla")
    got = tbanded.banded_batch_scores(mode, pairs, band, AlignParams(**p),
                                      device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and np.array_equal(g, w), (g, w)
    if band == 4:  # the banded routes' own results on empty sequences
        bad = np.inf if mode == "edit" else -np.inf
        assert got[0][0] == bad


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_engine_rows_match_jax(mode):
    pairs = _engine_pairs(mode)
    if mode == "fit":  # an empty query has no finite start: see below
        pairs = [(q, t) for q, t in pairs if q]
    want, we = jbanded.banded_align_batch(mode, pairs, 24, JParams(),
                                          engine="xla")
    got, ge = tbanded.banded_align_batch(mode, pairs, 24, AlignParams(),
                                         device="cpu")
    assert np.array_equal(ge, we)
    assert [(r.score, r.row1, r.row2) for r in got] == [
        (r.score, r.row1, r.row2) for r in want]
    if mode == "global":  # (empty, ACG): gaps against the target, -inf
        r = got[pairs.index((b"", b"AC"))]
        assert (r.score, r.row1, r.row2) == (-np.inf, b"--", b"AC")


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap",
                                  "edit"])
def test_grouping_and_slicing_change_nothing(mode, monkeypatch):
    """Groups of 3 pairs by query length and a pointer budget that slices
    groups and splits the run into waves give the one-group results."""
    pairs = _pairs(mode, 24, 503, 10) + [(b"AC", b"AC"), (b"ACGTACGT" * 20,
                                                          b"ACGTACGT" * 20)]
    def run():
        if mode == "edit":
            return [list(x) for x in tbanded.banded_batch_scores(
                mode, pairs, 24, device="cpu")]
        res, edge = tbanded.banded_align_batch(mode, pairs, 24, device="cpu")
        return [(r.score, r.row1, r.row2) for r in res], list(edge)

    whole = run()
    monkeypatch.setattr(tbanded, "GROUP_PAIRS_MIN", 3)
    monkeypatch.setattr(tbanded, "GROUPS", 4)
    assert len(tbanded._groups(pairs)) == 4
    monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET", str(int(
        170 * 2 * 64 / 0.45)))  # two (160 x 64) pointer slabs a wave
    waves = []
    collect = tbanded._collect
    monkeypatch.setattr(tbanded, "_collect",
                        lambda *a: (waves.append(len(a[1])), collect(*a)))
    assert run() == whole
    if mode != "edit":
        assert len(waves) >= 3


ERROR_CASES = [
    ("scores", "foo", [(b"AC", b"AC")], 4),
    ("scores", "global", [(b"AC", b"AC"), (b"ACGT", b"A" * 40)], 8),
    ("scores", "edit", [(b"ACGT", b"ACGT" * 8)], 4),
    ("scores", "fit", [(b"ACGTACGT", b"ACG")], 8),
    ("scores", "local", [], 8),
    ("rows", "edit", [(b"AC", b"AC")], 4),
    ("rows", "global", [(b"ACGT", b"ACGT" * 8)], 4),
    ("rows", "fit", [(b"ACGTACGT", b"ACG")], 8),
    ("rows", "fit", [(b"AC", b"ACGT"), (b"", b"ACG")], 4),
    ("rows", "local", [], 8),
]


@pytest.mark.parametrize("kind,mode,pairs,band", ERROR_CASES)
def test_engine_errors_match_jax(kind, mode, pairs, band):
    """The same exception, with the same message, in the same order of
    checks (an empty list: the JAX package's max() error, whose wording is
    Python's)."""
    jfn = (jbanded.banded_batch_scores if kind == "scores"
           else jbanded.banded_align_batch)
    tfn = (tbanded.banded_batch_scores if kind == "scores"
           else tbanded.banded_align_batch)
    with pytest.raises(Exception) as want:
        jfn(mode, pairs, band, JParams(), engine="xla")
    with pytest.raises(Exception) as got:
        tfn(mode, pairs, band, AlignParams(), device="cpu")
    assert got.type is want.type
    if pairs:
        assert str(got.value) == str(want.value)


def test_band_certificate_matches_jax():
    sets = [dict(), dict(match=2, mismatch=-3, gap_open=-1, gap_extend=-2),
            dict(mismatch=1), dict(gap_open=2), dict(match=-1, mismatch=-2)]
    for mode in ("global", "local", "edit", "fit", "overlap"):
        for pd in sets:
            for m, n, band in ((0, 0, 0), (10, 4, 2), (4, 10, 8),
                               (300, 320, 16), (50, 50, 64)):
                assert tbanded.band_certificate(
                    mode, m, n, band, AlignParams(**pd)
                ) == jbanded.band_certificate(mode, m, n, band, JParams(**pd))
    assert tbanded.BANDED_MODES == jbanded.BANDED_MODES


# ---------------------------------------------------------------------------
# Launch shapes and the CTA path's geometry
# ---------------------------------------------------------------------------


def test_launch_shape_takes_the_warp_path_up_to_its_widest_strip():
    """Every band up to W = 255 (V = 511 <= 32 x 16) takes the warp path
    with the narrowest strip that holds V in one warp; wider bands the CTA
    path, 4, 8 or 16 lanes a thread (the narrowest whose team fits a
    cluster of 16 CTAs of 8 warps: V up to 16,384, 32,768, 65,536), teams
    sharing a CTA or spanning a cluster of up to 16 CTAs."""
    for band in range(256):
        V = 2 * band + 1
        path, threads, strip = tops.launch_shape(band)
        assert (path, threads) == ("warp", 32 * tops.WARP_PAIRS), band
        assert strip == min(s for s in tops.WARP_STRIPS if 32 * s >= V), band
    assert tops.launch_shape(64) == ("warp", 128, 5)  # BK1's second shape
    assert tops.launch_shape(128) == ("warp", 128, 9)  # BK1's first, BS
    assert tops.launch_shape(255) == ("warp", 128, 16)
    assert tops.launch_shape(256) == ("cta", 160, 4)  # one past the warp
    assert tops.launch_shape(511) == ("cta", 256, 4)  # V = 1,023: a CTA
    assert tops.launch_shape(512) == ("cta", 160, 4)  # 2 CTAs of 5 warps
    assert tops.launch_shape(2048) == ("cta", 224, 4)  # 5 CTAs of 7
    assert tops.launch_shape(8191) == ("cta", 256, 4)  # 16 CTAs of 8
    assert tops.launch_shape(8192) == ("cta", 256, 8)  # 9 CTAs, 8 lanes
    assert tops.launch_shape(16384) == ("cta", 256, 16)  # 9, 16 lanes


def test_launch_shape_of_a_small_batch():
    """The path depends on the band alone: a batch of any size takes the
    shape of its band (launch_shape has no batch argument), 5 lanes a
    thread up to W 79, 9 up to W 143 and 16 up to W 255."""
    assert list(inspect.signature(tops.launch_shape).parameters) == ["band"]
    assert tops.launch_shape(0) == ("warp", 128, 5)
    assert tops.launch_shape(63) == ("warp", 128, 5)  # V = 127
    assert tops.launch_shape(79) == ("warp", 128, 5)  # V = 159
    assert tops.launch_shape(80) == ("warp", 128, 9)  # V = 161
    assert tops.launch_shape(143) == ("warp", 128, 9)  # V = 287
    assert tops.launch_shape(144) == ("warp", 128, 16)  # V = 289
    assert tops.launch_shape(255) == ("warp", 128, 16)
    assert tops.launch_shape(256) == ("cta", 160, 4)
    assert tops.WARP_STRIPS == (5, 9, 16)


# bands at the CTA path's edges: teams of 4-lane warps sharing a CTA (W 0
# to 255), filling one (W 511), clusters of 2 (W 512), 8 and 9 CTAs (W
# 4,095 / 4,096: the portable size and one past) and 16 (W 8,191); 8-lane
# ones from W 8,192 (9 CTAs) to 16,383 (16); 16-lane ones from W 16,384 (9)
# to 32,767 (16)
CTA_EDGE_BANDS = [0, 255, 256, 511, 512, 1000, 1023, 1024, 2047, 2048, 4095,
                  4096, 8191, 8192, 12000, 16383, 16384, 32767]


@pytest.mark.parametrize("band", CTA_EDGE_BANDS)
def test_cta_shape_covers_the_window(band):
    """The CTA path's team holds V in the fewest warps of the narrowest
    strip whose team fits a CTA, or a cluster's CTAs of equal 16-lane warps
    (at most 256 threads, 16 CTAs); narrow teams share a CTA of up to 8
    warps. The geometry is the C entry's."""
    V = 2 * band + 1
    path, threads, strip = tops.cta_shape(band)
    assert path == "cta" and strip in tops.CTA_STRIPS and threads % 32 == 0
    assert V <= 16 * 8 * 32 * strip
    assert strip == 4 or V > 16 * 8 * 32 * (strip // 2)
    gw, pairs, ctas, chunks = tops.cta_geometry(band, threads, strip)
    need = -(-V // (32 * strip))
    assert chunks == 1  # one pass up to 65,536 lanes
    assert gw * 32 * strip >= V and threads <= 256 and ctas <= 16
    if ctas == 1:
        assert gw == need and pairs * gw == threads // 32
        assert pairs == 8 // need
    else:
        assert pairs == 1 and gw == ctas * threads // 32
        assert gw - need < ctas  # pad warps: fewer than one a CTA
    if band > 255:
        assert tops.launch_shape(band) == tops.cta_shape(band)


def test_cta_shape_shares_a_cta_once_the_batch_fills_the_card():
    """With the batch given, teams share a CTA only as far as every SM
    still gets one (a CTA of ~200-register threads fills an SM); a team of
    more than 4 warps, or a cluster, takes no batch into account."""
    assert tops.cta_shape(128, 64) == ("cta", 96, 4)  # 64 CTAs of 1 pair
    assert tops.cta_shape(128, 2 * tops.SMS) == ("cta", 192, 4)
    assert tops.cta_shape(128, 10**6) == tops.cta_shape(128) == ("cta", 192,
                                                                 4)
    assert tops.cta_shape(20, 3 * tops.SMS) == ("cta", 96, 4)
    assert tops.cta_shape(512, 512) == ("cta", 160, 4)  # BW: 2 CTAs of 5
    for band in (20, 1000, 2047, 2048, 32767):
        assert tops.cta_shape(band, 10**6) == tops.cta_shape(band)
        sh = tops.cta_shape(band, 1)
        assert tops.cta_geometry(band, sh[1], sh[2])[1] == 1


def test_cta_geometry_refuses_what_no_instance_takes():
    """Threads that are no whole number of teams, too many threads, a
    cluster past 16 CTAs, chunks at a strip narrower than 16 lanes: no
    launch. Past the one-pass width (W 32,767) every band has one, in
    chunks (tests/test_torch_banded_uncapped.py)."""
    assert tops.cta_geometry(256, 32, 4) == (5, 1, 5, 1)  # one-warp CTAs
    assert tops.cta_geometry(600, 64, 8) == (6, 1, 3, 1)  # and a pad warp
    assert tops.cta_geometry(256, 128, 16) == (2, 2, 1, 1)
    assert tops.cta_geometry(32767, 256, 16) == (128, 1, 16, 1)
    assert tops.cta_geometry(8191, 256, 4) == (128, 1, 16, 1)
    for band, threads, strip in ((256, 96, 16), (256, 288, 16),
                                 (256, 48, 16), (8191, 32, 16),
                                 (32767, 128, 16), (32768, 256, 8),
                                 (20, 0, 4), (256, 64, 5), (8192, 256, 4)):
        with pytest.raises(ValueError, match="no CTA-path launch"):
            tops.cta_geometry(band, threads, strip)
    assert tops.cta_shape(32768) == ("cta", 256, 16)
    assert tops.cta_geometry(32768, 256, 16) == (72, 1, 9, 2)
