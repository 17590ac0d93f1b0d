"""The port's banded path against the JAX package's banded engine.

The same seeded numpy inputs go through the JAX package's two banded
routes, ``pallas_banded.banded_pallas_scores`` / ``banded_pallas_full``
(interpret mode on the CPU) and the vmapped XLA ``banded_fill``, and
through the port's ``ops/banded.py`` on CPU tensors (its plain version):
best, edge, the start info a/b and every pointer byte at lanes < V must be
equal. Then the engines (scores, rows, single-pair entries, the
certificate, the input checks and the empty-sequence results), the window
walk against ``_walk_banded`` (on the fills' pointers and on the drawn
walks of tests/walk_cases.py), and ``aligntools-torch batch MODE --band W
--device cpu`` byte for byte against ``aligntools batch MODE --band W``."""

import inspect
import os

import banded_ties
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import walk_cases

from aligntools_tpu.engine import banded as jbanded
from aligntools_tpu.ops import pallas_banded as jpb
from aligntools_tpu.params import AlignParams as JParams
from aligntools_tpu.pipeline import run_pipeline as jax_run_pipeline
from aligntools_tpu_torch.cli import main
from aligntools_tpu_torch.engine import banded as tbanded
from aligntools_tpu_torch.engine import device_tb
from aligntools_tpu_torch.ops import banded as tops
from aligntools_tpu_torch.params import AlignParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _tie_pairs(mode, seed=311, count=12):
    """tests/test_banded.py's tie-heavy mix: two letters in two of three
    pairs."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(count):
        alpha = [65, 66] if k % 3 else ALPHA
        q = bytes(rng.choice(alpha, int(rng.integers(3, 90))).tolist())
        t = bytes(rng.choice(alpha, int(rng.integers(3, 110))).tolist())
        if mode == "global":
            t = q[: max(1, len(q) - 5)]
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


@pytest.mark.parametrize("case", ["o<e-W32", "o>e-W17", "ties-W32"])
@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_plain_full_matches_jax(mode, case):
    """best, edge, a, b and every pointer byte at lanes < V; pad lanes are
    unset in the port."""
    if case == "ties-W32":
        pd, band = PARAM_SETS[0]
        pairs = _tie_pairs(mode)
    else:
        pd, band = PARAM_SETS[SET_IDS.index(case)]
        pairs = _pairs(mode, band, 311 + SET_IDS.index(case))
    enc = _encode(pairs, band, AlignParams(**pd))
    V = 2 * band + 1
    best, edge, a, b, ptrs = _port(mode, band, enc, True)
    assert a.dtype == b.dtype == np.int32 and ptrs.dtype == np.uint8
    assert ptrs.shape == enc[0].shape + (tops.lanes_padded(band),)
    unset = 3 if mode == "overlap" else 7
    assert (ptrs[:, :, V:] == unset).all()
    for want in (_jax_pallas(mode, band, enc, True),
                 _jax_xla(mode, band, enc, True)):
        for name, g, w in zip(("best", "edge", "a", "b"), (best, edge, a, b),
                              want):
            _same(g, w, name)
        assert np.array_equal(ptrs[:, :, :V], want[4][:, :, :V]), "ptrs"


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
    assert tops.launch_shape(32767) == ("cta", 256, 16)  # of 16: the widest
    with pytest.raises(ValueError, match="65536 lanes"):
        tops.launch_shape(32768)


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


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap",
                                  "edit"])
def test_single_pair_entries_match_jax(mode):
    rng = np.random.default_rng(601)
    p = dict(match=2, mismatch=-2, gap_open=-4, gap_extend=-1)
    for _ in range(2):
        q, t = _similar_pair(rng, int(rng.integers(30, 90)), 4, 2)
        if mode == "fit" and len(q) > len(t):
            q, t = t, q
        want = jbanded.banded_score_auto(mode, q, t, JParams(**p), band0=4)
        got = tbanded.banded_score_auto(mode, q, t, AlignParams(**p),
                                        band0=4, device="cpu")
        assert got == want
        band = max(abs(len(t) - len(q)), 6)
        assert tbanded.banded_score(mode, q, t, band, AlignParams(**p),
                                    device="cpu") == jbanded.banded_score(
            mode, q, t, band, JParams(**p))
        if mode != "edit":
            g, ge = tbanded.banded_align(mode, q, t, band, AlignParams(**p),
                                         device="cpu")
            w, we = jbanded.banded_align(mode, q, t, band, JParams(**p))
            assert (g.score, g.row1, g.row2, ge) == (w.score, w.row1,
                                                      w.row2, we)
    if mode in ("global", "edit"):
        for fn in (jbanded.banded_score, tbanded.banded_score):
            with pytest.raises(ValueError, match=r"\|n-m\|=36"):
                fn(mode, b"ACGT", b"ACGT" * 10, 8)


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
# The walk in window coordinates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["o<e-W32", "ties-W32"])
@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_window_walk_matches_jax(mode, case):
    """The port's walk over the plain fill's pointers (its plain version on
    the CPU) gives ``_walk_banded``'s rows on the same pointer slabs."""
    pd, band = PARAM_SETS[0]
    pairs = _tie_pairs(mode) if case == "ties-W32" else _pairs(mode, band,
                                                               701)
    enc = _encode(pairs, band, AlignParams(**pd))
    qs, te, ns, ms = (torch.from_numpy(x) for x in enc[:4])
    best, edge, a, b, ptrs = tops.banded_full(
        mode, band, qs, te, ns, ms, torch.from_numpy(enc[4]))
    starts = device_tb.walk_starts(mode, best, a, b, ms, ns)
    before = device_tb.plain_calls
    cols1, cols2, scal = device_tb.walk(mode, 1, ptrs, qs, te, starts, band)
    assert device_tb.plain_calls == before + 1
    assert cols1.shape == (qs.shape[1] + te.shape[1] + 1, len(pairs))
    scal = scal.numpy()
    assert not scal[3].any()
    rows = device_tb.assemble(mode, cols1.numpy(), cols2.numpy(), scal,
                              pairs)
    V = 2 * band + 1
    st = starts.numpy()
    for k, (q, t) in enumerate(pairs):
        want = jbanded._walk_banded(q, t, ptrs[k, :, :V].numpy(), band, mode,
                                    int(st[0, k]), int(st[1, k]),
                                    int(st[2, k]))
        assert rows[k] == want, (k, q, t)


@pytest.mark.parametrize("mode,byte", [("global", 0x00), ("fit", 0x00),
                                       ("local", 0x10), ("overlap", 0x02)])
def test_window_walk_that_leaves_the_band(mode, byte):
    """Pointers that keep the walk moving off the diagonal (L extending up,
    U extending left, overlap RIGHT): ``_walk_banded`` raises and the port
    flags the left-band bit, which the engine raises as the same error."""
    band = 3
    pairs = [(b"ACGTACGTAC", b"ACGTACGTAC")] * 2
    enc = _encode(pairs, band, AlignParams())
    qs, te = torch.from_numpy(enc[0]), torch.from_numpy(enc[1])
    ptrs = torch.full((2, qs.shape[1], tops.lanes_padded(band)), byte,
                      dtype=torch.uint8)
    state = {"local": device_tb.UPP, "overlap": 0}.get(mode, device_tb.LOW)
    starts = torch.tensor([[state] * 2, [10] * 2, [10] * 2],
                          dtype=torch.int32)
    _, _, scal = device_tb.walk(mode, 1, ptrs, qs, te, starts, band)
    assert (scal[3].numpy() & device_tb.ERR_LEFT_BAND).all()
    with pytest.raises(RuntimeError) as want:
        jbanded._walk_banded(*pairs[0], ptrs[0, :, : 2 * band + 1].numpy(),
                             band, mode, state, 10, 10)
    assert str(tbanded._walk_error(mode, int(scal[3, 0]))) == str(
        want.value)


@pytest.mark.parametrize("case", walk_cases.window_cases(),
                         ids=lambda c: f"{c.name}-{c.mode}")
def test_window_walk_cases_match_jax(case):
    """Window walks drawn across the kernel's tiles (tests/walk_cases.py):
    diagonals over row tiles, L and U runs in the band, and runs that leave
    it. Each pair's rows equal ``_walk_banded``'s, or both walks fail with
    the same error."""
    ptrs, qs, te, starts = (torch.from_numpy(x) for x in (
        case.ptrs, case.qs, case.ts, case.starts))
    cols1, cols2, scal = (x.numpy() for x in device_tb.walk(
        case.mode, 1, ptrs, qs, te, starts, case.band))
    V = 2 * case.band + 1
    failed = 0
    for k, (q, t) in enumerate(case.pairs):
        try:
            want = jbanded._walk_banded(q, t, case.ptrs[k, :, :V],
                                        case.band, case.mode,
                                        *map(int, case.starts[:, k]))
        except RuntimeError as e:
            failed += 1
            assert scal[3, k] and str(tbanded._walk_error(
                case.mode, int(scal[3, k]))) == str(e), k
            continue
        assert not scal[3, k], k
        got = device_tb.assemble(case.mode, cols1[:, k : k + 1],
                                 cols2[:, k : k + 1], scal[:, k : k + 1],
                                 [(q, t)])
        assert got[0] == want, k
    assert 0 < failed < len(case.pairs)


def test_window_walk_rejects_bad_layouts():
    enc = _encode([(b"ACGT", b"ACGT")], 4, AlignParams())
    qs, te = torch.from_numpy(enc[0]), torch.from_numpy(enc[1])
    ptrs = torch.zeros((1, qs.shape[1], 16), dtype=torch.uint8)
    starts = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="window walk"):
        device_tb.walk("local", 2, ptrs, qs, te, starts, 4)
    with pytest.raises(ValueError, match="window walk"):
        device_tb.walk("local", 1, ptrs[:, :, :8], qs, te, starts, 4)


# ---------------------------------------------------------------------------
# aligntools-torch batch --band
# ---------------------------------------------------------------------------

OUTPUTS = {"scores": ("--scores-only",), "rows": (), "cigar": ("--cigar",)}


def _params_of(args):
    p = JParams()
    flags = {"-m": "match", "-u": "mismatch", "-o": "gap_open",
             "-e": "gap_extend"}
    for k in range(len(args) - 1):
        if args[k] in flags:
            p = p.replace(**{flags[args[k]]: int(args[k + 1])})
    return p


def _compare(tmp_path, mode, fasta, band, output, args=(), chunk=16384):
    want_path = tmp_path / f"{mode}.{output}.jax.tsv"
    got_path = tmp_path / f"{mode}.{output}.torch.tsv"
    jax_run_pipeline(mode, fasta, _params_of(args), band=band,
                     scores_only=output == "scores", cigar=output == "cigar",
                     chunk_size=chunk, out_path=str(want_path))
    rc = main(["batch", mode, fasta, *args, "--band", str(band),
               *OUTPUTS[output], "--device", "cpu", "--chunk-size",
               str(chunk), "--out", str(got_path)])
    assert rc == 0
    want = want_path.read_bytes()
    assert want and got_path.read_bytes() == want
    return want


# (mode, band, args) on test/test_MODE.fa: each band holds the end cell
FIXTURE_CASES = [("global", 16, ()), ("local", 16, ()), ("overlap", 16, ()),
                 ("fit", 32, ("-m", "2", "-u", "-2")), ("edit", 64, ())]


@pytest.mark.parametrize("mode,band,args,output", [
    (*c, output) for c in FIXTURE_CASES
    for output in (("scores",) if c[0] == "edit" else OUTPUTS)])
def test_band_fixture_tsv_matches_jax(tmp_path, mode, band, args, output):
    _compare(tmp_path, mode, os.path.join(REPO, "test", f"test_{mode}.fa"),
             band, output, args)


def _similar_fasta(tmp_path, mode, empty):
    """Seeded similar pairs of 10-120 (end cells in band 24 for global and
    edit, m <= n for fit), with empty records when ``empty``."""
    pairs = _pairs(mode, 24, 809, 20)
    for k in range(len(pairs)):
        q, t = pairs[k]
        pairs[k] = (q[: 10 + k * 5], t[: 10 + k * 5 + (k % 3)])
    if empty:
        pairs[3:3] = [(b"", b"ACGT"), (b"", b"")]
        if mode != "fit":
            pairs.insert(9, (b"ACG", b""))
    path = tmp_path / "similar.fa"
    path.write_text("".join(f">q{k}\n{q.decode()}\n>t{k}\n{t.decode()}\n"
                            for k, (q, t) in enumerate(pairs)))
    return str(path)


@pytest.mark.parametrize("mode,output", [
    (mode, output) for mode in ("global", "local", "overlap", "fit", "edit")
    for output in (("scores",) if mode == "edit" else OUTPUTS)])
def test_band_similar_tsv_matches_jax(tmp_path, mode, output):
    """Similar pairs in chunks of 8; empty records wherever the JAX
    pipeline prints a line for them (not edit, whose +inf it cannot print,
    and not fit rows, which have no finite start)."""
    empty = mode != "edit" and not (mode == "fit" and output != "scores")
    want = _compare(tmp_path, mode, _similar_fasta(tmp_path, mode, empty),
                    24, output, ("-o", "-3"), chunk=8)
    if empty:
        assert b"\t-inf" in want


def test_band_edit_on_an_empty_query_exits_255(tmp_path, capsys):
    """The JAX pipeline dies on int(+inf); the port refuses with FATAL
    ERROR."""
    fasta = str(tmp_path / "e.fa")
    with open(fasta, "w") as f:
        f.write(">q0\n\n>t0\nACGT\n>q1\nACGT\n>t1\nACGA\n")
    with pytest.raises(OverflowError):
        jax_run_pipeline("edit", fasta, JParams(), band=4,
                         out_path=str(tmp_path / "jax.tsv"))
    assert main(["batch", "edit", fasta, "--band", "4", "--device",
                 "cpu"]) == 255
    err = capsys.readouterr().err
    assert "FATAL ERROR" in err and "+inf" in err


@pytest.mark.parametrize("flags,msg", [
    (["-s"], "--band does not support the fit jump state"),
    (["--sharded"], "--band does not support --sharded"),
])
def test_band_refusals(tmp_path, capsys, flags, msg):
    fasta = _similar_fasta(tmp_path, "fit", False)
    assert main(["batch", "fit", fasta, "--band", "8", *flags, "--device",
                 "cpu"]) == 255
    assert msg in capsys.readouterr().err


def test_band_too_narrow_for_the_end_cell_exits_255(tmp_path, capsys):
    fasta = str(tmp_path / "w.fa")
    with open(fasta, "w") as f:
        f.write(">q0\nACGT\n>t0\n" + "ACGT" * 10 + "\n")
    assert main(["batch", "global", fasta, "--band", "8", "--device",
                 "cpu"]) == 255
    assert "band cannot contain the end cell" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Launch shapes and tie inputs at the kernel's strip and warp edges
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
    gw, pairs, ctas = tops.cta_geometry(band, threads, strip)
    need = -(-V // (32 * strip))
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
    cluster past 16 CTAs, a band past the cap: no launch."""
    assert tops.cta_geometry(256, 32, 4) == (5, 1, 5)  # one-warp CTAs
    assert tops.cta_geometry(600, 64, 8) == (6, 1, 3)  # and a pad warp
    assert tops.cta_geometry(256, 128, 16) == (2, 2, 1)
    assert tops.cta_geometry(32767, 256, 16) == (128, 1, 16)
    assert tops.cta_geometry(8191, 256, 4) == (128, 1, 16)
    for band, threads, strip in ((256, 96, 16), (256, 288, 16),
                                 (256, 48, 16), (8191, 32, 16),
                                 (32767, 128, 16), (32768, 256, 16),
                                 (20, 0, 4), (256, 64, 5), (8192, 256, 4)):
        with pytest.raises(ValueError, match="no CTA-path launch"):
            tops.cta_geometry(band, threads, strip)
    with pytest.raises(ValueError, match="W <= 32767"):
        tops.cta_shape(32768)


@pytest.mark.parametrize("band", [128, 256], ids=["warp-W128", "cta-W256"])
@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_plain_full_on_tie_inputs_matches_jax(mode, band):
    """tests/banded_ties.py's pairs at the launch's strip and warp edges
    (W 128: the warp path at 9 lanes a thread; W 256: one past its widest
    strip, the CTA path, a team of five 128-lane warps; a cluster's CTA
    edge: tests/test_torch_banded_wide_rows.py): best, edge, a, b and every
    pointer byte equal the JAX routes', and each designed pair of ``mode``
    gives its stated start (the tie's winner)."""
    path, _, strip = tops.launch_shape(band)
    assert path == ("warp" if band == 128 else "cta")
    (qs, te, ns, ms), ties = banded_ties.tie_inputs(band, strip, 32 * strip,
                                                    5)
    pm = banded_ties.pmat(mode)
    ps = np.repeat(pm, qs.shape[0], axis=0)
    ps[:, 5] = ms[:, 0]
    enc = (qs, te, ns, ms, pm, ps)
    V = 2 * band + 1
    best, edge, a, b, ptrs = got = _port(mode, band, enc, True)
    for want in (_jax_pallas(mode, band, enc, True),
                 _jax_xla(mode, band, enc, True)):
        for name, g, w in zip(("best", "edge", "a", "b"), got, want):
            _same(g, w, name)
        assert np.array_equal(ptrs[:, :, :V], want[4][:, :, :V]), "ptrs"
    for pair, (tmode, ab) in ties.items():
        if tmode == mode:
            assert (a[pair], b[pair]) == ab, (pair, a[pair], b[pair])
