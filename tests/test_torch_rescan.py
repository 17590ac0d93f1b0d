"""The checkpoint-rescan engine of the port (``engine/rescan.py``, the
checkpoint and refill instances of ``ops/blocked.py``, the walk's pause) on
the CPU, held against the JAX package's ``engine/rescan.py`` and against
the port's own whole-matrix fill. Exact throughout: scores bit-equal,
checkpoints bit-equal float32, pointer bytes and rows byte-equal."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligntools_tpu import batch as jbatch
from aligntools_tpu.cli import main as jax_main
from aligntools_tpu.engine import rescan as jrescan
from aligntools_tpu.engine.scan import _encode, _params_vec, pad_len
from aligntools_tpu.params import AlignParams as JaxParams
from aligntools_tpu.serve import serve as jax_serve
from aligntools_tpu_torch import api, layout
from aligntools_tpu_torch import batch as tbatch
from aligntools_tpu_torch.cli import main as port_main
from aligntools_tpu_torch.convert import params_matrix
from aligntools_tpu_torch.engine import device_tb
from aligntools_tpu_torch.engine import rescan as trescan
from aligntools_tpu_torch.engine import select
from aligntools_tpu_torch.ops import blocked, ptr
from aligntools_tpu_torch.params import AlignParams
from aligntools_tpu_torch.serve import serve as port_serve

ALPHA = np.frombuffer(b"ACGT", np.uint8)
VARIANTS = ("global", "local", "fit", "fit+jump", "overlap")
P = dict(match=2, mismatch=-2, gap_open=-4, gap_extend=-1)
CPU = torch.device("cpu")


def _pair(rng, m, n, alpha=ALPHA):
    return (bytes(rng.choice(alpha, m).tolist()),
            bytes(rng.choice(alpha, n).tolist()))


def _sites(rng, n, variant):
    if variant != "fit+jump":
        return None
    return sorted(int(x) for x in rng.integers(0, n, 4))


def _port_inputs(q, t, m_pad, n_pad, sites):
    """One pair's kernel inputs on the CPU: (qs, ts, allow, ns, ms)."""
    qs = np.full((1, m_pad), -1, np.int32)
    qs[0, : len(q)] = np.frombuffer(q, np.uint8)
    ts = np.full((1, n_pad), -2, np.int32)
    ts[0, : len(t)] = np.frombuffer(t, np.uint8)
    allow = None
    if sites is not None:
        allow = np.ones((1, n_pad), np.float32)
        allow[0, [x for x in sites if x < n_pad]] = 0.0
        allow = torch.from_numpy(allow)
    return (torch.from_numpy(qs), torch.from_numpy(ts), allow,
            torch.tensor([[len(t)]], dtype=torch.int32),
            torch.tensor([[len(q)]], dtype=torch.int32))


@pytest.mark.parametrize("S", [8, 16])
@pytest.mark.parametrize("variant", VARIANTS)
def test_ckpt_fill_equals_jax_forward(variant, S):
    """The plain checkpoint forward: its checkpoints equal the JAX
    _forward_ckpt's on columns 0..n (the two packages pad n differently),
    and its start info the JAX finish."""
    rng = np.random.default_rng(301)
    mode, jump = variant.split("+")[0], variant.endswith("+jump")
    m, n = 3 * S - 5, 150
    q, t = _pair(rng, m, n)
    sites = _sites(rng, n, variant)
    m_pad = -(-m // S) * S
    # the JAX side, as its rescan_align calls it
    jn_pad = pad_len(n)
    qa = np.full(m_pad, -1, np.int32)
    qa[:m] = np.frombuffer(q, np.uint8)
    allowed = np.ones(jn_pad, dtype=bool)
    if jump:
        allowed[sites] = False
    fin, cks = jrescan._forward_ckpt(
        mode, jn_pad, S, jump, jnp.asarray(qa), _encode(t, jn_pad, -2),
        jnp.int32(n), _params_vec(JaxParams(**P), m), jnp.asarray(allowed))
    want = np.asarray(cks)
    n_pad = trescan.pad_n(n)
    args = _port_inputs(q, t, m_pad, n_pad, sites)
    score, a, b, got = blocked.blocked_ckpt_fill(
        mode, jump, S, m_pad, n_pad, select.blocked_c_blk(), *args,
        params_matrix(AlignParams(**P), CPU))
    assert got.shape == (1, m_pad // S, trescan._N_STATE_ROWS[mode],
                         n_pad + 1)
    assert trescan._N_STATE_ROWS == jrescan._N_STATE_ROWS
    assert np.array_equal(got[0, ..., : n + 1].numpy(),
                          want[..., : n + 1]), variant
    fin = [np.asarray(x) for x in fin]
    assert float(score[0]) == float(fin[0])
    if mode == "global":
        assert int(a[0]) == int(fin[1])
    elif mode in ("local", "fit"):
        assert (int(a[0]), int(b[0])) == (int(fin[1]), int(fin[2]))
    else:
        assert int(a[0]) == int(fin[1])


@pytest.mark.parametrize("S", [8, 16, 32])
@pytest.mark.parametrize("variant", VARIANTS)
def test_refill_equals_whole_fill(variant, S):
    """The plain refill of every block from its checkpoint equals the
    matching rows of the port's whole-matrix pointer fill, byte for byte,
    at the refill's own packing (rpb 4 for overlap at S 32)."""
    rng = np.random.default_rng(302)
    mode, jump = variant.split("+")[0], variant.endswith("+jump")
    m, n = 4 * S - 3, 130
    q, t = _pair(rng, m, n)
    sites = _sites(rng, n, variant)
    m_pad, n_pad = 4 * S, trescan.pad_n(n)
    rpb = layout.rows_per_byte(mode, jump, S)
    pm = params_matrix(AlignParams(**P), CPU)
    args = _port_inputs(q, t, m_pad, n_pad, sites)
    whole = ptr.ptr_fill_plain(mode, jump, m_pad, n_pad, *args, pm, rpb)[3]
    cks = blocked.blocked_ckpt_fill(mode, jump, S, m_pad, n_pad,
                                    select.blocked_c_blk(), *args, pm)[3]
    qs, ts, allow, ns, ms = args
    for k in range(m_pad // S):
        got = blocked.blocked_refill(
            mode, jump, S, n_pad, select.blocked_c_blk(),
            cks[:, k].contiguous(), k * S,
            qs[:, k * S : (k + 1) * S].contiguous(), ts, allow, ns, ms, pm,
            rpb)
        r = S // rpb
        assert torch.equal(got, whole[:, k * r : (k + 1) * r]), (variant, k)


def _same(got, want):
    assert (got.score, got.row1, got.row2) == (want.score, want.row1,
                                               want.row2)


@pytest.mark.parametrize("S", [8, 16, 32])
@pytest.mark.parametrize("variant", VARIANTS)
def test_rescan_equals_jax(variant, S):
    """The port's rescan_align equals the JAX one: m < S, m a multiple of
    S, and m spanning five blocks."""
    rng = np.random.default_rng(303 + S)
    mode = variant.split("+")[0]
    for m in (S - 3, 2 * S, 5 * S - 2):
        q, t = _pair(rng, m, int(rng.integers(max(m, 60), 240)))
        sites = _sites(rng, len(t), variant)
        want = jrescan.rescan_align(mode, q, t, JaxParams(**P), sites=sites,
                                    stride=S)
        got = trescan.rescan_align(mode, q, t, AlignParams(**P), sites=sites,
                                   stride=S, device="cpu")
        _same(got, want)


@pytest.mark.parametrize("variant", VARIANTS)
def test_rescan_tie_heavy(variant):
    """The binary alphabet's ties across block boundaries (the JAX
    test_rescan_tie_heavy's inputs)."""
    rng = np.random.default_rng(212)
    mode = variant.split("+")[0]
    for _ in range(2):
        m = int(rng.integers(3, 40))
        q, t = _pair(rng, m, int(rng.integers(max(m, 120), 300)),
                     np.frombuffer(b"AB", np.uint8))
        sites = _sites(rng, len(t), variant)
        want = jrescan.rescan_align(mode, q, t, JaxParams(), sites=sites,
                                    stride=8)
        got = trescan.rescan_align(mode, q, t, AlignParams(), sites=sites,
                                   stride=8, device="cpu")
        _same(got, want)


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_rescan_empty_sides(mode):
    """A side with no DP cell: the rows path's result (batch._empty_result),
    which is the JAX rescan's."""
    cases = [(b"", b"ACGT"), (b"", b"")]
    if mode != "fit":
        cases.append((b"ACGT", b""))
    for q, t in cases:
        if mode == "fit" and not t:
            with pytest.raises(RuntimeError, match="no finite traceback"):
                trescan.rescan_align(mode, q, t, AlignParams(), stride=8,
                                     device="cpu")
            continue
        want = jrescan.rescan_align(mode, q, t, JaxParams(), stride=8)
        got = trescan.rescan_align(mode, q, t, AlignParams(), stride=8,
                                   device="cpu")
        _same(got, want)


def test_rescan_refusals():
    """The JAX guards: edit, fit with m > n, a stride off the 8-row grid,
    and pairs past float32's exact integers."""
    p = AlignParams()
    with pytest.raises(ValueError, match="no traceback"):
        trescan.rescan_align("edit", b"AC", b"ACGT", p, device="cpu")
    with pytest.raises(ValueError, match="shorter"):
        trescan.rescan_align("fit", b"ACGTA", b"ACGT", p, device="cpu")
    with pytest.raises(ValueError, match="multiple of 8"):
        trescan.rescan_align("global", b"AC", b"ACGT", p, stride=12,
                             device="cpu")
    with pytest.raises(ValueError, match="float32"):
        trescan.rescan_align("global", b"A", b"C",
                             AlignParams(match=1 << 24), device="cpu")


def test_rescan_fit_without_a_start_raises():
    """Fit's bottom-row scan over columns 1..n-1 is empty at n = 1: the
    reference's UB, refused as the JAX rescan refuses it."""
    with pytest.raises(RuntimeError, match="no finite traceback start"):
        trescan.rescan_align("fit", b"A", b"C", AlignParams(), stride=8,
                             device="cpu")
    with pytest.raises(RuntimeError, match="no finite traceback start"):
        jrescan.rescan_align("fit", b"A", b"C", JaxParams(), stride=8)


def test_rescan_overlap_leaving_row_0_raises(monkeypatch):
    """An overlap walk that reaches row 0 with target left (the reference
    reads pointer row -1) raises, as the JAX rescan does: the walk here is
    made to pause at row 0 of the top block with j > 0."""
    walk = device_tb.walk

    def paused_early(mode, rpb, ptrs, qs, ts, starts, band=None,
                     pause=False):
        c1, c2, scal = walk(mode, rpb, ptrs, qs, ts, starts, band, pause)
        scal = scal.clone()
        scal[0], scal[1], scal[2] = 0, 0, starts[2]  # no step, at row 0
        scal[4] = device_tb.LOW
        return c1, c2, scal

    monkeypatch.setattr(device_tb, "walk", paused_early)
    with pytest.raises(RuntimeError, match="unset pointer"):
        trescan.rescan_align("overlap", b"ACG", b"ACGTACGT", AlignParams(),
                             stride=8, device="cpu")


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_paused_walk_equals_plain_walk(mode):
    """The walk's pause on a whole-matrix fill: a pair started at its end
    walks to the same columns block by block (resuming at each block's row
    0 with the state it paused in) as in one walk; overlap's would flag
    row 0 unpaused."""
    rng = np.random.default_rng(304)
    q, t = _pair(rng, 45, 120)
    m_pad, n_pad, S = 48, 128, 16
    pm = params_matrix(AlignParams(**P), CPU)
    args = _port_inputs(q, t, m_pad, n_pad, None)
    qs, ts, _, ns, ms = args
    score, a, b, ptrs = ptr.ptr_fill_plain(mode, False, m_pad, n_pad, *args,
                                           pm, 1)
    starts = device_tb.walk_starts(mode, score, a, b, ms, ns)
    c1, c2, sc = device_tb.walk(mode, 1, ptrs, qs, ts, starts)
    whole = (c1[: sc[0, 0], 0], c2[: sc[0, 0], 0])
    st, i, j = (int(x) for x in starts[:, 0])
    parts1, parts2 = [], []
    k = (i - 1) // S
    while k >= 0:
        base = k * S
        blk = (ptrs[:, base : base + S].contiguous(),
               qs[:, base : base + S].contiguous())
        s3 = torch.tensor([[st], [i - base], [j]], dtype=torch.int32)
        w1, w2, scal = device_tb.walk(mode, 1, blk[0], blk[1], ts, s3,
                                      pause=True)
        assert scal.shape == (5, 1)
        n_k, fi, fj, err, st = (int(x) for x in scal[:, 0])
        assert err == 0
        parts1.append(w1[:n_k, 0])
        parts2.append(w2[:n_k, 0])
        i, j = base + fi, fj
        if st >= device_tb.DONE or (mode in ("global", "local") and j == 0):
            break
        assert fi == 0  # a pause at the block's row 0
        k -= 1
    assert torch.equal(torch.cat(parts1), whole[0])
    assert torch.equal(torch.cat(parts2), whole[1])
    assert (i, j) == (int(sc[1, 0]), int(sc[2, 0]))


def _budget_pairs(mode):
    """tests/test_budget_router.py:50's pairs, sites and params."""
    rng = np.random.default_rng(102)
    alpha = list(b"ACGT")
    pairs = [
        (bytes(rng.choice(alpha, int(rng.integers(1, 50))).tolist()),
         bytes(rng.choice(alpha, int(rng.integers(1, 260))).tolist()))
        for _ in range(5)
    ]
    if mode == "fit":
        pairs = [(q[: len(t)], t) for q, t in pairs]
    sites = None
    if mode == "fit":
        sites = [sorted(int(x) for x in rng.integers(0, max(1, len(t)), 3))
                 for _, t in pairs]
    p = dict(match=2, mismatch=-2) if mode == "fit" else {}
    return pairs, sites, p


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "fit"])
def test_align_batch_over_budget_equals_jax(monkeypatch, mode):
    """With ALIGNTOOLS_HBM_BUDGET=10000 on both sides (overlap, whose
    2-bit pointers fit that budget here, also at 8000) pairs pass the
    pointer budget alone and take the rescan route: the port's rows equal
    the JAX align_batch's."""
    pairs, sites, p = _budget_pairs(mode)
    rescan = trescan.rescan_align
    routed = 0
    for hbm in (10000, 8000) if mode == "overlap" else (10000,):
        monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET", str(hbm))
        want = jbatch.align_batch(mode, pairs, JaxParams(**p),
                                  sites_list=sites, traceback=True)
        calls = []

        def counted(*a, **k):
            calls.append(a[0])
            return rescan(*a, **k)

        monkeypatch.setattr(trescan, "rescan_align", counted)
        got = tbatch.align_batch(mode, pairs, AlignParams(**p),
                                 sites_list=sites, traceback=True,
                                 device="cpu")
        for w, g in zip(want, got):
            _same(g, w)
        # the pairs of the buckets whose packed pointers pass the budget a
        # pair went through the rescan
        budget = int(hbm * tbatch.PTR_BUDGET_FRAC)
        over = sum(mp * n_pad // layout.rows_per_byte(mode, mode == "fit", mp)
                   > budget
                   for mp, n_pad in tbatch._bucket_keys(pairs, 64, 128))
        assert len(calls) == over
        routed += over
    assert routed > 0


def test_auto_stride_equals_jax():
    for m in (0, 1, 255, 256, 1000, 4096, 65537, 240000):
        for n_pad in (128, 4096, 114688, 330112):
            for budget in (4500, 10 ** 6, 10 ** 9, 38 * 10 ** 9):
                assert tbatch._auto_stride(m, n_pad, budget) == \
                    jbatch._auto_stride(m, n_pad, budget), (m, n_pad, budget)
    for n in (0, 1, 127, 128, 129, 114491):
        assert tbatch.pad_len(n) == pad_len(n)


def test_over_budget_pair_through_align_pair(monkeypatch):
    rng = np.random.default_rng(305)
    q, t = _pair(rng, 40, 200)
    want = api.align_pair("global", q, t, device="cpu")
    monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET", "10000")
    _same(api.align_pair("global", q, t, device="cpu"), want)
    _same(api.align_pair("fit", q, t, AlignParams(**P), [3, 77],
                         device="cpu"),
          jrescan.rescan_align("fit", q, t, JaxParams(**P), sites=[3, 77],
                               stride=256))


def test_over_budget_pair_through_the_cli(monkeypatch, tmp_path, capsys):
    """``aligntools-torch global FILE`` answers an over-budget pair, with the
    JAX CLI's stdout; and ``batch`` prints the JAX batch's TSV."""
    rng = np.random.default_rng(306)
    q, t = _pair(rng, 30, 300)  # overlap's 2-bit pointers: 64 x 384 / 4
    path = tmp_path / "pair.fa"
    path.write_text(f">q\n{q.decode()}\n>t\n{t.decode()}\n")
    monkeypatch.setenv("ALIGNTOOLS_DEVICE", "cpu")
    monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET", "10000")
    assert port_main(["global", str(path)]) == 0
    got = capsys.readouterr().out
    assert jax_main(["aligntools", "global", str(path)]) == 0
    assert got == capsys.readouterr().out
    out_t, out_j = tmp_path / "t.tsv", tmp_path / "j.tsv"
    assert port_main(["batch", "overlap", str(path), "--device", "cpu",
                      "--out", str(out_t)]) == 0
    assert jax_main(["aligntools", "batch", "overlap", str(path), "--out",
                     str(out_j)]) == 0
    assert out_t.read_text() == out_j.read_text()


def test_over_budget_pair_through_serve(monkeypatch, tmp_path):
    rng = np.random.default_rng(307)
    lines = []
    for k in range(3):
        q, t = _pair(rng, int(rng.integers(10, 40)), 150)
        lines += [f">q{k}\n{q.decode()}", f">t{k} 5|60\n{t.decode()}"]
    path = tmp_path / "pairs.fa"
    path.write_text("\n".join(lines) + "\n")
    monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET", "10000")
    stream = [f"global {path}\n", f"fit {path} sites\n", "quit\n"]
    outs = []
    for fn, kw in ((port_serve, {"device": "cpu"}), (jax_serve, {})):
        out = io.StringIO()
        assert fn(iter(stream), out, **kw) == 0
        outs.append([ln.split(" seconds=")[0]
                     for ln in out.getvalue().splitlines()])
    assert outs[0] == outs[1]
    assert sum(ln.startswith("#done pairs=3") for ln in outs[0]) == 2


def test_rsr_checks_on_small_pairs(monkeypatch):
    """chip_smoke.py's RSR holds a pair past the card's budget by its rows'
    host rescoring (rescore_global) and its gapless rows: both agree with
    the rows path here, on related pairs (utils/synth.related_pair) forced
    through the rescan and on random ones with leading gaps."""
    import chip_smoke

    from aligntools_tpu_torch.utils.synth import related_pair

    rng = np.random.default_rng(308)
    pairs = [related_pair(300, 412, seed=k) for k in range(3)]
    pairs += [_pair(rng, 40, 90), _pair(rng, 90, 40), _pair(rng, 5, 200)]
    for p in (AlignParams(), AlignParams(**P)):
        monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET", "10000")
        got = tbatch.align_batch("global", pairs, p, traceback=True,
                                 device="cpu")
        monkeypatch.delenv("ALIGNTOOLS_HBM_BUDGET")
        want = tbatch.align_batch("global", pairs, p, device="cpu")
        for (q, t), g, w in zip(pairs, got, want):
            assert g.score == w.score
            assert chip_smoke.rescore_global(g.row1, g.row2, p) == g.score
            assert (g.row1.replace(b"-", b""),
                    g.row2.replace(b"-", b"")) == (q, t)
    q, t = pairs[0]
    assert 290 < len(q) < 310 and len(t) == 412
    assert got[0].score > 0  # the query is a window of the target
