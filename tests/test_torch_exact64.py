"""Single pairs past float32's exact integers: the port's double instances
against the JAX package's double-precision spec engine, on the CPU.

``api.align_pair`` sends a pair with max|param| * (m+n+1) >= 2^24 to the
double instances of its route's kernels (on the CPU their plain versions
in float64), as the JAX ``align_pair`` sends it to its spec engine. The same
seeded pairs go through both: related pairs of 24 to 300 bases at odd
params near 2^20, so that every mode's score passes 2^24 (edit: a
substitution cost past 2^24, which float32 cannot hold), and pairs of 8 to
19 bases at params past 2^24 (20,000,001 rounds to 20,000,000 in float32).
Scores must be equal and rows equal byte for byte, on the flat route, on
the blocked route (forced by an injected crossover table with small caps)
and through the checkpoint rescan (forced by ALIGNTOOLS_HBM_BUDGET). Each
case also shows that the float32 route, run past its range, gives another
answer: the double route is needed."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import numpy as np
import pytest
import torch

from aligntools_tpu.api import align_pair as jax_align_pair
from aligntools_tpu.params import AlignParams as JaxParams
from aligntools_tpu_torch import api, batch, exact
from aligntools_tpu_torch.convert import params_matrix
from aligntools_tpu_torch.engine import autotune, device_tb
from aligntools_tpu_torch.ops import blocked, ptr, scan
from aligntools_tpu_torch.params import AlignParams

MODES = ("global", "local", "fit", "fit-sites", "overlap", "edit")
# odd params near 2^20; edit's substitution cost past 2^24 (the nearest
# float32 is -16,777,216; negative, the reference's quirk, so that it
# counts)
BIG = dict(match=1048573, mismatch=-1048571, gap_open=-3145739,
           gap_extend=-1048577, jump=-2097143)
EDIT_BIG = dict(mismatch=-16777217)
LENGTHS = [(24, 40), (37, 60), (120, 200), (300, 300)]
# short pairs: params past 2^24, which float32 rounds
SHORT = dict(match=20000003, mismatch=-20000005, gap_open=-60000007,
             gap_extend=-20000001, jump=-40000003)
SHORT_LENGTHS = [(8, 8), (8, 19), (13, 17)]


def _params(mode, kw=None):
    kw = kw or (EDIT_BIG if mode == "edit" else BIG)
    if mode == "edit":
        kw = {"mismatch": kw["mismatch"]}
    return AlignParams(**kw), JaxParams(**kw)


def _pair(m, n, seed):
    """A query of m random bases and a target of n that holds it with 10%
    substitutions (a random tail where n > m): related, so the scores of
    every mode grow past 2^24 at BIG."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    q = alpha[rng.integers(0, 4, m)]
    t = np.concatenate([q, alpha[rng.integers(0, 4, n - m)]])
    sub = rng.random(n) < 0.1
    t[sub] = alpha[rng.integers(0, 4, int(sub.sum()))]
    return q.tobytes(), t.tobytes()


def _sites(n, seed):
    rng = np.random.default_rng(seed + 1)
    return sorted(int(x) for x in rng.integers(1, n, 3))


def _case(mode, m, n):
    seed = 1000 * m + n
    q, t = _pair(m, n, seed)
    sites = _sites(n, seed) if mode == "fit-sites" else None
    return mode.split("-")[0], q, t, sites


def _spec(mode, q, t, sites, jp):
    return jax_align_pair(mode, q, t, jp, sites, engine="spec")


def _key(r):
    return r if isinstance(r, int) else (r.score, r.row1, r.row2)


def _f32_route(mode, q, t, sites, tp, monkeypatch):
    """The float32 route's answer past its range (the batch path's guard
    lifted for the comparison)."""
    with monkeypatch.context() as mp:
        mp.setattr(batch, "check_f32_exact", lambda *a: None)
        return batch.align_batch(mode, [(q, t)], tp,
                                 None if sites is None else [sites],
                                 traceback=mode != "edit", device="cpu")[0]


@pytest.fixture
def default_table():
    was = autotune.set_table(dict(autotune.DEFAULTS))
    yield
    autotune.set_table(was)


@pytest.mark.parametrize("m,n", LENGTHS, ids=[f"{m}x{n}" for m, n in LENGTHS])
@pytest.mark.parametrize("mode", MODES)
def test_align_pair_past_f32_equals_spec(mode, m, n, monkeypatch,
                                         default_table):
    mode, q, t, sites = _case(mode, m, n)
    tp, jp = _params(mode)
    assert not exact.f32_exact(tp, m, n, mode)
    assert exact.dp_bound(tp, m, n, mode) < exact.F64_EXACT_LIMIT
    ptr.reset_counts()
    blocked.reset_counts()
    got = api.align_pair(mode, q, t, tp, sites, device="cpu")
    want = _spec(mode, q, t, sites, jp)
    if mode == "edit":
        assert type(got) is int
    assert _key(got) == _key(want)
    assert blocked.plain_calls == 0  # the flat route
    assert _key(_f32_route(mode, q, t, sites, tp, monkeypatch)) != _key(want)


@pytest.mark.parametrize("m,n", SHORT_LENGTHS,
                         ids=[f"{m}x{n}" for m, n in SHORT_LENGTHS])
@pytest.mark.parametrize("mode", MODES)
def test_short_pair_past_f32_equals_spec(mode, m, n, monkeypatch,
                                         default_table):
    mode, q, t, sites = _case(mode, m, n)
    tp, jp = _params(mode, SHORT)
    assert not exact.f32_exact(tp, m, n, mode)
    got = api.align_pair(mode, q, t, tp, sites, device="cpu")
    want = _spec(mode, q, t, sites, jp)
    assert _key(got) == _key(want)
    assert _key(_f32_route(mode, q, t, sites, tp, monkeypatch)) != _key(want)


@pytest.mark.parametrize("mode", MODES)
def test_blocked_route_past_f32_equals_spec(mode, default_table):
    """Caps of 128 columns (the double pointer fill's and edit's score
    fill's) send a 300-base target to the blocked fills' double
    instances."""
    autotune.set_table({"ptr_flat_cap": {"float64": 128},
                        "score_flat_cap": {"edit": 128}})
    mode, q, t, sites = _case(mode, 120, 300)
    tp, jp = _params(mode)
    blocked.reset_counts()
    got = api.align_pair(mode, q, t, tp, sites, device="cpu")
    assert blocked.plain_calls == 1
    assert _key(got) == _key(_spec(mode, q, t, sites, jp))


@pytest.mark.parametrize("mode", ["global", "local", "fit", "fit-sites",
                                  "overlap"])
def test_rescan_past_f32_equals_spec(mode, monkeypatch, default_table):
    """A budget below one pair's pointer bytes sends it through the
    checkpoint rescan: its double forward and refills, whose rows equal
    the spec engine's."""
    monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET", "20000")
    mode, q, t, sites = _case(mode, 300, 300)
    tp, jp = _params(mode)
    blocked.reset_counts()
    device_tb.reset_counts()
    got = api.align_pair(mode, q, t, tp, sites, device="cpu")
    assert blocked.plain_calls > 1  # the forward and the refills
    assert _key(got) == _key(_spec(mode, q, t, sites, jp))


def test_batch_path_still_refuses(default_table):
    """batch.align_batch (batch, serve) refuses such a pair, as the JAX
    align_batch does."""
    q, t = _pair(120, 200, 3)
    with pytest.raises(ValueError, match="float32 exact-integer range"):
        batch.align_batch("global", [(q, t)], AlignParams(**BIG),
                          traceback=True, device="cpu")


def test_in_range_pairs_keep_float32(monkeypatch, default_table):
    """In range, align_pair builds a float32 params row (the float32
    instances); past it, a float64 one."""
    seen = []
    real = batch.params_matrix

    def spy(p, device, dtype=torch.float32):
        seen.append(dtype)
        return real(p, device, dtype)

    monkeypatch.setattr(batch, "params_matrix", spy)
    q, t = _pair(37, 60, 5)
    api.align_pair("global", q, t, device="cpu")
    api.align_pair("global", q, t, AlignParams(**BIG), device="cpu")
    assert seen == [torch.float32, torch.float64]


def test_params_reach_the_fills_as_double():
    """20,000,001 is not a float32 (the nearest is 20,000,000): the double
    row holds it, and the edit fill counts it."""
    p = AlignParams(match=20000001, mismatch=20000001)
    assert params_matrix(p, "cpu")[0, 0].item() == 20000000.0
    row = params_matrix(p, "cpu", torch.float64)
    assert row.dtype == torch.float64 and row[0, 0].item() == 20000001.0
    q, t = b"ACGTACGTAC", b"ACGAACGTTCG"
    got = api.align_pair("edit", q, t, p, device="cpu")
    assert got == jax_align_pair("edit", q, t, JaxParams(mismatch=20000001),
                                 engine="spec")


@pytest.mark.parametrize("variant", ["global", "local", "fit", "fit+jump",
                                     "overlap", "edit"])
def test_plain_versions_in_float64_equal_float32_in_range(variant):
    """In float32's range the float64 plain versions give the float32
    ones' scores, start info and pointer bytes: the same arithmetic."""
    mode, jump = variant.split("+")[0], variant.endswith("+jump")
    rng = np.random.default_rng(7)
    B, m_pad, n_pad = 3, 16, 128
    alpha = np.frombuffer(b"ACGT", np.uint8).astype(np.int32)
    qs = torch.from_numpy(rng.choice(alpha, (B, m_pad)).astype(np.int32))
    ts = torch.from_numpy(rng.choice(alpha, (B, n_pad)).astype(np.int32))
    ns = torch.tensor([[n_pad], [100], [17]], dtype=torch.int32)
    ms = torch.tensor([[m_pad], [9], [12]], dtype=torch.int32)
    allow = torch.from_numpy((rng.random((B, n_pad)) > 0.1).astype(
        np.float32))
    p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-2,
                    jump=-6)
    p32, p64 = (params_matrix(p, "cpu", dt)
                for dt in (torch.float32, torch.float64))
    if mode == "edit":
        a = scan.scores_plain("edit", m_pad, n_pad, qs, ts, ns, ms, p32)
        b = scan.scores_plain("edit", m_pad, n_pad, qs, ts, ns, ms, p64)
        assert b.dtype == torch.float64
        assert torch.equal(a.to(torch.float64), b)
        return
    al = allow if jump else None
    for rpb in (1, 2) if not jump else (1,):
        a = ptr.ptr_fill_plain(mode, jump, m_pad, n_pad, qs, ts, al, ns, ms,
                               p32, rpb)
        b = ptr.ptr_fill_plain(mode, jump, m_pad, n_pad, qs, ts, al, ns, ms,
                               p64, rpb)
        assert b[0].dtype == torch.float64
        assert torch.equal(a[0].to(torch.float64), b[0])
        for x, y in zip(a[1:], b[1:]):
            assert torch.equal(x, y)
