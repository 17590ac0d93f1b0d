"""The port's batch path against the JAX package's.

Bucketing must give the same shape keys; ``batch_scores`` on the CPU (the
kernels' plain versions) must equal ``aligntools_tpu.batch.batch_scores(
..., engine="pallas")`` exactly, for every mode; and ``align_batch(
traceback=True)`` must give the JAX package's AlignResults (score and both
rows), under every pointer-budget slicing."""

import numpy as np
import pytest
import torch

from aligntools_tpu import batch as jbatch
from aligntools_tpu.params import AlignParams as JAlignParams
from aligntools_tpu.spec import engine as spec
from aligntools_tpu_torch import backend, layout
from aligntools_tpu_torch import batch as tbatch
from aligntools_tpu_torch.params import AlignParams
from aligntools_tpu_torch.utils.synth import clustered_pairs

ALPHA = list(b"ACGT")


def _rand_pairs(rng, count, qlo, qhi, tlo, thi, fit=False):
    out = []
    for _ in range(count):
        q = bytes(rng.choice(ALPHA, int(rng.integers(qlo, qhi))).tolist())
        lo = max(tlo, len(q)) if fit else tlo
        t = bytes(rng.choice(ALPHA, int(rng.integers(lo, thi))).tolist())
        out.append((q, t))
    return out


def test_bucket_keys_match_jax():
    pairs = clustered_pairs(512)
    assert max(len(t) for _, t in pairs) <= 32768
    for floors in ((64, 128), (16, 128)):
        want = jbatch._bucket_keys(pairs, *floors)
        assert tbatch._bucket_keys(pairs, *floors) == want
    assert len(set(want)) > 1


@pytest.mark.parametrize("x", [1, 63, 64, 65, 300, 3000, 32768, 32769, 70000])
def test_bucket_len_matches_jax(x):
    for floor in (16, 64, 128):
        assert tbatch.bucket_len(x, floor) == jbatch.bucket_len(x, floor, 1)


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "edit", "fit",
                                  "fit-s"])
def test_batch_scores_match_jax(mode):
    rng = np.random.default_rng(41)
    fit = mode.startswith("fit")
    pairs = _rand_pairs(rng, 14, 1, 70, 1, 300, fit=fit)  # several buckets
    p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    sites = None
    if mode == "fit-s":
        sites = [sorted(int(x) for x in rng.integers(0, len(t), 3))
                 for _, t in pairs]
    jmode = "fit" if fit else mode
    want = jbatch.batch_scores(jmode, pairs, _jp(p), sites, engine="pallas")
    got = tbatch.batch_scores(jmode, pairs, p, sites, device="cpu")
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    if mode == "fit-s":  # and the spec oracle, quirk included
        for k in range(3):
            assert got[k] == spec.spec_fit(*pairs[k], _jp(p),
                                           sites[k]).score


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap", "edit"])
def test_padding_invariance(mode):
    """A pair's score alone equals its score inside a mixed batch that pads
    it into a larger bucket beside other pairs."""
    rng = np.random.default_rng(13)
    q = bytes(rng.choice(ALPHA, 20).tolist())
    t = bytes(rng.choice(ALPHA, 37).tolist())
    big = (bytes(rng.choice(ALPHA, 300).tolist()),
           bytes(rng.choice(ALPHA, 900).tolist()))
    partner = (bytes(rng.choice(ALPHA, 21).tolist()),
               bytes(rng.choice(ALPHA, 30).tolist()))
    solo = tbatch.batch_scores(mode, [(q, t)], device="cpu")[0]
    mixed = tbatch.batch_scores(mode, [partner, (q, t), big], device="cpu")
    assert mixed[1] == solo
    keys = tbatch._bucket_keys([partner, (q, t), big], 64, 128)
    assert keys[1] != keys[2]


def test_f32_exact_guard():
    pairs = [(b"ACGT" * 10, b"ACGT" * 20)]
    huge = AlignParams(match=1 << 20)
    with pytest.raises(ValueError, match="float32 exact-integer range"):
        tbatch.batch_scores("local", pairs, huge, device="cpu")
    with pytest.raises(ValueError, match="float32 exact-integer range"):
        tbatch.batch_scores("edit", pairs, AlignParams(mismatch=1 << 20),
                            device="cpu")


def test_flat_ceiling():
    """Targets up to 32,768 columns run on the flat fills; one past it
    would need the column-blocked fill, which is not ported."""
    q = b"ACGTTGCA"
    t = (b"ACGT" * 8192)[:-4] + b"TGCA"
    got = tbatch.batch_scores("local", [(q, t)], device="cpu")
    assert got[0] == 8.0
    assert tbatch._bucket_keys([(q, t)], 64, 128) == [(64, 32768)]
    with pytest.raises(ValueError, match="column-blocked"):
        tbatch.batch_scores("local", [(q, t), (q, t + b"A")], device="cpu")


def test_fit_length_guard():
    with pytest.raises(ValueError, match="first sequence must be shorter"):
        tbatch.batch_scores("fit", [(b"ACGTACGT", b"ACG")], device="cpu")


def _jp(p):
    """The JAX package's AlignParams with the same values."""
    return JAlignParams(p.match, p.mismatch, p.gap_open, p.gap_extend,
                        p.jump)


def _rows_case(mode, seed=43, count=14):
    rng = np.random.default_rng(seed)
    fit = mode.startswith("fit")
    pairs = _rand_pairs(rng, count, 2, 70, 2, 300, fit=fit)
    pairs[0] = (pairs[0][0][:1], pairs[0][1][:2])  # m = 1
    if not fit:  # n = 1 (fit needs n >= 2 for a traceback start)
        pairs[1] = (pairs[1][0], pairs[1][1][:1])
    sites = None
    if mode == "fit-s":
        sites = [sorted(int(x) for x in rng.integers(0, len(t), 3))
                 for _, t in pairs]
    return ("fit" if fit else mode), pairs, sites


def _jax_rows(mode, pairs, p, sites):
    return [(r.score, r.row1, r.row2)
            for r in jbatch.align_batch(mode, pairs, _jp(p), sites,
                                        traceback=True)]


def _port_rows(mode, pairs, p, sites, **kw):
    res = tbatch.align_batch(mode, pairs, p, sites, traceback=True,
                             device="cpu", **kw)
    return [(r.score, r.row1, r.row2) for r in res]


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "fit",
                                  "fit-s"])
def test_align_batch_rows_match_jax(mode):
    jmode, pairs, sites = _rows_case(mode)
    p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    got = _port_rows(jmode, pairs, p, sites)
    assert got == _jax_rows(jmode, pairs, p, sites)
    assert any(len(r1) > 0 for _, r1, _ in got)


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "fit-s"])
def test_rows_budget_slices_buckets(monkeypatch, mode):
    """A budget that holds a few pairs' pointers slices every bucket and
    flushes between slices; the results do not change."""
    jmode, pairs, sites = _rows_case(mode, seed=47, count=12)
    p = AlignParams()
    want = _port_rows(jmode, pairs, p, sites)
    jump = mode == "fit-s"
    one_pair = max(m * n // layout.rows_per_byte(jmode, jump, m)
                   for m, n in tbatch._bucket_keys(pairs, 64, 128))
    # room for one pair of the largest bucket, a few of the smaller ones
    monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET",
                       str(int(one_pair / tbatch.PTR_BUDGET_FRAC) + 1))
    calls = {"slices": 0, "waves": 0}

    def counted(name, key):
        real = getattr(tbatch, name)

        def fn(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)
        monkeypatch.setattr(tbatch, name, fn)

    counted("_slice_bucket", "slices")
    counted("_collect_rows_wave", "waves")
    assert _port_rows(jmode, pairs, p, sites) == want
    assert calls["slices"] > 0 and calls["waves"] > 1
    assert want == _jax_rows(jmode, pairs, p, sites)


def test_rows_budget_too_small_for_one_pair(monkeypatch):
    monkeypatch.setenv("ALIGNTOOLS_HBM_BUDGET", "1000")
    with pytest.raises(ValueError, match="rescan"):
        tbatch.align_batch("local", [(b"ACGT", b"AGT")], traceback=True,
                           device="cpu")


def test_fit_rows_without_a_start_raise():
    """A one-column target leaves fit's bottom-row scan (columns 1..n-1)
    empty: the reference's UB, refused as the JAX package refuses it."""
    with pytest.raises(RuntimeError, match="no finite traceback start"):
        tbatch.align_batch("fit", [(b"A", b"C")], traceback=True,
                           device="cpu")


def test_edit_rows_are_its_score():
    pairs = [(b"ACGT", b"AGT")]
    # edit has no rows: the score path serves traceback=True as well
    assert tbatch.align_batch("edit", pairs, traceback=True,
                              device="cpu") == [
        spec.spec_edit(b"ACGT", b"AGT")]


def test_counters_and_empty_input():
    from aligntools_tpu_torch.utils.profiling import Counters

    c = Counters()
    pairs = [(b"ACGT", b"ACGTT"), (b"GATTACA" * 20, b"GCATGCA" * 40)]
    tbatch.batch_scores("local", pairs, device="cpu", counters=c)
    keys = tbatch._bucket_keys(pairs, 64, 128)
    assert c.padded_cells == sum(m * n for m, n in keys)
    assert tbatch.align_batch("local", [], traceback=False,
                              device="cpu") == []
    c = Counters()
    tbatch.align_batch("global", pairs, traceback=True, device="cpu",
                       counters=c)
    assert c.padded_cells == sum(m * n for m, n in keys)
    assert c.walk_seconds > 0 and c.fill_seconds > 0


def test_resolve_device(monkeypatch):
    assert backend.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        backend.resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        backend.resolve_device("cuda")
