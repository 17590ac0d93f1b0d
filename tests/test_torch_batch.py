"""The port's batch path against the JAX package's.

Bucketing must give the same shape keys; ``batch_scores`` on the CPU (the
kernels' plain versions) must equal ``aligntools_tpu.batch.batch_scores(
..., engine="pallas")`` exactly, for every mode; and ``align_batch(
traceback=True)`` must give the JAX package's AlignResults (score and both
rows), under every pointer-budget slicing."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

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
    goes to the column-blocked fills, in a bucket snapped to 16,384."""
    q = b"ACGTTGCA"
    t = (b"ACGT" * 8192)[:-4] + b"TGCA"
    got = tbatch.batch_scores("local", [(q, t)], device="cpu")
    assert got[0] == 8.0
    assert tbatch._bucket_keys([(q, t)], 64, 128) == [(64, 32768)]
    pairs = [(q, t), (q, t + b"A")]
    assert tbatch._bucket_keys(pairs, 64, 128) == [(64, 32768), (64, 49152)]
    assert list(tbatch.batch_scores("local", pairs, device="cpu")) == [8.0,
                                                                       8.0]


def test_bucket_keys_long_targets_match_jax():
    rng = np.random.default_rng(17)
    pairs = clustered_pairs(64, seed=9)
    for n in (32768, 32769, 33000, 49152, 49153, 70000):
        pairs.append((bytes(rng.choice(ALPHA, 100).tolist()),
                      bytes(rng.choice(ALPHA, n).tolist())))
    for floors in ((64, 128), (16, 128)):
        want = jbatch._bucket_keys(pairs, *floors)
        assert tbatch._bucket_keys(pairs, *floors) == want
    assert {key[1] for key in want[-6:]} == {32768, 49152, 65536, 81920}
    assert tbatch._bucket_keys(pairs[-4:-3], 64, 128) == [(112, 49152)]


def _long_pairs(seed, fit=False):
    """Two targets of 33,000-40,000 columns (one bucket of n_pad 49,152,
    the column-blocked fills' regime) and two short pairs."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(4):
        m = int(rng.integers(20, 65))
        lo, hi = (33000, 40001) if k < 2 else (m if fit else 1, 300)
        pairs.append((bytes(rng.choice(ALPHA, m).tolist()),
                      bytes(rng.choice(ALPHA, int(rng.integers(lo, hi)))
                            .tolist())))
    return pairs


@pytest.mark.parametrize("mode", ["global", "local", "overlap", "edit", "fit",
                                  "fit-s"])
def test_align_batch_long_targets_match_jax(mode):
    """Scores and alignment rows of long targets (the blocked fills'
    plain versions here) equal the JAX package's align_batch."""
    fit = mode.startswith("fit")
    pairs = _long_pairs(5, fit)
    sites = None
    if mode == "fit-s":
        rng = np.random.default_rng(6)
        sites = [sorted(int(x) for x in rng.integers(0, len(t), 3))
                 for _, t in pairs]
    jmode = "fit" if fit else mode
    p = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    for traceback in (False,) if mode == "edit" else (False, True):
        want = jbatch.align_batch(jmode, pairs, _jp(p), sites,
                                  traceback=traceback)
        got = tbatch.align_batch(jmode, pairs, p, sites, traceback=traceback,
                                 device="cpu")
        if mode != "edit":
            want = [(r.score, r.row1, r.row2) for r in want]
            got = [(r.score, r.row1, r.row2) for r in got]
        assert got == want


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


# pairs with an empty side, where each mode allows them (fit needs m <= n)
EMPTY = {"global": [(b"", b"ACGT"), (b"ACG", b""), (b"", b"")],
         "fit": [(b"", b"ACGT"), (b"", b"")]}
for _mode in ("local", "overlap", "edit"):
    EMPTY[_mode] = EMPTY["global"]


def _results(fn):
    """Results as comparable tuples, or the exception's type and text."""
    try:
        return [r if isinstance(r, int) else (r.score, r.row1, r.row2)
                for r in fn()]
    except (RuntimeError, ValueError) as err:
        return type(err).__name__, str(err)


@pytest.mark.parametrize("traceback", [False, True])
@pytest.mark.parametrize("mode", ["global", "local", "overlap", "edit", "fit",
                                  "fit-s"])
def test_empty_pairs_match_jax(mode, traceback):
    """A pair with an empty side, alone and mixed into a batch of normal
    pairs, gets the JAX package's align_batch result: its engines' borders
    read at (m, n), or the same error."""
    fit = mode.startswith("fit")
    jmode = "fit" if fit else mode
    rng = np.random.default_rng(23)
    normal = _rand_pairs(rng, 5, 1, 40, 1, 120, fit=fit)
    batches = [[e] for e in EMPTY[jmode]]
    batches.append(normal[:2] + EMPTY[jmode] + normal[2:])
    batches.append(normal[:2] + EMPTY[jmode][:1] + normal[2:])
    for p in (AlignParams(), AlignParams(match=2, mismatch=-3, gap_open=-4,
                                         gap_extend=-1)):
        for pairs in batches:
            sites = ([[1, 2]] * len(pairs)) if mode == "fit-s" else None
            want = _results(lambda: jbatch.align_batch(
                jmode, pairs, _jp(p), sites, traceback=traceback))
            got = _results(lambda: tbatch.align_batch(
                jmode, pairs, p, sites, traceback=traceback, device="cpu"))
            assert got == want, (pairs, p)
    if fit and traceback:  # (b"", b"") has no traceback start
        with pytest.raises(RuntimeError, match="no finite traceback start"):
            tbatch.align_batch("fit", [(b"", b"")], traceback=True,
                               device="cpu")


def test_rows_c_blk_routes_by_the_cap():
    """The rows path's pointer fill (ptr.ptr_fill) keeps buckets up to
    ptr.FLAT_REG_MAX_N_PAD columns on the flat pointer kernel and hands
    wider flat ones and long targets to the blocked fill at
    select.blocked_c_blk(), which need not divide a flat n_pad."""
    from aligntools_tpu_torch.engine import select
    from aligntools_tpu_torch.ops import ptr

    cap = ptr.FLAT_REG_MAX_N_PAD
    assert ptr.blocked_c_blk(128) is None and ptr.blocked_c_blk(cap) is None
    for n_pad in (cap + 128, tbatch.PALLAS_FLAT_MAX_N_PAD,
                  tbatch.PALLAS_FLAT_MAX_N_PAD + tbatch.BLOCKED_C_BLK):
        assert ptr.blocked_c_blk(n_pad) == select.blocked_c_blk(), n_pad
    assert (cap + 128) % select.blocked_c_blk()


def test_dispatch_rows_picks_the_fill_by_the_cap(monkeypatch):
    """A rows run with one bucket at the cap and one just past it: the
    first runs the flat pointer fill, the second the blocked one (each
    wrapper's count of plain calls on CPU tensors); the rows equal those
    of a run with every bucket on the blocked fill (the cap moved below
    both through the crossover table, engine/select.py)."""
    from aligntools_tpu_torch.ops import blocked, ptr

    cap = ptr.FLAT_REG_MAX_N_PAD
    rng = np.random.default_rng(29)
    pairs = [(bytes(rng.choice(list(b"ACGT"), 40).tolist()),
              bytes(rng.choice(list(b"ACGT"), n).tolist()))
             for n in (cap - 5, cap + 100)]
    assert sorted(n for _, n in tbatch._bucket_keys(pairs, 64, 128)) == [
        cap, cap + 128]
    ptr.reset_counts()
    blocked.reset_counts()
    got = _port_rows("local", pairs, AlignParams(), None)
    # the blocked wrapper's plain version is the flat one, counted there too
    assert (ptr.plain_calls, blocked.plain_calls) == (2, 1)
    from aligntools_tpu_torch.engine import autotune

    was = autotune.set_table({"ptr_flat_cap": {"float32": cap - 128}})
    try:
        ptr.reset_counts()
        blocked.reset_counts()
        assert _port_rows("local", pairs, AlignParams(), None) == got
        assert (ptr.plain_calls, blocked.plain_calls) == (2, 2)
    finally:
        autotune.set_table(was)
    ptr.reset_counts()
    blocked.reset_counts()
