"""The port's banded engine past the banded kernel's one-pass width
(65,536 lanes, W 32,767) against the JAX package's, on the CPU.

Past that width the card runs the CTA path in chunks: a cluster's team of
16-lane warps, each warp taking ``ops/banded.chunks(band)`` consecutive
512-lane chunks a row (``cta_geometry``), which computes the plain window
fill's function bit for bit (tests/test_torch_cuda.py). Here the port's
``engine/banded`` runs that plain fill on CPU tensors, and its scores,
edges and rows at W 40,000 and ``banded_score_auto`` on a pair of 40,064
bases must equal the JAX package's vmapped XLA route (``engine="xla"``)
exactly; every band has a launch shape, and a rows slab's budget counts
the chunks' scratch. A file of its own, so that a test run with workers
takes it beside the other banded files."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import numpy as np
import pytest

from aligntools_tpu.engine import banded as jbanded
from aligntools_tpu.params import AlignParams as JParams
from aligntools_tpu_torch.engine import banded as tbanded
from aligntools_tpu_torch.engine import select
from aligntools_tpu_torch.ops import banded as tops
from aligntools_tpu_torch.params import AlignParams
from test_torch_banded_wide import _wide_pairs

# one past the one-pass width's band by 7,233: two chunks a warp
BAND = 40000
P = dict(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap",
                                  "edit"])
def test_uncapped_band_scores_match_jax(mode):
    """Scores and edges at W 40,000 (n up to m + 40,000) equal the JAX
    package's vmapped XLA fill, exactly."""
    pairs = _wide_pairs(mode, BAND, 1907)
    want = jbanded.banded_batch_scores(mode, pairs, BAND, JParams(**P),
                                       engine="xla")
    got = tbanded.banded_batch_scores(mode, pairs, BAND, AlignParams(**P),
                                      device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and np.array_equal(g, w), (g, w)


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_uncapped_band_rows_match_jax(mode):
    """Rows and edges at W 40,000 equal the JAX package's banded rows,
    byte for byte."""
    pairs = _wide_pairs(mode, BAND, 1911)
    want, we = jbanded.banded_align_batch(mode, pairs, BAND, JParams(),
                                          engine="xla")
    got, ge = tbanded.banded_align_batch(mode, pairs, BAND, AlignParams(),
                                         device="cpu")
    assert np.array_equal(ge, we)
    assert [(r.score, r.row1, r.row2) for r in got] == [
        (r.score, r.row1, r.row2) for r in want]


def unrelated_pair(seed, m=64, n=40064):
    rng = np.random.default_rng(seed)
    return (bytes(rng.choice(list(b"ACGT"), m).tolist()),
            bytes(rng.choice(list(b"ACGT"), n).tolist()))


@pytest.mark.parametrize("mode", ["local", "overlap"])
def test_score_auto_past_the_one_pass_width_matches_jax(mode):
    """An unrelated 64 x 40,064 pair: these modes' certificate is the
    perfect score, so the band doubles from 40,016 to cover the matrix
    (W 40,064, two chunks a warp on the card); (score, band, certified)
    equals the JAX package's exactly."""
    q, t = unrelated_pair(83)
    want = jbanded.banded_score_auto(mode, q, t, JParams())
    got = tbanded.banded_score_auto(mode, q, t, AlignParams(), device="cpu")
    assert got == want and got[1] == 40064 and got[2], (got, want)
    assert tops.chunks(got[1]) == 2


# (band, its CTA-path geometry: warps a pair, pairs a CTA, CTAs a pair,
# chunks a warp): the one-pass width's last band, one past it, the
# uncapped test's band, four chunks and thirty-one
UNCAPPED_SHAPES = [(32767, (128, 1, 16, 1)), (32768, (72, 1, 9, 2)),
                   (40000, (80, 1, 10, 2)), (131071, (128, 1, 16, 4)),
                   (1000000, (128, 1, 16, 31))]


@pytest.mark.parametrize("band,geometry", UNCAPPED_SHAPES)
def test_every_band_has_a_launch_shape(band, geometry):
    """Every band past the one-pass width takes CTAs of 8 warps of 16
    lanes, a team of one cluster whose warps take ceil(V / 65,536) chunks
    of 512 lanes each, as few warps as hold V; the scratch holds three
    states (one for overlap and edit) over the team's lanes."""
    V = 2 * band + 1
    assert tops.launch_shape(band) == tops.cta_shape(band) == ("cta", 256,
                                                               16)
    assert tops.cta_shape(band, 10**6) == tops.cta_shape(band, 1)
    assert select.banded_path(band, 10**6) == "cta"
    gw, pairs, ctas, R = tops.cta_geometry(band, 256, 16)
    assert (gw, pairs, ctas, R) == geometry
    assert R == tops.chunks(band) == -(-V // tops.MAX_LANES)
    assert gw * R * 512 >= V > (gw - 8) * R * 512 and ctas <= 16
    lanes = gw * R * 512 if R > 1 else 0
    assert tops.scratch_floats("local", band, 256, 16) == 3 * lanes
    assert tops.scratch_floats("edit", band, 256, 16) == lanes
    assert tops.scratch_bytes(band) == 12 * lanes
    for threads, strip in ((256, 8), (256, 4)):
        if R > 1:  # chunks at the widest strip only
            with pytest.raises(ValueError, match="no CTA-path launch"):
                tops.cta_geometry(band, threads, strip)


def test_plan_counts_the_scratch_beside_the_pointers():
    """A rows slab past the one-pass width is cut by its pointers and its
    fill's scratch together: a budget that holds two pairs' pointers but
    not their scratch gives slabs of one pair, and one that holds neither
    refuses the run."""
    pairs = _wide_pairs("local", BAND, 1913)
    m_pad = tbanded._m_pad(range(len(pairs)), pairs)
    ptr = m_pad * tops.lanes_padded(BAND)
    scratch = tops.scratch_bytes(BAND)
    assert scratch == 12 * 80 * 2 * 512
    assert [len(i) for i, _ in tbanded.plan(pairs, BAND, 2 * ptr)] == [1] * 4
    assert [len(i) for i, _ in tbanded.plan(
        pairs, BAND, 2 * (ptr + scratch))] == [2, 2]
    with pytest.raises(ValueError, match="exceed the device budget"):
        tbanded.plan(pairs, BAND, ptr)
