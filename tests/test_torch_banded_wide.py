"""The port's banded engine at bands past the warp path against the JAX
package's, on the CPU.

On the card these bands run the banded fill's CTA path (a team of warps a
pair, several pairs a CTA or a cluster of CTAs a pair; ``ops/banded.
cta_shape``), which computes the plain window fill's function bit for bit
(tests/test_torch_cuda.py). Here the port's ``engine/banded`` runs that
plain fill on CPU tensors, and its scores and rows must equal the JAX
package's vmapped XLA route (``engine="xla"``) exactly: scores at W 256,
1,000 and 2,048 (teams of 5 warps and clusters of 2 and 5 CTAs on the
card) and at W 9,000, past the 8,191 the card's kernel once capped (rows
and a cluster's tie: tests/test_torch_banded_wide_rows.py). Files of
their own, so that a test run with workers takes them beside
tests/test_torch_banded.py."""

import numpy as np
import pytest

from aligntools_tpu.engine import banded as jbanded
from aligntools_tpu.params import AlignParams as JParams
from aligntools_tpu_torch.engine import banded as tbanded
from aligntools_tpu_torch.params import AlignParams

ALPHA = list(b"ACGT")


def _wide_pairs(mode, band, seed, count=4):
    """Seeded pairs of m 48-96, the target the query with 5% substitutions
    and a random tail of up to W bases (n up to m + W; half of them a few
    bases shorter than the query but for fit)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for k in range(count):
        m = int(rng.integers(48, 97))
        q = rng.choice(ALPHA, m).astype(np.uint8)
        t = q.copy()
        mut = rng.random(m) < 0.05
        t[mut] = rng.choice(ALPHA, int(mut.sum()))
        if k % 2 or mode == "fit":
            t = np.concatenate([t, rng.choice(ALPHA, int(rng.integers(
                0, band + 1))).astype(np.uint8)])
        else:
            t = t[: m - int(rng.integers(0, 8))]
        pairs.append((bytes(q.tolist()), bytes(t.tolist())))
    return pairs


# bands only the CTA path serves: a team of five warps, clusters of 2 and
# 5 CTAs, and one of 9 CTAs of 8-lane warps past the 8,191 that the kernel
# once capped
WIDE_BANDS = [256, 1000, 2048, 9000]


@pytest.mark.parametrize("band", WIDE_BANDS)
@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap",
                                  "edit"])
def test_wide_band_scores_match_jax(mode, band):
    """The port's banded scores (its plain window fill on the CPU, the
    function the CTA path computes on the card) at bands past the warp
    path equal the JAX package's vmapped XLA fill, exactly."""
    p = dict(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    pairs = _wide_pairs(mode, band, 907 + band)
    want = jbanded.banded_batch_scores(mode, pairs, band, JParams(**p),
                                       engine="xla")
    got = tbanded.banded_batch_scores(mode, pairs, band, AlignParams(**p),
                                      device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and np.array_equal(g, w), (g, w)
