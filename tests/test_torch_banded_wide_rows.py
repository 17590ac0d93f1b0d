"""The port's banded rows at bands past the warp path against the JAX
package's, on the CPU: the engine's rows at W 300 and 9,000, and the
window fill on tests/banded_ties.py's pairs placed across the CTA edge of
a cluster (W 4,096: nine CTAs of 8 warps of 4 lanes on the card), against
the JAX package's vmapped XLA route (``engine="xla"``), exactly. See
tests/test_torch_banded_wide.py."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import banded_ties
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligntools_tpu.engine import banded as jbanded
from aligntools_tpu.params import AlignParams as JParams
from aligntools_tpu_torch.engine import banded as tbanded
from aligntools_tpu_torch.ops import banded as tops
from aligntools_tpu_torch.params import AlignParams
from test_torch_banded_wide import _wide_pairs


@pytest.mark.parametrize("band", [300, 9000])
@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_wide_band_rows_match_jax(mode, band):
    """Rows at a band of two warps and one past the old 8,191 cap equal the
    JAX package's banded rows, byte for byte."""
    pairs = _wide_pairs(mode, band, 911 + band)
    want, we = jbanded.banded_align_batch(mode, pairs, band, JParams(),
                                          engine="xla")
    got, ge = tbanded.banded_align_batch(mode, pairs, band, AlignParams(),
                                         device="cpu")
    assert np.array_equal(ge, we)
    assert [(r.score, r.row1, r.row2) for r in got] == [
        (r.score, r.row1, r.row2) for r in want]


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_plain_full_on_cluster_tie_inputs_matches_jax(mode):
    """tests/banded_ties.py's pairs at W 4,096 with pair 1's tie across the
    CTA edge of the card's cluster (lane 1,024): best, edge, a, b and every
    pointer byte of the port's plain fill equal the JAX XLA fill's, and
    each designed pair of ``mode`` gives its stated start."""
    band = 4096
    path, threads, strip = tops.launch_shape(band)
    assert path == "cta" and threads * strip == 1024
    assert tops.cta_geometry(band, threads, strip)[2] == 9
    (qs, te, ns, ms), ties = banded_ties.tie_inputs(band, strip,
                                                    threads * strip, 5)
    pm = banded_ties.pmat(mode)
    ps = np.repeat(pm, qs.shape[0], axis=0)
    ps[:, 5] = ms[:, 0]
    got = [x.numpy() for x in tops.banded_full(mode, band, *(
        torch.from_numpy(x) for x in (qs, te, ns, ms, pm)))]
    want = [np.asarray(x) for x in jax.jit(jax.vmap(
        lambda q, t, n, p: jbanded.banded_fill(mode, q, t, n, band, p, True)
    ))(jnp.asarray(qs), jnp.asarray(te), jnp.asarray(ns[:, 0]),
       jnp.asarray(ps))]
    for g, w in zip(got[:4], want[:4]):
        assert np.array_equal(g.astype(np.float64), w.astype(np.float64))
    V = 2 * band + 1
    assert np.array_equal(got[4][:, :, :V], want[4][:, :, :V])
    for pair, (tmode, ab) in ties.items():
        if tmode == mode:
            assert (got[2][pair], got[3][pair]) == ab, pair
