"""The port's banded pointer fill and window walk against the JAX
package's banded engine.

The same seeded numpy inputs (tests/test_torch_banded.py's helpers) go
through the JAX package's two banded routes, ``banded_pallas_full``
(interpret mode on the CPU) and the vmapped XLA ``banded_fill``, and
through the port's ``ops/banded.banded_full`` on CPU tensors (its plain
version): best, edge, the start info a/b and every pointer byte at lanes <
V must be equal, on similar pairs, on tie-heavy pairs and on the tie inputs
of tests/banded_ties.py at the launch's strip and warp edges. Then the
window walk against ``_walk_banded``, on the fills' pointers and on the
drawn walks of tests/walk_cases.py."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import banded_ties
import numpy as np
import pytest
import torch
import walk_cases

from aligntools_tpu.engine import banded as jbanded
from aligntools_tpu_torch.engine import banded as tbanded
from aligntools_tpu_torch.engine import device_tb
from aligntools_tpu_torch.ops import banded as tops
from aligntools_tpu_torch.params import AlignParams
from test_torch_banded import (ALPHA, PARAM_SETS, SET_IDS, _encode,
                               _jax_pallas, _jax_xla, _pairs, _port, _same)


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
