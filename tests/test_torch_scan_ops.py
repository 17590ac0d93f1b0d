"""The port's score fills against the JAX package's Pallas kernels.

The same seeded numpy inputs go through ``pallas_scores`` /
``pallas_fit_scores`` (interpret mode on the CPU) and through the port's
``scores`` / ``fit_scores`` on CPU tensors, which run the kernels' plain
PyTorch versions. Scores are integer-valued float32 with -inf borders, so
the comparison is exact (``np.array_equal``; edit as integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligntools_tpu.ops import pallas_scan as ps
from aligntools_tpu.params import AlignParams
from aligntools_tpu_torch import convert
from aligntools_tpu_torch.ops import scan

B, M_PAD, N_PAD = 8, 64, 256
PARAMS = {
    "default": AlignParams(),
    "posmis": AlignParams(match=2, mismatch=3, gap_open=-4, gap_extend=-1,
                          jump=-7),
}


def _inputs(seed, fit=False):
    """Ragged pairs in the kernels' int32 sentinel layout; pair 0 forces a
    gap spanning most of its row (deep in-row propagation)."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)
    ms = rng.integers(1, M_PAD + 1, B).astype(np.int32)
    ns = rng.integers(1, N_PAD + 1, B).astype(np.int32)
    ms[0], ns[0] = M_PAD, N_PAD
    if fit:
        ns = np.maximum(ns, ms)
    qs = rng.choice(alpha, (B, M_PAD))
    ts = rng.choice(alpha, (B, N_PAD))
    ts[0, :] = ord("C")
    ts[0, :16] = qs[0, :16]
    ts[0, -48:] = qs[0, 16:]
    qs[np.arange(M_PAD)[None, :] >= ms[:, None]] = -1
    ts[np.arange(N_PAD)[None, :] >= ns[:, None]] = -2
    allow = (rng.random((B, N_PAD)) > 0.1).astype(np.float32)
    return qs, ts, allow, ns[:, None], ms[:, None]


def _pmat(p):
    """The JAX entry points' params row, built independently of convert."""
    pm = np.zeros((1, 8), np.float32)
    pm[0, :5] = [p.match, p.mismatch, p.gap_open, p.gap_extend, p.jump]
    return pm


@pytest.mark.parametrize("pname", sorted(PARAMS))
def test_params_matrix_layout(pname):
    got = convert.params_matrix(PARAMS[pname])
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), _pmat(PARAMS[pname]))


@pytest.mark.parametrize("pname", sorted(PARAMS))
@pytest.mark.parametrize("mode", ["global", "local", "overlap", "edit"])
def test_scores_match_pallas(mode, pname):
    qs, ts, _, ns, ms = _inputs(11)
    pm = _pmat(PARAMS[pname])
    want = np.asarray(ps.pallas_scores(
        mode, M_PAD, N_PAD, True, *(jnp.asarray(a) for a in (qs, ts, ns, ms,
                                                               pm))))
    tq, tt, _, tn, tm, tp = convert.kernel_inputs_from_numpy(
        qs, ts, None, ns, ms, pm, "cpu")
    got = scan.scores(mode, M_PAD, N_PAD, tq, tt, tn, tm, tp).numpy()
    if mode == "edit":
        assert got.dtype == np.int32
        assert np.array_equal(got.astype(np.int64), want.astype(np.int64))
    else:
        assert got.dtype == np.float32
        assert np.array_equal(got, want)


@pytest.mark.parametrize("pname", sorted(PARAMS))
@pytest.mark.parametrize("use_jump", [False, True])
def test_fit_scores_match_pallas(use_jump, pname):
    qs, ts, allow, ns, ms = _inputs(13, fit=True)
    pm = _pmat(PARAMS[pname])
    want = np.asarray(ps.pallas_fit_scores(
        use_jump, M_PAD, N_PAD, True,
        *(jnp.asarray(a) for a in (qs, ts, allow, ns, ms, pm))))
    args = convert.kernel_inputs_from_numpy(qs, ts, allow, ns, ms, pm, "cpu")
    got = scan.fit_scores(use_jump, M_PAD, N_PAD, *args).numpy()
    assert np.array_equal(got, want)


def test_cpu_tensors_take_the_plain_version():
    qs, ts, allow, ns, ms = _inputs(17, fit=True)
    args = convert.kernel_inputs_from_numpy(qs, ts, allow, ns, ms,
                                            _pmat(AlignParams()), "cpu")
    scan.reset_counts()
    scan.scores("local", M_PAD, N_PAD, *args[:2], *args[3:])
    scan.fit_scores(True, M_PAD, N_PAD, *args)
    assert scan.plain_calls == 2
    assert all(v == 0 for v in scan.launches.values())
    scan.reset_counts()


def test_wrapper_rejects_bad_inputs():
    qs, ts, _, ns, ms = _inputs(19)
    tq, tt, _, tn, tm, tp = convert.kernel_inputs_from_numpy(
        qs, ts, None, ns, ms, _pmat(AlignParams()), "cpu")
    with pytest.raises(ValueError, match="qs"):
        scan.scores("global", M_PAD, N_PAD, tq.to(torch.int64), tt, tn, tm, tp)
    with pytest.raises(ValueError, match="ts"):
        scan.scores("global", M_PAD, N_PAD + 128, tq, tt, tn, tm, tp)
    with pytest.raises(ValueError, match="contiguous"):
        scan.scores("global", M_PAD, N_PAD, tq,
                    torch.cat([tt, tt], dim=1)[:, ::2], tn, tm, tp)
    with pytest.raises(ValueError, match="mode"):
        scan.scores("fit", M_PAD, N_PAD, tq, tt, tn, tm, tp)


@pytest.mark.parametrize("n_pad", [128, 2048, 4096, 32768, 65536])
def test_launch_shape_covers_the_row(n_pad):
    threads, wmax = scan.launch_shape(n_pad)
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert threads * wmax >= n_pad
    assert threads * (wmax - 1) < n_pad
