"""The port's traceback walk against the JAX package's device walks.

The pointer tensors come from the port's plain pointer fill (held equal
to the Pallas kernel's in test_torch_ptr_ops.py) at rpb 1, 2 and 4, and
from tests/walk_cases.py (paths drawn to cross the walk kernel's tiles).
The same tensors and starts go through ``device_tb._walk_affine`` /
``_walk_overlap`` (jax on the CPU) and the port's ``walk`` on CPU tensors
(its plain version); the whole (n_steps, B) column buffers and every
scalar must be equal."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import walk_cases

from aligntools_tpu.engine import device_tb as jtb
from aligntools_tpu_torch import convert
from aligntools_tpu_torch.engine import device_tb as ttb
from aligntools_tpu_torch.ops import ptr
from test_torch_ptr_ops import CASES, M_PAD, N_PAD, pmat, ptr_inputs


def _fill(mode, use_jump, rpb, seed=71, params=None):
    arrs = ptr_inputs(seed, mode == "fit")
    pm = pmat() if params is None else params
    qs, ts, allow, ns, ms, pm = convert.kernel_inputs_from_numpy(*arrs, pm,
                                                                 "cpu")
    score, a, b, ptrs = ptr.ptr_fill(mode, use_jump, M_PAD, N_PAD, qs, ts,
                                     allow, ns, ms, pm, rpb)
    return qs, ts, ptrs, ttb.walk_starts(mode, score, a, b, ms, ns)


def _jax_walk(mode, rpb, ptrs, qs, ts, starts):
    n_steps = qs.shape[1] + ts.shape[1] + 1
    j = [jnp.asarray(x.numpy()) for x in (ptrs, qs, ts)]
    s = [jnp.asarray(x) for x in starts.numpy()]
    if mode == "overlap":
        c1, c2, cnt, fi, fj, _, err = jtb._walk_overlap(
            n_steps, 1, False, rpb, 0, *j, s[1], s[2])
    else:
        c1, c2, cnt, fi, fj, _, err = jtb._walk_affine(
            mode != "fit", n_steps, 1, rpb == 2, mode == "local", 0, *j,
            *s)
    scal = np.stack([np.asarray(x).astype(np.int32)
                     for x in (cnt, fi, fj, err)])
    return np.asarray(c1), np.asarray(c2), scal


def _compare(mode, rpb, ptrs, qs, ts, starts):
    got = [x.numpy() for x in ttb.walk(mode, rpb, ptrs, qs, ts, starts)]
    want = _jax_walk(mode, rpb, ptrs, qs, ts, starts)
    for name, g, w in zip(("cols1", "cols2", "scal"), got, want):
        assert g.shape == w.shape and np.array_equal(g, w), name
    return got


@pytest.mark.parametrize("mode,use_jump,rpb", CASES)
def test_walk_matches_jax(mode, use_jump, rpb):
    qs, ts, ptrs, starts = _fill(mode, use_jump, rpb)
    cols1, _, scal = _compare(mode, rpb, ptrs, qs, ts, starts)
    assert scal[0].max() > 0 and not scal[3][2:].any()
    assert not cols1[scal[0].max():].any()


@pytest.mark.parametrize("mode,rpb,unset", [
    ("global", 1, 0x07), ("global", 2, 0x33), ("fit", 1, 0x07),
    ("fit", 2, 0x33), ("overlap", 1, 0x03), ("overlap", 4, 0xFF),
])
def test_unset_pointer_flags_err(mode, rpb, unset):
    """A tensor whose pointers are all unset: both walks flag every pair
    that takes a step (the reference's UB), and assembly raises."""
    qs, ts, ptrs, starts = _fill(mode, False, rpb)
    bad = torch.full_like(ptrs, unset)
    _, _, scal = _compare(mode, rpb, bad, qs, ts, starts)
    assert scal[3].any()
    with pytest.raises(RuntimeError, match="unset pointer"):
        ttb.assemble(mode, np.zeros((0, 8), np.uint8),
                     np.zeros((0, 8), np.uint8), scal,
                     [(b"A", b"C")] * 8)


def test_local_home_emits_then_stops():
    """Local at rpb 1 and 2: the walk ends on a HOME code having emitted
    that step's column (the count includes it)."""
    for rpb in (1, 2):
        qs, ts, ptrs, starts = _fill("local", False, rpb, seed=5,
                                     params=pmat(1, -2, -5, -1))
        cols1, _, scal = _compare("local", rpb, ptrs, qs, ts, starts)
        assert (scal[0] >= 1).all() and not scal[3].any()
        last = cols1[scal[0] - 1, np.arange(cols1.shape[1])]
        assert (last != 0).all()


def test_cpu_tensors_take_the_plain_version():
    qs, ts, ptrs, starts = _fill("global", False, 2)
    ttb.reset_counts()
    ttb.walk("global", 2, ptrs, qs, ts, starts)
    assert (ttb.plain_calls, ttb.launches) == (1, 0)
    ttb.reset_counts()


def test_walk_behind_on_the_cpu_is_walk_and_stack():
    """On CPU tensors walk_behind is the plain walk with the ride-along
    rows stacked under its scalars, and join_walks does nothing."""
    qs, ts, ptrs, starts = _fill("fit", True, 1)
    score = torch.arange(qs.shape[0], dtype=torch.float32)
    want = ttb.walk("fit", 1, ptrs, qs, ts, starts)
    got = ttb.walk_behind("fit", 1, ptrs, qs, ts, starts,
                          ride=(score.view(torch.int32),))
    ttb.join_walks(qs.device)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2][:4], want[2])
    assert torch.equal(got[2][4].view(torch.float32), score)


def test_walk_rejects_bad_inputs():
    qs, ts, ptrs, starts = _fill("local", False, 2)
    with pytest.raises(ValueError, match="ptrs"):
        ttb.walk("local", 1, ptrs, qs, ts, starts)
    with pytest.raises(ValueError, match="starts"):
        ttb.walk("local", 2, ptrs, qs, ts, starts.to(torch.int64))
    with pytest.raises(ValueError, match="mode"):
        ttb.walk("edit", 2, ptrs, qs, ts, starts)
    with pytest.raises(ValueError, match="not a local layout"):
        ttb.walk("local", 4, ptrs, qs, ts, starts)


FLAT_CASES = walk_cases.flat_cases()


@pytest.mark.parametrize("case", FLAT_CASES,
                         ids=lambda c: f"{c.name}-{c.mode}-rpb{c.rpb}")
def test_walk_cases_match_jax(case):
    """Walks drawn across the kernel's tiles (long J, L, U and diagonal
    runs, fit past column 0, HOME on tile edges, unset codes, overlap's two
    ends, starts on tile edges): the plain walk gives the JAX walk's
    columns and scalars, and each case reaches what it was drawn for."""
    args = [torch.from_numpy(x) for x in (case.ptrs, case.qs, case.ts,
                                          case.starts)]
    _, _, scal = _compare(case.mode, case.rpb, *args)
    count, err = scal[0], scal[3]
    want_err = {"unset": 1, "diag": 1 if case.mode == "overlap" else 0}
    if case.name in want_err:
        assert err.any() == bool(want_err[case.name])
    else:
        assert not err.any()
    assert count.max() > 128  # more than a tile's width, at least once


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_overlap_reads_the_walk_under_the_fills(tmp_path):
    """chip_smoke.trace_overlap on a synthetic Chrome trace: busy time is
    the union of device spans, and a walk's time under the fill kernels is
    its overlap with their union."""
    import json

    ev = [("kernel", "bptr_affine", 0, 100), ("kernel", "bptr_affine", 50,
                                                100),
          ("kernel", "walk_kernel<false>", 120, 60),
          ("kernel", "walk_kernel<false>", 300, 50),
          ("gpu_memcpy", "Memcpy DtoH", 340, 20),
          ("cpu_op", "aten::cat", 0, 1000)]
    trace = tmp_path / "t.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"cat": c, "name": n, "ts": t, "dur": d} for c, n, t, d in ev]}))
    got = _chip_smoke().trace_overlap(str(trace))
    # busy: [0, 180) and [300, 360); the walk 110 us, 30 of it in [0, 150)
    assert got == pytest.approx({"busy_ms": 0.24, "walk_ms": 0.11,
                                 "walk_share_of_busy": 110 / 240,
                                 "walk_under_fill_ms": 0.03,
                                 "walk_under_fill_share": 30 / 110})
