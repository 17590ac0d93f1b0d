"""The port's column-blocked fills against the JAX package's Pallas ones.

The same seeded numpy inputs go through ``pallas_blocked.blocked_scores``
and ``blocked_ptr_fill`` (interpret mode on the CPU) and through the
port's entries of the same names on CPU tensors, which run the flat
fills' plain PyTorch versions. At B 8, m_pad 64, n_pad 512 and c_blk 128
(four column blocks) everything is compared exactly: every score (edit's
as an integer), the start info a/b and every byte of the pointer tensor,
pad rows and pad columns included. The same holds on inputs whose start-info
candidates tie across blocks (``tests/blocked_ties.py``), which the
wavefront kernels merge in block order."""

import importlib.util
import json
import os

import blocked_ties as ties
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligntools_tpu.ops import pallas_blocked as jblocked
from aligntools_tpu_torch import convert
from aligntools_tpu_torch.ops import blocked

B, M_PAD, N_PAD, C_BLK = 8, 64, 512, 128
ALPHA = list(b"ACGT")
# the cases of tests/test_blocked.py: six score variants, nine
# (mode, jump, rows per byte) pointer layouts
SCORE_CASES = [("global", False), ("local", False), ("fit", False),
               ("fit", True), ("overlap", False), ("edit", False)]
PTR_CASES = [
    ("global", False, 1), ("local", False, 1), ("fit", True, 1),
    ("overlap", False, 1), ("global", False, 2), ("local", False, 2),
    ("fit", False, 2), ("overlap", False, 2), ("overlap", False, 4),
]


def blocked_inputs(seed, fit, n_pad=N_PAD):
    """Ragged pairs over four column blocks (at n_pad 512) in the kernels'
    int32 sentinel layout (query pad -1, target pad -2), three junction
    sites per target (allow = 0 there), and the params row."""
    rng = np.random.default_rng(seed)
    ms = rng.integers(1, M_PAD + 1, B)
    ns = rng.integers(1, n_pad + 1, B)
    ms[0], ns[0] = M_PAD, n_pad
    ns[1] = C_BLK  # ends on a block edge
    if fit:
        ns = np.maximum(ns, ms)
    qs = np.full((B, M_PAD), -1, np.int32)
    ts = np.full((B, n_pad), -2, np.int32)
    allow = np.ones((B, n_pad), np.float32)
    for k in range(B):
        qs[k, : ms[k]] = rng.choice(ALPHA, ms[k])
        ts[k, : ns[k]] = rng.choice(ALPHA, ns[k])
        allow[k, rng.integers(0, ns[k], 3)] = 0.0
    pm = np.zeros((1, 8), np.float32)
    pm[0, :5] = [2, -3, -4, -1, -7]
    return (qs, ts, allow, ns[:, None].astype(np.int32),
            ms[:, None].astype(np.int32), pm)


def port_args(arrs):
    return convert.kernel_inputs_from_numpy(*arrs, "cpu")


@pytest.mark.parametrize("mode,use_jump", SCORE_CASES)
def test_blocked_scores_match_jax(mode, use_jump):
    arrs = blocked_inputs(61, mode == "fit")
    want = np.asarray(jblocked.blocked_scores(
        mode, use_jump, M_PAD, N_PAD, C_BLK, True,
        *(jnp.asarray(a) for a in arrs)))
    before = blocked.plain_calls
    got = blocked.blocked_scores(mode, use_jump, M_PAD, N_PAD, C_BLK,
                                 *port_args(arrs))
    assert blocked.plain_calls == before + 1
    assert got.dtype == (torch.int32 if mode == "edit" else torch.float32)
    if mode == "edit":  # the Pallas kernel carries edit in f32
        want = want.astype(np.int32)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode,use_jump,rpb", PTR_CASES)
def test_blocked_ptr_fill_matches_jax(mode, use_jump, rpb):
    arrs = blocked_inputs(67, mode == "fit")
    want = jblocked.blocked_ptr_fill(
        mode, use_jump, M_PAD, N_PAD, C_BLK, True,
        *(jnp.asarray(a) for a in arrs), rows_per_byte=rpb)
    got = blocked.blocked_ptr_fill(mode, use_jump, M_PAD, N_PAD, C_BLK,
                                   *port_args(arrs), rpb)
    assert got[3].shape == (B, M_PAD // rpb, N_PAD)
    for name, g, w in zip(("score", "a", "b", "ptrs"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name


@pytest.mark.parametrize("kind", ["scores", "ptr"])
def test_blocked_results_do_not_depend_on_c_blk(kind):
    args = port_args(blocked_inputs(71, True))
    outs = []
    for c_blk in (C_BLK, 2 * C_BLK):
        if kind == "scores":
            outs.append((blocked.blocked_scores(
                "fit", True, M_PAD, N_PAD, c_blk, *args),))
        else:
            outs.append(blocked.blocked_ptr_fill(
                "local", False, M_PAD, N_PAD, c_blk, *args, 2))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_blocked_entries_check_their_blocks():
    qs, ts, allow, ns, ms, pm = port_args(blocked_inputs(73, False))
    # both fills take a ragged last block, not a c_blk or an n_pad off the
    # 16-column grid
    with pytest.raises(ValueError, match="multiple of 16"):
        blocked.blocked_scores("local", False, M_PAD, N_PAD, 120, qs, ts,
                               None, ns, ms, pm)
    with pytest.raises(ValueError, match="multiple of 16"):
        blocked.blocked_ptr_fill("local", False, M_PAD, N_PAD, 120, qs, ts,
                                 None, ns, ms, pm, 1)
    t520 = torch.cat([ts, ts[:, :8]], dim=1)
    with pytest.raises(ValueError, match="n_pad 520 a multiple of 16"):
        blocked.blocked_scores("local", False, M_PAD, 520, C_BLK, qs, t520,
                               None, ns, ms, pm)
    with pytest.raises(ValueError, match="n_pad 520 a multiple of 16"):
        blocked.blocked_ptr_fill("local", False, M_PAD, 520, C_BLK, qs, t520,
                                 None, ns, ms, pm, 1)
    q48, m48 = qs[:, :48].contiguous(), torch.clamp(ms, max=48)
    with pytest.raises(ValueError, match="multiple of 8"):
        blocked.blocked_ptr_fill("overlap", False, 48, N_PAD, C_BLK, q48, ts,
                                 None, ns, m48, pm, 4)
    with pytest.raises(ValueError, match="jump state"):
        blocked.blocked_scores("local", True, M_PAD, N_PAD, C_BLK, qs, ts,
                               allow, ns, ms, pm)


@pytest.mark.parametrize("mode,use_jump,rpb", [
    ("local", False, 2), ("fit", True, 1), ("overlap", False, 4)])
def test_blocked_ptr_fill_takes_a_ragged_last_block(mode, use_jump, rpb):
    """n_pad 1,152 at c_blk 512 (two full blocks and one of 128 columns):
    the pointer fill takes it (on CPU tensors, its plain version, counted)
    and gives the flat plain version's outputs; so does the score fill."""
    from aligntools_tpu_torch.ops import ptr

    n_pad, c_blk = 1152, 512
    arrs = blocked_inputs(97, mode == "fit", n_pad)
    qs, ts, allow, ns, ms, pm = port_args(arrs)
    blocked.reset_counts()
    got = blocked.blocked_ptr_fill(mode, use_jump, M_PAD, n_pad, c_blk, qs,
                                   ts, allow, ns, ms, pm, rpb)
    assert (blocked.plain_calls, blocked.launches["blocked_ptr"]) == (1, 0)
    want = ptr.ptr_fill_plain(mode, use_jump, M_PAD, n_pad, qs, ts, allow,
                              ns, ms, pm, rpb)
    for name, g, w in zip(("score", "a", "b", "ptrs"), got, want):
        assert torch.equal(g, w), name
    from aligntools_tpu_torch.ops import scan

    got = blocked.blocked_scores(mode, use_jump, M_PAD, n_pad, c_blk, qs, ts,
                                 allow, ns, ms, pm)
    assert (blocked.plain_calls, blocked.launches["blocked_scores"]) == (2, 0)
    if mode == "fit":
        want = scan.fit_scores_plain(use_jump, M_PAD, n_pad, qs, ts, allow,
                                     ns, ms, pm)
    else:
        want = scan.scores_plain(mode, M_PAD, n_pad, qs, ts, ns, ms, pm)
    assert torch.equal(got, want)
    blocked.reset_counts()


def test_tie_inputs_really_tie():
    """Each tie pair's two blocks, read alone (the other pattern blanked),
    give the same score, at the rows (local) or from the matrices (fit) the
    builder states, and the whole pair keeps the stated block's candidate;
    the edge pairs end on and one past block edges."""
    arrs = ties.tie_inputs(C_BLK, 79)
    assert (ties.M_PAD, ties.BLOCKS * C_BLK) == (M_PAD, N_PAD)

    def fill(mode, a):
        return blocked.blocked_ptr_fill(mode, False, M_PAD, N_PAD, C_BLK,
                                        *port_args(a), 1)

    for mode in ("local", "fit"):
        full = fill(mode, arrs)
        alone = [fill(mode, ties.solo(arrs, C_BLK, keep)) for keep in (0, 2)]
        for k, (kmode, kept, held) in ties.TIES.items():
            if kmode != mode:
                continue
            want = 2 * ties.K_LOCAL if mode == "local" else 2 * M_PAD - 4
            assert [float(x[0][k]) for x in (alone[0], alone[1], full)] == [
                want] * 3, k
            assert [int(x[1][k]) for x in alone] == list(held), k
            for blk, x in zip((0, 2), alone):
                assert (int(x[2][k]) - 1) // C_BLK == blk, k
            assert (int(full[2][k]) - 1) // C_BLK == kept, k
            assert int(full[1][k]) == held[kept // 2], k
    ns = arrs[3][:, 0]
    assert [int(ns[k]) % C_BLK for k in ties.EDGE_PAIRS] == [0, 1, 0, 1, 1, 0]


@pytest.mark.parametrize("mode,use_jump", SCORE_CASES)
def test_blocked_scores_on_ties_match_jax(mode, use_jump):
    arrs = ties.tie_inputs(C_BLK, 83)
    want = np.asarray(jblocked.blocked_scores(
        mode, use_jump, M_PAD, N_PAD, C_BLK, True,
        *(jnp.asarray(a) for a in arrs)))
    got = blocked.blocked_scores(mode, use_jump, M_PAD, N_PAD, C_BLK,
                                 *port_args(arrs))
    if mode == "edit":
        want = want.astype(np.int32)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode,use_jump,rpb", PTR_CASES)
def test_blocked_ptr_fill_on_ties_matches_jax(mode, use_jump, rpb):
    arrs = ties.tie_inputs(C_BLK, 89)
    want = jblocked.blocked_ptr_fill(
        mode, use_jump, M_PAD, N_PAD, C_BLK, True,
        *(jnp.asarray(a) for a in arrs), rows_per_byte=rpb)
    got = blocked.blocked_ptr_fill(mode, use_jump, M_PAD, N_PAD, C_BLK,
                                   *port_args(arrs), rpb)
    for name, g, w in zip(("score", "a", "b", "ptrs"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name


def test_blocked_wavefront_buffers_are_checked():
    """The wrapper's wavefront buffers: _scratch's shapes pass, a buffer of
    another shape or type raises, the counters start at 0, and a grid past
    the int32 ticket counter raises; a column block past C_BLK_MAX raises
    before anything is computed."""
    Bs, nblk = 3, N_PAD // C_BLK
    edges, flags, cand = blocked._scratch(Bs, nblk, M_PAD, "cpu")
    blocked._check_scratch(edges, flags, cand, Bs, nblk, M_PAD)
    assert not flags.any()
    bad = {"edges": (edges[:, :, :, 1:], flags, cand),
           "flags": (edges, flags[1:], cand),
           "cand": (edges, flags, cand[:, 1:])}
    for name, args in bad.items():
        with pytest.raises(ValueError, match=name):
            blocked._check_scratch(*args, Bs, nblk, M_PAD)
    with pytest.raises(ValueError, match="cand"):
        blocked._check_scratch(edges, flags, cand.float(), Bs, nblk, M_PAD)
    with pytest.raises(ValueError, match="ticket"):
        blocked._check_scratch(edges, flags, cand, 2**20, 2**11, M_PAD)
    qs, ts, allow, ns, ms, pm = port_args(blocked_inputs(97, False))
    wide = 2 * blocked.C_BLK_MAX
    with pytest.raises(ValueError, match="C_BLK_MAX"):
        blocked.blocked_scores("local", False, M_PAD, wide, wide, qs, ts,
                               None, ns, ms, pm)
    with pytest.raises(ValueError, match="C_BLK_MAX"):
        blocked.blocked_ptr_fill("local", False, M_PAD, wide, wide, qs, ts,
                                 None, ns, ms, pm, 1)


def test_chip_smoke_sms_in_use_reads_the_trace(tmp_path):
    """chip_smoke's profile phase weighs each fill and walk launch's SMs
    (min(SMs, its CTAs)) by its device time; kernels without a grid, and
    other kernels, are left out."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def kernel(name, dur, grid):
        return {"cat": "kernel", "name": name, "dur": dur,
                "args": {"grid": grid} if grid else {}}

    events = [kernel("void bptr_affine<2, true>(...)", 30, [640, 1, 1]),
              kernel("void bptr_affine<2, true>(...)", 10, [10, 1, 1]),
              kernel("walk_kernel", 5, [1, 1, 1]),
              kernel("walk_kernel", 5, None),
              kernel("elementwise_kernel", 50, [9, 1, 1]),
              {"cat": "cpu_op", "name": "aten::zeros", "dur": 7}]
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    got = cs.sms_in_use(str(trace), 132)
    assert got["fill"] == (30 * 132 + 10 * 10) / 40
    assert got["walk"] == 1.0
    assert got["copies"] is None and got["allocation"] is None
