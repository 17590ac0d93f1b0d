"""The blocked fills' register-strip row, on the CPU.

Their CUDA kernels (``csrc/blocked_fill.cu``) run each column block on the
flat fills' strips of 16 columns (8 for double; ``csrc/strip_row.cuh``),
latch start info per thread and merge the blocks' candidates in block
order. The tie inputs of ``tests/blocked_strip_ties.py`` put equal
candidates at the strip and warp edges inside a block and across a block
edge; here they are checked to tie, and the port's entries on CPU tensors
(the plain versions) are held to the JAX package's Pallas blocked pointer
and score fills (interpret mode), to its rescan's ``_forward_ckpt`` and
``_refill_block`` and to its ``seqpar_score`` on them, exactly. The card
tests hold the kernels to the same plain versions on the same inputs. The
pointer fills' launch shapes and their refusals are checked too."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import blocked_strip_ties as ties
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from aligntools_tpu.engine import rescan as jrescan
from aligntools_tpu.ops import pallas_blocked as jblocked
from aligntools_tpu.parallel import seqpar as jseqpar
from aligntools_tpu.params import AlignParams as JParams
from aligntools_tpu_torch import convert
from aligntools_tpu_torch.ops import blocked, ptr
from aligntools_tpu_torch.parallel import seqpar
from aligntools_tpu_torch.params import AlignParams

M_PAD, N_PAD, C_BLK = ties.M_PAD, ties.N_PAD, ties.C_BLK
PTR_CASES = [
    ("global", False, 1), ("local", False, 1), ("fit", True, 1),
    ("overlap", False, 1), ("global", False, 2), ("local", False, 2),
    ("fit", False, 2), ("overlap", False, 2), ("overlap", False, 4),
]
F32, F64 = torch.float32, torch.float64
SCORE_VARIANTS = ["global", "local", "fit", "fit+jump", "overlap", "edit"]


def _port(arrs, mode):
    return convert.kernel_inputs_from_numpy(*arrs, ties.pmat(mode), "cpu")


def _fill(mode, arrs, rpb=1, use_jump=False):
    return blocked.blocked_ptr_fill(mode, use_jump, M_PAD, N_PAD, C_BLK,
                                    *_port(arrs, mode), rpb)


def test_strip_tie_inputs_really_tie():
    """Each tie pair gives the (a, b) it names, and each of its two
    candidates, read alone (the other blanked), the same score at its own
    (a, b); the moved pairs' columns lie in block 1, at the strip and warp
    edges of its 64-thread launch, and pairs 12-14 straddle the block
    edge."""
    arrs = ties.tie_inputs(0)
    assert ptr.launch_shape(C_BLK) == (64, 16)
    for mode in ("local", "fit", "overlap"):
        full = _fill(mode, arrs)
        for k, (tie_mode, ab, halves) in ties.TIES.items():
            if tie_mode != mode:
                continue
            assert (int(full[1][k]), int(full[2][k])) == ab, k
            for which, (_, ab_alone) in enumerate(halves):
                alone = _fill(mode, ties.half(arrs, k, which))
                assert float(alone[0][k]) == float(full[0][k]), (k, which)
                assert (int(alone[1][k]), int(alone[2][k])) == ab_alone, (
                    k, which)
    # the candidates' columns: block 1's warp edge (local column 512),
    # strip edges, and both sides of the block edge
    local = {ab[1] - C_BLK for k, (_, ab, h) in ties.TIES.items()
             if k in ties.MOVED for ab in [ab] + [x[1] for x in h]}
    assert {512, 513, 103, 104, 112, 113} <= local
    edge = [ab[1] for k in (12, 13, 14) for _, ab in ties.TIES[k][2]]
    assert min(edge) <= C_BLK < max(edge)


@pytest.mark.parametrize("mode,use_jump,rpb", PTR_CASES)
def test_blocked_ptr_fill_on_strip_ties_matches_jax(mode, use_jump, rpb):
    """The port's blocked pointer fill (its plain version) equals the
    Pallas blocked pointer fill on the strip tie inputs: score, a, b and
    every pointer byte."""
    arrs = ties.tie_inputs(5)
    want = jblocked.blocked_ptr_fill(
        mode, use_jump, M_PAD, N_PAD, C_BLK, True,
        *(jnp.asarray(x) for x in (*arrs, ties.pmat(mode))),
        rows_per_byte=rpb)
    got = _fill(mode, arrs, rpb, use_jump)
    for name, g, w in zip(("score", "a", "b", "ptrs"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name


@pytest.mark.parametrize("variant", ["global", "local", "fit", "fit+jump",
                                     "overlap"])
def test_ckpt_and_refill_on_strip_ties_match_jax(variant):
    """The checkpoint forward (CKPT) and the row-block refills (SEED) of
    the blocked pointer fill, through their plain versions, against the JAX
    rescan's _forward_ckpt and _refill_block pair by pair: every checkpoint
    row over columns 0..n, the start info, and every refilled pointer
    byte."""
    mode, jump = variant.split("+")[0], variant.endswith("+jump")
    S = 16
    arrs = ties.tie_inputs(7)
    qs, ts, allow, ns, ms = arrs
    args = _port(arrs, mode)
    allow_t = args[2] if jump else None
    score, a, b, cks = blocked.blocked_ckpt_fill(
        mode, jump, S, M_PAD, N_PAD, C_BLK, args[0], args[1], allow_t,
        *args[3:])
    pm = ties.pmat(mode)[0, :5]
    for k in range(ties.B):
        n, m = int(ns[k, 0]), int(ms[k, 0])
        params = jnp.asarray(np.append(pm, m).astype(np.float32))
        fin, jcks = jrescan._forward_ckpt(
            mode, N_PAD, S, jump, jnp.asarray(qs[k]), jnp.asarray(ts[k]),
            jnp.int32(n), params, jnp.asarray(allow[k] > 0))
        assert np.array_equal(cks[k, ..., : n + 1].numpy(),
                              np.asarray(jcks)[..., : n + 1]), k
        fin = [np.asarray(x) for x in fin]
        assert float(score[k]) == float(fin[0]), k
        if mode in ("local", "fit"):
            assert (int(a[k]), int(b[k])) == (int(fin[1]), int(fin[2])), k
        else:
            assert int(a[k]) == int(fin[1]), k
        for blk in range(M_PAD // S):
            q_blk = qs[k : k + 1, blk * S : (blk + 1) * S]
            got = blocked.blocked_refill(
                mode, jump, S, N_PAD, C_BLK, cks[k : k + 1, blk].contiguous(),
                blk * S, torch.from_numpy(np.ascontiguousarray(q_blk)),
                args[1][k : k + 1], None if allow_t is None else
                allow_t[k : k + 1], args[3][k : k + 1], args[4][k : k + 1],
                args[5], 1)
            want = jrescan._refill_block(
                mode, N_PAD, S, jump, jnp.asarray(np.asarray(jcks)[blk]),
                jnp.int32(blk * S), jnp.asarray(q_blk[0]),
                jnp.asarray(ts[k]), jnp.int32(n), params,
                jnp.asarray(allow[k] > 0))
            assert np.array_equal(got[0].numpy(), np.asarray(want)[:, 1:]), (
                k, blk)


def _score_pmat(mode):
    """The strip ties' params of ``mode``; edit's substitution cost 1."""
    if mode == "edit":
        return np.array([[0, 1, 0, 0, 0, 0, 0, 0]], np.float32)
    return ties.pmat(mode)


@pytest.mark.parametrize("c_blk", [C_BLK, 768])
@pytest.mark.parametrize("variant", SCORE_VARIANTS)
def test_blocked_scores_on_strip_ties_match_jax(variant, c_blk):
    """The port's blocked score fill (its plain version) equals the Pallas
    blocked score fill (interpret mode, at the ties' column block) on the
    strip tie inputs, every pair's score bit for bit; at c_blk 768 the
    2,048 columns are three blocks, the last one ragged (512 wide)."""
    mode, jump = variant.split("+")[0], variant.endswith("+jump")
    arrs = ties.tie_inputs(11)
    pm = _score_pmat(mode)
    want = jblocked.blocked_scores(
        mode, jump, M_PAD, N_PAD, C_BLK, True,
        *(jnp.asarray(x) for x in (*arrs, pm)))
    qs, ts, allow, ns, ms, tp = convert.kernel_inputs_from_numpy(*arrs, pm,
                                                                 "cpu")
    got = blocked.blocked_scores(mode, jump, M_PAD, N_PAD, c_blk, qs, ts,
                                 allow if jump else None, ns, ms, tp)
    assert got.dtype == (torch.int32 if mode == "edit" else F32)
    assert np.array_equal(got.numpy().astype(np.float64),
                          np.asarray(want).ravel().astype(np.float64))


def _pair_params(mode):
    """``_score_pmat(mode)`` as AlignParams (the port's and the JAX
    package's)."""
    pm = _score_pmat(mode)[0]
    kw = dict(match=pm[0], mismatch=pm[1], gap_open=pm[2], gap_extend=pm[3],
              jump=pm[4])
    return AlignParams(**kw), JParams(**kw)


@pytest.mark.parametrize("variant", SCORE_VARIANTS)
def test_edge_scores_on_strip_ties_match_seqpar(variant):
    """The port's EDGE score fill (its plain version), chained by
    ``seqpar_score`` over two column slices of 1,024 (the ties' block edge
    is the slice edge) in chunks of 16 rows, gives the JAX seqpar_score of
    every tie pair on a mesh of two devices, bit for bit (fit+jump with no
    junction site: every column allowed)."""
    mode, jump = variant.split("+")[0], variant.endswith("+jump")
    qs, ts, allow, ns, ms = ties.tie_inputs(13)
    tp, jp = _pair_params(mode)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    sites = [] if jump else None
    for k in range(ties.B):
        q = bytes(qs[k, : ms[k, 0]].astype(np.uint8))
        t = bytes(ts[k, : ns[k, 0]].astype(np.uint8))
        want = jseqpar.seqpar_score(mode, q, t, jp, sites=sites, mesh=mesh)
        got = seqpar.seqpar_score(mode, q, t, tp, sites, device="cpu",
                                  loopback=2, chunk=16)
        assert got == want, (k, got, want)


@pytest.mark.parametrize("c_blk,dtype,shape", [
    (32, F32, (32, 16)), (128, F32, (32, 16)), (2048, F32, (128, 16)),
    (8192, F32, (512, 16)), (32, F64, (32, 8)), (128, F64, (32, 8)),
    (2048, F64, (256, 8)), (4096, F64, (512, 8))])
def test_ptr_launch_shape(c_blk, dtype, shape):
    """The blocked pointer fills' shape: the flat fill's rule
    (ptr.launch_shape) on the column block, the fewest whole warps of
    W-column strips (W 16; 8 for double)."""
    assert ptr.launch_shape(c_blk, dtype) == shape
    threads, width = shape
    assert threads * width >= c_blk > (threads - 32) * width


@pytest.mark.parametrize("n_pad,c_blk,dtype,edges", [
    (2048, 32, F32, [1] * 64),
    (4096, 128, F32, [7] * 32),
    (8576, 2048, F32, [127] * 4 + [23]),
    (16384, 8192, F32, [511, 511]),
    (8576, 2048, F64, [255] * 4 + [47]),
    (4224, 4096, F64, [511, 15])])
def test_edge_thread_of_every_block(n_pad, c_blk, dtype, edges):
    """The thread that owns each block's last column, (width - 1) // W:
    the last thread of a full block that its strips fill, an inner one at
    c_blk 32 (32 threads, 2 of them active) and in a ragged last block,
    neither thread 0 nor the CTA's last."""
    threads, _ = ptr.launch_shape(c_blk, dtype)
    widths = [min(c_blk, n_pad - c) for c in range(0, n_pad, c_blk)]
    got = [blocked.edge_thread(w, dtype) for w in widths]
    assert got == edges
    assert all(0 < e < threads for e in got)


def test_ptr_fills_refuse_a_block_past_their_cap():
    """Every pointer-fill entry refuses a column block past C_BLK_MAX (and
    the double instances past C_BLK_MAX64) before anything is computed;
    the shape rule refuses it too."""
    arrs = ties.tie_inputs(0)
    qs, ts, allow, ns, ms, pm = _port(arrs, "local")
    n_pad = 2 * blocked.C_BLK_MAX + 32
    wide = torch.full((ties.B, n_pad), -2, dtype=torch.int32)
    past = blocked.C_BLK_MAX + 16
    for pmx, cap in ((pm, "C_BLK_MAX"), (pm.double(), "C_BLK_MAX64")):
        c_blk = past if cap == "C_BLK_MAX" else blocked.C_BLK_MAX64 + 16
        with pytest.raises(ValueError, match=cap):
            blocked.blocked_ptr_fill("local", False, M_PAD, n_pad, c_blk, qs,
                                     wide, None, ns, ms, pmx, 1)
        with pytest.raises(ValueError, match=cap):
            blocked.blocked_ckpt_fill("local", False, 16, M_PAD, n_pad, c_blk,
                                      qs, wide, None, ns, ms, pmx)
        ck = torch.zeros((ties.B, 3, n_pad + 1), dtype=pmx.dtype)
        with pytest.raises(ValueError, match=cap):
            blocked.blocked_refill("local", False, 16, n_pad, c_blk, ck, 0,
                                   qs[:, :16].contiguous(), wide, None, ns,
                                   ms, pmx, 1)
    for c_blk, dtype in ((past, F32), (blocked.C_BLK_MAX64 + 16, F64)):
        with pytest.raises(ValueError, match="blocked fill"):
            ptr.launch_shape(c_blk, dtype)
