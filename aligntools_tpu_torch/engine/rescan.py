"""Checkpoint-rescan traceback on the card: one pair's alignment rows in
O(m·n/S) memory.

Counterpart of ``aligntools_tpu/engine/rescan.py``. The rows path keeps one
packed pointer byte a DP cell (a nibble, or two bits for overlap), so a pair
whose pointers pass the device budget cannot be filled whole. This engine
fills it twice instead:

  forward   one fill of the whole matrix that stores no pointers and keeps
            the (M, L, U[, J]; overlap M) state rows of every S-th row,
            (m_pad/S) x states x (n_pad+1) float32, float64 in the double
            instances (``ops/blocked.py``
            ``blocked_ckpt_fill``; the JAX ``_forward_ckpt``), and the start
            info of the pointer fill;
  backward  the traceback visits rows bottom-up, so the row blocks are
            refilled from their checkpoints one at a time, with pointers
            (S / rpb x n_pad bytes live at once; ``blocked_refill``, the JAX
            ``_refill_block``), and walked on the card by the walk kernel
            in its resumable mode (``device_tb.walk(..., pause=True)``): it
            stops at the block's row 0 with its state, and the walk goes on
            in the block above from (state, S, j).

Both fills are instances of the column-blocked pointer fill
(``csrc/blocked_fill.cu``), never the flat register strips: a pair comes
here only when its pointers pass the budget (~38 GB on an 80 GB H100), so
its target is far past the flat kernels' 8,192 columns; one route halves the
kernel work, and at one column block the blocked fill runs any n correctly.
The refills run the forward's recurrences, tie-breaks and wavefront from a
checkpoint, so each block's bytes are the whole-matrix fill's rows, bit for
bit, and the rows equal the rows path's (and the JAX engine's). Total
refill work is at most the forward's; the walk takes O(m + n) steps and one
launch a block.

The walked columns stay on the device in one (m + n + 1)-byte buffer a row
and cross to the host once at the end; each block costs one small copy of
the walk's scalars (count, i, j, error, state).
"""

from __future__ import annotations

import numpy as np
import torch

from aligntools_tpu_torch import layout
from aligntools_tpu_torch.backend import resolve_device
from aligntools_tpu_torch.convert import params_matrix
from aligntools_tpu_torch.engine import device_tb, select
from aligntools_tpu_torch.exact import check_f32_exact
from aligntools_tpu_torch.ops import blocked
from aligntools_tpu_torch.params import AlignResult

# a checkpoint's state rows by mode (the JAX engine's table)
_N_STATE_ROWS = blocked.CK_STATES


def pad_n(n: int) -> int:
    """The port's n_pad: the blocked fill's 16-column grid."""
    return max(16, -(-n // 16) * 16)


def _plane(seq: bytes, size: int, fill: int) -> np.ndarray:
    a = np.full((1, size), fill, np.int32)
    a[0, : len(seq)] = np.frombuffer(seq, np.uint8)
    return a


def pair_tensors(mode, q: bytes, t: bytes, sites, S: int, device):
    """One pair's fill inputs at stride S on ``device``: ((qs, ts, allow,
    ns, ms), m_pad, n_pad); query pad -1, target pad -2, ``allow`` 0.0 at
    fit's junction sites (None without them)."""
    m_pad = max(S, -(-len(q) // S) * S)
    n_pad = pad_n(len(t))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    allow = None
    if mode == "fit" and sites is not None:
        al = np.ones((1, n_pad), np.float32)
        al[0, [x for x in sites if 0 <= x < n_pad]] = 0.0
        allow = put(al)
    return ((put(_plane(q, m_pad, -1)), put(_plane(t, n_pad, -2)), allow,
             put(np.full((1, 1), len(t), np.int32)),
             put(np.full((1, 1), len(q), np.int32))), m_pad, n_pad)


def rescan_align(mode, q: bytes, t: bytes, params, sites=None,
                 stride: int = 256, *, device="cuda",
                 dtype=torch.float32) -> AlignResult:
    """One pair's full alignment by checkpoint-rescan traceback on
    ``device`` ("cuda" or "cpu", the kernels' plain versions). Rows are
    byte-equal to the rows path's; the pointers held at once are one S x
    n_pad block. ``stride`` is the row-block size S (checkpoint memory ~
    states * 4 * m * n / S bytes, twice that in double), a multiple of 8.
    ``dtype`` float64 runs the double instances of both fills (the rows
    path of ``api.align_pair`` for a pair past float32's exact integers);
    float32 refuses such a pair, as the JAX rescan does."""
    if mode == "edit":
        raise ValueError("edit mode has no traceback (alignment.h:291-315)")
    if mode == "fit" and len(q) > len(t):
        raise ValueError("first sequence must be shorter than the second")
    m, n = len(q), len(t)
    if dtype != torch.float64:
        check_f32_exact(params, m, n, mode)
    S = int(stride)
    if S % 8:
        raise ValueError("stride must be a multiple of 8")
    dev = resolve_device(device)
    if not q or not t:  # no DP cell: the borders' result, as the rows path
        if mode == "fit" and not t:
            raise RuntimeError("fit: no finite traceback start (reference UB)")
        from aligntools_tpu_torch.batch import _empty_result

        return _empty_result(mode, q, t, params, True)
    use_jump = mode == "fit" and sites is not None
    rpb = layout.rows_per_byte(mode, use_jump, S)
    c_blk = select.blocked_c_blk(dtype == torch.float64)
    (qs, ts, allow, ns, ms), m_pad, n_pad = pair_tensors(mode, q, t, sites,
                                                         S, dev)
    pmat = params_matrix(params, dev, dtype)

    score, a, b, cks = blocked.blocked_ckpt_fill(
        mode, use_jump, S, m_pad, n_pad, c_blk, qs, ts, allow, ns, ms, pmat)
    # one copy: the score's words (one float32's, two of a double), a, b
    words = score.element_size() // 4
    fin = torch.cat([score.view(torch.int32), a, b]).cpu().numpy()
    score = float(fin[:words].view(np.float32 if words == 1
                                   else np.float64)[0])
    fa, fb = int(fin[words]), int(fin[words + 1])
    # the start cell, as the rows path maps it (device_tb.walk_starts)
    if mode == "global":
        state, i, j = fa, m, n  # 0/1/2 = LOW/MID/UPP
    elif mode == "local":
        state, i, j = device_tb.MID, fa, fb
    elif mode == "fit":
        if not np.isfinite(score):
            raise RuntimeError("fit: no finite traceback start (reference UB)")
        state = device_tb.LOW if fa else device_tb.MID
        i, j = m, fb
    else:  # overlap
        state, i, j = 0, m, fa

    stop_j0 = mode in ("global", "local")
    cols = torch.zeros((2, m + n + 1), dtype=torch.uint8, device=dev)
    count = 0
    finished = i <= 0
    k = (i - 1) // S if i > 0 else -1
    while k >= 0 and not finished:
        base = k * S
        q_blk = qs[:, base : base + S]
        ptrs = blocked.blocked_refill(
            mode, use_jump, S, n_pad, c_blk, cks[:, k].contiguous(), base,
            q_blk, ts, allow, ns, ms, pmat, rpb)
        starts = torch.tensor([[state], [i - base], [j]], dtype=torch.int32,
                              device=dev)
        c1, c2, scal = device_tb.walk(mode, rpb, ptrs, q_blk, ts, starts,
                                      pause=True)
        steps, fi, fj, err, state = (int(x) for x in scal[:, 0].cpu())
        if err:
            raise RuntimeError("traceback hit unset pointer (reference UB)")
        if count + steps > cols.shape[1]:
            raise RuntimeError("traceback ran past m + n steps (reference "
                               "UB)")
        cols[0, count : count + steps] = c1[:steps, 0]
        cols[1, count : count + steps] = c2[:steps, 0]
        count += steps
        i, j = base + fi, fj
        if state >= device_tb.DONE or (stop_j0 and j == 0):
            finished = True
        elif fi != 0:
            raise RuntimeError("rescan walk stopped inside a row block (bug)")
        k -= 1
    if not finished and mode == "overlap" and j > 0:
        # the walk left row 0 with target left: the reference reads pointer
        # row -1 here (UB); fail as the walks do
        raise RuntimeError("traceback hit unset pointer (reference UB)")
    rows = cols[:, :count].cpu().numpy()[:, ::-1]
    r1, r2 = rows[0].tobytes(), rows[1].tobytes()
    if mode == "global":
        # the unconsumed prefix (alignment.h:398-407)
        r1 = q[:i] + b"-" * j + r1
        r2 = b"-" * i + t[:j] + r2
    return AlignResult(score, r1, r2)
