"""Pointer-emitting DP fill: the CUDA kernel's wrapper and its plain version.

Counterpart of ``aligntools_tpu/ops/pallas_ptr.py:pallas_ptr_fill`` (the
Pallas ``_ptr_kernel``), with its argument layout (``ops/scan.py``'s, plus
``allow``) and outputs:

  score  (B,) in params' dtype (float32; float64 for the double instances)
  a, b   (B,) int32 traceback-start info
           global   a = start state (0 L, 1 M, 2 U at (m, n))
           local    a = i_max, b = j_max (strict running argmax of M)
           fit      a = 1 when L wins the bottom row, b = j_max
           overlap  a = j_max (0 unless the bottom row's max beats 0)
  ptrs   (B, m_pad / rpb, n_pad) uint8, columns 1..n_pad, in the packed
         layout of ``layout.py``; every byte is written, pad rows and pad
         columns included (they read the sentinel chars: query pad -1,
         target pad -2), so two fills can be compared byte for byte.

Targets up to ``select.ptr_flat_cap`` columns (at most FLAT_REG_MAX_N_PAD,
the kernel's widest) take ``csrc/ptr_fill.cu`` (one CTA per pair, each
thread's strip of WIDTH columns and its row state in registers; see its
header); wider ones take the blocked pointer fill (``ops/blocked.py``) at
its column block, with a ragged last block where it does not divide
n_pad: same bytes, on either device. On a CUDA tensor a wrapper launches
its kernel or raises; on a CPU tensor ``ptr_fill`` runs
``ptr_fill_plain``, which fills one query row per step over whole (B,
n_pad) rows as the Pallas kernel does. Values are integer-valued float32
with true -inf borders, and every pointer is a comparison of such values
in the reference's argument order, so the two agree bit for bit.

The params row's dtype picks the instance: float32, or float64 for a pair
past float32's exact integers (``exact.py``; ``api.align_pair`` alone
sends it), whose values are exact integers below 2^53. The double
instances run strips of WIDTH64 columns, up to FLAT64_MAX_N_PAD; their
pointer bytes and start info are laid out as float32's, and the plain
version runs the same arithmetic in float64.
"""

from __future__ import annotations

import ctypes

import torch

from aligntools_tpu_torch import layout as L
from aligntools_tpu_torch.ops import scan

NEG = float("-inf")
BIG = 1 << 30  # the start column when no column qualifies
MODES = ("global", "local", "fit", "overlap")

launches = 0
launches64 = 0  # the double instances' launches (not in `launches`)
plain_calls = 0

# the kernel's strip width (its one template instance) and the most
# threads its CTA runs (so the 128 registers a thread may take). W 16, the
# fewest warps, beat W 4 and W 8 on every row of chip_smoke.py's ptr phase
# on the H100 but fit+jump at 2,048 columns, where W 8's lead was inside
# the spread of two timings of one instance (PERF.md).
WIDTH = 16
MAX_THREADS = 512
# the widest target the kernel takes: the routes read their cap from
# engine/select.py (ptr_flat_cap, at most this; by default this: from 4,224
# to 8,192 columns this kernel is 1.2-2.6x faster than the blocked one on
# the H100, chip_smoke.py's ptr phase, `cap` lines; PERF.md), and wider
# targets go to the blocked pointer fill (blocked_c_blk)
FLAT_REG_MAX_N_PAD = MAX_THREADS * WIDTH
# the double instances' strip width and widest target (csrc/ptr_fill.cu
# kWidth64: a double takes two registers)
WIDTH64 = 8
FLAT64_MAX_N_PAD = MAX_THREADS * WIDTH64


def reset_counts() -> None:
    global launches, launches64, plain_calls
    launches = launches64 = plain_calls = 0


def launch_shape(n_pad: int, dtype=torch.float32) -> tuple[int, int]:
    """(threads per CTA, strip width W) for targets up to n_pad: the fewest
    whole warps of W-column strips that cover n_pad (WIDTH, or WIDTH64 for
    the float64 instances)."""
    width, top = ((WIDTH64, FLAT64_MAX_N_PAD) if dtype == torch.float64
                  else (WIDTH, FLAT_REG_MAX_N_PAD))
    if not 0 < n_pad <= top:
        raise ValueError(f"n_pad {n_pad} is past the pointer kernel's "
                         f"{top} columns: the blocked fill takes it")
    return max(32, -(-n_pad // (32 * width)) * 32), width


def blocked_c_blk(n_pad: int, dtype=torch.float32) -> int | None:
    """The column block at which ``ptr_fill`` hands a target of n_pad
    columns to the blocked pointer fill, or None where the kernel takes it
    (up to ``select.ptr_flat_cap``)."""
    from aligntools_tpu_torch.engine import select

    f64 = dtype == torch.float64
    if n_pad <= select.ptr_flat_cap(f64):
        return None
    return select.blocked_c_blk(f64)


def _shift_in(x, col):
    return torch.cat([col, x[:, :-1]], dim=1)


def _first_eq_j(vec, target, mask, jc):
    """Smallest column j where vec == target within mask, else BIG."""
    hit = (vec == target[:, None]) & mask
    return torch.where(hit, jc, BIG).amin(dim=1).to(torch.int32)


def _masked_max(vec, mask):
    return torch.where(mask, vec, NEG).amax(dim=1)


def _border(mode, r, o, e):
    """Column 0's state values (M, L, U[, J]; overlap M) at row r, as the
    per-pair machines of ``aligntools_tpu/engine/scan.py`` carry them."""
    if mode == "overlap":
        return [0.0]
    if mode == "local":
        return [0.0, 0.0, 0.0]
    first = r == 0
    if mode == "global":  # M(0, 0) = 0, L(r, 0) = o + e*r, U(0, 0) = o
        return [0.0 if first else NEG, o + e * float(r), o if first else NEG]
    return [0.0 if first else NEG, NEG, 0.0 if first else NEG, NEG]  # fit


# the state rows of one row of the pointer fill (a checkpoint's, and the
# EDGE phase's state buffer): M, L, U, and fit's J (-inf without the jump);
# overlap's M
TOP_STATES = {"global": 3, "local": 3, "fit": 4, "overlap": 1}


def edge_states(mode: str, use_jump: bool) -> int:
    """The edge states the EDGE phase passes a rank's right neighbour: M,
    L, U, and J with fit's jump; overlap's M."""
    return 1 if mode == "overlap" else 4 if use_jump else 3


def ptr_fill_plain(mode, use_jump, m_pad, n_pad, qs, ts, allow, ns, ms,
                   params, rows_per_byte=1, *, stride=None, seed=None, i0=0,
                   col0=0, edge=None, cand=None):
    """Plain version of ``ptr_fill`` (any device), and of the
    checkpoint-rescan engine's two fills (``ops/blocked.py``):

      stride S  the checkpoint forward: no pointers; returns (score, a, b,
                cks), cks (B, m_pad / S, states, n_pad + 1) in params'
                dtype, the
                state rows (M, L, U, fit's J; overlap M) of columns 0..n_pad
                at rows 0, S, 2S, ..., checkpoint k entering row k*S + 1;
      seed      (B, states, n_pad + 1), the state rows of row i0: the
                refill of rows i0+1 .. i0+m_pad (qs holds their chars);
                returns the pointers alone;
      edge      the EDGE phase (``ops/blocked.edge_ptr_fill``): rows
                i0+1 .. i0+m_pad of global columns col0+1 .. col0+n_pad
                (one rank's slice; ts, allow and ns / ms in those terms),
                ``seed`` (B, TOP_STATES, n_pad) the state rows of row i0,
                ``edge`` (B, edge_states, m_pad+1) the states at column
                col0 of rows i0 .. i0+m_pad, ``cand`` (B, 4) int32 the
                running start candidate (score bits, a, b, 0), updated in
                place: global's latch where the slice holds (m, n), local's
                strict running row-major maximum, fit's and overlap's row
                m (overlap's raw, without the j = 0 candidate). Returns
                (ptrs, bottom, redge): the pointer bytes, the state rows of
                row i0+m_pad, and the states at column col0+n_pad of rows
                i0+1 .. i0+m_pad (B, edge_states, m_pad)."""
    global plain_calls
    plain_calls += 1
    rpb = rows_per_byte
    chunk = edge is not None
    latch = seed is None or chunk
    match, mis, o, e, jp = (params[0, k] for k in range(5))
    B, dev = qs.shape[0], qs.device
    vals = dict(device=dev, dtype=params.dtype)
    if rpb > 1:
        k_home = k_unset = L.PK2_CODE3
        lbit, ubit = L.PK2_L_IS_MID, L.PK2_U_IS_UPP
    else:
        k_home, k_unset = L.PK_HOME, L.PK_UNSET
        lbit, ubit = L.PK_L_IS_MID, L.PK_U_IS_UPP
    jc = torch.arange(col0 + 1, col0 + n_pad + 1, device=dev,
                      dtype=torch.int32)[None, :]
    jf = jc.to(params.dtype)
    n_col, m_vec = ns, ms[:, 0]
    mask_le_n, mask_eq_n, mask_lt_n = jc <= n_col, jc == n_col, jc <= n_col - 1
    zrow = torch.zeros((B, n_pad), **vals)
    zcol = torch.zeros((B, 1), **vals)
    negcol = torch.full((B, 1), NEG, **vals)
    negrow = torch.full((B, n_pad), NEG, **vals)
    zero = torch.zeros((), **vals)
    if mode == "global":
        mp, lp, up = negrow, negrow, o + e * jf.expand(B, n_pad)
    elif mode == "local":
        mp = lp = up = zrow
    elif mode == "fit":
        mp, lp, up = zrow, negrow, zrow
    else:  # overlap: one matrix, row 0 is -inf past column 0
        mp = negrow
    jpr = negrow
    if seed is not None:
        top = seed if chunk else seed[:, :, 1:]
        mp = top[:, 0]
        if mode != "overlap":
            lp, up = top[:, 1], top[:, 2]
        if use_jump:
            jpr = top[:, 3]

    def border(r):
        """(M, L, U, J) at column col0 of row i0 + r, as (B, 1) columns:
        the left edge's, else column 0's border (its constants made once)."""
        if chunk:
            cols = [edge[:, k, r : r + 1] for k in range(edge.shape[1])]
        else:
            cols = [(zcol if v == 0.0 else negcol) if isinstance(v, float)
                    else zcol + v for v in _border(mode, i0 + r, o, e)]
        if not use_jump:
            cols = cols[:3]
        return cols + [negcol] * (4 - len(cols))

    if chunk:
        score = cand[:, 0].clone().view(params.dtype)
        a, b = cand[:, 1].clone(), cand[:, 2].clone()
        holds_n = (n_col[:, 0] > col0) & (n_col[:, 0] <= col0 + n_pad)
        redge = torch.empty((B, edge_states(mode, use_jump), m_pad), **vals)
    cks = None
    if stride:
        cks = torch.empty((B, m_pad // stride, TOP_STATES[mode], n_pad + 1),
                          **vals)
    if not chunk:
        score = torch.full((B,), NEG, **vals)
        a = torch.zeros(B, dtype=torch.int32, device=dev)
        b = torch.zeros(B, dtype=torch.int32, device=dev)
    ptrs = None if cks is not None else torch.empty(
        (B, m_pad // rpb, n_pad), dtype=torch.uint8, device=dev)
    bits = 8 // rpb
    if use_jump:
        jgate = allow > 0.0
    byte = None
    here_border = border(0)
    for idx in range(m_pad):
        if cks is not None and idx % stride == 0:
            rows = [mp] if mode == "overlap" else [mp, lp, up] + (
                [jpr] if mode == "fit" else [])
            bcol = _border(mode, idx, o, e)
            for st, row in enumerate(rows):
                cks[:, idx // stride, st, 0] = bcol[st]
                cks[:, idx // stride, st, 1:] = row
        i = i0 + idx + 1  # the global row
        sub = torch.where(ts == qs[:, idx : idx + 1], match, mis)
        here = m_vec == i
        (bm, bl, bu, bj), here_border = here_border, border(idx + 1)
        cm, _, cu, cj = here_border  # row i; the other row i-1
        if mode == "overlap":
            # argument order LEFT, DIAG, RIGHT (alignment.h:944)
            diag = _shift_in(mp, bm) + sub
            right = mp + o
            dr = torch.maximum(diag, right)
            m_row = torch.maximum(
                torch.cummax(dr - o * jf, dim=1).values,
                cm - o * col0 if col0 else cm) + o * jf
            left = _shift_in(m_row, cm) + o
            val = torch.maximum(left, dr)
            code = torch.where(left >= val, L.OV_LEFT,
                               torch.where(diag >= right, L.OV_DIAG,
                                           L.OV_RIGHT))
            code = torch.where(val > NEG, code, L.OV_UNSET)
            if chunk:  # the raw bottom-row maximum, first column
                rowmax = _masked_max(m_row, mask_lt_n)
                score = torch.where(here, rowmax, score)
                a = torch.where(here, _first_eq_j(m_row, rowmax, mask_lt_n,
                                                  jc), a)
                b = torch.where(here, 0, b)
            elif latch:
                rowmax = _masked_max(m_row, mask_lt_n)
                jarg = _first_eq_j(m_row, rowmax, mask_lt_n, jc)
                jarg = torch.where(rowmax > 0.0, jarg, 0)
                score = torch.where(here, torch.maximum(rowmax, zero), score)
                a = torch.where(here, jarg, a)
            mp = m_row
            if chunk:
                redge[:, 0, idx] = m_row[:, -1]
        else:
            cands = [_shift_in(lp, bl) + sub, _shift_in(mp, bm) + sub,
                     _shift_in(up, bu) + sub]
            codes = [L.PK_LOW, L.PK_MID, L.PK_UPP]
            if use_jump:
                cands.append(_shift_in(jpr, bj) + sub)
                codes.append(L.PK_JUMP)
            if mode == "local":
                cands.append(zrow)  # the HOME candidate, with no +sub
                codes.append(k_home)
            # earliest-argument strict argmax: a later candidate must
            # exceed the best so far to take over
            m_row = cands[0]
            pm = torch.full((B, n_pad), codes[0], dtype=torch.int32,
                            device=dev)
            for c, k in zip(cands[1:], codes[1:]):
                pm = torch.where(c > m_row, k, pm)
                m_row = torch.maximum(m_row, c)
            pm = torch.where(m_row > NEG, pm, k_unset)
            la, lb2 = lp + e, mp + o
            l_row = torch.maximum(la, lb2)
            plbit = torch.where(la >= lb2, 0, lbit)
            # U(i, col0) seeds the chain: column 0's is 0 local, -inf
            # otherwise
            sm = _shift_in(m_row, cm)
            v = torch.cummax(sm + (o - e * jf), dim=1).values
            if chunk or mode == "local":  # else U(i, 0) is -inf
                v = torch.maximum(v, cu - e * col0 if col0 else cu)
            u_row = v + e * jf
            ua = sm + o
            ub2 = _shift_in(u_row, cu) + e
            pubit = torch.where(ua >= ub2, 0, ubit)
            code = pm | plbit | pubit
            if use_jump:
                jcand = torch.where(jgate, sm + jp, NEG)
                j_row = torch.cummax(jcand, dim=1).values
                if chunk:  # J(i, col0) seeds the chain; column 0's is -inf
                    j_row = torch.maximum(j_row, cj)
                jb = _shift_in(j_row, cj)
                code = code | torch.where((jcand > NEG) & (jcand >= jb), 0,
                                          L.PK_J_IS_JUMP)
                jpr = j_row
            if latch and mode == "global":
                if chunk:  # the slice that holds column n latches
                    here = here & holds_n
                ln = _masked_max(l_row, mask_eq_n)
                mn = _masked_max(m_row, mask_eq_n)
                un = _masked_max(u_row, mask_eq_n)
                st = torch.where((ln >= mn) & (ln >= un), 0,
                                 torch.where(mn >= un, 1, 2))
                score = torch.where(
                    here, torch.maximum(torch.maximum(ln, mn), un), score)
                a = torch.where(here, st.to(torch.int32), a)
                b = torch.where(here, 0, b)
            elif latch and mode == "local":
                rowmax = _masked_max(m_row, mask_le_n)
                upd = (rowmax > score) & (i <= m_vec)
                jarg = _first_eq_j(m_row, rowmax, mask_le_n, jc)
                score = torch.where(upd, rowmax, score)
                a = torch.where(upd, i, a)
                b = torch.where(upd, jarg, b)
            elif latch:  # fit: the bottom row over columns 1..n-1
                mbst = _masked_max(m_row, mask_lt_n)
                lbst = _masked_max(l_row, mask_lt_n)
                use_l = lbst > mbst
                jarg = torch.where(use_l,
                                   _first_eq_j(l_row, lbst, mask_lt_n, jc),
                                   _first_eq_j(m_row, mbst, mask_lt_n, jc))
                score = torch.where(here, torch.maximum(mbst, lbst), score)
                a = torch.where(here, use_l.to(torch.int32), a)
                b = torch.where(here, jarg, b)
            mp, lp, up = m_row, l_row, u_row
            if chunk:
                for k, row in enumerate((m_row, l_row, u_row, jpr)[
                        : redge.shape[1]]):
                    redge[:, k, idx] = row[:, -1]
        if cks is not None:
            continue
        r, s = divmod(idx, rpb)
        byte = code if s == 0 else byte | (code << (bits * s))
        if s == rpb - 1:
            ptrs[:, r] = byte.to(torch.uint8)
    if cks is not None:
        return score, a, b, cks
    if chunk:
        cand[:, 0], cand[:, 1], cand[:, 2] = score.view(torch.int32), a, b
        rows = [mp] if mode == "overlap" else [mp, lp, up, jpr]
        return ptrs, torch.stack(rows[: TOP_STATES[mode]], dim=1), redge
    if seed is not None:
        return ptrs
    return score, a, b, ptrs


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_fns = None


def _kernel(f64=False):
    """The C entry of the float32 pointer fill, or of its double instances
    with ``f64``."""
    global _fns
    if _fns is None:
        from aligntools_tpu_torch.ops import _build

        lib = _build.load()
        P, I = ctypes.c_void_p, ctypes.c_int
        # mode, use_jump, rpb, qs, ts, allow, ns, ms, params, score, a, b,
        # ptrs, B, m_pad, n_pad, threads, width, stream
        fns = (lib.at_ptr_fill, lib.at_ptr_fill64)
        for fn in fns:
            fn.argtypes = [I, I, I, P, P, P, P, P, P, P, P, P, P, I, I, I, I,
                           I, P]
            fn.restype = ctypes.c_int
        _fns = fns
    return _fns[int(f64)]


def _check(mode, use_jump, m_pad, n_pad, rpb, qs, ts, allow, ns, ms,
           params):
    if mode not in MODES:
        raise ValueError(f"unknown pointer-fill mode {mode!r}")
    if rpb not in (1, 2, 4) or m_pad % rpb:
        raise ValueError(f"rows_per_byte {rpb} does not divide m_pad {m_pad}")
    if rpb > 1 and use_jump:
        raise ValueError("fit+jump needs rows_per_byte 1 (6-bit cells)")
    if rpb == 4 and mode != "overlap":
        raise ValueError("rows_per_byte 4 holds overlap's 2-bit codes only")
    if use_jump and (mode != "fit" or allow is None):
        raise ValueError("the jump state exists in fit mode only, and "
                         "needs allow")
    scan._check(m_pad, n_pad, qs, ts, ns, ms, params, allow)


def ptr_fill(mode, use_jump, m_pad, n_pad, qs, ts, allow, ns, ms, params,
             rows_per_byte=1):
    """Fill with packed pointer emission; returns (score, a, b, ptrs) as
    the module docstring lays them out. ``allow`` (B, n_pad) float32 gates
    fit's jump entry (1.0 allowed); it is read only with ``use_jump`` and
    may be None otherwise. ``params`` float64 takes the double instances.
    Targets past ``select.ptr_flat_cap`` columns run the blocked pointer
    fill at ``blocked_c_blk(n_pad, params.dtype)``, which also needs m_pad
    % (8 * rows_per_byte) == 0."""
    rpb = rows_per_byte
    c_blk = blocked_c_blk(n_pad, params.dtype)
    if c_blk:
        from aligntools_tpu_torch.ops import blocked

        return blocked.blocked_ptr_fill(mode, use_jump, m_pad, n_pad, c_blk,
                                        qs, ts, allow, ns, ms, params, rpb)
    _check(mode, use_jump, m_pad, n_pad, rpb, qs, ts, allow, ns, ms, params)
    if qs.device.type == "cpu":
        return ptr_fill_plain(mode, use_jump, m_pad, n_pad, qs, ts, allow,
                              ns, ms, params, rpb)
    return _launch(mode, use_jump, m_pad, n_pad, rpb,
                   (qs, ts, allow, ns, ms, params),
                   launch_shape(n_pad, params.dtype))


def _launch(mode, use_jump, m_pad, n_pad, rpb, args, shape):
    """Launch the kernel on CUDA tensors at ``shape`` = (threads, W) on the
    current stream, the instance of params' dtype; returns (score, a, b,
    ptrs)."""
    global launches, launches64
    qs, ts, allow, ns, ms, params = args
    f64 = params.dtype == torch.float64
    threads, width = shape
    if width != (WIDTH64 if f64 else WIDTH) or not (
            32 <= threads <= MAX_THREADS) or (
            threads % 32 or threads * width < n_pad or n_pad % 16):
        raise ValueError(f"no kernel instance covers n_pad {n_pad} with "
                         f"{threads} threads of {width} columns")
    if ts.data_ptr() % 16:
        raise ValueError("ts must be 16-byte aligned (the kernel reads it "
                         "as 16-byte words)")
    B, dev = qs.shape[0], qs.device
    score = torch.empty(B, dtype=params.dtype, device=dev)
    a = torch.empty(B, dtype=torch.int32, device=dev)
    b = torch.empty(B, dtype=torch.int32, device=dev)
    ptrs = torch.empty((B, m_pad // rpb, n_pad), dtype=torch.uint8,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel(f64)(
            MODES.index(mode), int(bool(use_jump)), rpb, qs.data_ptr(),
            ts.data_ptr(), 0 if allow is None else allow.data_ptr(),
            ns.data_ptr(), ms.data_ptr(),
            params.data_ptr(), score.data_ptr(), a.data_ptr(), b.data_ptr(),
            ptrs.data_ptr(), B, m_pad, n_pad, threads, width, stream)
    if err != 0:
        raise RuntimeError(f"pointer fill kernel launch failed: CUDA error "
                           f"{err}")
    if f64:
        launches64 += 1
    else:
        launches += 1
    return score, a, b, ptrs
