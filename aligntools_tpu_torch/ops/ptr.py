"""Pointer-emitting DP fill: the CUDA kernel's wrapper and its plain version.

Counterpart of ``aligntools_tpu/ops/pallas_ptr.py:pallas_ptr_fill`` (the
Pallas ``_ptr_kernel``), with its argument layout (``ops/scan.py``'s, plus
``allow``) and outputs:

  score  (B,) float32
  a, b   (B,) int32 traceback-start info
           global   a = start state (0 L, 1 M, 2 U at (m, n))
           local    a = i_max, b = j_max (strict running argmax of M)
           fit      a = 1 when L wins the bottom row, b = j_max
           overlap  a = j_max (0 unless the bottom row's max beats 0)
  ptrs   (B, m_pad / rpb, n_pad) uint8, columns 1..n_pad, in the packed
         layout of ``layout.py``; every byte is written, pad rows and pad
         columns included (they read the sentinel chars: query pad -1,
         target pad -2), so two fills can be compared byte for byte.

On a CUDA tensor ``ptr_fill`` launches ``csrc/ptr_fill.cu`` (one CTA per
pair; see its header) or raises; on a CPU tensor it runs ``ptr_fill_plain``,
which fills one query row per step over whole (B, n_pad) rows as the
Pallas kernel does. Values are integer-valued float32 with true -inf
borders, and every pointer is a comparison of such values in the
reference's argument order, so the two agree bit for bit.
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
plain_calls = 0

# scratch row buffers per pair (csrc/ptr_fill.cu)
_NBUF = {"affine": 5, "jump": 7, "overlap": 4}


def reset_counts() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def _shift_in(x, col):
    return torch.cat([col, x[:, :-1]], dim=1)


def _first_eq_j(vec, target, mask, jc):
    """Smallest column j where vec == target within mask, else BIG."""
    hit = (vec == target[:, None]) & mask
    return torch.where(hit, jc, BIG).amin(dim=1).to(torch.int32)


def _masked_max(vec, mask):
    return torch.where(mask, vec, NEG).amax(dim=1)


def ptr_fill_plain(mode, use_jump, m_pad, n_pad, qs, ts, allow, ns, ms,
                   params, rows_per_byte=1):
    """Plain version of ``ptr_fill`` (any device)."""
    global plain_calls
    plain_calls += 1
    rpb = rows_per_byte
    match, mis, o, e, jp = (params[0, k] for k in range(5))
    B, dev = qs.shape[0], qs.device
    f32 = dict(device=dev, dtype=torch.float32)
    if rpb > 1:
        k_home = k_unset = L.PK2_CODE3
        lbit, ubit = L.PK2_L_IS_MID, L.PK2_U_IS_UPP
    else:
        k_home, k_unset = L.PK_HOME, L.PK_UNSET
        lbit, ubit = L.PK_L_IS_MID, L.PK_U_IS_UPP
    jc = torch.arange(1, n_pad + 1, device=dev, dtype=torch.int32)[None, :]
    jf = jc.to(torch.float32)
    n_col, m_vec = ns, ms[:, 0]
    mask_le_n, mask_eq_n, mask_lt_n = jc <= n_col, jc == n_col, jc <= n_col - 1
    zrow = torch.zeros((B, n_pad), **f32)
    zcol = torch.zeros((B, 1), **f32)
    negcol = torch.full((B, 1), NEG, **f32)
    negrow = torch.full((B, n_pad), NEG, **f32)
    zero = torch.zeros((), **f32)
    if mode == "global":
        mp, lp, up = negrow, negrow, o + e * jf.expand(B, n_pad)
    elif mode == "local":
        mp = lp = up = zrow
    elif mode == "fit":
        mp, lp, up = zrow, negrow, zrow
    else:  # overlap: one matrix, row 0 is -inf past column 0
        mp = negrow
    jpr = negrow
    score = torch.full((B,), NEG, **f32)
    a = torch.zeros(B, dtype=torch.int32, device=dev)
    b = torch.zeros(B, dtype=torch.int32, device=dev)
    ptrs = torch.empty((B, m_pad // rpb, n_pad), dtype=torch.uint8,
                       device=dev)
    bits = 8 // rpb
    if use_jump:
        jgate = allow > 0.0
    byte = None
    for idx in range(m_pad):
        i = idx + 1
        sub = torch.where(ts == qs[:, idx : idx + 1], match, mis)
        latch = m_vec == i
        if mode == "overlap":
            # argument order LEFT, DIAG, RIGHT (alignment.h:944)
            diag = _shift_in(mp, zcol) + sub
            right = mp + o
            dr = torch.maximum(diag, right)
            m_row = torch.maximum(
                torch.cummax(dr - o * jf, dim=1).values, zero) + o * jf
            left = _shift_in(m_row, zcol) + o
            val = torch.maximum(left, dr)
            code = torch.where(left >= val, L.OV_LEFT,
                               torch.where(diag >= right, L.OV_DIAG,
                                           L.OV_RIGHT))
            code = torch.where(val > NEG, code, L.OV_UNSET)
            rowmax = _masked_max(m_row, mask_lt_n)
            jarg = _first_eq_j(m_row, rowmax, mask_lt_n, jc)
            jarg = torch.where(rowmax > 0.0, jarg, 0)
            score = torch.where(latch, torch.maximum(rowmax, zero), score)
            a = torch.where(latch, jarg, a)
            mp = m_row
        else:
            i_f = float(i)
            if mode == "global":
                mb = zcol if idx == 0 else negcol
                lb = zcol + (o + e * (i_f - 1.0))
                ub = zcol + o if idx == 0 else negcol
            elif mode == "local":
                mb = lb = ub = zcol
            else:  # fit
                mb = ub = zcol if idx == 0 else negcol
                lb = negcol
            cands = [_shift_in(lp, lb) + sub, _shift_in(mp, mb) + sub,
                     _shift_in(up, ub) + sub]
            codes = [L.PK_LOW, L.PK_MID, L.PK_UPP]
            if use_jump:
                cands.append(_shift_in(jpr, negcol) + sub)
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
            # the current row's column-0 M border: 0 local, -inf otherwise
            mbc = zcol if mode == "local" else negcol
            sm = _shift_in(m_row, mbc)
            v = torch.cummax(sm + (o - e * jf), dim=1).values
            if mode == "local":  # U(i, 0) = 0
                v = torch.clamp_min(v, 0.0)
            u_row = v + e * jf
            ua = sm + o
            ub2 = _shift_in(u_row, mbc) + e
            pubit = torch.where(ua >= ub2, 0, ubit)
            code = pm | plbit | pubit
            if use_jump:
                jcand = torch.where(jgate, sm + jp, NEG)
                j_row = torch.cummax(jcand, dim=1).values
                jb = _shift_in(j_row, negcol)
                code = code | torch.where((jcand > NEG) & (jcand >= jb), 0,
                                          L.PK_J_IS_JUMP)
                jpr = j_row
            if mode == "global":
                ln = _masked_max(l_row, mask_eq_n)
                mn = _masked_max(m_row, mask_eq_n)
                un = _masked_max(u_row, mask_eq_n)
                st = torch.where((ln >= mn) & (ln >= un), 0,
                                 torch.where(mn >= un, 1, 2))
                score = torch.where(
                    latch, torch.maximum(torch.maximum(ln, mn), un), score)
                a = torch.where(latch, st.to(torch.int32), a)
            elif mode == "local":
                rowmax = _masked_max(m_row, mask_le_n)
                upd = (rowmax > score) & (i <= m_vec)
                jarg = _first_eq_j(m_row, rowmax, mask_le_n, jc)
                score = torch.where(upd, rowmax, score)
                a = torch.where(upd, i, a)
                b = torch.where(upd, jarg, b)
            else:  # fit: the bottom row over columns 1..n-1
                mbst = _masked_max(m_row, mask_lt_n)
                lbst = _masked_max(l_row, mask_lt_n)
                use_l = lbst > mbst
                jarg = torch.where(use_l,
                                   _first_eq_j(l_row, lbst, mask_lt_n, jc),
                                   _first_eq_j(m_row, mbst, mask_lt_n, jc))
                score = torch.where(latch, torch.maximum(mbst, lbst), score)
                a = torch.where(latch, use_l.to(torch.int32), a)
                b = torch.where(latch, jarg, b)
            mp, lp, up = m_row, l_row, u_row
        r, s = divmod(idx, rpb)
        byte = code if s == 0 else byte | (code << (bits * s))
        if s == rpb - 1:
            ptrs[:, r] = byte.to(torch.uint8)
    return score, a, b, ptrs


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from aligntools_tpu_torch.ops import _build

        fn = _build.load().at_ptr_fill
        P, I = ctypes.c_void_p, ctypes.c_int
        # mode, use_jump, rpb, qs, ts, allow, ns, ms, params, score, a, b,
        # ptrs, scratch, B, m_pad, n_pad, threads, wmax, stream
        fn.argtypes = [I, I, I, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I,
                       I, P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    may be None otherwise."""
    rpb = rows_per_byte
    _check(mode, use_jump, m_pad, n_pad, rpb, qs, ts, allow, ns, ms, params)
    if qs.device.type == "cpu":
        return ptr_fill_plain(mode, use_jump, m_pad, n_pad, qs, ts, allow,
                              ns, ms, params, rpb)
    global launches
    B, dev = qs.shape[0], qs.device
    score = torch.empty(B, dtype=torch.float32, device=dev)
    a = torch.empty(B, dtype=torch.int32, device=dev)
    b = torch.empty(B, dtype=torch.int32, device=dev)
    ptrs = torch.empty((B, m_pad // rpb, n_pad), dtype=torch.uint8,
                       device=dev)
    threads, wmax = scan.launch_shape(n_pad)
    nbuf = _NBUF["overlap" if mode == "overlap" else
                 "jump" if use_jump else "affine"]
    scratch = torch.empty((B, nbuf, threads * wmax), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(
            MODES.index(mode), int(bool(use_jump)), rpb, qs.data_ptr(),
            ts.data_ptr(), 0 if allow is None else allow.data_ptr(),
            ns.data_ptr(), ms.data_ptr(),
            params.data_ptr(), score.data_ptr(), a.data_ptr(), b.data_ptr(),
            ptrs.data_ptr(), scratch.data_ptr(), B, m_pad, n_pad, threads,
            wmax, stream)
    if err != 0:
        raise RuntimeError(f"pointer fill kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return score, a, b, ptrs
