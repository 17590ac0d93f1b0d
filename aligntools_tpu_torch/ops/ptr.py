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

Targets up to FLAT_REG_MAX_N_PAD columns take ``csrc/ptr_fill.cu`` (one
CTA per pair, each thread's strip of WIDTH columns and its row state in
registers; see its header); wider ones, which that CTA cannot hold, take
the blocked pointer fill (``ops/blocked.py``) at its column block, with a
ragged last block where it does not divide n_pad: same bytes, on either
device. On a CUDA tensor a wrapper launches its kernel or raises; on a CPU
tensor ``ptr_fill`` runs ``ptr_fill_plain``,
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

# the kernel's strip width (its one template instance) and the most
# threads its CTA runs (so the 128 registers a thread may take). W 16, the
# fewest warps, beat W 4 and W 8 on every row of chip_smoke.py's ptr phase
# on the H100 but fit+jump at 2,048 columns, where W 8's lead was inside
# the spread of two timings of one instance (PERF.md).
WIDTH = 16
MAX_THREADS = 512
# the widest target the kernel takes: wider ones go to the blocked pointer
# fill (blocked_c_blk). From 4,224 to 8,192 columns this kernel is 1.2-2.6x
# faster than the blocked one on the H100 (chip_smoke.py's ptr phase, `cap`
# lines; PERF.md).
FLAT_REG_MAX_N_PAD = MAX_THREADS * WIDTH


def reset_counts() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def launch_shape(n_pad: int) -> tuple[int, int]:
    """(threads per CTA, strip width W) for targets up to n_pad: the fewest
    whole warps of WIDTH-column strips that cover n_pad."""
    if not 0 < n_pad <= FLAT_REG_MAX_N_PAD:
        raise ValueError(f"n_pad {n_pad} is past the pointer kernel's "
                         f"{FLAT_REG_MAX_N_PAD} columns: the blocked fill "
                         f"takes it")
    return max(32, -(-n_pad // (32 * WIDTH)) * 32), WIDTH


def blocked_c_blk(n_pad: int) -> int | None:
    """The column block at which ``ptr_fill`` hands a target of n_pad
    columns to the blocked pointer fill, or None where the kernel takes
    it."""
    if n_pad <= FLAT_REG_MAX_N_PAD:
        return None
    from aligntools_tpu_torch.ops import blocked

    return blocked.C_BLK


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


def ptr_fill_plain(mode, use_jump, m_pad, n_pad, qs, ts, allow, ns, ms,
                   params, rows_per_byte=1, *, stride=None, seed=None, i0=0):
    """Plain version of ``ptr_fill`` (any device), and of the
    checkpoint-rescan engine's two fills (``ops/blocked.py``):

      stride S  the checkpoint forward: no pointers; returns (score, a, b,
                cks), cks (B, m_pad / S, states, n_pad + 1) float32, the
                state rows (M, L, U, fit's J; overlap M) of columns 0..n_pad
                at rows 0, S, 2S, ..., checkpoint k entering row k*S + 1;
      seed      (B, states, n_pad + 1), the state rows of row i0: the
                refill of rows i0+1 .. i0+m_pad (qs holds their chars);
                returns the pointers alone."""
    global plain_calls
    plain_calls += 1
    rpb = rows_per_byte
    latch = seed is None
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
    if seed is not None:
        mp = seed[:, 0, 1:]
        if mode != "overlap":
            lp, up = seed[:, 1, 1:], seed[:, 2, 1:]
        if mode == "fit":
            jpr = seed[:, 3, 1:]
    cks = None
    if stride:
        states = 1 if mode == "overlap" else 4 if mode == "fit" else 3
        cks = torch.empty((B, m_pad // stride, states, n_pad + 1), **f32)
    score = torch.full((B,), NEG, **f32)
    a = torch.zeros(B, dtype=torch.int32, device=dev)
    b = torch.zeros(B, dtype=torch.int32, device=dev)
    ptrs = None if cks is not None else torch.empty(
        (B, m_pad // rpb, n_pad), dtype=torch.uint8, device=dev)
    bits = 8 // rpb
    if use_jump:
        jgate = allow > 0.0
    byte = None
    for idx in range(m_pad):
        if cks is not None and idx % stride == 0:
            rows = [mp] if mode == "overlap" else [mp, lp, up] + (
                [jpr] if mode == "fit" else [])
            col0 = _border(mode, idx, o, e)
            for st, row in enumerate(rows):
                cks[:, idx // stride, st, 0] = col0[st]
                cks[:, idx // stride, st, 1:] = row
        i = i0 + idx + 1  # the global row
        sub = torch.where(ts == qs[:, idx : idx + 1], match, mis)
        here = m_vec == i
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
            if latch:
                rowmax = _masked_max(m_row, mask_lt_n)
                jarg = _first_eq_j(m_row, rowmax, mask_lt_n, jc)
                jarg = torch.where(rowmax > 0.0, jarg, 0)
                score = torch.where(here, torch.maximum(rowmax, zero), score)
                a = torch.where(here, jarg, a)
            mp = m_row
        else:
            i_f = float(i)
            first = i == 1  # the row above is row 0
            if mode == "global":
                mb = zcol if first else negcol
                lb = zcol + (o + e * (i_f - 1.0))
                ub = zcol + o if first else negcol
            elif mode == "local":
                mb = lb = ub = zcol
            else:  # fit
                mb = ub = zcol if first else negcol
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
            if latch and mode == "global":
                ln = _masked_max(l_row, mask_eq_n)
                mn = _masked_max(m_row, mask_eq_n)
                un = _masked_max(u_row, mask_eq_n)
                st = torch.where((ln >= mn) & (ln >= un), 0,
                                 torch.where(mn >= un, 1, 2))
                score = torch.where(
                    here, torch.maximum(torch.maximum(ln, mn), un), score)
                a = torch.where(here, st.to(torch.int32), a)
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
        if cks is not None:
            continue
        r, s = divmod(idx, rpb)
        byte = code if s == 0 else byte | (code << (bits * s))
        if s == rpb - 1:
            ptrs[:, r] = byte.to(torch.uint8)
    if cks is not None:
        return score, a, b, cks
    if seed is not None:
        return ptrs
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
        # ptrs, B, m_pad, n_pad, threads, width, stream
        fn.argtypes = [I, I, I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                       P]
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
    may be None otherwise. Targets past FLAT_REG_MAX_N_PAD columns run the
    blocked pointer fill at ``blocked_c_blk(n_pad)``, which also needs
    m_pad % (8 * rows_per_byte) == 0."""
    rpb = rows_per_byte
    c_blk = blocked_c_blk(n_pad)
    if c_blk:
        from aligntools_tpu_torch.ops import blocked

        return blocked.blocked_ptr_fill(mode, use_jump, m_pad, n_pad, c_blk,
                                        qs, ts, allow, ns, ms, params, rpb)
    _check(mode, use_jump, m_pad, n_pad, rpb, qs, ts, allow, ns, ms, params)
    if qs.device.type == "cpu":
        return ptr_fill_plain(mode, use_jump, m_pad, n_pad, qs, ts, allow,
                              ns, ms, params, rpb)
    return _launch(mode, use_jump, m_pad, n_pad, rpb,
                   (qs, ts, allow, ns, ms, params), launch_shape(n_pad))


def _launch(mode, use_jump, m_pad, n_pad, rpb, args, shape):
    """Launch the kernel on CUDA tensors at ``shape`` = (threads, W) on the
    current stream; returns (score, a, b, ptrs)."""
    global launches
    qs, ts, allow, ns, ms, params = args
    threads, width = shape
    if width != WIDTH or not 32 <= threads <= MAX_THREADS or (
            threads % 32 or threads * width < n_pad or n_pad % 16):
        raise ValueError(f"no kernel instance covers n_pad {n_pad} with "
                         f"{threads} threads of {width} columns")
    if ts.data_ptr() % 16:
        raise ValueError("ts must be 16-byte aligned (the kernel reads it "
                         "as 16-byte words)")
    B, dev = qs.shape[0], qs.device
    score = torch.empty(B, dtype=torch.float32, device=dev)
    a = torch.empty(B, dtype=torch.int32, device=dev)
    b = torch.empty(B, dtype=torch.int32, device=dev)
    ptrs = torch.empty((B, m_pad // rpb, n_pad), dtype=torch.uint8,
                       device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(
            MODES.index(mode), int(bool(use_jump)), rpb, qs.data_ptr(),
            ts.data_ptr(), 0 if allow is None else allow.data_ptr(),
            ns.data_ptr(), ms.data_ptr(),
            params.data_ptr(), score.data_ptr(), a.data_ptr(), b.data_ptr(),
            ptrs.data_ptr(), B, m_pad, n_pad, threads, width, stream)
    if err != 0:
        raise RuntimeError(f"pointer fill kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return score, a, b, ptrs
