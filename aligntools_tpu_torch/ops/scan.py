"""Score-only DP fills: CUDA kernel wrappers and their plain PyTorch versions.

Counterpart of ``aligntools_tpu/ops/pallas_scan.py``, with its entry
points' argument layout:

  qs      (B, m_pad) int32 query chars, pad -1
  ts      (B, n_pad) int32 target chars, pad -2
  allow   (B, n_pad) float32, 1.0 where fit's jump entry is allowed
  ns, ms  (B, 1) int32 true target / query lengths
  params  (1, 8) float32 [match, mismatch, gap_open, gap_extend, jump, 0, 0, 0]
          (float64 for a pair past float32's exact integers: edit's double
          instance on the card, and every plain version in float64)

``scores`` / ``fit_scores`` return (B,) float32 scores (int32 for edit;
float64 for a float64 params row).
On a CUDA tensor they launch the hand-written kernels or raise: the
register-strip score fills of ``csrc/ptr_fill.cu`` (one CTA per pair, each
thread's strip of 16 columns and its row state in registers; entry
``at_score_fill``): global, local, fit(+jump) and overlap the score-only
instances of its pointer kernels, edit its int32 min-plus kernel, each up
to ``flat_cap(mode)`` columns (``engine/select.py``'s score_flat_cap) at
``flat_shape(mode, n_pad)``. Wider targets go to the blocked score fill
(``ops/blocked.py``) at ``select.blocked_c_blk()``, with a ragged last
block where it does not divide n_pad, on either device: ``blocked_c_blk``
is the one place that picks. On a CPU tensor the wrappers
run the plain versions below. Scores are integer-valued float32 with true
-inf borders, so the kernel and the plain version agree bit for bit (the
batch path guards the exact range with ``exact.check_f32_exact``).

The plain versions fill one query row per step over whole (B, n_pad)
rows, as the Pallas kernels do, and resolve each in-row gap chain with
the slope-normalized running max / min of ``engine/scan.py:_u_scan``
(``torch.cummax`` / ``torch.cummin``).
"""

from __future__ import annotations

import ctypes

import torch

from aligntools_tpu_torch.params import MODES

NEG = float("-inf")
INT32_MAX = 2**31 - 1

# launches of each kernel through its wrapper, keyed by the TPU kernel it
# replaces, and calls of the plain versions: a run can show which of the
# two carried it
launches = {"affine": 0, "overlap": 0, "edit": 0, "fit": 0}
launches64 = 0  # edit's double instance (not in `launches`)
plain_calls = 0

# the most threads the edit kernel's CTA runs (csrc/ptr_fill.cu
# kEditMaxThreads): two words a column leave it 64 registers a thread
EDIT_MAX_THREADS = 1024


def reset_counts() -> None:
    global launches64, plain_calls
    for k in launches:
        launches[k] = 0
    launches64 = plain_calls = 0


def _edit64(mode: str, dtype) -> bool:
    """Whether ``mode`` at ``dtype`` is edit's double instance, the one
    score fill with a float64 form on the card."""
    return mode == "edit" and dtype == torch.float64


def _widest(mode: str, dtype) -> tuple[int, int]:
    """(strip width, widest n_pad) of the register-strip score fill of
    ``mode``: MAX_THREADS strips of ptr.WIDTH, and for edit, whose CTA may
    run more threads, EDIT_MAX_THREADS; edit's double instance ptr.WIDTH64
    columns a strip."""
    from aligntools_tpu_torch.ops import ptr

    width = ptr.WIDTH64 if _edit64(mode, dtype) else ptr.WIDTH
    return width, (EDIT_MAX_THREADS if mode == "edit"
                   else ptr.MAX_THREADS) * width


def flat_cap(mode: str, dtype=torch.float32) -> int:
    """The widest target (n_pad) the routes give the register-strip score
    fill of ``mode``: ``engine/select.score_flat_cap(mode)``, for edit's
    double instance at most its widest."""
    from aligntools_tpu_torch.engine import select

    return min(select.score_flat_cap(mode), _widest(mode, dtype)[1])


def flat_shape(mode: str, n_pad: int, dtype=torch.float32) -> tuple[int, int]:
    """(threads per CTA, strip width) of the register-strip score fill of
    ``mode`` at n_pad: the fewest whole warps of strips that cover it."""
    width, top = _widest(mode, dtype)
    if not 0 < n_pad <= top:
        raise ValueError(f"n_pad {n_pad} is past the {mode} score fill's "
                         f"{top} columns: the blocked fill takes it")
    return max(32, -(-n_pad // (32 * width)) * 32), width


def blocked_c_blk(mode: str, n_pad: int, dtype=torch.float32) -> int | None:
    """The column block at which ``scores`` / ``fit_scores`` hand a target
    of n_pad columns to the blocked score fill, or None where the
    register-strip fill takes it (up to ``flat_cap(mode, dtype)``)."""
    from aligntools_tpu_torch.engine import select

    if n_pad <= flat_cap(mode, dtype):
        return None
    return select.blocked_c_blk(_edit64(mode, dtype))


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _shift_in(x, col):
    """[col, x[:, :-1]]: shift right one column, border column in front."""
    return torch.cat([col, x[:, :-1]], dim=1)


def _cummax(x):
    return torch.cummax(x, dim=1).values


def _affine_plain(local, m_pad, n_pad, qs, ts, ns, ms, params):
    match, mis, o, e = (params[0, k] for k in range(4))
    B, dev = qs.shape[0], qs.device
    jf = torch.arange(1, n_pad + 1, device=dev, dtype=params.dtype)[None, :]
    jc = torch.arange(1, n_pad + 1, device=dev, dtype=torch.int32)[None, :]
    ej = e * jf
    oj = o - ej
    zcol = torch.zeros((B, 1), device=dev, dtype=params.dtype)
    negcol = torch.full((B, 1), NEG, device=dev, dtype=params.dtype)
    zero = torch.zeros((), device=dev, dtype=params.dtype)
    if local:  # calloc-zero borders
        mp = lp = best = torch.zeros((B, n_pad), device=dev,
                                     dtype=params.dtype)
    else:  # row 0: M = L = -inf, U = o + e*j
        mp = lp = torch.full((B, n_pad), NEG, device=dev, dtype=params.dtype)
        best = (o + ej).expand(B, n_pad)
    acc = torch.full((B, n_pad), NEG, device=dev, dtype=params.dtype)
    for i in range(1, m_pad + 1):
        sub = torch.where(ts == qs[:, i - 1 : i], match, mis)
        l_row = torch.maximum(lp + e, mp + o)
        if local:
            m_row = torch.maximum(_shift_in(best, zcol) + sub, zero)
            u_row = torch.maximum(_cummax(_shift_in(m_row, zcol) + oj), zero) + ej
            acc = torch.maximum(acc, torch.where(ms >= i, m_row, NEG))
        else:
            # column-0 diagonal border: 0 at i = 1, then L(i-1, 0)
            bb = zcol if i == 1 else zcol + (o + e * (i - 1.0))
            m_row = _shift_in(best, bb) + sub
            u_row = _cummax(_shift_in(m_row, negcol) + oj) + ej
        best = torch.maximum(torch.maximum(l_row, m_row), u_row)
        if not local:
            acc = torch.where(ms == i, best, acc)
        mp, lp = m_row, l_row
    mask = jc <= ns if local else jc == ns
    out = torch.where(mask, acc, NEG).amax(dim=1)
    return out + 0.0 if local else out


def _overlap_plain(m_pad, n_pad, qs, ts, ns, ms, params):
    match, mis, o = (params[0, k] for k in range(3))
    B, dev = qs.shape[0], qs.device
    jf = torch.arange(1, n_pad + 1, device=dev, dtype=params.dtype)[None, :]
    jc = torch.arange(1, n_pad + 1, device=dev, dtype=torch.int32)[None, :]
    ojc = o * jf
    zcol = torch.zeros((B, 1), device=dev, dtype=params.dtype)
    zero = torch.zeros((), device=dev, dtype=params.dtype)
    # row 0 past column 0
    mp = torch.full((B, n_pad), NEG, device=dev, dtype=params.dtype)
    acc = torch.full((B, n_pad), NEG, device=dev, dtype=params.dtype)
    for i in range(1, m_pad + 1):
        sub = torch.where(ts == qs[:, i - 1 : i], match, mis)
        dr = torch.maximum(_shift_in(mp, zcol) + sub, mp + o)
        mp = torch.maximum(_cummax(dr - ojc), zero) + ojc  # M(i, 0) = 0 seed
        acc = torch.where(ms == i, mp, acc)
    fin = torch.where(jc <= ns - 1, acc, NEG).amax(dim=1)
    return torch.maximum(fin, zero) + 0.0  # the j = 0 border's 0


def _edit_plain(m_pad, n_pad, qs, ts, ns, ms, params):
    """int32 from a float32 params row (u = (int)params[1]); float64, with
    +inf in place of INT32_MAX, from a float64 one (the double instance)."""
    B, dev = qs.shape[0], qs.device
    f64 = params.dtype == torch.float64
    dt = torch.float64 if f64 else torch.int32
    top = float("inf") if f64 else INT32_MAX
    u = params[0, 1].to(dt)
    zero = torch.zeros((), dtype=dt, device=dev)
    jc = torch.arange(1, n_pad + 1, device=dev, dtype=torch.int32)[None, :]
    jv = jc.to(dt)
    prev = jv.expand(B, n_pad)  # M(0, j) = j
    acc = torch.zeros((B, n_pad), dtype=dt, device=dev)
    for i in range(1, m_pad + 1):
        sub = torch.where(ts == qs[:, i - 1 : i], zero, u)
        pb = torch.full((B, 1), i - 1, dtype=dt, device=dev)
        cand = torch.minimum(_shift_in(prev, pb) + sub, prev + 1)
        # row[0] = i; row[j] = min(cand[j], row[j-1] + 1)
        v = torch.clamp_max(torch.cummin(cand - jv, dim=1).values, i)
        prev = v + jv
        acc = torch.where(ms == i, prev, acc)
    return torch.where(jc == ns, acc, top).amin(dim=1)


def _fit_plain(use_jump, m_pad, n_pad, qs, ts, allow, ns, ms, params):
    match, mis, o, e, jp = (params[0, k] for k in range(5))
    B, dev = qs.shape[0], qs.device
    jf = torch.arange(1, n_pad + 1, device=dev, dtype=params.dtype)[None, :]
    jc = torch.arange(1, n_pad + 1, device=dev, dtype=torch.int32)[None, :]
    ej = e * jf
    zcol = torch.zeros((B, 1), device=dev, dtype=params.dtype)
    negcol = torch.full((B, 1), NEG, device=dev, dtype=params.dtype)
    # row 0: M = U = 0, L = J = -inf
    mp = best = torch.zeros((B, n_pad), device=dev, dtype=params.dtype)
    lp = torch.full((B, n_pad), NEG, device=dev, dtype=params.dtype)
    acc = torch.full((B, n_pad), NEG, device=dev, dtype=params.dtype)
    if use_jump:  # jp where jump entry is allowed, -inf elsewhere
        jbias = torch.where(allow > 0.0, jp, NEG)
    for i in range(1, m_pad + 1):
        sub = torch.where(ts == qs[:, i - 1 : i], match, mis)
        # the column-0 diagonal border is 0 only at i = 1
        m_row = _shift_in(best, zcol if i == 1 else negcol) + sub
        l_row = torch.maximum(lp + e, mp + o)
        sm = _shift_in(m_row, negcol)
        u_row = _cummax(sm + (o - ej)) + ej
        best_ml = torch.maximum(m_row, l_row)
        best = torch.maximum(best_ml, u_row)
        if use_jump:  # J carries for free: a max-scan with no slope
            best = torch.maximum(best, _cummax(sm + jbias))
        acc = torch.where(ms == i, best_ml, acc)  # U is excluded
        mp, lp = m_row, l_row
    return torch.where(jc <= ns - 1, acc, NEG).amax(dim=1)


def scores_plain(mode, m_pad, n_pad, qs, ts, ns, ms, params):
    """Plain version of ``scores`` (any device)."""
    global plain_calls
    plain_calls += 1
    if mode in ("global", "local"):
        return _affine_plain(mode == "local", m_pad, n_pad, qs, ts, ns, ms,
                             params)
    if mode == "overlap":
        return _overlap_plain(m_pad, n_pad, qs, ts, ns, ms, params)
    if mode == "edit":
        return _edit_plain(m_pad, n_pad, qs, ts, ns, ms, params)
    raise ValueError(f"unknown score mode {mode!r}")


def fit_scores_plain(use_jump, m_pad, n_pad, qs, ts, allow, ns, ms, params):
    """Plain version of ``fit_scores`` (any device)."""
    global plain_calls
    plain_calls += 1
    return _fit_plain(use_jump, m_pad, n_pad, qs, ts, allow, ns, ms, params)


# ---------------------------------------------------------------------------
# The EDGE phase: one chunk of rows over one rank's column slice
# ---------------------------------------------------------------------------

# the state rows a chunk leaves for the next: M, L, max(L, M, U[, J]) for
# global, local and fit; overlap's and edit's M
EDGE_TOP = {"global": 3, "local": 3, "fit": 3, "overlap": 1, "edit": 1}


def edge_states(mode: str, use_jump: bool) -> int:
    """The edge states a rank passes its right neighbour: max(L, M, U[,
    J]), M, U, and J with fit's jump; overlap's and edit's M."""
    return 4 if use_jump else EDGE_TOP[mode]


def edge_dtype(mode: str):
    return torch.int32 if mode == "edit" else torch.float32


def edge_scores_plain(mode, use_jump, col0, i0, qs, ts, allow, ns, ms,
                      params, top, ledge, acc):
    """Plain version of ``ops/blocked.edge_scores`` (any device): rows i0+1
    .. i0+R of global columns col0+1 .. col0+n_loc of the score fill.

      qs     (B, R) int32, the query chars of those rows (pad -1)
      ts     (B, n_loc) int32, the slice's target chars (pad -2)
      allow  (B, n_loc) float32, allow[:, k] gates J's entry into column
             col0+k+1 (fit with the jump; else None)
      top    (B, EDGE_TOP, n_loc) the state rows of row i0 (edit int32)
      ledge  (B, edge_states, R+1) the left edge: the states at column col0
             of rows i0 .. i0+R (edit int32)
      acc    (B,) the running candidate (float32; edit int32), raised to
             the chunk's (lowered for edit) in place: local's maximum of M
             over rows <= m and columns <= n, global's max(L, M, U) at (m,
             n), fit's max(M, L) and overlap's M on row m over columns <=
             n-1, edit's M(m, n)

    Returns (bottom, redge): the state rows of row i0+R and the right edge
    (B, edge_states, R), the states at column col0+n_loc of rows i0+1 ..
    i0+R. Every row and column is filled, pad ones included."""
    global plain_calls
    plain_calls += 1
    B, R = qs.shape
    n_loc = ts.shape[1]
    dev = qs.device
    dt = edge_dtype(mode)
    match, mis, o, e, jp = (params[0, k].to(torch.float32) for k in range(5))
    jc = torch.arange(col0 + 1, col0 + n_loc + 1, device=dev,
                      dtype=torch.int32)[None, :]
    jf = jc.to(dt)
    m_vec, n_col = ms[:, 0], ns
    top = top.clone()
    redge = torch.empty((B, edge_states(mode, use_jump), R), dtype=dt,
                        device=dev)
    if mode == "edit":
        u = params[0, 1].to(torch.int32)
        prev = top[:, 0]
        for r in range(1, R + 1):
            sub = torch.where(ts == qs[:, r - 1 : r], 0, u)
            cand = torch.minimum(_shift_in(prev, ledge[:, 0, r - 1 : r]) + sub,
                                 prev + 1) - jf
            run = torch.minimum(torch.cummin(cand, dim=1).values,
                                ledge[:, 0, r : r + 1] - col0)
            prev = (run + jf).to(torch.int32)
            redge[:, 0, r - 1] = prev[:, -1]
            hit = (m_vec == i0 + r)[:, None] & (jc == n_col)
            acc.copy_(torch.minimum(acc, torch.where(hit, prev, INT32_MAX)
                                    .amin(dim=1)))
        top[:, 0] = prev
        return top, redge
    if mode == "overlap":
        mp = top[:, 0]
        for r in range(1, R + 1):
            sub = torch.where(ts == qs[:, r - 1 : r], match, mis)
            dr = torch.maximum(_shift_in(mp, ledge[:, 0, r - 1 : r]) + sub,
                               mp + o)
            run = torch.maximum(_cummax(dr - o * jf),
                                ledge[:, 0, r : r + 1] - o * col0)
            mp = run + o * jf
            redge[:, 0, r - 1] = mp[:, -1]
            hit = (m_vec == i0 + r)[:, None] & (jc <= n_col - 1)
            acc.copy_(torch.maximum(acc, torch.where(hit, mp, NEG)
                                    .amax(dim=1)))
        top[:, 0] = mp
        return top, redge
    local = mode == "local"
    mp, lp, bp = top[:, 0], top[:, 1], top[:, 2]
    if use_jump:
        jbias = torch.where(allow > 0.0, jp, NEG)
    for r in range(1, R + 1):
        i = i0 + r
        sub = torch.where(ts == qs[:, r - 1 : r], match, mis)
        m_row = _shift_in(bp, ledge[:, 0, r - 1 : r]) + sub
        if local:
            m_row = torch.clamp_min(m_row, 0.0)
        l_row = torch.maximum(lp + e, mp + o)
        em = ledge[:, 1, r : r + 1]
        sm = _shift_in(m_row, em)
        u_row = torch.maximum(_cummax(sm + (o - e * jf)),
                              ledge[:, 2, r : r + 1] - e * col0) + e * jf
        ml = torch.maximum(m_row, l_row)
        best = torch.maximum(ml, u_row)
        if use_jump:
            j_row = torch.maximum(_cummax(sm + jbias), ledge[:, 3, r : r + 1])
            best = torch.maximum(best, j_row)
            redge[:, 3, r - 1] = j_row[:, -1]
        redge[:, 0, r - 1] = best[:, -1]
        redge[:, 1, r - 1] = m_row[:, -1]
        redge[:, 2, r - 1] = u_row[:, -1]
        if local:
            hit = ((m_vec >= i)[:, None] & (jc <= n_col), m_row)
        elif mode == "global":
            hit = ((m_vec == i)[:, None] & (jc == n_col), best)
        else:
            hit = ((m_vec == i)[:, None] & (jc <= n_col - 1), ml)
        acc.copy_(torch.maximum(acc, torch.where(hit[0], hit[1], NEG)
                                .amax(dim=1)))
        mp, lp, bp = m_row, l_row, best
    top[:, 0], top[:, 1], top[:, 2] = mp, lp, bp
    return top, redge


def edge_analytic(mode, use_jump, kind, i0, R, col0, B, o, e, device):
    """A chunk's analytic left edge (B, states, R+1) at column col0, made
    on ``device``: the column-0 border of rows i0 .. i0+R at col0 == 0
    (rank 0); at col0 > 0 the row-0 values at column col0 in row 0 (zeros
    elsewhere: those rows are the left rank's). ``kind`` "scores"
    (``edge_states``: max(L, M, U[, J]), M, U, J; overlap and edit M) or
    "ptr" (``ops/ptr.edge_states``: M, L, U[, J]; overlap M), in the
    fill's value type; ``o``, ``e`` the gap params."""
    from aligntools_tpu_torch.ops import ptr

    n_st = (edge_states(mode, use_jump) if kind == "scores"
            else ptr.edge_states(mode, use_jump))
    i = torch.arange(i0, i0 + R + 1, device=device, dtype=torch.float64)
    neg, zero = torch.full_like(i, NEG), torch.zeros_like(i)
    first = i == 0
    if col0 > 0:  # row 0 at column col0; the rest the left rank's
        uu = o + e * col0 if mode == "global" else 0.0
        mm = NEG if mode == "global" else 0.0
        ll = 0.0 if mode == "local" else NEG
        vals = {"edit": [col0], "overlap": [NEG]}.get(
            mode, [uu, mm, uu, NEG] if kind == "scores" else [mm, ll, uu, NEG])
        rows = [torch.where(first, v, zero) for v in vals]
    elif mode == "edit":
        rows = [i]  # M(i, 0) = i
    elif mode == "overlap":
        rows = [zero]
    elif mode == "local":
        rows = [zero, zero, zero, neg]
    else:
        # column 0: M and U live at row 0 only (global U(0, 0) = o), global
        # L(i, 0) = o + e*i; the diagonal reads max(L, M, U), 0 at row 0
        mm = torch.where(first, 0.0, NEG)
        uu = torch.where(first, o if mode == "global" else 0.0, NEG)
        ll = o + e * i if mode == "global" else neg
        bb = torch.where(first, 0.0, ll if mode == "global" else NEG)
        rows = [bb, mm, uu, neg] if kind == "scores" else [mm, ll, uu, neg]
    x = torch.stack(rows[:n_st])[None].expand(B, -1, -1)
    return x.to(edge_dtype(mode)).contiguous()


def top_analytic(mode, kind, col0, n_loc, B, o, e, device):
    """Row 0's state rows at global columns col0+1 .. col0+n_loc, made on
    ``device``, the state buffer of chunk 0: ``kind`` "scores"
    (``EDGE_TOP``: M, L, max(L, M, U), which is U on row 0; overlap and
    edit M) or "ptr" (``ops/ptr.TOP_STATES``: M, L, U[, J]; overlap M)."""
    from aligntools_tpu_torch.ops import ptr

    jf = torch.arange(col0 + 1, col0 + n_loc + 1, device=device,
                      dtype=torch.float64)
    neg, zero = torch.full_like(jf, NEG), torch.zeros_like(jf)
    if mode == "edit":
        rows = [jf]
    elif mode == "overlap":
        rows = [neg]
    else:
        uu = o + e * jf if mode == "global" else zero
        mm = neg if mode == "global" else zero
        ll = zero if mode == "local" else neg
        rows = [mm, ll, uu, neg]
        rows = rows[: 3 if kind == "scores" else ptr.TOP_STATES[mode]]
    x = torch.stack(rows)[None].expand(B, -1, -1)
    return x.to(edge_dtype(mode)).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_lib = None


def _kernels():
    """The built kernel library with its C signatures declared (every
    pointer and the stream as c_void_p, so ctypes keeps all 64 bits)."""
    global _lib
    if _lib is None:
        from aligntools_tpu_torch.ops import _build

        lib = _build.load()
        P, I = ctypes.c_void_p, ctypes.c_int
        # mode, use_jump, qs, ts, allow, ns, ms, params, out, B, m_pad,
        # n_pad, threads, width, stream
        lib.at_score_fill.argtypes = [I, I, P, P, P, P, P, P, P, I, I, I, I,
                                      I, P]
        lib.at_score_fill.restype = ctypes.c_int
        # qs, ts, ns, ms, params, out, B, m_pad, n_pad, threads, width,
        # stream
        lib.at_edit_fill64.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P]
        lib.at_edit_fill64.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_tensors(want, device):
    """Raise unless every (name, tensor, dtype, shape) of ``want`` has its
    dtype and shape, lies contiguous on ``device``, a CPU or CUDA device."""
    for name, x, dtype, shape in want:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: want {dtype} {shape}, got {x.dtype} "
                f"{tuple(x.shape)}"
            )
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, qs on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def _check(m_pad, n_pad, qs, ts, ns, ms, params, allow=None):
    B = qs.shape[0] if qs.dim() == 2 else -1
    want = [("qs", qs, torch.int32, (B, m_pad)),
            ("ts", ts, torch.int32, (B, n_pad)),
            ("ns", ns, torch.int32, (B, 1)),
            ("ms", ms, torch.int32, (B, 1)),
            ("params", params, torch.float64 if params.dtype == torch.float64
             else torch.float32, (1, 8))]
    if allow is not None:
        want.append(("allow", allow, torch.float32, (B, n_pad)))
    check_tensors(want, qs.device)


def _launch_strip(mode, use_jump, m_pad, n_pad, qs, ts, allow, ns, ms,
                  params):
    """Launch the register-strip score fill of ``mode`` (``allow`` read
    with fit's jump alone) on CUDA tensors at ``flat_shape(mode, n_pad)``
    on the current stream (the C entry refuses an n_pad off the 16-column
    grid); returns (B,) float32, int32 for edit. A float64 params row takes
    edit's double instance (float64 out); the other modes have none."""
    global launches64
    f64 = params.dtype == torch.float64
    if f64 and mode != "edit":
        raise ValueError(f"the {mode} score fill has no double-precision "
                         f"instance on the card (edit's alone: a pair past "
                         f"float32's range takes the pointer fill)")
    threads, width = flat_shape(mode, n_pad, params.dtype)
    if ts.data_ptr() % 16:
        raise ValueError("ts must be 16-byte aligned (the kernel reads it "
                         "as 16-byte words)")
    out = torch.empty(qs.shape[0], device=qs.device,
                      dtype=params.dtype if f64 else torch.int32
                      if mode == "edit" else torch.float32)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        if f64:
            err = _kernels().at_edit_fill64(
                qs.data_ptr(), ts.data_ptr(), ns.data_ptr(), ms.data_ptr(),
                params.data_ptr(), out.data_ptr(), qs.shape[0], m_pad, n_pad,
                threads, width, stream)
        else:
            err = _kernels().at_score_fill(
                MODES.index(mode), int(bool(use_jump)), qs.data_ptr(),
                ts.data_ptr(), allow.data_ptr() if use_jump else None,
                ns.data_ptr(), ms.data_ptr(), params.data_ptr(),
                out.data_ptr(), qs.shape[0], m_pad, n_pad, threads, width,
                stream)
    if err != 0:
        raise RuntimeError(f"{mode} score fill kernel launch failed: CUDA "
                           f"error {err}")
    if f64:
        launches64 += 1
    else:
        launches["affine" if mode in ("global", "local") else mode] += 1
    return out


def scores(mode, m_pad, n_pad, qs, ts, ns, ms, params):
    """Score-only fill for global / local / overlap / edit (the
    counterpart of ``pallas_scores``). Returns (B,) float32, int32 for
    edit; float64 for a float64 params row. Targets past ``flat_cap(mode,
    params.dtype)`` run the blocked score fill at ``blocked_c_blk(mode,
    n_pad, params.dtype)``."""
    c_blk = blocked_c_blk(mode, n_pad, params.dtype)
    if c_blk:
        from aligntools_tpu_torch.ops import blocked

        return blocked.blocked_scores(mode, False, m_pad, n_pad, c_blk, qs,
                                      ts, None, ns, ms, params)
    _check(m_pad, n_pad, qs, ts, ns, ms, params)
    if qs.device.type == "cpu":
        return scores_plain(mode, m_pad, n_pad, qs, ts, ns, ms, params)
    if mode in ("global", "local", "overlap", "edit"):
        return _launch_strip(mode, False, m_pad, n_pad, qs, ts, None, ns, ms,
                             params)
    raise ValueError(f"unknown score mode {mode!r}")


def fit_scores(use_jump, m_pad, n_pad, qs, ts, allow, ns, ms, params):
    """Fit-mode score fill (the counterpart of ``pallas_fit_scores``).
    Returns (B,) float32. ``allow`` may be None without ``use_jump`` (every
    column allowed). Targets past ``flat_cap("fit")`` columns run the
    blocked score fill at ``blocked_c_blk("fit", n_pad, params.dtype)``."""
    c_blk = blocked_c_blk("fit", n_pad, params.dtype)
    if c_blk:
        from aligntools_tpu_torch.ops import blocked

        return blocked.blocked_scores("fit", use_jump, m_pad, n_pad, c_blk,
                                      qs, ts, allow, ns, ms, params)
    if allow is None:
        allow = torch.ones(qs.shape[:1] + (n_pad,), device=qs.device)
    _check(m_pad, n_pad, qs, ts, ns, ms, params, allow)
    if qs.device.type == "cpu":
        return fit_scores_plain(use_jump, m_pad, n_pad, qs, ts, allow, ns, ms,
                                params)
    return _launch_strip("fit", use_jump, m_pad, n_pad, qs, ts, allow, ns, ms,
                         params)
