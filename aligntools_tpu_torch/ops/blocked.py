"""Column-blocked DP fills for long targets: the CUDA kernels' wrappers.

Counterpart of ``aligntools_tpu/ops/pallas_blocked.py``: ``blocked_scores``
(the Pallas ``_blocked_affine_kernel``, all five modes) and
``blocked_ptr_fill`` (``_blocked_ptr_kernel``: global, local, fit(+jump),
overlap), with the JAX entries' argument layout (``ops/scan.py``'s, plus
the column block ``c_blk``) and outputs:

  blocked_scores    (B,) float32, int32 for edit
  blocked_ptr_fill  (score, a, b, ptrs) in ``ops/ptr.py``'s layout: ptrs
                    (B, m_pad / rpb, n_pad) uint8, columns 1..n_pad, every
                    byte written

Both also take flat buckets too wide for the register-strip kernels
(``ptr.ptr_fill``, ``scan.scores`` and ``scan.fit_scores`` hand them
over), whose n_pad, a multiple of 128, a c_blk need not divide: the last
column block is then narrower (ragged). The JAX entries need ``n_pad %
c_blk == 0``; the results do not depend on c_blk either way.

Streaming the target in column blocks changes where the DP state lives,
not what is computed: the blocked Pallas kernels give the flat ones'
scores, start info and every pointer byte on the same inputs, pad rows and
pad columns included. So the plain versions are the flat fills' own
(``scan.scores_plain``, ``scan.fit_scores_plain``, ``ptr.ptr_fill_plain``),
and the results do not depend on ``c_blk``.

The checkpoint-rescan engine (``engine/rescan.py``) takes two more
entries, instances of the pointer fill (the CKPT and SEED phases of
``csrc/blocked_fill.cu``), whose plain versions are ``ptr.ptr_fill_plain``
with a checkpoint stride and with a seed row:

  blocked_ckpt_fill  the forward fill with no pointers: (score, a, b) as
                     ``blocked_ptr_fill``'s and the checkpoints (B, m_pad /
                     S, states, n_pad + 1) float32, the (M, L, U[, J];
                     overlap M) state rows of columns 0..n_pad at rows 0, S,
                     2S, ... (the JAX ``_forward_ckpt``'s ``cks``, a pair's
                     (m_pad / S, states, n_pad + 1))
  blocked_refill     rows i0+1 .. i0+S from one checkpoint: (B, S / rpb,
                     n_pad) pointer bytes, the whole-matrix fill's rows
                     bit for bit (the JAX ``_refill_block``)

On a CUDA tensor the wrappers launch ``csrc/blocked_fill.cu`` (a wavefront
across column blocks: one CTA per (pair, column block), each row's edge
passed to the next block behind a release/acquire progress counter; in
each block the flat fills' register-strip row, ``csrc/strip_row.cuh``:
the pointer fills at ``ptr.launch_shape`` of the column block, the score
fills at ``scan.flat_shape`` of it; see its header) or raise; on a CPU
tensor they run the plain versions.

A float64 params row (a pair past float32's exact integers, sent by
``api.align_pair`` alone) takes the double instances of the pointer fill's
three phases and of edit's score fill: scores, checkpoints and block edges
in float64, pointer bytes and start info as float32's, column blocks up to
C_BLK_MAX64. Their launches count under the kernel's name with "64".
"""

from __future__ import annotations

import ctypes

import torch

from aligntools_tpu_torch.ops import ptr, scan
from aligntools_tpu_torch.params import MODES

# the widest column block one CTA of the fills covers: 512 threads (128
# registers a thread) of ptr.WIDTH columns, and of ptr.WIDTH64 for the
# double instances (ptr.FLAT_REG_MAX_N_PAD, ptr.FLAT64_MAX_N_PAD); the
# score fills take the same caps (edit's CTA could run 1,024 threads)
C_BLK_MAX = 8192
C_BLK_MAX64 = 4096

# launches of each kernel through its wrapper, and wrapper calls that ran
# the plain versions (on a CPU tensor)
launches = {"blocked_scores": 0, "blocked_ptr": 0, "blocked_ckpt": 0,
            "blocked_refill": 0, "blocked_edit64": 0, "blocked_ptr64": 0,
            "blocked_ckpt64": 0, "blocked_refill64": 0, "edge_scores": 0,
            "edge_ptr": 0}
plain_calls = 0


def reset_counts() -> None:
    global plain_calls
    for k in launches:
        launches[k] = 0
    plain_calls = 0


def edge_thread(width: int, dtype=torch.float32) -> int:
    """The thread of a pointer fill's CTA that owns the last column of a
    block ``width`` columns wide (a multiple of 16) and so stores the
    block's edge a row and publishes its count: (width - 1) // W. The
    pointer fills launch ``ptr.launch_shape(c_blk, dtype)``, the flat
    fill's rule on the column block (W ``ptr.WIDTH``, ``ptr.WIDTH64`` for
    float64); threads past a block's width, in a ragged last block or at a
    c_blk below 32 strips, compute on pad and store nothing."""
    return (width - 1) // (ptr.WIDTH64 if dtype == torch.float64
                           else ptr.WIDTH)


def _check_blocks(n_pad, c_blk, dtype=torch.float32):
    """Raise unless c_blk is a positive multiple of 16 that fits a CTA (in
    the fill's value type) and n_pad a multiple of 16 (the last block may
    be ragged)."""
    if c_blk <= 0 or c_blk % 16 or n_pad % 16:
        raise ValueError(f"c_blk {c_blk} must be a positive multiple of 16 "
                         f"and n_pad {n_pad} a multiple of 16")
    f64 = dtype == torch.float64
    top = C_BLK_MAX64 if f64 else C_BLK_MAX
    if c_blk > top:
        raise ValueError(f"c_blk {c_blk} is past C_BLK_MAX{'64' if f64 else ''}"
                         f" {top}: a block's strips would not fit one CTA")


_fns = None


def _kernels(f64=False):
    """(scores, pointer fill, checkpoint forward, refill) C entry points
    with their signatures: the float32 ones, or with ``f64`` the double
    instances (edit's score fill alone among the scores)."""
    global _fns
    if _fns is None:
        from aligntools_tpu_torch.ops import _build

        lib = _build.load()
        P, I = ctypes.c_void_p, ctypes.c_int
        # mode, use_jump, qs, ts, allow, ns, ms, params, out, edges, flags,
        # cand, B, m_pad, n_pad, c_blk, threads, width, stream
        lib.at_blocked_scores.argtypes = [I, I, P, P, P, P, P, P, P, P, P, P,
                                          I, I, I, I, I, I, P]
        # qs, ts, ns, ms, params, out, edges, flags, cand, B, m_pad, n_pad,
        # c_blk, threads, width, stream
        lib.at_blocked_edit64.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I,
                                          I, I, I, P]
        # mode, use_jump, rpb, qs, ts, allow, ns, ms, params, score, a, b,
        # ptrs, edges, flags, cand, B, m_pad, n_pad, c_blk, threads, width,
        # stream
        ptr_args = [I, I, I, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I,
                    I, I, I, P]
        # mode, use_jump, qs, ts, allow, ns, ms, params, score, a, b, ck,
        # edges, flags, cand, B, m_pad, n_pad, c_blk, threads, width, S,
        # stream
        ckpt_args = [I, I, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I,
                     I, I, I, P]
        # mode, use_jump, rpb, qs, ts, allow, ns, ms, params, ck, i0, ptrs,
        # edges, flags, cand, B, S, n_pad, c_blk, threads, width, stream
        refill_args = [I, I, I, P, P, P, P, P, P, P, I, P, P, P, P, I, I, I,
                       I, I, I, P]
        for name, args in (("ptr_fill", ptr_args), ("ckpt_fill", ckpt_args),
                           ("refill", refill_args)):
            for suffix in ("", "64"):
                getattr(lib, f"at_blocked_{name}{suffix}").argtypes = args
        fns = ((lib.at_blocked_scores, lib.at_blocked_ptr_fill,
                lib.at_blocked_ckpt_fill, lib.at_blocked_refill),
               (lib.at_blocked_edit64, lib.at_blocked_ptr_fill64,
                lib.at_blocked_ckpt_fill64, lib.at_blocked_refill64))
        for fn in fns[0] + fns[1]:
            fn.restype = ctypes.c_int
        _fns = fns
    return _fns[int(f64)]


def _scratch(B, nblk, m_pad, device, dtype=torch.float32):
    """The wavefront's device buffers, made anew for every launch (with
    nblk = ceil(n_pad / c_blk) column blocks):

      edges  (B, nblk, 4, m_pad + 1) in the fill's value type (float32;
             edit's int32 in a float32 buffer; float64 in the double
             instances): each block's four edge states (its last column) of
             rows 0..m_pad, read by the next block
      flags  (1 + B * (nblk + 1),) int32, zeroed: the ticket counter, then
             per pair nblk progress counters (rows of the edge published)
             and one done counter (blocks finished)
      cand   (B, nblk, 4) int32: each block's start-info candidate (score
             bits, a, b; a double's high word in the fourth), merged by the
             pair's last block to finish
    """
    edges = torch.empty((B, nblk, 4, m_pad + 1), dtype=dtype, device=device)
    flags = torch.zeros(1 + B * (nblk + 1), dtype=torch.int32, device=device)
    cand = torch.empty((B, nblk, 4), dtype=torch.int32, device=device)
    return edges, flags, cand


def _check_scratch(edges, flags, cand, B, nblk, m_pad, dtype=torch.float32):
    """Raise unless the buffers have ``_scratch``'s shapes and types: the
    kernels index them from B, nblk and m_pad alone."""
    if B * nblk > scan.INT32_MAX:
        raise ValueError(f"{B} pairs x {nblk} column blocks is past the "
                         f"int32 ticket counter")
    want = ((edges, (B, nblk, 4, m_pad + 1), dtype),
            (flags, (1 + B * (nblk + 1),), torch.int32),
            (cand, (B, nblk, 4), torch.int32))
    for name, (x, shape, dt) in zip(("edges", "flags", "cand"), want):
        if tuple(x.shape) != shape or x.dtype != dt or (
                not x.is_contiguous()):
            raise ValueError(f"{name} buffer is {tuple(x.shape)} {x.dtype}; "
                             f"the kernels need a contiguous {shape} {dt}")


def _launch(name, fn, args, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def blocked_scores(mode, use_jump, m_pad, n_pad, c_blk, qs, ts, allow, ns,
                   ms, params):
    """Score-only blocked fill (the counterpart of the JAX
    ``blocked_scores``). ``allow`` (B, n_pad) float32 gates fit's jump
    entry and may be None without ``use_jump``. The last column block may
    be ragged. Returns (B,) float32, int32 for edit; a float64 params row
    takes edit's double instance (float64 out; the other modes have none on
    the card)."""
    global plain_calls
    if mode not in MODES:
        raise ValueError(f"unknown score mode {mode!r}")
    if use_jump and (mode != "fit" or allow is None):
        raise ValueError("the jump state exists in fit mode only, and needs "
                         "allow")
    f64 = params.dtype == torch.float64
    _check_blocks(n_pad, c_blk, params.dtype)
    scan._check(m_pad, n_pad, qs, ts, ns, ms, params, allow)
    if qs.device.type == "cpu":
        plain_calls += 1
        if mode == "fit":
            return scan.fit_scores_plain(use_jump, m_pad, n_pad, qs, ts,
                                         allow, ns, ms, params)
        return scan.scores_plain(mode, m_pad, n_pad, qs, ts, ns, ms, params)
    if f64 and mode != "edit":
        raise ValueError(f"the blocked {mode} score fill has no "
                         f"double-precision instance on the card")
    B, dev = qs.shape[0], qs.device
    out = torch.empty(B, dtype=params.dtype if f64 else torch.int32
                      if mode == "edit" else torch.float32, device=dev)
    threads, width = _score_shape(mode, c_blk, params.dtype, ts)
    nblk = -(-n_pad // c_blk)
    scratch = _scratch(B, nblk, m_pad, dev, params.dtype)
    _check_scratch(*scratch, B, nblk, m_pad, params.dtype)
    if f64:
        _launch("blocked_edit64", _kernels(True)[0], (
            qs.data_ptr(), ts.data_ptr(), ns.data_ptr(), ms.data_ptr(),
            params.data_ptr(), out.data_ptr(),
            *(x.data_ptr() for x in scratch), B, m_pad, n_pad, c_blk,
            threads, width), dev)
        return out
    _launch("blocked_scores", _kernels()[0], (
        MODES.index(mode), int(bool(use_jump)), qs.data_ptr(),
        ts.data_ptr(), 0 if allow is None else allow.data_ptr(),
        ns.data_ptr(), ms.data_ptr(), params.data_ptr(), out.data_ptr(),
        *(x.data_ptr() for x in scratch), B, m_pad, n_pad, c_blk, threads,
        width), dev)
    return out


def _aligned(ts):
    """Raise unless ts is 16-byte aligned (a strip's chars are read as
    16-byte words)."""
    if ts.data_ptr() % 16:
        raise ValueError("ts must be 16-byte aligned (the kernel reads it "
                         "as 16-byte words)")


def _ptr_shape(c_blk, dtype, ts):
    """The pointer fills' launch shape (threads, W) at c_blk: the flat
    pointer fill's rule on the column block."""
    _aligned(ts)
    return ptr.launch_shape(c_blk, dtype)


def _score_shape(mode, c_blk, dtype, ts):
    """The score fills' launch shape (threads, W) at c_blk: the flat score
    fill's rule on the column block (``scan.flat_shape``: W 16, 8 for edit's
    double instance; edit's CTA up to 1,024 threads)."""
    _aligned(ts)
    return scan.flat_shape(mode, c_blk, dtype)


def _name(kernel, params):
    """The launch count's key: the double instance's with a float64 row."""
    return f"{kernel}64" if params.dtype == torch.float64 else kernel


def blocked_ptr_fill(mode, use_jump, m_pad, n_pad, c_blk, qs, ts, allow, ns,
                     ms, params, rows_per_byte=1):
    """Blocked fill with packed pointer emission (the counterpart of the
    JAX ``blocked_ptr_fill``); returns (score, a, b, ptrs) as
    ``ops/ptr.py`` lays them out (the score in params' dtype: a float64
    row takes the double instance). Needs m_pad % (8 * rows_per_byte) ==
    0, as the Pallas kernel does; the last column block may be ragged."""
    global plain_calls
    rpb = rows_per_byte
    _check_blocks(n_pad, c_blk, params.dtype)
    ptr._check(mode, use_jump, m_pad, n_pad, rpb, qs, ts, allow, ns, ms,
               params)
    if m_pad % (8 * rpb):
        raise ValueError(f"m_pad {m_pad} is not a multiple of 8 * "
                         f"rows_per_byte {rpb}")
    if qs.device.type == "cpu":
        plain_calls += 1
        return ptr.ptr_fill_plain(mode, use_jump, m_pad, n_pad, qs, ts, allow,
                                  ns, ms, params, rpb)
    B, dev = qs.shape[0], qs.device
    score = torch.empty(B, dtype=params.dtype, device=dev)
    a = torch.empty(B, dtype=torch.int32, device=dev)
    b = torch.empty(B, dtype=torch.int32, device=dev)
    ptrs = torch.empty((B, m_pad // rpb, n_pad), dtype=torch.uint8,
                       device=dev)
    threads, width = _ptr_shape(c_blk, params.dtype, ts)
    nblk = -(-n_pad // c_blk)
    scratch = _scratch(B, nblk, m_pad, dev, params.dtype)
    _check_scratch(*scratch, B, nblk, m_pad, params.dtype)
    f64 = params.dtype == torch.float64
    _launch(_name("blocked_ptr", params), _kernels(f64)[1], (
        ptr.MODES.index(mode), int(bool(use_jump)), rpb, qs.data_ptr(),
        ts.data_ptr(), 0 if allow is None else allow.data_ptr(),
        ns.data_ptr(), ms.data_ptr(), params.data_ptr(), score.data_ptr(),
        a.data_ptr(), b.data_ptr(), ptrs.data_ptr(),
        *(x.data_ptr() for x in scratch), B, m_pad, n_pad, c_blk, threads,
        width), dev)
    return score, a, b, ptrs


# a checkpoint's state rows: M, L, U (global, local), fit's J too (-inf
# without the jump), overlap's M
CK_STATES = ptr.TOP_STATES


def blocked_ckpt_fill(mode, use_jump, S, m_pad, n_pad, c_blk, qs, ts, allow,
                      ns, ms, params):
    """The checkpoint forward of the pointer fill: returns (score, a, b,
    cks) as the module docstring lays them out (score and cks in params'
    dtype: a float64 row takes the double instance). Needs a stride S, a
    positive multiple of 8, that divides m_pad; the last column block may
    be ragged."""
    global plain_calls
    _check_blocks(n_pad, c_blk, params.dtype)
    ptr._check(mode, use_jump, m_pad, n_pad, 1, qs, ts, allow, ns, ms,
               params)
    if S <= 0 or S % 8 or m_pad % S:
        raise ValueError(f"stride {S} must be a positive multiple of 8 "
                         f"that divides m_pad {m_pad}")
    if qs.device.type == "cpu":
        plain_calls += 1
        return ptr.ptr_fill_plain(mode, use_jump, m_pad, n_pad, qs, ts, allow,
                                  ns, ms, params, stride=S)
    B, dev = qs.shape[0], qs.device
    score = torch.empty(B, dtype=params.dtype, device=dev)
    a = torch.empty(B, dtype=torch.int32, device=dev)
    b = torch.empty(B, dtype=torch.int32, device=dev)
    cks = torch.empty((B, m_pad // S, CK_STATES[mode], n_pad + 1),
                      dtype=params.dtype, device=dev)
    threads, width = _ptr_shape(c_blk, params.dtype, ts)
    nblk = -(-n_pad // c_blk)
    scratch = _scratch(B, nblk, m_pad, dev, params.dtype)
    _check_scratch(*scratch, B, nblk, m_pad, params.dtype)
    f64 = params.dtype == torch.float64
    _launch(_name("blocked_ckpt", params), _kernels(f64)[2], (
        ptr.MODES.index(mode), int(bool(use_jump)), qs.data_ptr(),
        ts.data_ptr(), 0 if allow is None else allow.data_ptr(),
        ns.data_ptr(), ms.data_ptr(), params.data_ptr(), score.data_ptr(),
        a.data_ptr(), b.data_ptr(), cks.data_ptr(),
        *(x.data_ptr() for x in scratch), B, m_pad, n_pad, c_blk, threads,
        width, S), dev)
    return score, a, b, cks


def blocked_refill(mode, use_jump, S, n_pad, c_blk, ck, i0, qs, ts, allow,
                   ns, ms, params, rows_per_byte=1):
    """Rows i0+1 .. i0+S of the pointer fill from ``ck`` (B, states, n_pad
    + 1), the state rows of row i0 (a checkpoint of
    ``blocked_ckpt_fill``, in params' dtype); ``qs`` (B, S) holds those
    rows' query chars. Returns the (B, S / rows_per_byte, n_pad) pointer
    bytes; needs S % (8 * rows_per_byte) == 0."""
    global plain_calls
    rpb = rows_per_byte
    _check_blocks(n_pad, c_blk, params.dtype)
    ptr._check(mode, use_jump, S, n_pad, rpb, qs, ts, allow, ns, ms, params)
    if S % (8 * rpb):
        raise ValueError(f"stride {S} is not a multiple of 8 * "
                         f"rows_per_byte {rpb}")
    B = qs.shape[0]
    scan.check_tensors([("ck", ck, params.dtype,
                         (B, CK_STATES[mode], n_pad + 1))], qs.device)
    if not 0 <= i0 <= scan.INT32_MAX:
        raise ValueError(f"row {i0} is not a row of an int32 fill")
    if qs.device.type == "cpu":
        plain_calls += 1
        return ptr.ptr_fill_plain(mode, use_jump, S, n_pad, qs, ts, allow,
                                  ns, ms, params, rpb, seed=ck, i0=i0)
    dev = qs.device
    ptrs = torch.empty((B, S // rpb, n_pad), dtype=torch.uint8, device=dev)
    threads, width = _ptr_shape(c_blk, params.dtype, ts)
    nblk = -(-n_pad // c_blk)
    scratch = _scratch(B, nblk, S, dev, params.dtype)
    _check_scratch(*scratch, B, nblk, S, params.dtype)
    f64 = params.dtype == torch.float64
    _launch(_name("blocked_refill", params), _kernels(f64)[3], (
        ptr.MODES.index(mode), int(bool(use_jump)), rpb, qs.data_ptr(),
        ts.data_ptr(), 0 if allow is None else allow.data_ptr(),
        ns.data_ptr(), ms.data_ptr(), params.data_ptr(), ck.data_ptr(),
        i0, ptrs.data_ptr(), *(x.data_ptr() for x in scratch), B, S, n_pad,
        c_blk, threads, width), dev)
    return ptrs


# ---------------------------------------------------------------------------
# The EDGE phase: one chunk of rows over one rank's column slice
# (parallel/seqpar.py)
# ---------------------------------------------------------------------------


def _edge_check(mode, use_jump, col0, i0, c_blk, qs, ts, allow, ns, ms,
                params, top, ledge, n_top, n_edge, value):
    """Raise unless a chunk's inputs have the EDGE phase's layout (see
    ``edge_scores``); returns (B, R, n_loc)."""
    if params.dtype != torch.float32:
        raise ValueError("the EDGE phase has float32 instances only (a pair "
                         "past float32's exact range is refused)")
    B, R = qs.shape if qs.dim() == 2 else (-1, -1)
    n_loc = ts.shape[1] if ts.dim() == 2 else -1
    _check_blocks(n_loc, c_blk)
    if R < 1 or col0 < 0 or col0 % 16 or not 0 <= i0 <= scan.INT32_MAX - R:
        raise ValueError(f"a chunk of {R} rows at row {i0}, column {col0} "
                         f"(a multiple of 16)")
    if use_jump and (mode != "fit" or allow is None):
        raise ValueError("the jump state exists in fit mode only, and needs "
                         "allow")
    want = [("qs", qs, torch.int32, (B, R)),
            ("ts", ts, torch.int32, (B, n_loc)),
            ("ns", ns, torch.int32, (B, 1)), ("ms", ms, torch.int32, (B, 1)),
            ("params", params, torch.float32, (1, 8)),
            ("top", top, value, (B, n_top, n_loc)),
            ("ledge", ledge, value, (B, n_edge, R + 1))]
    if use_jump:
        want.append(("allow", allow, torch.float32, (B, n_loc)))
    scan.check_tensors(want, qs.device)
    if B * (-(-n_loc // c_blk) + 1) > scan.INT32_MAX:
        raise ValueError(f"{B} pairs is past the int32 ticket counter")
    return B, R, n_loc


def _edge_scratch(B, nblk, R, ledge, n_edge, dtype):
    """The wavefront's buffers with one more edge slot a pair: (B, nblk +
    1, 4, R + 1) edges whose slot 0 is the left edge (read by block 0) and
    whose slot nblk the last block writes (the right edge), the counters
    and the candidates of ``_scratch``."""
    dev = ledge.device
    edges = torch.empty((B, nblk + 1, 4, R + 1), dtype=dtype, device=dev)
    edges[:, 0, :n_edge] = ledge
    flags = torch.zeros(1 + B * (nblk + 2), dtype=torch.int32, device=dev)
    cand = torch.empty((B, nblk, 4), dtype=torch.int32, device=dev)
    return edges, flags, cand


def edge_scores(mode, use_jump, col0, i0, c_blk, qs, ts, allow, ns, ms,
                params, top, ledge, acc):
    """The EDGE phase of the blocked score fill: rows i0+1 .. i0+R (qs (B,
    R)) of global columns col0+1 .. col0+n_loc (ts (B, n_loc), allow (B,
    n_loc) with fit's jump) in column blocks of c_blk, one launch. ``top``
    (B, scan.EDGE_TOP[mode], n_loc) holds the state rows of row i0 and
    ``ledge`` (B, scan.edge_states, R+1) the left edge, the states at
    column col0 of rows i0 .. i0+R (both int32 for edit, else float32);
    ``acc`` (B,) the running candidate, raised (edit: lowered) in place.
    Returns (bottom, redge), the state rows of row i0+R and the right edge
    (B, edge_states, R) of rows i0+1 .. i0+R; ``scan.edge_scores_plain``
    is the plain version."""
    global plain_calls
    value = scan.edge_dtype(mode)
    n_edge = scan.edge_states(mode, use_jump)
    B, R, n_loc = _edge_check(mode, use_jump, col0, i0, c_blk, qs, ts,
                              allow, ns, ms, params, top, ledge,
                              scan.EDGE_TOP[mode], n_edge, value)
    scan.check_tensors([("acc", acc, value, (B,))], qs.device)
    if qs.device.type == "cpu":
        plain_calls += 1
        return scan.edge_scores_plain(mode, use_jump, col0, i0, qs, ts, allow,
                                      ns, ms, params, top, ledge, acc)
    threads, width = _score_shape(mode, c_blk, torch.float32, ts)
    nblk = -(-n_loc // c_blk)
    edges, flags, cand = _edge_scratch(B, nblk, R, ledge, n_edge, value)
    bottom = torch.empty_like(top)
    _launch("edge_scores", _edge_kernels()[0], (
        MODES.index(mode), int(bool(use_jump)), qs.data_ptr(), ts.data_ptr(),
        0 if allow is None else allow.data_ptr(), ns.data_ptr(),
        ms.data_ptr(), params.data_ptr(), top.data_ptr(), bottom.data_ptr(),
        acc.data_ptr(), edges.data_ptr(), flags.data_ptr(), cand.data_ptr(),
        B, R, n_loc, c_blk, threads, width, col0, i0), qs.device)
    return bottom, edges[:, nblk, :n_edge, 1:]


def edge_ptr_fill(mode, use_jump, col0, i0, c_blk, qs, ts, allow, ns, ms,
                  params, top, ledge, cand, slab, rows_per_byte=1):
    """The EDGE phase of the blocked pointer fill: rows i0+1 .. i0+R of
    global columns col0+1 .. col0+n_loc, as ``edge_scores`` lays them out,
    their pointer bytes written into rows i0/rpb .. (i0+R)/rpb of ``slab``
    (B, slab rows, n_loc) uint8; ``top`` (B, ptr.TOP_STATES[mode], n_loc)
    and ``ledge`` (B, ptr.edge_states, R+1) float32; ``cand`` (B, 4) int32
    the running start candidate (score bits, a, b, 0), updated in place
    (``ptr.ptr_fill_plain``'s ``edge``). Needs i0 and R multiples of 8 *
    rows_per_byte. Returns (bottom, redge)."""
    global plain_calls
    rpb = rows_per_byte
    n_edge = ptr.edge_states(mode, use_jump)
    B, R, n_loc = _edge_check(mode, use_jump, col0, i0, c_blk, qs, ts,
                              allow, ns, ms, params, top, ledge,
                              CK_STATES.get(mode, 0), n_edge,
                              torch.float32)
    if mode not in ptr.MODES or rpb not in (1, 2, 4) or R % (8 * rpb) or (
            i0 % (8 * rpb)) or (rpb > 1 and use_jump) or (
            rpb == 4 and mode != "overlap"):
        raise ValueError(f"no {mode} pointer layout of rows_per_byte {rpb} "
                         f"for a chunk of {R} rows at row {i0}")
    rows = slab.shape[1] if slab.dim() == 3 else -1
    scan.check_tensors([("cand", cand, torch.int32, (B, 4)),
                        ("slab", slab, torch.uint8, (B, rows, n_loc))],
                       qs.device)
    if (i0 + R) // rpb > rows:
        raise ValueError(f"rows {i0 + 1} .. {i0 + R} pass the slab's "
                         f"{rows * rpb}")
    if qs.device.type == "cpu":
        plain_calls += 1
        chunk, bottom, redge = ptr.ptr_fill_plain(
            mode, use_jump, R, n_loc, qs, ts, allow, ns, ms, params, rpb,
            seed=top, i0=i0, col0=col0, edge=ledge, cand=cand)
        slab[:, i0 // rpb : (i0 + R) // rpb] = chunk
        return bottom, redge
    threads, width = _ptr_shape(c_blk, params.dtype, ts)
    nblk = -(-n_loc // c_blk)
    edges, flags, cand_blk = _edge_scratch(B, nblk, R, ledge, n_edge,
                                           torch.float32)
    bottom = torch.empty_like(top)
    _launch("edge_ptr", _edge_kernels()[1], (
        ptr.MODES.index(mode), int(bool(use_jump)), rpb, qs.data_ptr(),
        ts.data_ptr(), 0 if allow is None else allow.data_ptr(),
        ns.data_ptr(), ms.data_ptr(), params.data_ptr(), top.data_ptr(),
        bottom.data_ptr(), cand.data_ptr(), slab.data_ptr(), rows,
        edges.data_ptr(), flags.data_ptr(), cand_blk.data_ptr(), B, R,
        n_loc, c_blk, threads, width, col0, i0), qs.device)
    return bottom, edges[:, nblk, :n_edge, 1:]


_edge_fns = None


def _edge_kernels():
    """The EDGE phase's C entry points (score fill, pointer fill)."""
    global _edge_fns
    if _edge_fns is None:
        from aligntools_tpu_torch.ops import _build

        lib = _build.load()
        P, I = ctypes.c_void_p, ctypes.c_int
        # mode, use_jump, qs, ts, allow, ns, ms, params, top, bottom, acc,
        # edges, flags, cand, B, R, n_loc, c_blk, threads, width, col0, i0,
        # stream
        lib.at_blocked_edge_scores.argtypes = [I, I] + [P] * 12 + [I] * 8 + [
            P]
        # mode, use_jump, rpb, qs, ts, allow, ns, ms, params, top, bottom,
        # cand, slab, slab rows, edges, flags, cand_blk, B, R, n_loc, c_blk,
        # threads, width, col0, i0, stream
        lib.at_blocked_edge_ptr.argtypes = [I, I, I] + [P] * 10 + [I] + [
            P] * 3 + [I] * 8 + [P]
        fns = (lib.at_blocked_edge_scores, lib.at_blocked_edge_ptr)
        for fn in fns:
            fn.restype = ctypes.c_int
        _edge_fns = fns
    return _edge_fns
