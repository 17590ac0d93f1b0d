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
across column blocks: one CTA per (pair, column block), the row state of
a block in shared memory, each row's edge passed to the next block behind
a release/acquire progress counter; see its header) or raise; on a CPU
tensor they run the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from aligntools_tpu_torch.ops import ptr, scan
from aligntools_tpu_torch.params import MODES

# the kernels' column block on the H100 (a divisor of batch.BLOCKED_C_BLK):
# the fastest of 8,192, 4,096 and 2,048 on the reference fixture's shape,
# on long-target read sets and on P3 (64 x 512 x 32,768 fit+jump, a flat
# bucket too wide for the flat pointer kernel; chip_smoke.py's blocked,
# long and ptr phases; PERF.md): narrower blocks put more CTAs, and more
# of them an SM, in flight
C_BLK = 2048
# the widest column block whose row state and pointer staging fit one CTA's
# shared memory (fit+jump's pointer fill: 26 bytes a column, 216 KiB at 8192)
C_BLK_MAX = 8192
STRIP = 8  # block columns per thread the launch shape aims for

# launches of each kernel through its wrapper, and wrapper calls that ran
# the plain versions (on a CPU tensor)
launches = {"blocked_scores": 0, "blocked_ptr": 0, "blocked_ckpt": 0,
            "blocked_refill": 0}
plain_calls = 0


def reset_counts() -> None:
    global plain_calls
    for k in launches:
        launches[k] = 0
    plain_calls = 0


def launch_shape(c_blk: int) -> tuple[int, int]:
    """(threads per CTA, strip slots per thread) of a column block of
    c_blk columns."""
    threads = min(1024, max(32, -(-c_blk // (32 * STRIP)) * 32))
    return threads, -(-c_blk // threads)


def _check_blocks(n_pad, c_blk):
    """Raise unless c_blk is a positive multiple of 16 that fits a CTA and
    n_pad a multiple of 16 (the last block may be ragged)."""
    if c_blk <= 0 or c_blk % 16 or n_pad % 16:
        raise ValueError(f"c_blk {c_blk} must be a positive multiple of 16 "
                         f"and n_pad {n_pad} a multiple of 16")
    if c_blk > C_BLK_MAX:
        raise ValueError(f"c_blk {c_blk} is past C_BLK_MAX {C_BLK_MAX}: a "
                         f"block's row state would not fit a CTA's shared "
                         f"memory")


_fns = None


def _kernels():
    """(scores, pointer fill) C entry points with their signatures."""
    global _fns
    if _fns is None:
        from aligntools_tpu_torch.ops import _build

        lib = _build.load()
        P, I = ctypes.c_void_p, ctypes.c_int
        # mode, use_jump, qs, ts, allow, ns, ms, params, out, edges, flags,
        # cand, B, m_pad, n_pad, c_blk, threads, wmax, stream
        lib.at_blocked_scores.argtypes = [I, I, P, P, P, P, P, P, P, P, P, P,
                                          I, I, I, I, I, I, P]
        # mode, use_jump, rpb, qs, ts, allow, ns, ms, params, score, a, b,
        # ptrs, edges, flags, cand, B, m_pad, n_pad, c_blk, threads, wmax,
        # stream
        lib.at_blocked_ptr_fill.argtypes = [I, I, I, P, P, P, P, P, P, P, P,
                                            P, P, P, P, P, I, I, I, I, I, I,
                                            P]
        # mode, use_jump, qs, ts, allow, ns, ms, params, score, a, b, ck,
        # edges, flags, cand, B, m_pad, n_pad, c_blk, threads, wmax, S,
        # stream
        lib.at_blocked_ckpt_fill.argtypes = [I, I, P, P, P, P, P, P, P, P, P,
                                             P, P, P, P, I, I, I, I, I, I, I,
                                             P]
        # mode, use_jump, rpb, qs, ts, allow, ns, ms, params, ck, i0, ptrs,
        # edges, flags, cand, B, S, n_pad, c_blk, threads, wmax, stream
        lib.at_blocked_refill.argtypes = [I, I, I, P, P, P, P, P, P, P, I, P,
                                          P, P, P, I, I, I, I, I, I, P]
        fns = (lib.at_blocked_scores, lib.at_blocked_ptr_fill,
               lib.at_blocked_ckpt_fill, lib.at_blocked_refill)
        for fn in fns:
            fn.restype = ctypes.c_int
        _fns = fns
    return _fns


def _scratch(B, nblk, m_pad, device):
    """The wavefront's device buffers, made anew for every launch (with
    nblk = ceil(n_pad / c_blk) column blocks):

      edges  (B, nblk, 4, m_pad + 1) float32: each block's four edge states
             (its last column) of rows 0..m_pad, read by the next block
      flags  (1 + B * (nblk + 1),) int32, zeroed: the ticket counter, then
             per pair nblk progress counters (rows of the edge published)
             and one done counter (blocks finished)
      cand   (B, nblk, 4) int32: each block's start-info candidate (score
             bits, a, b), merged by the pair's last block to finish
    """
    edges = torch.empty((B, nblk, 4, m_pad + 1), dtype=torch.float32,
                        device=device)
    flags = torch.zeros(1 + B * (nblk + 1), dtype=torch.int32, device=device)
    cand = torch.empty((B, nblk, 4), dtype=torch.int32, device=device)
    return edges, flags, cand


def _check_scratch(edges, flags, cand, B, nblk, m_pad):
    """Raise unless the buffers have ``_scratch``'s shapes and types: the
    kernels index them from B, nblk and m_pad alone."""
    if B * nblk > scan.INT32_MAX:
        raise ValueError(f"{B} pairs x {nblk} column blocks is past the "
                         f"int32 ticket counter")
    want = ((edges, (B, nblk, 4, m_pad + 1), torch.float32),
            (flags, (1 + B * (nblk + 1),), torch.int32),
            (cand, (B, nblk, 4), torch.int32))
    for name, (x, shape, dtype) in zip(("edges", "flags", "cand"), want):
        if tuple(x.shape) != shape or x.dtype != dtype or (
                not x.is_contiguous()):
            raise ValueError(f"{name} buffer is {tuple(x.shape)} {x.dtype}; "
                             f"the kernels need a contiguous {shape} {dtype}")


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
    be ragged. Returns (B,) float32, int32 for edit."""
    global plain_calls
    if mode not in MODES:
        raise ValueError(f"unknown score mode {mode!r}")
    if use_jump and (mode != "fit" or allow is None):
        raise ValueError("the jump state exists in fit mode only, and needs "
                         "allow")
    _check_blocks(n_pad, c_blk)
    scan._check(m_pad, n_pad, qs, ts, ns, ms, params, allow)
    if qs.device.type == "cpu":
        plain_calls += 1
        if mode == "fit":
            return scan.fit_scores_plain(use_jump, m_pad, n_pad, qs, ts,
                                         allow, ns, ms, params)
        return scan.scores_plain(mode, m_pad, n_pad, qs, ts, ns, ms, params)
    B, dev = qs.shape[0], qs.device
    out = torch.empty(B, dtype=torch.int32 if mode == "edit"
                      else torch.float32, device=dev)
    threads, wmax = launch_shape(c_blk)
    nblk = -(-n_pad // c_blk)
    scratch = _scratch(B, nblk, m_pad, dev)
    _check_scratch(*scratch, B, nblk, m_pad)
    _launch("blocked_scores", _kernels()[0], (
        MODES.index(mode), int(bool(use_jump)), qs.data_ptr(),
        ts.data_ptr(), 0 if allow is None else allow.data_ptr(),
        ns.data_ptr(), ms.data_ptr(), params.data_ptr(), out.data_ptr(),
        *(x.data_ptr() for x in scratch), B, m_pad, n_pad, c_blk, threads,
        wmax), dev)
    return out


def blocked_ptr_fill(mode, use_jump, m_pad, n_pad, c_blk, qs, ts, allow, ns,
                     ms, params, rows_per_byte=1):
    """Blocked fill with packed pointer emission (the counterpart of the
    JAX ``blocked_ptr_fill``); returns (score, a, b, ptrs) as
    ``ops/ptr.py`` lays them out. Needs m_pad % (8 * rows_per_byte) == 0,
    as the Pallas kernel does; the last column block may be ragged."""
    global plain_calls
    rpb = rows_per_byte
    _check_blocks(n_pad, c_blk)
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
    score = torch.empty(B, dtype=torch.float32, device=dev)
    a = torch.empty(B, dtype=torch.int32, device=dev)
    b = torch.empty(B, dtype=torch.int32, device=dev)
    ptrs = torch.empty((B, m_pad // rpb, n_pad), dtype=torch.uint8,
                       device=dev)
    threads, wmax = launch_shape(c_blk)
    nblk = -(-n_pad // c_blk)
    scratch = _scratch(B, nblk, m_pad, dev)
    _check_scratch(*scratch, B, nblk, m_pad)
    _launch("blocked_ptr", _kernels()[1], (
        ptr.MODES.index(mode), int(bool(use_jump)), rpb, qs.data_ptr(),
        ts.data_ptr(), 0 if allow is None else allow.data_ptr(),
        ns.data_ptr(), ms.data_ptr(), params.data_ptr(), score.data_ptr(),
        a.data_ptr(), b.data_ptr(), ptrs.data_ptr(),
        *(x.data_ptr() for x in scratch), B, m_pad, n_pad, c_blk, threads,
        wmax), dev)
    return score, a, b, ptrs


# a checkpoint's state rows: M, L, U (global, local), fit's J too (-inf
# without the jump), overlap's M
CK_STATES = {"global": 3, "local": 3, "fit": 4, "overlap": 1}


def blocked_ckpt_fill(mode, use_jump, S, m_pad, n_pad, c_blk, qs, ts, allow,
                      ns, ms, params):
    """The checkpoint forward of the pointer fill: returns (score, a, b,
    cks) as the module docstring lays them out. Needs a stride S, a
    positive multiple of 8, that divides m_pad; the last column block may
    be ragged."""
    global plain_calls
    _check_blocks(n_pad, c_blk)
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
    score = torch.empty(B, dtype=torch.float32, device=dev)
    a = torch.empty(B, dtype=torch.int32, device=dev)
    b = torch.empty(B, dtype=torch.int32, device=dev)
    cks = torch.empty((B, m_pad // S, CK_STATES[mode], n_pad + 1),
                      dtype=torch.float32, device=dev)
    threads, wmax = launch_shape(c_blk)
    nblk = -(-n_pad // c_blk)
    scratch = _scratch(B, nblk, m_pad, dev)
    _check_scratch(*scratch, B, nblk, m_pad)
    _launch("blocked_ckpt", _kernels()[2], (
        ptr.MODES.index(mode), int(bool(use_jump)), qs.data_ptr(),
        ts.data_ptr(), 0 if allow is None else allow.data_ptr(),
        ns.data_ptr(), ms.data_ptr(), params.data_ptr(), score.data_ptr(),
        a.data_ptr(), b.data_ptr(), cks.data_ptr(),
        *(x.data_ptr() for x in scratch), B, m_pad, n_pad, c_blk, threads,
        wmax, S), dev)
    return score, a, b, cks


def blocked_refill(mode, use_jump, S, n_pad, c_blk, ck, i0, qs, ts, allow,
                   ns, ms, params, rows_per_byte=1):
    """Rows i0+1 .. i0+S of the pointer fill from ``ck`` (B, states, n_pad
    + 1), the state rows of row i0 (a checkpoint of
    ``blocked_ckpt_fill``); ``qs`` (B, S) holds those rows' query chars.
    Returns the (B, S / rows_per_byte, n_pad) pointer bytes; needs S %
    (8 * rows_per_byte) == 0."""
    global plain_calls
    rpb = rows_per_byte
    _check_blocks(n_pad, c_blk)
    ptr._check(mode, use_jump, S, n_pad, rpb, qs, ts, allow, ns, ms, params)
    if S % (8 * rpb):
        raise ValueError(f"stride {S} is not a multiple of 8 * "
                         f"rows_per_byte {rpb}")
    B = qs.shape[0]
    scan.check_tensors([("ck", ck, torch.float32,
                         (B, CK_STATES[mode], n_pad + 1))], qs.device)
    if not 0 <= i0 <= scan.INT32_MAX:
        raise ValueError(f"row {i0} is not a row of an int32 fill")
    if qs.device.type == "cpu":
        plain_calls += 1
        return ptr.ptr_fill_plain(mode, use_jump, S, n_pad, qs, ts, allow,
                                  ns, ms, params, rpb, seed=ck, i0=i0)
    dev = qs.device
    ptrs = torch.empty((B, S // rpb, n_pad), dtype=torch.uint8, device=dev)
    threads, wmax = launch_shape(c_blk)
    nblk = -(-n_pad // c_blk)
    scratch = _scratch(B, nblk, S, dev)
    _check_scratch(*scratch, B, nblk, S)
    _launch("blocked_refill", _kernels()[3], (
        ptr.MODES.index(mode), int(bool(use_jump)), rpb, qs.data_ptr(),
        ts.data_ptr(), 0 if allow is None else allow.data_ptr(),
        ns.data_ptr(), ms.data_ptr(), params.data_ptr(), ck.data_ptr(),
        i0, ptrs.data_ptr(), *(x.data_ptr() for x in scratch), B, S, n_pad,
        c_blk, threads, wmax), dev)
    return ptrs
