"""Batched traceback walk on the device: every pair's pointers, in parallel.

Counterpart of ``aligntools_tpu/engine/device_tb.py``: ``_walk_affine``
(global / local / fit) and ``_walk_overlap``, the flush-wave collection
``walk_scalars_many`` / ``walk_rows_many`` and the host assembly
``_assemble``, for the pointer fill's (B, m_pad/rpb, n_pad) tensor
(columns 1..n_pad; ``ops/ptr.py``).

``walk`` returns, per bucket,

  cols1, cols2  (n_steps, B) uint8, n_steps = m_pad + n_pad + 1: the
                (query, target) column each pair emits at each step, in
                walk order; 0 past a pair's walk
  scal          (4, B) int32: emitted length, final i, final j, error flag

On a CUDA tensor it launches ``csrc/walk.cu`` (one thread per pair, each
walking to its own end) or raises; on a CPU tensor it runs ``walk_plain``,
which steps all pairs together until none is active. The semantics are the
JAX walks', step for step: local's HOME step emits its column and then
stops, an unset pointer flags ``err`` (global and fit; overlap also flags
a walk that reaches row 0 before column 0, and leaves that step out of the
count), an inactive pair keeps its state, and out-of-range indices clamp
as a JAX gather does.

Scalars stay int32 (the JAX package folds them into one float32 stack,
which would round past 2^24); a bucket's float32 scores ride along as
their int32 bit pattern, so one device-to-host copy carries both exactly.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from aligntools_tpu_torch import layout as L
from aligntools_tpu_torch.ops.scan import check_tensors

# walk states (the JAX walk's, and native/aligntools_native.cpp's)
LOW, MID, UPP, JUMP, DONE, ERR = 0, 1, 2, 3, 4, 5
GAP = ord("-")
MODES = ("global", "local", "fit", "overlap")

launches = 0
plain_calls = 0


def reset_counts() -> None:
    global launches, plain_calls
    launches = plain_calls = 0


def walk_starts(mode, score, a, b, ms, ns):
    """(3, B) int32 walk starts (state, i, j) from the fill's outputs, on
    the fill's device with no host sync: global (a, m, n), local
    (MID, a, b), fit (LOW if a else MID, m, b), overlap (0, m, a)."""
    m, n = ms[:, 0], ns[:, 0]
    if mode == "global":
        rows = (a, m, n)
    elif mode == "local":
        rows = (torch.full_like(a, MID), a, b)
    elif mode == "fit":
        rows = (torch.where(a != 0, LOW, MID).to(torch.int32), m, b)
    else:
        rows = (torch.zeros_like(a), m, a)
    return torch.stack(rows)


def _gather(ptrs, bidx, row, jc):
    """One pointer byte per pair, indices clamped as a JAX gather clamps."""
    R, C = ptrs.shape[1], ptrs.shape[2]
    return ptrs[bidx, row.clamp(0, R - 1), jc.clamp(0, C - 1)].to(torch.int32)


def _chars(plane, bidx, idx):
    return plane[bidx, idx.clamp(0, plane.shape[1] - 1)].to(torch.uint8)


def walk_plain(mode, rpb, ptrs, qs, ts, starts):
    """Plain version of ``walk`` (any device)."""
    global plain_calls
    plain_calls += 1
    B, m_pad, n_pad = qs.shape[0], qs.shape[1], ts.shape[1]
    dev = qs.device
    n_steps = m_pad + n_pad + 1
    bidx = torch.arange(B, device=dev)
    state, i, j = (s.clone() for s in starts)
    cols1 = torch.zeros((n_steps, B), dtype=torch.uint8, device=dev)
    cols2 = torch.zeros_like(cols1)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    err = torch.zeros(B, dtype=torch.bool, device=dev)
    gap = torch.tensor(GAP, dtype=torch.uint8, device=dev)
    nul = torch.zeros((), dtype=torch.uint8, device=dev)
    overlap = mode == "overlap"
    done = j <= 0
    for k in range(n_steps):
        if overlap:
            active = ~done & (j > 0)
        else:
            active = (state < DONE) & (i > 0)
            if mode != "fit":
                active &= j > 0
        if not bool(active.any()):
            break
        row = torch.clamp_min(i - 1, 0)
        jc = torch.clamp_min(j - 1, 0)
        if overlap:
            byte = _gather(ptrs, bidx, row // rpb, jc)
            code = (byte >> ((row % rpb) * (8 // rpb))) & 0x3
            bad = active & ((code == L.OV_UNSET) | (i <= 0))
            takes_q = code != L.OV_LEFT  # DIAG and RIGHT consume a query char
            takes_t = code != L.OV_RIGHT  # LEFT and DIAG consume a target char
        else:
            if rpb == 2:
                byte = _gather(ptrs, bidx, row >> 1, jc)
                byte = torch.where((row & 1) != 0, byte >> 4, byte) & 0xF
                code = byte & 0x3
                nxt_mid = torch.where(code == L.PK2_CODE3,
                                      DONE if mode == "local" else ERR, code)
                l_is_mid = (byte & L.PK2_L_IS_MID) != 0
                u_is_upp = (byte & L.PK2_U_IS_UPP) != 0
            else:
                byte = _gather(ptrs, bidx, row, jc)
                code = byte & 0x7
                nxt_mid = torch.where(code == L.PK_UNSET, ERR,
                                      torch.where(code <= 3, code, DONE))
                l_is_mid = (byte & L.PK_L_IS_MID) != 0
                u_is_upp = (byte & L.PK_U_IS_UPP) != 0
            j_is_jump = (byte & L.PK_J_IS_JUMP) != 0
            nxt = torch.where(
                state == MID, nxt_mid,
                torch.where(state == LOW, torch.where(l_is_mid, MID, LOW),
                            torch.where(state == UPP,
                                        torch.where(u_is_upp, UPP, MID),
                                        torch.where(j_is_jump, JUMP, MID))))
            takes_q = (state == LOW) | (state == MID)
            takes_t = state != LOW
        ni = torch.where(active & takes_q, i - 1, i)
        nj = torch.where(active & takes_t, j - 1, j)
        c1 = torch.where(takes_q, _chars(qs, bidx, ni), gap)
        c2 = torch.where(takes_t, _chars(ts, bidx, nj), gap)
        cols1[k] = torch.where(active, c1, nul)
        cols2[k] = torch.where(active, c2, nul)
        if overlap:
            err |= bad
            done |= bad | (nj == 0)
            count += (active & ~bad).to(torch.int32)
        else:
            err |= active & (nxt == ERR)
            state = torch.where(active, nxt, state)
            count += active.to(torch.int32)
        i, j = ni, nj
    scal = torch.stack([count, i.to(torch.int32), j.to(torch.int32),
                        err.to(torch.int32)])
    return cols1, cols2, scal


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_fn = None
THREADS = 128  # pairs per CTA


def _kernel():
    global _fn
    if _fn is None:
        from aligntools_tpu_torch.ops import _build

        fn = _build.load().at_walk
        P, I = ctypes.c_void_p, ctypes.c_int
        # mode, rpb, ptrs, qs, ts, starts, cols1, cols2, scal, B, m_pad,
        # n_pad, rows, threads, stream
        fn.argtypes = [I, I, P, P, P, P, P, P, P, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(mode, rpb, ptrs, qs, ts, starts):
    if mode not in MODES:
        raise ValueError(f"unknown walk mode {mode!r}")
    B, m_pad = qs.shape if qs.dim() == 2 else (-1, -1)
    n_pad = ts.shape[1] if ts.dim() == 2 else -1
    if rpb not in (1, 2, 4) or m_pad % rpb or (rpb == 4 and mode != "overlap"):
        raise ValueError(f"rows_per_byte {rpb} is not a {mode} layout for "
                         f"m_pad {m_pad}")
    check_tensors([("ptrs", ptrs, torch.uint8, (B, m_pad // rpb, n_pad)),
                   ("qs", qs, torch.int32, (B, m_pad)),
                   ("ts", ts, torch.int32, (B, n_pad)),
                   ("starts", starts, torch.int32, (3, B))], qs.device)


def walk(mode, rpb, ptrs, qs, ts, starts):
    """Walk every pair of a bucket from ``starts`` ((3, B) int32 state, i,
    j); returns (cols1, cols2, scal) as the module docstring lays them out.
    ``qs``/``ts`` are the fill's int32 sentinel char planes."""
    starts = starts.contiguous()
    _check(mode, rpb, ptrs, qs, ts, starts)
    if qs.device.type == "cpu":
        return walk_plain(mode, rpb, ptrs, qs, ts, starts)
    global launches
    B, m_pad = qs.shape
    n_pad = ts.shape[1]
    n_steps = m_pad + n_pad + 1
    cols1 = torch.zeros((n_steps, B), dtype=torch.uint8, device=qs.device)
    cols2 = torch.zeros_like(cols1)
    scal = torch.empty((4, B), dtype=torch.int32, device=qs.device)
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        err = _kernel()(MODES.index(mode), rpb, ptrs.data_ptr(),
                        qs.data_ptr(), ts.data_ptr(), starts.data_ptr(),
                        cols1.data_ptr(), cols2.data_ptr(), scal.data_ptr(),
                        B, m_pad, n_pad, ptrs.shape[1], THREADS, stream)
    if err != 0:
        raise RuntimeError(f"walk kernel launch failed: CUDA error {err}")
    launches += 1
    return cols1, cols2, scal


# ---------------------------------------------------------------------------
# Collection: two device-to-host copies per flush wave
# ---------------------------------------------------------------------------


def walk_scalars_many(scals):
    """Each bucket's (k, B) int32 scalar block, pulled in ONE copy for the
    whole wave (it also waits for the wave's fills and walks)."""
    if not scals:
        return []
    flat = torch.cat([s.reshape(-1) for s in scals]).cpu().numpy()
    out, off = [], 0
    for s in scals:
        out.append(flat[off : off + s.numel()].reshape(s.shape))
        off += s.numel()
    return out


def walk_rows_many(mode, cols_list, scalars_list, pairs_list):
    """The walked columns of every bucket of a wave in ONE copy, each
    bucket's sliced to its longest walk; then the host assembly.
    ``cols_list``: each bucket's (cols1, cols2); ``scalars_list``: the
    pulled (4+, B) blocks; ``pairs_list``: each bucket's true (q, t)
    pairs."""
    parts, lens = [], []
    for (c1, c2), sc in zip(cols_list, scalars_list):
        ln = int(sc[0].max()) if sc.shape[1] else 0
        lens.append(ln)
        parts += [c1[:ln].reshape(-1), c2[:ln].reshape(-1)]
    flat = (torch.cat(parts).cpu().numpy() if parts
            else np.zeros(0, np.uint8))
    out, off = [], 0
    for (c1, _), sc, pairs, ln in zip(cols_list, scalars_list, pairs_list,
                                      lens):
        B = c1.shape[1]
        both = flat[off : off + 2 * ln * B].reshape(2, ln, B)
        off += 2 * ln * B
        out.append(assemble(mode, both[0], both[1], sc, pairs))
    return out


def assemble(mode, cols1, cols2, scal, pairs):
    """Host row assembly from pulled walk columns: reverse, trim to each
    pair's walk length; global's unconsumed prefix is padded with gaps
    (alignment.h:398-407)."""
    count, fi, fj, err = scal[0], scal[1], scal[2], scal[3]
    out = []
    for b, (q, t) in enumerate(pairs):
        if err[b]:
            raise RuntimeError(
                f"traceback hit unset pointer (reference UB) in pair {b}")
        ln = int(count[b])
        r1 = cols1[:ln, b][::-1].tobytes()
        r2 = cols2[:ln, b][::-1].tobytes()
        if mode == "global":
            i, j = int(fi[b]), int(fj[b])
            r1 = q[:i] + b"-" * j + r1
            r2 = b"-" * i + t[:j] + r2
        out.append((r1, r2))
    return out
