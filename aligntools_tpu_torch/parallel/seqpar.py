"""Sequence parallelism: one pair's TARGET split across ranks by columns.

Port of ``aligntools_tpu/parallel/seqpar.py`` onto torch.distributed and
the port's own kernels. Rank d of the mesh's ``seq`` axis holds global
target columns col0_d+1 .. col0_d+n_loc (col0_d = d * n_loc; n_loc a
multiple of 16, the blocked kernels' rule), and the ranks run a wavefront
over chunks of R query rows: rank d receives the left edge of chunk k
(the states at its column col0_d, rows i0+1 .. i0+R) from rank d-1,
fills the chunk over its columns in one launch of the EDGE phase of the
blocked fills (``ops/blocked.edge_scores`` / ``edge_ptr_fill``: row i0
from a state buffer, the left edge from a tensor, the right edge to a
tensor, every chain continued by global column), and sends its right edge
to rank d+1. So rank d runs chunk k while rank d-1 runs chunk k+1. Under
NCCL the edges are ``send``/``recv`` of CUDA tensors, ordered on the
stream; under gloo they go through host memory. The JAX package instead
exchanges a few scalars a row (``ppermute``, ``all_gather``) under
``shard_map``; the chunked exchange is the same function, computed in the
blocked kernels' own order, so scores and rows are bit-equal to the
single-device route.

  seqpar_score         one pair's score (edit an int): after the last
                       chunk the ranks' candidates merge in rank order by
                       the blocks' rules, on every rank;
  seqpar_batch_scores  ``data`` x ``seq``: the pairs in contiguous equal
                       shards over ``data`` (default mesh (2, world / 2),
                       the JAX default), each EDGE launch over the rank's
                       pairs at once; float64 (edit int64), on every rank;
  seqpar_align         one pair's alignment: the pointer slabs stay on
                       their ranks; the start info merges across ranks with
                       the reference's tie-breaks; the walk starts on the
                       rank that holds the start column and hands its (i,
                       j, state) leftwards (the walk's column pause), and
                       the rows are assembled from the segments.

Ranks whose columns all lie past the last target column take no part in
the wavefront. A pair past float32's exact integers is refused, as
``batch`` refuses it; a pair with an empty side gets the single-device
route's result (``batch._empty_result``). A slab past the pointer budget
(``batch._hbm_budget``) raises: there is no rescan here, as in the JAX
package.

``loopback=D`` runs D column slices in this process, one after another,
through the same phases with no process group (the CPU tests' way; on the
CPU the EDGE functions are the plain versions).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aligntools_tpu_torch import layout as L
from aligntools_tpu_torch.engine import device_tb
from aligntools_tpu_torch.ops import blocked, ptr, scan
from aligntools_tpu_torch.params import AlignParams, AlignResult

NEG = float("-inf")
NEG_BITS = int(np.float32(NEG).view(np.int32))  # -inf's float32 bits
INT32_MAX = 2**31 - 1
CHUNK_MIN = 256  # query rows a chunk, at least
RAMP_SHARE = 10  # a chunk is at least this many times the ramp's rows


def slice_width(n: int, D: int) -> int:
    """n_loc: the columns of each of D ranks, a multiple of 16."""
    return max(16, -(-max(1, -(-n // D)) // 16) * 16)


def edge_c_blk(n_loc: int) -> int:
    """The column block of a rank's EDGE launches: the blocked fills' own
    (``engine/select.blocked_c_blk``), at most the slice."""
    from aligntools_tpu_torch.engine import select

    return min(select.blocked_c_blk(), n_loc)


def chunk_rows(n_loc: int, c_blk: int) -> int:
    """The default chunk of R query rows: the ramp of a launch (its column
    blocks start about a row apart) stays under a tenth of R; a multiple of
    32, so that every pointer layout packs whole bytes."""
    ramp = -(-n_loc // c_blk)
    return max(CHUNK_MIN, -(-(RAMP_SHARE * ramp) // 32) * 32)


@dataclasses.dataclass
class _Job:
    """What every rank of a seq line knows of the work: a batch of pairs
    laid out for the EDGE launches."""

    mode: str
    use_jump: bool
    D: int  # ranks of the seq axis
    n_loc: int
    c_blk: int
    R: int  # rows a chunk
    rows: int  # rows to fill (pointer fills: m_pad)
    active: int  # ranks that hold a column <= the widest n
    qs: torch.Tensor  # (B, rows) int32, pad -1
    t_all: torch.Tensor  # (B, D * n_loc) int32, pad -2
    allow_all: torch.Tensor | None  # (B, D * n_loc) float32
    ns: torch.Tensor  # (B, 1) int32
    ms: torch.Tensor
    params: torch.Tensor  # (1, 8) float32
    o: float
    e: float
    device: torch.device

    def slice(self, d):
        """Rank d's (col0, ts, allow) on the device."""
        c0 = d * self.n_loc
        cut = slice(c0, c0 + self.n_loc)
        allow = (self.allow_all[:, cut].contiguous() if self.use_jump
                 else None)
        return c0, self.t_all[:, cut].contiguous(), allow


def _job(mode, pairs, params, sites_list, D, device, rows=None, chunk=None):
    from aligntools_tpu_torch.convert import params_matrix

    use_jump = sites_list is not None and mode == "fit"
    B = len(pairs)
    n_max = max(len(t) for _, t in pairs)
    m_max = max(len(q) for q, _ in pairs)
    n_loc = slice_width(n_max, D)
    c_blk = edge_c_blk(n_loc)
    R = chunk or chunk_rows(n_loc, c_blk)
    rows = m_max if rows is None else rows
    qs = np.full((B, max(rows, 1)), -1, np.int32)
    t_all = np.full((B, D * n_loc), -2, np.int32)
    allow = np.ones((B, D * n_loc), np.float32) if use_jump else None
    for k, (q, t) in enumerate(pairs):
        qs[k, : len(q)] = np.frombuffer(q, np.uint8)
        t_all[k, : len(t)] = np.frombuffer(t, np.uint8)
        if use_jump and sites_list[k]:
            s = [x for x in sites_list[k] if 0 <= x < D * n_loc]
            allow[k, s] = 0.0
    ns = torch.tensor([[len(t)] for _, t in pairs], dtype=torch.int32)
    ms = torch.tensor([[len(q)] for q, _ in pairs], dtype=torch.int32)
    put = lambda a: None if a is None else torch.from_numpy(a).to(device)
    return _Job(mode, use_jump, D, n_loc, c_blk, R, rows,
                min(D, -(-n_max // n_loc)), put(qs), put(t_all), put(allow),
                ns.to(device), ms.to(device),
                params_matrix(params, device), float(params.gap_open),
                float(params.gap_extend), device)


def _chunks(job):
    return [(i0, min(job.R, job.rows - i0)) for i0 in range(0, job.rows,
                                                             job.R)]


def _left_edge(job, kind, col0, i0, Rk, rows, corner):
    """Chunk (i0, Rk)'s left edge (B, states, Rk+1): rank 0's analytic
    border; else row 0 (the left rank's row i0, kept from the last chunk,
    or row 0 analytic) and the left rank's rows i0+1 .. i0+Rk."""
    B = job.qs.shape[0]
    if col0 == 0 or i0 == 0:
        edge = scan.edge_analytic(job.mode, job.use_jump, kind, i0,
                                  Rk if col0 == 0 else 0, col0, B, job.o,
                                  job.e, job.device)
        if col0 == 0:
            return edge
        corner = edge[:, :, 0]
    edge = torch.empty((B, rows.shape[1], Rk + 1), dtype=rows.dtype,
                       device=job.device)
    edge[:, :, 0] = corner
    edge[:, :, 1:] = rows
    return edge


def _fill_rank(job, d, kind, recv, send, slab=None, rpb=1):
    """Every chunk of rank d (d < job.active): the left edges from
    ``recv(k)`` (rank d > 0), the right edges to ``send(k, redge)``.
    Returns the rank's candidate: scores (B,) float32 (edit int32), or
    the pointer fill's (B, 4) int32 with ``slab`` filled."""
    col0, ts, allow = job.slice(d)
    B, mode = job.qs.shape[0], job.mode
    top = scan.top_analytic(mode, kind, col0, job.n_loc, B, job.o, job.e,
                            job.device)
    if kind == "scores":
        acc = torch.full((B,), INT32_MAX if mode == "edit" else NEG,
                         dtype=scan.edge_dtype(mode), device=job.device)
    else:
        acc = torch.zeros((B, 4), dtype=torch.int32, device=job.device)
        acc[:, 0] = NEG_BITS
    corner = None
    for k, (i0, Rk) in enumerate(_chunks(job)):
        rows = recv(k) if col0 > 0 else None
        ledge = _left_edge(job, kind, col0, i0, Rk, rows, corner)
        if rows is not None:
            corner = rows[:, :, -1]
        qk = job.qs[:, i0 : i0 + Rk].contiguous()
        if kind == "scores":
            top, redge = blocked.edge_scores(
                mode, job.use_jump, col0, i0, job.c_blk, qk, ts, allow,
                job.ns, job.ms, job.params, top, ledge, acc)
        else:
            top, redge = blocked.edge_ptr_fill(
                mode, job.use_jump, col0, i0, job.c_blk, qk, ts, allow,
                job.ns, job.ms, job.params, top, ledge, acc, slab, rpb)
        if d + 1 < job.active:
            send(k, redge)
    return acc


def _finish_scores(mode, accs, pairs, params):
    """The ranks' (B,) candidates, in rank order, merged: the maximum (edit
    the minimum), with local's + 0 and overlap's j = 0 zero; pairs with an
    empty side take ``batch._empty_result``."""
    from aligntools_tpu_torch.batch import _empty_result

    x = torch.stack([a.cpu() for a in accs])
    v = (x.amin(dim=0) if mode == "edit" else x.amax(dim=0)).numpy()
    out = []
    for k, (q, t) in enumerate(pairs):
        if not q or not t:
            r = _empty_result(mode, q, t, params, False)
            out.append(r if mode == "edit" else r.score)
        elif mode == "edit":
            out.append(int(v[k]))
        elif mode == "overlap":
            out.append(float(max(v[k], np.float32(0.0))) + 0.0)
        elif mode == "local":
            out.append(float(v[k]) + 0.0)
        else:
            out.append(float(v[k]))
    return out


def _merge_start(mode, cands, n, n_loc):
    """The ranks' (4,) int32 start candidates (score bits, a, b, 0), in
    rank order, merged as the blocks' are: global the rank that holds
    column n; local a greater score, or an equal one at a smaller row;
    fit rank 0's, then a greater score, or an equal one from M where the
    kept one is from L, or from the same matrix at a smaller j; overlap
    the first greatest, then the j = 0 zero candidate. Returns (score, a,
    b)."""
    rows = [(float(np.int32(c[0]).view(np.float32)), int(c[1]), int(c[2]))
            for c in cands]
    if mode == "global":
        return rows[(n - 1) // n_loc]
    s, a, b = rows[0]
    for fs, fa, fb in rows[1:]:
        if mode == "local":
            take = fs > s or (fs == s and fa < a)
        elif mode == "fit":
            take = fs > s or (fs == s and (fa < a or (fa == a and fb < b)))
        else:
            take = fs > s
        if take:
            s, a, b = fs, fa, fb
    if mode == "overlap":
        s, a = (s, a) if s > 0.0 else (0.0, 0)
    return s, a, b


def _walk_segment(job, d, slab, rpb, cur):
    """Rank d's part of the walk from ``cur`` (state, i, j): its (cols1,
    cols2) bytes in walk order and (count, i, j, err, state)."""
    col0, ts, _ = job.slice(d)
    starts = torch.tensor([[cur[0]], [cur[1]], [cur[2]]], dtype=torch.int32,
                          device=job.device)
    c1, c2, scal = device_tb.walk(job.mode, rpb, slab, job.qs, ts, starts,
                                  col0=col0)
    sc = scal[:, 0].cpu().tolist()
    if len(sc) == 4:  # rank 0's walk ends there
        sc.append(device_tb.DONE)
    n = sc[0]
    return (c1[:n, 0].cpu().numpy().tobytes(),
            c2[:n, 0].cpu().numpy().tobytes()), sc


def _resumes(mode, sc, d, col0):
    """Whether the walk goes on on rank d-1 after rank d's segment."""
    count, i, j, err, state = sc
    if err or d == 0 or j != col0:
        return False
    if mode == "overlap":
        return state != device_tb.DONE
    return state < device_tb.DONE and i > 0


def _assemble(mode, q, t, segs, sc):
    """The rows from the walk's segments, in walk order, and its last
    scalars (count, i, j, err): ``device_tb.assemble``'s."""
    cols = [np.frombuffer(b"".join(s[k] for s in segs), np.uint8)[:, None]
            for k in (0, 1)]
    scal = np.array([[len(cols[0])], [sc[1]], [sc[2]], [sc[3]]])
    return device_tb.assemble(mode, *cols, scal, [(q, t)])[0]


# ---------------------------------------------------------------------------
# The transports: in-process, and torch.distributed
# ---------------------------------------------------------------------------


class _Loopback:
    """D column slices in this process: rank d runs after rank d-1, its
    left edges the ones d-1 left."""

    def __init__(self, D):
        self.D = D
        self.edges = {}

    def fill(self, job, kind, slabs=None, rpb=1):
        accs = []
        for d in range(self.D):
            if d >= job.active:
                accs.append(None)
                continue
            accs.append(_fill_rank(
                job, d, kind, lambda k, d=d: self.edges.pop((d - 1, k)),
                lambda k, e, d=d: self.edges.__setitem__((d, k), e),
                None if slabs is None else slabs[d], rpb))
        return accs


class _Dist:
    """This rank of the mesh's seq line."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.D = mesh.shape["seq"]
        self.d = mesh.coords["seq"]
        self.ranks = mesh.ranks["seq"]
        self.group = mesh.groups["seq"]

    def _pinned(self):
        """gloo on the card: the edges cross through pinned host memory."""
        return self.mesh.backend == "gloo" and self.mesh.device.type == "cuda"

    def _to_comm(self, x):
        if self._pinned():
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return host.copy_(x)
        return x.contiguous().to(self.mesh.comm_device())

    def recv(self, shape, dtype):
        import torch.distributed as dist

        buf = torch.empty(shape, dtype=dtype, device=self.mesh.comm_device(),
                          pin_memory=self._pinned())
        dist.recv(buf, src=self.ranks[self.d - 1])
        return buf.to(self.mesh.device, non_blocking=True)

    def send(self, x):
        import torch.distributed as dist

        dist.send(self._to_comm(x), dst=self.ranks[self.d + 1])

    def gather(self, x):
        """Every rank's tensor of x's shape, in rank order (a list)."""
        from aligntools_tpu_torch.parallel.mesh import all_gather_rows

        out = all_gather_rows(self.mesh, "seq", x[None])
        return [out[k].to(x.device) for k in range(self.D)]

    def bcast(self, x, d):
        import torch.distributed as dist

        y = self._to_comm(x)
        if self.D > 1:
            dist.broadcast(y, src=self.ranks[d], group=self.group)
        return y.to(x.device)

    def fill(self, job, kind, slab=None, rpb=1):
        if self.d >= job.active:
            return None
        B, value = job.qs.shape[0], (scan.edge_dtype(job.mode)
                                    if kind == "scores" else torch.float32)
        n_st = (scan.edge_states(job.mode, job.use_jump) if kind == "scores"
                else ptr.edge_states(job.mode, job.use_jump))
        sizes = dict(enumerate(Rk for _, Rk in _chunks(job)))
        return _fill_rank(
            job, self.d, kind,
            lambda k: self.recv((B, n_st, sizes[k]), value),
            lambda k, e: self.send(e), slab, rpb)


def _seq_mesh(mesh, device, loopback):
    if loopback is not None:
        if mesh is not None:
            raise ValueError("pass a mesh or loopback, not both")
        return None, _Loopback(int(loopback))
    if mesh is None:
        from aligntools_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(axis="seq", device=device)
    return mesh, _Dist(mesh)


def _refuse(mode, pairs, params):
    from aligntools_tpu_torch.exact import check_f32_exact

    if mode not in ("global", "local", "fit", "overlap", "edit"):
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "fit" and any(len(q) > len(t) for q, t in pairs):
        raise ValueError("first sequence must be shorter than the second")
    if pairs:
        q, t = max(pairs, key=lambda pr: len(pr[0]) + len(pr[1]))
        check_f32_exact(params, len(q), len(t), mode)


def _scores(mode, pairs, params, sites_list, comm, device, chunk):
    """The merged scores of ``pairs`` over the comm's seq ranks."""
    live = [k for k, (q, t) in enumerate(pairs) if q and t]
    accs = []
    if live:
        sub = [pairs[k] for k in live]
        sl = None if sites_list is None else [sites_list[k] for k in live]
        job = _job(mode, sub, params, sl, comm.D, device, chunk=chunk)
        if isinstance(comm, _Loopback):
            accs = [a for a in comm.fill(job, "scores") if a is not None]
        else:
            acc = comm.fill(job, "scores")
            if acc is None:  # a rank past every target: the merge's unit
                acc = torch.full((len(live),), INT32_MAX if mode == "edit"
                                 else NEG, dtype=scan.edge_dtype(mode),
                                 device=device)
            accs = comm.gather(acc)
    full = [torch.full((len(pairs),), INT32_MAX if mode == "edit" else NEG,
                       dtype=scan.edge_dtype(mode)) for _ in accs or [0]]
    for f, a in zip(full, accs):
        f[live] = a.cpu()
    return _finish_scores(mode, full, pairs, params)


def seqpar_score(mode: str, q: bytes, t: bytes,
                 params: AlignParams = AlignParams(), sites=None, mesh=None,
                 *, device="cuda", loopback: int | None = None,
                 chunk: int | None = None):
    """Score one pair with its target split over the mesh's ``seq`` ranks
    (a one-axis ``seq`` mesh over the group by default). Bit-equal to the
    single-device route; an int for edit, else a float, on every rank.
    ``chunk``: rows a chunk (default ``chunk_rows``)."""
    _refuse(mode, [(q, t)], params)
    mesh, comm = _seq_mesh(mesh, device, loopback)
    dev = torch.device(device) if mesh is None else mesh.device
    sl = None if sites is None else [sites]
    return _scores(mode, [(q, t)], params, sl, comm, dev, chunk)[0]


def seqpar_batch_scores(mode: str, pairs, params: AlignParams = AlignParams(),
                        sites_list=None, mesh=None, *, device="cuda",
                        loopback: tuple[int, int] | None = None,
                        chunk: int | None = None) -> np.ndarray:
    """Batch scores over BOTH axes: contiguous equal shards of the pairs
    over ``data``, every pair's target over ``seq`` (default mesh (2, world
    / 2)). float64 (edit int64), on every rank; ``loopback=(data, seq)``
    runs in this process."""
    _refuse(mode, pairs, params)
    B = len(pairs)
    dt = np.int64 if mode == "edit" else np.float64
    if B == 0:
        return np.zeros(0, dt)
    if loopback is not None:
        d_data, d_seq = loopback
        per = -(-B // d_data)
        out = []
        for k in range(d_data):
            shard = list(pairs[k * per : (k + 1) * per])
            sl = (None if sites_list is None
                  else list(sites_list[k * per : (k + 1) * per]))
            if shard:
                out += _scores(mode, shard, params, sl, _Loopback(d_seq),
                               torch.device(device), chunk)
        return np.asarray(out, dt)
    from aligntools_tpu_torch.parallel.mesh import all_gather_rows, make_mesh

    if mesh is None:
        mesh = make_mesh(axis=("data", "seq"), device=device)
    per = -(-B // mesh.shape["data"])
    lo = min(B, mesh.coords["data"] * per)
    hi = min(B, lo + per)
    local = np.zeros(per, dt)
    if hi > lo:
        sl = None if sites_list is None else list(sites_list[lo:hi])
        local[: hi - lo] = _scores(mode, list(pairs[lo:hi]), params, sl,
                                   _Dist(mesh), mesh.device, chunk)
    x = torch.from_numpy(local).to(torch.int64 if mode == "edit"
                                   else torch.float64)
    return all_gather_rows(mesh, "data", x).cpu().numpy()[:B]


def seqpar_align(mode: str, q: bytes, t: bytes,
                 params: AlignParams = AlignParams(), sites=None, mesh=None,
                 *, device="cuda", loopback: int | None = None,
                 chunk: int | None = None) -> AlignResult:
    """Full alignment of one pair with its target split over the mesh's
    ``seq`` ranks: each rank's pointer slab stays on its rank, the start
    info merges across ranks, and the walk runs from the rank that holds
    the start column leftwards. Rows byte-equal to the single-device
    route's; the same AlignResult on every rank."""
    from aligntools_tpu_torch.batch import (PTR_BUDGET_FRAC, _empty_result,
                                            _hbm_budget)

    if mode == "edit":
        raise ValueError("edit mode has no traceback (alignment.h:291-315)")
    _refuse(mode, [(q, t)], params)
    m, n = len(q), len(t)
    if not q or not t:
        if mode == "fit" and not t:
            raise RuntimeError("fit: no finite traceback start (reference UB)")
        return _empty_result(mode, q, t, params, True)
    mesh, comm = _seq_mesh(mesh, device, loopback)
    dev = torch.device(device) if mesh is None else mesh.device
    use_jump = sites is not None and mode == "fit"
    m_pad = -(-m // 32) * 32
    rpb = L.rows_per_byte(mode, use_jump, m_pad)
    job = _job(mode, [(q, t)], params, [sites] if use_jump else None,
               comm.D, dev, rows=m_pad, chunk=chunk)
    if job.R % 32:
        raise ValueError(f"a chunk of {job.R} rows: the pointer fills need a "
                         f"multiple of 32")
    slab_bytes = m_pad // rpb * job.n_loc
    if slab_bytes > _hbm_budget(dev) * PTR_BUDGET_FRAC:
        raise RuntimeError(
            f"one rank's pointer slab ({slab_bytes} bytes) is past the "
            f"device budget; sequence parallelism has no rescan")

    def new_slab():
        return torch.empty((1, m_pad // rpb, job.n_loc), dtype=torch.uint8,
                           device=dev)

    if isinstance(comm, _Loopback):
        slabs = [new_slab() if d < job.active else None
                 for d in range(comm.D)]
        cands = comm.fill(job, "ptr", slabs, rpb)
        cands = [c[0] for c in cands if c is not None]
    else:
        slab = new_slab() if comm.d < job.active else None
        cand = comm.fill(job, "ptr", slab, rpb)
        if cand is None:
            cand = torch.zeros((1, 4), dtype=torch.int32, device=dev)
            cand[0, 0] = NEG_BITS
        cands = comm.gather(cand[0])
    cands = [c.cpu().numpy() for c in cands]
    score, a, b = _merge_start(mode, cands, n, job.n_loc)
    if mode == "fit" and not np.isfinite(score):
        raise RuntimeError("fit: no finite traceback start (reference UB)")
    cur = tuple(device_tb.walk_starts(
        mode, torch.tensor([score]), torch.tensor([a]), torch.tensor([b]),
        torch.tensor([[m]]), torch.tensor([[n]]))[:, 0].tolist())
    segs, sc = [], [0, cur[1], cur[2], 0, cur[0]]
    d = (cur[2] - 1) // job.n_loc if cur[2] > 0 else -1
    while d >= 0:
        if isinstance(comm, _Loopback):
            seg, sc = _walk_segment(job, d, slabs[d], rpb, cur)
        else:
            seg, out = (b"", b""), torch.zeros(5, dtype=torch.int64)
            if comm.d == d:
                seg, sc = _walk_segment(job, d, slab, rpb, cur)
                out = torch.tensor(sc, dtype=torch.int64)
            sc = comm.bcast(out.to(dev), d).cpu().tolist()
        segs.append((d, seg))
        if not _resumes(mode, sc, d, d * job.n_loc):
            break
        cur = (sc[4], sc[1], sc[2])
        d -= 1
    if not isinstance(comm, _Loopback):
        segs = _gather_segments(comm, segs, dev)
    r1, r2 = _assemble(mode, q, t, [s for _, s in segs], sc)
    return AlignResult(score, r1, r2)


def _gather_segments(comm, segs, dev):
    """Every rank's walk segment (its own, empty elsewhere), on every
    rank, in the walk's order."""
    mine = next((s for d, s in segs if d == comm.d), (b"", b""))
    n = torch.tensor([len(mine[0])], dtype=torch.int64, device=dev)
    lens = [int(x) for x in comm.gather(n)]
    top = max(max(lens), 1)
    buf = torch.zeros((2, top), dtype=torch.uint8)
    if lens[comm.d]:
        buf[0, : lens[comm.d]] = torch.frombuffer(bytearray(mine[0]),
                                                  dtype=torch.uint8)
        buf[1, : lens[comm.d]] = torch.frombuffer(bytearray(mine[1]),
                                                  dtype=torch.uint8)
    parts = comm.gather(buf.to(dev))
    return [(d, (parts[d][0, : lens[d]].cpu().numpy().tobytes(),
                 parts[d][1, : lens[d]].cpu().numpy().tobytes()))
            for d, _ in segs]
