"""Batch pipeline: many-pair FASTA -> bucketed device work -> TSV.

Port of ``aligntools_tpu/pipeline.py``: a multi-record FASTA/Q (gz ok) is
read with the native parser, consecutive records pair up (q1, t1, q2, t2,
...), pairs are aligned in chunks on one device (``batch.align_batch``),
and results stream out as TSV, byte for byte the JAX package's:

    name1  name2  score  row1  row2     (the default)
    name1  name2  score  CIGAR          (cigar)
    name1  name2  score                 (scores_only, and edit)

With ``band`` the pairs go to the banded engine (``engine/banded.py``):
its scores for ``scores_only`` and edit, its rows otherwise, and no bucket
partition is built. With ``sharded`` each chunk's scores come from
``parallel/mesh.batch_scores_sharded`` over every rank of the process
group (torchrun's, or one rank): scores are printed whatever the other
flags ask, as the JAX pipeline prints them; every rank reads the FASTA and
rank 0 alone writes the TSV and the manifest. Otherwise one global bucket
partition covers the whole run; a one-worker prefetch
overlaps the next chunk's fills with formatting the previous chunk;
``--resume`` checkpoints chunk completion through the shared Manifest.
Fit junction sites come from each target record's header comment.
"""

from __future__ import annotations

import io
import os
import sys
import time as _time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from aligntools_tpu_torch.io.fasta import parse_junctions, read_records
from aligntools_tpu_torch.params import AlignParams, AlignResult
from aligntools_tpu_torch.utils.checkpoint import Manifest
from aligntools_tpu_torch.utils.cigar import rows_to_cigar
from aligntools_tpu_torch.utils.profiling import (Counters, device_trace,
                                                  stopwatch)


def read_pair_records(path: str):
    """All records; consecutive records pair (q, t). Odd counts are an
    error (a dangling query with no target). Copied from
    ``aligntools_tpu/pipeline.py``, whose module reaches jax."""
    records = list(read_records(path))
    if len(records) % 2:
        raise ValueError(
            f"{path}: {len(records)} records — batch input must pair up "
            f"(query, target) consecutively"
        )
    return [(records[i], records[i + 1]) for i in range(0, len(records), 2)]


def run_pipeline(
    mode: str,
    path: str,
    params: AlignParams = AlignParams(),
    *,
    device,
    use_sites: bool = False,
    scores_only: bool = False,
    sharded: bool = False,
    chunk_size: int = 16384,
    manifest_path: str | None = None,
    out=None,
    out_path: str | None = None,
    band: int | None = None,
    cigar: bool = False,
    trace_dir: str | None = None,
) -> Counters:
    """Align every pair in ``path`` on ``device``; returns run counters.

    TSV goes to the text stream ``out`` (default stdout; the server passes
    its own), or to ``out_path``, which the pipeline then owns: with a
    manifest, each chunk's end byte offset is checkpointed and a resumed run
    truncates any torn chunk back to the last completed watermark before
    appending. With a caller's ``out``, chunk skipping still works, but a
    kill between the chunk's write and the manifest's update re-emits that
    chunk. Targets past the flat fills' 32,768
    columns run on the column-blocked fills; ``band`` runs the banded
    engine; ``sharded`` shards each chunk's scores over the process group's
    ranks (``--band`` with it is refused, as the JAX pipeline refuses it).
    Departure: fit ``use_sites`` with ``sharded`` passes the sites, so the
    jump state is on, where the JAX pipeline drops them. A +inf banded edit
    distance (an empty sequence) raises ValueError: it has no integer to
    print. ``trace_dir``: a torch.profiler Chrome trace of the run's loop
    (the region of ``Counters.seconds``) goes there
    (``utils/profiling.device_trace``; a file a rank where several run)."""
    from aligntools_tpu_torch.batch import _bucket_keys, align_batch
    from aligntools_tpu_torch.engine import banded

    if out is not None and out_path is not None:
        raise ValueError("pass out or out_path, not both")
    if mode != "fit" and use_sites:
        raise ValueError("junction sites are only meaningful in fit mode")
    if band is not None and use_sites:
        raise ValueError("--band does not support the fit jump state")
    if band is not None and sharded:
        raise ValueError("--band does not support --sharded")
    mesh = None
    if sharded:
        from aligntools_tpu_torch.parallel.mesh import (
            batch_scores_sharded, make_mesh)

        mesh = make_mesh(device=device)
    # rank 0 alone writes the TSV and the manifest
    writer = mesh is None or mesh.rank == 0
    counters = Counters()
    with stopwatch(counters, "io_seconds"):
        rec_pairs = read_pair_records(path)
    # ONE bucket partition for the whole run, sliced per chunk
    global_keys = None
    if band is None and not sharded:
        with stopwatch(counters, "encode_seconds"):
            global_keys = _bucket_keys(
                [(a.seq, b.seq) for a, b in rec_pairs], 64, 128
            )
    manifest = None
    if manifest_path and writer:
        manifest = Manifest.load_or_create(
            manifest_path, os.path.abspath(path), mode, chunk_size,
            len(rec_pairs),
        )
    if not writer:
        out, out_path = io.StringIO(), None
    own_out = out_path is not None
    if own_out:
        # Binary: tell()/truncate() must be real byte offsets for the
        # manifest watermark. r+b keeps completed chunks for resume.
        out = open(out_path, "r+b" if os.path.exists(out_path) else "w+b")
        wm = manifest.watermark() if manifest else 0
        out.seek(wm)
        out.truncate(wm)  # drop any torn chunk from a killed run
    else:
        out = out if out is not None else sys.stdout

    chunks = [
        rec_pairs[i : i + chunk_size]
        for i in range(0, len(rec_pairs), chunk_size)
    ]

    def compute(ci, chunk):
        """Align one chunk (on the prefetch worker: the NEXT chunk's
        encode + fills + walks overlap the main thread's formatting)."""
        pairs = [(a.seq, b.seq) for a, b in chunk]
        sites_list = None
        if use_sites:
            sites_list = [
                parse_junctions(b.comment) if b.comment else []
                for _, b in chunk
            ]
        if sharded:
            scores = batch_scores_sharded(mode, pairs, params, mesh,
                                          sites_list)
            if mode == "edit":
                return pairs, [int(s) for s in scores]
            return pairs, [AlignResult(float(s), b"", b"") for s in scores]
        if band is not None:
            if mode == "edit" or scores_only:
                scores, _ = banded.banded_batch_scores(
                    mode, pairs, band, params, device=device,
                    counters=counters)
                if mode == "edit":
                    if not np.isfinite(scores).all():
                        raise ValueError(
                            "banded edit distance is +inf (an empty "
                            "sequence: no in-band path)")
                    return pairs, list(scores)
                return pairs, [AlignResult(float(s), b"", b"")
                               for s in scores]
            return pairs, banded.banded_align_batch(
                mode, pairs, band, params, device=device,
                counters=counters)[0]
        keys = global_keys[ci * chunk_size : ci * chunk_size + len(chunk)]
        return pairs, align_batch(
            mode, pairs, params, sites_list, traceback=not scores_only,
            device=device, counters=counters, keys=keys)

    done = [bool(manifest and manifest.is_done(ci))
            for ci in range(len(chunks))]
    if mesh is not None and mesh.size > 1:
        done = _rank0_flags(mesh, done)  # every rank skips rank 0's chunks
    pending = [(ci, chunk) for ci, chunk in enumerate(chunks) if not done[ci]]
    pool = ThreadPoolExecutor(1)
    try:
        with device_trace(trace_dir, device,
                          mesh.rank if mesh is not None and mesh.size > 1
                          else None), stopwatch(counters, "seconds"):
            fut = pool.submit(compute, *pending[0]) if pending else None
            for pi, (ci, chunk) in enumerate(pending):
                pairs, results = fut.result()
                if pi + 1 < len(pending):
                    fut = pool.submit(compute, *pending[pi + 1])
                tfmt = _time.perf_counter()
                lines = []
                for k, ((a, b), r) in enumerate(zip(chunk, results)):
                    name1 = a.name.decode("latin-1")
                    name2 = b.name.decode("latin-1")
                    if mode == "edit":
                        lines.append(f"{name1}\t{name2}\t{int(r)}")
                    elif scores_only or sharded:
                        lines.append(f"{name1}\t{name2}\t{r.score:.6f}")
                    elif cigar:
                        lines.append(
                            f"{name1}\t{name2}\t{r.score:.6f}\t"
                            f"{rows_to_cigar(r.row1, r.row2)}")
                    else:
                        lines.append(
                            f"{name1}\t{name2}\t{r.score:.6f}\t"
                            f"{r.row1.decode('latin-1')}\t"
                            f"{r.row2.decode('latin-1')}")
                    counters.pairs += 1
                    counters.cells += len(pairs[k][0]) * len(pairs[k][1])
                if sharded:
                    # the cells of the JAX pipeline's bucket keys, as it
                    # counts a sharded chunk
                    counters.padded_cells += sum(
                        mp * np_ for mp, np_ in _bucket_keys(pairs, 64, 128))
                text = "\n".join(lines) + "\n"
                out.write(text.encode("latin-1") if own_out else text)
                out.flush()
                if own_out:
                    os.fsync(out.fileno())  # durable before manifest says done
                if manifest:
                    manifest.mark_done(ci, out.tell() if own_out else None)
                counters.format_seconds += _time.perf_counter() - tfmt
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        if own_out:
            out.close()
    return counters


def _rank0_flags(mesh, flags):
    """Rank 0's list of booleans, on every rank of the mesh."""
    import torch
    import torch.distributed as dist

    x = torch.tensor(flags, dtype=torch.uint8, device=mesh.comm_device())
    if len(flags):
        dist.broadcast(x, src=0)
    return [bool(v) for v in x.cpu().tolist()]
