"""``aligntools-torch`` CLI: the port's batch surface.

    aligntools-torch batch MODE FASTA [options]
    python3 -m aligntools_tpu_torch batch MODE FASTA [options]

Records pair up consecutively (q1, t1, q2, t2, ...); the TSV (alignment
rows by default, CIGAR with ``--cigar``, scores with ``--scores-only``)
goes to stdout or ``--out``, byte for byte ``aligntools batch``'s.
``--device`` picks the device explicitly (default ``cuda``): there is no
silent fallback to the CPU. Errors print ``FATAL ERROR: ...`` and exit
255, as ``aligntools batch`` does.
"""

from __future__ import annotations

import argparse
import sys

_USAGE = (
    "\nUsage:   aligntools-torch batch <mode> [options] <pairs.fa>\n\n"
    "Batched alignment (PyTorch / CUDA); see "
    "`aligntools-torch batch --help`.\n\n"
)


def run_batch(args: list[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="aligntools-torch batch",
        description="Batched alignment of many pairs on one CUDA GPU (or "
                    "the CPU, by name)",
    )
    ap.add_argument("mode", choices=["global", "local", "fit", "overlap",
                                     "edit"])
    ap.add_argument("fasta", help="multi-record FASTA/Q (gz ok); records "
                                  "pair up consecutively (q1,t1,q2,t2,...)")
    ap.add_argument("-m", type=int, default=1, help="match score")
    ap.add_argument("-u", type=int, default=-2, help="mismatch penalty")
    ap.add_argument("-o", type=int, default=-5, help="gap open penalty")
    ap.add_argument("-e", type=int, default=-1, help="gap extension penalty")
    ap.add_argument("-j", type=int, default=-10, help="fit jump penalty")
    ap.add_argument("-s", action="store_true",
                    help="fit: junction sites from each target's comment")
    ap.add_argument("--scores-only", action="store_true",
                    help="skip traceback (fastest)")
    ap.add_argument("--cigar", action="store_true",
                    help="emit CIGAR strings instead of gapped rows")
    ap.add_argument("--chunk-size", type=int, default=16384)
    ap.add_argument("--out", metavar="FILE", default=None,
                    help="output TSV file owned by the pipeline (with "
                         "--resume: crash-atomic chunk checkpointing)")
    ap.add_argument("--resume", metavar="MANIFEST",
                    help="chunk manifest for checkpoint/resume")
    ap.add_argument("--sharded", action="store_true",
                    help="multi-device data parallelism (not ported yet: "
                         "refused)")
    ap.add_argument("--band", type=int, default=None, metavar="W",
                    help="banded fill (not ported yet: refused)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the fills run (default cuda; cpu runs the "
                         "kernels' plain PyTorch versions)")
    ns = ap.parse_args(args)
    from aligntools_tpu_torch.params import AlignParams
    from aligntools_tpu_torch.backend import resolve_device
    from aligntools_tpu_torch.pipeline import run_pipeline

    p = AlignParams(match=ns.m, mismatch=ns.u, gap_open=ns.o,
                    gap_extend=ns.e, jump=ns.j)
    if ns.resume and not ns.out:
        sys.stderr.write(
            "[batch] note: --resume without --out checkpoints chunk "
            "completion only; add --out FILE for crash-atomic output\n"
        )
    try:
        counters = run_pipeline(
            ns.mode, ns.fasta, p, device=resolve_device(ns.device),
            use_sites=ns.s, scores_only=ns.scores_only, sharded=ns.sharded,
            chunk_size=ns.chunk_size, manifest_path=ns.resume,
            out_path=ns.out, band=ns.band, cigar=ns.cigar,
        )
    except (OSError, ValueError, RuntimeError) as err:
        sys.stderr.write(f"FATAL ERROR: {err}\n")
        return 255
    counters.report()
    return 0


def main(argv: list[str] | None = None) -> int:
    """``argv`` without the program name (default ``sys.argv[1:]``)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "batch":
        sys.stderr.write(_USAGE)
        return 1
    return run_batch(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
