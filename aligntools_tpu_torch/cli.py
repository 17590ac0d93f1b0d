"""``aligntools-torch`` CLI: the port's command line.

    aligntools-torch global|local|fit|overlap|edit [options] FILE
    aligntools-torch batch MODE FASTA [options]
    aligntools-torch serve
    aligntools-torch calibrate [--force]
    python3 -m aligntools_tpu_torch ...    (without the console script)

The per-mode commands are the reference's surface (src/main.c:6-57, the
five main_* of src/alignment.h), copied from ``aligntools_tpu/cli.py``: a
two-record FASTA/Q, getopt options before the file with C ``atoi`` values,
and on stdout ``score=%f`` plus the two gapped rows (global, local, fit;
``fit -s`` first echoes the second record's raw comment), overlap's bare
``%f`` plus the rows, or ``edit_distance=%d``; on success ``[main]
Version:`` / ``[main] CMD:`` go to stderr. ``serve`` answers requests on
stdin (``serve.py``). These run on the device that ``ALIGNTOOLS_DEVICE``
names, the variable the JAX CLI reads: ``cuda`` by default, ``cpu`` (the
kernels' plain versions) only when asked by name; without a usable card
they end in ``FATAL ERROR``.

``batch`` aligns many pairs: records pair up consecutively (q1, t1, q2,
t2, ...); the TSV (alignment rows by default, CIGAR with ``--cigar``,
scores with ``--scores-only``) goes to stdout or ``--out``, byte for byte
``aligntools batch``'s. ``--device`` picks its device (default ``cuda``).
``--sharded`` prints scores sharded over the ranks of a process group:
under ``torchrun --nproc-per-node N`` one card a rank (NCCL; gloo with
``--device cpu``), alone a group of one rank; rank 0 writes the TSV, and a
failing rank ends the job (``parallel/distributed.abort_all``).

``calibrate`` measures the card's crossover table once (``engine/
autotune.py``; ``--force`` measures again) and caches it per card under
``ALIGNTOOLS_TORCH_CACHE`` (default ``~/.cache/aligntools-torch``); the
routes read it from then on. Without a usable Hopper card it ends in
``FATAL ERROR``, as the JAX one does off the TPU.

A pair whose (params x lengths) leave float32's exact integers runs the
double instances of the kernels (``api.align_pair``), as the JAX CLI
answers it in double; ``batch`` and ``serve`` refuse it, as ``aligntools
batch`` does.

Errors print ``FATAL ERROR: ...`` and exit 255, with the JAX CLI's wording;
a file that cannot be opened reads ``cannot open FILE`` from the C++ parser
(the C reference prints ``Can't open FILE``). Departure from the JAX CLI,
whose per-mode commands run its double-precision spec engine on the CPU:
a pair with an empty side gets the JAX device route's result
(``engine/scan.scan_align``): local and overlap with an empty target and
overlap with both empty print ``-inf`` and empty rows, fit with an empty
query ``score=0.000000`` and empty rows, where the JAX CLI ends in ``FATAL
ERROR`` or an uncaught ``IndexError``; fit with both empty ends in ``FATAL
ERROR`` worded ``fit: no finite traceback start``.

Not ported: the JAX CLI's hand-over to the native C++ binary (here the
port's own kernels answer) and its XLA compile cache.
"""

from __future__ import annotations

import argparse
import getopt
import os
import sys

from aligntools_tpu_torch.io.fasta import c_atoi
from aligntools_tpu_torch.params import AlignParams
from aligntools_tpu_torch.version import __version__

_OPTSTRINGS = {
    # the reference's optstrings: global/local/overlap "m:u:o:e:j:s" with
    # -j/-s falling through to `default: return 1` (alignment.h:481-488),
    # rejected here with a message; fit takes them; edit's broken "m:u:o:e"
    # takes a (dead) -e value (aligntools_tpu/cli.py:31-42)
    "global": "m:u:o:e:",
    "local": "m:u:o:e:",
    "fit": "m:u:o:e:j:s",
    "overlap": "m:u:o:e:",
    "edit": "m:u:o:e:",
}
DEVICE_ENV = "ALIGNTOOLS_DEVICE"


def _usage() -> int:
    sys.stderr.write(
        "\n"
        "Program: aligntools-torch (PyTorch / CUDA pairwise sequence "
        "alignment)\n"
        f"Version: {__version__}\n\n"
        "Usage:   aligntools-torch <command> [options] <target.fa>\n\n"
        "Command: global     global (Needleman-Wunsch) alignment, affine gap\n"
        "         local      local (Smith-Waterman) alignment, affine gap\n"
        "         fit        fit alignment, affine gap plus junction jump state\n"
        "         overlap    overlap alignment\n"
        "         edit       edit distance\n"
        "         batch      many-pair batched pipeline (TSV output; "
        "aligntools-torch batch --help)\n"
        "         serve      long-lived request loop (stdin/stdout)\n"
        "         calibrate  measure this card's crossover table once "
        "(--force: again)\n"
        "\n"
        f"Device:  {DEVICE_ENV}=cuda (default) or cpu (the kernels' plain "
        "versions); batch takes --device\n"
        "\n"
    )
    return 1


def _sub_usage(mode: str, p: AlignParams) -> int:
    lines = [
        "",
        f"Usage:   aligntools-torch {mode} [options] <target.fa>",
        "",
        f"Options: -m INT   score for a match [{p.match}]",
        f"         -u INT   mismatch penalty [{p.mismatch}]",
        f"         -o INT   gap open penalty [{p.gap_open}]",
        f"         -e INT   gap extension penalty [{p.gap_extend}]",
    ]
    if mode == "fit":
        lines += [
            f"         -j INT   jump penalty [{p.jump}]",
            "         -s       junction sites from 2nd record's comment",
        ]
    sys.stderr.write("\n".join(lines) + "\n\n")
    return 1


def _env_device():
    """The device ``ALIGNTOOLS_DEVICE`` names (default cuda), resolved with
    no fallback."""
    from aligntools_tpu_torch.backend import resolve_device

    return resolve_device(os.environ.get(DEVICE_ENV) or "cuda",
                          cpu_hint=f"set {DEVICE_ENV}=cpu")


def run_subcommand(mode: str, args: list[str]) -> int:
    p = AlignParams()
    try:
        opts, rest = getopt.getopt(args, _OPTSTRINGS[mode])
    except getopt.GetoptError as err:
        sys.stderr.write(f"aligntools-torch {mode}: {err}\n")
        return 1
    use_sites = False
    for flag, val in opts:
        if flag == "-m":
            p = p.replace(match=c_atoi(val.encode()))
        elif flag == "-u":
            p = p.replace(mismatch=c_atoi(val.encode()))
        elif flag == "-o":
            p = p.replace(gap_open=c_atoi(val.encode()))
        elif flag == "-e":
            p = p.replace(gap_extend=c_atoi(val.encode()))
        elif flag == "-j":
            p = p.replace(jump=c_atoi(val.encode()))
        elif flag == "-s":
            use_sites = True
    if not rest:
        return _sub_usage(mode, p)
    path = rest[-1]
    from aligntools_tpu_torch.api import align_file

    try:
        result, pair = align_file(mode, path, p, use_sites,
                                  device=_env_device())
    except (OSError, ValueError, RuntimeError) as err:
        sys.stderr.write(f"FATAL ERROR: {err}\n")
        return 255  # the reference's die() -> exit(-1) (alignment.h:69-79)
    out = sys.stdout
    if mode == "edit":
        out.write(f"edit_distance={result}\n")
    elif mode == "overlap":
        out.write(f"{result.score:.6f}\n")
        out.write(result.row1.decode("latin-1") + "\n")
        out.write(result.row2.decode("latin-1") + "\n")
    else:
        if mode == "fit" and use_sites and pair.comment2 is not None:
            # junction echo line (alignment.h:249)
            out.write(pair.comment2.decode("latin-1") + "\n")
        out.write(f"score={result.score:.6f}\n")
        out.write(result.row1.decode("latin-1") + "\n")
        out.write(result.row2.decode("latin-1") + "\n")
    return 0


def run_serve() -> int:
    from aligntools_tpu_torch.serve import serve

    try:
        device = _env_device()
    except (ValueError, RuntimeError) as err:
        sys.stderr.write(f"FATAL ERROR: {err}\n")
        return 255
    return serve(device=device)


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
                    help="scores sharded over the ranks of a process group "
                         "(torchrun --nproc-per-node N: N cards; alone: one "
                         "rank)")
    ap.add_argument("--band", type=int, default=None, metavar="W",
                    help="banded fill, O(m*W) work: full rows (or scores "
                         "with --scores-only); exact when the optimal "
                         "path stays in band")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the fills run (default cuda; cpu runs the "
                         "kernels' plain PyTorch versions)")
    ns = ap.parse_args(args)
    from aligntools_tpu_torch.backend import resolve_device
    from aligntools_tpu_torch.pipeline import run_pipeline

    p = AlignParams(match=ns.m, mismatch=ns.u, gap_open=ns.o,
                    gap_extend=ns.e, jump=ns.j)
    if ns.resume and not ns.out:
        sys.stderr.write(
            "[batch] note: --resume without --out checkpoints chunk "
            "completion only; add --out FILE for crash-atomic output\n"
        )
    if ns.sharded:
        from aligntools_tpu_torch.parallel import distributed

        try:
            counters = run_pipeline(
                ns.mode, ns.fasta, p, device=resolve_device(ns.device),
                use_sites=ns.s, scores_only=ns.scores_only, sharded=True,
                chunk_size=ns.chunk_size, manifest_path=ns.resume,
                out_path=ns.out, band=ns.band, cigar=ns.cigar,
            )
        except (OSError, ValueError, RuntimeError) as err:
            if not distributed.is_multihost():
                sys.stderr.write(f"FATAL ERROR: {err}\n")
                return 255
            distributed.abort_all(err)  # no rank left in a collective
        if distributed.rank() == 0:
            counters.report()
        return 0
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
    if not argv:
        return _usage()
    cmd = argv[0]
    if cmd == "batch":
        return run_batch(argv[1:])
    if cmd == "serve":
        return run_serve()
    if cmd == "calibrate":
        # the card's crossover table, measured once and cached per card
        from aligntools_tpu_torch.engine.autotune import calibrate

        try:
            calibrate(force="--force" in argv[1:])
        except (ValueError, RuntimeError) as err:
            sys.stderr.write(f"FATAL ERROR: {err}\n")
            return 255
        return 0
    if cmd not in _OPTSTRINGS:
        sys.stderr.write(f"[main] unrecognized command '{cmd}'\n")
        return 1
    ret = run_subcommand(cmd, argv[1:])
    if ret == 0:
        sys.stderr.write(f"[main] Version: {__version__}\n")
        sys.stderr.write("[main] CMD: aligntools-torch " + " ".join(argv)
                         + "\n")
    return ret


if __name__ == "__main__":
    sys.exit(main())
