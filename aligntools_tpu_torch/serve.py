"""Serving mode: a long-lived process answering alignment requests.

Port of ``aligntools_tpu/serve.py``. A server process builds the kernels
and reaches the card once, then answers every request warm. The protocol
is the JAX package's: newline-delimited requests on stdin, TSV results and
a terminator on stdout, so a shell loop, a socket wrapper or a workflow
manager can drive it:

    <mode> <pairs.fa> [m=INT] [u=INT] [o=INT] [e=INT] [j=INT]
           [chunk=INT] [sites] [scores_only] [cigar] [sharded]

Each request runs ``pipeline.run_pipeline`` on the server's device, its TSV
lines byte for byte ``aligntools-torch batch``'s, followed by one line:

    #done pairs=N seconds=S gcups=G

or ``#error <message>``: a malformed request never stops the server. A
``sharded`` request prints the scores of ``aligntools-torch batch
--sharded`` (over the server's process group: one rank unless it runs
under torchrun). A ``quit`` or ``exit`` line, or EOF, ends the loop.
"""

from __future__ import annotations

import shlex
import sys

from aligntools_tpu_torch.params import AlignParams


def handle_request(line: str, out, *, device) -> bool:
    """Process one request line on ``device``; returns False on quit.
    Writes the results and the #done/#error terminator to ``out``."""
    from aligntools_tpu_torch.pipeline import run_pipeline

    parts = shlex.split(line.strip())
    if not parts:
        return True
    if parts[0] in ("quit", "exit"):
        return False
    try:
        if len(parts) < 2:
            raise ValueError("expected: <mode> <pairs.fa> [options]")
        mode, path = parts[0], parts[1]
        kv = {}
        flags = set()
        for tok in parts[2:]:
            if "=" in tok:
                k, v = tok.split("=", 1)
                kv[k] = int(v)
            else:
                flags.add(tok)
        params = AlignParams(
            match=kv.get("m", 1), mismatch=kv.get("u", -2),
            gap_open=kv.get("o", -5), gap_extend=kv.get("e", -1),
            jump=kv.get("j", -10),
        )
        counters = run_pipeline(
            mode, path, params, device=device,
            use_sites="sites" in flags,
            scores_only="scores_only" in flags,
            sharded="sharded" in flags,
            cigar="cigar" in flags,
            chunk_size=kv.get("chunk", 16384),
            out=out,
        )
        out.write(
            f"#done pairs={counters.pairs} "
            f"seconds={counters.seconds:.3f} "
            f"gcups={counters.gcups:.2f}\n"
        )
    except Exception as err:  # a bad request must not kill the server
        out.write(f"#error {err}\n")
    if hasattr(out, "flush"):
        out.flush()
    return True


def serve(stream_in=None, stream_out=None, *, device) -> int:
    """Answer requests from ``stream_in`` (default stdin) on ``stream_out``
    (default stdout) until ``quit`` or EOF."""
    from aligntools_tpu_torch.backend import resolve_device

    device = resolve_device(device)
    stream_in = stream_in if stream_in is not None else sys.stdin
    stream_out = stream_out if stream_out is not None else sys.stdout
    sys.stderr.write("[aligntools-torch] serving; one request per line, "
                     "'quit' or EOF ends\n")
    for line in stream_in:
        if not handle_request(line, stream_out, device=device):
            break
    return 0
