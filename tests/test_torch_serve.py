"""``aligntools-torch serve``: the port's request loop on the CPU, each
request's TSV held against the JAX package's ``serve`` on the same stream
(the ``#done`` lines without their times)."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import io
import os
import subprocess
import sys

import numpy as np

from aligntools_tpu.params import AlignParams as JaxParams
from aligntools_tpu.serve import serve as jax_serve
from aligntools_tpu.spec import engine as spec
from aligntools_tpu_torch.serve import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHA = list(b"ACGT")


def _make_fasta(tmp_path, n_pairs, seed):
    """Pairs with m <= n and three junction sites in every target header."""
    rng = np.random.default_rng(seed)
    lines, pairs = [], []
    for k in range(n_pairs):
        q = bytes(rng.choice(ALPHA, int(rng.integers(5, 60))).tolist())
        t = bytes(rng.choice(ALPHA, int(rng.integers(len(q), 150))).tolist())
        sl = sorted(int(x) for x in rng.integers(0, len(t), 3))
        pairs.append((q, t))
        lines += [f">q{k}\n{q.decode()}",
                  f">t{k} {'|'.join(map(str, sl))}\n{t.decode()}"]
    path = tmp_path / "pairs.fa"
    path.write_text("\n".join(lines) + "\n")
    return str(path), pairs


def _blocks(text):
    """Each request's (TSV lines, terminator), the #done line without its
    seconds and gcups."""
    out, lines = [], []
    for ln in text.splitlines():
        if ln.startswith("#"):
            out.append((lines, ln.split(" seconds=")[0]
                        if ln.startswith("#done") else "#error"))
            lines = []
        else:
            lines.append(ln)
    assert not lines, "TSV lines after the last terminator"
    return out


def test_serve_loop(tmp_path):
    """The JAX package's test_serve_loop, ported: a scores request, a
    malformed line, an edit request, quit, and a request after quit that
    is never processed; plus rows, fit sites, CIGAR and chunked requests,
    held line for line against the JAX serve."""
    path, pairs = _make_fasta(tmp_path, 5, seed=23)
    requests = [
        f"local {path} m=2 scores_only",
        "bogus_mode_line",
        f"edit {path}",
        f"global {path} u=-3 o=-4",
        f"fit {path} sites",
        f"overlap {path} cigar",
        f"local {path} chunk=2 e=-2",
        "",
    ]
    after = ["quit", f"local {path}"]  # after quit: never processed
    out = io.StringIO()
    assert serve(io.StringIO("\n".join(requests + after) + "\n"), out,
                 device="cpu") == 0
    got = _blocks(out.getvalue())
    want_out = io.StringIO()
    assert jax_serve(io.StringIO("\n".join(requests + after) + "\n"),
                     want_out) == 0
    want = _blocks(want_out.getvalue())
    assert got == want
    assert [t for _, t in got] == ["#done pairs=5", "#error"] + [
        "#done pairs=5"] * 5
    p2 = JaxParams(match=2)
    first = got[0][0]
    assert float(first[0].split("\t")[2]) == spec.spec_local(*pairs[0],
                                                             p2).score
    assert len(sum((lines for lines, _ in got), [])) == 30


def test_sharded_and_malformed_requests_keep_serving(tmp_path):
    """``sharded`` is answered as the JAX serve answers it (the scores of
    ``batch --sharded``, whatever the other flags); a bad value and sites
    outside fit are answered with #error, and the server goes on to the
    next request."""
    path, _ = _make_fasta(tmp_path, 3, seed=5)
    text = (f"local {path} sharded\n"
            f"local {path} m=two\n"
            f"global {path} sites\n"
            f"local {path} scores_only\n")
    out, want = io.StringIO(), io.StringIO()
    assert serve(io.StringIO(text), out, device="cpu") == 0
    assert jax_serve(io.StringIO(text), want) == 0
    blocks = _blocks(out.getvalue())
    assert [t for _, t in blocks] == ["#done pairs=3"] + ["#error"] * 2 + [
        "#done pairs=3"]
    assert blocks == _blocks(want.getvalue())
    assert blocks[0][0] == blocks[3][0] and len(blocks[3][0]) == 3


def test_serve_subcommand_reads_stdin(tmp_path):
    """``aligntools-torch serve`` with ALIGNTOOLS_DEVICE=cpu, fed on
    stdin, in a fresh interpreter."""
    path, _ = _make_fasta(tmp_path, 2, seed=3)
    r = subprocess.run(
        [sys.executable, "-m", "aligntools_tpu_torch", "serve"], cwd=REPO,
        env=dict(os.environ, ALIGNTOOLS_DEVICE="cpu"),
        input=f"edit {path}\nexit\nedit {path}\n", capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert len(lines) == 3 and lines[2].startswith("#done pairs=2 ")
