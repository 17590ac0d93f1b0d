"""The port's banded entry points against the JAX package's: the
single-pair entries (``banded_score_auto``, ``banded_score``,
``banded_align``) and ``aligntools-torch batch MODE --band W --device cpu``
byte for byte against ``aligntools batch MODE --band W``, on the fixtures
and on seeded similar pairs (tests/test_torch_banded.py's helpers), with
the refusals and exit codes of both."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import os

import numpy as np
import pytest

from aligntools_tpu.engine import banded as jbanded
from aligntools_tpu.params import AlignParams as JParams
from aligntools_tpu.pipeline import run_pipeline as jax_run_pipeline
from aligntools_tpu_torch.cli import main
from aligntools_tpu_torch.engine import banded as tbanded
from aligntools_tpu_torch.params import AlignParams
from test_torch_banded import _pairs, _similar_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap",
                                  "edit"])
def test_single_pair_entries_match_jax(mode):
    rng = np.random.default_rng(601)
    p = dict(match=2, mismatch=-2, gap_open=-4, gap_extend=-1)
    for _ in range(2):
        q, t = _similar_pair(rng, int(rng.integers(30, 90)), 4, 2)
        if mode == "fit" and len(q) > len(t):
            q, t = t, q
        want = jbanded.banded_score_auto(mode, q, t, JParams(**p), band0=4)
        got = tbanded.banded_score_auto(mode, q, t, AlignParams(**p),
                                        band0=4, device="cpu")
        assert got == want
        band = max(abs(len(t) - len(q)), 6)
        assert tbanded.banded_score(mode, q, t, band, AlignParams(**p),
                                    device="cpu") == jbanded.banded_score(
            mode, q, t, band, JParams(**p))
        if mode != "edit":
            g, ge = tbanded.banded_align(mode, q, t, band, AlignParams(**p),
                                         device="cpu")
            w, we = jbanded.banded_align(mode, q, t, band, JParams(**p))
            assert (g.score, g.row1, g.row2, ge) == (w.score, w.row1,
                                                      w.row2, we)
    if mode in ("global", "edit"):
        for fn in (jbanded.banded_score, tbanded.banded_score):
            with pytest.raises(ValueError, match=r"\|n-m\|=36"):
                fn(mode, b"ACGT", b"ACGT" * 10, 8)


# ---------------------------------------------------------------------------
# aligntools-torch batch --band
# ---------------------------------------------------------------------------

OUTPUTS = {"scores": ("--scores-only",), "rows": (), "cigar": ("--cigar",)}


def _params_of(args):
    p = JParams()
    flags = {"-m": "match", "-u": "mismatch", "-o": "gap_open",
             "-e": "gap_extend"}
    for k in range(len(args) - 1):
        if args[k] in flags:
            p = p.replace(**{flags[args[k]]: int(args[k + 1])})
    return p


def _compare(tmp_path, mode, fasta, band, output, args=(), chunk=16384):
    want_path = tmp_path / f"{mode}.{output}.jax.tsv"
    got_path = tmp_path / f"{mode}.{output}.torch.tsv"
    jax_run_pipeline(mode, fasta, _params_of(args), band=band,
                     scores_only=output == "scores", cigar=output == "cigar",
                     chunk_size=chunk, out_path=str(want_path))
    rc = main(["batch", mode, fasta, *args, "--band", str(band),
               *OUTPUTS[output], "--device", "cpu", "--chunk-size",
               str(chunk), "--out", str(got_path)])
    assert rc == 0
    want = want_path.read_bytes()
    assert want and got_path.read_bytes() == want
    return want


# (mode, band, args) on test/test_MODE.fa: each band holds the end cell
FIXTURE_CASES = [("global", 16, ()), ("local", 16, ()), ("overlap", 16, ()),
                 ("fit", 32, ("-m", "2", "-u", "-2")), ("edit", 64, ())]


@pytest.mark.parametrize("mode,band,args,output", [
    (*c, output) for c in FIXTURE_CASES
    for output in (("scores",) if c[0] == "edit" else OUTPUTS)])
def test_band_fixture_tsv_matches_jax(tmp_path, mode, band, args, output):
    _compare(tmp_path, mode, os.path.join(REPO, "test", f"test_{mode}.fa"),
             band, output, args)


def _similar_fasta(tmp_path, mode, empty):
    """Seeded similar pairs of 10-120 (end cells in band 24 for global and
    edit, m <= n for fit), with empty records when ``empty``."""
    pairs = _pairs(mode, 24, 809, 20)
    for k in range(len(pairs)):
        q, t = pairs[k]
        pairs[k] = (q[: 10 + k * 5], t[: 10 + k * 5 + (k % 3)])
    if empty:
        pairs[3:3] = [(b"", b"ACGT"), (b"", b"")]
        if mode != "fit":
            pairs.insert(9, (b"ACG", b""))
    path = tmp_path / "similar.fa"
    path.write_text("".join(f">q{k}\n{q.decode()}\n>t{k}\n{t.decode()}\n"
                            for k, (q, t) in enumerate(pairs)))
    return str(path)


@pytest.mark.parametrize("mode,output", [
    (mode, output) for mode in ("global", "local", "overlap", "fit", "edit")
    for output in (("scores",) if mode == "edit" else OUTPUTS)])
def test_band_similar_tsv_matches_jax(tmp_path, mode, output):
    """Similar pairs in chunks of 8; empty records wherever the JAX
    pipeline prints a line for them (not edit, whose +inf it cannot print,
    and not fit rows, which have no finite start)."""
    empty = mode != "edit" and not (mode == "fit" and output != "scores")
    want = _compare(tmp_path, mode, _similar_fasta(tmp_path, mode, empty),
                    24, output, ("-o", "-3"), chunk=8)
    if empty:
        assert b"\t-inf" in want


def test_band_edit_on_an_empty_query_exits_255(tmp_path, capsys):
    """The JAX pipeline dies on int(+inf); the port refuses with FATAL
    ERROR."""
    fasta = str(tmp_path / "e.fa")
    with open(fasta, "w") as f:
        f.write(">q0\n\n>t0\nACGT\n>q1\nACGT\n>t1\nACGA\n")
    with pytest.raises(OverflowError):
        jax_run_pipeline("edit", fasta, JParams(), band=4,
                         out_path=str(tmp_path / "jax.tsv"))
    assert main(["batch", "edit", fasta, "--band", "4", "--device",
                 "cpu"]) == 255
    err = capsys.readouterr().err
    assert "FATAL ERROR" in err and "+inf" in err


@pytest.mark.parametrize("flags,msg", [
    (["-s"], "--band does not support the fit jump state"),
    (["--sharded"], "--band does not support --sharded"),
])
def test_band_refusals(tmp_path, capsys, flags, msg):
    fasta = _similar_fasta(tmp_path, "fit", False)
    assert main(["batch", "fit", fasta, "--band", "8", *flags, "--device",
                 "cpu"]) == 255
    assert msg in capsys.readouterr().err


def test_band_too_narrow_for_the_end_cell_exits_255(tmp_path, capsys):
    fasta = str(tmp_path / "w.fa")
    with open(fasta, "w") as f:
        f.write(">q0\nACGT\n>t0\n" + "ACGT" * 10 + "\n")
    assert main(["batch", "global", fasta, "--band", "8", "--device",
                 "cpu"]) == 255
    assert "band cannot contain the end cell" in capsys.readouterr().err
