"""``aligntools-torch batch``: TSV byte parity with the JAX pipeline, the
port's import boundary, and its refusals."""

import os
import subprocess
import sys

import numpy as np
import pytest

from aligntools_tpu.params import AlignParams
from aligntools_tpu.pipeline import run_pipeline as jax_run_pipeline
from aligntools_tpu_torch.cli import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHA = list(b"ACGT")


def _synthetic_fasta(tmp_path, n_pairs=40, seed=0):
    """Two length clusters (two buckets), fit-safe lengths, and junction
    sites in every target header."""
    rng = np.random.default_rng(seed)
    lines = []
    for k in range(n_pairs):
        q = bytes(rng.choice(ALPHA, int(rng.integers(5, 60))).tolist())
        hi = 150 if k % 2 else 400
        t = bytes(rng.choice(ALPHA, int(rng.integers(len(q), hi))).tolist())
        sl = sorted(int(x) for x in rng.integers(0, len(t), 3))
        lines.append(f">q{k}\n{q.decode()}")
        lines.append(f">t{k} {'|'.join(map(str, sl))}\n{t.decode()}")
    path = tmp_path / "pairs.fa"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _params_of(args):
    p = AlignParams()
    flags = {"-m": "match", "-u": "mismatch", "-o": "gap_open",
             "-e": "gap_extend", "-j": "jump"}
    for k in range(0, len(args) - 1):
        if args[k] in flags:
            p = p.replace(**{flags[args[k]]: int(args[k + 1])})
    return p


def _compare(tmp_path, mode, fasta, args=(), chunk=16384):
    want_path = tmp_path / f"{mode}.jax.tsv"
    got_path = tmp_path / f"{mode}.torch.tsv"
    jax_run_pipeline(mode, fasta, _params_of(args), use_sites="-s" in args,
                     scores_only=True, engine="pallas", chunk_size=chunk,
                     out_path=str(want_path))
    rc = main(["batch", mode, fasta, *args, "--scores-only", "--device",
               "cpu", "--chunk-size", str(chunk), "--out", str(got_path)])
    assert rc == 0
    want = want_path.read_bytes()
    assert want and got_path.read_bytes() == want


@pytest.mark.parametrize("mode,args", [
    ("global", ()), ("local", ()), ("overlap", ()), ("edit", ()),
    ("fit", ("-m", "2", "-u", "-2", "-s")),
])
def test_fixture_tsv_matches_jax(tmp_path, mode, args):
    _compare(tmp_path, mode, os.path.join(REPO, "test", f"test_{mode}.fa"),
             args)


@pytest.mark.parametrize("mode,args", [
    ("global", ("-m", "2", "-u", "-3", "-o", "-4")), ("local", ()),
    ("overlap", ("-o", "-3")), ("edit", ("-u", "1")), ("fit", ()),
    ("fit", ("-s", "-j", "-6")),
])
def test_synthetic_tsv_matches_jax(tmp_path, mode, args):
    _compare(tmp_path, mode, _synthetic_fasta(tmp_path), args, chunk=16)


def test_resume_keeps_completed_chunks(tmp_path):
    fasta = _synthetic_fasta(tmp_path, 12, seed=3)
    out, manifest = tmp_path / "o.tsv", tmp_path / "m.json"
    args = ["batch", "local", fasta, "--scores-only", "--device", "cpu",
            "--chunk-size", "4", "--out", str(out), "--resume",
            str(manifest)]
    assert main(args) == 0
    first = out.read_bytes()
    assert len(first.splitlines()) == 12
    assert main(args) == 0  # every chunk done: nothing re-emitted
    assert out.read_bytes() == first


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib')]:\n"
        "    del sys.modules[k]\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib'):\n"
        "            raise ImportError('jax import: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import aligntools_tpu_torch\n"
        "from aligntools_tpu_torch import (backend, batch, cli, convert,\n"
        "    exact, pipeline)\n"
        "from aligntools_tpu_torch.ops import _build, scan\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_device_cuda_without_cuda_fails_clearly(tmp_path):
    fasta = _synthetic_fasta(tmp_path, 2)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "aligntools_tpu_torch", "batch", "local",
         fasta, "--scores-only", "--device", "cuda"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert "FATAL ERROR" in r.stderr and "cuda" in r.stderr
    assert r.stdout == ""


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap"])
def test_rows_are_refused(tmp_path, capsys, mode):
    fasta = _synthetic_fasta(tmp_path, 2)
    assert main(["batch", mode, fasta, "--device", "cpu"]) == 255
    err = capsys.readouterr().err
    assert "FATAL ERROR" in err and "--scores-only" in err


@pytest.mark.parametrize("flag", [["--sharded"], ["--band", "32"]])
def test_unported_options_are_refused(tmp_path, capsys, flag):
    fasta = _synthetic_fasta(tmp_path, 2)
    assert main(["batch", "local", fasta, "--scores-only", "--device", "cpu",
                 *flag]) == 255
    err = capsys.readouterr().err
    assert "FATAL ERROR" in err and flag[0] in err and "not ported" in err


def test_long_targets_are_refused_before_output(tmp_path, capsys):
    fasta = tmp_path / "long.fa"
    fasta.write_text(">q0\nACGT\n>t0\nACG\n>q1\nACGT\n>t1\n"
                     + "A" * 32769 + "\n")
    out = tmp_path / "o.tsv"
    assert main(["batch", "local", str(fasta), "--scores-only", "--device",
                 "cpu", "--out", str(out)]) == 255
    err = capsys.readouterr().err
    assert "FATAL ERROR: pair 1" in err and "column-blocked" in err
    assert not out.exists()


def test_usage_without_batch(capsys):
    assert main([]) == 1
    assert main(["local", "x.fa"]) == 1
    assert "aligntools-torch batch" in capsys.readouterr().err
