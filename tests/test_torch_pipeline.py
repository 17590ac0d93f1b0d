"""``aligntools-torch batch``: TSV byte parity with the JAX pipeline, the
port's import boundary, its copies of the JAX package's pure modules, and
its refusals of the options it does not port."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import ast
import glob
import gzip
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


# the TSV kinds: name1 name2 score [row1 row2 | CIGAR]
OUTPUTS = {"scores": ("--scores-only",), "rows": (), "cigar": ("--cigar",)}


def _compare(tmp_path, mode, fasta, args=(), chunk=16384, output="scores",
             engine="pallas"):
    want_path = tmp_path / f"{mode}.{output}.jax.tsv"
    got_path = tmp_path / f"{mode}.{output}.torch.tsv"
    jax_run_pipeline(mode, fasta, _params_of(args), use_sites="-s" in args,
                     scores_only=output == "scores", cigar=output == "cigar",
                     engine=engine, chunk_size=chunk,
                     out_path=str(want_path))
    rc = main(["batch", mode, fasta, *args, *OUTPUTS[output], "--device",
               "cpu", "--chunk-size", str(chunk), "--out", str(got_path)])
    assert rc == 0
    want = want_path.read_bytes()
    assert want and got_path.read_bytes() == want
    return want


FIXTURE_CASES = [
    ("global", ()), ("local", ()), ("overlap", ()), ("edit", ()),
    ("fit", ("-m", "2", "-u", "-2", "-s")),
]


@pytest.mark.parametrize("mode,args", FIXTURE_CASES)
def test_fixture_tsv_matches_jax(tmp_path, mode, args):
    _compare(tmp_path, mode, os.path.join(REPO, "test", f"test_{mode}.fa"),
             args)


@pytest.mark.parametrize("output", ["rows", "cigar"])
@pytest.mark.parametrize("mode,args", [c for c in FIXTURE_CASES
                                       if c[0] != "edit"])
def test_fixture_rows_tsv_matches_jax(tmp_path, mode, args, output):
    want = _compare(tmp_path, mode,
                    os.path.join(REPO, "test", f"test_{mode}.fa"), args,
                    output=output)
    assert len(want.split(b"\t")) == (5 if output == "rows" else 4)


SYNTHETIC_CASES = [
    ("global", ("-m", "2", "-u", "-3", "-o", "-4")), ("local", ()),
    ("overlap", ("-o", "-3")), ("edit", ("-u", "1")), ("fit", ()),
    ("fit", ("-s", "-j", "-6")),
]


@pytest.mark.parametrize("mode,args", SYNTHETIC_CASES)
def test_synthetic_tsv_matches_jax(tmp_path, mode, args):
    _compare(tmp_path, mode, _synthetic_fasta(tmp_path), args, chunk=16)


@pytest.mark.parametrize("output", ["rows", "cigar"])
@pytest.mark.parametrize("mode,args", [c for c in SYNTHETIC_CASES
                                       if c[0] != "edit"])
def test_synthetic_rows_tsv_matches_jax(tmp_path, mode, args, output):
    _compare(tmp_path, mode, _synthetic_fasta(tmp_path), args, chunk=16,
             output=output)


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


PORT_FILES = sorted(
    glob.glob(os.path.join(REPO, "aligntools_tpu_torch", "**", "*.py"),
              recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]
BLOCKED = ("jax", "jaxlib", "aligntools_tpu", "tools")


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke, imports with jax, jaxlib,
    the JAX package and its ``tools/`` blocked at the import system, and
    then runs a small rows batch on the CPU."""
    mods = [os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
            for p in PORT_FILES if not p.endswith("__main__.py")]
    code = (
        "import sys\n"
        f"BLOCKED = {BLOCKED!r}\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in BLOCKED]:\n"
        "    del sys.modules[k]\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked import: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from aligntools_tpu_torch import align_batch\n"
        "r = align_batch('global', [(b'ACGT', b'AGT')], traceback=True,\n"
        "                device='cpu')\n"
        "assert (r[0].row1, r[0].row2) == (b'ACGT', b'A-GT'), r\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_validate_campaign_imports_no_jax():
    """The differential campaign (``tools/validate.py`` of the port) runs a
    section on the CPU with jax, jaxlib, the JAX package and its
    ``tools/`` blocked, and leaves none of them in sys.modules."""
    code = (
        "import sys\n"
        f"BLOCKED = {BLOCKED!r}\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in BLOCKED]:\n"
        "    del sys.modules[k]\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked import: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from aligntools_tpu_torch.tools import validate\n"
        "assert validate.main(['2', '--device', 'cpu', '--section',\n"
        "                      'main']) == 0\n"
        "left = [k for k in sys.modules if k.split('.')[0] in BLOCKED]\n"
        "assert not left, left\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert '"validate"' in r.stdout.splitlines()[-1]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_names_no_jax_import(path):
    """No import statement of the port (at any depth: inside functions
    too) names jax or the JAX package."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, (path, node.lineno)


def test_read_records_match_jax(tmp_path):
    """The port's parser (native and pure Python) gives the JAX package's
    records on every test/*.fa and on a gzipped FASTQ."""
    from aligntools_tpu.io import fasta as jfasta
    from aligntools_tpu_torch.io import fasta as tfasta

    fq = tmp_path / "reads.fq.gz"
    with gzip.open(fq, "wb") as f:
        f.write(b"@r1 c1\nACGT\n+\nIIII\n@r2\nGG\nTT\n+\nII\nII\n")
    paths = sorted(glob.glob(os.path.join(REPO, "test", "*.fa"))) + [str(fq)]
    fields = ("name", "comment", "seq", "qual")
    for path in paths:
        want = [tuple(getattr(r, k) for k in fields)
                for r in jfasta.read_records(path)]
        assert want
        got = [tuple(getattr(r, k) for k in fields)
               for r in tfasta.read_records(path)]
        assert got == want, path
        with tfasta._open_maybe_gzip(path) as f:
            py = [tuple(getattr(r, k) for k in fields)
                  for r in tfasta.parse_records(f)]
        assert py == want, path
    assert tfasta.parse_junctions(b"100||-3| 7x|") == [100, -3, 7]


def test_copied_modules_agree_with_their_sources():
    import dataclasses

    from aligntools_tpu import params as jparams
    from aligntools_tpu.spec import engine as spec
    from aligntools_tpu.utils import cigar as jcigar
    from aligntools_tpu.utils import synth as jsynth
    from aligntools_tpu.version import __version__ as jversion
    from aligntools_tpu_torch import params as tparams
    from aligntools_tpu_torch.utils import cigar as tcigar
    from aligntools_tpu_torch.utils import synth as tsynth
    from aligntools_tpu_torch.version import __version__ as tversion

    assert dataclasses.asdict(tparams.AlignParams()) == dataclasses.asdict(
        jparams.AlignParams())
    assert tparams.MODES == jparams.MODES
    assert [f.name for f in dataclasses.fields(tparams.AlignResult)] == [
        f.name for f in dataclasses.fields(spec.AlignResult)]
    assert tversion == jversion
    assert tsynth.clustered_pairs(64, 3) == jsynth.clustered_pairs(64, 3)
    for rows in ((b"AC-GT", b"ACGG-"), (b"", b""), (b"--A", b"GT-")):
        assert tcigar.rows_to_cigar(*rows) == jcigar.rows_to_cigar(*rows)


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


@pytest.mark.parametrize("flag", [["--sharded"]])
def test_unported_options_are_refused(tmp_path, capsys, flag):
    """``--sharded``, refused until the parallel package was ported, now
    runs (a one-rank group here) and prints the ``--scores-only`` TSV."""
    fasta = _synthetic_fasta(tmp_path, 2)
    assert main(["batch", "local", fasta, "--scores-only", "--device", "cpu",
                 *flag]) == 0
    sharded = capsys.readouterr()
    assert main(["batch", "local", fasta, "--scores-only", "--device",
                 "cpu"]) == 0
    assert sharded.out == capsys.readouterr().out != ""
    assert "FATAL ERROR" not in sharded.err


def _long_fasta(tmp_path):
    """Two targets past the flat fills' 32,768 columns (the column-blocked
    fills' regime) between short pairs, junction sites in every target
    header."""
    rng = np.random.default_rng(29)
    lines = []
    for k, (m, n) in enumerate([(30, 200), (50, 33000), (20, 90),
                                (60, 36500)]):
        q = bytes(rng.choice(ALPHA, m).tolist()).decode()
        t = bytes(rng.choice(ALPHA, n).tolist()).decode()
        sl = sorted(int(x) for x in rng.integers(0, n, 3))
        lines += [f">q{k}\n{q}", f">t{k} {'|'.join(map(str, sl))}\n{t}"]
    path = tmp_path / "long.fa"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("mode,args,output", [
    ("local", (), "rows"), ("fit", ("-s",), "rows"),
    ("overlap", (), "cigar"), ("global", (), "scores"),
    ("edit", (), "scores"),
])
def test_long_target_tsv_matches_jax(tmp_path, mode, args, output):
    _compare(tmp_path, mode, _long_fasta(tmp_path), args, output=output)


def _empty_records_fasta(tmp_path, mode):
    """Records that pair up as (empty, ACGT), (ACG, empty) and a normal
    pair; fit (which needs m <= n) gets (empty, ACGT) only."""
    recs = [("", "ACGT"), ("ACG", ""), ("ACGTA", "ACGTT")]
    if mode == "fit":
        recs = [recs[0], recs[2]]
    path = tmp_path / "empty.fa"
    path.write_text("".join(f">q{k}\n{q}\n>t{k}\n{t}\n"
                            for k, (q, t) in enumerate(recs)))
    return str(path)


@pytest.mark.parametrize("mode,output", [
    (mode, output) for mode in ("global", "local", "overlap", "edit", "fit")
    for output in (("scores",) if mode == "edit" else OUTPUTS)])
def test_empty_records_tsv_matches_jax(tmp_path, mode, output):
    """A record with no sequence pairs up, and its pair's line is the JAX
    pipeline's: its engines' borders (which its Pallas score route does not
    give on such pairs), not a kernel's -inf."""
    want = _compare(tmp_path, mode, _empty_records_fasta(tmp_path, mode),
                    output=output, engine="auto")
    if mode == "global":
        assert want.startswith(b"q0\tt0\t-9.000000")


def test_usage_without_batch(capsys):
    assert main([]) == 1
    assert main(["semiglobal", "x.fa"]) == 1
    assert "aligntools-torch batch" in capsys.readouterr().err
