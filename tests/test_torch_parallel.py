"""The port's parallel package on the CPU (gloo): ``parallel/distributed.py``
at a world of one, ``parallel/mesh.py``'s ``batch_scores_sharded`` and
``aligntools-torch batch --sharded`` against the JAX ``batch_scores_sharded``
and ``aligntools batch --sharded`` (the 8-device CPU mesh of
tests/conftest.py), and one spawn of 8 CPU ranks on a FileStore (no port
taken) running the dry run of ``__graft_entry__.dryrun_multichip``, held
against the JAX package, exactly."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from aligntools_tpu.cli import main as jax_cli
from aligntools_tpu.params import AlignParams as JParams
from aligntools_tpu.parallel import mesh as jmesh
from aligntools_tpu.parallel import seqpar as jseqpar
from aligntools_tpu_torch.cli import main
from aligntools_tpu_torch.params import AlignParams
from aligntools_tpu_torch.parallel import distributed, mesh

import torch_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["global", "local", "overlap", "edit", "fit"]


def test_world_of_one_helpers():
    """Without torchrun's environment every helper is a no-op: one rank,
    no init, the barrier returns, the gather hands back the array."""
    assert not distributed.is_multihost() and distributed.world() == 1
    assert distributed.rank() == 0
    distributed.init_multihost(device="cpu")
    distributed.barrier("aligntools-test")
    x = np.arange(6, dtype=np.int64).reshape(3, 2)
    assert distributed.gather_to_host0(x) is x
    assert distributed.default_backend("cpu") == "gloo"
    assert distributed.local_device("cpu").type == "cpu"


def test_make_mesh_at_one_rank():
    """A one-rank gloo group on a HashStore; one and two axes; a mesh that
    does not cover the group and an unknown backend are refused."""
    m = mesh.make_mesh(device="cpu")
    assert (m.axes, m.shape, m.coords, m.rank) == (
        ("data",), {"data": 1}, {"data": 0}, 0)
    assert m.backend == "gloo" and m.comm_device().type == "cpu"
    g = mesh.make_mesh(axis=("data", "seq"), shape=(1, 1), device="cpu")
    assert g.shape == {"data": 1, "seq": 1} and g.ranks == {"data": [0],
                                                            "seq": [0]}
    assert mesh.make_mesh(device="cpu") is m
    with pytest.raises(ValueError, match="does not cover"):
        mesh.make_mesh(axis=("data", "seq"), shape=(2, 1), device="cpu")
    with pytest.raises(ValueError, match="over a group of 1"):
        mesh.make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="unsupported backend"):
        mesh.make_mesh(device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="nccl backend needs a CUDA"):
        mesh.make_mesh(device="cpu", backend="nccl")


def test_abort_all_ends_the_process():
    """``abort_all`` prints ``FATAL ERROR (rank r): ...`` and exits 1."""
    r = subprocess.run(
        [sys.executable, "-c",
         "from aligntools_tpu_torch.parallel import distributed as d; "
         "d.abort_all(RuntimeError('boom'))"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert "FATAL ERROR (rank 0): boom" in r.stderr


def _pairs(seed, k=11):
    rng = np.random.default_rng(seed)
    out, sites = [], []
    for _ in range(k):
        m = int(rng.integers(3, 60))
        n = int(rng.integers(m, 400))
        out.append((bytes(rng.choice(list(b"ACGT"), m).tolist()),
                    bytes(rng.choice(list(b"ACGT"), n).tolist())))
        sites.append(sorted(int(x) for x in rng.integers(0, n, 3)))
    return out, sites


@pytest.mark.parametrize("mode", MODES + ["fit+sites"])
def test_batch_scores_sharded_equals_jax(mode):
    """The port's batch_scores_sharded at one rank against the JAX one over
    8 devices (fit with sites: both take the jump)."""
    mo = mode.split("+")[0]
    pairs, sites = _pairs(3)
    sl = sites if mode == "fit+sites" else None
    p = dict(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    got = mesh.batch_scores_sharded(mo, pairs, AlignParams(**p), None, sl,
                                    device="cpu")
    want = jmesh.batch_scores_sharded(mo, pairs, JParams(**p), None, sl)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _fasta(tmp_path, pairs, sites):
    path = tmp_path / "pairs.fa"
    with open(path, "w") as f:
        for k, ((q, t), s) in enumerate(zip(pairs, sites)):
            f.write(f">q{k}\n{q.decode()}\n>t{k} {'|'.join(map(str, s))}\n"
                    f"{t.decode()}\n")
    return str(path)


def jax_main(argv):
    return jax_cli(["aligntools", *argv])


def _tsv(run, argv, path):
    assert run([*argv, "--out", str(path)]) == 0
    return path.read_bytes()


@pytest.mark.parametrize("mode", MODES)
def test_batch_sharded_tsv_equals_jax(tmp_path, mode):
    """``aligntools-torch batch MODE --sharded`` prints the bytes of
    ``aligntools batch MODE --sharded``: scores whatever the other flags."""
    fasta = _fasta(tmp_path, *_pairs(7))
    got = _tsv(main, ["batch", mode, fasta, "--sharded", "--device", "cpu",
                      "-o", "-4", "--chunk-size", "5"], tmp_path / "t.tsv")
    want = _tsv(jax_main, ["batch", mode, fasta, "--sharded", "-o", "-4",
                           "--chunk-size", "5"], tmp_path / "j.tsv")
    assert got == want and got.count(b"\n") == 11


def test_batch_fit_sites_sharded_keeps_the_jump(tmp_path):
    """Departure: ``batch fit -s --sharded`` passes the junction sites, so
    its TSV is ``batch fit -s --scores-only``'s (the JAX package's too);
    the JAX ``--sharded`` drops them: its TSV is its no-sites one."""
    pairs, sites = _pairs(9)
    fasta = _fasta(tmp_path, pairs, sites)
    got = _tsv(main, ["batch", "fit", fasta, "-s", "--sharded", "--device",
                      "cpu"], tmp_path / "t.tsv")
    assert got == _tsv(main, ["batch", "fit", fasta, "-s", "--scores-only",
                              "--device", "cpu"], tmp_path / "t1.tsv")
    assert got == _tsv(jax_main, ["batch", "fit", fasta, "-s",
                                  "--scores-only"], tmp_path / "j1.tsv")
    jax_sharded = _tsv(jax_main, ["batch", "fit", fasta, "-s", "--sharded"],
                       tmp_path / "j2.tsv")
    assert jax_sharded == _tsv(jax_main, ["batch", "fit", fasta,
                                          "--sharded"], tmp_path / "j3.tsv")
    assert jax_sharded != got


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One gloo group of 8 CPU processes (tests/torch_ranks.py), which
    import no jax; rank 0's results."""
    tmp = tmp_path_factory.mktemp("ranks")
    out, store = tmp / "out.json", tmp / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_ranks.py"),
         str(out), str(store), str(r), "8"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(8)]
    errs = [p.communicate(timeout=300)[1] for p in procs]
    assert [p.returncode for p in procs] == [0] * 8, errs
    assert not any("jax" in e for e in errs)
    return json.loads(out.read_text())


def test_spawned_ranks_meet(spawned):
    assert spawned["ranks"] == list(range(8))
    assert spawned["mesh"] == {"data": {"data": 8}, "seq": {"seq": 8},
                               "grid": {"data": 2, "seq": 4}}


@pytest.mark.parametrize("mode", MODES + ["fit+sites"])
def test_spawned_ranks_equal_jax(spawned, mode):
    """Sharded scores over 8 ranks, seqpar_batch_scores over (2, 4),
    seqpar_score over 8 and seqpar_align over (2, 4) against the JAX
    package's on the same pairs (its 8-device mesh)."""
    import jax
    from jax.sharding import Mesh

    mo = mode.split("+")[0]
    w = torch_ranks.workloads()
    p = JParams(**torch_ranks.PARAMS)
    sl = (lambda k: w[k] if mode == "fit+sites" else None)
    want = jmesh.batch_scores_sharded(mo, w["sharded"], p, None,
                                      sl("sharded_sites"))
    assert spawned[f"sharded/{mode}"] == want.tolist()
    grid = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "seq"))
    want = jseqpar.seqpar_batch_scores(mo, w["batch"], p, sl("batch_sites"),
                                       grid)
    assert spawned[f"batch/{mode}"] == want.tolist()
    assert spawned[f"single/{mode}"] == jseqpar.seqpar_score(
        mo, *w["single"], p, sl("single_sites"))
    if mo != "edit":
        r = jseqpar.seqpar_align(mo, *w["align"], p, sl("align_sites"))
        assert spawned[f"align/{mode}"] == [r.score, r.row1.decode(),
                                            r.row2.decode()]
