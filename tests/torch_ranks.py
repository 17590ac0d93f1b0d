"""One rank of a gloo group of CPU processes running the port's parallel
package (no jax here): the workloads of ``__graft_entry__.dryrun_multichip``
on seeded pairs, rank 0 writing every result as JSON.

    python tests/torch_ranks.py OUT.json STORE_FILE RANK WORLD

The group meets on a ``torch.distributed.FileStore`` at STORE_FILE, so that
no port is taken. ``workloads(seed)`` gives the inputs, which the tests
rebuild to run the JAX package on the same pairs. Any failure ends the
whole group through ``distributed.abort_all``.
"""

import datetime
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("global", "local", "overlap", "edit", "fit")
PARAMS = dict(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)


def workloads(seed=29):
    """(sharded pairs, seqpar_batch_scores pairs, one seqpar pair, one
    seqpar_align pair, fit sites of each), made from ``seed``."""
    rng = np.random.default_rng(seed)

    def pair(m_lo, m_hi, n_hi):
        m = int(rng.integers(m_lo, m_hi))
        n = int(rng.integers(m, n_hi))
        return (bytes(rng.choice(list(b"ACGT"), m).tolist()),
                bytes(rng.choice(list(b"ACGT"), n).tolist()))

    sharded = [pair(5, 60, 300) for _ in range(13)]
    batch = [pair(5, 40, 500) for _ in range(5)]
    single = pair(60, 90, 900)
    align = pair(40, 70, 700)
    sites = lambda t, k: sorted(int(x) for x in rng.integers(0, len(t), k))
    return {"sharded": sharded, "batch": batch, "single": single,
            "align": align,
            "sharded_sites": [sites(t, 3) for _, t in sharded],
            "batch_sites": [sites(t, 3) for _, t in batch],
            "single_sites": sites(single[1], 4),
            "align_sites": sites(align[1], 4)}


def main(out, store, rank, world):
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from aligntools_tpu_torch.params import AlignParams
    from aligntools_tpu_torch.parallel import distributed, mesh, seqpar

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        w = workloads()
        p = AlignParams(**PARAMS)
        data = mesh.make_mesh(device="cpu")
        seq = mesh.make_mesh(axis="seq", device="cpu")
        grid = mesh.make_mesh(axis=("data", "seq"), shape=(2, world // 2),
                              device="cpu")
        res = {}
        for mode in MODES + ("fit+sites",):
            mo = mode.split("+")[0]
            sl = (lambda k: w[k] if mode == "fit+sites" else None)
            res[f"sharded/{mode}"] = mesh.batch_scores_sharded(
                mo, w["sharded"], p, data, sl("sharded_sites")).tolist()
            res[f"batch/{mode}"] = seqpar.seqpar_batch_scores(
                mo, w["batch"], p, sl("batch_sites"), grid).tolist()
            res[f"single/{mode}"] = seqpar.seqpar_score(
                mo, *w["single"], p, sl("single_sites"), seq, chunk=32)
            if mo != "edit":
                r = seqpar.seqpar_align(mo, *w["align"], p, sl("align_sites"),
                                        grid, chunk=32)
                res[f"align/{mode}"] = [r.score, r.row1.decode(),
                                        r.row2.decode()]
        got = distributed.gather_to_host0(np.array([rank], np.int64))
        if rank == 0:
            res["ranks"] = got.tolist()
            res["mesh"] = {"data": data.shape, "seq": seq.shape,
                           "grid": grid.shape}
            with open(out, "w") as f:
                json.dump(res, f)
        distributed.barrier("aligntools-done")
    except Exception as err:  # every failure ends the whole job
        distributed.abort_all(err)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
