"""Multi-device execution on torch.distributed: the mesh, and batch data
parallelism.

Port of ``aligntools_tpu/parallel/mesh.py``. A ``Mesh`` is this rank's
view of the process group laid out on one or two named axes (``data``,
and ``seq`` for sequence parallelism, ``parallel/seqpar.py``): the axis
sizes, this rank's coordinates, its device, the process group along each
axis, and the backend. Ranks are laid out row-major, as the JAX package's
``Mesh(devices.reshape(2, -1), ("data", "seq"))`` lays out its devices:
rank = data coordinate * seq size + seq coordinate.

``batch_scores_sharded`` splits the pairs into contiguous equal shards
over the ``data`` axis, as ``P("data")`` does; each rank scores its shard
on its device with the port's own ``batch.batch_scores`` (its own
bucketing and routes: no one max-length bucket, which the JAX package
builds for XLA's compile keys), and the ranks ``all_gather`` the scores,
so that every rank returns the whole array, as the JAX replicated
``out_specs=P()`` does.

Without torchrun's environment (and no group started), ``make_mesh``
starts a one-rank group on a ``torch.distributed.HashStore``, so that the
same code runs at one rank and at D ranks. The backend is NCCL for a CUDA
device and gloo for the CPU, unless the caller names one (gloo on CUDA
tensors moves them through host memory); a mesh never switches backend on
its own.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from aligntools_tpu_torch.params import AlignParams
from aligntools_tpu_torch.parallel import distributed


@dataclasses.dataclass
class Mesh:
    axes: tuple  # axis names, outermost first
    shape: dict  # axis -> size
    coords: dict  # axis -> this rank's coordinate
    rank: int
    device: torch.device
    backend: str
    groups: dict  # axis -> the process group of this rank's line along it
    ranks: dict  # axis -> that line's global ranks, in coordinate order

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in self.axes]))

    def comm_device(self) -> torch.device:
        """Where this mesh's collectives take their tensors: the card under
        NCCL, host memory under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


_meshes: dict = {}


def _start_group(device, backend) -> None:
    """A group for this process: torchrun's (init_multihost), else one
    rank on a HashStore."""
    if distributed.is_multihost():
        distributed.init_multihost(device=device, backend=backend)
        return
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, **kwargs)


def make_mesh(n_devices: int | None = None, axis="data", *, device,
              backend: str | None = None, shape=None) -> Mesh:
    """This rank's mesh over every rank of the group (started here when
    none is). ``axis``: one name, or two (outer, inner) with ``shape``
    their sizes (default ``(2, world // 2)``, the JAX seqpar default).
    ``n_devices``, where given, must be the group's size."""
    device = distributed.local_device(device)
    backend = backend or distributed.default_backend(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}: nccl or gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if not dist.is_initialized():
        _start_group(device, backend)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices over a group of "
                         f"{world} ranks")
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(axes) == 1:
        sizes = (world,)
    elif len(axes) == 2:
        sizes = tuple(shape) if shape is not None else (2, world // 2)
    else:
        raise ValueError(f"a mesh has one or two axes, not {axes}")
    if int(np.prod(sizes)) != world or min(sizes) < 1:
        raise ValueError(f"mesh shape {sizes} does not cover {world} ranks")
    key = (axes, sizes, device, backend)
    if key in _meshes:
        return _meshes[key]
    r = dist.get_rank()
    coords = dict(zip(axes, np.unravel_index(r, sizes)))
    coords = {a: int(c) for a, c in coords.items()}
    grid = np.arange(world).reshape(sizes)
    groups, ranks = {}, {}
    for k, a in enumerate(axes):
        # every rank creates every line's group, in the same order
        lines = np.moveaxis(grid, k, -1).reshape(-1, sizes[k])
        for line in lines:
            line = [int(x) for x in line]
            g = (dist.group.WORLD if len(line) == world
                 else dist.new_group(line))
            if r in line:
                groups[a], ranks[a] = g, line
    mesh = Mesh(axes, dict(zip(axes, sizes)), coords, r, device, backend,
                groups, ranks)
    _meshes[key] = mesh
    return mesh


def all_gather_rows(mesh: Mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """The (k, ...) tensors of every rank along ``axis``, concatenated in
    coordinate order, on this rank's comm device."""
    x = x.to(mesh.comm_device()).contiguous()
    if mesh.shape[axis] == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x, group=mesh.groups[axis])
    return torch.cat(parts)


def batch_scores_sharded(
    mode: str,
    pairs: Sequence[tuple[bytes, bytes]],
    params: AlignParams = AlignParams(),
    mesh: Mesh | None = None,
    sites_list: Sequence[Sequence[int] | None] | None = None,
    *,
    device="cuda",
) -> np.ndarray:
    """Data-parallel score-only batch over the mesh's ``data`` axis:
    contiguous equal shards (the count padded to a multiple of the axis),
    each scored by ``batch.batch_scores`` on its rank's device, then
    gathered so that every rank returns all B scores (float32, exact
    below float32's integer range, as the JAX scores are; int64 for
    edit). ``sites_list`` (fit): per-pair junction sites, the jump state
    on. ``device`` makes the mesh when none is given."""
    from aligntools_tpu_torch.batch import batch_scores
    from aligntools_tpu_torch.exact import check_f32_exact

    # every rank refuses what align_batch would refuse on any shard, before
    # any collective, so that no rank waits on one that raised
    if mode == "fit" and any(len(q) > len(t) for q, t in pairs):
        raise ValueError("first sequence must be shorter than the second")
    if pairs:
        q, t = max(pairs, key=lambda pr: len(pr[0]) + len(pr[1]))
        check_f32_exact(params, len(q), len(t), mode)
    if mesh is None:
        mesh = make_mesh(device=device)
    B = len(pairs)
    dtype = torch.int64 if mode == "edit" else torch.float32
    if B == 0:
        return np.zeros(0, np.int64 if mode == "edit" else np.float32)
    d, idx = mesh.shape["data"], mesh.coords["data"]
    per = -(-B // d)
    lo, hi = min(B, idx * per), min(B, (idx + 1) * per)
    sites = None if sites_list is None else list(sites_list[lo:hi])
    local = np.zeros(per, np.int64 if mode == "edit" else np.float32)
    if hi > lo:
        local[: hi - lo] = batch_scores(mode, list(pairs[lo:hi]), params,
                                        sites, device=mesh.device)
    out = all_gather_rows(mesh, "data", torch.from_numpy(local).to(dtype))
    return out.cpu().numpy()[:B]
