"""Single-pair API: the port's counterpart of ``aligntools_tpu/api.py``.

``align_pair`` aligns one pair and ``align_file`` reads the reference's
two-record FASTA first (alignment.h:503-510); the per-mode CLI
(``aligntools-torch global|local|fit|overlap|edit FILE``) runs on them.
``batch.align_batch`` is the throughput path, and a single pair is a batch
of one: on the card it takes the flat pointer fill and the walk up to
``engine/select.ptr_flat_cap()`` columns and the blocked pointer fill past
them; edit takes its register-strip score fill up to
``select.score_flat_cap("edit")`` columns and the blocked score fill past
that. The results equal the per-pair machines of
``aligntools_tpu/engine/scan.py`` (``scan_align``) field by field.

A pair whose (params x lengths) leave float32's exact integers
(``exact.f32_exact``) runs, on the same route, the double instances of the
same kernels (float64 params, scores and row state; its pointer bytes and
walk as float32's), as the JAX ``align_pair`` sends it to its
double-precision spec engine; the results equal that engine's. The range
test alone picks it: in-range pairs keep the float32 route.

``device`` takes the place of the JAX package's ``engine``: ``"cuda"`` (the
default) or ``"cpu"`` (the kernels' plain versions), through
``backend.resolve_device``, with no fallback. Departure from the JAX
package's ``align_pair``, whose CPU default is its double-precision spec
engine:

  * a pair with an empty side gets ``scan_align``'s result (the borders of
    its per-pair machines), where the spec engine refuses or crashes on
    four of the fifteen cases: local and overlap with an empty target,
    overlap with both empty, fit with an empty query.
"""

from __future__ import annotations

from typing import Sequence

from aligntools_tpu_torch.params import MODES, AlignParams


def align_pair(
    mode: str,
    seq1: bytes,
    seq2: bytes,
    params: AlignParams = AlignParams(),
    sites: Sequence[int] | None = None,
    *,
    device="cuda",
):
    """Align one pair on ``device``; returns an AlignResult with the
    alignment rows, or an int for mode='edit'.

    ``sites`` (fit only): junction positions on seq2. A list, even an empty
    one, turns the jump state on, as the reference's ``-s`` does; sites
    outside the target are ignored."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if sites is not None and mode != "fit":
        raise ValueError("junction sites are only meaningful in fit mode")
    from aligntools_tpu_torch.batch import align_batch
    from aligntools_tpu_torch.exact import f32_exact

    return align_batch(
        mode, [(seq1, seq2)], params,
        [list(sites)] if sites is not None else None,
        traceback=mode != "edit", device=device,
        _f64=not f32_exact(params, len(seq1), len(seq2), mode))[0]


def align_file(
    mode: str,
    path: str,
    params: AlignParams = AlignParams(),
    use_sites: bool = False,
    *,
    device="cuda",
):
    """Read a two-record FASTA/Q (gz ok) and align it, the reference's
    per-subcommand flow. Returns (result, pair)."""
    from aligntools_tpu_torch.io.fasta import read_pair

    pair = read_pair(path, want_sites=use_sites)
    sites = pair.sites if use_sites else None
    return align_pair(mode, pair.seq1, pair.seq2, params, sites,
                      device=device), pair
