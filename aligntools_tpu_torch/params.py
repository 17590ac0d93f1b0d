"""Scoring parameters and the per-pair result type.

Copied from ``aligntools_tpu/params.py`` (``MODES``, ``AlignParams``) and
``aligntools_tpu/spec/engine.py`` (``AlignResult``): the port imports
nothing of the JAX package. Defaults match the reference's ``opt_t``
(src/alignment.h:102-114).
"""

from __future__ import annotations

import dataclasses

MODES = ("global", "local", "fit", "overlap", "edit")


@dataclasses.dataclass(frozen=True)
class AlignParams:
    """Scoring parameters; defaults match the reference (alignment.h:102-114)."""

    match: int = 1  # opt->m
    mismatch: int = -2  # opt->u
    gap_open: int = -5  # opt->o  (cost of the FIRST gap char, not open+extend)
    gap_extend: int = -1  # opt->e
    jump: int = -10  # opt->j  (fit mode junction jump penalty)

    def replace(self, **kw) -> "AlignParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class AlignResult:
    score: float
    row1: bytes  # gapped query row (reference r1)
    row2: bytes  # gapped target row (reference r2)
