"""CIGAR emission from gapped alignment rows (copied from
``aligntools_tpu/utils/cigar.py``).

The reference prints two gapped row strings (alignment.h:509-510); for
pipeline/serving consumers a compact CIGAR is the standard exchange form
(BASELINE.json's north star names CIGAR gather explicitly). Ops follow
SAM conventions over the row pair:

  M  both rows have a residue (match or mismatch — '=' /'X' split by
     byte equality available via ``extended=True``)
  I  row1 (query) has a residue, row2 (target) a gap
  D  row1 has a gap, row2 a residue

Runs are length-encoded. Empty alignments give an empty string.
"""

from __future__ import annotations


def rows_to_cigar(row1: bytes, row2: bytes, extended: bool = False) -> str:
    """Length-encoded CIGAR for a pair of equal-length gapped rows."""
    if len(row1) != len(row2):
        raise ValueError("alignment rows differ in length")
    out: list[str] = []
    run_op = ""
    run_len = 0
    gap = ord("-")
    for a, b in zip(row1, row2):
        if a != gap and b != gap:
            op = ("=" if a == b else "X") if extended else "M"
        elif b == gap:
            op = "I"
        elif a == gap:
            op = "D"
        else:  # both gaps cannot occur in a valid traceback
            raise ValueError("gap aligned to gap")
        if op == run_op:
            run_len += 1
        else:
            if run_len:
                out.append(f"{run_len}{run_op}")
            run_op, run_len = op, 1
    if run_len:
        out.append(f"{run_len}{run_op}")
    return "".join(out)
