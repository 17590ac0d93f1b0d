"""FASTA/FASTQ ingest: a kseq-equivalent streaming parser.

Copied from ``aligntools_tpu/io/fasta.py`` (records, the junction-site
parse, the pure-Python parser and the single-pair reader ``read_pair``). It
mirrors the klib parser the reference uses (src/kseq.h over gzread):

  * records start at '>' (FASTA) or '@' (FASTQ); multi-line sequences are
    concatenated; empty lines inside a record are skipped;
  * the header splits at the FIRST whitespace char into name and comment,
    a trailing '\\r' stripped;
  * a FASTQ '+' line is skipped and quality is read up to the sequence's
    length;
  * gzip is transparent;
  * ``read_pair`` keeps the reference's pair contract (alignment.h:217-262):
    exactly two records, junction sites from the second one's comment.

A file that cannot be opened raises ``OSError``: ``cannot open PATH`` from
the C++ parser, Python's own message from the pure-Python one, as in the
JAX package (the C reference prints ``Can't open PATH``).

``read_records`` takes the C++ parser of ``native/aligntools_native.cpp``
(``aligntools_tpu_torch.native``) when it builds, and this module's parser
otherwise.
"""

from __future__ import annotations

import dataclasses
import gzip
import io as _io
from typing import Iterator, Sequence

_WS = b" \t\n\v\f\r"  # C isspace set


@dataclasses.dataclass
class FastaRecord:
    name: bytes
    comment: bytes | None
    seq: bytes
    qual: bytes | None = None


def _open_maybe_gzip(path: str) -> _io.BufferedReader:
    f = open(path, "rb")
    magic = f.peek(2)[:2] if hasattr(f, "peek") else f.read(2)
    if magic == b"\x1f\x8b":
        f.close()
        return gzip.open(path, "rb")  # type: ignore[return-value]
    return f


def _split_header(line: bytes) -> tuple[bytes, bytes | None]:
    """Split a header line body (without the '>'/'@') into name/comment at the
    first isspace char; comment is None when the separator was the newline."""
    for i, b in enumerate(line):
        if b in _WS:
            return line[:i], line[i + 1 :]
    return line, None


def read_records(path: str) -> Iterator[FastaRecord]:
    from aligntools_tpu_torch import native

    recs = native.parse_records_native(path)
    if recs is not None:
        yield from recs
        return
    with _open_maybe_gzip(path) as f:
        yield from parse_records(f)


def parse_records(f) -> Iterator[FastaRecord]:
    name = comment = None
    seq_parts: list[bytes] = []
    lines = iter(f)
    line = next(lines, None)
    # skip junk before the first record (kseq.h:194 scans to '>'/'@')
    while line is not None and not line.startswith((b">", b"@")):
        line = next(lines, None)
    while line is not None:
        body = line.rstrip(b"\n")
        if body.endswith(b"\r"):
            body = body[:-1]
        fastq = body.startswith(b"@")
        name, comment = _split_header(body[1:])
        seq_parts = []
        qual = None
        line = next(lines, None)
        while line is not None and not line.startswith((b">", b"@", b"+")):
            part = line.rstrip(b"\n")
            if part.endswith(b"\r"):
                part = part[:-1]
            if part:
                seq_parts.append(part)
            line = next(lines, None)
        seq = b"".join(seq_parts)
        if fastq and line is not None and line.startswith(b"+"):
            # skip '+' line, then read quality until it reaches len(seq)
            line = next(lines, None)
            qparts: list[bytes] = []
            qlen = 0
            while line is not None and qlen < len(seq):
                part = line.rstrip(b"\n")
                if part.endswith(b"\r"):
                    part = part[:-1]
                qparts.append(part)
                qlen += len(part)
                line = next(lines, None)
            qual = b"".join(qparts)
        yield FastaRecord(name=name, comment=comment, seq=seq, qual=qual)


def c_atoi(s: bytes) -> int:
    """C atoi: skip leading whitespace, optional sign, digits; 0 on no-parse."""
    i = 0
    while i < len(s) and s[i] in _WS:
        i += 1
    sign = 1
    if i < len(s) and s[i : i + 1] in (b"+", b"-"):
        sign = -1 if s[i : i + 1] == b"-" else 1
        i += 1
    j = i
    while j < len(s) and 0x30 <= s[j] <= 0x39:
        j += 1
    return sign * int(s[i:j]) if j > i else 0


def parse_junctions(comment: bytes) -> list[int]:
    """ksplit(tmp, '|') + atoi per field (alignment.h:250-253). ksplit skips
    empty fields (consecutive delimiters produce no field: kstring.c:120-125)."""
    return [c_atoi(tok) for tok in comment.split(b"|") if tok != b""]


@dataclasses.dataclass
class Pair:
    seq1: bytes
    seq2: bytes
    sites: list[int] | None  # parsed junctions (only when requested)
    comment2: bytes | None  # raw second-record comment (echoed by fit -s)


def read_pair(path: str, want_sites: bool = False) -> Pair:
    """kstring_read equivalent (alignment.h:217-262): exactly 2 records."""
    records: list[FastaRecord] = []
    for rec in read_records(path):
        if len(records) >= 2:
            raise ValueError("input fasta file has more than 2 sequences")  # :233
        records.append(rec)
    if len(records) < 2 or records[0].seq == b"" or records[1].seq == b"":
        # the reference dies on NULL seq pointers (:239); empty sequences
        # pass, as in the JAX package, and take the engines' borders
        if len(records) < 2:
            raise ValueError("read_kstring: fail to read sequence")
    sites = None
    comment2 = records[1].comment
    if want_sites:
        if comment2 is None:
            raise ValueError("fail to read junction sites")  # :244
        sites = parse_junctions(comment2)
    return Pair(records[0].seq, records[1].seq, sites, comment2)


def read_pairs_many(paths: Sequence[str]) -> list[Pair]:
    return [read_pair(p) for p in paths]
