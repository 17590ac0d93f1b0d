"""Checkpoint / resume for large batch runs (copied from
``aligntools_tpu/utils/checkpoint.py``).

The reference is stateless (runs are one pair, sub-second; SURVEY.md §5);
large TPU batch runs over millions of pairs are not, so the pipeline
processes pairs in chunks and records completion in a JSON manifest next
to the output file. A re-run with the same manifest skips completed chunks
and appends only the remainder.

Crash atomicity: the manifest itself is always written via tmp-file
rename. When the pipeline owns the output file (``run_pipeline(...,
out_path=...)``), it additionally records each chunk's output end byte
offset here and, on resume, truncates the output back to the watermark of
the last completed chunk — so a run killed mid-chunk (or between the chunk
write and ``mark_done``) never leaves a torn or duplicated chunk. With a
caller-provided stream (stdout), only chunk skipping is available; a kill
in the write→mark_done window can re-emit that chunk on resume.
"""

from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass
class Manifest:
    path: str
    input_path: str = ""
    mode: str = ""
    chunk_size: int = 0
    total_pairs: int = 0
    done_chunks: list = dataclasses.field(default_factory=list)
    # chunk index (as str, JSON keys) -> output end byte offset; only
    # populated when the pipeline owns the output file.
    chunk_ends: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def load_or_create(cls, path, input_path, mode, chunk_size, total_pairs):
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            m = cls(path=path, chunk_ends=data.get("chunk_ends", {}),
                    **{k: data[k] for k in (
                        "input_path", "mode", "chunk_size", "total_pairs",
                        "done_chunks")})
            if (m.input_path, m.mode, m.chunk_size, m.total_pairs) != (
                input_path, mode, chunk_size, total_pairs
            ):
                raise ValueError(
                    f"manifest {path} was written for a different run "
                    f"(input/mode/chunking changed); delete it to restart"
                )
            return m
        return cls(
            path=path, input_path=input_path, mode=mode,
            chunk_size=chunk_size, total_pairs=total_pairs,
        )

    def is_done(self, chunk_idx: int) -> bool:
        return chunk_idx in self.done_chunks

    def watermark(self) -> int:
        """Output byte offset at the end of the last completed chunk (0 if
        none recorded); anything past it in the output file is a torn
        chunk and safe to truncate before resuming."""
        ends = [self.chunk_ends.get(str(ci), 0) for ci in self.done_chunks]
        return max(ends, default=0)

    def mark_done(self, chunk_idx: int, end_offset: int | None = None) -> None:
        if chunk_idx not in self.done_chunks:
            self.done_chunks.append(chunk_idx)
        if end_offset is not None:
            self.chunk_ends[str(chunk_idx)] = end_offset
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "input_path": self.input_path,
                    "mode": self.mode,
                    "chunk_size": self.chunk_size,
                    "total_pairs": self.total_pairs,
                    "done_chunks": self.done_chunks,
                    "chunk_ends": self.chunk_ends,
                },
                f,
            )
        os.replace(tmp, self.path)
