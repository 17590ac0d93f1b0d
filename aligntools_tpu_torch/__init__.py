"""aligntools_tpu_torch — the PyTorch / CUDA port of aligntools_tpu.

Every entry point of the JAX package on NVIDIA Hopper GPUs with
hand-written CUDA fills and walk, held bit for bit against the JAX
package: the per-mode commands (``aligntools-torch
global|local|fit|overlap|edit FILE``, on ``align_pair`` / ``align_file``),
the batch path (``aligntools-torch batch MODE FASTA``: alignment rows,
CIGAR or scores, long targets, ``--band`` at any width, ``--sharded``
across ranks, on ``align_batch`` / ``batch_scores``), the request loop
(``aligntools-torch serve``), the card's crossover table
(``aligntools-torch calibrate``), sequence parallelism
(``parallel/seqpar.py``) and the differential campaign
(``tools/validate.py``). Importing this package loads neither torch
nor jax; the entry points load torch on first use.
"""

from aligntools_tpu_torch.params import AlignParams, MODES
from aligntools_tpu_torch.version import __version__

__all__ = ["AlignParams", "MODES", "__version__", "align_batch",
           "align_file", "align_pair", "batch_scores"]


def __getattr__(name):  # lazy: keep `import aligntools_tpu_torch` light
    if name in ("align_batch", "batch_scores"):
        from aligntools_tpu_torch import batch

        return getattr(batch, name)
    if name in ("align_pair", "align_file"):
        from aligntools_tpu_torch import api

        return getattr(api, name)
    raise AttributeError(name)
