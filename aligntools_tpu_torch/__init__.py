"""aligntools_tpu_torch — the PyTorch / CUDA port of aligntools_tpu.

The batch path (``aligntools-torch batch MODE FASTA``: alignment rows,
CIGAR or scores, long targets, ``--band``) on one NVIDIA Hopper GPU, with
hand-written CUDA fills and walk, held bit for bit against the JAX
package. Importing this package loads neither
torch nor jax; ``align_batch`` / ``batch_scores`` load torch on first use.
"""

from aligntools_tpu_torch.params import AlignParams, MODES
from aligntools_tpu_torch.version import __version__

__all__ = ["AlignParams", "MODES", "__version__", "align_batch",
           "batch_scores"]


def __getattr__(name):  # lazy: keep `import aligntools_tpu_torch` light
    if name in ("align_batch", "batch_scores"):
        from aligntools_tpu_torch import batch

        return getattr(batch, name)
    raise AttributeError(name)
