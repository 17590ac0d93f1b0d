"""aligntools_tpu_torch — the PyTorch / CUDA port of aligntools_tpu.

The score-only batch path (``aligntools-torch batch MODE FASTA
--scores-only``) on one NVIDIA Hopper GPU, with hand-written CUDA fills
for the global/local, overlap, edit and fit(+jump) score kernels, held bit
for bit against the JAX package. Importing this package loads neither
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
