"""Carry the JAX package's kernel inputs across to the port's tensors."""

from __future__ import annotations

import numpy as np
import torch

from aligntools_tpu_torch.params import AlignParams


def params_matrix(p: AlignParams, device, dtype=torch.float32) -> torch.Tensor:
    """(1, 8) float32 [match, mismatch, gap_open, gap_extend, jump, 0, 0, 0]
    — the kernels' params row, as ``aligntools_tpu/batch.py``
    (``_params_mat_np`` / ``_kernel_widen``) lays it out; ``dtype``
    float64 for the double instances, whose params need not be exact in
    float32 (20,000,001 is not)."""
    row = np.zeros((1, 8), np.float64 if dtype == torch.float64
                   else np.float32)
    row[0, :5] = [p.match, p.mismatch, p.gap_open, p.gap_extend, p.jump]
    return torch.from_numpy(row).to(device)


def kernel_inputs_from_numpy(qs, ts, allow, ns, ms, pmat, device):
    """(qs, ts, allow, ns, ms, pmat) as the numpy arrays the JAX entry
    points take -> the same values as the port's tensors on ``device``
    (``allow`` may be None)."""
    def put(a, dtype):
        if a is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return (put(qs, np.int32), put(ts, np.int32), put(allow, np.float32),
            put(ns, np.int32), put(ms, np.int32), put(pmat, np.float32))
