"""Per-tile change energy for the temporal-delta gate (tensor_delta).

Port of ``nnstreamer_tpu/ops/delta.py``. The detector needs one number
per ``tile x tile`` block: the mean absolute difference between the
current frame and the reference, channels already collapsed. The JAX
package computes it with a jitted ``jnp`` reshape and mean, not a Pallas
kernel, so the port computes it with the same torch ops on the frame's
device; no hand kernel is owed. Inputs are 2-D with dims that are
multiples of ``tile``; the caller (``elements/delta.py``) owns the
padding.

The mean reduces in another order than XLA:CPU's, so energies agree
with the JAX op within float32 rounding, not bit for bit.

``runs`` counts the calls that ran on the card: a test hook beside the
hand kernels' launch counts (``_tally.py``), reset to 0 to count a run.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

runs = 0
_count_lock = threading.Lock()


def tile_error_reference(cur: np.ndarray, ref: np.ndarray,
                         tile: int) -> np.ndarray:
    """NumPy oracle: (H/t, W/t) mean-abs-diff per tile. ``cur``/``ref``
    are 2-D with dims that are multiples of ``tile``."""
    h, w = cur.shape
    d = np.abs(cur.astype(np.float32) - ref.astype(np.float32))
    return d.reshape(h // tile, tile, w // tile, tile).mean(axis=(1, 3))


def tile_error(cur: torch.Tensor, ref: torch.Tensor, tile: int
               ) -> torch.Tensor:
    """Device twin of :func:`tile_error_reference`: the frames stay where
    they lie; only the (H/t, W/t) grid has to cross to the host."""
    global runs
    h, w = cur.shape
    d = (cur.to(torch.float32) - ref.to(torch.float32)).abs()
    out = d.reshape(h // tile, tile, w // tile, tile).mean(dim=(1, 3))
    if out.is_cuda:
        with _count_lock:
            runs += 1
    return out
