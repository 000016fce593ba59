"""Sparse pack/unpack on the card (index+value coding of non-zeros).

Port of ``nnstreamer_tpu/ops/sparse.py``. The JAX package computes these
with a jitted ``jnp`` scatter, not a Pallas kernel, so the port computes
them with ordinary torch ops on the tensor's device (``cumsum``,
``scatter_``); no hand kernel is owed. What makes them device ops is the
contract: a chunk on the card is packed to ``(indices, values, nnz)`` in
device memory, and only ``capacity`` pairs cross to the host instead of
the dense tensor.

Differences from the JAX ops, each with the same result:

* JAX scatters with ``mode="drop"``; torch's ``scatter_`` raises on an
  index out of bounds, so both ops scatter into a buffer one slot longer
  than asked and slice the dump slot off.
* torch's ``uint32`` has few kernels: indices are ``int64`` on the card,
  and :func:`fetch_packed` casts them to ``np.uint32`` on the host after
  the one device-to-host copy, which carries ``nnz`` too.

``packs``, ``unpacks`` and ``pack_d2h_bytes`` count the calls that ran on
the card (and the bytes :func:`fetch_packed` copied back), beside the
hand kernels' launch counts (``_tally.py``): a test hook, reset to 0 to
count a run; not a pipeline statistic.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch

# card runs of pack and unpack, and the bytes fetch_packed brought back
packs = 0
unpacks = 0
pack_d2h_bytes = 0
_count_lock = threading.Lock()


def _count(**deltas: int) -> None:
    global packs, unpacks, pack_d2h_bytes
    with _count_lock:
        packs += deltas.get("packs", 0)
        unpacks += deltas.get("unpacks", 0)
        pack_d2h_bytes += deltas.get("pack_d2h_bytes", 0)


def reset_counts() -> None:
    global packs, unpacks, pack_d2h_bytes
    with _count_lock:
        packs = unpacks = pack_d2h_bytes = 0


_BITS = {torch.float64: torch.int64, torch.float32: torch.int32,
         torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _as_bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's same-width integer view: values are scattered as
    bits, so every NaN payload moves unchanged (torch's CPU scatter of
    bfloat16 rewrites a NaN's bits)."""
    return t.view(_BITS[t.dtype]) if t.dtype in _BITS else t


def pack_reference(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy oracle: (uint32 indices, values) of non-zeros, flat order."""
    flat = arr.reshape(-1)
    idx = np.flatnonzero(flat).astype(np.uint32)
    return idx, flat[idx]


def pack(flat: torch.Tensor, capacity: int
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack the non-zeros of ``flat`` [N] into fixed-size (idx, vals, nnz)
    on the device ``flat`` lies on.

    Returns (idx int64 [capacity], vals [capacity], nnz int64 0-d), all
    on that device. Entries past nnz are zero; if nnz > capacity the
    pairs past capacity are DROPPED, so the caller must check nnz and
    take the host path."""
    flat = flat.reshape(-1)
    nz = flat != 0
    nnz = nz.sum()
    # each non-zero's output slot is its rank among the non-zeros; zeros
    # and ranks past capacity go to the dump slot at index ``capacity``
    slot = torch.cumsum(nz, 0) - 1
    slot = torch.where(nz & (slot < capacity), slot,
                       torch.full_like(slot, capacity))
    n = flat.shape[0]
    idx = torch.zeros(capacity + 1, dtype=torch.int64, device=flat.device)
    idx.scatter_(0, slot, torch.arange(n, dtype=torch.int64,
                                       device=flat.device))
    bits = _as_bits(flat)
    vals = torch.zeros(capacity + 1, dtype=bits.dtype, device=flat.device)
    vals.scatter_(0, slot, bits)
    vals = vals.view(flat.dtype)
    if flat.is_cuda:
        _count(packs=1)
    return idx[:capacity], vals[:capacity], nnz


def fetch_packed(idx: torch.Tensor, vals: torch.Tensor, nnz: torch.Tensor
                 ) -> Tuple[np.ndarray, np.ndarray, int]:
    """:func:`pack`'s result on the host in ONE device-to-host copy:
    (uint32 indices, values as their bytes' numpy dtype, nnz). Values of
    bfloat16 come back as their uint16 bit patterns."""
    cap = idx.shape[0]
    blob = torch.cat([nnz.reshape(1).to(torch.int64).view(torch.uint8),
                      idx.contiguous().view(torch.uint8),
                      vals.contiguous().view(torch.uint8)]).cpu().numpy()
    if idx.is_cuda:
        _count(pack_d2h_bytes=int(blob.nbytes))
    n = int(blob[:8].view(np.int64)[0])
    host_idx = blob[8:8 + 8 * cap].view(np.int64).astype(np.uint32)
    vdt = (np.dtype(np.uint16) if vals.dtype == torch.bfloat16
           else torch.empty((), dtype=vals.dtype).numpy().dtype)
    host_vals = blob[8 + 8 * cap:].view(vdt)
    return host_idx, host_vals, n


def unpack(idx: Union[np.ndarray, torch.Tensor],
           vals: Union[np.ndarray, torch.Tensor], size: int,
           device: Optional[Union[str, torch.device]] = None
           ) -> torch.Tensor:
    """Scatter (idx, vals) back to a dense flat [size] on ``device``
    (default: where ``vals`` lies).

    A slot whose value is zero is routed to the dump slot, as the JAX op
    routes it out of bounds: padded slots (idx 0, val 0) then cannot
    clobber index 0's real value. A real value of -0.0 compares equal to
    0 and is dropped the same way in both (the dense output keeps +0.0
    there)."""
    if isinstance(vals, np.ndarray):
        vals = torch.from_numpy(np.ascontiguousarray(vals))
    if isinstance(idx, np.ndarray):
        idx = torch.from_numpy(idx.astype(np.int64))
    dev = torch.device(device) if device is not None else vals.device
    vals = vals.to(dev)
    idx = idx.to(dev, torch.int64)
    target = torch.where(vals != 0, idx, torch.full_like(idx, size))
    bits = _as_bits(vals)
    out = torch.zeros(size + 1, dtype=bits.dtype, device=dev)
    out.scatter_(0, target, bits)
    if out.is_cuda:
        _count(unpacks=1)
    return out[:size].view(vals.dtype)
