"""Hardware capability probe.

Port of ``nnstreamer_tpu/utils/hw.py`` (≙ gst/nnstreamer/hw_accel.c:
NEON/SIMD detection via getauxval) over ``torch.cuda``: the CUDA cards
(name, index, memory and power limit) beside the host's SIMD flags from
/proc/cpuinfo, and the published peak rates that a roofline share is
taken against. The peak tables name NVIDIA's data-sheet figures for the
cards the port is measured on; an unknown card gets None, so no caller
makes up a utilisation from a guess.
"""
from __future__ import annotations

import functools
import subprocess
from typing import Any, Dict, List, Optional

import torch


@functools.lru_cache(maxsize=1)
def cpu_simd_flags() -> List[str]:
    """Host vector-ISA flags (≙ accl_available neon/sse checks)."""
    wanted = {"neon", "asimd", "sse", "sse2", "sse4_1", "sse4_2",
              "avx", "avx2", "avx512f", "amx_tile"}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith(("flags", "features")):
                    present = set(line.split(":", 1)[1].split())
                    return sorted(wanted & present)
    except OSError:
        pass
    return []


def _power_limits() -> List[str]:
    """``nvidia-smi``'s power limit per card, in index order ([] where
    the tool is missing or fails: the limit is reported, not needed)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]


def accelerators() -> List[Dict[str, Any]]:
    """One entry per CUDA card: index, name, memory in use and in total
    (bytes), and the power limit ``nvidia-smi`` reports ("" when it
    cannot say). Empty on a host without CUDA."""
    if not torch.cuda.is_available():
        return []
    limits = _power_limits()
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out.append({
            "id": i,
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(i),
            "memory": {"bytes_in_use": total - free, "bytes_limit": total},
            "power_limit": limits[i] if i < len(limits) else "",
        })
    return out


def capabilities() -> Dict[str, Any]:
    """Full probe result: the cards (none on a CPU-only host, where the
    default platform is ``cpu``) and the host's SIMD flags."""
    accs = accelerators()
    return {
        "accelerators": accs,
        "num_devices": len(accs),
        "default_platform": accs[0]["platform"] if accs else "cpu",
        "cpu_simd": cpu_simd_flags(),
    }


# NVIDIA's data sheet, H100 SXM5 (the 80 GB HBM3 part), dense rates at
# the full 700 W limit: 989 TFLOP/s in bf16 and 3.35 TB/s of HBM. The
# key is a substring of torch.cuda.get_device_name(); first match wins.
_PEAK_BF16_TFLOPS = (("H100 80GB HBM3", 989.0), ("H100 SXM", 989.0))
_PEAK_HBM_GBPS = (("H100 80GB HBM3", 3350.0), ("H100 SXM", 3350.0))


def _match_peak(table, device, scale: float) -> Optional[float]:
    """The table's entry for ``device`` (a torch device, an index or
    None for card 0), or None on the CPU or for an unknown card."""
    if isinstance(device, torch.device):
        if device.type != "cuda":
            return None
        device = device.index
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0 if device is None else device)
    for sub, value in table:
        if sub in name:
            return value * scale
    return None


def peak_flops(device=None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of ``device`` (default: card 0), or None
    when the card is unknown or there is none."""
    return _match_peak(_PEAK_BF16_TFLOPS, device, 1e12)


def peak_membw(device=None) -> Optional[float]:
    """Peak device-memory bytes/s of ``device`` (default: card 0), or
    None when the card is unknown or there is none."""
    return _match_peak(_PEAK_HBM_GBPS, device, 1e9)


def is_available(kind: str) -> bool:
    """CHECK_HW_AVAILABILITY answer: is an accelerator of this kind
    (``gpu``/``cuda``/``cpu``/``default``) usable?"""
    kind = (kind or "default").lower()
    if kind in ("default", "any", "cpu"):
        return True
    if kind in ("gpu", "cuda"):
        return torch.cuda.is_available()
    return any(kind in a["kind"].lower() for a in accelerators())
