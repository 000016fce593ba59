"""SNTP client: universal-time source for cross-device base-time sync.

Port of ``nnstreamer_tpu/edge/ntp.py``, which is framework neutral: a
copy.

≙ gst/mqtt/ntputil.c — the reference queries configured NTP servers
(default pool.ntp.org:123) so that every device stamps its pipeline
base-time against the same clock before embedding it in MQTT headers
(mqttsink.c:89, Documentation/synchronization-in-mqtt-elements.md).

Implements a plain SNTPv4 exchange over UDP: 48-byte request with the
client transmit timestamp, server reply carrying its receive/transmit
timestamps; the offset estimate is the standard
((t1 - t0) + (t2 - t3)) / 2.
"""
from __future__ import annotations

import socket
import struct
import time
from typing import List, Optional, Tuple

from ..utils.log import logger

# seconds between the NTP epoch (1900) and the Unix epoch (1970)
_NTP_DELTA = 2208988800


def _to_ntp(unix_s: float) -> Tuple[int, int]:
    secs = int(unix_s) + _NTP_DELTA
    frac = int((unix_s % 1.0) * (1 << 32))
    return secs, frac


def _from_ntp(secs: int, frac: int) -> float:
    return secs - _NTP_DELTA + frac / (1 << 32)


def query_offset(host: str, port: int = 123,
                 timeout: float = 2.0) -> float:
    """One SNTP exchange; returns the estimated clock offset in seconds
    (add to local unix time to get server time)."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.settimeout(timeout)
        t0 = time.time()
        pkt = bytearray(48)
        pkt[0] = (0 << 6) | (4 << 3) | 3   # LI=0, VN=4, mode=3 (client)
        pkt[40:48] = struct.pack("!II", *_to_ntp(t0))
        s.sendto(bytes(pkt), (host, port))
        data, _ = s.recvfrom(512)
        t3 = time.time()
    if len(data) < 48:
        raise ValueError("short NTP reply")
    t1 = _from_ntp(*struct.unpack("!II", data[32:40]))  # server receive
    t2 = _from_ntp(*struct.unpack("!II", data[40:48]))  # server transmit
    return ((t1 - t0) + (t2 - t3)) / 2.0


def best_offset(servers: str, timeout: float = 2.0) -> float:
    """Try ``host[:port],host[:port],...`` in order; first success wins
    (≙ ntputil.c walking mqtt-ntp-srvs). Returns 0.0 when none answer —
    falling back to the local clock like the reference's non-sync mode."""
    for srv in (s.strip() for s in (servers or "").split(",")):
        if not srv:
            continue
        host, _, port = srv.partition(":")
        try:
            off = query_offset(host, int(port or 123), timeout)
            logger.info("ntp: offset %+.6fs from %s", off, srv)
            return off
        except (OSError, ValueError) as e:
            logger.warning("ntp: %s unreachable (%s)", srv, e)
    return 0.0


def synced_epoch_ns(servers: Optional[str], timeout: float = 2.0) -> int:
    """Universal 'now' in ns: local clock plus NTP offset when servers
    are configured, local clock otherwise."""
    off = best_offset(servers, timeout) if servers else 0.0
    return time.time_ns() + int(off * 1e9)
