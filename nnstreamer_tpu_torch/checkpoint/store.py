"""Crash-consistent snapshot store for pipeline checkpoints.

A copy of ``nnstreamer_tpu/checkpoint/store.py``, which is framework
neutral; the manifest it writes is byte for byte the JAX package's, so
either package's ``SnapshotStore.verify`` accepts the other's snapshots.

Layout (one snapshot = one directory, atomically published)::

    <root>/
      snap-00000007/
        MANIFEST.json          # version, seq, meta, per-file sha256+size
        elements/<name>.blob   # pickled element state dict
        elements/<name>.d/...  # optional per-element scratch files
                               # (e.g. the trainer's params state_dict)

Crash consistency: a snapshot is written into a ``.tmp-*`` sibling,
every file is hashed into the manifest, the manifest is fsynced, and
the directory is published with a single :func:`os.replace` — a
reader either sees a complete, self-verifying snapshot or nothing.
A crash mid-write leaves only a ``.tmp-*`` directory, which the next
writer sweeps.

Integrity: :meth:`SnapshotStore.verify` re-hashes every manifest
entry; a truncated blob or tampered manifest raises
:class:`SnapshotError` carrying ``.blob`` — the relative path of the
offending file — so a restore can *name* what it rejected instead of
silently proceeding with partial state.

Retention: ``retain`` newest snapshots survive ``save()``; older
ones are garbage-collected (oldest first).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Callable, Dict, List, Optional

MANIFEST = "MANIFEST.json"
FORMAT_VERSION = 1
_SNAP_RE = re.compile(r"^snap-(\d{8})$")


class SnapshotError(RuntimeError):
    """A snapshot failed verification. ``blob`` names the offending
    file (relative to the snapshot directory) — ``MANIFEST.json`` when
    the manifest itself is missing or tampered."""

    def __init__(self, message: str, blob: Optional[str] = None):
        super().__init__(message)
        self.blob = blob


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _walk_rel(root: str) -> List[str]:
    out: List[str] = []
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            out.append(os.path.relpath(os.path.join(dirpath, fn), root))
    return sorted(out)


class SnapshotStore:
    """Retain-N crash-consistent snapshot directory manager."""

    def __init__(self, root: str, retain: int = 3):
        self.root = root
        self.retain = max(1, int(retain))

    # -- write -------------------------------------------------------------
    def save(self, writer: Callable[[str], None],
             meta: Optional[Dict] = None) -> str:
        """Run ``writer(tmp_dir)`` to populate a fresh snapshot, seal it
        with a hashed manifest, and publish it atomically. Returns the
        final snapshot directory path."""
        os.makedirs(self.root, exist_ok=True)
        self._sweep_tmp()
        seq = self._next_seq()
        tmp = os.path.join(self.root, f".tmp-snap-{seq:08d}-{os.getpid()}")
        os.makedirs(tmp)
        try:
            writer(tmp)
            files = {rel: {"sha256": _sha256(os.path.join(tmp, rel)),
                           "size": os.path.getsize(os.path.join(tmp, rel))}
                     for rel in _walk_rel(tmp) if rel != MANIFEST}
            manifest = {"version": FORMAT_VERSION, "seq": seq,
                        "meta": dict(meta or {}), "files": files}
            mpath = os.path.join(tmp, MANIFEST)
            with open(mpath, "w", encoding="utf-8") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            final = os.path.join(self.root, f"snap-{seq:08d}")
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    # -- read --------------------------------------------------------------
    def snapshots(self) -> List[str]:
        """Published snapshot directories, oldest first."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        snaps = sorted(n for n in names if _SNAP_RE.match(n))
        return [os.path.join(self.root, n) for n in snaps]

    def latest(self) -> Optional[str]:
        snaps = self.snapshots()
        return snaps[-1] if snaps else None

    @staticmethod
    def verify(snap_dir: str) -> Dict:
        """Re-hash every manifest entry; return the parsed manifest.
        Raises :class:`SnapshotError` (with ``.blob``) on any missing,
        truncated, or tampered file — never a silent partial pass."""
        mpath = os.path.join(snap_dir, MANIFEST)
        try:
            with open(mpath, "r", encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError) as exc:
            raise SnapshotError(
                f"snapshot manifest unreadable: {mpath}: {exc}",
                blob=MANIFEST) from exc
        if (not isinstance(manifest, dict)
                or manifest.get("version") != FORMAT_VERSION
                or not isinstance(manifest.get("files"), dict)):
            raise SnapshotError(
                f"snapshot manifest malformed or wrong version: {mpath}",
                blob=MANIFEST)
        for rel, ent in sorted(manifest["files"].items()):
            path = os.path.join(snap_dir, rel)
            try:
                size = os.path.getsize(path)
            except OSError as exc:
                raise SnapshotError(
                    f"snapshot blob missing: {rel}", blob=rel) from exc
            if size != ent.get("size"):
                raise SnapshotError(
                    f"snapshot blob truncated: {rel} "
                    f"({size} != {ent.get('size')} bytes)", blob=rel)
            if _sha256(path) != ent.get("sha256"):
                raise SnapshotError(
                    f"snapshot blob corrupt: {rel} (sha256 mismatch)",
                    blob=rel)
        return manifest

    # -- housekeeping ------------------------------------------------------
    def _next_seq(self) -> int:
        last = 0
        for path in self.snapshots():
            m = _SNAP_RE.match(os.path.basename(path))
            if m:
                last = max(last, int(m.group(1)))
        return last + 1

    def _gc(self) -> None:
        snaps = self.snapshots()
        for path in snaps[:-self.retain]:
            shutil.rmtree(path, ignore_errors=True)

    def _sweep_tmp(self) -> None:
        # a crash mid-save leaves .tmp-* orphans; they are never visible
        # to readers, so sweeping them is always safe
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for n in names:
            if n.startswith(".tmp-snap-"):
                shutil.rmtree(os.path.join(self.root, n),
                              ignore_errors=True)
