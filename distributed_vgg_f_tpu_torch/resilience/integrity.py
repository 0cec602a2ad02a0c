"""Checkpoint integrity manifests: per-step checksums, written after a save
is durable and verified before a restore reads the data — an own copy of
the JAX package's ``resilience/integrity.py`` (:1–130), with its manifest
format, so either package verifies the other's manifest of the same
files.

The manager's commit is atomic (a step is written under
`<root>/<step>.tmp-*` and renamed to `<root>/<step>`), so a crash during a
save never leaves a partial step under its final name. What that does not
cover is damage after the commit: a truncated copy, filesystem
corruption, bit rot. Once a step is durable, its manifest records every
file's size and SHA-256 under `<root>/integrity/<step>.json`
(`write_manifest` from hashes the writer took as it wrote the files,
`write_step_manifest` by reading them back); before a restore,
`verify_step_manifest`
re-hashes and compares, so a damaged step is found up front (and
checkpoint/manager.py falls back to the newest intact one).

A step WITHOUT a manifest verifies as `None` (unknown): the crash window
between a step's commit and its manifest stays restorable, vouched for
by the atomic rename.

`integrity/` is a non-numeric sibling of the step dirs, which the step
scan ignores. Under a process group only rank 0 writes; every rank
verifies and reaches the same verdict.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Mapping, Optional

MANIFEST_DIRNAME = "integrity"


def _manifest_dir(root: str) -> str:
    return os.path.join(root, MANIFEST_DIRNAME)


def manifest_path(root: str, step: int) -> str:
    return os.path.join(_manifest_dir(root), f"{int(step)}.json")


def step_dir(root: str, step: int) -> str:
    """The step directory: the bare number under the root."""
    return os.path.join(root, str(int(step)))


def _iter_files(base: str):
    for dirpath, _, filenames in os.walk(base):
        for name in sorted(filenames):
            full = os.path.join(dirpath, name)
            yield os.path.relpath(full, base), full


def step_size_bytes(root: str, step: int) -> int:
    """Total on-disk bytes of a step — a stat walk."""
    return sum(os.path.getsize(full)
               for _, full in _iter_files(step_dir(root, step)))


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_step_manifest(root: str, step: int) -> str:
    """Hash every file under the (already durable) step dir and write the
    manifest (`write_manifest`)."""
    base = step_dir(root, step)
    return write_manifest(
        root, step, {rel: {"size": os.path.getsize(full),
                           "sha256": _sha256(full)}
                     for rel, full in _iter_files(base)})


def write_manifest(root: str, step: int,
                   files: Mapping[str, Mapping]) -> str:
    """Write the manifest of a durable step from `files` ({path relative
    to the step dir: {"size", "sha256"}}) atomically (tmp + rename — a
    crash mid-write must not leave a half manifest that later fails
    verification of a GOOD step)."""
    path = manifest_path(root, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": int(step), "files": dict(files)}, f, indent=1)
    os.replace(tmp, path)
    return path


def verify_step_manifest(root: str, step: int) -> tuple[Optional[bool], str]:
    """(verdict, detail): True = every manifest entry matches on size and
    hash; False = damage found (detail names the first mismatch); None = no
    manifest exists, nothing to verify against (legacy / pre-flush step)."""
    path = manifest_path(root, step)
    if not os.path.exists(path):
        return None, "no manifest"
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"unreadable manifest: {e}"
    base = step_dir(root, step)
    for rel, want in manifest.get("files", {}).items():
        full = os.path.join(base, rel)
        if not os.path.exists(full):
            return False, f"missing file {rel}"
        size = os.path.getsize(full)
        if size != want["size"]:
            return False, (f"size mismatch {rel}: manifest {want['size']} "
                           f"bytes, on disk {size}")
        if _sha256(full) != want["sha256"]:
            return False, f"checksum mismatch {rel}"
    return True, "ok"


def remove_step_manifest(root: str, step: int) -> None:
    try:
        os.remove(manifest_path(root, step))
    except FileNotFoundError:
        pass


def list_manifest_steps(root: str) -> list[int]:
    """Steps that currently have a manifest on disk — used by the manager to
    prune manifests orphaned by its retention, which deletes step dirs
    without passing through this layer."""
    try:
        names = os.listdir(_manifest_dir(root))
    except FileNotFoundError:
        return []
    return sorted(int(n[:-5]) for n in names
                  if n.endswith(".json") and n[:-5].isdigit())
