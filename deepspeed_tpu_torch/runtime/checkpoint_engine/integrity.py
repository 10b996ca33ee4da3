"""Checkpoint integrity: per-leaf checksum manifests + atomic commit
markers (counterpart of ``deepspeed_tpu/runtime/checkpoint_engine/integrity.py``,
copied; the leaves may be torch tensors as well as numpy arrays).

A checkpoint directory written by the engine carries three sidecar files
next to the arrays:

- ``ds_metadata.json`` — step counters / LR-scheduler state / client
  state, written strictly AFTER the arrays are durable.
- ``ds_manifest.json`` — one entry per state-tree leaf: CRC32 of the
  host bytes, dtype, shape. Load recomputes and compares, so silent
  array corruption (a torn file, a bad byte on the wire) is caught
  before training resumes on garbage.
- ``ds_commit.json`` — the atomic commit marker, placed LAST via
  tmp+``os.replace``. Its presence is the durability contract: a tag
  without it is torn (the writer died mid-commit) and
  ``load_checkpoint`` refuses it, falling back to the previous good tag.

numpy has no bfloat16: a bf16 tensor's CRC is taken over its raw 16-bit
words (C-contiguous) and its entry reads ``"bfloat16"``, which is what the
reference writes for an ``ml_dtypes`` bf16 array of the same bits. The
same bits therefore give the same manifest entry in both packages.
"""

import json
import os
import re
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

MANIFEST_FILE = "ds_manifest.json"
COMMIT_MARKER = "ds_commit.json"
METADATA_FILE = "ds_metadata.json"
_TAG_RE = re.compile(r"^global_step(\d+)$")


class TornCheckpointError(RuntimeError):
    """The checkpoint tag is torn: its commit marker is missing (the
    writer died between the array commit and the marker placement) or a
    leaf's bytes no longer match the manifest. Resuming from it would
    silently train on corrupt or half-written state — refuse and fall
    back to the previous good tag."""


def host_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf's C-contiguous host bytes as a numpy array, and its dtype's
    name. A device tensor is copied to the host; a bf16 tensor comes back
    as its raw 16-bit words under the name ``"bfloat16"``."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    if not a.flags.c_contiguous:  # (ascontiguousarray would make a 0-d array 1-d)
        a = np.ascontiguousarray(a)
    return a, str(a.dtype)


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(a.reshape(-1).view(np.uint8)) & 0xFFFFFFFF


def leaf_crc(arr) -> int:
    """CRC32 of a leaf's host bytes (canonical C-contiguous layout)."""
    return _crc(host_array(arr)[0])


def manifest_entry(arr) -> dict:
    """One leaf's manifest entry: CRC32 of its host bytes, dtype, shape."""
    a, dtype = host_array(arr)
    return {"crc32": _crc(a), "dtype": dtype, "shape": list(a.shape)}


def manifest_of(entries: Dict[str, dict]) -> dict:
    """The manifest of ``{key: manifest_entry(leaf)}``."""
    return {"version": 1, "leaf_count": len(entries), "leaves": dict(entries)}


def manifest_from_leaves(named_leaves: Iterable[Tuple[str, object]]) -> dict:
    """Build the per-leaf manifest from ``(key, host_leaf)`` pairs (an
    iterator is consumed one leaf at a time)."""
    return manifest_of({key: manifest_entry(arr) for key, arr in named_leaves})


def verify_leaves(named_leaves: Iterable[Tuple[str, object]],
                  manifest: dict) -> List[str]:
    """Compare restored leaves against a manifest; returns human-readable
    mismatch descriptions (empty list = intact). Leaves absent from
    either side are mismatches too — a dropped optimizer moment is as
    fatal as a flipped bit."""
    expected = dict(manifest.get("leaves", {}))
    problems = []
    for key, arr in named_leaves:
        want = expected.pop(key, None)
        if want is None:
            problems.append(f"unexpected leaf {key!r} (not in manifest)")
            continue
        got = leaf_crc(arr)
        if got != int(want["crc32"]):
            problems.append(
                f"leaf {key!r} checksum mismatch: "
                f"manifest {want['crc32']:#010x}, restored {got:#010x}")
    for key in expected:
        problems.append(f"missing leaf {key!r} (in manifest, not restored)")
    return problems


def write_json_atomic(path: str, obj: dict):
    """tmp + ``os.replace``: readers see the old content or the new,
    never a half-written file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(obj, fh, default=str)
    os.replace(tmp, path)


def write_commit_marker(path: str, extra: Optional[dict] = None):
    """Place the commit marker for checkpoint directory ``path`` —
    atomically, and only call this once everything else is durable."""
    marker = {"committed": True, "tag": os.path.basename(path)}
    if extra:
        marker.update(extra)
    write_json_atomic(os.path.join(path, COMMIT_MARKER), marker)


def is_committed(path: str) -> bool:
    """True iff checkpoint directory ``path`` carries a commit marker."""
    return os.path.exists(os.path.join(path, COMMIT_MARKER))


def read_manifest(path: str) -> Optional[dict]:
    """The tag's ``ds_manifest.json``, or None when the save disabled
    manifests (``checkpoint.integrity_manifest``)."""
    mpath = os.path.join(path, MANIFEST_FILE)
    if not os.path.exists(mpath):
        return None
    with open(mpath) as fh:
        return json.load(fh)


def tag_step(tag: str) -> Optional[int]:
    """The step a ``global_step<N>`` tag names, or None for foreign tags."""
    m = _TAG_RE.match(tag)
    return int(m.group(1)) if m else None


def scan_tags(save_dir: str) -> List[Tuple[int, str, bool]]:
    """Every ``global_step<N>`` tag under ``save_dir`` as
    ``(step, tag, committed)``, newest first — the restore-candidate
    order the fallback ladder walks."""
    if not os.path.isdir(save_dir):
        return []
    out = []
    for name in os.listdir(save_dir):
        step = tag_step(name)
        if step is None or not os.path.isdir(os.path.join(save_dir, name)):
            continue
        out.append((step, name, is_committed(os.path.join(save_dir, name))))
    out.sort(key=lambda t: t[0], reverse=True)
    return out


def latest_committed_tag(save_dir: str) -> Optional[str]:
    """Newest tag whose commit marker is present, or None."""
    for _step, tag, committed in scan_tags(save_dir):
        if committed:
            return tag
    return None
