"""The port's checkpoint writer, in place of the reference's Orbax engine
(``deepspeed_tpu/runtime/checkpoint_engine/orbax_checkpoint_engine.py``).

On-disk format of a tag directory: ``arrays/`` holds one file per leaf of
the state tree, the leaf's whole logical tensor as raw C-contiguous bytes
(never rank-shaped), and ``arrays/index.json`` maps each leaf's key to its
file, dtype and shape (``numpy.fromfile(...).view(dtype).reshape(shape)``
reads one back; bf16 is stored as its raw 16-bit words). Beside them sit
the integrity sidecars (``integrity.py``): metadata, manifest and, last,
the commit marker. A load lands each leaf on its template's device and in
its template's dtype.

Leaves are named as the reference's ``jax.tree_util.keystr`` names the same
leaf of the same tree: ``['params']['layers'][0]['attn']['wqkv']`` for a
dict key and a list index, ``['scale_state'].scale`` for a NamedTuple
field; dict keys are walked in sorted order, as jax flattens them.

Ranks that save one tag together share a :class:`CommitGroup`: the world's
rank 0 writes every leaf, as each is assembled from the ranks' blocks (the
leaves may come from an iterator that runs collectives as it is consumed,
so every rank consumes its own), and the tag is committed only when every
rank agrees over the control channel, after each has run the pre-commit
window: then rank 0 places the marker, and no rank goes on before it is
placed. A load needs no collective: the tag lies on a filesystem every rank
sees, and each rank reads the leaf files it needs (memory-mapped).
"""

import atexit
import collections
import json
import os
import re
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime.checkpoint_engine import integrity
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import CheckpointEngine
from deepspeed_tpu_torch.runtime.checkpoint_engine.integrity import TornCheckpointError
from deepspeed_tpu_torch.utils import not_ported
from deepspeed_tpu_torch.utils.logging import logger

ARRAYS_DIR = "arrays"
INDEX_FILE = "index.json"
_WRITERS = 8


def tree_items(tree, prefix=""):
    """``(key, leaf)`` for every leaf of a nested dict / list / NamedTuple
    tree, keys spelled as ``jax.tree_util.keystr`` spells them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from tree_items(getattr(tree, name), f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def tree_map_with_keys(fn, tree, prefix=""):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``; the same
    containers, keys as :func:`tree_items` gives them."""
    if isinstance(tree, dict):
        return {k: tree_map_with_keys(fn, v, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_keys(fn, getattr(tree, n), f"{prefix}.{n}")
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_keys(fn, v, f"{prefix}[{i}]") for i, v in enumerate(tree))
    return fn(prefix, tree)


def named_host_leaves(tree):
    """``(key, host_leaf)`` pairs for every leaf of ``tree``. Device
    tensors are copied to the host here, on the calling thread; host
    tensors and numpy arrays are taken as they are, so a caller that goes
    on writing host tensors must hand over copies."""
    return [(key, leaf.detach().cpu() if torch.is_tensor(leaf) else leaf)
            for key, leaf in tree_items(tree)]


def _file_name(key: str) -> str:
    return re.sub(r"\W+", ".", key).strip(".") + ".bin"


def _write_leaf(fname: str, a: np.ndarray):
    with open(fname, "wb") as fh:
        fh.write(a.reshape(-1).view(np.uint8))
        fh.flush()
        os.fsync(fh.fileno())


def _write_arrays(path: str, leaves, manifest):
    """Write every leaf's bytes and the index, each file fsync'ed, into a
    fresh tag directory (an older tag of the same name goes first, stale
    marker and all); returns the manifest, built from the same host bytes
    when ``manifest`` is a function of the named leaves. The files are
    written by ``_WRITERS`` threads at once (one stream of writes and fsyncs
    leaves the storage waiting on each file in turn). ``leaves`` may be an
    iterator that assembles each leaf as it yields: then the leaves waiting
    on the writers never hold more bytes than the largest leaf so far, so
    that with the one being assembled no more than two leaves' worth is on
    the host (a list is on the host already). An iterator is consumed to its
    end even when a write fails (it may run collectives that other ranks
    wait on)."""
    entries = {} if callable(manifest) else None
    if os.path.isdir(path):
        shutil.rmtree(path)
    adir = os.path.join(path, ARRAYS_DIR)
    os.makedirs(adir)
    index, pending = {}, collections.deque()
    streamed, held, largest = not isinstance(leaves, list), 0, 0
    try:
        with ThreadPoolExecutor(max_workers=_WRITERS) as pool:
            for key, leaf in leaves:
                a, dtype = integrity.host_array(leaf)
                name = _file_name(key)
                if any(e["file"] == name for e in index.values()):
                    raise ValueError(f"two leaves map to the file {name!r}")
                index[key] = {"file": name, "dtype": dtype, "shape": list(a.shape)}
                if entries is not None:
                    entries[key] = integrity.manifest_entry(leaf)
                pending.append((pool.submit(_write_leaf, os.path.join(adir, name), a), a.nbytes))
                held, largest = held + a.nbytes, max(largest, a.nbytes)
                while len(pending) > _WRITERS or (streamed and held > largest):
                    done, nbytes = pending.popleft()
                    done.result()
                    held -= nbytes
            while pending:
                pending.popleft()[0].result()
    except Exception:
        _drain(leaves)
        raise
    integrity.write_json_atomic(os.path.join(adir, INDEX_FILE), index)
    return integrity.manifest_of(entries) if entries is not None else manifest


def _map_leaf(path: str, key: str, entry: dict) -> torch.Tensor:
    """The whole leaf ``key`` as a host tensor backed by its file
    (memory-mapped, copy on write)."""
    fname = os.path.join(path, ARRAYS_DIR, entry["file"])
    dtype = getattr(torch, entry["dtype"])
    shape = tuple(entry["shape"])
    want = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
    if not os.path.exists(fname) or os.path.getsize(fname) != want:
        raise TornCheckpointError(f"{path}: leaf {key!r} file {entry['file']} is missing or "
                                  f"not {want} bytes")
    raw = np.memmap(fname, dtype=np.uint8, mode="c") if want else np.empty(0, np.uint8)
    return torch.from_numpy(raw).view(dtype).reshape(shape)


def _drain(leaves):
    for _ in leaves:
        pass


class CommitGroup:
    """The ranks of the world that save one tag together: the world's rank
    0 writes, and :meth:`agree` is a vote of every rank over the control
    channel."""

    def __init__(self):
        self.writer = comm.process_world()[0] == 0

    def agree(self, ok: bool) -> bool:
        return comm.control_all(ok)


class TorchCheckpointEngine(CheckpointEngine):
    def __init__(self, use_ocdbt: bool = False):
        if use_ocdbt:
            raise not_ported("checkpoint.use_ocdbt (Orbax's OCDBT layout: the port "
                             "writes one file per leaf)")
        self.world = None  # a CommitGroup where ranks save together

    def writes(self) -> bool:
        """Whether this rank writes the tags it saves."""
        return self.world is None or self.world.writer

    def save(self, path: str, state_tree, metadata: dict, manifest=None,
             pre_commit=None) -> None:
        """``manifest`` is the per-leaf checksum table
        (integrity.manifest_from_leaves), or that function itself, to be
        applied to the host leaves written; ``pre_commit`` runs after
        every sidecar except the commit marker is durable — it is the
        torn-write injection window: a raise there leaves a markerless
        tag that ``load`` refuses, exactly like a writer killed
        mid-commit."""
        self.save_leaves(path, named_host_leaves(state_tree) if self.writes() else [], metadata,
                         manifest, pre_commit)

    def save_leaves(self, path: str, leaves, metadata: dict, manifest=None,
                    pre_commit=None, on_commit=()) -> None:
        """:meth:`save` of ``(key, host leaf)`` pairs in the tree's order: a
        list, or an iterator consumed as it yields (each rank of a
        ``world`` consumes its own; a rank that does not write drains it).
        ``on_commit``: callbacks to run once the tag is committed, before
        any rank goes on."""
        path = os.path.abspath(path)
        error = None
        try:
            if self.writes():
                manifest = _write_arrays(path, leaves, manifest)
            else:
                _drain(leaves)
        except Exception as exc:  # noqa: BLE001 — every rank votes before it is raised
            error = exc
        self._commit(path, metadata, manifest, pre_commit, error, list(on_commit))

    def _commit(self, path, metadata, manifest, pre_commit, error=None, callbacks=None):
        """Sidecar ordering contract: the arrays are already durable when this
        runs; metadata next (its presence implies the arrays committed), then
        the checksum manifest, then — past the injectable ``pre_commit``
        window, which every rank runs — the atomic commit marker, once every
        rank agrees, and the ``callbacks`` (each removed from the list as it
        runs). A death anywhere before the marker leaves a tag that loads as
        torn; a rank whose part failed raises its error, and the others a
        ``TornCheckpointError``."""
        if error is None and self.writes():
            try:
                integrity.write_json_atomic(os.path.join(path, integrity.METADATA_FILE),
                                            metadata)
                if manifest is not None:
                    integrity.write_json_atomic(os.path.join(path, integrity.MANIFEST_FILE),
                                                manifest)
            except Exception as exc:  # noqa: BLE001 — as above
                error = exc
        if error is None and pre_commit is not None:
            try:
                pre_commit()
            except Exception as exc:  # noqa: BLE001 — as above
                error = exc
        agreed = error is None if self.world is None else self.world.agree(error is None)
        if error is not None:
            raise error
        if not agreed:
            raise TornCheckpointError(f"{path}: another rank's part of the commit failed; "
                                      "the tag stays uncommitted")
        if self.writes():
            extra = ({"leaf_count": manifest.get("leaf_count")}
                     if manifest is not None else None)
            integrity.write_commit_marker(path, extra=extra)
        for cb in list(callbacks or ()):
            cb()
            callbacks.remove(cb)
        if self.world is not None:
            self.world.agree(True)  # no rank goes on before the marker is placed

    def open(self, path: str, keys=None, require_commit: bool = True,
             verify_integrity: bool = True):
        """Check tag ``path`` and return ``(read, metadata)``: ``read(key)``
        is the whole leaf as a host tensor backed by its file. Refused
        (``TornCheckpointError``) without a commit marker, or where a leaf
        file is short or, with ``verify_integrity``, a leaf of ``keys``
        (default: every leaf of the tag) fails the manifest's checksum,
        read one leaf at a time."""
        path = os.path.abspath(path)
        self.wait()
        if require_commit and not integrity.is_committed(path):
            raise TornCheckpointError(
                f"{path} has no {integrity.COMMIT_MARKER} — torn/uncommitted "
                "checkpoint (writer died mid-commit); load an earlier tag")
        meta_path = os.path.join(path, integrity.METADATA_FILE)
        if not os.path.exists(meta_path):
            # metadata is written strictly AFTER the arrays are durable;
            # its absence means the save never fully committed
            raise ValueError(
                f"{path} has no {integrity.METADATA_FILE} — incomplete (uncommitted) "
                "checkpoint; load an earlier tag")
        with open(os.path.join(path, ARRAYS_DIR, INDEX_FILE)) as fh:
            index = json.load(fh)
        keys = list(index) if keys is None else list(keys)
        absent = [key for key in keys if key not in index]
        if absent:
            raise ValueError(f"{path} holds no leaf {absent[0]!r} of the template "
                             f"({len(absent)} absent): another model, precision or optimizer")

        def read(key):
            return _map_leaf(path, key, index[key])

        if verify_integrity:
            manifest = integrity.read_manifest(path)
            if manifest is not None:
                problems = integrity.verify_leaves(((key, read(key)) for key in keys), manifest)
                if problems:
                    raise TornCheckpointError(
                        f"{path} failed integrity verification "
                        f"({len(problems)} leaf mismatch(es)): "
                        + "; ".join(problems[:3]))
        with open(meta_path) as fh:
            metadata = json.load(fh)
        return read, metadata

    def load(self, path: str, template_tree, require_commit: bool = True,
             verify_integrity: bool = True):
        read, metadata = self.open(path, [key for key, _ in tree_items(template_tree)],
                                   require_commit, verify_integrity)
        restored = tree_map_with_keys(
            lambda key, t: read(key).to(device=t.device, dtype=t.dtype), template_tree)
        return restored, metadata

    def wait(self, alone: bool = False) -> None:
        """Block until in-flight saves are durable (no-op for sync saves)."""

    def on_commit(self, callback) -> None:
        """Run ``callback`` once the most recent save is durable. Sync saves
        are durable on return, so: immediately. The async engine defers to
        the commit fence — 'latest' pointers and anything else that must
        only ever name durable checkpoints goes through here."""
        callback()


# Engines with a pending (unfenced) save are pinned by a STRONG reference
# until the fence runs: if they were only weakly held, a gc before any
# wait()/atexit drain would drop the pending sidecar writes and leave a
# fully-durable checkpoint permanently flagged as uncommitted. Idle engines
# are not pinned and stay collectable.
_PENDING_ASYNC_ENGINES = set()


def _drain_async_engines():
    for engine in list(_PENDING_ASYNC_ENGINES):
        try:
            engine.wait(alone=True)
        except Exception:  # noqa: BLE001 — interpreter exit: nothing is left to report to
            pass


atexit.register(_drain_async_engines)


class AsyncTorchCheckpointEngine(TorchCheckpointEngine):
    """Non-blocking saves. ``save`` copies every device leaf to the host
    before it returns (the engine updates its buffers in place, so the next
    step must not reach the bytes being written); the checksums and the
    file writes run on a background thread while training continues.
    ``wait()`` fences: it joins the writer, then places the sidecars and
    runs the commit callbacks; ``load`` and a subsequent ``save`` fence
    automatically. Ranks that save together each reach the fence, where
    they vote (on the calling thread: the writer thread runs no
    collective)."""

    def __init__(self, use_ocdbt: bool = False):
        super().__init__(use_ocdbt=use_ocdbt)
        self._writer = None            # (thread, result) of the save in flight
        self._pending_meta = None
        self._pending_commits = []

    def save_leaves(self, path: str, leaves, metadata: dict, manifest=None,
                    pre_commit=None, on_commit=()) -> None:
        path = os.path.abspath(path)
        self.wait()  # one save in flight at a time; flushes prior sidecars
        result = {}
        if self.writes():
            leaves = list(leaves)  # the host copies, before this returns

            def write():
                try:
                    result["manifest"] = _write_arrays(path, leaves, manifest)
                except BaseException as exc:  # noqa: BLE001 — re-raised by the fence
                    result["error"] = exc

            thread = threading.Thread(target=write, name="ckpt-writer")
            thread.start()
            self._writer = (thread, result)
        else:
            _drain(leaves)
        # the sidecars ride the next fence (wait()/load()/next save()/
        # atexit), after the writer has made the arrays durable: a commit
        # marker on disk implies the arrays are durable, matching the sync
        # engine's "marker last" ordering
        self._pending_meta = (path, dict(metadata), pre_commit)
        self._pending_commits.extend(on_commit)
        _PENDING_ASYNC_ENGINES.add(self)

    def on_commit(self, callback) -> None:
        self._pending_commits.append(callback)
        _PENDING_ASYNC_ENGINES.add(self)

    def wait(self, alone: bool = False) -> None:
        """The fence. ``alone``: the interpreter's exit, where the other
        ranks may be gone, so there is no vote: the world's writer commits
        its save once its own writer thread has joined without error (the
        other ranks' parts were taken before ``save`` returned), and a rank
        that does not write drops its pending commit."""
        # exception safety: the strong-ref unpin runs regardless — a
        # raising fence must not leave the engine pinned forever
        world = self.world
        try:
            if alone and world is not None:
                if not world.writer:
                    self._pending_meta = None
                    self._pending_commits.clear()
                    return
                self.world = None
            manifest, error = None, None
            if self._writer is not None:
                (thread, result), self._writer = self._writer, None
                thread.join()
                error = result.get("error")
                manifest = result.get("manifest")
            marker_written = True
            if self._pending_meta is not None:
                (path, metadata, pre_commit), self._pending_meta = self._pending_meta, None
                # the directory can legitimately be gone (test tmp dirs
                # removed between save and teardown drain) — skip the write
                # but don't break the fence
                if error is None and self.world is None and not os.path.isdir(path):
                    marker_written = False
                    logger.warning(
                        f"checkpoint dir {path} vanished before the async "
                        "fence; commit marker not written — this tag will "
                        "load as uncommitted and its commit callbacks "
                        "(e.g. the 'latest' pointer) are dropped")
                else:
                    try:
                        self._commit(path, metadata, manifest, pre_commit, error,
                                     self._pending_commits)
                    except BaseException:
                        # the arrays never became durable, or a torn commit:
                        # sidecars before the marker may be on disk but the
                        # marker is not — the tag must load as uncommitted,
                        # nothing may point 'latest' at it, and a later fence
                        # must NOT retroactively commit it (a real writer
                        # death has no retry)
                        self._pending_commits.clear()
                        raise
            elif error is not None:
                self._pending_commits.clear()
                raise error
            if marker_written:
                for cb in list(self._pending_commits):
                    cb()
                    self._pending_commits.remove(cb)
            else:
                # never point 'latest' (or anything else) at a checkpoint
                # whose commit marker could not be placed
                self._pending_commits.clear()
        finally:
            self.world = world
            if self._pending_meta is None and not self._pending_commits:
                _PENDING_ASYNC_ENGINES.discard(self)
