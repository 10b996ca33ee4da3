"""Data loading (counterpart of ``deepspeed_tpu/runtime/dataloader.py``;
reference: ``runtime/dataloader.py`` DeepSpeedDataLoader + RepeatingLoader).
The port trains in one process, so a loader yields whole batches (no
process striding). The shuffle is the reference's, ``RandomState(seed +
epoch).permutation(n)``, so both packages yield the same batches, and the
``state_dict``/``load_state_dict`` cursor and the quarantine skip-list mean
the same positions in both."""

import numpy as np


def _stack(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([it[i] for it in items]) for i in range(len(first)))
    return np.stack([np.asarray(it) for it in items])


class TpuDataLoader:
    """Wraps an indexable or iterable dataset into batches of numpy arrays
    (``collate_fn`` decides their form otherwise). ``process_shard`` is the
    reference's multi-process striding switch; with one process it changes
    nothing."""

    def __init__(self, dataset, batch_size: int, collate_fn=None, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True, process_shard=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _stack
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.process_shard = process_shard
        self.epoch = 0
        # resume cursor: batches already yielded this epoch (state_dict),
        # and how many to skip on the next pass (load_state_dict)
        self._batches_yielded = 0
        self._resume_batch = 0
        # numerical-health quarantine: (epoch, batch-index) slots excluded
        # from iteration — skipped but still *counted*, so cursors taken
        # before and after a quarantine name the same positions
        self._quarantined = set()
        try:
            self._len = len(dataset)
        except TypeError:
            self._len = None

    def __len__(self):
        if self._len is None:
            raise TypeError("underlying dataset has no __len__")
        return self._len // self.batch_size if self.drop_last else -(-self._len // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def quarantine(self, epoch: int, batch: int):
        """Exclude one (epoch, batch-index) slot from iteration. The slot
        is skipped but batch numbering is unchanged, so an existing
        cursor still names the same stream position and a rewound replay
        sees the identical sequence *minus* the quarantined batch."""
        self._quarantined.add((int(epoch), int(batch)))

    def state_dict(self) -> dict:
        """Resume cursor: how far into the deterministic (seed, epoch)
        stream this loader has advanced. Restoring it on a fresh loader
        replays the exact same batch sequence from that point."""
        out = {"epoch": self.epoch, "batch": self._batches_yielded, "seed": self.seed}
        if self._quarantined:
            out["quarantined"] = sorted(list(q) for q in self._quarantined)
        return out

    def load_state_dict(self, state: dict):
        if self._len is None:
            raise TypeError(
                "cannot resume an iterable dataset without __len__ — its "
                "stream position is not replayable from a cursor")
        if "seed" in state and int(state["seed"]) != int(self.seed):
            raise ValueError(
                f"dataloader cursor was taken under seed {state['seed']}, "
                f"this loader uses seed {self.seed} — the shuffle orders "
                "differ, so the cursor does not name the same batches")
        self.epoch = int(state.get("epoch", 0))
        self._resume_batch = int(state.get("batch", 0))
        # the cursor is authoritative for the skip-list too (the
        # supervisor re-applies its own journal after a rewind, since a
        # snapshot cursor can predate later quarantines)
        self._quarantined = {(int(e), int(b)) for e, b in state.get("quarantined", [])}

    def __iter__(self):
        if self._len is None:
            return self._iter_iterable()
        return self._iter_indexable()

    def _iter_indexable(self):
        n = self._len
        order = np.arange(n)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(n)
        skip, self._resume_batch = self._resume_batch, 0
        for b, start in enumerate(range(
                0, n - (self.batch_size - 1 if self.drop_last else 0), self.batch_size)):
            if b < skip:
                continue
            if (self.epoch, b) in self._quarantined:
                # skipped, not renumbered: position advances past the slot
                self._batches_yielded = b + 1
                continue
            idx = order[start : start + self.batch_size]
            self._batches_yielded = b + 1
            yield self.collate_fn([self.dataset[int(i)] for i in idx])

    def _iter_iterable(self):
        buf = []
        for item in self.dataset:
            buf.append(item)
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.collate_fn(buf)


class RepeatingLoader:
    """Wraps an iterator to restart on StopIteration (reference:
    runtime/dataloader.py RepeatingLoader)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(getattr(self.loader, "epoch", 0) + 1)
            self.data_iter = iter(self.loader)
            return next(self.data_iter)

    def state_dict(self) -> dict:
        return self.loader.state_dict()

    def load_state_dict(self, state: dict):
        self.loader.load_state_dict(state)
        # drop the live iterator: the next __next__ must honor the cursor
        self.data_iter = iter(self.loader)

    def quarantine(self, epoch: int, batch: int):
        self.loader.quarantine(epoch, batch)
