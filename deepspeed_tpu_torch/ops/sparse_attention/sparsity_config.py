"""Block-sparsity pattern configs.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``, a
copy of its five configs (Dense / Fixed / BigBird / BSLongformer / Variable)
with the same ``np.random.RandomState`` draws, so both packages make the same
layouts. Each config produces a block-level layout: an int32 array
(num_heads, nb, nb) where entry 1 means the (q-block, k-block) tile is
attended. The CUDA kernels (``ops/block_sparse_attention.py``) visit only the
tiles whose layout entry is nonzero.
"""

from typing import List, Optional

import numpy as np


class SparsityConfig:
    def __init__(self, num_heads: int, block: int = 64, different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len: int) -> np.ndarray:
        assert seq_len % self.block == 0, f"seq_len {seq_len} must be divisible by block {self.block}"
        nb = seq_len // self.block
        return np.zeros((self.num_heads, nb, nb), dtype=np.int32)

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    def _finalize(self, layout: np.ndarray, causal: bool) -> np.ndarray:
        if causal:
            nb = layout.shape[1]
            layout = layout * np.tril(np.ones((nb, nb), np.int32))
        return layout


class DenseSparsityConfig(SparsityConfig):
    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed pattern (reference :87): local blocks of ``num_local_blocks``
    plus global attention to the last ``num_global_blocks`` of each local
    window (unidirectional = causal)."""

    def __init__(
        self,
        num_heads: int,
        block: int = 64,
        different_layout_per_head: bool = False,
        num_local_blocks: int = 4,
        num_global_blocks: int = 1,
        attention: str = "bidirectional",
        horizontal_global_attention: bool = False,
        num_different_global_patterns: int = 1,
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        assert num_local_blocks % num_global_blocks == 0 or num_global_blocks <= num_local_blocks
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns if different_layout_per_head else 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        nloc = self.num_local_blocks
        for h in range(self.num_heads):
            pat = h % self.num_different_global_patterns
            # local windows
            for start in range(0, nb, nloc):
                end = min(start + nloc, nb)
                layout[h, start:end, start:end] = 1
            # global columns: representative block(s) of each window
            for start in range(0, nb, nloc):
                gstart = min(start + nloc - self.num_global_blocks * (pat + 1), nb - 1)
                gend = min(gstart + self.num_global_blocks, nb)
                cols = range(max(gstart, 0), gend)
                for c in cols:
                    layout[h, :, c] = 1  # vertical global (everyone attends to it)
                    if self.horizontal_global_attention:
                        layout[h, c, :] = 1
        return self._finalize(layout, self.attention == "unidirectional")


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird (reference :423): sliding window + random blocks + global
    first/last blocks."""

    def __init__(
        self,
        num_heads: int,
        block: int = 64,
        different_layout_per_head: bool = False,
        num_random_blocks: int = 1,
        num_sliding_window_blocks: int = 3,
        num_global_blocks: int = 1,
        attention: str = "bidirectional",
        seed: int = 0,
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        rng = np.random.RandomState(self.seed)
        for h in range(self.num_heads):
            hh = h if self.different_layout_per_head else 0
            if h > 0 and not self.different_layout_per_head:
                layout[h] = layout[0]
                continue
            for i in range(nb):
                lo, hi = max(0, i - w), min(nb, i + w + 1)
                layout[h, i, lo:hi] = 1  # sliding window
                choices = rng.choice(nb, size=min(self.num_random_blocks, nb), replace=False)
                layout[h, i, choices] = 1  # random blocks
            g = self.num_global_blocks
            layout[h, :g, :] = 1
            layout[h, :, :g] = 1
            layout[h, -g:, :] = 1
            layout[h, :, -g:] = 1
        return self._finalize(layout, self.attention == "unidirectional")


class BSLongformerSparsityConfig(SparsityConfig):
    """Longformer-style (reference :559): sliding window + designated global
    block indices (bidirectional global attention)."""

    def __init__(
        self,
        num_heads: int,
        block: int = 64,
        different_layout_per_head: bool = False,
        num_sliding_window_blocks: int = 3,
        global_block_indices: Optional[List[int]] = None,
        global_block_end_indices: Optional[List[int]] = None,
        attention: str = "bidirectional",
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_heads):
            for i in range(nb):
                layout[h, i, max(0, i - w): min(nb, i + w + 1)] = 1
            if self.global_block_end_indices is None:
                for g in self.global_block_indices:
                    if g < nb:
                        layout[h, :, g] = 1
                        layout[h, g, :] = 1
            else:
                for gs, ge in zip(self.global_block_indices, self.global_block_end_indices):
                    layout[h, :, gs:ge] = 1
                    layout[h, gs:ge, :] = 1
        return self._finalize(layout, self.attention == "unidirectional")


class VariableSparsityConfig(SparsityConfig):
    """Variable local window sizes + global + random (reference :232)."""

    def __init__(
        self,
        num_heads: int,
        block: int = 64,
        different_layout_per_head: bool = False,
        num_random_blocks: int = 0,
        local_window_blocks: Optional[List[int]] = None,
        global_block_indices: Optional[List[int]] = None,
        global_block_end_indices: Optional[List[int]] = None,
        attention: str = "bidirectional",
        horizontal_global_attention: bool = False,
        seed: int = 0,
    ):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices if global_block_indices is not None else [0]
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        rng = np.random.RandomState(self.seed)
        for h in range(self.num_heads):
            # variable local windows: consume window sizes in order, last repeats
            start = 0
            wi = 0
            while start < nb:
                size = self.local_window_blocks[min(wi, len(self.local_window_blocks) - 1)]
                end = min(start + size, nb)
                layout[h, start:end, start:end] = 1
                start = end
                wi += 1
            if self.global_block_end_indices is None:
                for g in self.global_block_indices:
                    if g < nb:
                        layout[h, :, g] = 1
                        if self.horizontal_global_attention:
                            layout[h, g, :] = 1
            else:
                for gs, ge in zip(self.global_block_indices, self.global_block_end_indices):
                    layout[h, :, gs:ge] = 1
                    if self.horizontal_global_attention:
                        layout[h, gs:ge, :] = 1
            if self.num_random_blocks > 0:
                for i in range(nb):
                    choices = rng.choice(nb, size=min(self.num_random_blocks, nb), replace=False)
                    layout[h, i, choices] = 1
        return self._finalize(layout, self.attention == "unidirectional")
