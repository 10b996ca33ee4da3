"""The port's block-sparsity layouts against the reference's.

``deepspeed_tpu_torch/ops/sparse_attention/sparsity_config.py`` is a copy of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py`` (the port imports
nothing of the reference), so every config must give the same int32 layout,
``np.array_equal``, for every mode, both attention directions, one layout
for all heads or one per head, and every seed of the random draws. The
model's ``_sparse_layout`` must match the reference's too, and hand out a
read-only array, since its cache gives the same array to every caller.
"""

import numpy as np
import pytest

from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc

# name: (config class name, kwargs); each runs for both directions, one
# layout or one per head, and two seeds where the config draws at random
CONFIGS = {
    "dense": ("DenseSparsityConfig", {}),
    "fixed": ("FixedSparsityConfig", {}),
    "fixed-local2-global2-horizontal": (
        "FixedSparsityConfig", dict(num_local_blocks=2, num_global_blocks=2,
                                    horizontal_global_attention=True,
                                    num_different_global_patterns=2)),
    "bigbird": ("BigBirdSparsityConfig", {}),
    "bigbird-random3-window5-global2": (
        "BigBirdSparsityConfig", dict(num_random_blocks=3, num_sliding_window_blocks=5,
                                      num_global_blocks=2)),
    "bslongformer": ("BSLongformerSparsityConfig", {}),
    "bslongformer-global-ranges": (
        "BSLongformerSparsityConfig", dict(global_block_indices=[0, 5],
                                           global_block_end_indices=[2, 7])),
    "variable": ("VariableSparsityConfig", {}),
    "variable-windows-random2-horizontal": (
        "VariableSparsityConfig", dict(local_window_blocks=[1, 2, 3], num_random_blocks=2,
                                       global_block_indices=[1, 4],
                                       horizontal_global_attention=True)),
}
RANDOM = ("BigBirdSparsityConfig", "VariableSparsityConfig")


def _directions(cls_name):
    return [None] if cls_name == "DenseSparsityConfig" else ["bidirectional", "unidirectional"]


@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layouts_match_reference(name, per_head):
    cls_name, kw = CONFIGS[name]
    for attention in _directions(cls_name):
        for seed in ((0, 1) if cls_name in RANDOM else (None,)):
            args = dict(kw, num_heads=3, block=16, different_layout_per_head=per_head)
            if attention is not None:
                args["attention"] = attention
            if seed is not None:
                args["seed"] = seed
            for seq in (64, 160):
                ref = getattr(jsc, cls_name)(**args).make_layout(seq)
                got = getattr(tsc, cls_name)(**args).make_layout(seq)
                assert got.dtype == ref.dtype == np.int32
                assert np.array_equal(got, ref), (name, attention, seed, seq)


def test_seeds_draw_different_layouts():
    """The seed reaches the draws: two seeds give two layouts (in both)."""
    for mod in (jsc, tsc):
        a = mod.BigBirdSparsityConfig(num_heads=1, block=16, seed=0).make_layout(256)
        b = mod.BigBirdSparsityConfig(num_heads=1, block=16, seed=1).make_layout(256)
        assert not np.array_equal(a, b)


def test_seq_len_must_be_a_multiple_of_the_block():
    with pytest.raises(AssertionError, match="divisible"):
        tsc.FixedSparsityConfig(num_heads=2, block=16).make_layout(40)


@pytest.mark.parametrize("pattern", [
    (("mode", "fixed"),),
    (("block", 16), ("mode", "fixed"), ("num_local_blocks", 2)),
    (("block", 32), ("mode", "bigbird"), ("num_random_blocks", 2)),
    (("block", 16), ("mode", "bslongformer")),
    (("attention", "unidirectional"), ("block", 16), ("mode", "variable")),
    (("block", 16), ("mode", "dense")),
])
def test_model_sparse_layout_matches_reference(pattern):
    for heads, seq in ((4, 128), (12, 256)):
        ref_layout, ref_block = jtf._sparse_layout(pattern, heads, seq)
        layout, block = ttf._sparse_layout(pattern, heads, seq)
        assert block == ref_block
        assert np.array_equal(layout, ref_layout)


def test_model_sparse_layout_is_read_only_and_cached():
    layout, _ = ttf._sparse_layout((("block", 16), ("mode", "fixed")), 4, 128)
    again, _ = ttf._sparse_layout((("block", 16), ("mode", "fixed")), 4, 128)
    assert again is layout
    assert not layout.flags.writeable
    with pytest.raises(ValueError, match="read-only"):
        layout[0, 0, 0] = 0
