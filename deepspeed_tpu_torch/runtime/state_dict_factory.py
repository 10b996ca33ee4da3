"""Checkpoint merge/split for inference tensor parallelism (counterpart of
``deepspeed_tpu/runtime/state_dict_factory.py``; reference:
``deepspeed/runtime/state_dict_factory.py`` SDLoaderFactory, which merges
and splits Megatron mp_rank_XX checkpoints for another inference TP degree,
:190).

Host-side numpy transforms over dotted-name state dicts in the reference's
names and layout (``utils/zero_to_fp32``'s output, a universal directory's
``model_states.npz``): qkv/column-parallel weights split on the output dim,
o_proj/down-proj on the input dim, everything else replicated, as the
tensor-parallel rules place them (module_inject/policies.py).
"""

from typing import Dict, List, Sequence

import numpy as np

# dotted-name suffix -> split axis convention (column = output dim -1,
# row = input dim 0); mirrors module_inject policy geometry
COLUMN_SUFFIXES = ("wq", "wk", "wv", "wi", "wg", "q_proj", "k_proj", "v_proj",
                   "gate_proj", "up_proj", "c_attn", "qkvw", "inter_w")
ROW_SUFFIXES = ("wo", "o_proj", "down_proj", "c_proj", "output_w")


def _axis_for(name: str):
    leaf = name.rsplit(".", 1)[-1]
    if leaf in COLUMN_SUFFIXES:
        return -1
    if leaf in ROW_SUFFIXES:
        return 0
    return None


META_KEY = "__tp_split_axes__"


def split_state_dict(sd: Dict[str, np.ndarray], tp_size: int) -> List[Dict[str, np.ndarray]]:
    """Full weights -> tp_size rank shards (reference SDLoader split path).
    Each shard records which names were actually split (META_KEY) so merge
    never has to guess from tensor contents."""
    shards: List[Dict[str, np.ndarray]] = [dict() for _ in range(tp_size)]
    split_axes: Dict[str, int] = {}
    for name, arr in sd.items():
        axis = _axis_for(name)
        if axis is None or arr.ndim < 2 or arr.shape[axis] % tp_size != 0:
            for s in shards:
                s[name] = arr
            continue
        split_axes[name] = axis
        for rank, piece in enumerate(np.split(arr, tp_size, axis=axis)):
            shards[rank][name] = piece
    for s in shards:
        s[META_KEY] = np.asarray(  # serializable marker
            [f"{n}:{a}" for n, a in sorted(split_axes.items())], dtype=object
        )
    return shards


def merge_state_dicts(shards: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """tp shards -> full weights (reference SDLoader merge path). Prefers the
    split-axis metadata written by split_state_dict; without it falls back to
    the name-policy axes (which mis-merges shardable names that were
    replicated for indivisibility — always carry the metadata)."""
    meta = shards[0].get(META_KEY)
    if meta is not None:
        split_axes = {e.split(":")[0]: int(e.split(":")[1]) for e in meta.tolist()}
    else:
        split_axes = None
    out: Dict[str, np.ndarray] = {}
    for name, arr in shards[0].items():
        if name == META_KEY:
            continue
        pieces = [s[name] for s in shards]
        if split_axes is not None:
            axis = split_axes.get(name)
        else:
            axis = _axis_for(name) if arr.ndim >= 2 else None
        if axis is None:
            out[name] = arr
        else:
            out[name] = np.concatenate(pieces, axis=axis)
    return out


class SDLoaderFactory:
    """Reference-named facade."""

    @staticmethod
    def get_sd_loader_json(sd: Dict[str, np.ndarray], tp_size: int):
        return split_state_dict(sd, tp_size)
