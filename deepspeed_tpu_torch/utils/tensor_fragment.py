"""High-precision fragment mapping + safe full-tensor access (counterpart of
``deepspeed_tpu/utils/tensor_fragment.py``; reference:
``deepspeed/utils/tensor_fragment.py`` ``safe_get_full_fp32_param``,
``safe_get_full_grad``, ``safe_get_full_optimizer_state``,
``safe_set_full_fp32_param``).

Under ZeRO and tensor parallelism each rank holds blocks of each leaf
(``runtime/zero/partitioned.py``): the f32 masters, Adam's moments and the
accumulators in parts, the params whole or in parts. "Get full tensor"
assembles the whole leaf, in this package's layout, from every rank's
blocks, and gives every rank the same tensor: it is collective, so every
rank calls it, in one order. "Set full tensor" cuts a whole value into this
rank's blocks, in place. Without a process group every leaf is whole and
nothing is gathered. ``name`` is a dotted path into the param tree
(``"layers.0.attn.wqkv"``) or a list of its keys; the accumulators and
Adam's moments are found by the same paths.
"""

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch


@dataclass
class FragmentAddress:
    """Where one device's fragment sits in the logical tensor
    (reference fragment_address: numel/start offsets)."""

    device: str
    index: Tuple[slice, ...]  # index into the whole tensor
    shape: Tuple[int, ...]


def get_hp_fragment_mapping(t, name=None) -> List[FragmentAddress]:
    """Fragment records: of a tensor, the whole of it; of an engine and a
    leaf ``name``, this rank's blocks of the leaf's master (the optimizer's
    f32 copy), each with its index into the whole leaf."""
    if name is None:
        return [FragmentAddress(device=str(t.device), index=tuple(slice(0, n) for n in t.shape),
                                shape=tuple(t.shape))]
    path = t._state.path_of(name)
    if path is None:
        return []
    return [FragmentAddress(device=str(block.device), index=index, shape=tuple(block.shape))
            for index, block in t._state.fragments(path, _master(t))]


def _master(engine) -> str:
    """The component that holds a leaf's f32 value: the masters, or the
    params where the engine keeps none."""
    return "base" if engine.mixed_precision else "param"


def safe_get_full_fp32_param(engine, name) -> Optional[torch.Tensor]:
    """An f32 copy of a parameter's whole master value (its value when the
    engine keeps no masters), or None for an unknown name."""
    path = engine._state.path_of(name)
    if path is None:
        return None
    return engine._state.full_leaf(path, _master(engine)).to(torch.float32, copy=True)


def safe_get_full_grad(engine, name) -> Optional[torch.Tensor]:
    """A copy of a parameter's whole accumulated gradient (the f32
    accumulators' blocks, as they stand on each rank)."""
    path = engine._state.path_of(name)
    return None if path is None else engine._state.full_leaf(path, "grad").clone()


def safe_get_full_optimizer_state(engine, name, state_key: str) -> Optional[torch.Tensor]:
    """A copy of one whole optimizer-state tensor of a parameter, e.g.
    ``state_key="exp_avg"``."""
    if engine.opt_state is None:
        return None
    state = getattr(engine.opt_state, state_key, None)
    path = engine._state.path_of(name)
    if not isinstance(state, list) or path is None:
        return None
    return engine._state.full_leaf(path, "base", state).clone()


@torch.no_grad()
def safe_set_full_fp32_param(engine, name, value) -> bool:
    """Overwrite a parameter's master value (its value without masters) in
    place from a whole tensor or array, each rank writing its blocks;
    False for an unknown name. As in the reference, a model-dtype copy
    follows at the next step."""
    path = engine._state.path_of(name)
    if path is None:
        return False
    engine._state.set_leaf(path, _master(engine), torch.as_tensor(value))
    return True
