"""High-precision fragment mapping + safe full-tensor access (counterpart of
``deepspeed_tpu/utils/tensor_fragment.py``; reference:
``deepspeed/utils/tensor_fragment.py`` ``safe_get_full_fp32_param``,
``safe_get_full_grad``, ``safe_get_full_optimizer_state``,
``safe_set_full_fp32_param``).

The port trains on one device without ZeRO, so every tensor is whole: the
fragment map of a tensor is one fragment, the whole of it, and "get full
tensor" is an f32 copy. ``name`` is a dotted path into the param tree
(``"layers.0.attn.wqkv"``) or a list of its keys; the accumulators and
Adam's moments, flat lists in the engine, are found by the same paths.
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


def get_hp_fragment_mapping(t: torch.Tensor) -> List[FragmentAddress]:
    """Per-device fragment records: one device, so the whole tensor."""
    return [FragmentAddress(device=str(t.device), index=tuple(slice(0, n) for n in t.shape),
                            shape=tuple(t.shape))]


def _parse_path(name) -> List[str]:
    if isinstance(name, (list, tuple)):
        return [str(k) for k in name]
    return [p for p in str(name).replace("]", "").replace("[", ".").split(".") if p]


def _tree_get(tree, path):
    node = tree
    for key in path:
        node = node[int(key)] if isinstance(node, list) else node[key]
    return node


def _find(engine, name) -> Optional[int]:
    """The index of ``name``'s leaf in the engine's flat lists."""
    path = ".".join(_parse_path(name))
    return engine._leaf_names.index(path) if path in engine._leaf_names else None


def safe_get_full_fp32_param(engine, name) -> Optional[torch.Tensor]:
    """An f32 copy of a parameter's master value (its value when the
    engine keeps no masters), or None for an unknown name."""
    tree = engine.master_params if engine.master_params is not None else engine.params
    try:
        leaf = _tree_get(tree, _parse_path(name))
    except (KeyError, IndexError, ValueError, TypeError):
        return None
    return leaf.detach().to(torch.float32, copy=True)


def safe_get_full_grad(engine, name) -> Optional[torch.Tensor]:
    """A copy of a parameter's accumulated gradient (the f32 accumulator)."""
    i = _find(engine, name)
    return None if i is None else engine.grad_acc[i].clone()


def safe_get_full_optimizer_state(engine, name, state_key: str) -> Optional[torch.Tensor]:
    """A copy of one optimizer-state tensor of a parameter, e.g.
    ``state_key="exp_avg"``."""
    if engine.opt_state is None:
        return None
    state = getattr(engine.opt_state, state_key, None)
    i = _find(engine, name)
    if not isinstance(state, list) or i is None:
        return None
    return state[i].clone()


@torch.no_grad()
def safe_set_full_fp32_param(engine, name, value) -> bool:
    """Overwrite a parameter's master value (its value without masters) in
    place from a whole tensor or array; False for an unknown name. As in
    the reference, a model-dtype copy follows at the next step."""
    tree = engine.master_params if engine.master_params is not None else engine.params
    try:
        leaf = _tree_get(tree, _parse_path(name))
    except (KeyError, IndexError, ValueError, TypeError):
        return False
    leaf.copy_(torch.as_tensor(value))
    return True
