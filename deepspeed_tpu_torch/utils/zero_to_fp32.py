"""Offline checkpoint -> full fp32 weights, engine-free (counterpart of
``deepspeed_tpu/utils/zero_to_fp32.py``; reference:
``deepspeed/utils/zero_to_fp32.py`` ``get_fp32_state_dict_from_zero_checkpoint``).

A tag of this package (``runtime/checkpoint_engine/torch_checkpoint_engine``)
holds every leaf whole, whatever the ZeRO stage and mesh that wrote it, so
"consolidation" is a read of the f32 masters (or, without them, of the
params), which are then laid out as the reference lays them out: its dotted
names (``layers.attn.wq``), layers stacked, weights ``x @ w``
(``models/transformer.params_to_numpy``). The output equals the reference
tool's for the same state. Usable standalone:

    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <checkpoint_dir> <output.npz> [--tag TAG]
"""

import argparse
import json
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.runtime.checkpoint_engine import torch_checkpoint_engine as tce

_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def _latest_tag(checkpoint_dir: str) -> Optional[str]:
    latest = os.path.join(checkpoint_dir, "latest")
    if os.path.exists(latest):
        with open(latest) as fh:
            return fh.read().strip()
    return None


def tag_path(checkpoint_dir: str, tag: Optional[str] = None) -> Tuple[str, Optional[str]]:
    """(the tag's directory, the tag): ``tag``, else what ``latest`` names,
    else ``checkpoint_dir`` itself."""
    tag = tag or _latest_tag(checkpoint_dir)
    return os.path.abspath(os.path.join(checkpoint_dir, tag) if tag else checkpoint_dir), tag


def _lists(node):
    """Dicts keyed 0..n-1 (a tree's lists) back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def read_tag(path: str):
    """``(tree, metadata)`` of a committed tag: its state tree as nested
    dicts (a NamedTuple's fields as keys), every leaf a host tensor backed
    by its file, after each leaf's checksum was held to the manifest."""
    read, metadata = tce.TorchCheckpointEngine().open(path)
    with open(os.path.join(path, tce.ARRAYS_DIR, tce.INDEX_FILE)) as fh:
        keys = list(json.load(fh))
    root = {}
    for key in keys:
        parts = [a or (int(b) if b else c) for a, b, c in _KEY.findall(key)]
        node = root
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = read(key)
    return _lists(root), metadata


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _flatten(tree[k], f"{prefix}{k}.").items()}
    return {prefix[:-1]: tree}


def reference_state_dict(tree) -> Dict[str, np.ndarray]:
    """This package's param-shaped tree -> {the reference's dotted name: f32
    array in its layout}."""
    return {k: np.asarray(v, np.float32) for k, v in _flatten(tf.params_to_numpy(tree)).items()}


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir: str,
                                             tag: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Full fp32 weights as {dotted_name: ndarray} in the reference's names
    and layout (reference zero_to_fp32.py:158)."""
    path, _ = tag_path(checkpoint_dir, tag)
    tree, _ = read_tag(path)
    weights = tree.get("master_params") or tree.get("params")
    if weights is None:
        raise ValueError(f"checkpoint at {path} has no params/master_params")
    return reference_state_dict(weights)


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir: str, output_file: str,
                                               tag: Optional[str] = None):
    """Write consolidated fp32 weights to ``output_file`` (.npz)
    (reference zero_to_fp32.py convert_zero_checkpoint_to_fp32_state_dict)."""
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    np.savez(output_file, **sd)
    meta = {"num_tensors": len(sd), "total_params": int(sum(v.size for v in sd.values()))}
    with open(output_file + ".meta.json", "w") as fh:
        json.dump(meta, fh)
    return sd


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("--tag", default=None)
    args = p.parse_args(argv)
    sd = convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir, args.output_file, args.tag)
    print(f"wrote {len(sd)} tensors to {args.output_file}")


if __name__ == "__main__":
    main()
