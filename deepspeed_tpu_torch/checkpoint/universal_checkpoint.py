"""Universal checkpoint format and conversion (counterpart of
``deepspeed_tpu/checkpoint/universal_checkpoint.py``; reference:
``deepspeed/checkpoint/ds_to_universal.py``, ``universal_checkpoint.py``).

The directory is the reference's, key for key: ``model_states.npz`` ({the
reference's dotted name: whole f32 array in its layout}, from the masters
where the tag has them), one ``optim_<component>.npz`` for each param-shaped
component of the optimizer's state (Adam's ``exp_avg`` and ``exp_avg_sq``),
and ``universal_manifest.json`` with ``tensors`` (shapes and dtypes),
``optimizer`` (each component's names), ``optimizer_scalars`` (Adam's
``step``) and ``engine_metadata`` (the tag's ``ds_metadata.json``). The
reference's ``load_universal_into_engine`` reads a directory written here,
and :func:`load_universal_into_engine` reads one the reference writes, onto
an engine at any ZeRO stage and mesh: each rank lays out one leaf of this
package's tree at a time from the memory-mapped arrays (of a stacked one,
only that layer's bytes) and cuts its blocks from it.
"""

import json
import os
import struct
import zipfile
from typing import Any, Dict, Optional

import numpy as np

from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.utils.zero_to_fp32 import read_tag, reference_state_dict, tag_path

MODEL_FILE = "model_states.npz"
OPT_PREFIX = "optim_"
MANIFEST = "universal_manifest.json"


def ds_to_universal(checkpoint_dir: str, output_dir: str, tag: Optional[str] = None) -> Dict[str, Any]:
    """Convert an engine checkpoint (this package's tag) into the universal
    layout (reference: checkpoint/ds_to_universal.py main flow)."""
    src, tag = tag_path(checkpoint_dir, tag)
    tree, metadata = read_tag(src)
    os.makedirs(output_dir, exist_ok=True)
    manifest: Dict[str, Any] = {"source": src, "tag": tag, "tensors": {}, "optimizer": {}}

    weights_tree = tree.get("master_params") or tree.get("params")
    if weights_tree is None:
        raise ValueError(f"{src} has no params/master_params")
    weights = reference_state_dict(weights_tree)
    np.savez(os.path.join(output_dir, MODEL_FILE), **weights)
    manifest["tensors"] = {k: {"shape": list(v.shape), "dtype": "float32"} for k, v in weights.items()}

    opt = tree.get("opt_state")
    if opt is not None:
        scalars: Dict[str, Any] = {}
        for comp in sorted(opt):
            if isinstance(opt[comp], dict):
                tensors = reference_state_dict(opt[comp])
                np.savez(os.path.join(output_dir, f"{OPT_PREFIX}{comp}.npz"), **tensors)
                manifest["optimizer"][comp] = sorted(tensors)
            else:
                arr = np.asarray(opt[comp])
                scalars[comp] = arr.item() if arr.size == 1 else arr.tolist()
        manifest["optimizer_scalars"] = scalars
    manifest["engine_metadata"] = metadata

    with open(os.path.join(output_dir, MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=1, default=str)
    return manifest


class UniversalCheckpoint:
    """Inspect / load a universal checkpoint directory (reference:
    DeepSpeedCheckpoint deepspeed_checkpoint.py:33, without the rank-file
    geometry, which this format does not have)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        with open(os.path.join(self.path, MANIFEST)) as fh:
            self.manifest = json.load(fh)

    def tensor_names(self):
        return sorted(self.manifest["tensors"])

    def get_tensor(self, name: str) -> np.ndarray:
        with np.load(os.path.join(self.path, MODEL_FILE)) as z:
            return z[name]

    def load_weights(self) -> Dict[str, np.ndarray]:
        with np.load(os.path.join(self.path, MODEL_FILE)) as z:
            return {k: z[k] for k in z.files}

    def members(self, comp: Optional[str] = None) -> "NpzMembers":
        """The weights' arrays (or optimizer component ``comp``'s), each
        read when asked for."""
        name = MODEL_FILE if comp is None else f"{OPT_PREFIX}{comp}.npz"
        return NpzMembers(os.path.join(self.path, name))

    def optimizer_components(self):
        return sorted(self.manifest.get("optimizer", {}))

    def load_optimizer_component(self, comp: str) -> Dict[str, np.ndarray]:
        with np.load(os.path.join(self.path, f"{OPT_PREFIX}{comp}.npz")) as z:
            return {k: z[k] for k in z.files}

    @property
    def engine_metadata(self) -> Dict[str, Any]:
        return self.manifest.get("engine_metadata", {})


class NpzMembers:
    """The arrays of an ``.npz`` that ``numpy.savez`` wrote, by name: each
    stored member memory-mapped in place (indexing one reads only the bytes
    indexed), any other read whole when asked for."""

    def __init__(self, path: str):
        self.path, self._mapped = path, {}
        with zipfile.ZipFile(path) as zf, open(path, "rb") as fh:
            self.files = [info.filename.removesuffix(".npy") for info in zf.infolist()]
            for name, info in zip(self.files, zf.infolist()):
                if info.compress_type != zipfile.ZIP_STORED:
                    continue
                fh.seek(info.header_offset + 26)  # the local header's name and extra lengths
                n, m = struct.unpack("<HH", fh.read(4))
                fh.seek(info.header_offset + 30 + n + m)
                if np.lib.format.read_magic(fh) != (1, 0):
                    continue
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(fh)
                if shape and 0 not in shape and not dtype.hasobject:
                    self._mapped[name] = (fh.tell(), shape, "F" if fortran else "C", dtype)

    def __getitem__(self, name: str) -> np.ndarray:
        if name in self._mapped:
            offset, shape, order, dtype = self._mapped[name]
            return np.memmap(self.path, dtype, "r", offset, shape, order)
        with np.load(self.path) as z:
            return z[name]


def load_universal_into_engine(engine, path: str, load_optimizer_states: bool = True):
    """Resume an engine from a universal checkpoint at its own stage and mesh
    (reference: engine.load_checkpoint with --universal-checkpoint): the f32
    weights into the masters and, cast, into the params; Adam's moments and
    step; the step counters. Each rank cuts its own blocks, one leaf at a
    time; nothing is gathered. Returns the engine metadata the directory
    carries."""
    ckpt = UniversalCheckpoint(path)
    state = engine._state
    weights = ckpt.members()
    for leaf_path in state.leaf_paths:
        w = tf.leaf_from_numpy(weights.__getitem__, leaf_path)
        if engine.mixed_precision:
            state.set_leaf(leaf_path, "base", w)
        state.set_leaf(leaf_path, "param", w)

    if load_optimizer_states and engine.opt_state is not None and ckpt.optimizer_components():
        opt = engine.opt_state
        for comp in ckpt.optimizer_components():
            units = getattr(opt, comp, None)
            if not isinstance(units, list):
                continue
            arrays = ckpt.members(comp)
            for leaf_path in state.leaf_paths:
                state.set_leaf(leaf_path, "base", tf.leaf_from_numpy(arrays.__getitem__, leaf_path),
                               units)
        scalars = ckpt.manifest.get("optimizer_scalars", {})
        if "step" in scalars:
            opt.step = int(scalars["step"])

    meta = ckpt.engine_metadata
    engine.global_steps = int(meta.get("global_steps", engine.global_steps) or 0)
    engine.global_samples = int(meta.get("global_samples", engine.global_samples) or 0)
    return meta
