"""Regex-driven partition rules for tensor parallelism.

Counterpart of ``deepspeed_tpu/parallel/partition.py``: a table of
``(regex, PartitionSpec)`` rules matched against each parameter's
``/``-joined tree path assigns every weight a placement over the mesh, the
first match winning. Rules describe a weight's trailing dims (a shorter spec
is left-padded with None), scalars never partition, and a placement is
clipped to what the mesh and the weight's dims allow. The specs are the
port's own (``runtime/zero/sharding.PartitionSpec``); the trees are nested
dicts and lists of anything with a ``shape``.

The serving mesh (:func:`serving_mesh`) is a ``("data", "tensor")`` mesh
over the first ``data*tensor`` ranks of the world, with process groups of
its own, and :func:`serving_placements` gives a serving engine's spec tree
the way the reference's engine picks it: the model's logical axes, user
rules laid over them leaf by leaf, or the whole regex table (``use_rules``).
"""

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.runtime.zero.sharding import PartitionSpec, ShardingPolicy

DEFAULT_RULES: Tuple[Tuple[str, PartitionSpec], ...] = (
    # attention: column-split q/k/v, row-split output projection
    (r"attn/w[qkv]$", PartitionSpec(None, "tensor")),
    (r"attn/wo$", PartitionSpec("tensor", None)),
    (r"attn/b[qkv]$", PartitionSpec("tensor")),
    (r"attn/bo$", PartitionSpec()),
    # MLP: column-split in/gate, row-split out
    (r"mlp/(wi|wg|res_wi|res_wg)$", PartitionSpec(None, "tensor")),
    (r"mlp/(wo|res_wo)$", PartitionSpec("tensor", None)),
    (r"mlp/(bi|res_bi)$", PartitionSpec("tensor")),
    (r"mlp/(bo|res_bo|gate|coef_w|coef_b)", PartitionSpec()),
    # embeddings / lm head: vocab-split
    (r"embed/tok$", PartitionSpec("tensor", None)),
    (r"lm_head/w$", PartitionSpec(None, "tensor")),
    (r"lm_head/b$", PartitionSpec("tensor")),
    # norms, positional tables, scalar leaves: replicate
    (r".*", PartitionSpec()),
)


def _items(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _items(v, prefix + (str(k),))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _items(v, prefix + (str(i),))]
    return [(prefix, tree)]


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def tree_path_names(params, sep: str = "/"):
    """``[(path_name, leaf), ...]`` with ``sep``-joined paths (dict keys and
    list indices), the names the rules match."""
    return [(sep.join(path), leaf) for path, leaf in _items(params)]


def normalize_rules(rules) -> List[Tuple[str, PartitionSpec]]:
    """Entries ``(regex, PartitionSpec)`` or the JSON form ``[regex, [axis,
    ...]]`` (an axis a name, a list of names, or None) -> ``[(regex,
    PartitionSpec)]``."""
    out = []
    for entry in rules:
        pattern, spec = entry[0], entry[1]
        if not isinstance(spec, PartitionSpec):
            axes = []
            for ax in (spec if isinstance(spec, (list, tuple)) else [spec]):
                axes.append(tuple(ax) if isinstance(ax, list) else ax)
            spec = PartitionSpec(*axes)
        out.append((str(pattern), spec))
    return out


def _align_spec(spec: PartitionSpec, shape) -> PartitionSpec:
    """Rules describe the trailing dims: left-pad a shorter spec with None."""
    if len(spec) == 0 or len(spec) >= len(shape):
        return spec
    return PartitionSpec(*([None] * (len(shape) - len(spec)) + list(spec)))


def _spec_for(name: str, shape, compiled):
    if len(shape) == 0 or int(np.prod(shape)) == 1:
        return PartitionSpec()
    for pat, spec in compiled:
        if pat.search(name) is not None:
            return _align_spec(spec, shape)
    return None


def _shape(leaf):
    return tuple(getattr(leaf, "shape", ()))


def match_partition_rules(rules, params, on_miss: str = "error"):
    """A spec tree for ``params``: each leaf takes the spec of the first
    rule that ``search``-matches its path; ``on_miss`` ``"error"`` raises
    naming an unmatched param, ``"replicate"`` places it whole."""
    compiled = [(re.compile(pat), spec) for pat, spec in normalize_rules(rules)]

    def get_spec(name, leaf):
        spec = _spec_for(name, _shape(leaf), compiled)
        if spec is not None:
            return spec
        if on_miss == "replicate":
            return PartitionSpec()
        raise ValueError(f"no partition rule matches param {name!r}")

    return _rebuild(params, iter([get_spec(n, leaf) for n, leaf in tree_path_names(params)]))


def _mesh_sizes(mesh) -> Dict[str, int]:
    return dict(getattr(mesh, "shape", mesh))


def _clip_spec_to_mesh(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """Drop the axes a dim cannot honour on ``mesh`` (dim not divisible by
    the axis product, or the axis of size 1 or absent)."""
    sizes = _mesh_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries[: len(shape)]):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        keep = []
        factor = 1
        for ax in axes:
            size = sizes.get(ax, 1)
            if size > 1 and dim % (factor * size) == 0:
                keep.append(ax)
                factor *= size
        out.append(keep[0] if len(keep) == 1 else (tuple(keep) or None))
    return PartitionSpec(*out)


def partition_params(mesh, abstract_params, rules=None, on_miss: str = "replicate"):
    """A spec tree for ``abstract_params`` from the rules (``rules`` first,
    then ``DEFAULT_RULES``), each clipped to the mesh (a ``comm.Mesh`` or an
    {axis: size} dict) and the leaf's dims."""
    table = normalize_rules(rules or ()) + normalize_rules(DEFAULT_RULES)
    pspecs = match_partition_rules(table, abstract_params, on_miss=on_miss)
    leaves = [leaf for _, leaf in _items(abstract_params)]
    specs = [spec for _, spec in _items(pspecs)]
    return _rebuild(abstract_params, iter(
        [_clip_spec_to_mesh(s, _shape(leaf), mesh) for leaf, s in zip(leaves, specs)]))


def apply_rule_overrides(mesh, abstract_params, base_specs, rules):
    """Overlay user rules onto a spec tree: a leaf whose path matches a rule
    takes that rule's (clipped) spec, every other leaf keeps its own."""
    compiled = [(re.compile(p), s) for p, s in normalize_rules(rules)]
    flat = tree_path_names(abstract_params)
    base = [spec for _, spec in _items(base_specs)]
    assert len(flat) == len(base), (len(flat), len(base))
    out = []
    for (name, leaf), b in zip(flat, base):
        shape = _shape(leaf)
        spec = None if len(shape) == 0 or int(np.prod(shape)) == 1 \
            else _spec_for(name, shape, compiled)
        out.append(b if spec is None else _clip_spec_to_mesh(spec, shape, mesh))
    return _rebuild(abstract_params, iter(out))


def serving_mesh(data: int = 1, tensor: int = 1):
    """A ``("data", "tensor")``-shaped serving mesh over the FIRST
    ``data*tensor`` ranks of the world (``comm.subset_mesh``): its own
    process groups, and the global comm state left as it is, so engines of
    several widths coexist in one world. Raises the reference's
    ``ValueError`` for a shape wider than the world. A rank outside the
    mesh gets None."""
    from deepspeed_tpu_torch import comm

    world = comm.process_world()[1]
    need = int(data) * int(tensor)
    if need < 1:
        raise ValueError(f"mesh needs >= 1 device, got {data}x{tensor}")
    if need > world:
        raise ValueError(f"mesh {data}x{tensor} needs {need} devices, only {world} available")
    return comm.subset_mesh({"data": int(data), "tensor": int(tensor)})


def serving_placements(mesh, shapes, logical=None, rules=None, use_rules: bool = False):
    """The spec tree of a serving engine's params (``shapes``: leaves with
    a ``shape`` in the reference's layout, e.g. meta tensors), as
    the reference's ``InferenceEngine`` picks it: the regex table (user
    ``rules`` first, then ``DEFAULT_RULES``) under ``use_rules`` or without
    ``logical`` axis names; else the logical axes' placements
    (``ShardingPolicy`` at stage 0) with the user rules laid over them leaf
    by leaf. Every spec is clipped to the mesh and the leaf's dims
    (:func:`_clip_spec_to_mesh`): a dim the width does not divide, such as
    GPT-2's vocabulary of 50,257 over two ranks, stays whole."""
    if use_rules or logical is None:
        return partition_params(mesh, shapes, rules=rules)
    policy = ShardingPolicy(_mesh_sizes(mesh), stage=0)
    leaves = [leaf for _, leaf in _items(shapes)]
    names = [n for _, n in _items(logical)]
    base = _rebuild(shapes, iter([_clip_spec_to_mesh(policy.param_spec(_shape(leaf), n),
                                                     _shape(leaf), mesh)
                                  for leaf, n in zip(leaves, names)]))
    if rules:
        return apply_rule_overrides(mesh, shapes, base, rules)
    return base


def parse_mesh_arg(spec: str) -> Dict[str, int]:
    """``"DATA:TENSOR"`` (e.g. ``1:2``) or ``"axis=N,axis=M"`` -> a mesh
    shape dict."""
    spec = spec.strip()
    if "=" in spec:
        out = {}
        for part in spec.split(","):
            ax, _, n = part.partition("=")
            out[ax.strip()] = int(n)
        return out
    lo, sep, hi = spec.partition(":")
    if not sep:
        raise ValueError(f"--mesh wants DATA:TENSOR, got {spec!r}")
    return {"data": int(lo), "tensor": int(hi)}


def mesh_tensor_width(mesh: Optional[object]) -> int:
    """Size of the ``tensor`` axis (1 without a mesh)."""
    if mesh is None:
        return 1
    return int(_mesh_sizes(mesh).get("tensor", 1))


def kv_shard_width(mesh: Optional[object], cfg) -> int:
    """How many ways the KV cache's heads split on this mesh: the tensor
    width where the kv heads divide it, else 1."""
    t = mesh_tensor_width(mesh)
    if t <= 1 or cfg.kv_heads % t != 0:
        return 1
    return t
