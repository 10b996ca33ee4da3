"""Memory-bounded loading of (sharded) HF checkpoints (counterpart of
``deepspeed_tpu/module_inject/load_checkpoint.py``), with no ``transformers``
and no ``safetensors`` package: the port reads both itself.

- :class:`HFConfig` reads ``config.json`` (the counterpart of
  ``AutoConfig.from_pretrained``): its values as attributes, transformers'
  attribute aliases (GPT-2's ``hidden_size`` is ``n_embd``), and, where the
  file omits a field a policy reads, the default of transformers' config
  class for that ``model_type`` (``_FAMILIES``; transformers writes only the
  values that differ from its defaults).
- :class:`SafetensorsFile` maps one ``.safetensors`` file: an 8-byte
  little-endian header length, a JSON header (each tensor's dtype, shape and
  data offsets) and the raw bytes, read per tensor through ``mmap`` and
  ``torch.frombuffer`` in the stored dtype. A ``.bin`` file is mapped by
  ``torch.load(..., mmap=True, weights_only=True)``.
- :class:`ShardedStateDict` is the name -> tensor mapping the policies read,
  over an HF shard index (``model.safetensors.index.json`` /
  ``pytorch_model.bin.index.json``) or one file. An LRU of ``cache_shards``
  mapped files bounds what is open, and ``shard_loads`` counts the opens.
  Unlike the reference's, which reads a whole shard into f32 numpy on each
  miss, a lookup reads only that tensor's bytes, so the policies' walk
  (every layer's ``wq``, then every layer's ``wk``, ...) costs a reopened
  file's header across a shard boundary, never a re-read of its data.
"""

import json
import mmap
import os
import struct
from collections import OrderedDict
from typing import Tuple

import torch

from deepspeed_tpu_torch.utils.logging import logger

_SAFE_INDEX = "model.safetensors.index.json"
_BIN_INDEX = "pytorch_model.bin.index.json"
_SAFE_SINGLE = "model.safetensors"
_BIN_SINGLE = "pytorch_model.bin"
_CONFIG = "config.json"

# the defaults of transformers' config classes (4.57) for every field a
# policy reads, by model_type, and their attribute aliases (alias -> field)
_FAMILIES = {
    "gpt2": ({"vocab_size": 50257, "n_embd": 768, "n_layer": 12, "n_head": 12,
              "n_positions": 1024, "layer_norm_epsilon": 1e-5},
             {"hidden_size": "n_embd", "max_position_embeddings": "n_positions",
              "num_attention_heads": "n_head", "num_hidden_layers": "n_layer"}),
    "gpt_neo": ({"vocab_size": 50257, "hidden_size": 2048, "num_layers": 24, "num_heads": 16,
                 "intermediate_size": None, "max_position_embeddings": 2048,
                 "layer_norm_epsilon": 1e-5, "window_size": 256,
                 "attention_types": [[["global", "local"], 12]]},
                {"num_attention_heads": "num_heads", "num_hidden_layers": "num_layers"}),
    "llama": ({"vocab_size": 32000, "hidden_size": 4096, "num_hidden_layers": 32,
               "num_attention_heads": 32, "num_key_value_heads": None,
               "intermediate_size": 11008, "max_position_embeddings": 2048,
               "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "tie_word_embeddings": False}, {}),
    "mistral": ({"vocab_size": 32000, "hidden_size": 4096, "num_hidden_layers": 32,
                 "num_attention_heads": 32, "num_key_value_heads": 8,
                 "intermediate_size": 14336, "max_position_embeddings": 131072,
                 "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "sliding_window": 4096,
                 "tie_word_embeddings": False}, {}),
    "opt": ({"vocab_size": 50272, "hidden_size": 768, "num_hidden_layers": 12,
             "num_attention_heads": 12, "ffn_dim": 3072, "max_position_embeddings": 2048,
             "activation_function": "relu", "do_layer_norm_before": True,
             "word_embed_proj_dim": None, "tie_word_embeddings": True}, {}),
    "bloom": ({"vocab_size": 250880, "hidden_size": 64, "n_layer": 2, "n_head": 8,
               "layer_norm_epsilon": 1e-5},
              {"num_hidden_layers": "n_layer", "num_attention_heads": "n_head",
               "n_embed": "hidden_size"}),
    "gpt_neox": ({"vocab_size": 50432, "hidden_size": 6144, "num_hidden_layers": 44,
                  "num_attention_heads": 64, "intermediate_size": 24576,
                  "max_position_embeddings": 2048, "rotary_pct": 0.25, "rotary_emb_base": 10000,
                  "use_parallel_residual": True, "tie_word_embeddings": False,
                  "layer_norm_eps": 1e-5}, {}),
    "gptj": ({"vocab_size": 50400, "n_embd": 4096, "n_layer": 28, "n_head": 16,
              "n_positions": 2048, "rotary_dim": 64, "layer_norm_epsilon": 1e-5,
              "tie_word_embeddings": False},
             {"max_position_embeddings": "n_positions", "hidden_size": "n_embd",
              "num_attention_heads": "n_head", "num_hidden_layers": "n_layer"}),
    "bert": ({"vocab_size": 30522, "hidden_size": 768, "num_hidden_layers": 12,
              "num_attention_heads": 12, "intermediate_size": 3072,
              "max_position_embeddings": 512, "type_vocab_size": 2, "layer_norm_eps": 1e-12}, {}),
    "distilbert": ({"vocab_size": 30522, "dim": 768, "n_layers": 6, "n_heads": 12,
                    "hidden_dim": 3072, "max_position_embeddings": 512},
                   {"hidden_size": "dim", "num_attention_heads": "n_heads",
                    "num_hidden_layers": "n_layers"}),
    "clip_text_model": ({"vocab_size": 49408, "hidden_size": 512, "intermediate_size": 2048,
                         "num_hidden_layers": 12, "num_attention_heads": 8,
                         "max_position_embeddings": 77, "hidden_act": "quick_gelu",
                         "layer_norm_eps": 1e-5}, {}),
    "clip": ({}, {}),
}


def _expand_attention_types(types):
    """GPT-Neo's ``attention_types`` ([[kinds, repeat], ...]) -> one kind a
    layer (transformers' ``expand_attention_types_params``)."""
    return [kind for kinds, repeat in types for _ in range(repeat) for kind in kinds]


class HFConfig:
    """An HF ``config.json`` as attributes, with transformers' defaults for
    the fields the policies read (see the module docstring)."""

    def __init__(self, values: dict):
        values = dict(values)
        model_type = values.get("model_type", "")
        defaults, aliases = _FAMILIES.get(model_type, ({}, {}))
        for alias, name in aliases.items():
            if alias in values:  # transformers sets the alias after the field
                values[name] = values.pop(alias)
        merged = {"architectures": None, "tie_word_embeddings": True, **defaults, **values}
        if merged.get("num_key_value_heads", 0) is None:  # Llama/Mistral: MHA
            merged["num_key_value_heads"] = merged["num_attention_heads"]
        if model_type == "opt" and merged["word_embed_proj_dim"] is None:
            merged["word_embed_proj_dim"] = merged["hidden_size"]
        if model_type == "gpt_neo" and "attention_layers" not in values:
            merged["attention_layers"] = _expand_attention_types(merged["attention_types"])
        if model_type == "clip":
            merged["text_config"] = HFConfig(
                {**merged.get("text_config", {}), "model_type": "clip_text_model"})
        self.__dict__["_aliases"] = aliases
        self.__dict__.update(merged)

    def __getattr__(self, name):  # only for names that are not attributes
        aliases = self.__dict__.get("_aliases", {})
        if name in aliases:
            return getattr(self, aliases[name])
        raise AttributeError(name)

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, HFConfig) else v)
                for k, v in self.__dict__.items() if k != "_aliases"}

    @classmethod
    def from_pretrained(cls, ckpt_dir: str) -> "HFConfig":
        with open(os.path.join(ckpt_dir, _CONFIG)) as f:
            return cls(json.load(f))

    def save_pretrained(self, save_dir: str) -> str:
        """Write ``config.json`` (every value held, transformers reads it)."""
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, _CONFIG)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        return path


_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}


class SafetensorsFile:
    """One ``.safetensors`` file, mapped copy-on-write (the pages are the
    file's until a tensor is written to). ``tensor(key)`` reads that tensor
    only: a view of the mapping in its stored dtype, which keeps the
    mapping alive."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self.header = header
        self._base = 8 + n

    def keys(self):
        return self.header.keys()

    def tensor(self, key: str) -> torch.Tensor:
        info = self.header[key]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        offset = self._base + start
        if end == start:
            return torch.empty(info["shape"], dtype=dtype)
        if offset % dtype.itemsize:  # an unaligned tensor: copy its bytes out
            buf, offset = bytearray(self._map[offset:self._base + end]), 0
        else:
            buf = self._map
        flat = torch.frombuffer(buf, dtype=dtype, count=(end - start) // dtype.itemsize,
                                offset=offset)
        return flat.reshape(info["shape"])


class _BinFile:
    """One ``.bin`` (torch.save zip) file, its storages mapped."""

    def __init__(self, path: str):
        self._state = torch.load(path, map_location="cpu", mmap=True, weights_only=True)

    def keys(self):
        return self._state.keys()

    def tensor(self, key: str) -> torch.Tensor:
        return self._state[key]


def _open(path: str):
    return SafetensorsFile(path) if path.endswith(".safetensors") else _BinFile(path)


def load_file(path: str) -> dict:
    """Every tensor of one checkpoint file, as mapped views in the stored
    dtype (``safetensors.torch.load_file``'s counterpart)."""
    f = _open(path)
    return {k: f.tensor(k) for k in f.keys()}


class ShardedStateDict:
    """Lazy name -> tensor mapping over an HF checkpoint directory."""

    def __init__(self, ckpt_dir: str, cache_shards: int = 1):
        self.dir = ckpt_dir
        self.cache_shards = max(1, cache_shards)
        self._cache: "OrderedDict[str, object]" = OrderedDict()
        self.shard_loads = 0  # shard files opened (a header or pickle read each)
        self.bytes_read = 0  # tensor bytes handed to the caller

        for index in (_SAFE_INDEX, _BIN_INDEX):
            if os.path.exists(os.path.join(ckpt_dir, index)):
                with open(os.path.join(ckpt_dir, index)) as f:
                    self.weight_map = json.load(f)["weight_map"]
                break
        else:
            single = [f for f in (_SAFE_SINGLE, _BIN_SINGLE)
                      if os.path.exists(os.path.join(ckpt_dir, f))]
            if not single:
                raise FileNotFoundError(
                    f"no HF checkpoint found in {ckpt_dir} (looked for "
                    f"{_SAFE_INDEX}, {_BIN_INDEX}, {_SAFE_SINGLE}, {_BIN_SINGLE})")
            self.weight_map = {k: single[0] for k in self._shard(single[0]).keys()}
        n_shards = len(set(self.weight_map.values()))
        logger.info(
            f"sharded checkpoint at {ckpt_dir}: {len(self.weight_map)} tensors in "
            f"{n_shards} shard(s), cache_shards={self.cache_shards}"
        )

    def _shard(self, fname: str):
        if fname in self._cache:
            self._cache.move_to_end(fname)
            return self._cache[fname]
        shard = _open(os.path.join(self.dir, fname))
        self.shard_loads += 1
        self._cache[fname] = shard
        while len(self._cache) > self.cache_shards:
            self._cache.popitem(last=False)
        return shard

    # --- the mapping protocol the policies use ---
    def __getitem__(self, key: str) -> torch.Tensor:
        t = self._shard(self.weight_map[key]).tensor(key)
        self.bytes_read += t.numel() * t.element_size()
        return t

    def __contains__(self, key: str) -> bool:
        return key in self.weight_map

    def __iter__(self):
        return iter(self.weight_map)

    def keys(self):
        return self.weight_map.keys()

    def __len__(self):
        return len(self.weight_map)


def convert_hf_checkpoint(ckpt_dir: str, cache_shards: int = 1) -> Tuple:
    """HF checkpoint directory -> (TransformerConfig, the reference's param
    tree of tensors in the stored dtype), without the whole source state
    dict in memory at once (reference: load_model_with_checkpoint,
    load_checkpoint.py:255)."""
    from deepspeed_tpu_torch.module_inject.policies import policy_for

    hf_config = HFConfig.from_pretrained(ckpt_dir)
    policy = policy_for(hf_config)
    cfg = policy.config(hf_config)
    state = ShardedStateDict(ckpt_dir, cache_shards=cache_shards)
    params = policy.params(state, cfg)
    logger.info(
        f"converted sharded {hf_config.model_type} checkpoint "
        f"({cfg.num_params():,} params, {state.shard_loads} shard opens, "
        f"{state.bytes_read:,} tensor bytes read)"
    )
    return cfg, params
