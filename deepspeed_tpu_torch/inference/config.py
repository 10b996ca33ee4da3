"""Inference config, counterpart of ``deepspeed_tpu/inference/config.py``: the
same fields and defaults, so both packages parse the same JSON. Features
outside the port's serving slice parse here and raise in the engine
(ROADMAP.md)."""

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.runtime.config_utils import from_dict
from deepspeed_tpu_torch.telemetry.config import TelemetryConfig


@dataclass
class QuantConfig:
    enabled: bool = False
    num_bits: int = 8


@dataclass
class MeshConfig:
    """Serving mesh for tensor-parallel inference (docs/inference.md
    "Tensor-parallel serving"). ``shape`` maps mesh axis names
    (comm.MESH_AXES; serving uses ``data``/``tensor``) to sizes — an
    explicit shape smaller than the host's device count builds a SUBSET
    mesh over the first ``prod(shape)`` devices (virtual-mesh A/Bs run
    several widths in one process); ``-1`` absorbs remaining devices as
    before. ``rules`` are regex partition-rule overrides,
    ``[[pattern, [axis, ...]], ...]`` matched against ``/``-joined param
    paths: on a model carrying ``logical_specs`` annotations they
    override placement PER MATCHED LEAF (unmatched params keep their
    annotation); without annotations — or under ``use_rules`` — they
    front the whole-tree regex table (parallel/partition.DEFAULT_RULES).
    The default (no shape, no rules) is the single-chip degenerate mesh
    — bit-identical to pre-mesh configs."""

    shape: Optional[Dict[str, int]] = None
    # regex partition-rule overrides (see class docstring)
    rules: Optional[List[Any]] = None
    # force the regex rule table even for models carrying logical_specs
    # annotations (default: annotations win, regex serves models without)
    use_rules: bool = False


@dataclass
class TensorParallelConfig:
    tp_size: int = 1
    enabled: bool = True


@dataclass
class MoEInferenceConfig:
    enabled: bool = False
    ep_size: int = 1


@dataclass
class SpeculativeConfig:
    """Speculative decoding (lossless: emitted tokens follow the target
    model's sampling distribution; greedy mode matches plain greedy decode
    token-for-token). ``mode`` picks the proposal source: ``"draft"`` — a
    second (smaller) model resident on the same mesh; ``"ngram"`` —
    self-drafting from the request's own token history
    (inference/ngram.py), no second model needed. ``pool`` additionally
    enables the speculative CONTINUOUS-BATCHING tick (docs/inference.md
    "Speculative decoding"): every pooled serving tick proposes
    ``num_draft_tokens`` per active row and verifies them in one target
    forward; requires single-token ticks."""

    enabled: bool = False
    num_draft_tokens: int = 4  # gamma: draft proposals verified per round
    mode: str = "draft"        # "draft" | "ngram"
    pool: bool = False         # speculate inside the pooled serving tick
    ngram_max_order: int = 3   # longest context suffix the ngram matcher tries


@dataclass
class InferenceConfig:
    dtype: str = "bfloat16"  # float32 | float16 | bfloat16 | int8 (weight quant)
    # KV-cache storage format: "model" (cache in model dtype) or "int8"
    # (per-token-per-head symmetric quantization — halves the cache-read
    # bytes that bound decode at long context and doubles servable context;
    # compute dequantizes at the attention read)
    kv_cache_dtype: str = "model"
    # tight-read cache geometry (default ON): decode/segment steps attend a
    # bucketed ACTIVE length (power-of-2 from kv_read_floor, block-granular
    # static slices over the cache time axis with the tail masked) instead
    # of the full allocated cache_len, and the per-token decode loop grows
    # its cache by bucket migration instead of allocating max_len upfront.
    # Decode is an HBM-bandwidth roofline — cache bytes streamed per token
    # are the cost — so this is a direct throughput lever at long
    # allocations (docs/inference.md "Cache geometry"). Token streams are
    # identical (the masked tail contributes exact zeros). Rolling (ring)
    # caches and speculative decoding keep their own geometry.
    kv_tight_read: bool = True
    # smallest tight-read bucket / initial migrated-cache allocation; each
    # growth doubles it. Tests shrink it so tiny models cross several
    # buckets.
    kv_read_floor: int = 128
    tensor_parallel: TensorParallelConfig = field(default_factory=TensorParallelConfig)
    moe: MoEInferenceConfig = field(default_factory=MoEInferenceConfig)
    quant: QuantConfig = field(default_factory=QuantConfig)
    speculative: SpeculativeConfig = field(default_factory=SpeculativeConfig)
    # structured request traces + latency metrics (docs/telemetry.md);
    # default off — generate() behavior is unchanged when disabled
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    # the whole-generation path (prefill, then bucket-staged decode loops
    # over a cache allocated once). In the reference it is one compiled
    # program; the port runs it eagerly. False selects the reference's
    # per-token loop with bucket migration, not ported yet (ROADMAP.md).
    fused_generate: bool = True
    # rolling (ring-buffer) KV cache for uniform-sliding-window models
    # (Mistral): the cache holds only the last `window` positions — decode
    # HBM footprint and cache-read bytes are O(window) instead of O(total
    # length). Auto-applies when safe (uniform window, rope/no pos-emb,
    # flash prefill available, no speculative decoding); exact — slot
    # positions derive modulo the cache length.
    rolling_kv_cache: bool = True
    # chunked prefill: stream the prompt through fixed (B, chunk) segments
    # (not ported yet, ROADMAP.md)
    prefill_chunk_size: Optional[int] = None
    # override the model's attention implementation for inference
    # ("xla" | "pallas" | "block_sparse"); None keeps the model config's.
    # "pallas" names the flash-attention path: the hand-written CUDA
    # kernel in the port (ops/csrc/flash_fwd.cu).
    attn_impl: Optional[str] = None
    max_tokens: int = 1024  # alias accepted from reference configs
    replace_with_kernel_inject: bool = False  # accepted for config compatibility
    replace_method: str = "auto"
    enable_cuda_graph: bool = False  # accepted; CUDA graphs come in a later slice
    profile_model_time: bool = False
    # serving mesh block: shape + regex partition-rule overrides; a plain
    # {axis: size} dict (the pre-mesh-block form) still parses as the
    # shape alone. None = the engine's default mesh (single-chip
    # degenerate unless tensor_parallel.tp_size says otherwise).
    mesh: MeshConfig = field(default_factory=MeshConfig)

    @classmethod
    def parse(cls, config) -> "InferenceConfig":
        if isinstance(config, cls):
            return config
        config = dict(config or {})
        # reference compat: max_tokens is the old name for max_out_tokens
        if "max_tokens" in config and "max_out_tokens" not in config:
            config["max_out_tokens"] = config["max_tokens"]
        # reference compat: mp_size / tensor_parallel.tp_size
        if "mp_size" in config:
            config.setdefault("tensor_parallel", {})
            if isinstance(config["tensor_parallel"], dict):
                config["tensor_parallel"].setdefault("tp_size", config.pop("mp_size"))
            else:
                config.pop("mp_size")
        tp = config.get("tensor_parallel", {})
        moe = config.get("moe", {})
        if isinstance(moe, bool):
            moe = {"enabled": moe}
        quant = config.get("quant", {})
        if isinstance(quant, bool):
            quant = {"enabled": quant}
        dtype = config.get("dtype", "bfloat16")
        if not isinstance(dtype, str):
            dtype = {"torch.float32": "float32", "torch.float16": "float16",
                     "torch.bfloat16": "bfloat16", "torch.int8": "int8"}.get(str(dtype), "bfloat16")
        spec = config.get("speculative", {})
        if isinstance(spec, bool):
            spec = {"enabled": spec}
        telemetry = config.get("telemetry", {})
        if isinstance(telemetry, bool):
            telemetry = {"enabled": telemetry}
        if isinstance(telemetry, TelemetryConfig):
            telemetry = dict(telemetry.__dict__)
        mesh = config.get("mesh", {})
        if not isinstance(mesh, MeshConfig):
            mesh = dict(mesh or {})
            if mesh and not (set(mesh) & set(MeshConfig.__dataclass_fields__)):
                # pre-mesh-block form: a plain {axis: size} dict IS the shape
                mesh = {"shape": mesh}
            mesh = from_dict(MeshConfig, mesh)
        known = {f for f in cls.__dataclass_fields__}
        base = {k: v for k, v in config.items()
                if k in known and k not in ("tensor_parallel", "moe", "quant", "speculative",
                                            "telemetry", "dtype", "mesh")}
        return cls(
            dtype=dtype,
            tensor_parallel=from_dict(TensorParallelConfig, tp if isinstance(tp, dict) else {}),
            moe=from_dict(MoEInferenceConfig, moe),
            quant=from_dict(QuantConfig, quant),
            speculative=from_dict(SpeculativeConfig, spec),
            telemetry=from_dict(TelemetryConfig, telemetry),
            mesh=mesh,
            **base,
        )
