"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from the sources in this checkout (one
nvcc per source, started together), reports ptxas's registers and spills and
counts the tensor-core (HGMMA) instructions of the 16-bit kernels of the
flash forward and backward and of the block-sparse forward and backward in
their SASS, holds each kernel against its plain PyTorch version on the card
(K1-K3 flash attention, each in both of its variants: tensor core for bf16,
f32 FMA for f32; K4-K6 block-sparse attention, each in both of theirs:
tensor core for 16-bit inputs at tile 64, f32 FMA for f32 and tiles 16/32;
K3's GQA head sum bit for bit, K7-K8 fused LayerNorm/RMSNorm on their
vector and scalar load paths), and drives the port's paths with random
weights from a seed (the model's every LayerNorm is K7 forward and K8
backward):
  - the fused-op surface (``ops/transformer/fused_ops``: ``fused_layernorm``
    -> a 768 x 3072 matmul -> ``fused_bias_gelu`` -> a 3072 x 768 matmul ->
    ``fused_bias_dropout_residual``) at GPT-2 125M's training width, B8 S1024
    bf16, forward and backward through K7/K8, against the same chain built
    from the plain versions, and its dropout at ratio 0.1;
  - serving (``deepspeed_tpu_torch.init_inference`` -> ``generate``) on
    GPT-2 350M at full width and depth: three requests, then a profiled
    breakdown;
  - the decode path's other request shapes on the same model (12 of its 24
    layers, for the script's time limit): int8 weights
    (W8A8) and the int8 KV cache in ``bench_decode``'s geometry (B 8 x 128
    + 128, greedy), four engines {bf16, int8} weights x {model, int8} KV on
    the same weights, each int8 engine's logits against the same engine on
    the CPU (``decode_int8``); then ragged prompts (left and right padded)
    prefilled whole and in chunks of 64 and 48, with either KV type, each
    row against its own single-row ``generate`` (``ragged_chunked``);
  - the continuous-batching serving tick (``ContinuousBatchingEngine``) on
    GPT-2 125M at full width and depth in ``bench_serving``'s geometry (8
    slots, cache 256, burst ticks of 4, 32 requests of 64 new tokens), at
    ``pipeline_depth`` 0 and 1, each request against its own single-row
    ``generate``, ticks dispatched where a host sync raises
    (``serve_pool``; ``--serve-pool`` runs this phase alone);
  - speculative decoding (``--spec`` runs these phases alone): the draft
    probe of ``bench_decode`` (GPT-2 350M target, a 4-layer draft of the
    same preset, B 8 x 128 + 128 greedy, gamma 2/4/8, plain ``generate`` as
    the yardstick; ``spec_generate``) and the speculative pool of
    ``bench_serving`` (GPT-2 125M, ngram at gamma 2/4/8, then a 3-layer
    draft at the best gamma, the plain single-token pool as the yardstick,
    a self-draft pool's acceptance, spec ticks dispatched where a host sync
    raises; ``serve_pool_spec``), each stream held to plain greedy under
    the bf16 tie rule;
  - the serving layer (``deepspeed_tpu_torch.serving.ServingEngine`` over
    the batching engine, with the telemetry hub, the ops server, the
    single-replica loadgen and fault recovery) on the serving tick's GPT-2
    125M engine build: the layer's cost against the bare pool on the same
    schedule (``serve_layer_overhead``), two open-loop runs of the loadgen
    (fifo at 4 req/s with a ``/metrics`` scrape and a rebuilt timeline; edf
    with deadlines, all arriving at once, shedding and expiring;
    ``serve_layer_load``), and a fault plan with two rebuilds at depths 0
    and 1 (``serve_layer_chaos``); ``--serve-layer`` runs these alone;
  - the serving fleet (``FleetRouter`` over ``ServingEngine`` replicas on
    one card, one host thread and one hub, the ops server live) on the same
    build: a 1-replica fleet against the bare layer on the replayed
    schedule (streams and engine rids bit for bit), the loadgen's
    ``--replicas 1,2`` sweep at Poisson 4 req/s, a kill of a replica
    holding running streams with a replacement 5 ticks later (lost 0,
    migrated streams under the bf16 tie rule), ``rolling_under_load`` with
    the ops plane scraped mid-run, and ``burst_frontend`` at 1 and 2 fixed
    replicas and autoscaled 1:2 (``serve_fleet``; ``--fleet`` runs it
    alone);
  - training (``deepspeed_tpu_torch.initialize`` -> ``forward`` /
    ``backward`` / ``step``) on GPT-2 125M at full width and depth, seq
    1024, micro-batch 8, bf16, flash attention, AdamW: 2 warm-up and 10
    timed steps on one fixed batch, a first-step comparison with the
    xla-attention engine on the same weights, a gradient check of the flash
    engine against the xla engine in f32 at 2 layers, one f32 step at 2
    layers on the card against the same step on the CPU (the model's norms
    through K7/K8 against their plain versions), then a profiled breakdown;
  - training resumed (``--train-resume`` runs these phases alone): the same
    GPT-2 125M saved, loaded and resumed, sync and async, bit for bit against
    an uninterrupted run, torn and corrupt tags refused, two SDC probes of
    one batch equal (``train_resume``); then a ``TrainSupervisor`` run under
    a plan of a dispatch error, a torn write, a preemption, a fetch hang and
    a flipped gradient bit, its loss stream bit for bit the fault-free
    run's (``train_supervised``); both write their tags under
    ``checkpoint_dir_root()`` and remove them;
  - block-sparse training, the same entry points on GPT-2 125M at full
    width and depth, seq 4096, micro-batch 2, bf16, the fixed sparsity
    layout: 2 warm-up and 10 timed steps, a model-level check of the
    block-sparse kernels with the dense layout (against the flash engine in
    bf16, against the xla engine in f32), then a profiled breakdown;
  - Llama-family serving (``--llama`` runs these phases alone): the
    ``llama2-7b`` preset at full width and depth, B 8 x 512 + 64 greedy,
    fused and per-token with bucket migration, the streams equal and held to
    the uncached teacher-forced forward, the allocation walk to the
    reference's rule, the decode step beside its bound (``llama_serve``);
    then Mistral 7B's published shape, B 1 x 4,608 + 256 greedy with the
    rolling (ring) KV cache on and off (``mistral_ring``). Rope and the
    window and ring masks are plain PyTorch, as the reference computes them
    outside Pallas; the prefills run K1 (GQA and the window band for
    Mistral), every norm K7;
  - HF models in and out (``module_inject``; ``--hf`` runs these phases
    alone, after ``llama_serve``): ``llama_serve``'s Llama 2 7B weights
    written as ``meta-llama/Llama-2-7b-hf``'s directory (two bf16
    safetensors shards, their index and config.json, by this script's own
    writer) and loaded back through ``init_inference(dir)``, the stream
    equal to ``llama_serve``'s bit for bit (``hf_load_llama``); GPT-2 350M
    exported to an HF state dict and loaded from an in-memory module and
    from a ``save_hf_checkpoint`` directory, both streams equal to the
    direct engine's (``hf_load_gpt2``); and every decoder family the
    policies convert at its published config.json values (BLOOM-560m:
    ALiBi and the embedding norm; Pythia-410m: the parallel residual and
    partial rotary; GPT-J 6B: the shared LN and interleaved rotary; OPT-125m
    pre- and post-LN; GPT-Neo-125M: per-layer windows), fused, per-token and
    through the batching pool (``hf_families``). The card's machine has
    neither transformers nor safetensors, and the port needs neither;
  - training every decoder family the port serves (``--train-decoders`` runs
    these phases alone): the ``llama2-7b`` preset at full width, 4 of its 32
    layers, B 2 x S 4096, flash (K1-K3 at hd 128, K7/K8 in RMSNorm), its
    first step against the xla engine and a 2-layer f32 gradient check
    (``train_llama``, with a profiled step); Mistral 7B's shape at 2 layers,
    B 1 x S 8192, the window band and GQA in K1-K3 (``train_mistral``); the
    six HF families at their published widths and 2 layers, each with an
    f32 step on the card against the CPU (``train_families``); and Llama 2
    7B's layout at 2 layers fine-tuned from an HF directory, exported and
    served from the export (``hf_finetune``);
  - ZeRO through the port's comm (``--train-zero`` runs this phase alone):
    a process group started by ``init_distributed`` on NCCL, one rank a
    card, on a ``file://`` store; each facade collective on CUDA f32 and
    bf16; GPT-2 125M (B8 S1024 bf16, flash) at ZeRO stages 0-3 on
    ``{fsdp: -1}``, 5 steps each, and Llama 2 7B's width at 2 layers (B1
    S4096) at stages 0 and 3, 3 steps each: loss streams and final params
    bit for bit across the stages and, for GPT-2, to the engine without a
    process group; one step's NCCL calls under the profiler
    (``train_zero``);
  - the tensor-parallel serving mesh (``--serve-mesh`` runs this phase
    alone): (a) world 1 through NCCL, the engines on ``{"data": 1,
    "tensor": 1}`` against the engines without a mesh, Llama 2 7B's width
    at 4 layers (B 8 x 512 + 64, fused and per token), GPT-2 125M's pool and
    the serving layer's degrade ladder; (b) tensor 2 as two processes
    sharing the card over gloo, each rank running K1 at 16 heads (held
    against the plain attention), its prefill logits and streams held
    against world 1's (``serve_mesh``);
  - ZeRO-sharded checkpoints (``--train-zero-ckpt`` runs this phase alone):
    GPT-2 125M (B8 S1024 bf16, flash) at stage 3 on ``{fsdp: 2}`` as two
    processes sharing the card over gloo, saved after 3 of 5 steps (sync,
    then async from a resumed engine): the resumed stream and state bit for
    bit the uninterrupted run's, the async tag's bytes the sync tag's; the
    tag loaded at stage 0 at world 1 over NCCL, leaf for leaf, and through
    ``zero_to_fp32`` and the universal directory onto stage 1
    (``train_zero_ckpt``).
Each path is driven with the kernel launch counts set to 0 just before it
and read just after. Prints JSON lines as it goes; the line before the last
names the card and its power limit (as nvidia-smi reports them), and the
last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without that line. Needs one CUDA card; exits non-zero without one.
Imports nothing of JAX or of the reference package.
"""

import contextlib
import dataclasses
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# the port is imported from this checkout, whatever the working directory
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit):
# the tensor cores in bf16, the CUDA cores in f32, and memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
PEAK_HBM_BYTES = 3.35e12

# K1 against _reference_fwd: the kernel rounds p to the input dtype before
# PV (as the TPU kernel does) where the reference keeps f32, so o differs by
# a few roundings of the input dtype; bf16 keeps 8 mantissa bits, so at
# |o| <= 4 two roundings are up to 3e-2; f32 (the FMA kernel) differs only in
# summation order: 1e-5. lse is f32 on both sides: 1e-5.
K1_O_TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-5}
K1_LSE_TOL = 1e-5
# K2/K3 against _reference_bwd on the same (q, k, v, o, lse, do), as max |Δ|
# over the largest |gradient| of the plain version. bf16: the kernels round
# ds (and, in K3, p) to bf16 before the products that use them, as the TPU
# kernels do, and round their f32 sums once at the output, where the plain
# version keeps f32; each rounding is unbiased and at most 2**-9 relative,
# so the gradients differ by a few such ulps: 2**-6. f32: the same values in
# another summation order: 1e-4.
GRAD_REL_TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-4}
# training: the first loss of a randomly initialised GPT-2 is near ln(V)
# (logits of std ~0.5 add ~0.15), so within 0.5 of it; on one fixed batch at
# lr 1e-4 the mean of the last 3 of 12 losses falls at least 0.25 below the
# first. Against the xla-attention engine on the same weights, first step
# in bf16: the two attention paths round at different places (bf16 q.k
# logits on the xla path, bf16 p and ds in the kernels); loss within 1e-3
# and global grad norm within 1 %. The per-layer q/k/v blocks of the wqkv
# gradient are reported. The model's gradients are held in f32 (TF32 off),
# 2 layers: every gradient leaf of the flash engine within 1e-4 of the
# largest |gradient| of the same leaf of the xla engine, and the loss (~11)
# within 1e-4 (1e-5 relative): summation order only.
FIRST_LOSS_TOL = 0.5
LOSS_DROP = 0.25
TRAIN_LOSS_TOL = 1e-3
TRAIN_GNORM_REL_TOL = 0.01
F32_GRAD_REL_TOL = 1e-4
F32_LOSS_TOL = 1e-4
# K4-K6 against their plain versions (block_sparse_attention._reference_fwd /
# _reference_bwd) on the same inputs, as max |Δ| over max |plain|: the kernels
# keep f32 throughout, as the plain versions do, and round once at the store
# (the tensor-core K5/K6 split p and ds into 16-bit parts that keep them below
# f32's own rounding, and sum each tile in f32), so bf16 is one rounding
# (2**-9) plus summation order: 2**-8; fp16 2**-11; f32 1e-5. For the 16-bit
# rows the gradients that kernel and plain version round off the exact
# (float64) value are counted: all, and in the top binade, where one such
# element misses the tolerance. lse is f32 on both
# sides: 1e-5 absolute. A layout row that is all zero gives o = 0 and dq = 0
# exactly.
BS_REL_TOL = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11, torch.float32: 1e-5}
BS_LSE_TOL = 1e-5
# K7/K8 against their plain versions (fused_norm._reference_fwd/_reference_bwd)
# on the same inputs, as max |Δ| over max |plain|: both compute in f32 and
# round once at the output, so out and dx are one rounding plus summation
# order apart: 2**-8 in bf16/f16, 1e-5 in f32; mu and rstd (f32) 1e-5;
# dscale and dbias are f32 sums over all rows in another order (K8's
# per-block partials, then their fixed-order sum): 1e-4, and 2**-8 after a cast
# to bf16.
NORM_TOL = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -8, torch.float32: 1e-5}
NORM_STAT_TOL = 1e-5
NORM_SUM_TOL = 1e-4
NORM_SUM_BF16_TOL = 2.0 ** -8
# the model's norms through K7/K8 on the card against the plain versions on
# the CPU, one f32 step of a 2-layer engine, the same weights and batch: the
# loss (~11) within 1e-5 (1e-6 relative) and every gradient leaf within
# F32_GRAD_REL_TOL of its max |grad| (summation order only)
NORM_MODEL_LOSS_TOL = 1e-5
# a relu's input, card against CPU in one f32 step: the two sums round ~1e-6
# apart at O(1) values, so an input that straddles 0 between them lies within
# that of 0, and either side's branch is a valid subgradient there; a
# straddle farther from 0 than 1e-4 is a fault, not rounding
RELU_KINK_TOL = 1e-4
# the fused-op chain in bf16, K7/K8 against the plain LayerNorm under
# autograd, the rest of the chain the same: loss within 1e-3 relative, every
# gradient within 2**-6 of its largest |plain| value (a few bf16 roundings
# through two matmuls); the dropout's keep rate within 4 sigma of 1 - ratio
FUSED_LOSS_REL_TOL = 1e-3
FUSED_GRAD_REL_TOL = 2.0 ** -6
# the profiler's kernel times against CUDA events around the same step:
# kernels on one stream do not overlap, so their sum stays within the span
# between the events; 2 % for the two clocks' granularity
PROFILER_SPAN_TOL = 0.02
# the H100's L2: a memory-bound kernel timed on one input reads it from L2
L2_BYTES = 50 * 2 ** 20
# the block-sparse model with the dense layout computes full causal
# attention: against the flash engine, first step in bf16, the same bounds
# as the flash engine against the xla engine (the kernels round p and ds at
# different places); in f32 at 2 layers against the xla engine, the same
# bounds as the flash engine's f32 check (summation order only)
# pallas-engine prefill logits against the xla-attention engine, both bf16
# on the same weights: the two attention paths round at different places
# (bf16 q.k logits on the xla path, bf16 p in the kernel), and the
# difference is carried through 24 residual layers; logits here have a
# spread of about 0.6, so 0.1 is a few bf16 roundings of the residual
# stream. Top-1 must agree on every row whose top-2 margin exceeds twice
# the tolerance (closer rows are ties either path may break).
LOGITS_TOL = 0.1

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the k1 and k2_k3 rows at the decoder-training phases' shapes
TRAIN_K1_ROWS = ("i_llama_train_b2_s4096_h32_hd128",
                 "j_mistral_train_b1_s8192_h32_hkv8_hd128_w4096")
TRAIN_K23_ROWS = ("f_llama_train_b2_s4096_h32_hd128",
                  "g_mistral_train_b1_s8192_h32_hkv8_hd128_w4096")
# K1's kernels by (dtype, head dim), as substrings of their mangled names:
# every instantiation of the tensor-core kernel (bf16, f16), and the FMA
# kernel for f32
FWD_TAGS = {
    **{f"{name}_hd{hd}": f"flash_fwd_kernel_wgmmaI{mangled}Li{hd}E"
       for name, mangled in (("bf16", "13__nv_bfloat16"), ("f16", "6__half"))
       for hd in (16, 32, 64, 128)},
    "f32_hd64": "flash_fwd_kernelIfLi64E",
    "f32_hd128": "flash_fwd_kernelIfLi128E",
}
# K2/K3's kernels by (kernel, dtype, head dim), as substrings of their mangled
# names: the tensor-core kernels for bf16, the FMA kernels for f32
BWD_PTXAS_TAGS = {
    "dq_bf16_hd64": "flash_bwd_dq_kernel_wgmmaI13__nv_bfloat16Li64E",
    "dkv_bf16_hd64": "flash_bwd_dkv_kernel_wgmmaI13__nv_bfloat16Li64E",
    "dq_bf16_hd128": "flash_bwd_dq_kernel_wgmmaI13__nv_bfloat16Li128E",
    "dkv_bf16_hd128": "flash_bwd_dkv_kernel_wgmmaI13__nv_bfloat16Li128E",
    "dq_f32_hd64": "flash_bwd_dq_kernelIfLi64E",
    "dkv_f32_hd64": "flash_bwd_dkv_kernelIfLi64E",
    "dq_f32_hd128": "flash_bwd_dq_kernelIfLi128E",
    "dkv_f32_hd128": "flash_bwd_dkv_kernelIfLi128E",
}
# the bf16 K2/K3 SASS's wgmma instructions, one per m64n64k16 product step
# (K2: Q K^T, dO V^T, dS K; K3: K Q^T, V dO^T, P^T dO, dS^T Q)
BWD_HGMMA = {"dq_bf16_hd64": 12, "dkv_bf16_hd64": 16, "dq_bf16_hd128": 24,
             "dkv_bf16_hd128": 32}
SPARSE_KERNELS = ("block_sparse_fwd", "block_sparse_bwd_dq", "block_sparse_bwd_dkv")
# the tensor-core K5/K6 (16-bit, tile 64) by (kernel, dtype, head dim), as
# substrings of their mangled names, and the HGMMA instructions their SASS
# must hold, one per m64n64k16 product step: Q K^T and dO V^T (K5) or K Q^T
# and V dO^T (K6) step over hd / 16; the products of the split f32 operand
# (ds K in K5; p^T dO and ds^T Q in K6), one for each of its 16-bit parts
# (block_sparse_bwd.cu kParts: 3 in bf16, 2 in f16), over the tile's 64 rows
# in 4 steps per 64-column panel of the gradient: both panels of dq at hd
# 128, one panel of dk/dv (K6 runs a block per panel)
SPARSE_BWD_PARTS = {"bf16": 3, "f16": 2}
SPARSE_BWD_TAGS = {
    f"{kern}_{name}_hd{hd}": f"block_sparse_bwd_{kern}_kernel_wgmmaI{mangled}Li{hd}E"
    for kern in ("dq", "dkv") for name, mangled in (("bf16", "13__nv_bfloat16"), ("f16", "6__half"))
    for hd in (16, 32, 64, 128)}
SPARSE_BWD_HGMMA = {
    f"{kern}_{name}_hd{hd}":
        2 * hd // 16 + (parts * 4 * max(1, hd // 64) if kern == "dq" else 2 * parts * 4)
    for kern in ("dq", "dkv") for name, parts in SPARSE_BWD_PARTS.items()
    for hd in (16, 32, 64, 128)}
# the tensor-core K4 (16-bit, tile 64) likewise: Q K^T steps over hd / 16,
# and P V, one product for each 16-bit part of p (as K5's ds K), over the
# tile's 64 rows in 4 steps per 64-column panel of o
SPARSE_FWD_TAGS = {
    f"{name}_hd{hd}": f"block_sparse_fwd_kernel_wgmmaI{mangled}Li{hd}E"
    for name, mangled in (("bf16", "13__nv_bfloat16"), ("f16", "6__half"))
    for hd in (16, 32, 64, 128)}
SPARSE_FWD_HGMMA = {
    f"{name}_hd{hd}": hd // 16 + parts * 4 * max(1, hd // 64)
    for name, parts in SPARSE_BWD_PARTS.items() for hd in (16, 32, 64, 128)}
NORM_KERNELS = ("fused_norm_fwd", "fused_norm_bwd")
# K7/K8's instantiations at the k7_k8 shapes (fused_norm.cu's template
# arguments: x's type, the weights' type, 16-byte chunks a thread, vector path)
NORM_TAGS = {
    "fused_norm_fwd_bf16_vector_chunks3": "fused_norm_fwd_kernelI13__nv_bfloat16S1_Li3ELb1E",
    "fused_norm_bwd_bf16_vector_chunks3": "fused_norm_bwd_kernelI13__nv_bfloat16S1_Li3ELb1E",
    "fused_norm_fwd_bf16_vector_chunks4": "fused_norm_fwd_kernelI13__nv_bfloat16S1_Li4ELb1E",
    "fused_norm_bwd_bf16_vector_chunks4": "fused_norm_bwd_kernelI13__nv_bfloat16S1_Li4ELb1E",
    "fused_norm_fwd_f32_vector_chunks4": "fused_norm_fwd_kernelIffLi4ELb1E",
    "fused_norm_bwd_f32_vector_chunks4": "fused_norm_bwd_kernelIffLi4ELb1E",
    "fused_norm_fwd_f16_f32w_scalar_chunks1": "fused_norm_fwd_kernelI6__halffLi1ELb0E",
    "fused_norm_bwd_f16_f32w_scalar_chunks1": "fused_norm_bwd_kernelI6__halffLi1ELb0E",
    "fused_norm_fwd_wide_bf16": "fused_norm_fwd_wide_kernelI13__nv_bfloat16S1_E",
    "fused_norm_bwd_wide_bf16": "fused_norm_bwd_wide_kernelI13__nv_bfloat16S1_E",
    "fused_norm_colsum": "fused_norm_colsum_kernel",
}

# the training path's config: the JAX package's GPT-2 125M bench config
# (_bench_impl.py:1017-1036 _gpt2_model / _gpt2_config(8))
TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 8,
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.01}},
    "bf16": {"enabled": True},
    "zero_optimization": {"stage": 0},
    "steps_per_print": 1000000,
    "mesh": {"data": -1},
}

failures = []
T0 = time.perf_counter()


def emit(obj):
    """Print one JSON line; a phase's line also gets ``t_s``, the script's
    seconds so far (where the run's time goes)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        failures.append(what)
        emit({"check_failed": what})


def cuda_ms(fn, iters=20, replays=5):
    """Mean device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph, the graph replayed between CUDA events, so the time is the
    device's and not the host's launch rate. Inputs stay warm in L2, as the
    model's q/k/v are when the projection has just written them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graphs asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def rotation_sets(input_bytes):
    """How many distinct input sets ``rotating_ms`` needs so that one pass
    over them reads more than twice the L2."""
    return 2 * L2_BYTES // input_bytes + 1


def rotating_ms(fn, sets, min_calls=20):
    """``cuda_ms`` of ``fn(*inputs)`` with the input sets taken in turn, each
    call's result kept until its set comes round again: one pass reads more
    than twice the L2 (``rotation_sets``), so a memory-bound kernel reads its
    inputs from device memory, and no output is written over memory another
    call wrote while it may still sit in L2."""
    state = {"i": 0, "keep": [None] * len(sets)}

    def step():
        i = state["i"] % len(sets)
        state["i"] += 1
        state["keep"][i] = fn(*sets[i])

    return cuda_ms(step, iters=len(sets) * -(-min_calls // len(sets)))


def reference_partial_rows(N, cap=256):
    """Rows of the partials that the TPU backward writes at its default
    ``block_rows`` of 256: one per row block of its tiling, the largest
    multiple-of-8 divisor of N up to ``cap``, or N itself when there is none."""
    block = max((br for br in range(8, min(cap, N) + 1, 8) if N % br == 0), default=N)
    return N // block


def norm_bytes(N, D, dtype, wdtype, has_bias, partial_rows):
    """The bytes K7 and K8 must move on (N, D), each once. K7 reads x, scale
    (and bias) and writes out, mu and rstd; K8 reads x, do, scale, mu and
    rstd and writes dx and (partial_rows, D) f32 partials of dscale and
    dbias. The partials are counted at the function's own row blocks
    (``reference_partial_rows``), not at the port's block count, so that the
    count does not grow with a choice of the kernel."""
    isz, wsz = torch.finfo(dtype).bits // 8, torch.finfo(wdtype).bits // 8
    rows = 2 * N * 4
    return (2 * N * D * isz + D * wsz * (2 if has_bias else 1) + rows,
            3 * N * D * isz + D * wsz + rows + 2 * partial_rows * D * 4)


def norm_bounds(N, D, dtype, wdtype, has_bias, partial_rows):
    """K7 and K8 on (N, D): (bound ms, bound_by) each, from ``norm_bytes``
    and the FLOPs (8 per element for K7, 16 for K8) at the f32 CUDA-core
    peak."""
    k7, k8 = norm_bytes(N, D, dtype, wdtype, has_bias, partial_rows)
    return (bound(8.0 * N * D, k7, torch.float32), bound(16.0 * N * D, k8, torch.float32))


def sass_counts(lib_path, tags, ops=("HGMMA", "HMMA", "FFMA")):
    """Instructions of each kind in the SASS of the kernel whose mangled name
    contains each tag (cuobjdump -sass of the built library, from the toolkit
    that holds nvcc)."""
    from deepspeed_tpu_torch.ops import op_builder

    tool = os.path.join(os.path.dirname(op_builder.nvcc_path()), "cuobjdump")
    check(os.path.exists(tool), f"no cuobjdump beside nvcc ({tool}): SASS not read")
    if not os.path.exists(tool):
        return {tag: "cuobjdump not found" for tag in tags}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300).stdout
    out, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            current = next((t for t in tags if t in name), None)
            if current is not None:
                out[current] = {op: 0 for op in ops}
        elif current is not None:
            words = line.replace(";", " ").split()
            for op in ops:
                out[current][op] += sum(1 for w in words if w == op or w.startswith(op + "."))
    return {tag: out.get(tag, "kernel not found") for tag in tags}


def ptxas_summary(output, tag):
    """ptxas's stack/spill and register lines for the kernel instantiation
    whose mangled name contains ``tag`` (empty when the library was not
    built in this run)."""
    lines = output.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and tag in line:
            return [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3]]
    return []


def attention_pairs(Sq, Sk, causal, window, layout=None, block=None):
    """(query, key) pairs the masks let through: the work this input needs.
    For one head; with a block-sparse ``layout`` (H, Sq/b, Sk/b) and its
    tile ``block``, summed over the layout's heads: a live tile below the
    diagonal (or any live tile when not causal) holds b * b pairs, a live
    diagonal tile b (b + 1) / 2 when causal, a tile above it none."""
    if layout is not None:
        live = torch.tensor(layout) > 0
        qi = torch.arange(live.shape[1])[:, None]
        ki = torch.arange(live.shape[2])[None, :]
        if not causal:
            return int(live.sum()) * block * block
        below, diag = (live & (ki < qi)).sum(), (live & (ki == qi)).sum()
        return int(below) * block * block + int(diag) * block * (block + 1) // 2
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= qp - kp < window
    return int(ok.sum())


def bound(flops, nbytes, dtype):
    """(least ms on the card, what bounds it) for this work."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def flash_bound(B, S, H, Hkv, hd, causal, window, dtype):
    """K1: 4 hd FLOPs per pair over q, k, v, o (and the f32 lse)."""
    itemsize = torch.finfo(dtype).bits // 8
    flops = 4.0 * B * H * hd * attention_pairs(S, S, causal, window)
    nbytes = (2 * B * H * S + 2 * B * Hkv * S) * hd * itemsize + 4 * B * H * S
    return bound(flops, nbytes, dtype)


def flash_bwd_bounds(B, S, H, Hkv, hd, causal, window, dtype):
    """K2: 6 hd FLOPs per pair over q, do, dq, k, v, lse, delta; K3: 8 hd
    over q, do, k, v, dk, dv, lse, delta (each read or written once)."""
    itemsize = torch.finfo(dtype).bits // 8
    pairs = attention_pairs(S, S, causal, window)
    q_bytes, kv_bytes, row_bytes = B * H * S * hd * itemsize, B * Hkv * S * hd * itemsize, 8 * B * H * S
    k2 = bound(6.0 * hd * pairs * B * H, 3 * q_bytes + 2 * kv_bytes + row_bytes, dtype)
    k3 = bound(8.0 * hd * pairs * B * H, 2 * q_bytes + 4 * kv_bytes + row_bytes, dtype)
    return k2, k3


def sparse_bounds(B, S, H, hd, pairs, dtype):
    """K4, K5, K6 on ``pairs`` (summed over heads, per batch row): 4, 6 and
    8 hd FLOPs per pair; K4 over q, k, v, o and lse, K5 over q, k, v, do,
    dq, lse and delta, K6 over q, k, v, do, dk, dv, lse and delta (each read
    or written once). Each (bound ms, bound_by, the same work's ms at the
    f32 CUDA-core peak)."""
    itemsize = torch.finfo(dtype).bits // 8
    t, row = B * S * H * hd * itemsize, 4 * B * H * S
    out = []
    for per_pair, nbytes in ((4, 4 * t + row), (6, 5 * t + 2 * row), (8, 6 * t + 2 * row)):
        flops = float(per_pair) * hd * pairs * B
        out.append((*bound(flops, nbytes, dtype), flops / PEAK_FLOPS[torch.float32] * 1e3))
    return out


def exact_sparse_bwd(bs, q, k, v, o, lse, do, layout, b, causal, sm_scale):
    """The plain block-sparse backward in float64 on the same inputs (o and
    lse as given): the exact gradients that the kernels' and the plain
    version's roundings are counted against."""
    mask = bs._mask(layout, b, q.shape[1], k.shape[1], causal, q.device)[None]
    qd, kd, vd, dod = (t.double() for t in (q, k, v, do))
    p = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * sm_scale
    p = torch.exp(p - lse.double()).masked_fill(~mask, 0.0)
    delta = (dod * o.double()).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dod, vd) - delta) * sm_scale
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kd), torch.einsum("bhqk,bqhd->bkhd", ds, qd),
            torch.einsum("bhqk,bqhd->bkhd", p, dod))


def rounded_off(got, exact):
    """Elements of ``got`` (16-bit) other than ``exact`` rounded to nearest,
    in all and in the top binade (|exact| within a factor 2 of its largest
    power of two), where one such element misses BS_REL_TOL."""
    off = got != exact.to(got.dtype)
    top = exact.abs() >= 2.0 ** math.floor(math.log2(exact.abs().max().item()))
    return {"all": int(off.sum()), "top_binade": int((off & top).sum()),
            "top_binade_elements": int(top.sum())}


def fwd_in_ascending_order(bs, q, k, v, layout, b, causal, sm_scale):
    """K4 (``_cuda_fwd``) with its blocks launched in ascending (head, tile)
    order in place of the lists' row_order (longest list first), by handing
    it lists whose row_order is 0, 1, 2, ...; the FMA kernel reads no order,
    so there the two launches are the same."""
    tile, lists = bs._lists_on(layout, b, causal, q.device)
    ascending = dict(lists, row_order=torch.arange(lists["row_order"].numel(), dtype=torch.int32,
                                                   device=q.device))
    lists_on = bs._lists_on
    bs._lists_on = lambda *args: (tile, ascending)
    try:
        return bs._cuda_fwd(q, k, v, layout, b, causal, sm_scale)
    finally:
        bs._lists_on = lists_on


def events_ms(fn, iters=3):
    """Mean time of one eager call of ``fn`` between CUDA events, after one
    warm-up call: for the plain versions, whose large kernels outweigh
    their launches (and whose mask upload a CUDA graph cannot capture)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn, sets):
    """Device milliseconds of one call of ``fn``: the profiler's kernel time
    over one pass of ``fn(*inputs)`` through the input sets, after a warm-up
    call, over the number of sets."""
    from torch.profiler import ProfilerActivity, profile

    fn(*sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for inputs in sets:
            fn(*inputs)
        torch.cuda.synchronize()
    return sum(t for _, t, _ in device_kernels(prof)) * 1e3 / len(sets)


def host_us(fn, calls=2000):
    """Host microseconds one call of ``fn`` takes to issue its work: a loop
    of calls between host clocks, the device left to drain after it (its
    kernels are shorter than the host's issue, so the queue never fills)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s / calls * 1e6


def plain_chain_norm(x, scale, bias, eps, rms):
    """The model's norm as an f32 chain of PyTorch ops, as the reference's
    plain-jnp ``_norm`` spells it out and as the port's ``_norm`` ran before
    it went through the fused-norm op: a yardstick of host cost only."""
    x32 = x.float()
    if rms:
        x32 = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    else:
        var, mu = torch.var_mean(x32, dim=-1, keepdim=True, unbiased=False)
        x32 = (x32 - mu) * torch.rsqrt(var + eps)
    out = x32 * scale
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def build_all(libs):
    """nvcc for every kernel source at once, one thread each; a failed build
    raises."""
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs))


def named_leaves(tree, prefix=""):
    """(dotted name, tensor) of a param tree, in the engine's leaf order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def wqkv_grad_blocks(engine, cfg):
    """The f32 gradient accumulators of every layer's wqkv, split into its q,
    k and v row blocks (read after backward, before step)."""
    acc = {id(p): g for p, g in zip(engine._param_leaves, engine.grad_acc)}
    rows = [cfg.num_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim,
            cfg.kv_heads * cfg.head_dim]
    return [acc[id(ly["attn"]["wqkv"])].split(rows, dim=0) for ly in engine.params["layers"]]


KERNEL_CATEGORIES = (  # first match wins, on the kernel's name
    ("flash (K1-K3)", ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")),
    ("block-sparse (K4-K6)", ("block_sparse_fwd_kernel", "block_sparse_bwd_dq_kernel",
                              "block_sparse_bwd_dkv_kernel")),
    ("fused norm (K7-K8)", ("fused_norm_",)),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("reduction", ("reduce_kernel", "softmax", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def by_category(kernels):
    """Device seconds and launches per kernel category."""
    out = {}
    for name, t, n in kernels:
        cat = next((c for c, tags in KERNEL_CATEGORIES if any(x in name for x in tags)), "other")
        s, c = out.get(cat, (0.0, 0))
        out[cat] = (s + t, c + n)
    return {c: {"device_s": s, "launches": n} for c, (s, n) in out.items()}


def device_kernels(prof):
    """(name, device seconds, launches) of every kernel (and copy or set)
    that ran on the card in a profile, from the profiler's raw events:
    ``key_averages()`` gives the same sums but took ~6 s to build for a
    profiled serving replay's ~39,000 launches on the H100 machine's host,
    against 0.46 s here."""
    from torch.autograd import DeviceType

    agg = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation() \
                and e.duration_ns() > 0:
            t, n = agg.get(e.name(), (0, 0))
            agg[e.name()] = (t + e.duration_ns(), n + 1)
    return [(name, t / 1e9, n) for name, (t, n) in agg.items()]


def generate_wall(eng, toks, n_new, **kwargs):
    """Wall seconds and this thread's CPU seconds of one greedy ``generate``
    of toks + n_new tokens."""
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), time.thread_time()
    eng.generate(toks, max_new_tokens=n_new, **kwargs)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, time.thread_time() - c0


def serve_breakdown(eng, toks, gen, card, request, short=8, long=40, reps=7):
    """The ``breakdown`` line: the decode step of ``generate`` at toks' shape
    as the median wall of ``reps`` calls of ``long`` new tokens less the
    median of ``reps`` of ``short``, over the steps between (the prefill and
    each call's set-up cancel), each pair's own step beside it; the device's
    kernel time and launches a step from one profiled call of each length,
    and the share of the step the device sits idle; the same step in the
    issuing thread's CPU time (below the wall step when the host's other
    work takes the thread's core) and the host's load; the prefill; and the
    host's cost of one of the step's norms against the f32 chain it
    replaced."""
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.models import transformer as tf

    cfg = eng.cfg
    generate_wall(eng, toks, short)  # warm-up at both cache lengths
    generate_wall(eng, toks, long)
    load = os.getloadavg()
    walls, cpus = {short: [], long: []}, {short: [], long: []}
    for _ in range(reps):  # interleaved, so a slow stretch of the host hits both
        for n in (short, long):
            wall, cpu = generate_wall(eng, toks, n)
            walls[n].append(wall)
            cpus[n].append(cpu)

    def per_step(t):
        return ((statistics.median(t[long]) - statistics.median(t[short]))
                / (long - short) * 1e3,
                [(tl - ts) / (long - short) * 1e3 for ts, tl in zip(t[short], t[long])])

    step_ms, pairs_ms = per_step(walls)
    cpu_step_ms, cpu_pairs_ms = per_step(cpus)
    profiled = {}
    for n in (short, long):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.generate(toks, max_new_tokens=n)
            torch.cuda.synchronize()
        profiled[n] = device_kernels(prof)
    device_s = {n: sum(t for _, t, _ in k) for n, k in profiled.items()}
    launches = {n: sum(c for _, _, c in k) for n, k in profiled.items()}
    measured = bool(profiled[short] and profiled[long])
    device_step_ms = (device_s[long] - device_s[short]) / (long - short) * 1e3
    with torch.inference_mode():
        cache = tf.init_cache(cfg, toks.shape[0], cfg.max_seq_len, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tf.forward_with_cache(eng.params, cfg, toks, cache, 0, last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    # the host's cost of one of a decode step's 49 norms: the model's routed
    # norm against the f32 chain it replaced, at the decode step's 8 rows
    ln1 = eng.params["layers"][0]["ln1"]
    x_dec = torch.randn(toks.shape[0], 1, cfg.hidden_size, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
    with torch.inference_mode():
        norm_host = {
            "routed_norm": host_us(lambda: tf._norm(x_dec, ln1["scale"], ln1.get("bias"), cfg)),
            "plain_chain": host_us(lambda: plain_chain_norm(x_dec, ln1["scale"], ln1.get("bias"),
                                                            cfg.norm_eps, False))}
    kernels = profiled[long]
    emit({"phase": "breakdown", "request": request, "prompt": list(toks.shape),
          "new_tokens": [short, long], "reps": reps,
          "generate_s": {str(n): w for n, w in walls.items()},
          "decode_step_ms": step_ms,
          "decode_step_ms_per_pair": pairs_ms,
          "decode_step_thread_cpu_ms": cpu_step_ms,
          "decode_step_thread_cpu_ms_per_pair": cpu_pairs_ms,
          "host_load_avg_1_5_15_min": load, "host_cpus": os.cpu_count(),
          "device_ms_per_step": device_step_ms if measured else "not measured",
          "device_idle_share_per_step": 1 - device_step_ms / step_ms if measured
          else "not measured",
          "launches_per_step": (launches[long] - launches[short]) / (long - short),
          "device_kernel_s": {str(n): device_s[n] for n in profiled} if measured
          else "not measured",
          "k1_device_s": sum(t for k, t, _ in kernels if "flash_fwd_kernel" in k),
          "k7_device_s": sum(t for k, t, _ in kernels if "fused_norm_" in k),
          "prefill_s": prefill_s, "norm_host_us_per_call": norm_host,
          "norm_rows": x_dec.shape[0],
          "top_kernels": [{"name": k[:90], "s": t}
                          for k, t, _ in sorted(kernels, key=lambda x: -x[1])[:8]],
          "card": card})


def k7_k8_phase(gen, card):
    """K7 and K8 against their plain versions on the same inputs at the
    fused-norm shapes of the models the repo supports, timed over rotating
    inputs (one pass reads more than twice the L2), beside the plain
    versions and F.layer_norm / F.rms_norm: the ``k7_k8`` lines."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import fused_norm as fnorm

    norm_shapes = {  # (rows, D, kind, x dtype, scale/bias dtype)
        "a_ln_8192x768_bf16": (8192, 768, "ln", torch.bfloat16, torch.bfloat16),
        "b_ln_1024x1024_bf16": (1024, 1024, "ln", torch.bfloat16, torch.bfloat16),
        "c_rms_4096x4096_bf16": (4096, 4096, "rms", torch.bfloat16, torch.bfloat16),
        "d_ln_2048x1600_f32": (2048, 1600, "ln", torch.float32, torch.float32),
        "e_ln_nobias_77x100_f16_f32_scale": (77, 100, "ln_nobias", torch.float16,
                                             torch.float32),
        # train_llama's rows: B2 x S4096 of llama2-7b's RMSNorm
        "f_rms_8192x4096_bf16": (8192, 4096, "rms", torch.bfloat16, torch.bfloat16),
    }
    k78 = {}
    for name, (N, D, kind, dtype, wdtype) in norm_shapes.items():
        rms = kind == "rms"
        n_sets = rotation_sets(N * D * torch.finfo(dtype).bits // 8)
        xs, dos = (torch.randn(n_sets, N, D, generator=gen, device="cuda", dtype=dtype)
                   for _ in range(2))
        scale = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(wdtype)
        bias = (0.1 * torch.randn(D, generator=gen, device="cuda")).to(wdtype)
        bias = bias if kind == "ln" else None
        _, mus, rstds = fnorm._reference_fwd(xs.reshape(-1, D), scale, bias, 1e-5, rms)
        sets = [(xs[i], dos[i], mus[i * N:(i + 1) * N], rstds[i * N:(i + 1) * N])
                for i in range(n_sets)]
        x, do, mu, rstd = sets[0]
        variant = fnorm.kernel_variant(D, dtype, x, do)
        check(all(fnorm.kernel_variant(D, dtype, xi, doi) == variant for xi, doi, _, _ in sets),
              f"K7/K8 {name}: the rotated inputs run different variants")
        out, kmu, krstd = fnorm._cuda_fwd(x, scale, bias, 1e-5, rms)
        dx, dscale, dbias = fnorm._cuda_bwd(x, scale, mu, rstd, do, rms)
        again = (fnorm._cuda_fwd(x, scale, bias, 1e-5, rms)
                 + fnorm._cuda_bwd(x, scale, mu, rstd, do, rms))
        same_bits = all(torch.equal(a, b) for a, b in
                        zip((out, kmu, krstd, dx, dscale, dbias), again))
        check(same_bits, f"K7/K8 {name}: two calls gave different bits")
        del again
        torch.cuda.synchronize()
        ro, rmu, rrstd = fnorm._reference_fwd(x, scale, bias, 1e-5, rms)
        rdx, rdscale, rdbias = fnorm._reference_bwd(x, scale, mu, rstd, do, rms)
        bf = torch.bfloat16
        errs = {}
        for gname, got, ref, tol in (
                ("out", out, ro, NORM_TOL[dtype]), ("mu", kmu, rmu, NORM_STAT_TOL),
                ("rstd", krstd, rrstd, NORM_STAT_TOL), ("dx", dx, rdx, NORM_TOL[dtype]),
                ("dscale", dscale, rdscale, NORM_SUM_TOL), ("dbias", dbias, rdbias, NORM_SUM_TOL),
                ("dscale_bf16", dscale.to(bf), rdscale.to(bf), NORM_SUM_BF16_TOL),
                ("dbias_bf16", dbias.to(bf), rdbias.to(bf), NORM_SUM_BF16_TOL)):
            d = (got.float() - ref.float()).abs().max().item()
            m = ref.float().abs().max().item()
            rel = d / m if m > 0 else d  # RMSNorm's mu is 0 on both sides
            errs[gname] = (d, rel, tol)
            check(rel <= tol and bool(torch.isfinite(got).all()),
                  f"K7/K8 {name}: max |{gname} - plain| {d} ({rel} of max |{gname}|, tol {tol})")
        partial_rows = reference_partial_rows(N)
        (k7b, k7by), (k8b, k8by) = norm_bounds(N, D, dtype, wdtype, bias is not None,
                                               partial_rows)
        k7_bytes, k8_bytes = norm_bytes(N, D, dtype, wdtype, bias is not None, partial_rows)
        (lib_k7b, _), (lib_k8b, _) = norm_bounds(N, D, dtype, dtype, bias is not None, 0)
        k7_ms = rotating_ms(lambda x, do, mu, rstd: fnorm._cuda_fwd(x, scale, bias, 1e-5, rms),
                            sets)
        k8_ms = rotating_ms(lambda x, do, mu, rstd: fnorm._cuda_bwd(x, scale, mu, rstd, do, rms),
                            sets)
        plain_fwd_ms = rotating_ms(
            lambda x, do, mu, rstd: fnorm._reference_fwd(x, scale, bias, 1e-5, rms), sets)
        plain_bwd_ms = rotating_ms(
            lambda x, do, mu, rstd: fnorm._reference_bwd(x, scale, mu, rstd, do, rms), sets)
        # warm L2, for comparison only: the same kernels over one input
        k7_warm_ms = cuda_ms(lambda: fnorm._cuda_fwd(x, scale, bias, 1e-5, rms))
        k8_warm_ms = cuda_ms(lambda: fnorm._cuda_bwd(x, scale, mu, rstd, do, rms))

        # the library yardstick, timed only, with scale and bias in x's dtype
        # (F.layer_norm does not take every mix of dtypes on every build):
        # forward, and forward + backward - forward for the backward
        def library(xl, w, b):
            if rms:
                return F.rms_norm(xl, (D,), w, 1e-5)
            return F.layer_norm(xl, (D,), w, b, 1e-5)

        lw = scale.to(dtype).requires_grad_(True)
        lb = bias.to(dtype).requires_grad_(True) if bias is not None else None
        lparams = [lw] + ([lb] if lb is not None else [])
        leaf_sets = [(xi.detach().requires_grad_(True), doi) for xi, doi, _, _ in sets]
        lib_fwd_ms = rotating_ms(lambda xl, dol: library(xl.detach(), lw.detach(),
                                                         None if lb is None else lb.detach()),
                                 leaf_sets)
        lib_fwd_bwd_ms = rotating_ms(
            lambda xl, dol: torch.autograd.grad(library(xl, lw, lb), [xl] + lparams, dol),
            leaf_sets)
        # what the model's norm cost before it went through K7/K8: the f32 chain
        # under autograd, forward and forward + backward, the weights as leaves
        cw = scale.clone().requires_grad_(True)
        cb = bias.clone().requires_grad_(True) if bias is not None else None
        cparams = [cw] + ([cb] if cb is not None else [])
        # (device time from the profiler: a CUDA graph does not capture its
        # backward, and an eager loop of its small kernels waits on the host)
        chain_fwd_ms = profiled_ms(lambda xl, dol: plain_chain_norm(
            xl.detach(), scale, bias, 1e-5, rms), leaf_sets)
        chain_fwd_bwd_ms = profiled_ms(
            lambda xl, dol: torch.autograd.grad(plain_chain_norm(xl, cw, cb, 1e-5, rms),
                                                [xl] + cparams, dol), leaf_sets)
        for what, ms, least in (("K7", k7_ms, k7b), ("K8", k8_ms, k8b),
                                ("library forward", lib_fwd_ms, lib_k7b),
                                ("library forward + backward", lib_fwd_bwd_ms,
                                 lib_k7b + lib_k8b)):
            check(ms >= least, f"K7/K8 {name}: {what} timed {ms} ms, under its bound {least} ms:"
                               f" a timing fault")
        row = {
            "phase": "k7_k8", "shape": name, "rows": N, "D": D, "kind": kind,
            "dtype": str(dtype).split(".")[-1], "param_dtype": str(wdtype).split(".")[-1],
            "max_abs_err": {g: e[0] for g, e in errs.items()},
            "max_err_over_max_ref": {g: e[1] for g, e in errs.items()},
            "tol": {g: e[2] for g, e in errs.items()},
            "rotation_sets": n_sets,
            "rotation_bytes_per_pass": {"x": n_sets * N * D * torch.finfo(dtype).bits // 8,
                                        "x_and_do": 2 * n_sets * N * D * torch.finfo(dtype).bits
                                        // 8},
            "k8_bound_partial_rows": partial_rows, "variant": variant,
            "same_bits_twice": same_bits,
            "k7_ms": k7_ms, "k8_ms": k8_ms, "k7_warm_l2_ms": k7_warm_ms,
            "k7_gb_per_s": k7_bytes / k7_ms * 1e-6, "k8_gb_per_s": k8_bytes / k8_ms * 1e-6,
            "k7_bound_share": k7b / k7_ms, "k8_bound_share": k8b / k8_ms,
            "k8_warm_l2_ms": k8_warm_ms, "plain_fwd_ms": plain_fwd_ms,
            "plain_bwd_ms": plain_bwd_ms, "k7_bound_ms": k7b, "k7_bound_by": k7by,
            "k8_bound_ms": k8b, "k8_bound_by": k8by,
            "library": "F.rms_norm" if rms else "F.layer_norm",
            "library_param_dtype": str(dtype).split(".")[-1],
            "library_fwd_ms": lib_fwd_ms, "library_fwd_bwd_ms": lib_fwd_bwd_ms,
            "library_bwd_ms": lib_fwd_bwd_ms - lib_fwd_ms,
            "plain_chain_fwd_ms": chain_fwd_ms, "plain_chain_fwd_bwd_ms": chain_fwd_bwd_ms,
            "card": card,
        }
        k78[name] = row
        emit(row)
        del xs, dos, mus, rstds, sets, leaf_sets, x, do, mu, rstd, out, kmu, krstd, dx, dscale
        del dbias, ro, rmu, rrstd, rdx, rdscale, rdbias, cw, cb, cparams
        torch.cuda.empty_cache()
    return k78


def fused_ops_phase(gen, card):
    """The fused-op surface's path, driven with the launch counts set to 0
    just before it and read just after (returned): the ``fused_ops`` line."""
    from deepspeed_tpu_torch.ops import fused_norm as fnorm
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.transformer import fused_ops as fo

    # GPT-2 125M's training width, B8 S1024, bf16 parameters as the engine
    # keeps them: fused_layernorm -> @ W1 -> fused_bias_gelu -> @ W2 ->
    # fused_bias_dropout_residual(..., x, ratio, gen) -> a scalar loss ->
    # backward, against the same chain with the plain LayerNorm under
    # autograd (the other ops are plain PyTorch in both)
    B_F, S_F, D_F, H_F = 8, 1024, 768, 3072
    bf16 = torch.bfloat16

    def rand_bf16(*shape, std=1.0, loc=0.0):
        return (loc + std * torch.randn(*shape, generator=gen, device="cuda")).to(bf16)

    x_f = rand_bf16(B_F, S_F, D_F)
    leaves_f = {"ln_scale": rand_bf16(D_F, std=0.1, loc=1.0), "ln_bias": rand_bf16(D_F, std=0.1),
                "w1": rand_bf16(D_F, H_F, std=0.02), "b1": rand_bf16(H_F, std=0.02),
                "w2": rand_bf16(H_F, D_F, std=0.02), "b2": rand_bf16(D_F, std=0.02)}

    def plain_layernorm(xp, sp, bp):
        return fnorm._reference_fwd(xp.reshape(-1, D_F), sp, bp, 1e-5, False)[0].reshape(xp.shape)

    def fused_chain(layernorm, ratio, rng):
        """(loss, {leaf: gradient}) of one forward and backward of the chain."""
        xl = x_f.clone().requires_grad_(True)
        p = {key: v.clone().requires_grad_(True) for key, v in leaves_f.items()}
        h = layernorm(xl, p["ln_scale"], p["ln_bias"])
        h = fo.fused_bias_gelu(h @ p["w1"], p["b1"])
        y = fo.fused_bias_dropout_residual(h @ p["w2"], p["b2"], xl, ratio, rng)
        loss = y.float().square().mean()
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {"x": xl.grad, **{key: v.grad for key, v in p.items()}}

    op_builder.reset_launch_counts()
    loss_k, grads_k = fused_chain(fo.fused_layernorm, 0.0,
                                  torch.Generator(device="cuda").manual_seed(3))
    fused_counts = op_builder.launch_counts()
    for kname in NORM_KERNELS:
        check(fused_counts.get(kname, 0) == 1,
              f"fused_ops: {kname} launched {fused_counts.get(kname, 0)} times, expected 1")
    for kname in KERNELS + SPARSE_KERNELS:
        check(fused_counts.get(kname, 0) == 0,
              f"fused_ops: {kname} launched {fused_counts.get(kname, 0)} times, expected none")
    loss_p, grads_p = fused_chain(plain_layernorm, 0.0, None)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = {key: float((grads_k[key].float() - g.float()).abs().max() / g.float().abs().max())
                for key, g in grads_p.items()}
    worst_leaf = max(grad_rel, key=grad_rel.get)
    check(math.isfinite(loss_k) and loss_rel <= FUSED_LOSS_REL_TOL
          and grad_rel[worst_leaf] <= FUSED_GRAD_REL_TOL
          and all(bool(torch.isfinite(g).all()) and g.dtype == bf16 for g in grads_k.values()),
          f"fused_ops ratio 0: loss {loss_k} vs plain {loss_p}, worst gradient {worst_leaf} at "
          f"{grad_rel[worst_leaf]} of its max")
    # the dropout at ratio 0.1 on the chain's own activations: the keep rate,
    # kept elements h / (1 - ratio) in bf16 exactly, with (1 - ratio) in bf16
    # first as the reference's weakly typed scalar is (the CPU tests hold this
    # against JAX bit for bit), dropped elements the residual exactly, the
    # same mask for the same seed; then one forward and backward at 0.1
    ratio = 0.1
    with torch.no_grad():
        h2 = fo.fused_bias_gelu(fo.fused_layernorm(x_f, leaves_f["ln_scale"], leaves_f["ln_bias"])
                                @ leaves_f["w1"], leaves_f["b1"]) @ leaves_f["w2"]
        hb = h2 + leaves_f["b2"]

        def dropout(residual, seed):
            return fo.fused_bias_dropout_residual(h2, leaves_f["b2"], residual, ratio,
                                                  torch.Generator(device="cuda").manual_seed(seed))

        dropped_only = dropout(torch.zeros_like(x_f), 7)
        y1, y2, y3 = dropout(x_f, 7), dropout(x_f, 7), dropout(x_f, 8)
        want = (hb.float() / torch.tensor(1.0 - ratio, dtype=bf16).item()).to(bf16)
        decided = hb != 0  # where h is 0 a kept and a dropped element look alike
        kept = dropped_only != 0
        keep_rate = kept[decided].float().mean().item()
        sigma = math.sqrt(ratio * (1 - ratio) / int(decided.sum()))
        scaled_exact = bool(torch.equal(dropped_only[kept], want[kept]))
        residual_exact = bool(torch.equal(y1[~kept], x_f[~kept])
                              and torch.equal(y1[kept], (x_f + want)[kept]))
        same_seed = bool(torch.equal(y1, y2))
        other_seed_differs = not torch.equal(y1, y3)
    check(abs(keep_rate - (1 - ratio)) <= 4 * sigma,
          f"fused_ops ratio 0.1: keep rate {keep_rate}, not within 4 sigma ({4 * sigma}) of 0.9")
    check(scaled_exact and residual_exact and same_seed and other_seed_differs,
          f"fused_ops ratio 0.1: kept = h/(1-ratio) {scaled_exact}, dropped = residual "
          f"{residual_exact}, same seed same mask {same_seed}, other seed differs "
          f"{other_seed_differs}")
    loss_d, grads_d = fused_chain(fo.fused_layernorm, ratio,
                                  torch.Generator(device="cuda").manual_seed(9))
    check(math.isfinite(loss_d) and all(bool(torch.isfinite(g).all()) for g in grads_d.values()),
          f"fused_ops ratio 0.1: loss {loss_d} or a gradient not finite")
    emit({"phase": "fused_ops", "x": [B_F, S_F, D_F], "ffn": H_F, "dtype": "bfloat16",
          "chain": "fused_layernorm -> @W1 -> fused_bias_gelu -> @W2 -> "
                   "fused_bias_dropout_residual(., x, ratio, gen) -> mean(y^2) -> backward",
          "launches": {k: fused_counts.get(k, 0) for k in NORM_KERNELS + KERNELS + SPARSE_KERNELS},
          "ratio_0": {"loss": loss_k, "plain_loss": loss_p, "loss_rel_diff": loss_rel,
                      "loss_rel_tol": FUSED_LOSS_REL_TOL, "grad_rel_diff": grad_rel,
                      "worst_leaf": worst_leaf, "grad_rel_tol": FUSED_GRAD_REL_TOL},
          "ratio_0_1": {"keep_rate": keep_rate, "sigma": sigma, "decided": int(decided.sum()),
                        "kept_equal_h_over_keep": scaled_exact,
                        "dropped_equal_residual": residual_exact,
                        "same_seed_same_mask": same_seed,
                        "other_seed_differs": other_seed_differs, "loss": loss_d},
          "card": card})
    return fused_counts


# the int8 path's plain-PyTorch steps, wrapped in profiler ranges while a
# profiled call runs (int8_spans), so that their device time a decode step
# can be read; "aten::_int_mm" is the int8 product alone
INT8_SPANS = ("int8_linear", "quantize_kv", "dequantize_kv")
# decode_int8 and ragged_chunked run GPT-2 350M at full width and 12 of its 24
# layers, for the script's time limit (to make room for the serving mesh's phase)
DECODE_SHAPES_LAYERS = 12


@contextlib.contextmanager
def int8_spans():
    """Wrap ``int8_linear`` (as the model calls it) and the int8 cache's
    ``quantize_kv``/``dequantize_kv`` (as ``inference_ops`` calls them) in
    ``record_function`` ranges of their names, and restore them after."""
    from torch.profiler import record_function

    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops.transformer import inference_ops

    saved = [(tf, "int8_linear"), (inference_ops, "quantize_kv"),
             (inference_ops, "dequantize_kv")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]

    def wrap(name, fn):
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapped

    try:
        for mod, name, fn in saved:
            setattr(mod, name, wrap(name, fn))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def profiled_generate(eng, toks, n, **kwargs):
    """One ``generate`` of n new tokens under the profiler, with the int8
    ranges: (device kernel seconds, launches, kernel categories, device
    seconds of each range and of ``aten::_int_mm``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with int8_spans(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.generate(toks, max_new_tokens=n, **kwargs)
        torch.cuda.synchronize()
    kernels = [k for k in device_kernels(prof) if k[0] not in INT8_SPANS]
    spans = {name: 0.0 for name in INT8_SPANS + ("aten::_int_mm",)}
    for e in prof.key_averages():
        if e.key in spans and e.device_type == DeviceType.CPU:
            spans[e.key] += e.device_time_total / 1e6
    return (sum(t for _, t, _ in kernels), sum(c for _, _, c in kernels),
            by_category(kernels), spans)


def step_profile(eng, toks, short=4, long=12, **kwargs):
    """A decode step of ``generate`` at toks' shape: wall ms from one
    unprofiled call of each length, device ms and launches from one profiled
    call of each, as (long - short) / (long - short tokens); the idle share;
    the int8 ranges' and the GEMM kernels' device ms a step."""
    wall = {n: generate_wall(eng, toks, n, **kwargs)[0] for n in (short, long)}
    prof = {n: profiled_generate(eng, toks, n, **kwargs) for n in (short, long)}
    steps = long - short

    def per_step(a, b):
        return (b - a) / steps * 1e3

    wall_ms = per_step(wall[short], wall[long])
    measured = prof[short][0] > 0 and prof[long][0] > 0
    device_ms = per_step(prof[short][0], prof[long][0])
    gemm = {n: prof[n][2].get("gemm", {"device_s": 0.0})["device_s"] for n in (short, long)}
    row = {"wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms if measured else "not measured",
           "device_idle_share_per_step": 1 - device_ms / wall_ms if measured else "not measured",
           "launches_per_step": (prof[long][1] - prof[short][1]) / steps,
           "gemm_kernels_ms_per_step": per_step(gemm[short], gemm[long])}
    for name in INT8_SPANS + ("aten::_int_mm",):
        row[f"{name.replace('aten::', '')}_ms_per_step"] = per_step(prof[short][3][name],
                                                                   prof[long][3][name])
    return row


def leaf_bytes(tree):
    return sum(t.numel() * t.element_size() for _, t in named_leaves(tree))


def alloc_slack(tensors):
    """How far the caching allocator may round ``tensors`` up: each block to
    512 bytes, and a block over 1 MiB may keep the rest of its 2 MiB-rounded
    segment unsplit."""
    return sum(2 ** 21 if t.numel() * t.element_size() > 2 ** 20 else 512 for t in tensors)


def top1_check(lp, lx, what):
    """Max |lp - lx| within LOGITS_TOL, and top-1 equal wherever lx's top-2
    margin exceeds twice it (float32 logits of the same rows)."""
    d = (lp - lx).abs().max().item()
    top2 = lx.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * LOGITS_TOL
    agree = lp.argmax(-1) == lx.argmax(-1)
    check(bool(torch.isfinite(lp).all()) and d <= LOGITS_TOL,
          f"{what}: logits |card - cpu| {d} > {LOGITS_TOL}")
    check(bool(agree[decided].all()), f"{what}: top-1 disagrees on decided rows")
    return {"max_abs_diff": d, "top1_agree": int(agree[decided].sum()),
            "decided": int(decided.sum()), "rows": int(decided.numel())}


def decode_int8_phase(gen, card):
    """The decode slice's int8 request shapes on GPT-2 350M at full width and
    12 of its 24 layers (``DECODE_SHAPES_LAYERS``), in ``bench_decode``'s
    geometry (B 8 x prompt 128 + 128 new, greedy, ``max_out_tokens`` 256,
    tight reads): four engines on the same weights, {bf16, int8} weights x
    {model, int8} KV, one at a time. Each
    ``decode_int8`` line: the request's wall time and tokens/s with K1/K7/K8
    launches (counted from 0 over the four requests, returned), the decode
    step's wall and device ms, launches, idle share and the int8 steps'
    device ms (``step_profile``), KV bytes a token (``decode_kv_bytes``),
    the cache's and the weights' allocated bytes against their leaves, and
    for each engine with an int8 part its logits against the same engine on
    the CPU (the same port code, ``device="cpu"``): the whole prefill of two
    rows and one decode step that reads the cache back."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.decoding import decode_kv_bytes
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import op_builder

    B, P, NEW, CACHE, CPU_ROWS = 8, 128, 128, 256, 2
    model = tf.TransformerModel.from_preset("gpt2-350m", dtype="bfloat16",
                                            num_layers=DECODE_SHAPES_LAYERS)
    cfg0 = model.cfg
    L, V, hd = cfg0.num_layers, cfg0.vocab_size, cfg0.head_dim
    base = tf.map_params(lambda p: p.to("cpu", torch.bfloat16), model.init(gen))
    torch.cuda.empty_cache()
    toks = torch.randint(0, V, (B, P), generator=gen, device="cuda")
    counts, cache_bytes, cache_alloc = {}, {}, {}
    for wdt, kv in (("bf16", "model"), ("bf16", "int8"), ("int8", "model"), ("int8", "int8")):
        name = f"w_{wdt}_kv_{kv}"
        config = {"dtype": "bfloat16" if wdt == "bf16" else "int8", "kv_cache_dtype": kv,
                  "attn_impl": "pallas", "max_out_tokens": CACHE, "kv_tight_read": True}
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        eng = deepspeed_tpu_torch.init_inference(model, config=config, params=base)
        torch.cuda.synchronize()
        weights_alloc = torch.cuda.memory_allocated() - before
        leaves = named_leaves(eng.params)
        wbytes = leaf_bytes(eng.params)
        q8 = {n for n, t in leaves if t.dtype == torch.int8}
        check(all(t.is_cuda for _, t in leaves), f"{name}: a weight is off the card")
        # every leaf is allocated, and nothing else the size of a weight copy
        check(wbytes <= weights_alloc <= wbytes + alloc_slack([t for _, t in leaves]),
              f"{name}: {weights_alloc} bytes allocated for {wbytes} bytes of weights")
        if wdt == "int8":
            want = {f"layers.{i}.{g}.q8" for i in range(L)
                    for g in ("attn.wqkv", "attn.wo", "mlp.wi", "mlp.wo")}
            check(q8 == want, f"{name}: int8 leaves {len(q8)}, expected {len(want)}")
            scales = [t for n, t in leaves if n.endswith(".s")]
            check(len(scales) == len(want) and all(t.dtype == torch.float32 and t.dim() == 1
                                                   for t in scales),
                  f"{name}: scales not f32 (out,)")
        else:
            check(not q8, f"{name}: int8 leaves in a bf16 engine")
        check(eng.cfg.kv_cache_dtype == kv and eng.cfg.dtype == "bfloat16",
              f"{name}: cfg {eng.cfg.dtype}/{eng.cfg.kv_cache_dtype}")
        before = torch.cuda.memory_allocated()
        cache = tf.init_cache(eng.cfg, B, CACHE, "cuda")
        cache_alloc[kv] = torch.cuda.memory_allocated() - before
        cache_leaves = [t for _, t in named_leaves(cache)]
        cache_bytes[kv] = leaf_bytes(cache)
        check(all(t.is_cuda for t in cache_leaves)
              and cache_bytes[kv] <= cache_alloc[kv]
              <= cache_bytes[kv] + alloc_slack(cache_leaves),
              f"{name}: cache {cache_alloc[kv]} bytes allocated for {cache_bytes[kv]}")
        del cache

        eng.generate(toks[:, :16], max_new_tokens=4)  # warm-up: cuBLAS, kernel load
        torch.cuda.synchronize()
        op_builder.reset_launch_counts()
        t0 = time.perf_counter()
        out = eng.generate(toks, max_new_tokens=NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = op_builder.launch_counts()
        for k, c in launched.items():
            counts[k] = counts.get(k, 0) + c
        check(tuple(out.shape) == (B, P + NEW) and bool(((out >= 0) & (out < V)).all()),
              f"{name}: output shape {tuple(out.shape)} / range")
        norms = (2 * L + 1) * NEW
        check(launched["flash_fwd"] == L and launched["fused_norm_fwd"] == norms
              and launched["fused_norm_bwd"] == 0,
              f"{name}: K1/K7/K8 launched {launched['flash_fwd']}/{launched['fused_norm_fwd']}/"
              f"{launched['fused_norm_bwd']} times, expected {L}/{norms}/0")
        row = {"phase": "decode_int8", "engine": name, "batch": B, "prompt": P,
               "new_tokens": NEW, "cache_len": CACHE, "generate_s": wall,
               "new_tokens_per_s": B * NEW / wall,
               "k1_launches": launched["flash_fwd"], "k7_launches": launched["fused_norm_fwd"],
               "k8_launches": launched["fused_norm_bwd"],
               "kv_bytes_per_token": decode_kv_bytes(eng.cfg, P, NEW, CACHE,
                                                     eng.config.kv_read_floor) / (NEW - 1),
               "cache_bytes": cache_bytes[kv], "cache_allocated_bytes": cache_alloc[kv],
               "weights_allocated_bytes": weights_alloc, "weights_leaf_bytes": wbytes,
               "int8_leaves": len(q8), **step_profile(eng, toks)}

        if wdt == "int8" or kv == "int8":
            cpu = deepspeed_tpu_torch.init_inference(model, config=config, params=base,
                                                     device="cpu")
            if wdt == "int8":
                same = all(torch.equal(a.cpu(), b) for (_, a), (_, b)
                           in zip(leaves, named_leaves(cpu.params)))
                check(same, f"{name}: the card's int8 weights differ from the CPU's")
                row["weights_equal_cpu"] = same
            rows = toks[:CPU_ROWS]
            with torch.inference_mode():
                res = {}
                for dev, e in (("cuda", eng), ("cpu", cpu)):
                    c = tf.init_cache(e.cfg, CPU_ROWS, CACHE, dev)
                    lg, c = tf.forward_with_cache(e.params, e.cfg, rows.to(dev), c, 0)
                    nxt = out[:CPU_ROWS, P:P + 1].to(dev)  # the card's first new token
                    st, _ = tf.forward_with_cache(e.params, e.cfg, nxt, c, P)
                    res[dev] = (lg.float().cpu(), st.float().cpu())
            row["cpu_prefill"] = top1_check(res["cuda"][0], res["cpu"][0],
                                            f"{name}: prefill logits, card vs CPU")
            row["cpu_decode_step"] = top1_check(res["cuda"][1], res["cpu"][1],
                                                f"{name}: decode-step logits, card vs CPU")
            row["logits_tol"] = LOGITS_TOL
            del cpu
        emit({**row, "card": card})
        del eng, out
        torch.cuda.empty_cache()
    want = (hd + 4) / (2 * hd)
    ratio = cache_bytes["int8"] / cache_bytes["model"]  # the tensors' bytes
    bytes_ratio = (tf.kv_read_bytes_per_row(dataclasses.replace(cfg0, kv_cache_dtype="int8"), 1)
                   / tf.kv_read_bytes_per_row(cfg0, 1))
    check(ratio == want == bytes_ratio,
          f"int8 cache takes {ratio} of the bf16 cache's bytes, expected {want}")
    emit({"phase": "decode_int8_cache", "int8_over_bf16_bytes": ratio,
          "expected": want, "kv_read_bytes_ratio": bytes_ratio, "bytes": cache_bytes,
          "allocated_bytes": cache_alloc,
          "int8_over_bf16_allocated": cache_alloc["int8"] / cache_alloc["model"], "card": card})
    return counts


def ragged_chunked_phase(gen, card):
    """Ragged prompts and chunked prefill on GPT-2 350M at full width and
    12 of its 24 layers (``DECODE_SHAPES_LAYERS``): B 4, real lengths 128/96/64/17 in a width of 128, left and right
    padded, prefilled whole (``attention_mask``) and in chunks of 64 and of
    48 (which does not divide the width), 32 greedy new tokens, with the
    model KV and the int8 KV. Each ``ragged_chunked`` line: the request's
    wall time and K1/K7/K8 launches (counted from 0 over these requests,
    returned: vector positions keep K1 off), and each row against the same
    engine's single-row unpadded ``generate`` of that row (its mask all
    ones, so that it takes the same path): equal tokens, or a first
    difference where the single-row path's own top-2 margin is under twice
    LOGITS_TOL (bf16 at another batch shape). One line a KV type adds the
    decode step's device ms (``step_profile``)."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import op_builder

    B, W, NEW, CACHE = 4, 128, 32, 256
    lens = (128, 96, 64, 17)
    model = tf.TransformerModel.from_preset("gpt2-350m", dtype="bfloat16",
                                            num_layers=DECODE_SHAPES_LAYERS)
    L, V = model.cfg.num_layers, model.cfg.vocab_size
    params = tf.map_params(lambda p: p.to(torch.bfloat16), model.init(gen))
    torch.cuda.empty_cache()
    rows = [torch.randint(0, V, (n,), generator=gen, device="cuda") for n in lens]
    batches = {}
    for side in ("left", "right"):
        toks = torch.zeros((B, W), dtype=torch.long, device="cuda")
        mask = np.zeros((B, W), np.int64)
        for b, r in enumerate(rows):
            sl = slice(W - len(r), W) if side == "left" else slice(0, len(r))
            toks[b, sl] = r
            mask[b, sl] = 1
        batches[side] = (toks, mask)

    def path_logits(eng, row, gen_toks):
        """The single-row path's own logits for each generated token:
        its prefill, then one segment a token (teacher-forced)."""
        prefill, segment = eng._ragged_fns_for(1, CACHE)
        c = tf.init_cache(eng.cfg, 1, CACHE, "cuda")
        S = row.numel()
        with torch.inference_mode():
            lg, c = prefill(eng.params, row[None], torch.arange(S, device="cuda")[None], c)
            out = [lg[0, -1]]
            for j in range(len(gen_toks) - 1):
                st, c = segment(eng.params, gen_toks[None, j:j + 1].long(), c,
                                torch.tensor([S + j], device="cuda"))
                out.append(st[0, -1])
        return torch.stack(out).float()

    counts = {}
    for kv in ("model", "int8"):
        for chunk in (None, 64, 48):
            config = {"dtype": "bfloat16", "attn_impl": "pallas", "kv_cache_dtype": kv,
                      "max_out_tokens": CACHE, "prefill_chunk_size": chunk}
            eng = deepspeed_tpu_torch.init_inference(model, config=config, params=params)
            eng.generate(batches["left"][0][:, -16:], max_new_tokens=2,
                         attention_mask=batches["left"][1][:, -16:])  # warm-up
            solo = [eng.generate(r[None], max_new_tokens=NEW,
                                 attention_mask=np.ones((1, len(r))))[0, len(r):]
                    for r in rows]
            for side in ("left", "right"):
                toks, mask = batches[side]
                torch.cuda.synchronize()
                op_builder.reset_launch_counts()
                t0 = time.perf_counter()
                out = eng.generate(toks, max_new_tokens=NEW, attention_mask=mask)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launched = op_builder.launch_counts()
                for k, c in launched.items():
                    counts[k] = counts.get(k, 0) + c
                step = chunk or W
                chunks = sum(1 for lo in range(0, W, step) if mask[:, lo:lo + step].any())
                norms = (2 * L + 1) * (chunks + NEW - 1)
                check(launched["flash_fwd"] == 0 and launched["fused_norm_fwd"] == norms
                      and launched["fused_norm_bwd"] == 0,
                      f"ragged {kv} {chunk} {side}: K1/K7/K8 launched {launched['flash_fwd']}/"
                      f"{launched['fused_norm_fwd']}/{launched['fused_norm_bwd']} times, "
                      f"expected 0/{norms}/0")
                check(tuple(out.shape) == (B, W + NEW) and torch.equal(out[:, :W], toks.int()),
                      f"ragged {kv} {chunk} {side}: shape {tuple(out.shape)} / prompt region")
                per_row = []
                for b, r in enumerate(rows):
                    got, want = out[b, W:], solo[b]
                    diff = torch.nonzero(got != want).flatten().tolist()
                    entry = {"len": len(r), "equal": not diff}
                    if diff:
                        j = diff[0]
                        top2 = path_logits(eng, r, want)[j].topk(2).values
                        margin = float(top2[0] - top2[1])
                        entry.update(first_diff_step=j, solo_margin=margin)
                        check(margin < 2 * LOGITS_TOL,
                              f"ragged {kv} {chunk} {side}: row {b} differs at step {j}, "
                              f"margin {margin} >= {2 * LOGITS_TOL}")
                    per_row.append(entry)
                emit({"phase": "ragged_chunked", "kv_cache_dtype": kv, "chunk": chunk,
                      "padding": side, "batch": B, "lens": list(lens), "width": W,
                      "new_tokens": NEW, "prefill_chunks": chunks, "generate_s": wall,
                      "new_tokens_per_s": B * NEW / wall, "k1_launches": launched["flash_fwd"],
                      "k7_launches": launched["fused_norm_fwd"],
                      "k8_launches": launched["fused_norm_bwd"], "rows": per_row,
                      "tie_margin": 2 * LOGITS_TOL, "card": card})
            if chunk is None:
                toks, mask = batches["left"]
                emit({"phase": "ragged_chunked_step", "kv_cache_dtype": kv, "padding": "left",
                      **step_profile(eng, toks, attention_mask=mask), "card": card})
            del eng
            torch.cuda.empty_cache()
    return counts


SERVE_REQUESTS, SERVE_NEW = 32, 64
# bench_serving's pool: slots, cache length, burst
SERVE_SLOTS, SERVE_CACHE, SERVE_BURST = 8, 256, 4
# the speculative phases profile a window (the first requests of a
# schedule, a few rounds of a generate): the profiler's cost grows with the
# launches it records
PROFILED_REQUESTS, PROFILED_NEW = 4, (6, 18)
# the draft mode's depth-0 replay and the self-draft pool take the first
# requests of the schedule
DEPTH0_DRAFT_REQUESTS, SELF_DRAFT_REQUESTS = 8, 16


def serving_schedule(vocab_size):
    """``bench_serving``'s arrival schedule: 32 requests of 64 new tokens,
    prompts of 32-128 tokens (``RandomState(7)``; tokens from
    ``RandomState(0)``), two arriving a step: [(step, prompt, new)]."""
    import numpy as np

    rs = np.random.RandomState(7)
    arrivals = [(t // 2, int(rs.randint(32, 129)), SERVE_NEW) for t in range(SERVE_REQUESTS)]
    rs = np.random.RandomState(0)
    return [(t, rs.randint(0, vocab_size, (n,)).astype(np.int32), new) for t, n, new in arrivals]


def serving_model(gen):
    """The serving phases' model: GPT-2 125M at full width and depth
    (``max_seq_len`` 1024) and its bf16 weights drawn from ``gen``."""
    from deepspeed_tpu_torch.models import transformer as tf

    model = tf.TransformerModel.from_preset("gpt2-125m", dtype="bfloat16", max_seq_len=1024)
    return model, tf.map_params(lambda p: p.to(torch.bfloat16), model.init(gen))


def build_pool(model, params, config=None, **kwargs):
    """A batching engine in ``bench_serving``'s geometry: 8 slots of cache
    256, bf16, flash asked for (vector positions keep K1 off), bursts of 4
    unless ``tokens_per_tick`` says otherwise; ``config`` adds to that
    engine config."""
    from deepspeed_tpu_torch.inference import ContinuousBatchingEngine

    kwargs.setdefault("tokens_per_tick", SERVE_BURST)
    return ContinuousBatchingEngine(
        model, config={"dtype": "bfloat16", "attn_impl": "pallas", **(config or {})},
        params=params, max_slots=SERVE_SLOTS, cache_len=SERVE_CACHE, **kwargs)


def warm_pool(eng, queue, cache_len):
    """Warm a batching engine as the bench's build_engine and run_spec do:
    the tick family, then one request a prompt bucket (the admission
    prefills); the tick counters then start from 0, as the loadgen's
    ``--warm`` leaves them. Returns (tick functions warmed, seconds)."""
    import numpy as np

    from deepspeed_tpu_torch.inference import decoding as dec

    t0 = time.perf_counter()
    programs = eng.precompile_tick_programs()
    for b in sorted({dec.read_bucket(int(p.size), cache_len) for _, p, _ in queue}):
        eng.submit(np.zeros(b, np.int32), max_new_tokens=4)
    while eng.has_work():
        eng.step()
    eng.finished()
    for k, v in eng._tick_stats.items():
        eng._tick_stats[k] = type(v)(0)
    torch.cuda.synchronize()
    return programs, time.perf_counter() - t0


def drive(counts, fn):
    """Run one driven serve with the kernel launch counts from 0, add them
    to ``counts`` and return what ``fn`` returns."""
    from deepspeed_tpu_torch.ops import op_builder

    op_builder.reset_launch_counts()
    out = fn()
    for k, c in op_builder.launch_counts().items():
        counts[k] = counts.get(k, 0) + c
    return out


class ServingBuild:
    """The serving phases' one GPT-2 125M build: ``serving_model``'s model
    and bf16 weights (drawn from ``gen``), ``serving_schedule``'s 32
    requests, and ``engine()``: a batching engine in ``build_pool``'s
    geometry on those weights, warmed as the bench's build_engine
    (``warm_pool``; its tick programs and seconds in ``last_warm``) unless
    ``warm`` is False; ``gamma`` and ``mode`` make it a speculative pool."""

    def __init__(self, gen):
        self.model, self.params = serving_model(gen)
        self.queue = serving_schedule(self.model.cfg.vocab_size)
        self.last_warm = None

    def engine(self, config=None, *, warm=True, gamma=None, mode=None, **kwargs):
        config = dict(config or {})
        if gamma is not None:
            config["speculative"] = {"enabled": True, "pool": True, "mode": mode,
                                     "num_draft_tokens": gamma}
        eng = build_pool(self.model, self.params, config, **kwargs)
        if warm:
            self.last_warm = warm_pool(eng, self.queue, SERVE_CACHE)
        return eng


class ScheduleFront:
    """``replay_schedule``'s one view of what it drives. A batching engine
    takes request i as rid i (the rid is part of a sampled token's key) and
    gives its results from ``finished()``; a ``ServingEngine`` or a
    ``FleetRouter`` (the same admission surface) gives the rid from its
    ``submit`` (a shed fails the check) and its finished results from
    ``reap()``, keeping each one's engine rid in ``engine_rids`` (by the
    rid that ``rid_of`` gives request i)."""

    def __init__(self, target):
        from deepspeed_tpu_torch.inference import ContinuousBatchingEngine

        self.target = target
        self.bare = isinstance(target, ContinuousBatchingEngine)
        self.rid_of, self.engine_rids = {}, {}

    def engines(self):
        if self.bare:
            return [self.target]
        if hasattr(self.target, "steppable_engines"):
            return [srv._cb for _, srv in self.target.steppable_engines()]
        return [self.target._cb]

    def submit(self, i, prompt, new):
        if self.bare:
            rid = self.target.submit(prompt, max_new_tokens=new, rid=i)
        else:
            adm = self.target.submit(prompt, max_new_tokens=new)
            check(adm.status != "shed", f"replay through {type(self.target).__name__}: "
                                        f"request {i} shed ({adm.reason})")
            rid = adm.rid
        self.rid_of[i] = rid
        return rid

    def collect(self):
        if self.bare:
            return self.target.finished()
        done = {rid: r for rid, r in self.target.reap().items() if r.state == "finished"}
        self.engine_rids.update({rid: r.engine_rid for rid, r in done.items()})
        return {rid: r.result for rid, r in done.items()}

    def tick_stats(self):
        if hasattr(self.target, "steppable_engines"):
            return fleet_tick_stats(self.target)
        return self.target.tick_stats()


def fleet_tick_stats(router):
    """The tick counters summed over every replica a ``FleetRouter`` has
    held, dead and drained ones too (its own ``tick_stats()`` sums the
    live ones only, so a replica that leaves takes its ticks with it)."""
    out = {}
    for rep in router._replicas.values():
        for k, v in rep.serving.tick_stats().items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out[k] = out.get(k, 0) + v
    return out


def replay_schedule(target, queue, depth, front=None):
    """One replay of an arrival schedule [(step, prompt, new)] at a
    pipeline depth, as ``bench_serving``'s run_serve, through a batching
    engine, a ``ServingEngine`` or a ``FleetRouter`` (``ScheduleFront``;
    pass ``front`` to keep its engine rids); returns the row of host and
    token counts (tick counters summed over the engines) and each request's
    result."""
    front = front or ScheduleFront(target)
    engines = front.engines()
    for eng in engines:
        eng.pipeline_depth = depth
    keys = ("block_ms", "dispatch_ms", "ticks", "wasted_tokens", "spec_drafted",
            "spec_accepted")
    stats0 = front.tick_stats()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step, done_tokens, completed = 0, 0, 0
    pending, rid_of, results = list(range(len(queue))), {}, {}
    while pending or target.has_work():
        for i in [i for i in pending if queue[i][0] <= step]:
            rid_of[i] = front.submit(i, queue[i][1], queue[i][2])
        pending = [i for i in pending if queue[i][0] > step]
        done_tokens += sum(len(v) for v in target.step().values())
        finished = front.collect()
        completed += len(finished)
        results.update(finished)
        step += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats1 = front.tick_stats()
    delta = {k: stats1.get(k, 0) - stats0.get(k, 0) for k in keys}
    block, dispatch = delta["block_ms"], delta["dispatch_ms"]
    row = {"tokens_per_s": done_tokens / wall, "tokens": done_tokens,
           "completed": completed, "steps": step, "ticks": delta["ticks"], "wall_s": wall,
           "tick_dispatch_ms": dispatch, "tick_block_ms": block,
           "block_ms_per_token": block / done_tokens if done_tokens else None,
           "overlap_frac": 1.0 - block / (dispatch + block) if dispatch + block else None,
           "wasted_tokens": delta["wasted_tokens"]}
    if engines[0].spec_gamma:
        row.update(spec_drafted=delta["spec_drafted"], spec_accepted=delta["spec_accepted"],
                   spec_acceptance=(delta["spec_accepted"] / delta["spec_drafted"]
                                    if delta["spec_drafted"] else None))
    return row, [results.get(rid_of.get(i)) for i in range(len(queue))]


def profiled_replay(eng, queue, depth, row, what, window=None):
    """The device's kernel time and launches a tick from one profiled replay
    of the schedule (or of its first ``window`` requests, which keeps the
    profile short) through ``eng`` (anything ``replay_schedule`` drives),
    and the idle share of the unprofiled run ``row`` (its ``ticks`` and
    ``wall_s``): 1 - device ms a tick x its ticks / its wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prow, _ = replay_schedule(eng, queue[:window], depth)
    kernels = device_kernels(prof)
    device_s, launches = sum(t for _, t, _ in kernels), sum(c for _, _, c in kernels)
    measured = device_s > 0
    check(measured, f"{what}: the profiler saw no device kernel")
    per_tick = device_s / prow["ticks"]
    return dict(
        device_ms_per_tick=per_tick * 1e3 if measured else "not measured",
        launches_per_tick=launches / prow["ticks"],
        device_idle_share=(1 - per_tick * row["ticks"] / row["wall_s"]) if measured
        else "not measured",
        profiled_requests=len(queue[:window]), profiled_replay_wall_s=prow["wall_s"],
        device_ms_by_category={c: v["device_s"] * 1e3 for c, v in by_category(kernels).items()})


def teacher_forced_logits(params, cfg, floor, row, gen_toks):
    """A single row's own logits for each of its tokens as ``generate``
    computes them: its prefill, then its decode steps teacher-forced, at its
    read geometry. (row: the prompt, numpy; gen_toks: the generated tokens,
    a CUDA tensor.)"""
    from deepspeed_tpu_torch.inference import decoding as dec
    from deepspeed_tpu_torch.models import transformer as tf

    S, T = row.size, cfg.max_seq_len
    with torch.inference_mode():
        c = tf.init_cache(cfg, 1, T, "cuda")
        lg, c = tf.forward_with_cache(params, cfg, torch.from_numpy(row[None]).long().cuda(), c,
                                      0, last_only=True)
        out, pos, j = [lg[0, -1]], S, 0
        for read_len, n in dec.read_stages(S, len(gen_toks) - 1, T, floor):
            for _ in range(n):
                st, c = tf.forward_with_cache(params, cfg, gen_toks[None, j:j + 1].long(), c, pos,
                                              read_len=read_len)
                out.append(st[0, -1])
                pos, j = pos + 1, j + 1
    return torch.stack(out).float()


def stream_agreement(got, want, prompt, margins_of, what):
    """Compare a generated stream with the one it must equal: equal, or the
    first difference at a step whose ``want`` top-2 margin (from
    ``margins_of()``, a (new,) tensor) is under 2 LOGITS_TOL, the bf16 tie
    rule."""
    import numpy as np

    got, want = np.asarray(got)[prompt.size:], np.asarray(want)[prompt.size:]
    diff = np.nonzero(got != want)[0]
    entry = {"len": int(prompt.size), "equal": not diff.size}
    if diff.size:
        j = int(diff[0])
        margin = float(margins_of()[j])
        entry.update(first_diff_step=j, margin=margin)
        check(margin < 2 * LOGITS_TOL,
              f"{what}: a stream of a {prompt.size}-token prompt differs at step {j}, "
              f"margin {margin} >= {2 * LOGITS_TOL}")
    return entry


def top2_margins(logits):
    top2 = logits.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]).cpu()


def serve_pool_phase(gen, card):
    """The continuous-batching serving tick (``ContinuousBatchingEngine``) in
    ``bench_serving``'s geometry (the JAX package's ``_bench_impl.py:608-
    700``): GPT-2 125M at full width and depth, bf16, random weights, 8 slots
    of cache 256, burst ticks of 4 tokens, 32 requests of 64 new tokens with
    prompts of 32-128 tokens (``RandomState(7)``; tokens from
    ``RandomState(0)``) arriving two a step. Attention is asked for flash
    (``attn_impl="pallas"``), so K1's 0 launches show that vector positions
    keep it off. Warm-up as the bench's ``build_engine``: the whole tick
    family, then one request a prompt bucket. Then the schedule at
    ``pipeline_depth`` 0 and then 1 (``serve_pool``: tokens/s, completed,
    steps and ticks, wall, dispatch and blocked ms, their shares, K1/K7/K8
    launches, and from one profiled replay the device ms and launches a tick
    and the idle share against the unprofiled wall). Checks: every request
    completes at both depths with the same streams, each equal to its own
    single-row ``generate`` or first differing where that path's top-2
    margin is under 2 LOGITS_TOL; K7 launches (2L + 1) a forward (4 a burst
    tick, 1 an admission prefill), K1 and K8 never; a burst tick and a
    fused-prefill tick, admissions included, dispatch under
    ``torch.cuda.set_sync_debug_mode("error")``; a sampled serve
    (temperature 0.8, top-k 40) gives the same tokens at both depths; the
    sampler's keyed uniforms equal the CPU's bit for bit. Also K7 at the
    tick's shape (8 x 768 bf16) against its bound, its plain version and
    ``F.layer_norm`` (``serve_pool_k7``). Returns the launch counts of the
    two measured serves."""
    import numpy as np
    import torch.nn.functional as F

    from deepspeed_tpu_torch.inference import decoding as dec
    from deepspeed_tpu_torch.ops import fused_norm as fnorm
    from deepspeed_tpu_torch.ops import op_builder

    SLOTS, CACHE, BURST, NEW, N_REQ = (SERVE_SLOTS, SERVE_CACHE, SERVE_BURST, SERVE_NEW,
                                       SERVE_REQUESTS)
    sb = ServingBuild(gen)
    model, queue = sb.model, sb.queue
    L, V, D = model.cfg.num_layers, model.cfg.vocab_size, model.cfg.hidden_size

    def run_serve(eng, depth):
        return replay_schedule(eng, queue, depth)

    eng = sb.engine()
    programs, warm_s = sb.last_warm
    counts, rows, streams = {}, {}, {}
    for depth in (0, 1):
        op_builder.reset_launch_counts()
        rows[depth], streams[depth] = run_serve(eng, depth)
        launched = op_builder.launch_counts()
        for k, c in launched.items():
            counts[k] = counts.get(k, 0) + c
        r = rows[depth]
        norms = (2 * L + 1) * (BURST * r["ticks"] + N_REQ)
        check(launched["flash_fwd"] == 0 and launched["fused_norm_fwd"] == norms
              and launched["fused_norm_bwd"] == 0,
              f"serve_pool depth {depth}: K1/K7/K8 launched {launched['flash_fwd']}/"
              f"{launched['fused_norm_fwd']}/{launched['fused_norm_bwd']} times, "
              f"expected 0/{norms}/0")
        r.update(k1_launches=launched["flash_fwd"], k7_launches=launched["fused_norm_fwd"],
                 k8_launches=launched["fused_norm_bwd"])
        complete = r["completed"] == N_REQ and all(
            s is not None and s.size == q[1].size + NEW for s, q in zip(streams[depth], queue))
        check(complete, f"serve_pool depth {depth}: {r['completed']} of {N_REQ} requests "
                        f"completed with {NEW} new tokens each")
    # one profiled replay a depth: the device's kernel time and launches a
    # tick, and its idle share of the unprofiled serve's wall
    for depth in (0, 1):
        rows[depth].update(profiled_replay(eng, queue, depth, rows[depth],
                                           f"serve_pool depth {depth}"))
        emit({"phase": "serve_pool", "model": "gpt2-125m", "dtype": "bfloat16", "slots": SLOTS,
              "cache_len": CACHE, "tokens_per_tick": BURST, "requests": N_REQ,
              "new_tokens": NEW, "pipeline_depth": depth, "tick_programs": programs,
              "warmup_s": warm_s, **rows[depth], "card": card})

    same = all(a is not None and b is not None and np.array_equal(a, b)
               for a, b in zip(streams[0], streams[1]))
    check(same, "serve_pool: the streams at depth 0 and depth 1 differ")
    agree = []
    for (_, p, _), got in zip(queue, streams[0]):
        want = eng._eng.generate(torch.from_numpy(p[None]).long().cuda(),
                                 max_new_tokens=NEW)[0, p.size:].cpu().numpy()
        got = got[p.size:]
        diff = np.nonzero(got != want)[0]
        entry = {"len": int(p.size), "equal": not diff.size}
        if diff.size:
            j = int(diff[0])
            top2 = teacher_forced_logits(eng._eng.params, eng.cfg, eng._eng._tight_floor(), p,
                                         torch.from_numpy(want).cuda())[j].topk(2).values
            margin = float(top2[0] - top2[1])
            entry.update(first_diff_step=j, solo_margin=margin)
            check(margin < 2 * LOGITS_TOL,
                  f"serve_pool: request of {p.size} tokens differs from its single-row "
                  f"generate at step {j}, margin {margin} >= {2 * LOGITS_TOL}")
        agree.append(entry)
    emit({"phase": "serve_pool_streams", "depths_equal": same,
          "equal_to_single_row": sum(e["equal"] for e in agree), "requests": agree,
          "tie_margin": 2 * LOGITS_TOL, "card": card})
    del eng
    torch.cuda.empty_cache()

    # a burst tick and a fused-prefill tick, with their admissions, dispatched
    # where any host sync raises: a depth of 8 retires nothing in two steps
    sync_rows = []
    for tpt in (BURST, 1):
        seng = sb.engine(warm=False, tokens_per_tick=tpt, pipeline_depth=8)
        prompts = [q[1] for q in queue[:3]]
        for p in prompts:  # warm the same shapes first
            seng.submit(p, max_new_tokens=8)
        while seng.has_work():
            seng.step()
        want = seng.finished()
        rids = [seng.submit(p, max_new_tokens=8) for p in prompts]
        torch.cuda.synchronize()
        error = None
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(2):
                seng.step()
        except RuntimeError as e:
            error = str(e)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        inflight = len(seng._inflight)
        check(error is None and inflight == 2,
              f"serve_pool_sync tokens_per_tick={tpt}: {inflight} ticks in flight, "
              f"sync error {error}")
        if error is None:
            while seng.has_work():
                seng.step()
            got = seng.finished()
            check(all(np.array_equal(got[r], want[w]) for r, w in zip(rids, sorted(want))),
                  f"serve_pool_sync tokens_per_tick={tpt}: the results differ from the "
                  f"same requests served before")
        sync_rows.append({"tokens_per_tick": tpt, "fused_prefill": seng.fused_prefill,
                          "steps_dispatched": 2, "ticks_in_flight": inflight,
                          "fused_prefill_ticks": seng.tick_stats()["fused_prefill_ticks"],
                          "sync_error": error})
        del seng
    emit({"phase": "serve_pool_sync", "runs": sync_rows, "card": card})

    # sampled: the same tokens at both depths (per-request keys)
    seng = sb.engine(temperature=0.8, top_k=40, seed=3)
    sampled = {depth: run_serve(seng, depth)[1] for depth in (0, 1)}
    same_sampled = all(a is not None and b is not None and np.array_equal(a, b)
                       for a, b in zip(sampled[0], sampled[1]))
    check(same_sampled, "serve_pool_sampled: the sampled streams at depth 0 and 1 differ")
    del seng
    torch.cuda.empty_cache()
    rids = torch.arange(8).repeat_interleave(6)
    gens = torch.tensor([0, 1, 2, 63, 64, 10 ** 6]).repeat(8)
    u_cpu = dec.request_uniforms(3, rids, gens, V)
    u_card = dec.request_uniforms(3, rids.cuda(), gens.cuda(), V).cpu()
    keys_equal = torch.equal(u_cpu, u_card)
    check(keys_equal, "serve_pool_sampled: the keyed uniforms differ between card and CPU")
    emit({"phase": "serve_pool_sampled", "temperature": 0.8, "top_k": 40,
          "depths_equal": same_sampled, "keyed_uniforms_equal_cpu": keys_equal,
          "uniforms_checked": int(u_cpu.numel()),
          "sampled_differs_from_greedy": any(not np.array_equal(a, b)
                                             for a, b in zip(sampled[0], streams[0])),
          "card": card})

    # K7 at the tick's shape: 8 decode rows of D 768, bf16 weights and bias
    x = torch.randn(SLOTS, D, generator=gen, device="cuda", dtype=torch.bfloat16)
    scale = torch.randn(D, generator=gen, device="cuda", dtype=torch.bfloat16)
    bias = torch.randn(D, generator=gen, device="cuda", dtype=torch.bfloat16)
    out = fnorm._cuda_fwd(x, scale, bias, 1e-5, False, with_stats=False)[0]
    ref = fnorm._reference_fwd(x, scale, bias, 1e-5, False)[0]
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= NORM_TOL[torch.bfloat16] * max(ref.float().abs().max().item(), 1.0),
          f"serve_pool_k7: K7 at 8 x 768 differs from its plain version by {err}")
    (bound_ms, bound_by), _ = norm_bounds(SLOTS, D, torch.bfloat16, torch.bfloat16, True,
                                          reference_partial_rows(SLOTS))
    k7 = {"phase": "serve_pool_k7", "rows": SLOTS, "D": D, "dtype": "bfloat16",
          "variant": fnorm.kernel_variant(D, x.dtype, x), "max_abs_err": err,
          "ms": cuda_ms(lambda: fnorm._cuda_fwd(x, scale, bias, 1e-5, False, with_stats=False)),
          "plain_ms": cuda_ms(lambda: fnorm._reference_fwd(x, scale, bias, 1e-5, False)),
          "library_ms": cuda_ms(lambda: F.layer_norm(x, (D,), scale, bias, 1e-5)),
          "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes": norm_bytes(SLOTS, D, torch.bfloat16, torch.bfloat16, True,
                              reference_partial_rows(SLOTS))[0], "card": card}
    emit(k7)
    return counts, k7


@contextlib.contextmanager
def counted_rounds(dec):
    """Record each speculative round's (active rows, accepted drafts) by
    wrapping the loop's host acceptance (``decoding._accept_round``, which
    the loop looks up by name each round)."""
    rounds, accept = [], dec._accept_round

    def counted(drafts, active, *args, **kwargs):
        out = accept(drafts, active, *args, **kwargs)
        rounds.append((int(active.sum()), int(out[0].sum())))
        return out

    dec._accept_round = counted
    try:
        yield rounds
    finally:
        dec._accept_round = accept


def spec_generate_phase(gen, card):
    """``bench_decode``'s draft probe (the JAX package's ``_bench_impl.py:535-
    577``) through ``init_inference(draft_model=)`` -> ``generate``: the GPT-2
    350M bf16 target of the serving phase (weights from seed 0, flash
    attention, ``max_out_tokens`` 256) and a draft of the same preset at 4
    layers, B 8 x 128 + 128 greedy, at gamma 2, 4 and 8; plain ``generate``
    on the same weights is the yardstick, in the same call. For each gamma
    (``spec_generate``): the wall, new tokens/s and the speedup over plain,
    the rounds, the acceptance (drafts accepted over drafts proposed to
    active rows), device ms and launches a round from two short profiled
    calls (8 and 24 new tokens: their difference over the rounds'), the idle
    share (1 - device ms a round x rounds / the unprofiled wall), and
    K1/K7/K8 launches. Checks:
    K1 launches once a layer for each prefill (24 + 4), K7 (2L + 1) a
    forward of either model ((1 + rounds) target forwards, 1 + rounds x
    (gamma + 1) draft ones), K8 never; each stream equals plain greedy or
    first differs at a step whose plain top-2 margin is under 2 LOGITS_TOL
    (the single-row teacher-forced logits). Then the target as its own
    draft at gamma 4, under the same rule (``spec_generate_self``). Returns
    the launch counts of the three measured calls."""
    from torch.profiler import ProfilerActivity, profile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import decoding as dec
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import op_builder

    B, P, NEW, CACHE, GAMMAS = 8, 128, 128, 256, (2, 4, 8)
    model = tf.TransformerModel.from_preset("gpt2-350m", dtype="bfloat16")
    draft_model = tf.TransformerModel.from_preset("gpt2-350m", dtype="bfloat16", num_layers=4,
                                                  attn_impl="pallas")
    base = {"dtype": "bfloat16", "attn_impl": "pallas", "max_out_tokens": CACHE}
    eng = deepspeed_tpu_torch.init_inference(
        model, config={**base, "speculative": {"enabled": True, "mode": "draft",
                                               "num_draft_tokens": GAMMAS[0]}},
        draft_model=draft_model, seed=0)
    plain = deepspeed_tpu_torch.init_inference(model, config=base, params=eng.params)
    L, Ld, V = eng.cfg.num_layers, eng._draft_engine.cfg.num_layers, eng.cfg.vocab_size
    toks = torch.randint(0, V, (B, P), generator=gen, device="cuda")
    rows_np = toks.cpu().numpy()

    plain.generate(toks, max_new_tokens=NEW)  # warm-up
    plain_wall = generate_wall(plain, toks, NEW)[0]
    want = plain.generate(toks, max_new_tokens=NEW).cpu().numpy()
    margins = {}

    def margins_of(b):
        def get():
            if b not in margins:
                margins[b] = top2_margins(teacher_forced_logits(
                    plain.params, plain.cfg, plain._tight_floor(), rows_np[b],
                    torch.from_numpy(want[b, P:]).cuda()))
            return margins[b]
        return get

    def agreement(out, what):
        return [stream_agreement(out[b], want[b], rows_np[b], margins_of(b), what)
                for b in range(B)]

    def spec_call(engine, gamma, new=NEW, **kwargs):
        with counted_rounds(dec) as rounds:
            out = engine.generate(toks, max_new_tokens=new, num_draft_tokens=gamma, **kwargs)
            torch.cuda.synchronize()
        active = sum(a for a, _ in rounds)
        return out, {"rounds": len(rounds), "drafted": gamma * active,
                     "accepted": sum(n for _, n in rounds),
                     "acceptance": sum(n for _, n in rounds) / (gamma * active) if active else None}

    emit({"phase": "spec_generate_plain", "model": "gpt2-350m", "batch": B, "prompt": P,
          "new_tokens": NEW, "cache_len": CACHE, "generate_s": plain_wall,
          "new_tokens_per_s": B * NEW / plain_wall, "card": card})
    counts = {}
    def profiled_round(gamma):
        """Device ms, launches and kernel categories a round: two profiled
        calls of PROFILED_NEW new tokens, (long - short) / their rounds'
        difference, so the prefills cancel."""
        got = []
        for new in PROFILED_NEW:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, acc = spec_call(eng, gamma, new=new)
            kernels = device_kernels(prof)
            got.append((sum(t for _, t, _ in kernels), sum(c for _, _, c in kernels),
                        acc["rounds"], by_category(kernels)))
        (d0, n0, r0, c0), (d1, n1, r1, c1) = got
        rounds = max(r1 - r0, 1)
        return ((d1 - d0) / rounds if d1 > 0 else None, (n1 - n0) / rounds,
                {c: (v["device_s"] - c0.get(c, {"device_s": 0.0})["device_s"]) * 1e3 / rounds
                 for c, v in c1.items()})

    for gamma in GAMMAS:
        spec_call(eng, gamma, new=4)  # warm-up: the round shapes
        op_builder.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, acc = spec_call(eng, gamma)
        wall = time.perf_counter() - t0
        launched = op_builder.launch_counts()
        for k, c in launched.items():
            counts[k] = counts.get(k, 0) + c
        R = acc["rounds"]
        k1, k7, k8 = (launched[k] for k in ("flash_fwd", "fused_norm_fwd", "fused_norm_bwd"))
        k7_want = (2 * L + 1) * (1 + R) + (2 * Ld + 1) * (1 + R * (gamma + 1))
        check(k1 == L + Ld and k7 == k7_want and k8 == 0,
              f"spec_generate gamma {gamma}: K1/K7/K8 launched {k1}/{k7}/{k8} times, "
              f"expected {L + Ld}/{k7_want}/0")
        out = out.cpu().numpy()
        check(out.shape == (B, P + NEW) and bool(((out >= 0) & (out < V)).all()),
              f"spec_generate gamma {gamma}: output shape {out.shape} / range")
        agree = agreement(out, f"spec_generate gamma {gamma}")
        device_s, launches, categories = profiled_round(gamma)
        measured = device_s is not None
        check(measured, f"spec_generate gamma {gamma}: the profiler saw no device kernel")
        emit({"phase": "spec_generate", "gamma": gamma, "draft": "gpt2-350m, 4 layers",
              "batch": B, "prompt": P, "new_tokens": NEW, "generate_s": wall,
              "new_tokens_per_s": B * NEW / wall, "speedup_vs_plain": plain_wall / wall,
              **acc, "tokens_per_round_per_row": (NEW - 1) / R,
              "device_ms_per_round": device_s * 1e3 if measured else "not measured",
              "launches_per_round": launches,
              "device_idle_share": 1 - device_s * R / wall if measured else "not measured",
              "device_ms_by_category_per_round": categories,
              "k1_launches": k1, "k7_launches": k7, "k8_launches": k8,
              "streams_equal_to_plain": sum(e["equal"] for e in agree), "rows": agree,
              "tie_margin": 2 * LOGITS_TOL, "card": card})
    out, acc = spec_call(plain, 4, draft=plain)
    agree = agreement(out.cpu().numpy(), "spec_generate_self")
    emit({"phase": "spec_generate_self", "gamma": 4, "draft": "the target itself", **acc,
          "streams_equal_to_plain": sum(e["equal"] for e in agree), "rows": agree,
          "card": card})
    del eng, plain
    torch.cuda.empty_cache()
    return counts


def serve_pool_spec_phase(gen, card):
    """``bench_serving``'s speculative pool (the JAX package's
    ``_bench_impl.py:767-840``): GPT-2 125M bf16 at full width and depth
    (flash asked for, vector positions keep K1 off), 8 slots of cache 256,
    ``tokens_per_tick=1``, the 32-request schedule of ``serve_pool``. Runs:
    ngram at gamma 2, 4 and 8, then draft mode (``gpt2-125m`` at 3 layers,
    weights from seed 1) at the best ngram gamma, each warmed as the bench's
    run_spec warms it; the plain pool at ``tokens_per_tick=1`` is the
    yardstick, in the same call. For each (``serve_pool_spec``): tokens/s
    at depth 1 and 0, the acceptance, device ms and launches a tick from one
    profiled replay of the schedule's first 4 requests, the idle share (1 -
    device ms a tick x ticks / the unprofiled wall), K1/K7/K8 launches. Checks: every
    request completes; the streams at depths 0 and 1 are equal (draft mode:
    a depth-0 replay of the first 8 requests), and each
    equals the plain pool's or first differs at a step whose single-row
    top-2 margin is under 2 LOGITS_TOL; K7 launches 25 a target forward (a
    tick, a fused prompt chunk), plus 7 a draft forward (gamma + 1 a tick,
    one prefill a request) in draft mode, K1 and K8 never. Then the target
    as its own draft at gamma 4 over the first 16 requests, whose
    acceptance must reach 0.9
    (``serve_pool_spec_self``), and a spec tick of each mode, fused and
    separate admission included, dispatched where a host sync raises
    (``serve_pool_spec_sync``). Returns the launch counts of the measured
    speculative serves."""
    import numpy as np

    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import op_builder

    SLOTS, CACHE, GAMMAS = SERVE_SLOTS, SERVE_CACHE, (2, 4, 8)
    sb = ServingBuild(gen)
    model, params, queue = sb.model, sb.params, sb.queue
    L, V = model.cfg.num_layers, model.cfg.vocab_size
    draft_model = tf.TransformerModel.from_preset("gpt2-125m", dtype="bfloat16",
                                                  max_seq_len=1024, num_layers=3)
    draft_params = tf.map_params(lambda p: p.to(torch.bfloat16), draft_model.init(
        torch.Generator(device="cuda").manual_seed(1)))
    Ld = draft_model.cfg.num_layers

    def build(gamma=None, mode=None, **kwargs):
        if mode == "draft":
            kwargs.setdefault("draft_model", draft_model)
            kwargs.setdefault("draft_params", draft_params)
        return sb.engine(gamma=gamma, mode=mode, tokens_per_tick=1, **kwargs)

    eng = build()
    plain_row, plain_streams = replay_schedule(eng, queue, 1)
    plain_row.update(profiled_replay(eng, queue, 1, plain_row, "serve_pool_spec plain",
                                     window=PROFILED_REQUESTS))
    margins = {}

    def margins_of(i):
        def get():
            if i not in margins:
                margins[i] = top2_margins(teacher_forced_logits(
                    eng._eng.params, eng.cfg, eng._eng._tight_floor(), queue[i][1],
                    torch.from_numpy(plain_streams[i][queue[i][1].size:]).cuda()))
            return margins[i]
        return get

    def agreement(streams, what):
        complete = all(s is not None and s.size == q[1].size + q[2]
                       for s, q in zip(streams, queue))
        check(complete, f"{what}: not every request completed with {SERVE_NEW} new tokens")
        if not complete:
            return []
        return [stream_agreement(s, w, q[1], margins_of(i), what)
                for i, (s, w, q) in enumerate(zip(streams, plain_streams, queue))]

    emit({"phase": "serve_pool_spec_plain", "model": "gpt2-125m", "slots": SLOTS,
          "cache_len": CACHE, "tokens_per_tick": 1, "requests": len(queue),
          "pipeline_depth": 1, **plain_row, "card": card})

    counts, best = {}, None
    plan = [(g, "ngram") for g in GAMMAS]
    while plan:
        gamma, mode = plan.pop(0)
        what = f"serve_pool_spec {mode} gamma {gamma}"
        spec = build(gamma, mode)
        programs, warm_s = sb.last_warm
        rows, streams = {}, {}
        for depth in (1, 0):
            # the draft mode's depth-0 replay takes the first requests only:
            # its rounds cost the most host time
            q = queue[:DEPTH0_DRAFT_REQUESTS] if depth == 0 and mode == "draft" else queue
            op_builder.reset_launch_counts()
            rows[depth], streams[depth] = replay_schedule(spec, q, depth)
            launched = op_builder.launch_counts()
            for k, c in launched.items():
                counts[k] = counts.get(k, 0) + c
            ticks = rows[depth]["ticks"]
            k7_want = (2 * L + 1) * (ticks + sum(1 for _, p, _ in q if p.size > 1))
            if mode == "draft":
                k7_want += (2 * Ld + 1) * ((gamma + 1) * ticks + len(q))
            k1, k7, k8 = (launched[k] for k in ("flash_fwd", "fused_norm_fwd", "fused_norm_bwd"))
            check(k1 == 0 and k7 == k7_want and k8 == 0,
                  f"{what} depth {depth}: K1/K7/K8 launched {k1}/{k7}/{k8} times, "
                  f"expected 0/{k7_want}/0")
            rows[depth].update(k1_launches=k1, k7_launches=k7, k8_launches=k8)
        same = all(a is not None and b is not None and np.array_equal(a, b)
                   for a, b in zip(streams[0], streams[1]))
        check(same, f"{what}: the streams at depth 0 and depth 1 differ")
        agree = agreement(streams[1], what)
        rows[1].update(profiled_replay(spec, queue, 1, rows[1], what, window=PROFILED_REQUESTS))
        emit({"phase": "serve_pool_spec", "mode": mode, "gamma": gamma,
              "draft": "gpt2-125m, 3 layers, seed 1" if mode == "draft" else None,
              "tick_programs": programs, "warmup_s": warm_s, **rows[1],
              "speedup_vs_plain": rows[1]["tokens_per_s"] / plain_row["tokens_per_s"],
              "depth0": {k: rows[0][k] for k in ("tokens_per_s", "completed", "wall_s", "ticks",
                                                 "spec_acceptance", "tick_block_ms")},
              "depths_equal": same, "equal_to_plain": sum(e["equal"] for e in agree),
              "streams": [e for e in agree if not e["equal"]], "card": card})
        if mode == "ngram" and (best is None or rows[1]["tokens_per_s"] > best[1]):
            best = (gamma, rows[1]["tokens_per_s"])
        if not plan and mode == "ngram":
            plan.append((best[0], "draft"))
        del spec
        torch.cuda.empty_cache()

    # the target as its own draft: greedy proposals the target would emit
    spec = build(4, "draft", draft_model=model, draft_params=params)
    row, streams = replay_schedule(spec, queue[:SELF_DRAFT_REQUESTS], 1)
    agree = agreement(streams, "serve_pool_spec_self")
    check(row["spec_acceptance"] is not None and row["spec_acceptance"] >= 0.9,
          f"serve_pool_spec_self: acceptance {row['spec_acceptance']} < 0.9")
    emit({"phase": "serve_pool_spec_self", "gamma": 4, "draft": "the target itself", **row,
          "equal_to_plain": sum(e["equal"] for e in agree), "card": card})
    del spec, eng
    torch.cuda.empty_cache()

    # spec ticks of both modes, with their admissions, where any host sync
    # raises: a depth of 8 retires nothing in two steps
    sync_rows = []
    for mode in ("ngram", "draft"):
        for fused in (True, False):
            seng = build(4, mode, warm=False, pipeline_depth=8, fused_prefill=fused)
            prompts = [q[1] for q in queue[:3]]
            for p in prompts:  # warm the same shapes first
                seng.submit(p, max_new_tokens=8)
            while seng.has_work():
                seng.step()
            want = seng.finished()
            rids = [seng.submit(p, max_new_tokens=8) for p in prompts]
            torch.cuda.synchronize()
            error = None
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(2):
                    seng.step()
            except RuntimeError as e:
                error = str(e)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            inflight = len(seng._inflight)
            check(error is None and inflight == 2,
                  f"serve_pool_spec_sync {mode} fused={fused}: {inflight} ticks in flight, "
                  f"sync error {error}")
            if error is None:
                while seng.has_work():
                    seng.step()
                got = seng.finished()
                check(all(np.array_equal(got[r], want[w]) for r, w in zip(rids, sorted(want))),
                      f"serve_pool_spec_sync {mode} fused={fused}: the results differ from the "
                      f"same requests served before")
            sync_rows.append({"mode": mode, "fused_prefill": fused, "steps_dispatched": 2,
                              "ticks_in_flight": inflight,
                              "fused_prefill_ticks": seng.tick_stats()["fused_prefill_ticks"],
                              "sync_error": error})
            del seng
    emit({"phase": "serve_pool_spec_sync", "runs": sync_rows, "card": card})
    torch.cuda.empty_cache()
    return counts


def serve_layer_phase(card):
    """The serving layer (``deepspeed_tpu_torch.serving``: ``ServingEngine``
    over the batching engine, its policies and recovery, the telemetry hub,
    the single-replica loadgen) on ``serve_pool``'s GPT-2 125M engine build
    (bf16, 8 slots of cache 256, bursts of 4). Three phases, each driven
    path counted from 0 (K7 only: vector positions keep K1 off, no K8):

    - ``serve_layer_overhead``: ``serve_pool``'s 32-request schedule at
      depth 1 through a bare ``ContinuousBatchingEngine``, through
      ``ServingEngine`` (fifo, the hub off) and with the hub on and a
      trace written, each on its own engine, twice in turns (bare, layer,
      hub, hub, layer, bare); tokens/s, ticks, dispatch and blocked ms a
      tick, each arm's mean tokens/s over the bare pool's; every stream
      the same as the first bare replay's or first differing at a top-2
      margin < 2 LOGITS_TOL.
    - ``serve_layer_load``: ``synth_workload(48, seed=0, prompts 32-128, 64
      new)`` through ``run_load`` on the real clock, (a) fifo at 4 req/s
      Poisson with the hub on, the ops server scraped over loopback once
      during the run (from another thread; it must succeed and end before
      the run does) and once after, and a request's timeline rebuilt from
      the trace, (b) edf, all 48 arriving at once (the burst process) into
      a queue of 16, each with a deadline of 1.25 waves at the layer arm's
      measured pace, so that it must shed and expire (checked);
      ``summarize``'s scorecard of each; every record terminal, none lost;
      (a)'s first 8 finished streams against their single-row ``generate``
      under the tie rule.
    - ``serve_layer_chaos``: the schedule's first 16 requests driven tick by
      tick on an injected clock, fault-free, then under a retried dispatch
      error, a fetch hang and a preemption with a same-size
      ``engine_factory``, at depths 0 and 1: every request finishes, none
      lost, conservation, ``recovery_stats()``; each recovered stream
      against the fault-free one (bit for bit where the card gives it, else
      first differing at a top-2 margin < 2 LOGITS_TOL); recovery and
      outage ms (the scorecard's goodput dip is left out: two waves of
      completions leave empty bins in the fault-free run too).

    Returns the K7/K1/K8 launch counts of the driven serves."""
    import tempfile
    import threading
    import urllib.request

    import numpy as np

    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.serving import (
        Fault,
        FaultInjector,
        FaultPlan,
        RecoveryConfig,
        ServingEngine,
    )
    from deepspeed_tpu_torch.serving import loadgen
    from deepspeed_tpu_torch.telemetry import read_trace
    from deepspeed_tpu_torch.telemetry import timeline

    # serve_pool's weights when it runs alone (a seed-0 generator)
    sb = ServingBuild(torch.Generator(device="cuda").manual_seed(0))
    model, queue = sb.model, sb.queue

    def build(config=None, **kwargs):
        return sb.engine(config, warm=False, **kwargs)

    # one engine for the single-row yardsticks and the tie margins
    solo_eng = build()._eng
    L = model.cfg.num_layers
    counts = {}

    def margins_along(prompt, gen_toks):
        """The top-2 margins of a single row's own logits along a stream."""
        return top2_margins(teacher_forced_logits(solo_eng.params, solo_eng.cfg,
                                                  solo_eng._tight_floor(), prompt, gen_toks))

    def solo(prompt, new):
        """A request's own single-row ``generate`` and its top-2 margins."""
        want = solo_eng.generate(torch.from_numpy(prompt[None]).long().cuda(),
                                 max_new_tokens=new)[0, prompt.size:]
        margins = margins_along(prompt, want)
        return np.concatenate([prompt, want.cpu().numpy()]), (lambda: margins)

    # ---- serve_layer_overhead -------------------------------------------
    # three engines built and warmed alike; their replays in turns (bare,
    # layer, hub, hub, layer, bare), so that the host's drift over the call
    # falls on every arm alike; each arm's tokens/s is the mean of its two
    runs, replays = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for run in ("bare", "layer", "layer_hub"):
            config = ({"telemetry": {"enabled": True, "trace_file": f"{tmp}/overhead.jsonl"}}
                      if run == "layer_hub" else None)
            eng = sb.engine(config)
            # the budget holds the whole schedule: these runs measure the
            # layer's cost, not its shedding
            runs[run] = eng if run == "bare" else ServingEngine(
                eng, policy="fifo", pipeline_depth=1, kv_budget_tokens=1 << 20)
        for run in ("bare", "layer", "layer_hub", "layer_hub", "layer", "bare"):
            target = runs[run]
            row, got = drive(counts, lambda: replay_schedule(target, queue, 1))
            row["tick_dispatch_ms_per_tick"] = row["tick_dispatch_ms"] / max(row["ticks"], 1)
            row["tick_block_ms_per_tick"] = row["tick_block_ms"] / max(row["ticks"], 1)
            row["k7_launches"] = op_builder.launch_counts()["fused_norm_fwd"]
            replays.setdefault(run, []).append((row, got))
        for run in ("layer", "layer_hub"):
            runs[run].close()
        trace_kinds = sorted({e["kind"] for e in read_trace(f"{tmp}/overhead.jsonl")})
    del runs
    reference = replays["bare"][0][1]
    margins = {}

    def margins_of(i):
        def get():
            if i not in margins:
                margins[i] = margins_along(
                    queue[i][1], torch.from_numpy(reference[i][queue[i][1].size:]).cuda())
            return margins[i]
        return get

    agree, rows = {}, {}
    for run, reps in replays.items():
        for j, (row, got) in enumerate(reps):
            complete = all(s is not None for s in got) and row["completed"] == len(queue)
            check(complete and row["k7_launches"] > 0,
                  f"serve_layer_overhead {run} replay {j}: {row['completed']} of {len(queue)} "
                  f"requests completed, K7 launched {row['k7_launches']} times")
            if run == "bare" and j == 0:
                continue
            agree[f"{run}_{j}"] = [
                stream_agreement(s, w, q[1], margins_of(i), f"serve_layer_overhead {run}")
                for i, (s, w, q) in enumerate(zip(got, reference, queue))
                if s is not None and w is not None]
        rows[run] = {k: [row[k] for row, _ in reps] for k in (
            "tokens_per_s", "ticks", "wall_s", "tick_dispatch_ms_per_tick",
            "tick_block_ms_per_tick", "k7_launches")}
        rows[run]["mean_tokens_per_s"] = statistics.mean(rows[run]["tokens_per_s"])
    bare_tps = rows["bare"]["mean_tokens_per_s"]
    emit({"phase": "serve_layer_overhead", "model": "gpt2-125m", "dtype": "bfloat16",
          "slots": SERVE_SLOTS, "cache_len": SERVE_CACHE, "tokens_per_tick": SERVE_BURST,
          "pipeline_depth": 1,
          "requests": len(queue), "order": "bare, layer, layer_hub, layer_hub, layer, bare",
          "runs": rows,
          "layer_over_bare_tokens_per_s": rows["layer"]["mean_tokens_per_s"] / bare_tps,
          "layer_hub_over_bare_tokens_per_s": rows["layer_hub"]["mean_tokens_per_s"] / bare_tps,
          "equal_to_bare": {run: sum(e["equal"] for e in a) for run, a in agree.items()},
          "differing": {run: [e for e in a if not e["equal"]] for run, a in agree.items()},
          "trace_kinds": trace_kinds, "card": card})
    torch.cuda.empty_cache()

    # ---- serve_layer_load ------------------------------------------------
    workload = loadgen.synth_workload(48, seed=0, prompt_range=(32, 128), new_range=(64, 64))
    vocab = model.cfg.vocab_size
    # (b)'s overload is certain whatever the host's speed: all 48 arrive at
    # once into 8 slots and a queue of 16 (24 shed), and the deadline is
    # 1.25 of a wave (8 requests' 64 tokens) at the layer arm's measured
    # pace above, so the queue's second wave, placed after two waves,
    # expires unless the host runs 1.6x faster than it did there
    wave_s = statistics.mean(rows["layer"]["wall_s"]) * SERVE_SLOTS / len(queue)
    deadline_ms = 1.25 * wave_s * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        trace = f"{tmp}/load.jsonl"
        for run, policy, kw in (("a", "fifo", {}), ("b", "edf", {"max_queue_depth": 16})):
            config = ({"telemetry": {"enabled": True, "trace_file": trace}}
                      if run == "a" else None)
            eng = sb.engine(config)
            srv = ServingEngine(eng, policy=policy, pipeline_depth=1, **kw)
            if run == "a":
                items, rate, process = workload, 4.0, "poisson"
            else:
                items = [dict(w, deadline_ms=deadline_ms) for w in workload]
                rate, process = 16.0, "burst"
            arrivals = loadgen.gen_arrivals(len(items), rate, process, seed=0,
                                            burst_size=len(items))
            mid = {}
            if run == "a":
                ops = srv.start_ops_server(port=0)

                def scrape(ops=ops):
                    with urllib.request.urlopen(ops.url + "/metrics", timeout=10) as r:
                        metrics = r.read().decode()
                    with urllib.request.urlopen(ops.url + "/healthz", timeout=10) as r:
                        return metrics, r.status, json.loads(r.read())

                def scrape_mid():
                    """The scrape taken while the run is under way, from
                    another thread: its result or its error, and when it
                    ended."""
                    try:
                        mid["scrape"] = scrape()
                    except Exception as e:  # noqa: BLE001 - checked below
                        mid["error"] = repr(e)
                    mid["done_s"] = time.perf_counter()

                timer = threading.Timer(arrivals[len(arrivals) // 2], scrape_mid)
                timer.start()
            records, wall_s = drive(counts, lambda: loadgen.run_load(srv, items, arrivals,
                                                                     seed=0))
            run_end_s = time.perf_counter()
            k7 = op_builder.launch_counts()["fused_norm_fwd"]
            summary = loadgen.summarize(records, wall_s, tick_stats=srv.tick_stats())
            lost = [i for i, r in enumerate(records)
                    if r.get("state") not in ("finished", "shed", "expired", "cancelled")]
            check(len(records) == len(items) and not lost,
                  f"serve_layer_load ({run}): requests {lost} ended in no terminal state")
            verdicts = {s: sum(1 for r in records if r["status"] == s)
                        for s in ("admitted", "queued", "shed")}
            row = {"policy": policy, "rate_rps": rate, "process": process, **kw,
                   "requests": len(items), "verdicts": verdicts, "k7_launches": k7,
                   **{k: summary.get(k) for k in (
                       "outcomes", "wall_s", "offered_rps", "shed_rate", "shed_by_reason",
                       "throughput_tok_s", "goodput_tok_s", "ttft_ms", "tbt_ms", "queue_ms",
                       "deadline_met_frac", "host")}}
            if run == "a":
                timer.join()
                final = scrape()  # and once more after the run, for the final count
                finished = sum(1 for r in records if r.get("state") == "finished")
                admitted = [float(line.split()[1]) for line in final[0].splitlines()
                            if line.startswith("serve_admitted_total ")]
                check("scrape" in mid and mid["done_s"] < run_end_s
                      and mid["scrape"][1] == final[1] == 200,
                      f"serve_layer_load (a): the scrape during the run "
                      f"{mid.get('error') or mid.get('scrape', [None, None])[1]}, ended "
                      f"{mid.get('done_s', float('nan')) - run_end_s:+.3f} s after the run; "
                      f"after the run /healthz {final[1]}")
                check(admitted == [finished],
                      f"serve_layer_load (a): /metrics serve_admitted_total {admitted}, "
                      f"{finished} requests admitted and finished")
                if "scrape" in mid:
                    row["scrape"] = {"mid_run_status": mid["scrape"][2],
                                     "mid_run_metric_lines": len(mid["scrape"][0].splitlines()),
                                     "mid_run_ended_s_before_run_end": run_end_s - mid["done_s"],
                                     "serve_admitted_total": admitted}
                agree_solo = []
                for i, r in enumerate(records):
                    if r.get("state") != "finished" or len(agree_solo) == 8:
                        continue
                    prompt = loadgen._item_prompt(items[i], i, 0, vocab)
                    want, m = solo(prompt, int(items[i]["max_new_tokens"]))
                    got = np.concatenate([prompt, np.asarray(r["generated"], np.int32)])
                    agree_solo.append(stream_agreement(got, want, prompt, m,
                                                       "serve_layer_load (a)"))
                row["equal_to_single_row"] = sum(e["equal"] for e in agree_solo)
                row["single_row_checked"] = len(agree_solo)
                srv.close()
                tls = timeline.build_timelines(read_trace(trace))
                done = [tl for tl in tls.values() if tl.spans and not tl.orphans]
                check(bool(done), "serve_layer_load (a): no clean timeline in the trace")
                if done:
                    tl = done[0]
                    row["timeline"] = {"trace_id": tl.trace_id, "spans": len(tl.spans),
                                       "duration_ms": tl.duration_ms,
                                       "critical_path_ms": tl.critical_path(),
                                       "attribution_ms": tl.attribution(),
                                       "dominant": tl.dominant_kind(),
                                       "timelines": len(tls),
                                       "with_orphans": sum(1 for t in tls.values()
                                                           if t.orphans)}
            else:
                srv.close()
                outcomes = row["outcomes"] or {}
                row.update(deadline_ms=deadline_ms, wave_s=wave_s)
                check(outcomes.get("shed", 0) > 0 and outcomes.get("expired", 0) > 0,
                      f"serve_layer_load (b): outcomes {outcomes}: the overload must shed "
                      f"and expire")
            emit({"phase": "serve_layer_load", "run": run, "model": "gpt2-125m",
                  "slots": SERVE_SLOTS, "cache_len": SERVE_CACHE,
                  "tokens_per_tick": SERVE_BURST, **row, "card": card})
            del srv, eng
    torch.cuda.empty_cache()

    # ---- serve_layer_chaos ---------------------------------------------
    chaos_queue = queue[:16]
    plan_faults = (("dispatch_error", 3), ("fetch_hang", 6), ("preempt", 10))
    chaos_rows = []
    for depth in (0, 1):
        outs = {}
        for faulted in (False, True):
            eng = build(pipeline_depth=depth)
            kw = {}
            injector = None
            if faulted:
                injector = FaultInjector(FaultPlan([Fault(tick=t, kind=k)
                                                    for k, t in plan_faults]))
                eng.fault_hook = injector
                kw = dict(engine_factory=lambda mesh_shape=None: build(pipeline_depth=depth),
                          recovery=RecoveryConfig())
            srv = ServingEngine(eng, clock=time.perf_counter, pipeline_depth=depth, **kw)

            def run_ticks(srv=srv):
                """Submit when due, one step a tick; a request shed while
                the breaker is open ("recovering") is submitted again on
                the next tick, as a client honouring the verdict would."""
                t0 = time.perf_counter()
                step, pending, rid_of, resubmits = 0, list(range(len(chaos_queue))), {}, 0
                while pending or srv.has_work():
                    for i in [i for i in pending if chaos_queue[i][0] <= step]:
                        adm = srv.submit(chaos_queue[i][1], max_new_tokens=chaos_queue[i][2])
                        if adm:
                            rid_of[i] = adm.rid
                        else:
                            check(adm.reason == "recovering",
                                  f"serve_layer_chaos: request {i} shed ({adm.reason})")
                            resubmits += 1
                    pending = [i for i in pending if i not in rid_of]
                    srv.step()
                    step += 1
                torch.cuda.synchronize()
                return rid_of, t0, time.perf_counter() - t0, step, resubmits

            rid_of, t0, wall, steps, resubmits = drive(counts, run_ticks)
            done = srv.reap()
            records = []
            for i in range(len(chaos_queue)):
                req = done.get(rid_of.get(i))
                records.append({"state": req.state if req else None,
                                "tokens": len(req.tokens) if req else 0,
                                "generated": list(req.tokens) if req else [],
                                "recoveries": req.recoveries if req else 0,
                                "finish_s": (req.finish_t - t0) if req and req.finish_t
                                else None})
            outs[faulted] = (records, wall, steps, srv.recovery_stats(), injector, resubmits)
            srv.close()
            del srv, eng
        free, chaos = outs[False][0], outs[True][0]
        records, wall, steps, stats, injector, resubmits = outs[True]
        states = [r["state"] for r in records]
        check(states == ["finished"] * len(chaos_queue) == [r["state"] for r in free],
              f"serve_layer_chaos depth {depth}: states {states}")
        check(stats["lost_requests"] == 0 and stats["rebuilds"] == 2 and stats["retries"] == 1
              and injector.pending() == 0 and not stats["breaker_open"],
              f"serve_layer_chaos depth {depth}: recovery_stats {stats}, "
              f"{injector.pending()} planned faults unfired")
        agree = []
        for i, (a, b) in enumerate(zip(chaos, free)):
            if a["state"] != "finished" or b["state"] != "finished":
                continue
            prompt = chaos_queue[i][1]
            got = np.concatenate([prompt, np.asarray(a["generated"], np.int32)])
            want = np.concatenate([prompt, np.asarray(b["generated"], np.int32)])

            def m(want=want, prompt=prompt):
                return margins_along(prompt, torch.from_numpy(want[prompt.size:]).cuda())

            agree.append(stream_agreement(got, want, prompt, m,
                                          f"serve_layer_chaos depth {depth}"))
        card_records = [{k: r[k] for k in ("state", "tokens", "recoveries", "finish_s")}
                        for r in records]
        score = loadgen.chaos_scorecard(card_records, wall, stats, injected=injector.fired)
        # the scorecard's goodput dip is left out: 16 completions in two
        # waves leave empty bins in the fault-free run too (it read 1.0
        # with and without faults), so the outage is read from
        # recovery_stats (outage_ms_total, lost_ticks) instead
        row = {"pipeline_depth": depth, "requests": len(chaos_queue), "steps": steps,
               "wall_s": wall, "fault_free_wall_s": outs[False][1],
               "plan": [{"tick": t, "kind": k} for k, t in plan_faults],
               "finished": states.count("finished"),
               "resubmitted_while_recovering": resubmits,
               "conservation": len(states) == sum(states.count(s) for s in (
                   "finished", "shed", "expired", "cancelled")),
               "recovered_requests": score["recovered_requests"],
               "bit_equal_to_fault_free": sum(e["equal"] for e in agree),
               "differing": [e for e in agree if not e["equal"]],
               "recovery_stats": stats}
        chaos_rows.append(row)
        emit({"phase": "serve_layer_chaos", "model": "gpt2-125m", "slots": SERVE_SLOTS,
              "cache_len": SERVE_CACHE, "tokens_per_tick": SERVE_BURST, **row, "card": card})
        torch.cuda.empty_cache()
    check(counts.get("fused_norm_fwd", 0) > 0 and counts.get("flash_fwd", 0) == 0
          and counts.get("fused_norm_bwd", 0) == 0,
          f"serve_layer: K7/K1/K8 launched {counts.get('fused_norm_fwd', 0)}/"
          f"{counts.get('flash_fwd', 0)}/{counts.get('fused_norm_bwd', 0)} times, "
          f"expected >0/0/0")
    return counts


def serve_fleet_phase(card):
    """The serving fleet (``deepspeed_tpu_torch.serving``: ``FleetRouter``
    over ``ServingEngine`` replicas, failover by migration, drain and
    rolling restart, the autoscaler, the scenarios, the loadgen's fleet
    runner ``build_fleet``/``fleet_run``) on the serving tick's GPT-2 125M
    build (``ServingBuild``, seed-0 weights: bf16, 8 slots of cache 256,
    bursts of 4, depth 1, fifo; every replica warmed at its build). Every
    replica shares one card, one host thread and one hub (registry only),
    with the fleet's ops server live. Each driven run is counted from 0 (K7
    only: vector positions keep K1 off, no K8); each run's K7 launches,
    engine ticks (over every replica it held), host ms a tick and wall;
    for the sweep's two runs also, from one profiled replay of the
    schedule's first 4 requests through the same router, the device ms and
    launches a tick and the idle share of the run's wall (a profile costs
    ~15 s of the phase, so the other runs have none).

    - (a) ``serve_fleet`` a_replay: ``serve_pool``'s 32-request schedule
      through a 1-replica fleet and a bare ``ServingEngine``, in turns
      (bare, fleet, fleet, bare): the fleet's tokens/s over the bare
      layer's, and every stream and engine rid equal, bit for bit (slot 0's
      rid base is 0). a_sweep_1, a_sweep_2: ``synth_workload(48, seed=0,
      prompts 32-128, 64 new)`` at Poisson 4 req/s through 1 and 2
      replicas (the loadgen's ``--replicas 1,2``), ``fleet_record``.
    - (b) b_kill: the same at 2 replicas; at the first tick from 20 on
      where the lowest healthy replica runs streams it is killed, and a
      replacement joins 5 ticks later. lost 0, migrated > 0, conservation;
      every migrated stream against a_sweep_2's under the bf16 tie rule,
      the count bit for bit, the replacement's build ms, TTFT/TBT beside
      a_sweep_2's.
    - (c) c_rolling: ``scenarios/rolling_under_load.jsonl`` at 2 replicas:
      nothing lost, each replica replaced once (r0, r1 drained; r2, r3
      healthy); ``/healthz``, ``/statusz`` and ``/metrics`` scraped from
      another thread mid-run (checked after ``join()``).
    - (d) d_fixed_1, d_fixed_2, d_autoscale: ``scenarios/
      burst_frontend.jsonl`` at 1 and 2 fixed replicas and with the
      autoscaler (1:2, from 1): goodput and SLO goodput (deadline-met
      tokens) a replica, the autoscaler's ``stats()``.

    Returns the K7/K1/K8 launch counts of the driven runs."""
    import threading
    import urllib.request

    import numpy as np

    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.serving import Scenario, ServingEngine, loadgen, scenario_scorecard

    sb = ServingBuild(torch.Generator(device="cuda").manual_seed(0))
    model, queue = sb.model, sb.queue
    vocab = model.cfg.vocab_size
    solo_eng = sb.engine(warm=False)._eng
    scen_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenarios")
    counts, builds_ms = {}, []
    t_phase = time.perf_counter()

    def make_engine(first):
        """A replica's batching engine, warmed; the first of a fleet
        carries the run's hub (registry only, for the ops server)."""
        t0 = time.perf_counter()
        eng = sb.engine({"telemetry": {"enabled": True, "trace_file": ""}} if first else None)
        builds_ms.append((time.perf_counter() - t0) * 1e3)
        return eng

    def fleet(n, **serving_kw):
        router = loadgen.build_fleet(make_engine, n, serving_kw={"policy": "fifo", **serving_kw})
        router.start_ops_server(port=0)
        return router

    def device_row(router, ticks, wall_s, what):
        """Device ms and launches a tick from a profiled replay of the
        schedule's first requests through ``router``; the idle share of a
        run of ``ticks`` engine ticks in ``wall_s``."""
        prof = profiled_replay(router, queue, 1, {"ticks": ticks, "wall_s": wall_s}, what,
                               window=PROFILED_REQUESTS)
        return {k: prof[k] for k in ("device_ms_per_tick", "launches_per_tick",
                                     "device_idle_share")}

    def run_row(router, summary, records, k7):
        """A run's row: the loadgen's scorecard and the run's counts."""
        host = summary.get("host") or {}
        fl = summary["fleet"]
        lost = [i for i, r in enumerate(records)
                if r.get("rid") is not None and r.get("state") not in (
                    "finished", "shed", "expired", "cancelled")]
        row = {k: summary.get(k) for k in (
            "requests", "outcomes", "wall_s", "offered_rps", "throughput_tok_s",
            "goodput_tok_s", "shed_rate", "deadline_met_frac", "ttft_ms", "tbt_ms",
            "queue_ms")}
        slo_good = sum(r.get("tokens", 0) for r in records if r.get("deadline_met") is True)
        row.update(slo_goodput_tok_s=slo_good / summary["wall_s"],
                   ticks=fleet_tick_stats(router)["ticks"],
                   tick_dispatch_ms_mean=host.get("tick_dispatch_ms_mean"),
                   tick_block_ms_mean=host.get("tick_block_ms_mean"), k7_launches=k7,
                   unterminated=lost,
                   fleet={k: fl[k] for k in ("submitted", "admitted", "shed", "spillovers",
                                             "migrated", "lost", "replica_deaths",
                                             "conservation_ok")},
                   replicas={rid: {k: info[k] for k in ("state", "admitted", "migrated_in",
                                                         "migrated_out")}
                             for rid, info in fl["replicas"].items()})
        return row

    def one_run(what, n, workload, arrivals, seed=0, before=None, profiled=False, **run_kw):
        """Build an n-replica fleet, drive one open-loop run through the
        loadgen's fleet runner (then, if ``profiled``, a profiled replay),
        close it."""
        router = fleet(n)
        extra = before(router) if before is not None else None
        summary, records = drive(counts, lambda: loadgen.fleet_run(
            router, workload, arrivals, seed=seed, **run_kw))
        k7 = op_builder.launch_counts()["fused_norm_fwd"]
        row = run_row(router, summary, records, k7)
        if profiled:
            row.update(device_row(router, row["ticks"], row["wall_s"], f"serve_fleet {what}"))
        check(not row["unterminated"] and row["fleet"]["lost"] == 0
              and row["fleet"]["conservation_ok"] and k7 > 0,
              f"serve_fleet {what}: requests {row['unterminated']} unterminated, fleet "
              f"{row['fleet']}, K7 {k7}")
        router.close()
        return row, summary, records, extra

    # ---- (a) the 1-replica fleet against the bare layer, replayed --------
    budget = {"kv_budget_tokens": 1 << 20}  # the whole schedule fits: nothing sheds
    targets = {"bare": ServingEngine(sb.engine(), policy="fifo", **budget),
               "fleet": fleet(1, **budget)}
    replays = {}
    for run in ("bare", "fleet", "fleet", "bare"):
        front = ScheduleFront(targets[run])
        row, got = drive(counts, lambda: replay_schedule(targets[run], queue, 1, front=front))
        row["k7_launches"] = op_builder.launch_counts()["fused_norm_fwd"]
        erids = [front.engine_rids.get(front.rid_of.get(i)) for i in range(len(queue))]
        replays.setdefault(run, []).append((row, got, erids))
    same = [all(a is not None and b is not None and np.array_equal(a, b)
                for a, b in zip(f[1], b[1]))
            for f, b in zip(replays["fleet"], replays["bare"])]
    rids_same = [f[2] == b[2] and None not in f[2]
                 for f, b in zip(replays["fleet"], replays["bare"])]
    check(all(same) and all(rids_same),
          f"serve_fleet a_replay: fleet streams equal the bare layer's {same}, engine rids "
          f"{rids_same}")
    tps = {run: statistics.mean(r[0]["tokens_per_s"] for r in reps)
           for run, reps in replays.items()}
    emit({"phase": "serve_fleet", "run": "a_replay", "replicas": 1, "requests": len(queue),
          "order": "bare, fleet, fleet, bare",
          "tokens_per_s": {run: [r[0]["tokens_per_s"] for r in reps]
                           for run, reps in replays.items()},
          "fleet_over_bare_tokens_per_s": tps["fleet"] / tps["bare"],
          "ticks": {run: [r[0]["ticks"] for r in reps] for run, reps in replays.items()},
          "k7_launches": {run: [r[0]["k7_launches"] for r in reps]
                          for run, reps in replays.items()},
          "streams_equal": same, "engine_rids_equal": rids_same,
          "wall_s": {run: [r[0]["wall_s"] for r in reps] for run, reps in replays.items()},
          "tick_dispatch_ms_per_tick": {
              run: [r[0]["tick_dispatch_ms"] / max(r[0]["ticks"], 1) for r in reps]
              for run, reps in replays.items()},
          "tick_block_ms_per_tick": {
              run: [r[0]["tick_block_ms"] / max(r[0]["ticks"], 1) for r in reps]
              for run, reps in replays.items()}, "card": card})
    targets["bare"].close()
    targets["fleet"].close()
    del targets, replays
    torch.cuda.empty_cache()

    # ---- (a) the --replicas 1,2 sweep, open loop ---------------------------
    workload = loadgen.synth_workload(48, seed=0, prompt_range=(32, 128), new_range=(64, 64))
    arrivals = loadgen.gen_arrivals(len(workload), 4.0, "poisson", seed=0)
    results, sweep = {}, {}
    for n in (1, 2):
        row, summary, records, _ = one_run(f"a_sweep_{n}", n, workload, arrivals,
                                           profiled=True)
        results[str(n)], sweep[n] = summary, (row, records)
        emit({"phase": "serve_fleet", "run": f"a_sweep_{n}", "replicas": n,
              "rate_rps": 4.0, "process": "poisson", **row, "card": card})
    record = loadgen.fleet_record(results, {
        "requests": len(workload), "rate": 4.0, "process": "poisson", "seed": 0,
        "pipeline_depth": 1, "slots": SERVE_SLOTS, "cache_len": SERVE_CACHE,
        "deadline_ms": None, "preset": "gpt2-125m", "kill_replica": None,
        "rolling_restart": None, "rate_curve": None, "scenario": None, "autoscale": None},
        device="cuda")
    r1, r2 = sweep[1][0], sweep[2][0]
    emit({"phase": "serve_fleet", "run": "a_fleet_record", "kind": record["kind"],
          "device_kind": record["device_kind"], "replicas": record["replicas"],
          "curves": record["curves"],
          "two_over_one_tokens_per_s": r2["throughput_tok_s"] / r1["throughput_tok_s"],
          "two_over_one_tbt_p50": r2["tbt_ms"]["p50"] / r1["tbt_ms"]["p50"],
          "card": card})
    torch.cuda.empty_cache()

    # ---- (b) kill a replica holding running streams, restore it ----------
    chaos = {}

    def arm_kill(router):
        def maybe_kill(r):
            if "tick" in chaos:
                return
            st = r.statusz()
            if st["tick"] < 20:
                return
            victim = next((rid for rid in r.replica_ids()
                           if st["replicas"][rid]["state"] == "healthy"), None)
            running = st["replicas"][victim]["statusz"]["residue_running"] if victim else 0
            if not running:
                return
            chaos.update(tick=st["tick"], victim=victim, running=running)
            r.kill(victim, detail="serve_fleet kill")

            def restore(rr):
                t0 = time.perf_counter()
                chaos["replacement"] = rr.add()
                chaos["replacement_build_ms"] = (time.perf_counter() - t0) * 1e3

            r.at_tick(st["tick"] + 5, restore)

        router.on_step(maybe_kill)

    row, summary, records, _ = one_run("b_kill", 2, workload, arrivals, before=arm_kill)
    free_records = sweep[2][1]
    agree = []
    margins = {}
    for i, (got_r, free_r) in enumerate(zip(records, free_records)):
        if not got_r.get("recoveries") or got_r.get("state") != "finished" \
                or free_r.get("state") != "finished":
            continue
        prompt = loadgen._item_prompt(workload[i], i, 0, vocab)
        got = np.concatenate([prompt, np.asarray(got_r["generated"], np.int32)])
        want = np.concatenate([prompt, np.asarray(free_r["generated"], np.int32)])

        def m(i=i, want=want, prompt=prompt):
            if i not in margins:
                margins[i] = top2_margins(teacher_forced_logits(
                    solo_eng.params, solo_eng.cfg, solo_eng._tight_floor(), prompt,
                    torch.from_numpy(want[prompt.size:]).cuda()))
            return margins[i]

        agree.append(stream_agreement(got, want, prompt, m, "serve_fleet b_kill"))
    all_equal = sum(1 for a, b in zip(records, free_records)
                    if a.get("generated") is not None and a.get("generated") == b.get("generated"))
    score = loadgen.chaos_scorecard(records, summary["wall_s"], {})
    check("replacement" in chaos and row["fleet"]["migrated"] > 0 and agree
          and row["fleet"]["replica_deaths"] == 1,
          f"serve_fleet b_kill: kill {chaos}, fleet {row['fleet']}, {len(agree)} migrated "
          f"streams compared")
    emit({"phase": "serve_fleet", "run": "b_kill", "replicas": 2, "kill": chaos, **row,
          "migrated_streams": len(agree),
          "migrated_bit_equal": sum(e["equal"] for e in agree),
          "migrated_differing": [e for e in agree if not e["equal"]],
          "all_streams_bit_equal_to_fault_free": all_equal,
          "goodput_dip": score.get("goodput_dip"),
          "fault_free": {k: r2[k] for k in ("ttft_ms", "tbt_ms", "throughput_tok_s")},
          "card": card})
    torch.cuda.empty_cache()

    # ---- (c) rolling restart under load, the ops plane scraped mid-run ----
    sc = Scenario.load(os.path.join(scen_dir, "rolling_under_load.jsonl"))
    workload_c, arrivals_c = sc.compile()
    mid = {}

    def arm_scrape(router):
        ops = router._ops_server

        def scrape_mid():
            """The scrape taken while the run is under way, from another
            thread: its result or its error, and when it ended."""
            try:
                out = {}
                for path in ("/healthz", "/statusz", "/metrics"):
                    with urllib.request.urlopen(ops.url + path, timeout=10) as r:
                        out[path] = (r.status, r.read().decode())
                mid["scrape"] = out
            except Exception as e:  # noqa: BLE001 - checked after join()
                mid["error"] = repr(e)
            mid["done_s"] = time.perf_counter()

        timer = threading.Timer(arrivals_c[len(arrivals_c) // 2], scrape_mid)
        timer.start()
        return timer

    row, summary, records, timer = one_run("c_rolling", 2, workload_c, arrivals_c,
                                           seed=sc.seed, before=arm_scrape, scenario=sc)
    run_end_s = time.perf_counter()
    timer.join()
    states = {rid: info["state"] for rid, info in row["replicas"].items()}
    scrape = mid.get("scrape") or {}
    status = json.loads(scrape["/statusz"][1]) if "/statusz" in scrape else {}
    check("scrape" in mid and mid["done_s"] < run_end_s
          and all(v[0] == 200 for v in scrape.values())
          and any(line.startswith("fleet_admitted_total") for line in
                  scrape["/metrics"][1].splitlines()),
          f"serve_fleet c_rolling: the mid-run scrape {mid.get('error') or sorted(scrape)}")
    check(states == {"r0": "drained", "r1": "drained", "r2": "healthy", "r3": "healthy"}
          and row["fleet"]["replica_deaths"] == 0 and row["fleet"]["migrated"] == 0,
          f"serve_fleet c_rolling: replica states {states}, fleet {row['fleet']}")
    emit({"phase": "serve_fleet", "run": "c_rolling", "scenario": sc.name, **row,
          "scorecard": scenario_scorecard(sc, summary),
          "mid_run_scrape": {"statuses": {k: v[0] for k, v in scrape.items()},
                             "health": json.loads(scrape["/healthz"][1]) if scrape else None,
                             "statusz_placeable": status.get("placeable"),
                             "statusz_rolling_restart": status.get("rolling_restart"),
                             "metric_lines": len(scrape["/metrics"][1].splitlines())
                             if scrape else 0,
                             "ended_s_before_run_end": run_end_s - mid.get("done_s", run_end_s),
                             "error": mid.get("error")},
          "card": card})
    torch.cuda.empty_cache()

    # ---- (d) burst_frontend: fixed 1, fixed 2, autoscaled 1:2 ---------------
    sc = Scenario.load(os.path.join(scen_dir, "burst_frontend.jsonl"))
    workload_d, arrivals_d = sc.compile()
    for what, n, autoscale in (("d_fixed_1", 1, None), ("d_fixed_2", 2, None),
                               ("d_autoscale", 1, (1, 2))):
        row, summary, records, _ = one_run(what, n, workload_d, arrivals_d, seed=sc.seed,
                                           scenario=sc, autoscale=autoscale)
        scaler = summary.get("autoscaler")
        mean_replicas = scaler["mean_replicas"] if scaler else float(n)
        emit({"phase": "serve_fleet", "run": what, "scenario": sc.name, **row,
              "autoscaler": scaler, "mean_replicas": mean_replicas,
              "goodput_per_replica": row["goodput_tok_s"] / mean_replicas,
              "slo_goodput_per_replica": row["slo_goodput_tok_s"] / mean_replicas,
              "card": card})
        torch.cuda.empty_cache()
    check(counts.get("fused_norm_fwd", 0) > 0 and counts.get("flash_fwd", 0) == 0
          and counts.get("fused_norm_bwd", 0) == 0,
          f"serve_fleet: K7/K1/K8 launched {counts.get('fused_norm_fwd', 0)}/"
          f"{counts.get('flash_fwd', 0)}/{counts.get('fused_norm_bwd', 0)} times, "
          f"expected >0/0/0")
    emit({"phase": "serve_fleet_summary", "replica_builds_ms": builds_ms,
          "phase_s": time.perf_counter() - t_phase, "k7_launches": counts.get("fused_norm_fwd", 0),
          "card": card})
    return counts


# Mistral 7B v0.1's published shape (mistralai/Mistral-7B-v0.1 config.json:
# hidden 4096, 32 layers, 32 heads with 8 kv heads, intermediate 14336, vocab
# 32000, sliding_window 4096, rope_theta 10000, rms_norm_eps 1e-5, 32768
# positions, untied head), mapped as the reference's LlamaPolicy.config maps
# an HF Mistral config (deepspeed_tpu/module_inject/policies.py:191-222)
MISTRAL_7B = dict(vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
                  num_kv_heads=8, ffn_hidden_size=14336, max_seq_len=32768,
                  pos_embedding="rope", norm_type="rmsnorm", activation="silu_glu",
                  tie_embeddings=False, use_bias=False, norm_eps=1e-5, rope_theta=10000.0,
                  attn_impl="pallas", local_attn_windows=(4096,) * 32)

# Llama 2 7B's published config.json (meta-llama/Llama-2-7b-hf), the file
# hf_load_llama writes beside its shards: LlamaPolicy maps it onto the
# llama2-7b preset that llama_serve builds
LLAMA2_7B_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "bos_token_id": 1, "eos_token_id": 2,
    "hidden_act": "silu", "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 11008, "max_position_embeddings": 4096, "model_type": "llama",
    "num_attention_heads": 32, "num_hidden_layers": 32, "num_key_value_heads": 32,
    "pretraining_tp": 1, "rms_norm_eps": 1e-05, "rope_scaling": None,
    "tie_word_embeddings": False, "torch_dtype": "float16", "use_cache": True,
    "vocab_size": 32000,
}
# GPT-2 350M (the decode bench's model, gpt2-350m) as a GPT2LMHeadModel
# config.json, for hf_load_gpt2's saved checkpoint
GPT2_350M_CONFIG = {
    "architectures": ["GPT2LMHeadModel"], "model_type": "gpt2", "vocab_size": 50257,
    "n_embd": 1024, "n_layer": 24, "n_head": 16, "n_positions": 1024,
    "layer_norm_epsilon": 1e-05, "activation_function": "gelu_new",
}

# the decoder families the policies convert, each at its published
# config.json values (typed in: the card's machine has no transformers), read
# by the port's config reader (module_inject/load_checkpoint.HFConfig);
# "variant" names what each family drives that the others do not
HF_FAMILIES = {
    "bigscience/bloom-560m": {"variant": "ALiBi, embed_norm, vocab 250880", "config": {
        "apply_residual_connection_post_layernorm": False, "architectures": ["BloomForCausalLM"],
        "attention_dropout": 0.0, "attention_softmax_in_fp32": True, "bos_token_id": 1,
        "eos_token_id": 2, "hidden_dropout": 0.0, "hidden_size": 1024,
        "initializer_range": 0.02, "layer_norm_epsilon": 1e-05, "model_type": "bloom",
        "n_head": 16, "n_inner": None, "n_layer": 24, "offset_alibi": 100, "pad_token_id": 3,
        "pretraining_tp": 1, "slow_but_exact": False, "unk_token_id": 0, "use_cache": True,
        "vocab_size": 250880}},
    "EleutherAI/pythia-410m": {"variant": "parallel residual, rotary_pct 0.25, untied head",
                               "config": {
        "architectures": ["GPTNeoXForCausalLM"], "bos_token_id": 0, "eos_token_id": 0,
        "hidden_act": "gelu", "hidden_size": 1024, "initializer_range": 0.02,
        "intermediate_size": 4096, "layer_norm_eps": 1e-05, "max_position_embeddings": 2048,
        "model_type": "gpt_neox", "num_attention_heads": 16, "num_hidden_layers": 24,
        "rotary_emb_base": 10000, "rotary_pct": 0.25, "tie_word_embeddings": False,
        "use_cache": True, "use_parallel_residual": True, "vocab_size": 50304}},
    "EleutherAI/gpt-j-6b": {"variant": "shared LN, interleaved rotary 64 of head dim 256, "
                                       "biased head", "config": {
        "activation_function": "gelu_new", "architectures": ["GPTJForCausalLM"],
        "attn_pdrop": 0.0, "bos_token_id": 50256, "embd_pdrop": 0.0, "eos_token_id": 50256,
        "initializer_range": 0.02, "layer_norm_epsilon": 1e-05, "model_type": "gptj",
        "n_embd": 4096, "n_head": 16, "n_inner": None, "n_layer": 28, "n_positions": 2048,
        "resid_pdrop": 0.0, "rotary": True, "rotary_dim": 64, "scale_attn_weights": True,
        "tie_word_embeddings": False, "use_cache": True, "vocab_size": 50400}},
    "facebook/opt-125m": {"variant": "ReLU, pre-LN", "config": {
        "activation_dropout": 0.0, "activation_function": "relu",
        "architectures": ["OPTForCausalLM"], "attention_dropout": 0.0, "bos_token_id": 2,
        "do_layer_norm_before": True, "dropout": 0.1, "eos_token_id": 2, "ffn_dim": 3072,
        "hidden_size": 768, "init_std": 0.02, "layerdrop": 0.0,
        "max_position_embeddings": 2048, "model_type": "opt", "num_attention_heads": 12,
        "num_hidden_layers": 12, "pad_token_id": 1, "use_cache": True, "vocab_size": 50272,
        "word_embed_proj_dim": 768}},
    "EleutherAI/gpt-neo-125M": {"variant": "per-layer windows 256, attn_scale 1.0", "config": {
        "activation_function": "gelu_new", "architectures": ["GPTNeoForCausalLM"],
        "attention_dropout": 0, "attention_layers": ["global", "local"] * 6,
        "attention_types": [[["global", "local"], 6]], "bos_token_id": 50256,
        "embed_dropout": 0, "eos_token_id": 50256, "hidden_size": 768,
        "initializer_range": 0.02, "intermediate_size": None, "layer_norm_epsilon": 1e-05,
        "max_position_embeddings": 2048, "model_type": "gpt_neo", "num_heads": 12,
        "num_layers": 12, "resid_dropout": 0, "use_cache": True, "vocab_size": 50257,
        "window_size": 256}},
}
# OPT-125m's widths as a post-LN model (OPT-350m itself, the published
# post-LN OPT, projects its 512-wide embeddings in and out, which the policy
# refuses as the reference's does)
HF_FAMILIES["facebook/opt-125m, do_layer_norm_before=False (post-LN variant)"] = {
    "variant": "post-LN", "config": dict(HF_FAMILIES["facebook/opt-125m"]["config"],
                                         do_layer_norm_before=False)}


@contextlib.contextmanager
def recorded_walk(eng):
    """The allocation walk of ``eng``'s requests inside the block: the cache
    length each request's ``init_cache`` allocates, then each migration's."""
    from deepspeed_tpu_torch.models import transformer as tf

    walk, real_init, real_grow = [], tf.init_cache, eng._grow_cache

    def init_cache(cfg, batch_size, max_len=None, *args, **kw):
        walk.append(max_len)
        return real_init(cfg, batch_size, max_len, *args, **kw)

    def grow(cache, new_len):
        walk.append(new_len)
        return real_grow(cache, new_len)

    tf.init_cache, eng._grow_cache = init_cache, grow
    try:
        yield walk
    finally:
        tf.init_cache = real_init
        del eng._grow_cache


def alloc_walk_rule(S, new, max_len, floor):
    """The reference's allocation walk of the per-token loop
    (``deepspeed_tpu/inference/engine.py:620-658``): ``read_bucket(S + 1)``,
    then ``read_bucket(pos + 1)`` whenever a decode write at pos (S to
    S + new - 2) reaches the allocation; tight reads off keep ``max_len``."""
    from deepspeed_tpu_torch.inference.decoding import read_bucket

    if floor is None:
        return [max_len]
    walk = [min(read_bucket(S + 1, max_len, floor), max_len)]
    for pos in range(S, S + new - 1):
        if pos + 1 > walk[-1]:
            walk.append(min(read_bucket(pos + 1, max_len, floor), max_len))
    return walk


def timed_generate(eng, toks, new):
    """(tokens, wall s, launch counts) of one greedy ``generate``."""
    from deepspeed_tpu_torch.ops import op_builder

    before = op_builder.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(toks, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = op_builder.launch_counts()
    return out, wall, {k: after[k] - before.get(k, 0) for k in after}


def teacher_forced_check(params, cfg, out, prompt, what):
    """The generated tokens against the uncached ``forward`` over the same
    sequence (teacher-forced): every token is the forward's argmax at its
    position, or that position's top-2 margin is under 2 LOGITS_TOL (the
    bf16 tie rule). Returns the counts and the widest margin of a
    mismatch."""
    from deepspeed_tpu_torch.models import transformer as tf

    with torch.inference_mode():
        logits = tf.forward(params, cfg, out[:, :-1].long())[:, prompt - 1:].float()
    want = logits.argmax(-1)
    got = out[:, prompt:].long()
    margins = top2_margins(logits).to(got.device)
    miss = want != got
    worst = float(margins[miss].max()) if bool(miss.any()) else 0.0
    check(worst < 2 * LOGITS_TOL,
          f"{what}: a generated token differs from the teacher-forced forward's argmax at a "
          f"top-2 margin of {worst} >= {2 * LOGITS_TOL}")
    return {"tokens": int(got.numel()), "equal_to_forward_argmax": int((~miss).sum()),
            "widest_mismatch_margin": worst, "tie_margin": 2 * LOGITS_TOL}


def decode_step_profile(eng, toks, short=4, long=12):
    """A decode step of greedy ``generate`` at toks' shape: wall ms from one
    unprofiled call of each length, device ms, launches and device ms by
    kernel category from one profiled call of each (raw profiler events),
    as (long - short) / (long - short tokens); the idle share."""
    from torch.profiler import ProfilerActivity, profile

    generate_wall(eng, toks, short)  # warm-up at this shape
    wall = {n: generate_wall(eng, toks, n)[0] for n in (short, long)}
    kernels = {}
    for n in (short, long):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            eng.generate(toks, max_new_tokens=n)
            torch.cuda.synchronize()
        kernels[n] = device_kernels(prof)
    steps = long - short
    measured = bool(kernels[short] and kernels[long])
    dev = {n: sum(t for _, t, _ in k) for n, k in kernels.items()}
    launches = {n: sum(c for _, _, c in k) for n, k in kernels.items()}
    cats = {n: by_category(k) for n, k in kernels.items()}
    wall_ms = (wall[long] - wall[short]) / steps * 1e3
    device_ms = (dev[long] - dev[short]) / steps * 1e3
    by_cat = {c: (v["device_s"] - cats[short].get(c, {"device_s": 0.0})["device_s"])
              / steps * 1e3 for c, v in cats[long].items()}
    short_by_name = {name: (t, c) for name, t, c in kernels[short]}
    per_kernel = sorted(((name, (t - short_by_name.get(name, (0.0, 0))[0]) / steps * 1e3,
                          (c - short_by_name.get(name, (0.0, 0))[1]) / steps)
                         for name, t, c in kernels[long]), key=lambda x: -x[1])
    return {"wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms if measured else "not measured",
            "device_idle_share_per_step": 1 - device_ms / wall_ms if measured
            else "not measured",
            "launches_per_step": (launches[long] - launches[short]) / steps,
            "device_ms_per_step_by_category": by_cat if measured else "not measured",
            "top_kernels_per_step": [{"name": name[:100], "ms": ms, "launches": n}
                                     for name, ms, n in per_kernel[:10]]}


def step_launches(eng, toks, short=4, long=12):
    """{kernel name: launches} of a decode step of greedy ``generate`` at
    toks' shape, as (long - short) / (long - short tokens), or None where the
    profile lost a marker. One profile holds a call of ``short`` tokens, then
    a marker kernel (an int16 fill, which ``generate`` never launches), a
    call of each length and a marker after each, all on the card's stream
    with a synchronize between: the kernels between two markers are the
    call's. A profile now and then misses kernels at its start, which moved
    a reading taken from a profile of each call alone by whole launches a
    step: here such a loss falls on the first call, which counts for
    nothing. The markers split the kernels by the card's own order, where
    ``record_function`` ranges on the host's clock now and then put a call's
    first kernels in the wrong range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def mark():
        torch.cuda.synchronize()
        torch.full((1,), 1, dtype=torch.int16, device="cuda")

    generate_wall(eng, toks, short)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.generate(toks, max_new_tokens=short)
        for n in (short, long):
            mark()
            eng.generate(toks, max_new_tokens=n)
        mark()
        torch.cuda.synchronize()
    names = [e.name() for e in sorted(
        (e for e in prof.profiler.kineto_results.events()
         if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
         and e.duration_ns() > 0), key=lambda e: e.start_ns())]
    marks = [i for i, name in enumerate(names) if "FillFunctor<short>" in name]
    if len(marks) != 3:
        return None
    counts = [{}, {}]
    for c, lo, hi in zip(counts, marks, marks[1:]):
        for name in names[lo + 1:hi]:
            c[name] = c.get(name, 0) + 1
    per_step = {k: (counts[1].get(k, 0) - counts[0].get(k, 0)) / (long - short)
                for k in set(counts[0]) | set(counts[1])}
    return {k: v for k, v in per_step.items() if v}


def llama_serve_phase(gen, card):
    """Llama 2 7B serving (the repo's ``llama2-7b`` preset at full width and
    depth: 32 layers, D 4096, 32 heads of 128, SwiGLU 11008, vocab 32000,
    untied head, no biases; bf16, random weights from the engine's seeded
    CUDA generator, ``attn_impl="pallas"``): B 8 x 512 + 64 greedy through
    ``init_inference`` -> ``generate``, fused and per-token with bucket
    migration (``fused_generate: false``, the default floor), and a B 8 x 100
    + 60 request whose per-token cache migrates 128 -> 256. Checks: the two
    paths' streams equal, the allocation walk equals the reference's rule,
    the stream against the uncached teacher-forced ``forward`` under the
    bf16 tie rule; K1 once a layer a prefill, K7 2 L + 1 times a forward, K8
    never. Prints the decode step (wall and device ms, launches, idle share,
    device ms by kernel category) beside its bound (the weights' bytes and
    the KV bytes the step's attention needs, over the memory rate), K7 at
    the decode rows (8 x 4096 RMSNorm) against its plain version, and the
    peak device memory. Returns the phase's launch counts, the K7 row and
    what ``hf_load_llama_phase`` takes over: {"engine", "prompt", "fused"
    (the fused stream)}; the engine stays on the card until it frees it."""
    import torch.nn.functional as F

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.decoding import bounded_cache_len
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import fused_norm as fnorm
    from deepspeed_tpu_torch.ops import op_builder

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tf.TransformerModel.from_preset("llama2-7b", dtype="bfloat16", attn_impl="pallas")
    config = {"dtype": "bfloat16", "attn_impl": "pallas"}
    eng = deepspeed_tpu_torch.init_inference(model, config=config, seed=0)
    loop = deepspeed_tpu_torch.init_inference(model, config=dict(config, fused_generate=False),
                                              params=eng.params)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg, V, L = eng.cfg, eng.cfg.vocab_size, eng.cfg.num_layers
    floor = eng.config.kv_read_floor
    B, P, NEW = 8, 512, 64
    toks = torch.randint(0, V, (B, P), generator=gen, device="cuda")
    short = torch.randint(0, V, (B, 100), generator=gen, device="cuda")
    eng.generate(toks[:, :16], max_new_tokens=2)  # warm-up: cuBLAS, kernel load

    op_builder.reset_launch_counts()
    runs = {}
    for name, e, prompt, new in (("fused", eng, toks, NEW), ("per_token", loop, toks, NEW),
                                 ("fused_p100", eng, short, 60),
                                 ("per_token_p100", loop, short, 60)):
        with recorded_walk(e) as walk:
            out, wall, launched = timed_generate(e, prompt, new)
        runs[name] = {"out": out, "wall_s": wall, "launched": launched, "walk": list(walk),
                      "prompt": prompt.shape[1], "new": new}
    counts = op_builder.launch_counts()

    rows = {}
    for name, r in runs.items():
        out, S, new, launched = r["out"], r["prompt"], r["new"], r["launched"]
        check(tuple(out.shape) == (B, S + new) and bool(((out >= 0) & (out < V)).all()),
              f"llama_serve {name}: output shape {tuple(out.shape)} / range")
        check(launched["flash_fwd"] == L and launched["fused_norm_fwd"] == (2 * L + 1) * new
              and launched["fused_norm_bwd"] == 0,
              f"llama_serve {name}: K1/K7/K8 launched {launched['flash_fwd']}/"
              f"{launched['fused_norm_fwd']}/{launched['fused_norm_bwd']}, expected "
              f"{L}/{(2 * L + 1) * new}/0")
        max_len = bounded_cache_len(S + new, cfg.max_seq_len, eng.config.max_out_tokens)
        want_walk = (alloc_walk_rule(S, new, max_len, floor) if name.startswith("per_token")
                     else [max_len])
        check(r["walk"] == want_walk,
              f"llama_serve {name}: allocation walk {r['walk']}, the rule gives {want_walk}")
        rows[name] = {"prompt": S, "new_tokens": new, "generate_s": r["wall_s"],
                      "new_tokens_per_s": B * new / r["wall_s"], "alloc_walk": r["walk"],
                      "alloc_walk_rule": want_walk, "k1_launches": launched["flash_fwd"],
                      "k7_launches": launched["fused_norm_fwd"],
                      "k8_launches": launched["fused_norm_bwd"]}
    for a, b in (("fused", "per_token"), ("fused_p100", "per_token_p100")):
        same = torch.equal(runs[a]["out"], runs[b]["out"])
        rows[b]["equal_to_fused"] = same
        check(same, f"llama_serve: the per-token stream ({b}) differs from the fused one")
    teacher = teacher_forced_check(eng.params, cfg, runs["fused"]["out"], P, "llama_serve")
    handoff = {"engine": eng, "prompt": toks, "fused": runs["fused"]["out"]}
    del runs

    step = decode_step_profile(eng, toks)
    weight_bytes = leaf_bytes(eng.params) - V * cfg.hidden_size * 2 + B * cfg.hidden_size * 2
    # the attention of step j (j = 1 .. NEW - 1) needs P + j cached positions
    # (and its own); the mean over the run's steps
    kv_bytes = B * statistics.mean(tf.kv_read_bytes_per_row(cfg, P + j + 1)
                                   for j in range(1, NEW))
    flops = 2.0 * B * (cfg.num_params() - V * cfg.hidden_size)
    bound_ms, bound_by = bound(flops, weight_bytes + kv_bytes, torch.bfloat16)

    # K7 at the decode step's rows: 8 x 4096 RMSNorm, bf16 scale, no bias
    D = cfg.hidden_size
    x = torch.randn(B, D, generator=gen, device="cuda", dtype=torch.bfloat16)
    scale = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(torch.bfloat16)
    out = fnorm._cuda_fwd(x, scale, None, cfg.norm_eps, True, with_stats=False)[0]
    ref = fnorm._reference_fwd(x, scale, None, cfg.norm_eps, True)[0]
    err = (out.float() - ref.float()).abs().max().item()
    check(err <= NORM_TOL[torch.bfloat16] * max(ref.float().abs().max().item(), 1.0),
          f"llama_serve_k7: K7 at 8 x 4096 differs from its plain version by {err}")
    (k7_bound_ms, k7_bound_by), _ = norm_bounds(B, D, torch.bfloat16, torch.bfloat16, False,
                                                reference_partial_rows(B))
    k7 = {"phase": "llama_serve_k7", "rows": B, "D": D, "dtype": "bfloat16", "kind": "rms",
          "variant": fnorm.kernel_variant(D, x.dtype, x), "max_abs_err": err,
          "ms": cuda_ms(lambda: fnorm._cuda_fwd(x, scale, None, cfg.norm_eps, True,
                                               with_stats=False)),
          "plain_ms": cuda_ms(lambda: fnorm._reference_fwd(x, scale, None, cfg.norm_eps, True)),
          "library_ms": cuda_ms(lambda: F.rms_norm(x, (D,), scale, cfg.norm_eps)),
          "bound_ms": k7_bound_ms, "bound_by": k7_bound_by,
          "launches_per_decode_step": 2 * L + 1, "card": card}
    emit({"phase": "llama_serve", "model": "llama2-7b", "layers": L, "hidden": cfg.hidden_size,
          "heads": cfg.num_heads, "kv_heads": cfg.kv_heads, "head_dim": cfg.head_dim,
          "ffn": cfg.ffn_size, "vocab": V, "params": cfg.num_params(), "batch": B,
          "kv_read_floor": floor, "build_s": build_s, "requests": rows,
          "teacher_forced": teacher,
          "decode_step": {**step, "batch": B, "prompt": P,
                          "k1_launches_per_request": rows["fused"]["k1_launches"],
                          "k7_launches_per_request": rows["fused"]["k7_launches"],
                          "k7_launches_per_step": 2 * L + 1,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "bound_weight_bytes": weight_bytes, "bound_kv_bytes": kv_bytes},
          "peak_memory_bytes": torch.cuda.max_memory_allocated(), "card": card})
    emit(k7)
    del eng, loop, model
    return counts, k7, handoff


def mistral_ring_phase(gen, card):
    """Mistral 7B's published shape (``MISTRAL_7B``; bf16, random weights
    from the engine's seeded CUDA generator): B 1 x 4,608 + 256 greedy
    through ``generate``, with the rolling KV cache on (the engine switches
    it on: a 4,096-slot ring that drops the first 512 positions at the
    prefill) and off (``rolling_kv_cache: false``, a 4,864-slot cache). The
    prefill runs K1's band with GQA group 4 at hd 128 in both. Checks: the
    ring stream against the full cache's under the bf16 tie rule and both
    against the uncached teacher-forced ``forward``; the caches' lengths and
    bytes. Prints both caches' bytes and each decode step's wall and device
    ms, and the peak device memory. Returns the phase's launch counts."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.decoding import bounded_cache_len
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import op_builder

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tf.TransformerModel(tf.TransformerConfig(**MISTRAL_7B, dtype="bfloat16"))
    ring = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bfloat16"}, seed=0)
    full = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "bfloat16", "rolling_kv_cache": False}, params=ring.params)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg, V, L = ring.cfg, ring.cfg.vocab_size, ring.cfg.num_layers
    check(ring.cfg.rolling_kv_cache and not full.cfg.rolling_kv_cache,
          "mistral_ring: the engine did not switch the ring on (or off)")
    B, P, NEW, W = 1, 4608, 256, cfg.uniform_window
    toks = torch.randint(0, V, (B, P), generator=gen, device="cuda")
    ring.generate(toks[:, :16], max_new_tokens=2)  # warm-up

    op_builder.reset_launch_counts()
    runs = {}
    for name, e in (("ring", ring), ("full", full)):
        with recorded_walk(e) as walk:
            out, wall, launched = timed_generate(e, toks, NEW)
        runs[name] = {"out": out, "wall_s": wall, "launched": launched, "cache_len": walk}
    counts = op_builder.launch_counts()

    total = P + NEW
    want_len = {"ring": W, "full": bounded_cache_len(total, cfg.max_seq_len,
                                                     ring.config.max_out_tokens)}
    rows = {}
    for name, r in runs.items():
        out, launched = r["out"], r["launched"]
        check(tuple(out.shape) == (B, total) and bool(((out >= 0) & (out < V)).all()),
              f"mistral_ring {name}: output shape {tuple(out.shape)} / range")
        check(r["cache_len"] == [want_len[name]],
              f"mistral_ring {name}: cache lengths {r['cache_len']}, expected {want_len[name]}")
        check(launched["flash_fwd"] == L and launched["fused_norm_fwd"] == (2 * L + 1) * NEW
              and launched["fused_norm_bwd"] == 0,
              f"mistral_ring {name}: K1/K7/K8 launched {launched['flash_fwd']}/"
              f"{launched['fused_norm_fwd']}/{launched['fused_norm_bwd']}")
        cache_bytes = leaf_bytes(tf.init_cache(cfg, B, want_len[name], device="meta"))
        rows[name] = {"cache_len": r["cache_len"][0], "cache_bytes": cache_bytes,
                      "generate_s": r["wall_s"], "new_tokens_per_s": B * NEW / r["wall_s"],
                      "k1_launches": launched["flash_fwd"],
                      "k7_launches": launched["fused_norm_fwd"],
                      "teacher_forced": teacher_forced_check(
                          ring.params, cfg, out, P, f"mistral_ring {name}")}
    with torch.inference_mode():
        want_logits = tf.forward(ring.params, cfg, runs["full"]["out"][:, :-1].long())
    margins = top2_margins(want_logits[0, P - 1:].float())
    del want_logits
    prompt_np = toks[0].cpu().numpy()
    agree = stream_agreement(runs["ring"]["out"][0].cpu(), runs["full"]["out"][0].cpu(),
                             prompt_np, lambda: margins, "mistral_ring ring vs full")
    del runs
    for name, e in (("ring", ring), ("full", full)):
        rows[name]["decode_step"] = decode_step_profile(e, toks)
    emit({"phase": "mistral_ring", "model": "Mistral-7B-v0.1 shape", "layers": L,
          "hidden": cfg.hidden_size, "heads": cfg.num_heads, "kv_heads": cfg.kv_heads,
          "head_dim": cfg.head_dim, "ffn": cfg.ffn_size, "vocab": V, "window": W,
          "params": cfg.num_params(), "batch": B, "prompt": P, "new_tokens": NEW,
          "build_s": build_s, "runs": rows, "ring_vs_full": agree,
          "cache_bytes_ring_over_full": rows["ring"]["cache_bytes"] / rows["full"]["cache_bytes"],
          "peak_memory_bytes": torch.cuda.max_memory_allocated(), "card": card})
    del ring, full, model
    torch.cuda.empty_cache()
    return counts


def hf_module_order(name):
    """An HF Llama state dict's key order (its modules' order): the
    embedding, then layer by layer, then the final norm and the head."""
    if name.startswith("model.layers."):
        return (1, int(name.split(".")[2]))
    return (0 if "embed_tokens" in name else 2 if name.startswith("model.norm") else 3, 0)


SAFETENSORS_DTYPES = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16",
                      torch.int64: "I64", torch.int32: "I32", torch.int8: "I8",
                      torch.uint8: "U8", torch.bool: "BOOL"}


def write_safetensors(path, tensors):
    """One ``.safetensors`` file of ``tensors`` (name -> tensor, in this
    order, on any device): an 8-byte little-endian header length, the JSON
    header (dtype, shape, data offsets) padded with spaces to 8 bytes, then
    each tensor's bytes, copied to the host one tensor at a time."""
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            host = t.detach().contiguous().cpu()
            f.write(memoryview(host.reshape(-1).view(torch.uint8).numpy()))
    return offset


def write_hf_shards(save_dir, state, config, n_shards=2):
    """``state`` (name -> tensor) as an HF sharded safetensors checkpoint:
    ``model-0000i-of-0000n.safetensors`` cut by size in the modules' order,
    ``model.safetensors.index.json`` (total size and weight map) and
    ``config.json``. Returns the bytes written."""
    names = sorted(state, key=hf_module_order)
    total = sum(state[k].numel() * state[k].element_size() for k in names)
    shards, acc = [[]], 0
    for k in names:
        if acc >= total * len(shards) / n_shards and len(shards) < n_shards:
            shards.append([])
        shards[-1].append(k)
        acc += state[k].numel() * state[k].element_size()
    weight_map = {}
    for i, keys in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(os.path.join(save_dir, fname), {k: state[k] for k in keys})
        weight_map.update({k: fname for k in keys})
    with open(os.path.join(save_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": dict(sorted(
            weight_map.items()))}, f, indent=2)
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return total


def host_peak_rss_bytes():
    """This process's peak resident set: {"VmHWM": from /proc/self/status
    (None where the kernel does not report it), "ru_maxrss": from
    getrusage}, in bytes."""
    import resource

    hwm = None
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                hwm = int(line.split()[1]) * 1024
    return {"VmHWM": hwm, "ru_maxrss": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}


@contextlib.contextmanager
def recorded_state_dicts():
    """The ``ShardedStateDict``s that checkpoint loads inside the block
    open (their ``shard_loads`` and ``bytes_read``)."""
    from deepspeed_tpu_torch.module_inject import load_checkpoint as lc

    real, made = lc.ShardedStateDict, []

    class Recorded(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    lc.ShardedStateDict = Recorded
    try:
        yield made
    finally:
        lc.ShardedStateDict = real


def launch_rule_check(what, launched, L, norms_per_forward, forwards):
    """K1 once a layer a prefill (``L``; 0 off flash), K7 as many times a
    forward as the model has norms, K8 never."""
    want = {"flash_fwd": L, "fused_norm_fwd": norms_per_forward * forwards, "fused_norm_bwd": 0}
    got = {k: launched.get(k, 0) for k in want}
    check(got == want, f"{what}: K1/K7/K8 launched {got}, expected {want}")
    return got


def hf_load_gpt2_phase(gen, card):
    """GPT-2 350M (``gpt2-350m``, 24 x 1024, the decode bench's model; bf16,
    weights from the engine's seeded CUDA generator) exported to an HF
    state dict (``module_inject.export``) and loaded back two ways through
    ``init_inference``: (a) an in-memory stand-in object with
    ``state_dict()`` and ``config`` (the port's ``HFConfig`` of
    ``GPT2_350M_CONFIG``), (b) ``save_hf_checkpoint`` into a temporary
    directory (one f32 ``pytorch_model.bin`` and ``config.json``), then the
    directory. Both with ``{"dtype": "bfloat16", "attn_impl": "pallas"}``.
    Checks: the configs equal the direct engine's, and greedy B 8 x 128 +
    128 of both equals the direct engine's stream bit for bit, with K1 24
    and K7 49 times a forward. Returns the phase's launch counts."""
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.module_inject import export
    from deepspeed_tpu_torch.module_inject import load_checkpoint as lc
    from deepspeed_tpu_torch.ops import op_builder

    class HFStandIn:
        """What ``init_inference`` takes as an HF module."""

        def __init__(self, state, config):
            self._state, self.config = state, config

        def state_dict(self):
            return dict(self._state)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    config = {"dtype": "bfloat16", "attn_impl": "pallas"}
    model = tf.TransformerModel.from_preset("gpt2-350m", dtype="bfloat16", attn_impl="pallas")
    direct = deepspeed_tpu_torch.init_inference(model, config=config, seed=0)
    cfg, L, V = direct.cfg, direct.cfg.num_layers, direct.cfg.vocab_size
    hf_config = lc.HFConfig(GPT2_350M_CONFIG)
    seconds = {}
    t0 = time.perf_counter()
    module = deepspeed_tpu_torch.init_inference(
        HFStandIn(export.export_hf_state_dict(direct.params, cfg, "gpt2"), hf_config),
        config=config)
    torch.cuda.synchronize()
    seconds["module_load_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="hf_gpt2_") as d:
        t0 = time.perf_counter()
        export.save_hf_checkpoint(d, direct.params, cfg, "gpt2", hf_config=hf_config)
        seconds["save_s"] = time.perf_counter() - t0
        seconds["checkpoint_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                                          for f in os.listdir(d))
        t0 = time.perf_counter()
        with recorded_state_dicts() as states:
            loaded = deepspeed_tpu_torch.init_inference(d, config=config)
        torch.cuda.synchronize()
        seconds["dir_load_s"] = time.perf_counter() - t0
    for name, e in (("module", module), ("dir", loaded)):
        check(e.cfg == cfg, f"hf_load_gpt2 {name}: config {e.cfg} differs from the direct "
                            f"engine's {cfg}")
    B, P, NEW = 8, 128, 128
    toks = torch.randint(0, V, (B, P), generator=gen, device="cuda")
    direct.generate(toks[:, :16], max_new_tokens=2)  # warm-up
    op_builder.reset_launch_counts()
    runs = {name: timed_generate(e, toks, NEW)
            for name, e in (("direct", direct), ("module", module), ("dir", loaded))}
    counts = op_builder.launch_counts()
    rows = {}
    for name, (out, wall, launched) in runs.items():
        check(tuple(out.shape) == (B, P + NEW) and bool(((out >= 0) & (out < V)).all()),
              f"hf_load_gpt2 {name}: output shape {tuple(out.shape)} / range")
        rows[name] = {"generate_s": wall, "new_tokens_per_s": B * NEW / wall,
                      "launches": launch_rule_check(f"hf_load_gpt2 {name}", launched, L,
                                                    2 * L + 1, NEW)}
        if name != "direct":
            same = torch.equal(out, runs["direct"][0])
            rows[name]["equal_to_direct"] = same
            check(same, f"hf_load_gpt2: the stream of the engine loaded from the {name} "
                        "differs from the direct engine's")
    emit({"phase": "hf_load_gpt2", "model": "gpt2-350m", "layers": L, "hidden": cfg.hidden_size,
          "params": cfg.num_params(), "batch": B, "prompt": P, "new_tokens": NEW,
          **seconds, "shard_loads": states[0].shard_loads if states else None,
          "runs": rows, "k1_launches_per_request": L, "k7_launches_per_forward": 2 * L + 1,
          "phase_s": time.perf_counter() - t_phase,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(), "card": card})
    del direct, module, loaded, model
    torch.cuda.empty_cache()
    return counts


def checkpoint_dir_root():
    """Where a multi-GB checkpoint is written: the temporary directory's
    file system or the checkout's, whichever has more room (the checkout's
    ``.scratch/`` is git-ignored)."""
    import shutil
    import tempfile

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".scratch")
    os.makedirs(here, exist_ok=True)
    return max((tempfile.gettempdir(), here), key=lambda d: shutil.disk_usage(d).free)


def hf_load_llama_phase(handoff, card):
    """Llama 2 7B from a checkpoint in HF's own layout: ``llama_serve``'s
    engine's weights (``handoff``; no second init) exported
    (``module_inject.export``) and written in bf16 as
    ``meta-llama/Llama-2-7b-hf``'s directory is laid out: two
    ``.safetensors`` shards cut by size, ``model.safetensors.index.json``
    and its published ``config.json`` (``LLAMA2_7B_CONFIG``), by this
    script's own writer. The serving engine is then freed, and
    ``init_inference(dir, config={"dtype": "bfloat16"})`` loads it with one
    shard open at a time (``cache_shards=1``). Checks: the loaded config
    equals the served one, and its fused stream for ``llama_serve``'s B 8 x
    512 + 64 prompt equals ``llama_serve``'s bit for bit, with K1 32 and K7
    65 times a forward. Prints the free disk before writing, the write and
    load seconds, the shard opens and tensor bytes read, this process's peak
    resident memory before and after the load, and the peak card memory.
    Returns the phase's launch counts."""
    import shutil
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.module_inject import export
    from deepspeed_tpu_torch.ops import op_builder

    t_phase = time.perf_counter()
    eng, toks, want = handoff.pop("engine"), handoff["prompt"], handoff["fused"]
    cfg, L = eng.cfg, eng.cfg.num_layers
    root = checkpoint_dir_root()
    free_before = shutil.disk_usage(root).free
    with tempfile.TemporaryDirectory(prefix="hf_llama2_7b_", dir=root) as d:
        t0 = time.perf_counter()
        written = write_hf_shards(d, export.export_hf_state_dict(eng.params, cfg, "llama"),
                                  LLAMA2_7B_CONFIG)
        write_s = time.perf_counter() - t0
        files = sorted(os.listdir(d))
        del eng
        handoff.clear()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rss_before = host_peak_rss_bytes()
        t0 = time.perf_counter()
        with recorded_state_dicts() as states:
            loaded = deepspeed_tpu_torch.init_inference(d, config={"dtype": "bfloat16"})
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        rss_after = host_peak_rss_bytes()
    check(loaded.cfg == cfg, f"hf_load_llama: the loaded config {loaded.cfg} differs from the "
                             f"served one {cfg}")
    B, P = toks.shape
    NEW = want.shape[1] - P
    op_builder.reset_launch_counts()
    out, wall, launched = timed_generate(loaded, toks, NEW)
    counts = op_builder.launch_counts()
    same = torch.equal(out, want)
    check(same, "hf_load_llama: the stream of the engine loaded from the checkpoint differs "
                "from llama_serve's")
    emit({"phase": "hf_load_llama", "model": "meta-llama/Llama-2-7b-hf layout, llama2-7b weights",
          "checkpoint_files": files, "checkpoint_tensor_bytes": written,
          "disk_free_bytes_before_write": free_before, "checkpoint_root": root,
          "write_s": write_s, "load_s": load_s,
          "shard_loads": states[0].shard_loads if states else None,
          "bytes_read": states[0].bytes_read if states else None, "cache_shards": 1,
          "host_peak_rss_bytes_before_load": rss_before,
          "host_peak_rss_bytes_after_load": rss_after,
          "batch": B, "prompt": P, "new_tokens": NEW, "generate_s": wall,
          "equal_to_llama_serve": same,
          "launches": launch_rule_check("hf_load_llama", launched, L, 2 * L + 1, NEW),
          "phase_s": time.perf_counter() - t_phase,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(), "card": card})
    del loaded
    torch.cuda.empty_cache()
    return counts


def norms_per_forward(cfg):
    """K7 launches a forward of ``cfg``: the embedding norm, each layer's
    norms (one with the shared LN) and the final norm of a pre-LN stack."""
    per_layer = 1 if cfg.parallel_residual and cfg.shared_ln else 2
    return (int(cfg.embed_norm) + cfg.num_layers * per_layer
            + int(cfg.norm_position == "pre"))


def bf16_error_bounds(params, cfg, out, prompt):
    """The uncached ``forward``'s logits over ``out`` (B, S) at each
    generated position, in the model dtype, and each position's own bf16
    rounding error: the largest |difference| over the vocab from the same
    forward in f32 on the same weights. Returns (logits, error), both
    (B, S - prompt), on the host as f32."""
    from deepspeed_tpu_torch.models import transformer as tf

    toks = out[:, :-1].long()
    with torch.inference_mode():
        low = tf.forward(params, cfg, toks)[:, prompt - 1:].float().cpu()
        f32 = tf.map_params(lambda p: p.float(), params)
        high = tf.forward(f32, dataclasses.replace(cfg, dtype="float32"), toks)[:, prompt - 1:]
        del f32
        err = (low - high.float().cpu()).abs().amax(-1)
    return low, err


def measured_tie_check(got, logits, err, what):
    """``got`` (B, new) tokens against the argmax of ``logits`` (B, new, V):
    a mismatch is a tie when its top-2 margin is under the larger of 2
    LOGITS_TOL (the bf16 tie rule) and twice its position's own bf16 error
    (``err``, from ``bf16_error_bounds``). Random weights with unscaled
    attention (GPT-Neo, ``attn_scale`` 1.0) move a bf16 forward's logits by
    ~1 from f32, against ~0.02 for the scaled families. Returns the counts,
    the widest mismatch margin and the bound it was held to."""
    margins = top2_margins(logits)
    bound = torch.clamp(2 * err, min=2 * LOGITS_TOL)
    miss = logits.argmax(-1) != got.cpu().long()
    over = miss & (margins >= bound)
    check(not bool(over.any()), f"{what}: {int(over.sum())} token(s) differ from the argmax at a "
                                "top-2 margin above the tie bound")
    worst = int(margins[miss].argmax()) if bool(miss.any()) else None
    return {"tokens": int(got.numel()), "equal_to_forward_argmax": int((~miss).sum()),
            "widest_mismatch_margin": float(margins[miss][worst]) if worst is not None else 0.0,
            "its_tie_bound": float(bound[miss][worst]) if worst is not None else None}


def hf_families_phase(gen, card):
    """Every decoder family the policies convert, at its published
    ``config.json`` values (``HF_FAMILIES``) read by the port's config
    reader and mapped by the family's policy, with weights from the
    engine's seeded CUDA generator, in bf16: greedy B 8 x 128 + 64 fused
    and through the per-token loop (equal), held to the uncached
    teacher-forced ``forward`` under the bf16 tie rule, and the same 8
    requests through the continuous-batching pool (8 slots, cache 256: the
    vector-position reads, ALiBi's included), each stream equal to the fused
    one or first differing at a tie. A tie here is a top-2 margin under the
    larger of the bf16 rule's 2 LOGITS_TOL and twice the position's own
    bf16 error (``bf16_error_bounds``, ``measured_tie_check``). K7 as many
    times a forward as the family has norms (fused and per-token), K1 never
    (the policies keep these families on the masked path), K8 never.
    Returns the phase's launch counts."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import ContinuousBatchingEngine
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.module_inject import load_checkpoint as lc
    from deepspeed_tpu_torch.module_inject import policies
    from deepspeed_tpu_torch.ops import op_builder

    t_phase = time.perf_counter()
    B, P, NEW = 8, 128, 64
    total, rows = {}, {}
    for family, entry in HF_FAMILIES.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cfg = policies.config_from_hf(lc.HFConfig(entry["config"]))
        model = tf.TransformerModel(cfg)
        eng = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bfloat16"}, seed=0)
        loop = deepspeed_tpu_torch.init_inference(
            model, config={"dtype": "bfloat16", "fused_generate": False}, params=eng.params)
        pool = ContinuousBatchingEngine(model, config={"dtype": "bfloat16"}, params=eng.params,
                                        max_slots=B, cache_len=256)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        cfg, V = eng.cfg, eng.cfg.vocab_size
        toks = torch.randint(0, V, (B, P), generator=gen, device="cuda")
        eng.generate(toks[:, :16], max_new_tokens=2)  # warm-up
        op_builder.reset_launch_counts()
        fused, fused_s, fused_launched = timed_generate(eng, toks, NEW)
        per_token, loop_s, loop_launched = timed_generate(loop, toks, NEW)
        prompts = [p.cpu().numpy() for p in toks]
        before = op_builder.launch_counts()
        t0 = time.perf_counter()
        rids = [pool.submit(p, max_new_tokens=NEW) for p in prompts]
        served = {}
        while pool.has_work():
            pool.step()
            served.update(pool.finished())
        served.update(pool.finished())
        torch.cuda.synchronize()
        pool_s = time.perf_counter() - t0
        after = op_builder.launch_counts()
        for k, c in after.items():
            total[k] = total.get(k, 0) + c
        per_forward = norms_per_forward(cfg)
        name = family.split(",")[0] + (" post-LN" if cfg.norm_position == "post" else "")
        check(tuple(fused.shape) == (B, P + NEW) and bool(((fused >= 0) & (fused < V)).all()),
              f"hf_families {name}: output shape {tuple(fused.shape)} / range")
        same = torch.equal(fused, per_token)
        check(same, f"hf_families {name}: the per-token stream differs from the fused one")
        launches = {path: launch_rule_check(f"hf_families {name} {path}", launched, 0,
                                            per_forward, NEW)
                    for path, launched in (("fused", fused_launched),
                                           ("per_token", loop_launched))}
        pool_k7 = after.get("fused_norm_fwd", 0) - before.get("fused_norm_fwd", 0)
        check(pool_k7 > 0 and after.get("flash_fwd", 0) == before.get("flash_fwd", 0),
              f"hf_families {name}: the pool launched K7 {pool_k7} times and K1 "
              f"{after.get('flash_fwd', 0) - before.get('flash_fwd', 0)}")
        logits, err = bf16_error_bounds(eng.params, cfg, fused, P)
        teacher = measured_tie_check(fused[:, P:], logits, err,
                                     f"hf_families {name} teacher-forced")
        # where a pool stream first differs from the fused one (the same
        # context up to there), its token is held as the fused ones are
        agree = []
        for b, r in enumerate(rids):
            pooled = torch.from_numpy(served[r][P:]).long()
            diff = torch.nonzero(pooled != fused[b, P:].cpu())
            row = {"equal": not len(diff)}
            if len(diff):
                j = int(diff[0])
                row.update(first_diff_step=j, **measured_tie_check(
                    pooled[None, j:j + 1], logits[b:b + 1, j:j + 1], err[b:b + 1, j:j + 1],
                    f"hf_families {name} pool row {b}"))
            agree.append(row)
        rows[family] = {
            "variant": entry["variant"], "layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "heads": cfg.num_heads, "head_dim": cfg.head_dim, "vocab": V,
            "params": cfg.num_params(), "pos_embedding": cfg.pos_embedding,
            "norm_position": cfg.norm_position, "parallel_residual": cfg.parallel_residual,
            "shared_ln": cfg.shared_ln, "embed_norm": cfg.embed_norm, "rope_dim": cfg.rope_dim,
            "rope_interleaved": cfg.rope_interleaved, "lm_head_bias": cfg.lm_head_bias,
            "local_attn_windows": sorted(set(cfg.local_attn_windows or ())),
            "attn_scale": cfg.attn_scale, "activation": cfg.activation,
            "build_s": build_s, "fused_s": fused_s, "per_token_s": loop_s, "pool_s": pool_s,
            "new_tokens_per_s_fused": B * NEW / fused_s, "per_token_equal_to_fused": same,
            "k7_launches_per_forward": per_forward, "launches": launches,
            "pool_k7_launches": pool_k7, "pool_vs_fused": agree,
            "pool_streams_equal": sum(a["equal"] for a in agree),
            "teacher_forced": teacher, "bf16_error_median": float(err.median()),
            "bf16_error_max": float(err.max()),
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        del eng, loop, pool, model, fused, per_token
    torch.cuda.empty_cache()
    emit({"phase": "hf_families", "batch": B, "prompt": P, "new_tokens": NEW,
          "families": rows, "phase_s": time.perf_counter() - t_phase, "card": card})
    return total


def rss_bytes():
    """This process's resident set now (VmRSS), in bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return None


def state_leaf_count(engine):
    """The number of leaves of the engine's checkpoint state tree."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.torch_checkpoint_engine import tree_items

    return sum(1 for _ in tree_items(engine._state_tree()))


def unequal_leaves(a, b):
    """Keys of the leaves that differ in any bit between two engines, each
    leaf whole (one leaf of each on the host at a time)."""
    bad = []
    for (ka, x), (kb, y) in itertools.zip_longest(a._host_leaves(), b._host_leaves(),
                                                  fillvalue=(None, None)):
        if ka != kb:
            return ["<the trees differ in keys>"]
        if not torch.equal(x, y):
            bad.append(ka)
    return bad


def tag_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def train_resume_phase(gen, card):
    """``train_resume``: the ``train`` phase's GPT-2 125M (full width and
    depth, B8 S1024, bf16, flash attention, AdamW) saved, loaded and resumed.
    Run A trains 6 steps; run B trains 3, saves (sync), and a fresh engine
    with other weights loads the tag and trains 3 more; then the same with
    ``async_save`` (the saving engine takes one more step while its writer
    runs, then fences). Both resumed streams and every leaf of the state
    tree after step 6 (params, masters, moments, accumulators, loss scale)
    must equal run A's bit for bit. Then a markerless newest tag is refused
    with fallback to the one before, a flipped byte in a leaf file is refused
    by the manifest, and two SDC probes of one batch agree. K1-K3 launch 12
    and K7/K8 25 times a step (an SDC probe is a step's forward and
    backward). The tags are written under ``checkpoint_dir_root()`` and
    removed at the end."""
    import shutil

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.runtime.checkpoint_engine import integrity
    from deepspeed_tpu_torch.runtime.checkpoint_engine import torch_checkpoint_engine as tce

    t_phase = time.perf_counter()
    root = os.path.join(checkpoint_dir_root(), f"train_resume_{os.getpid()}")
    model = tf.TransformerModel.from_preset("gpt2-125m", dtype="bfloat16", attn_impl="pallas")
    L, V = model.cfg.num_layers, model.cfg.vocab_size
    batches = [{"input_ids": torch.randint(0, V, (8, 1024), generator=gen, device="cuda")}
               for _ in range(6)]

    def engine(seed, async_save=False):
        config = dict(TRAIN_CONFIG, checkpoint={"async_save": async_save})
        return deepspeed_tpu_torch.initialize(model=model, config=config, seed=seed)[0]

    def train(e, steps):
        return [e.train_batch(iter([batches[e.global_steps]])).item() for _ in range(steps)]

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    verify_s = []
    real_verify = integrity.verify_leaves

    def timed_verify(*args):
        out, s = timed(lambda: real_verify(*args))
        verify_s.append(s)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rss0, peak0 = rss_bytes(), host_peak_rss_bytes()
    op_builder.reset_launch_counts()
    integrity.verify_leaves = timed_verify
    try:
        run_a = engine(0)
        losses_a = train(run_a, 6)
        # sync: tags at steps 2 and 3
        run_b = engine(0)
        sync_dir = os.path.join(root, "sync")
        losses_b = train(run_b, 2)
        run_b.save_checkpoint(sync_dir)
        losses_b += train(run_b, 1)
        _, sync_save_s = timed(lambda: run_b.save_checkpoint(sync_dir))
        tag = os.path.join(sync_dir, "global_step3")
        del run_b
        resumed = engine(1)
        (path, _), load_s = timed(lambda: resumed.load_checkpoint(sync_dir))
        load_verify_s = verify_s[-1]
        check(path == tag, f"train_resume: loaded {path}, expected {tag}")
        losses_b += train(resumed, 3)
        sync_bad = unequal_leaves(resumed, run_a)
        check(losses_b == losses_a and not sync_bad,
              f"train_resume (sync): losses {losses_b} vs {losses_a}, "
              f"{len(sync_bad)} leaves differ: {sync_bad[:3]}")
        del resumed
        # async: the next step runs while the writer writes
        run_d = engine(0, async_save=True)
        async_dir = os.path.join(root, "async")
        losses_d = train(run_d, 3)
        _, async_blocked_s = timed(lambda: run_d.save_checkpoint(async_dir))
        _, step_during_write_s = timed(lambda: train(run_d, 1))
        _, fence_s = timed(run_d.checkpoint_engine.wait)
        del run_d
        resumed = engine(1, async_save=True)
        resumed.load_checkpoint(async_dir)
        losses_d += train(resumed, 3)
        async_bad = unequal_leaves(resumed, run_a)
        check(losses_d == losses_a and not async_bad,
              f"train_resume (async): losses {losses_d} vs {losses_a}, "
              f"{len(async_bad)} leaves differ: {async_bad[:3]}")
        # a markerless newest tag falls back to the one before
        os.remove(os.path.join(tag, integrity.COMMIT_MARKER))
        path, _ = resumed.load_checkpoint(sync_dir)
        check(path.endswith("global_step2") and resumed.global_steps == 2,
              f"train_resume: a markerless global_step3 loaded {path} at step "
              f"{resumed.global_steps}, expected global_step2")
        # one flipped byte in one leaf file
        adir = os.path.join(sync_dir, "global_step2", tce.ARRAYS_DIR)
        with open(os.path.join(adir, tce.INDEX_FILE)) as fh:
            leaf_file = os.path.join(adir, json.load(fh)[f"['params']['layers'][{L // 2}]['mlp']['wi']"]["file"])
        with open(leaf_file, "r+b") as fh:
            fh.seek(12345)
            byte = fh.read(1)
            fh.seek(12345)
            fh.write(bytes([byte[0] ^ 0x10]))
        try:
            resumed.load_checkpoint(sync_dir, tag="global_step2")
            refused = None
        except integrity.TornCheckpointError as exc:
            refused = str(exc)
        check(refused is not None and "checksum mismatch" in refused,
              f"train_resume: a flipped byte was not refused by the manifest ({refused})")
        # two SDC probes of one batch
        digests = [run_a.sdc_probe(batches[0]) for _ in range(2)]
        check(digests[0] == digests[1], f"train_resume: SDC probes disagree: {digests}")
        torch.cuda.synchronize()
        counts = op_builder.launch_counts()
        steps = 6 + 3 + 3 + 3 + 1 + 3 + 2  # A, B, resumed, D, D's step mid-write, resumed, probes
        for kname in KERNELS:
            check(counts[kname] == L * steps,
                  f"train_resume: {kname} launched {counts[kname]} times, expected {L} x {steps}")
        for kname in NORM_KERNELS:
            check(counts[kname] == (2 * L + 1) * steps,
                  f"train_resume: {kname} launched {counts[kname]} times, expected "
                  f"{2 * L + 1} x {steps}")
        nbytes = tag_bytes(os.path.join(sync_dir, "global_step2"))
        peak1 = host_peak_rss_bytes()
        emit({"phase": "train_resume", "model": "gpt2-125m", "batch": 8, "seq": 1024,
              "layers": L, "dtype": "bfloat16", "losses": losses_a,
              "resume_bitwise": {"sync": losses_b == losses_a and not sync_bad,
                                 "async": losses_d == losses_a and not async_bad},
              "leaves": state_leaf_count(run_a), "tag_bytes": nbytes,
              "sync_save_s": sync_save_s, "async_save_blocked_s": async_blocked_s,
              "async_step_during_write_s": step_during_write_s, "async_fence_s": fence_s,
              "load_s": load_s, "load_verify_s": load_verify_s,
              "markerless_fallback": path, "flipped_byte_refused": refused is not None,
              "sdc_digests": digests,
              "host_rss_bytes": {"before": rss0, "after": rss_bytes()},
              "host_peak_rss_bytes": {"before": peak0, "after": peak1},
              "host_peak_rss_rise_bytes": {k: (peak1[k] - peak0[k]) if peak0[k] else None
                                           for k in peak0},
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "launches": {k: counts[k] for k in KERNELS + NORM_KERNELS}, "steps": steps,
              "phase_s": time.perf_counter() - t_phase, "card": card})
    finally:
        integrity.verify_leaves = real_verify
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


def train_supervised_phase(gen, card):
    """``train_supervised``: a ``TrainSupervisor`` run of 10 steps of the
    ``train`` phase's GPT-2 125M over a ``TpuDataLoader`` of seeded random
    tokens, host snapshots every 2 steps and committed tags on disk, the
    telemetry hub on, under a plan of a ``micro_dispatch`` error (step 3), a
    torn ``checkpoint_write`` (4), a preemption (5, restored from disk past
    the torn tag), a ``step_fetch`` hang with ``fetch_timeout_s`` set (7,
    rebuilt from memory) and a ``grad_bitflip`` (9, bit 30) with the sentinel
    armed (rewound). The loss stream must equal the fault-free run's bit for
    bit. Prints ``recovery_stats()`` and each rung's milliseconds from the
    trace."""
    import shutil

    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import faults
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.runtime.dataloader import TpuDataLoader
    from deepspeed_tpu_torch.runtime.resilience import TrainSupervisor
    from deepspeed_tpu_torch.telemetry import Telemetry, TelemetryConfig, read_trace

    t_phase = time.perf_counter()
    root = os.path.join(checkpoint_dir_root(), f"train_supervised_{os.getpid()}")
    model = tf.TransformerModel.from_preset("gpt2-125m", dtype="bfloat16", attn_impl="pallas")
    L, V = model.cfg.num_layers, model.cfg.vocab_size
    rs = np.random.RandomState(int(torch.randint(0, 2 ** 31, (1,), generator=gen, device="cuda")))
    rows = [{"input_ids": rs.randint(0, V, 1024).astype(np.int32)} for _ in range(96)]
    trace = os.path.join(root, "trace.jsonl")
    os.makedirs(root, exist_ok=True)
    hubs = []

    def factory():
        e = deepspeed_tpu_torch.initialize(model=model, config=TRAIN_CONFIG, seed=0)[0]
        if not hubs:  # the supervisor adopts the first engine's hub
            hubs.append(Telemetry(TelemetryConfig(enabled=True, trace_file=trace), role="train"))
            e.telemetry = hubs[0]
        return e

    def loader():
        return TpuDataLoader(rows, batch_size=8, seed=0)

    steps = 10
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    op_builder.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        ref = TrainSupervisor(lambda: deepspeed_tpu_torch.initialize(
            model=model, config=TRAIN_CONFIG, seed=0)[0], loader()).run(steps)
        fault_free_s = time.perf_counter() - t0
        plan = faults.TrainFaultPlan([
            faults.TrainFault(tick=3, kind="dispatch_error"),
            faults.TrainFault(tick=4, kind="torn_write"),
            faults.TrainFault(tick=5, kind="preempt"),
            faults.TrainFault(tick=7, kind="fetch_hang"),
            faults.TrainFault(tick=9, kind="grad_bitflip", leaf=f"layers.{L // 2}.mlp.wi", bit=30)])
        inj = faults.TrainFaultInjector(plan)
        sup = TrainSupervisor(factory, loader(), fault_hook=inj, recovery={
            "snapshot_every_n_steps": 2, "snapshot_dir": os.path.join(root, "tags"),
            "fetch_timeout_s": 30.0, "backoff_s": 0.0,
            "numeric_sentinel": {"min_history": 4}})
        t0 = time.perf_counter()
        losses = sup.run(steps)
        chaos_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = op_builder.launch_counts()
        stats = sup.recovery_stats()
        hubs[0]._writer.close()
        events = list(read_trace(trace))
        rung_ms = {
            "retry": [e["dur_ms"] for e in events if e.get("span") == "train_retry"],
            "rebuild": [{"source": e["source"], "recovery_ms": e["recovery_ms"]}
                        for e in events if e.get("event") == "rebuild"],
            "rewind": [e["rewind_ms"] for e in events if e.get("event") == "rewind"],
            "snapshot": [{"step": e["step"], "checkpoint_ms": e["checkpoint_ms"],
                          "committed": e["committed"]}
                         for e in events if e.get("event") == "snapshot"],
        }
        check(losses == ref, f"train_supervised: chaos stream {losses} vs fault-free {ref}")
        check(inj.pending() == 0 and [f["kind"] for f in inj.fired] == [
            "dispatch_error", "torn_write", "preempt", "fetch_hang", "grad_bitflip"],
              f"train_supervised: fired {[f['kind'] for f in inj.fired]}")
        check(stats["retries"] == 1 and stats["rebuilds"] == 2 and stats["torn_writes"] == 1
              and stats["rewinds"] == 1 and stats["quarantines"] == 0,
              f"train_supervised: recovery_stats {stats}")
        check([r["source"] for r in rung_ms["rebuild"]] == ["disk", "memory"],
              f"train_supervised: rebuilds {rung_ms['rebuild']}")
        # one forward and backward a step computed: the fault-free run's 10;
        # the chaos run's 1-4, 3-6 replayed after the preemption, 7 (its fetch
        # hangs), 7-8 replayed, 9 (rewound), 9-10 replayed (the injected
        # dispatch error raises before its forward)
        step_runs = steps + 4 + 4 + 1 + 2 + 1 + 2
        for kname in KERNELS + NORM_KERNELS:
            per = L if kname in KERNELS else 2 * L + 1
            check(counts[kname] == per * step_runs,
                  f"train_supervised: {kname} launched {counts[kname]} times, expected "
                  f"{per} x {step_runs} steps")
        emit({"phase": "train_supervised", "model": "gpt2-125m", "batch": 8, "seq": 1024,
              "layers": L, "steps": steps, "losses": losses, "equal_fault_free": losses == ref,
              "plan": [f.to_dict() for f in plan], "fired": [f["kind"] for f in inj.fired],
              "recovery_stats": stats, "rung_ms": rung_ms,
              "fault_free_run_s": fault_free_s, "chaos_run_s": chaos_s,
              "steps_run_incl_replays": step_runs,
              "launches": {k: counts[k] for k in KERNELS + NORM_KERNELS},
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "phase_s": time.perf_counter() - t_phase, "card": card})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# training every decoder family the port serves (``--train-decoders`` runs
# these phases alone)
# ---------------------------------------------------------------------------

# train_llama: the llama2-7b preset at full width, 4 of its 32 layers, B 2 x
# S 4096, flash; the f32 gradient check at 2 layers, B 1 x S 512
LLAMA_TRAIN = {"layers": 4, "batch": 2, "seq": 4096, "warmup": 2, "steps": 10,
               "f32_layers": 2, "f32_batch": 1, "f32_seq": 512}
# train_mistral: Mistral 7B's shape at 2 layers, B 1 x S 8192 (the window
# band of 4096 is live in K1-K3)
MISTRAL_TRAIN = {"layers": 2, "batch": 1, "seq": 8192, "warmup": 2, "steps": 10}
# train_families: every HF family at its published widths, 2 layers, B 4 x
# S 512, 1 + 8 steps; the f32 step card against CPU at B 1 x S 128
FAMILY_TRAIN = {"layers": 2, "batch": 4, "seq": 512, "warmup": 1, "steps": 8,
                "f32_batch": 1, "f32_seq": 128}
# hf_finetune: Llama 2 7B's layout at 2 layers, B 4 x S 1024 for 3 steps,
# served B 8 x 128 + 32
FINETUNE = {"layers": 2, "batch": 4, "seq": 1024, "steps": 3, "serve_batch": 8,
            "prompt": 128, "new": 32}
# the kernels a training step on the flash path launches
STEP_KERNELS = KERNELS + NORM_KERNELS


def train_config(batch, dtype="bfloat16"):
    """TRAIN_CONFIG (bf16, AdamW lr 1e-4 wd 0.01, ZeRO 0) at micro-batch
    ``batch``; without its bf16 block for an f32 engine."""
    config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=batch)
    if dtype == "float32":
        config.pop("bf16")
    return config


def engine_step(e, data, between=None):
    """One training step; ``between(e)`` runs after backward, before step."""
    loss = e.forward(data)
    e.backward(loss)
    got = between(e) if between is not None else None
    e.step()
    return loss, got


def step_launch_rule(cfg):
    """K1-K3 and K7/K8 launches a training step of ``cfg``: each flash
    kernel once a layer that takes the flash path (``attn_impl="pallas"``
    without ALiBi or per-layer windows; none on the masked path), each norm
    kernel once a norm of the forward (``norms_per_forward``)."""
    flash = (cfg.attn_impl == "pallas" and cfg.pos_embedding != "alibi"
             and not cfg.varying_windows)
    n = norms_per_forward(cfg)
    return {"flash_fwd": cfg.num_layers * flash, "flash_bwd_dq": cfg.num_layers * flash,
            "flash_bwd_dkv": cfg.num_layers * flash, "fused_norm_fwd": n, "fused_norm_bwd": n}


def alibi_slopes(n):
    """ALiBi's head slopes (Press et al.): 2^(-8 (i + 1) / n) for n a power
    of 2; otherwise those of the power of 2 below n, then every other slope
    of the one above."""
    c = 2 ** int(math.log2(n))
    return ([2.0 ** (-8 * (i + 1) / c) for i in range(c)]
            + [2.0 ** (-4 * (2 * i + 1) / c) for i in range(n - c)])


def init_loss(cfg, seq):
    """The first loss that a random init predicts on uniform random tokens.

    The final norm's output x has unit mean square at init, so the logits
    have variance sigma^2 = D std_head^2: the tied head is the embedding (std
    0.02, +0.15 at GPT-2 125M's D 768), an untied head has std 1/sqrt(D)
    (+0.5), and the loss is ln V + sigma^2 / 2.

    A tied head behind the embedding norm (BLOOM) also scores the current
    token t. The normed embedding h0 = e_t / sqrt(0.02^2 + eps) is the whole
    residual stream before the first layer, so x . e_t = 0.02^2 D /
    sqrt(0.02^2 + eps) / sigma_h, where sigma_h^2 is h0's mean square plus
    what each of the L pre-LN layers adds: its MLP E[act(z)^2] / (2 L) (wi's
    std 1/sqrt(D) makes z ~ N(0, 1) on a unit input; wo's is 1/sqrt(F) /
    sqrt(2 L)) and its attention E[sum_j p_j^2] / (2 L) (independent unit
    values; p the softmax of scores of variance head_dim * scale^2 less
    ALiBi's distance penalty, drawn from a seeded generator and averaged over
    the heads). Position i's loss is then logaddexp(x . e_t, ln(V - 1) +
    sigma^2 / 2), averaged over the positions that have a target: 18.10 at
    bloom-560m's width, 2 layers, S 512, where ln V is 12.43."""
    D, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    var_e = 0.02 ** 2
    sigma2 = D * (var_e if cfg.tie_embeddings else 1.0 / D)
    rest = math.log(V - 1) + sigma2 / 2
    if not (cfg.tie_embeddings and cfg.embed_norm):
        return math.log(V) + sigma2 / 2
    z = torch.linspace(-12.0, 12.0, 240001, dtype=torch.float64)
    pdf = torch.exp(-z * z / 2) / math.sqrt(2 * math.pi) * (z[1] - z[0])
    act = {"relu": torch.relu, "silu_glu": torch.nn.functional.silu,
           "gelu": lambda t: 0.5 * t * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                                       * (t + 0.044715 * t ** 3)))}
    mlp = float((act[cfg.activation](z) ** 2 * pdf).sum())
    scale = cfg.attn_scale if cfg.attn_scale is not None else cfg.head_dim ** -0.5
    slopes = alibi_slopes(cfg.num_heads) if cfg.pos_embedding == "alibi" else [0.0] * cfg.num_heads
    gen = torch.Generator().manual_seed(0)
    pos = torch.arange(seq, dtype=torch.float64)
    dist = pos[:, None] - pos[None, :]
    psq = torch.zeros(seq, dtype=torch.float64)
    for m in slopes:
        scores = (torch.randn(seq, seq, generator=gen, dtype=torch.float64)
                  * math.sqrt(cfg.head_dim) * scale - m * dist)
        p = torch.softmax(scores.masked_fill(dist < 0, -math.inf), dim=-1)
        psq += (p ** 2).sum(-1) / len(slopes)
    sigma_h = torch.sqrt(var_e / (var_e + cfg.norm_eps) + (psq + mlp) / 2)
    self_dot = D * var_e / math.sqrt(var_e + cfg.norm_eps) / sigma_h
    return float(torch.logaddexp(self_dot, torch.tensor(rest, dtype=torch.float64))[:-1].mean())


def timed_training(e, data, warmup, steps, first_between=None):
    """``warmup`` steps, then ``steps`` timed ones on one fixed batch, the
    launch counts set to 0 just before the timed steps and read just after.
    Returns the losses, the step seconds, the counts, the first step's
    grad norm and ``first_between``'s result, and the peak card memory of the
    timed steps."""
    from deepspeed_tpu_torch.ops import op_builder

    loss, first = engine_step(e, data, first_between)
    losses = [float(loss)]
    gnorm0 = e.get_global_grad_norm()
    for _ in range(warmup - 1):
        losses.append(float(engine_step(e, data)[0]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    op_builder.reset_launch_counts()
    step_s = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = engine_step(e, data)[0]
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    counts = op_builder.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    return {"losses": losses, "step_s": step_s, "counts": counts, "grad_norm0": gnorm0,
            "first": first, "peak": peak}


def training_row(what, cfg, run, batch, seq, steps):
    """The checks every training phase makes of its timed run (launches a
    step by the model's rule; the first loss finite and within
    FIRST_LOSS_TOL of ``init_loss``; the mean of the last 3 losses LOSS_DROP
    under the first) and the fields of its line."""
    rule = step_launch_rule(cfg)
    counts = {k: run["counts"].get(k, 0) for k in STEP_KERNELS}
    for k, per_step in rule.items():
        check(counts[k] == per_step * steps,
              f"{what}: {k} launched {counts[k]} times in {steps} steps, expected {per_step} "
              f"a step")
    losses = run["losses"]
    ln_v = math.log(cfg.vocab_size)
    predicted = init_loss(cfg, seq)
    check(all(math.isfinite(x) for x in losses) and abs(losses[0] - predicted) <= FIRST_LOSS_TOL,
          f"{what}: first loss {losses[0]} not finite or not within {FIRST_LOSS_TOL} of the "
          f"init's {predicted} (ln V {ln_v})")
    late = statistics.mean(losses[-3:])
    check(late <= losses[0] - LOSS_DROP,
          f"{what}: loss fell from {losses[0]} to {late} (last 3), less than {LOSS_DROP}")
    med = statistics.median(run["step_s"])
    tokens_per_s = batch * seq / med
    fpt = cfg.flops_per_token(seq)
    return {"batch": batch, "seq": seq, "layers": cfg.num_layers, "hidden": cfg.hidden_size,
            "heads": cfg.num_heads, "kv_heads": cfg.kv_heads, "head_dim": cfg.head_dim,
            "ffn": cfg.ffn_size, "vocab": cfg.vocab_size, "params": cfg.num_params(),
            "dtype": cfg.dtype, "attn_impl": cfg.attn_impl,
            "optimizer": "AdamW lr 1e-4 wd 0.01", "steps": steps, "losses": losses,
            "first_loss_vs_ln_v": losses[0] - ln_v,
            "first_loss_vs_init_prediction": losses[0] - predicted,
            "init_prediction": predicted,
            "first_loss_tol": FIRST_LOSS_TOL, "loss_drop_last3": losses[0] - late,
            "loss_drop_min": LOSS_DROP, "step_ms_median": med * 1e3,
            "step_ms_min": min(run["step_s"]) * 1e3, "step_ms_max": max(run["step_s"]) * 1e3,
            "tokens_per_s": tokens_per_s, "flops_per_token": fpt,
            "step_tflop": fpt * batch * seq / 1e12,
            "mfu": fpt * tokens_per_s / PEAK_FLOPS[torch.bfloat16],
            "peak_memory_bytes": run["peak"],
            "launches": counts, "launches_per_step": {k: c / steps for k, c in counts.items()},
            "launch_rule_per_step": rule}


def leaf_rel(got, ref):
    """max |got - ref| / max |ref| a leaf; a leaf whose gradient is 0 on the
    reference side (GPT-J's unused ln2) is held to 0 on the other."""
    out = {}
    for name, g in ref.items():
        m = float(g.abs().max())
        d = float((got[name].to(g.device) - g).abs().max())
        out[name] = d / m if m > 0 else d
    return out


def f32_step(cfg, params, data, device):
    """(loss, {leaf: f32 gradient on the host}, params) of one f32 step's
    forward and backward (TF32 off) of a fresh engine of ``cfg`` on
    ``device``, from ``params`` (None: the seeded init)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tf

    e = deepspeed_tpu_torch.initialize(model=tf.TransformerModel(cfg), params=params,
                                       config=train_config(data.shape[0], "float32"),
                                       device=device)[0]
    loss = e.forward({"input_ids": data.to(device)})
    e.backward(loss)
    grads = {name: g.detach().cpu() for (name, _), g in zip(named_leaves(e.params), e.grad_acc)}
    return float(loss), grads, e.params


@contextlib.contextmanager
def relu_branches(pinned=None):
    """Records the input of each ``F.relu`` call of the model in call order
    (``["inputs"]``, on the host) or, given another run's records
    (``pinned``), takes that run's branch where the two inputs straddle 0:
    the same subgradient on both sides of a card-against-CPU comparison.
    ``["straddles"]`` counts those inputs, ``["straddle_max_abs"]`` is the
    largest |input| among them on either side."""
    import torch.nn.functional as F

    real = F.relu
    rec = {"inputs": [], "straddles": 0, "straddle_max_abs": 0.0}

    def relu(x, inplace=False):
        rec["inputs"].append(x.detach().cpu())
        if pinned is None:
            return real(x, inplace=inplace)
        other = pinned["inputs"][len(rec["inputs"]) - 1].to(x.device)
        straddle = (x > 0) != (other > 0)
        if bool(straddle.any()):
            rec["straddles"] += int(straddle.sum())
            rec["straddle_max_abs"] = max(rec["straddle_max_abs"],
                                          float(x.detach()[straddle].abs().max()),
                                          float(other[straddle].abs().max()))
        return torch.where(other > 0, x, torch.zeros_like(x))

    F.relu = relu
    try:
        yield rec
    finally:
        F.relu = real


def step_breakdown(e, data, kernel_names, med_ms, card):
    """One training step under the profiler: device time by kernel and by
    category (the ``*_breakdown`` lines), cross-checked against CUDA events
    recorded around the same step: the kernels of one stream cannot add up
    to more than the events' span, and their sum over the span is the
    device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        engine_step(e, data)
        end.record()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    events_ms = start.elapsed_time(end)
    tk = device_kernels(prof)
    tdev = sum(t for _, t, _ in tk)
    check(not tk or tdev * 1e3 <= events_ms * (1 + PROFILER_SPAN_TOL),
          f"breakdown: the profiler's kernels add up to {tdev * 1e3} ms, more than the "
          f"{events_ms} ms between CUDA events around the same step")
    per_kernel = {}
    for kname in kernel_names:
        tag = f"{kname}_kernel"
        t = sum(x for k, x, _ in tk if tag in k)
        per_kernel[kname] = {"device_s": t, "share_of_device_time": t / tdev if tdev else None,
                             "launches": sum(n for k, _, n in tk if tag in k)}
    return tk, {
        "step_wall_s_under_profiler": prof_wall, "step_ms_median_unprofiled": med_ms,
        "device_kernel_s": tdev if tk else "not measured",
        "cuda_events_step_ms": events_ms,
        "profiler_device_ms_over_events_ms": tdev * 1e3 / events_ms if tk else "not measured",
        "device_busy_share": tdev / prof_wall if tk else "not measured",
        "device_busy_share_of_unprofiled_step": tdev / med_ms * 1e3 if tk else "not measured",
        "device_kernel_launches": sum(n for _, _, n in tk),
        "kernels": per_kernel,
        "by_category": by_category(tk),
        "top_kernels": [{"name": k[:120], "s": t, "launches": n}
                        for k, t, n in sorted(tk, key=lambda x: -x[1])[:15]],
        "card": card}


def first_step_vs_xla(what, cfg, init_params, data, loss0, gnorm0, extra=None):
    """The first bf16 step of an xla-attention engine on the same initial
    weights (a 7B-width flash engine already freed): loss within
    TRAIN_LOSS_TOL, grad norm within TRAIN_GNORM_REL_TOL; ``extra(engine)``,
    run after its backward, adds its dict of metrics to the result."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tf

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    xcfg = dataclasses.replace(cfg, attn_impl="xla")
    xe = deepspeed_tpu_torch.initialize(model=tf.TransformerModel(xcfg), params=init_params,
                                        config=train_config(data["input_ids"].shape[0]),
                                        device="cuda")[0]
    xloss, more = engine_step(xe, data, extra)
    xloss = float(xloss)
    xgnorm = xe.get_global_grad_norm()
    peak = torch.cuda.max_memory_allocated()
    del xe
    torch.cuda.empty_cache()
    rel = abs(gnorm0 - xgnorm) / xgnorm
    check(abs(loss0 - xloss) <= TRAIN_LOSS_TOL and rel <= TRAIN_GNORM_REL_TOL,
          f"{what}: first step vs xla engine: loss {loss0} vs {xloss}, grad norm {gnorm0} vs "
          f"{xgnorm}")
    return {"loss": loss0, "xla_loss": xloss, "loss_abs_diff": abs(loss0 - xloss),
            "grad_norm": gnorm0, "xla_grad_norm": xgnorm, "grad_norm_rel_diff": rel,
            "loss_tol": TRAIN_LOSS_TOL, "grad_norm_rel_tol": TRAIN_GNORM_REL_TOL,
            "xla_step_peak_memory_bytes": peak, **(more or {})}


def train_llama_phase(gen, card):
    """The ``llama2-7b`` preset at full width (D 4096, 32 heads of 128,
    SwiGLU 11008, vocab 32000, untied) at 4 of its 32 layers, bf16, flash,
    AdamW: 2 warm-up and 10 timed steps on one fixed B 2 x S 4096 batch, K1-K3
    4 and K7/K8 9 a step; the first step against the xla engine on the same
    weights (the flash engine freed first: the xla path's (2, 32, 4096,
    4096) scores take ~25 GB over 4 layers); one step under the profiler
    (``train_llama_breakdown``); every gradient leaf of a 2-layer f32 flash
    engine (TF32 off, B 1 x S 512) against the xla engine's. Returns the
    timed steps' launch counts and the line."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tf

    t_phase = time.perf_counter()
    s = LLAMA_TRAIN
    B, S = s["batch"], s["seq"]
    model = tf.TransformerModel.from_preset("llama2-7b", dtype="bfloat16", attn_impl="pallas",
                                            num_layers=s["layers"])
    engine = deepspeed_tpu_torch.initialize(model=model, config=train_config(B),
                                            device="cuda")[0]
    cfg = engine.model.cfg
    init_params = tf.map_params(lambda p: p.detach().to("cpu", copy=True), engine.master_params)
    data = {"input_ids": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")}
    run = timed_training(engine, data, s["warmup"], s["steps"])
    row = training_row("train_llama", cfg, run, B, S, s["steps"])
    tk, breakdown = step_breakdown(engine, data, KERNELS, row["step_ms_median"], card)
    check(bool(tk), "train_llama breakdown: the profiler saw no device kernel")
    del engine
    row["first_step_vs_xla"] = first_step_vs_xla("train_llama", cfg, init_params, data,
                                                 run["losses"][0], run["grad_norm0"])
    del init_params
    # every gradient leaf in f32 (TF32 off), 2 layers: flash against xla
    f32_cfg = dataclasses.replace(cfg, dtype="float32", num_layers=s["f32_layers"])
    f32_data = data["input_ids"][:s["f32_batch"], :s["f32_seq"]]
    loss_f, grads_f, params_f = f32_step(f32_cfg, None, f32_data, "cuda")
    loss_x, grads_x, _ = f32_step(dataclasses.replace(f32_cfg, attn_impl="xla"), params_f,
                                  f32_data, "cuda")
    del params_f
    rel = leaf_rel(grads_f, grads_x)
    worst = max(rel, key=rel.get)
    check(rel[worst] <= F32_GRAD_REL_TOL and abs(loss_f - loss_x) <= F32_LOSS_TOL,
          f"train_llama f32: flash vs xla engine: loss {loss_f} vs {loss_x}, worst leaf "
          f"{worst} at {rel[worst]} of its max |grad|")
    row["f32_vs_xla"] = {
        "layers": s["f32_layers"], "batch": s["f32_batch"], "seq": s["f32_seq"],
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "loss_flash": loss_f, "loss_xla": loss_x, "loss_abs_diff": abs(loss_f - loss_x),
        "loss_tol": F32_LOSS_TOL, "leaves": len(rel), "worst_leaf": worst,
        "worst_rel": rel[worst], "rel_tol": F32_GRAD_REL_TOL}
    del grads_f, grads_x
    row = {"phase": "train_llama", "model": f"llama2-7b width, {cfg.num_layers} of 32 layers",
           **row, "phase_s": time.perf_counter() - t_phase, "card": card}
    emit(row)
    emit({"phase": "train_llama_breakdown", "model": row["model"], "batch": B, "seq": S,
          **breakdown})
    torch.cuda.empty_cache()
    return run["counts"], row


def train_mistral_phase(gen, card):
    """Mistral 7B's shape (``MISTRAL_7B``: 32 heads, 8 kv heads, SwiGLU
    14336, the 4096-position window) at 2 layers, bf16, flash: 2 warm-up and
    10 timed steps on one fixed B 1 x S 8192 batch, so that the window band
    is live in K1-K3 (GQA group 4); the first step against the xla engine on
    the same weights (the flash engine freed first); the first step's wk/wv
    gradient norms a layer finite and non-zero. Returns the timed steps'
    launch counts."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tf

    t_phase = time.perf_counter()
    s = MISTRAL_TRAIN
    B, S = s["batch"], s["seq"]
    cfg = tf.TransformerConfig(**dict(MISTRAL_7B, num_layers=s["layers"], dtype="bfloat16",
                                      local_attn_windows=(4096,) * s["layers"]))
    engine = deepspeed_tpu_torch.initialize(model=tf.TransformerModel(cfg),
                                            config=train_config(B), device="cuda")[0]
    init_params = tf.map_params(lambda p: p.detach().to("cpu", copy=True), engine.master_params)
    data = {"input_ids": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")}

    def kv_norms(e):
        return [{part: float(blocks[i].norm()) for i, part in ((1, "wk"), (2, "wv"))}
                for blocks in wqkv_grad_blocks(e, cfg)]

    run = timed_training(engine, data, s["warmup"], s["steps"], kv_norms)
    row = training_row("train_mistral", cfg, run, B, S, s["steps"])
    del engine
    kv = run["first"]
    check(all(math.isfinite(v) and v > 0 for layer in kv for v in layer.values()),
          f"train_mistral: a wk/wv gradient norm is not finite and positive: {kv}")
    row["first_step_vs_xla"] = first_step_vs_xla("train_mistral", cfg, init_params, data,
                                                 run["losses"][0], run["grad_norm0"])
    del init_params
    emit({"phase": "train_mistral", "model": f"Mistral 7B shape, {cfg.num_layers} of 32 layers",
          "window": cfg.uniform_window, **row, "first_step_wk_wv_grad_norms": kv,
          "phase_s": time.perf_counter() - t_phase, "card": card})
    torch.cuda.empty_cache()
    return run["counts"]


def family_train_config(entry):
    """A family's published config as its policy maps it, cut to
    FAMILY_TRAIN's depth (GPT-Neo's per-layer windows with it), in bf16."""
    from deepspeed_tpu_torch.module_inject import load_checkpoint as lc
    from deepspeed_tpu_torch.module_inject import policies

    cfg = policies.config_from_hf(lc.HFConfig(entry["config"]))
    L = FAMILY_TRAIN["layers"]
    over = {"num_layers": L, "dtype": "bfloat16"}
    if cfg.local_attn_windows is not None:
        over["local_attn_windows"] = tuple(cfg.local_attn_windows[:L])
    return dataclasses.replace(cfg, **over)


def train_families_phase(gen, card):
    """Each of ``HF_FAMILIES`` at its published widths (its policy's
    config: the masked path, as the policies convert them), 2 layers, bf16,
    AdamW: 1 warm-up and 8 timed steps on one fixed B 4 x S 512 batch, the
    launches a step by the family's norm count (K1-K3 none); then one f32
    step (TF32 off) at B 1 x S 128 on the card against the same step on the
    CPU, every gradient leaf within F32_GRAD_REL_TOL of its max and the loss
    within NORM_MODEL_LOSS_TOL. Returns the timed steps' launch counts."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tf

    t_phase = time.perf_counter()
    s = FAMILY_TRAIN
    B, S = s["batch"], s["seq"]
    total, rows = {}, {}
    for family, entry in HF_FAMILIES.items():
        t0 = time.perf_counter()
        cfg = family_train_config(entry)
        engine = deepspeed_tpu_torch.initialize(model=tf.TransformerModel(cfg),
                                                config=train_config(B), device="cuda")[0]
        init_params = tf.map_params(lambda p: p.detach().to("cpu", copy=True),
                                    engine.master_params)
        data = {"input_ids": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                           device="cuda")}
        name = family.split(",")[0] + (" post-LN" if cfg.norm_position == "post" else "")
        run = timed_training(engine, data, s["warmup"], s["steps"])
        row = training_row(f"train_families {name}", cfg, run, B, S, s["steps"])
        del engine
        for k, c in run["counts"].items():
            total[k] = total.get(k, 0) + c
        f32_cfg = dataclasses.replace(cfg, dtype="float32")
        f32_data = data["input_ids"][:s["f32_batch"], :s["f32_seq"]]
        torch.cuda.empty_cache()
        with relu_branches() as card_relu:
            loss_c, grads_c, _ = f32_step(f32_cfg, init_params, f32_data, "cuda")
        # the CPU takes the card's branch at a relu input that straddles 0
        with relu_branches(card_relu) as kinks:
            loss_h, grads_h, _ = f32_step(f32_cfg, init_params, f32_data.cpu(), "cpu")
        del card_relu
        rel = leaf_rel(grads_c, grads_h)
        worst = max(rel, key=rel.get)
        check(rel[worst] <= F32_GRAD_REL_TOL and abs(loss_c - loss_h) <= NORM_MODEL_LOSS_TOL
              and kinks["straddle_max_abs"] <= RELU_KINK_TOL,
              f"train_families {name} f32: card vs CPU: loss {loss_c} vs {loss_h}, worst leaf "
              f"{worst} at {rel[worst]} of its max |grad|, {kinks['straddles']} relu inputs "
              f"straddling 0 up to {kinks['straddle_max_abs']}")
        rows[family] = {
            "variant": entry["variant"], **row,
            "pos_embedding": cfg.pos_embedding, "norm_position": cfg.norm_position,
            "parallel_residual": cfg.parallel_residual, "shared_ln": cfg.shared_ln,
            "embed_norm": cfg.embed_norm, "rope_dim": cfg.rope_dim,
            "rope_interleaved": cfg.rope_interleaved, "lm_head_bias": cfg.lm_head_bias,
            "local_attn_windows": cfg.local_attn_windows, "attn_scale": cfg.attn_scale,
            "activation": cfg.activation,
            "f32_card_vs_cpu": {
                "batch": s["f32_batch"], "seq": s["f32_seq"], "loss_card": loss_c,
                "loss_cpu": loss_h, "loss_abs_diff": abs(loss_c - loss_h),
                "loss_tol": NORM_MODEL_LOSS_TOL, "leaves": len(rel), "worst_leaf": worst,
                "worst_rel": rel[worst], "rel_tol": F32_GRAD_REL_TOL,
                "relu_straddles": kinks["straddles"],
                "relu_straddle_max_abs": kinks["straddle_max_abs"],
                "relu_kink_tol": RELU_KINK_TOL},
            "family_s": time.perf_counter() - t0}
        del init_params, grads_c, grads_h
        torch.cuda.empty_cache()
    emit({"phase": "train_families", "families": rows,
          "launches": {k: total.get(k, 0) for k in STEP_KERNELS},
          "phase_s": time.perf_counter() - t_phase, "card": card})
    return total


def hf_finetune_phase(gen, card):
    """A fine-tune from an HF directory and back out to one: Llama 2 7B's
    layout at 2 layers (``LLAMA2_7B_CONFIG``, ``num_hidden_layers`` 2,
    random bf16 weights) written as two safetensors shards by
    ``write_hf_shards``; ``convert_hf_checkpoint`` -> ``initialize(params=)``
    (bf16) -> 3 steps on one B 4 x S 1024 batch -> ``save_hf_checkpoint``
    -> ``init_inference`` from that directory. Checks: the exported tensors
    equal the engine's bf16 params bit for bit; the served greedy stream (B
    8 x 128 + 32) equals ``generate`` of an engine built directly from the
    trained params bit for bit; the launches (K1-K3 2 and K7/K8 5 a step;
    K1 2 and K7 5 a forward of each ``generate``). Prints the write, load
    and export seconds. Counts from 0 over the whole path; returns them."""
    import shutil
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.module_inject import export
    from deepspeed_tpu_torch.module_inject import load_checkpoint as lc
    from deepspeed_tpu_torch.module_inject import policies
    from deepspeed_tpu_torch.ops import op_builder

    t_phase = time.perf_counter()
    s = FINETUNE
    hf_config = dict(LLAMA2_7B_CONFIG, num_hidden_layers=s["layers"])
    cfg0 = dataclasses.replace(policies.config_from_hf(lc.HFConfig(hf_config)),
                               dtype="bfloat16")
    base = tf.map_params(lambda p: p.to(torch.bfloat16), tf.init(gen, cfg0))
    root = checkpoint_dir_root()
    op_builder.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="hf_finetune_", dir=root) as d:
        src, out = os.path.join(d, "base"), os.path.join(d, "finetuned")
        os.makedirs(src)
        t0 = time.perf_counter()
        written = write_hf_shards(src, export.export_hf_state_dict(base, cfg0, "llama"),
                                  hf_config)
        write_s = time.perf_counter() - t0
        del base
        t0 = time.perf_counter()
        cfg, tree = lc.convert_hf_checkpoint(src)
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
        engine = deepspeed_tpu_torch.initialize(model=tf.TransformerModel(cfg), params=tree,
                                                config=train_config(s["batch"]),
                                                device="cuda")[0]
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        del tree
        check(cfg == cfg0, f"hf_finetune: the converted config {cfg} differs from {cfg0}")
        data = {"input_ids": torch.randint(0, cfg.vocab_size, (s["batch"], s["seq"]),
                                           generator=gen, device="cuda")}
        before = op_builder.launch_counts()
        losses = [float(engine_step(engine, data)[0]) for _ in range(s["steps"])]
        torch.cuda.synchronize()
        train_counts = {k: op_builder.launch_counts()[k] - before[k] for k in STEP_KERNELS}
        rule = step_launch_rule(cfg)
        check(train_counts == {k: c * s["steps"] for k, c in rule.items()},
              f"hf_finetune: {s['steps']} steps launched {train_counts}, expected {rule} a step")
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"hf_finetune: losses {losses} not finite or not falling")
        t0 = time.perf_counter()
        export.save_hf_checkpoint(out, engine.params, cfg, "llama",
                                  hf_config=lc.HFConfig(hf_config))
        export_s = time.perf_counter() - t0
        saved = torch.load(os.path.join(out, "pytorch_model.bin"), map_location="cpu")
        want = export.export_hf_state_dict(engine.params, cfg, "llama")
        exact = (sorted(saved) == sorted(want)
                 and all(torch.equal(saved[k].to(torch.bfloat16), want[k].cpu())
                         and torch.equal(saved[k], want[k].cpu().float()) for k in want))
        check(exact, "hf_finetune: the exported tensors differ from the engine's bf16 params")
        del saved, want
        t0 = time.perf_counter()
        served = deepspeed_tpu_torch.init_inference(out, config={"dtype": "bfloat16"},
                                                    device="cuda")
        torch.cuda.synchronize()
        serve_load_s = time.perf_counter() - t0
    direct = deepspeed_tpu_torch.init_inference(tf.TransformerModel(cfg),
                                                config={"dtype": "bfloat16"},
                                                params=engine.params, device="cuda")
    del engine
    check(served.cfg == direct.cfg,
          f"hf_finetune: the served config {served.cfg} differs from {direct.cfg}")
    toks = torch.randint(0, cfg.vocab_size, (s["serve_batch"], s["prompt"]), generator=gen,
                         device="cuda")
    before = op_builder.launch_counts()
    got = served.generate(toks, max_new_tokens=s["new"])
    want = direct.generate(toks, max_new_tokens=s["new"])
    torch.cuda.synchronize()
    serve_counts = {k: op_builder.launch_counts()[k] - before[k] for k in STEP_KERNELS}
    L = cfg.num_layers
    serve_rule = {"flash_fwd": 2 * L, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                  "fused_norm_fwd": 2 * norms_per_forward(cfg) * s["new"], "fused_norm_bwd": 0}
    check(serve_counts == serve_rule,
          f"hf_finetune: two generates launched {serve_counts}, expected {serve_rule}")
    same = torch.equal(got, want)
    check(same and tuple(got.shape) == (s["serve_batch"], s["prompt"] + s["new"]),
          "hf_finetune: the stream served from the exported directory differs from the "
          "trained engine's")
    counts = op_builder.launch_counts()
    emit({"phase": "hf_finetune", "model": f"meta-llama/Llama-2-7b-hf layout, {L} layers",
          "params": cfg.num_params(), "checkpoint_tensor_bytes": written, "checkpoint_root": root,
          "write_s": write_s, "load_s": load_s, "export_s": export_s,
          "serve_load_s": serve_load_s, "train_batch": s["batch"], "train_seq": s["seq"],
          "losses": losses, "export_equal_to_params": exact,
          "serve_batch": s["serve_batch"], "prompt": s["prompt"], "new_tokens": s["new"],
          "served_stream_equal_to_direct": same,
          "train_launches": train_counts, "train_launch_rule_per_step": rule,
          "serve_launches": serve_counts, "serve_launch_rule": serve_rule,
          "phase_s": time.perf_counter() - t_phase, "card": card})
    del served, direct
    torch.cuda.empty_cache()
    return counts


# train_zero: ZeRO stages through the port's comm on NCCL (one rank a card)
ZERO_GPT2 = {"batch": 8, "seq": 1024, "steps": 5}
ZERO_LLAMA = {"layers": 2, "batch": 1, "seq": 4096, "steps": 3}


def facade_collectives(comm, world):
    """Each collective of the comm facade on CUDA f32 and bf16 tensors: its
    answer against what ``world`` ranks holding the same tensor would get
    (every rank here holds ``x``), bit for bit."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.arange(world * 4 * 8, device="cuda", dtype=torch.float32) % 7 + 1
             ).reshape(world * 4, 8).to(dtype)
        n = float(world)
        want = {
            "all_reduce_sum": (comm.all_reduce(x, comm.ReduceOp.SUM), x * n),
            "all_reduce_avg": (comm.all_reduce(x, comm.ReduceOp.AVG), x * n / n),
            "all_reduce_max": (comm.all_reduce(x, comm.ReduceOp.MAX), x),
            "all_reduce_min": (comm.all_reduce(x, comm.ReduceOp.MIN), x),
            "all_reduce_prod": (comm.all_reduce(x, comm.ReduceOp.PROD), x ** world),
            "all_gather": (comm.all_gather(x, axis=1), torch.cat([x] * world, 1)),
            "all_gather_stacked": (comm.all_gather(x, tiled=False), torch.stack([x] * world)),
            "reduce_scatter": (comm.reduce_scatter(x, scatter_dimension=0),
                               (x * n).chunk(world, 0)[comm.get_rank()]),
            "all_to_all": (comm.all_to_all(x, "fsdp", split_axis=0, concat_axis=1),
                           torch.cat(x.chunk(world, 0), 1)),
            "broadcast": (comm.broadcast(x, src=0), x),
        }
        for name, (got, ref) in want.items():
            ok = got.dtype == dtype and got.is_cuda and torch.equal(got, ref.to(dtype))
            check(ok, f"train_zero: {name} on CUDA {dtype} differs from its answer")
            out[f"{name}_{str(dtype).removeprefix('torch.')}"] = ok
    return out


def nccl_kernels(e, data):
    """One step under the profiler: the NCCL calls the host made (c10d's
    ``nccl:*`` ranges) and the NCCL kernels the card ran, with their device
    seconds. With one rank NCCL runs an in-place reduction as no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine_step(e, data)
        torch.cuda.synchronize()
    calls = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU and ev.name().startswith("nccl:"):
            calls[ev.name()] = calls.get(ev.name(), 0) + 1
    tk = [(k, t, n) for k, t, n in device_kernels(prof) if "nccl" in k.lower()]
    return {"host_calls": calls, "kernel_launches": sum(n for _, _, n in tk),
            "kernel_device_s": sum(t for _, t, _ in tk), "kernels": sorted({k[:60] for k, _, _ in tk})}


def zero_run(model, stage, data, steps, counts, profile_nccl=False):
    """An engine at ZeRO ``stage`` on ``{fsdp: -1}``, ``steps`` steps on one
    batch: the losses (as their f32 bits), the step ms, the peak memory of
    the start-up and of the steps, the launch counts (added to ``counts``)
    and the gathered final params (on the card)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.ops import op_builder

    conf = dict(train_config(data["input_ids"].shape[0]), mesh={"fsdp": -1},
                zero_optimization={"stage": stage, "stage3_param_persistence_threshold": 0})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e = deepspeed_tpu_torch.initialize(model=model, config=conf, device="cuda", seed=0)[0]
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    op_builder.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = engine_step(e, data)[0]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    for k, c in op_builder.launch_counts().items():
        counts[k] = counts.get(k, 0) + c
    row = {"stage": stage, "mesh": e.mesh.shape if e.mesh is not None else None,
           "losses": [float(x) for x in losses],
           "step_ms": step_ms, "step_ms_median_after_first": statistics.median(step_ms[1:]),
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "init_peak_allocated_bytes": init_peak,
           "master_elems_on_rank": sum(t.numel() for t in e._base_leaves),
           "launches": op_builder.launch_counts()}
    final = e.gathered_params()
    if profile_nccl:  # a sixth step, after the final params are taken
        row["nccl_one_step"] = nccl_kernels(e, data)
    loss_bits = torch.stack(losses).view(torch.int32).cpu()
    del e
    torch.cuda.empty_cache()
    return row, loss_bits, final


def same_bits(a, b):
    """Whether two param trees hold the same leaves (by name), bit for bit."""
    la, lb = dict(named_leaves(a)), dict(named_leaves(b))
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)


def train_zero_phase(gen, card):
    """ZeRO through the port's comm on NCCL, one rank a card (one card here,
    so every placement is whole, as the reference places it at fsdp 1):
    the plain engine's GPT-2 125M steps (no process group) first; then the
    process group through ``comm.init_distributed`` on a ``file://`` store;
    each facade collective on CUDA f32 and bf16; GPT-2 125M (B8 S1024 bf16,
    flash, AdamW) at stages 0-3 on ``{fsdp: -1}``, 5 steps each, the loss
    streams and final params bit for bit equal across the stages and to the
    plain engine's, one step profiled for its NCCL kernels; Llama 2 7B's
    width at 2 layers (B1 S4096) at stage 3 against stage 0, 3 steps each,
    bit for bit. Returns the launch counts of the driven runs."""
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.comm import comms_logging
    from deepspeed_tpu_torch.models import transformer as tf

    t_phase = time.perf_counter()
    g, ll = ZERO_GPT2, ZERO_LLAMA
    gpt2 = tf.TransformerModel.from_preset("gpt2-125m", dtype="bfloat16", attn_impl="pallas")
    data = {"input_ids": torch.randint(0, 50257, (g["batch"], g["seq"]), generator=gen,
                                       device="cuda")}
    counts = {}
    plain, plain_bits, plain_final = zero_run(gpt2, 0, data, g["steps"], {})
    check(not comm.has_process_group(), "train_zero: a process group before init_distributed")
    world = torch.cuda.device_count()
    store = tempfile.mkdtemp(prefix="dstorch_zero_")
    mesh = deepspeed_tpu_torch.init_distributed(mesh_shape={"fsdp": -1}, device="cuda",
                                                init_method=f"file://{store}/store", rank=0,
                                                world_size=1, enable_comms_logging=True)
    try:
        import torch.distributed as dist

        backend = dist.get_backend()
        check(backend == "nccl", f"train_zero: the process group runs {backend}, not nccl")
        collectives = facade_collectives(comm, comm.get_world_size())
        logged = comm.get_comms_logger().summary()
        check(logged.get("all_reduce", {}).get("count") == 10
              and logged["all_reduce"]["total_bytes"] == 5 * 32 * world * (4 + 2),
              f"train_zero: the comms log counted {logged.get('all_reduce')}")
        rows, finals = [], {}
        for stage in range(4):
            row, bits, final = zero_run(gpt2, stage, data, g["steps"], counts,
                                        profile_nccl=stage == 3)
            check(torch.equal(bits, plain_bits) and same_bits(final, plain_final),
                  f"train_zero gpt2 stage {stage}: the loss stream or the final params differ "
                  f"from the plain engine's ({row['losses']} vs {plain['losses']})")
            check(row["launches"].get("flash_fwd") == 12 * g["steps"]
                  and row["launches"].get("flash_bwd_dkv") == 12 * g["steps"],
                  f"train_zero gpt2 stage {stage}: K1-K3 launches {row['launches']}")
            rows.append(row)
            del final
        check(sum(rows[-1]["nccl_one_step"]["host_calls"].values()) > 0,
              f"train_zero: the profiler saw no NCCL call in a step ({rows[-1]['nccl_one_step']})")
        del plain_final
        llama = tf.TransformerModel.from_preset("llama2-7b", dtype="bfloat16",
                                                attn_impl="pallas", num_layers=ll["layers"])
        ldata = {"input_ids": torch.randint(0, 32000, (ll["batch"], ll["seq"]), generator=gen,
                                            device="cuda")}
        l0, l0_bits, l0_final = zero_run(llama, 0, ldata, ll["steps"], counts)
        l3, l3_bits, l3_final = zero_run(llama, 3, ldata, ll["steps"], counts)
        check(torch.equal(l0_bits, l3_bits) and same_bits(l0_final, l3_final),
              f"train_zero llama: stage 3 differs from stage 0 ({l3['losses']} vs {l0['losses']})")
        del l0_final, l3_final
        emit({"phase": "train_zero", "world": comm.get_world_size(), "backend": backend,
              "mesh": mesh.shape, "device_mesh": str(mesh.device_mesh),
              "collectives": collectives, "comms_log": comm.get_comms_logger().summary(),
              "msg_bytes_f32_4x8": comms_logging.get_msg_size(torch.zeros(4, 8)),
              "gpt2_125m": {"batch": g["batch"], "seq": g["seq"], "plain_engine": plain,
                            "stages": rows},
              "llama2_7b_width": {"layers": ll["layers"], "batch": ll["batch"],
                                  "seq": ll["seq"], "stage0": l0, "stage3": l3},
              "phase_s": time.perf_counter() - t_phase, "card": card})
    finally:
        comm.destroy()
    check(not comm.has_process_group(), "train_zero: the process group outlived destroy()")
    torch.cuda.empty_cache()
    return counts


def train_zero_main():
    """``python3 chip_smoke.py --train-zero``: the ``train_zero`` phase alone
    (no ``kernels`` line)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_norm as fnorm

    card = smi_card()
    build_all([fa.KERNEL_LIB, fa.BWD_KERNEL_LIB, fnorm.KERNEL_LIB])
    train_zero_phase(torch.Generator(device="cuda").manual_seed(0), card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
    return 1 if failures else 0


# ---------------------------------------------------------------------------
# serve_mesh: the tensor-parallel serving mesh
# ---------------------------------------------------------------------------

# Llama 2 7B's published width at 4 of its 32 layers (D 4096, 32 heads of
# 128, SwiGLU 11008, vocab 32000, which splits over 2), B 8 x 512 + 64 bf16
MESH_LLAMA = {"layers": 4, "batch": 8, "prompt": 512, "new": 64}
# the streams of tensor 2 against world 1's: equal, or first differing where
# world 1's top-2 margin is under this (the row-parallel sums run in another
# order in bf16)
MESH_TIE = 0.2
# tensor 2's prefill logits (bf16) against f32 logits on the same bf16
# weights: at most this many times world 1's own bf16 error there; and at
# every step the token tensor 2 chose is within that limit of world 1's best
# on the same prefix. Each bf16 forward rounds its activations and sums in
# its own order; a wrong head, cache or vocabulary split moves the logits by
# their spread (a std of about 1 here) instead
MESH_NOISE_FACTOR = 2.0
MESH_RANKS_TIMEOUT_S = 300


def mesh_llama_model():
    from deepspeed_tpu_torch.models import transformer as tf

    return tf.TransformerModel.from_preset("llama2-7b", dtype="bfloat16", attn_impl="pallas",
                                           num_layers=MESH_LLAMA["layers"])


def mesh_llama_config(extra=None):
    return {"dtype": "bfloat16", "attn_impl": "pallas", **(extra or {})}


def read_trace(path):
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def serve_mesh_rank(rank, world, store, out_dir, prompt, new):
    """One rank of ``serve_mesh`` (b): a gloo process group over the ranks
    sharing card 0; rank 0 builds the Llama engine on ``{"data": 1,
    "tensor": world}`` from the seed, generates, then takes the prefill's
    logits (``forward``); every other rank serves as
    ``inference.mesh.serve_worker``. Each rank holds every K1 call's output
    against the plain attention on the same q, k and v, and writes its K1
    calls (the query heads and max |Δ| of each), its launch counts, its
    peak card memory and the foreign modules it imported to ``out_dir``."""
    import datetime
    import pickle

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference import mesh as mesh_mod
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import op_builder

    out = {}
    torch.cuda.set_device(0)
    k1, real = [], tf.flash_attention

    def recording(q, k, v, **kw):
        o = real(q, k, v, **kw)
        want = fa.mha_reference(q, k, v, causal=kw.get("causal", True),
                                sm_scale=kw.get("sm_scale"), window=kw.get("window"))
        k1.append((int(q.shape[2]), float((o.float() - want.float()).abs().max())))
        return o

    tf.flash_attention = recording
    try:
        comm.init_distributed(device="cuda:0", init_method=f"file://{store}", rank=rank,
                              world_size=world, dist_backend="gloo",
                              timeout=datetime.timedelta(seconds=MESH_RANKS_TIMEOUT_S),
                              verbose=False)
        torch.cuda.reset_peak_memory_stats()
        op_builder.reset_launch_counts()
        if rank == 0:
            trace = os.path.join(out_dir, "mesh_trace.jsonl")
            try:
                eng = deepspeed_tpu_torch.init_inference(
                    mesh_llama_model(), seed=0, config=mesh_llama_config({
                        "mesh": {"shape": {"data": 1, "tensor": world}},
                        "telemetry": {"enabled": True, "trace_file": trace}}))
                out["shard"] = [eng.shard.attn, eng.shard.mlp, eng.shard.embed, eng.shard.head]
                out["kv_shard_width"] = eng.kv_shard_width
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out["tokens"] = eng.generate(torch.from_numpy(prompt).cuda(),
                                             max_new_tokens=new).cpu().numpy()
                out["generate_s"] = time.perf_counter() - t0
                out["events"] = [e for e in read_trace(trace)
                                 if e.get("kind") == "inference_request"]
                out["last_logits"] = eng.forward(
                    torch.from_numpy(prompt).cuda())[:, -1].float().cpu()
            finally:
                mesh_mod.shutdown()
        else:
            out["ops"] = mesh_mod.serve_worker("cuda:0")
        torch.cuda.synchronize()
        out.update(launches=op_builder.launch_counts(), k1=k1,
                   peak_allocated_bytes=torch.cuda.max_memory_allocated())
    except Exception as e:  # reported by the parent, as a failed check
        out["error"] = f"{type(e).__name__}: {e}"
    finally:
        comm.destroy()
    out["foreign_modules"] = sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "deepspeed_tpu"))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def spawn_ranks(target, world, *args):
    """``target(rank, world, store, out_dir, *args)`` on ``world`` spawned
    processes sharing this card, each leaving its result in
    ``out_dir/rank<r>.pkl``; the results in rank order (a rank that left
    none reports why)."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="dstorch_ranks_")
    ctx = mp.start_processes(target, args=(world, os.path.join(out_dir, "store"), out_dir, *args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.perf_counter() + MESH_RANKS_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"the {world} ranks ran past {MESH_RANKS_TIMEOUT_S} s")
    except Exception as e:  # a rank that died or hung: stop them all
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        return [{"error": f"{type(e).__name__}: {e}"}] * world
    results = []
    for rank in range(world):
        path = os.path.join(out_dir, f"rank{rank}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as fh:
                results.append(pickle.load(fh))
        else:
            results.append({"error": "the rank left no result"})
    return results


def serve_mesh_phase(gen, card):
    """The serving mesh (``config.mesh``) on the card. (a) World 1 through
    NCCL (a process group of one on a ``file://`` store), the engines on
    ``{"data": 1, "tensor": 1}`` against the engines without a mesh: Llama
    2 7B's width at 4 layers (B 8 x 512 + 64 bf16, ``generate`` fused and
    per token) bit for bit, with the launches and device ms of a decode
    step each (the launches must be equal) and the NCCL kernels a step (0);
    GPT-2 125M's pool in ``bench_serving``'s geometry (16 of its requests)
    bit for bit; the serving layer's degrade ladder at 1x1 (a preemption
    that takes capacity at tick 4, 12 requests), its recovered streams bit
    for bit the fault-free run's. (b) Tensor 2 as two processes sharing the
    card over gloo (the collectives through the host), ``generate`` then
    ``forward``: each rank runs K1 at 16 query heads on each prefill, held
    against the plain attention on the same q, k and v, and K7 on every
    norm; the prefill's last logits are within MESH_NOISE_FACTOR times
    world 1's bf16 error of f32 logits on the same weights; the streams
    equal world 1's or first differ where world 1's top-2 margin is under
    MESH_TIE, and at every step the token chosen is within that same limit
    of world 1's best on the same prefix (world 1's median top-2 margin is
    reported); the per-chip ``kv_bytes_read`` is half of world 1's; each
    rank's peak card memory. (b) reports no speed: the ranks share a card
    and gloo copies through the host. Returns the launch counts of the
    driven runs (both ranks' of (b))."""
    import tempfile

    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.serving import RecoveryConfig, ServingEngine
    from deepspeed_tpu_torch.serving.faults import Fault, FaultInjector, FaultPlan
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    ml = MESH_LLAMA
    counts, row = {}, {"card": card}
    B, S, new = ml["batch"], ml["prompt"], ml["new"]
    prompt = torch.randint(0, 32000, (B, S), generator=gen, device="cuda")
    store = tempfile.mkdtemp(prefix="dstorch_mesh_")
    trace = os.path.join(store, "world1_trace.jsonl")
    plain = deepspeed_tpu_torch.init_inference(
        mesh_llama_model(), seed=0,
        config=mesh_llama_config({"telemetry": {"enabled": True, "trace_file": trace}}))
    plain_loop = deepspeed_tpu_torch.init_inference(
        mesh_llama_model(), params=plain.params,
        config=mesh_llama_config({"fused_generate": False}))
    want = {"fused": timed_generate(plain, prompt, new), "loop": timed_generate(plain_loop,
                                                                               prompt, new)}
    world1_kv = [e for e in read_trace(trace) if e.get("kind") == "inference_request"][-1]
    mesh = deepspeed_tpu_torch.init_distributed(device="cuda",
                                                init_method=f"file://{store}/store", rank=0,
                                                world_size=1)
    try:
        import torch.distributed as dist

        backend = dist.get_backend()
        check(backend == "nccl", f"serve_mesh (a): the process group runs {backend}, not nccl")
        one = {"mesh": {"shape": {"data": 1, "tensor": 1}}}
        meng = deepspeed_tpu_torch.init_inference(mesh_llama_model(), seed=0,
                                                  config=mesh_llama_config(one))
        meng_loop = deepspeed_tpu_torch.init_inference(
            mesh_llama_model(), seed=0, config=mesh_llama_config(dict(one, fused_generate=False)))
        check(meng.shard is None and meng.mesh.shape["tensor"] == 1,
              f"serve_mesh (a): the 1x1 engine holds a shard ({meng.shard})")
        got = {"fused": drive(counts, lambda: timed_generate(meng, prompt, new)),
               "loop": drive(counts, lambda: timed_generate(meng_loop, prompt, new))}
        a = {"world": comm.get_world_size(), "backend": backend, "mesh": mesh.shape}
        for path in ("fused", "loop"):
            same = torch.equal(got[path][0], want[path][0])
            check(same, f"serve_mesh (a): the 1x1 engine's {path} stream differs from the "
                        f"engine without a mesh")
            check(got[path][2] == want[path][2],
                  f"serve_mesh (a) {path}: launches {got[path][2]} against {want[path][2]}")
            a[f"llama_{path}"] = {"bit_for_bit": same, "wall_s": got[path][1],
                                  "plain_wall_s": want[path][1], "launches": got[path][2],
                                  "plain_launches": want[path][2]}
        toks = prompt[:, :128]
        # the engine without a mesh, without telemetry, as the 1x1 one runs;
        # each engine's kernels a step read three times in turns, and its
        # reading the one that at least two of the three give
        bare = deepspeed_tpu_torch.init_inference(mesh_llama_model(), params=plain.params,
                                                  config=mesh_llama_config())
        t_read = time.perf_counter()
        step_plain, step_mesh = decode_step_profile(bare, toks), decode_step_profile(meng, toks)
        engines = {"plain": bare, "mesh_1x1": meng}
        turns = [(name, step_launches(engines[name], toks))
                 for name in ("plain", "mesh_1x1", "mesh_1x1", "plain", "plain", "mesh_1x1")]
        launches = {}
        for name in engines:
            seen = [sorted(k.items()) for n, k in turns if n == name and k is not None]
            launches[name] = next((dict(s) for s in seen if seen.count(s) >= 2), None)
        totals = [(n, sum(k.values()) if k is not None else None) for n, k in turns]
        check(None not in launches.values() and launches["mesh_1x1"] == launches["plain"],
              f"serve_mesh (a): a decode step's kernels on the 1x1 mesh differ from the "
              f"engine's without one (launches a step in turns: {totals})")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            meng.generate(toks, max_new_tokens=4)
            torch.cuda.synchronize()
        nccl = [(k, t, n) for k, t, n in device_kernels(prof) if "nccl" in k.lower()]
        check(not nccl, f"serve_mesh (a): NCCL kernels on the 1x1 mesh ({nccl[:3]})")
        a.update(decode_step={"plain": step_plain, "mesh_1x1": step_mesh,
                              "launches_per_step": {n: sum(k.values()) if k else None
                                                    for n, k in launches.items()},
                              "launches_per_step_in_turns": totals,
                              "readings_s": time.perf_counter() - t_read},
                 nccl_kernels_per_4_step_generate=sum(n for _, _, n in nccl))
        del bare
        del meng, meng_loop, plain_loop

        # GPT-2 125M: the pool and the serving layer's degrade ladder at 1x1
        build = ServingBuild(gen)
        queue = build.queue[:16]
        streams = {}
        for name, extra in (("plain", None), ("mesh_1x1", one)):
            eng = build.engine(extra, warm=False, tokens_per_tick=SERVE_BURST)
            # only the mesh's runs count as its path's launches
            stats, results = (drive(counts, lambda: replay_schedule(eng, queue, 1)) if extra
                              else replay_schedule(eng, queue, 1))
            streams[name] = results
            a[f"gpt2_pool_{name}"] = {"tokens_per_s": stats["tokens_per_s"],
                                      "ticks": stats["ticks"]}
            del eng
        pool_same = all(x is not None and y is not None and np.array_equal(x, y)
                        for x, y in zip(streams["plain"], streams["mesh_1x1"]))
        check(pool_same, "serve_mesh (a): the 1x1 pool's streams differ from the pool's "
                         "without a mesh")
        a["gpt2_pool_bit_for_bit"] = pool_same
        ladder_queue = [(0, p, n) for _, p, n in build.queue[:12]]
        served = {}
        for faulted in (False, True):
            eng = build.engine(one, warm=False, tokens_per_tick=SERVE_BURST)
            kw = {}
            if faulted:
                eng.fault_hook = FaultInjector(FaultPlan([Fault(tick=4, kind="preempt",
                                                                degrade=True)]))
                kw = dict(engine_factory=lambda mesh_shape=None: build.engine(
                    {"mesh": {"shape": mesh_shape or one["mesh"]["shape"]}}, warm=False,
                    tokens_per_tick=SERVE_BURST),
                    degrade_mesh_shapes=[{"data": 1, "tensor": 1}],
                    recovery=RecoveryConfig(backoff_s=0.0))
            srv = ServingEngine(eng, clock=time.perf_counter, **kw)
            _, results = drive(counts, lambda: replay_schedule(srv, ladder_queue, 1))
            served[faulted] = (results, srv.recovery_stats())
            srv.close()
            del srv, eng
        stats = served[True][1]
        check(stats["rebuilds"] == 1 and stats["degrade_level"] == 1
              and stats["lost_requests"] == 0, f"serve_mesh (a): the degrade ladder's stats {stats}")
        # a re-admitted request prefills its emitted tokens, where the
        # fault-free run decoded them one by one: in bf16 the two round
        # apart, so a recovered stream is equal where the card gives it, or
        # first differs at a top-2 margin under the bf16 tie rule
        agree = []
        for (_, p, _), got, want_row in zip(ladder_queue, served[True][0], served[False][0]):
            check(got is not None and want_row is not None,
                  "serve_mesh (a): a request of the ladder did not finish")
            if got is None or want_row is None:
                continue

            def m(want_row=want_row, p=p):
                return top2_margins(teacher_forced_logits(
                    build.params, build.model.cfg, 128, p,
                    torch.from_numpy(np.asarray(want_row)[p.size:]).cuda()))

            agree.append(stream_agreement(np.asarray(got), np.asarray(want_row), p, m,
                                          "serve_mesh (a) degrade ladder"))
        a["degrade_ladder"] = {"requests": len(ladder_queue),
                               "bit_equal_to_fault_free": sum(e["equal"] for e in agree),
                               "differing": [e for e in agree if not e["equal"]],
                               "rebuilds": stats["rebuilds"],
                               "degrade_level": stats["degrade_level"],
                               "recovery_ms": stats.get("recovery_ms")}
        a["s"] = time.perf_counter() - t_phase
        row["a_world1_nccl"] = a
        del build
    finally:
        comm.destroy()
    torch.cuda.empty_cache()

    # world 1's prefill logits in bf16, and in f32 on the same (bf16) weights:
    # the bf16 error of one forward, which sets (b)'s limit
    with torch.inference_mode():
        last_bf16 = plain.forward(prompt)[:, -1].float()
        f32 = deepspeed_tpu_torch.init_inference(
            mesh_llama_model(), params=tf.map_params(lambda p: p.float(), plain.params),
            config=mesh_llama_config({"dtype": "float32"}))
        last_f32 = f32.forward(prompt)[:, -1].float()
        del f32
    torch.cuda.empty_cache()
    world1_err = float((last_bf16 - last_f32).abs().max())

    # (b) tensor 2: two processes on this card over gloo
    ranks = spawn_ranks(serve_mesh_rank, 2, prompt.cpu().numpy(), new)
    errors = [r.get("error") for r in ranks if r.get("error")]
    check(not errors, f"serve_mesh (b): a rank failed: {errors}")
    b = {"world": 2, "backend": "gloo (through the host)", "errors": errors}
    if not errors:
        L = ml["layers"]
        forwards = new + 1  # generate's prefill and new - 1 decode steps, then forward
        for rank, r in enumerate(ranks):
            launched = r["launches"]
            for k, c in launched.items():
                counts[k] = counts.get(k, 0) + c
            check(launched.get("flash_fwd") == 2 * L and launched.get("fused_norm_fwd")
                  == (2 * L + 1) * forwards and not launched.get("fused_norm_bwd"),
                  f"serve_mesh (b) rank {rank}: launches {launched}, the rule is K1 {2 * L} and "
                  f"K7 {(2 * L + 1) * forwards}")
            heads = sorted({h for h, _ in r["k1"]})
            k1_err = max(e for _, e in r["k1"])
            check(heads == [16], f"serve_mesh (b) rank {rank}: K1 ran at {heads} query heads, "
                                 f"not 16")
            check(k1_err <= K1_O_TOL[torch.bfloat16],
                  f"serve_mesh (b) rank {rank}: K1 at 16 heads against the plain attention: "
                  f"max |Δ| {k1_err} > {K1_O_TOL[torch.bfloat16]}")
            check(r["foreign_modules"] == [], f"serve_mesh (b) rank {rank} imported "
                                              f"{r['foreign_modules']}")
            b[f"rank{rank}"] = {"launches": launched, "k1_query_heads": heads,
                                "k1_calls": len(r["k1"]), "k1_max_abs_err": k1_err,
                                "k1_tol": K1_O_TOL[torch.bfloat16],
                                "peak_allocated_bytes": r["peak_allocated_bytes"],
                                **({"worker_ops": r["ops"]} if "ops" in r else {})}
        r0 = ranks[0]
        b["shard"] = r0["shard"]
        ev = r0["events"][-1]
        check(ev["kv_bytes_read"] * 2 == world1_kv["kv_bytes_read"],
              f"serve_mesh (b): per-chip kv bytes {ev['kv_bytes_read']} against world 1's "
              f"{world1_kv['kv_bytes_read']}")
        b["kv_bytes_read_per_chip"] = ev["kv_bytes_read"]
        b["kv_bytes_read_world1"] = world1_kv["kv_bytes_read"]
        # the prefill's logits: tensor 2 as near the f32 logits as world 1
        last_mesh = r0["last_logits"].cuda()
        mesh_err = float((last_mesh - last_f32).abs().max())
        limit = MESH_NOISE_FACTOR * world1_err
        check(mesh_err <= limit, f"serve_mesh (b): prefill logits against f32: max |Δ| "
                                 f"{mesh_err} > {MESH_NOISE_FACTOR} x world 1's {world1_err}")
        b["prefill_logits"] = {"max_abs_err_vs_f32": mesh_err,
                               "world1_max_abs_err_vs_f32": world1_err, "limit": limit,
                               "max_abs_diff_vs_world1": float((last_mesh - last_bf16).abs().max()),
                               "world1_logits_std": float(last_bf16.std())}
        # the streams: world 1's logits teacher-forced along each row of
        # tensor 2's stream give, at every step, world 1's top-2 margin and
        # how far tensor 2's token sits below world 1's best
        world1 = want["fused"][0].cpu().numpy()
        rows_cmp, margins, gaps = [], [], []
        for i in range(B):
            got_row, want_row = r0["tokens"][i], world1[i]
            mine = torch.from_numpy(got_row[S:]).cuda()
            lg = teacher_forced_logits(plain.params, plain.cfg, plain.config.kv_read_floor,
                                       prompt[i].cpu().numpy(), mine)
            margin, gap = top2_margins(lg), (lg.max(-1).values
                                             - lg.gather(-1, mine[:, None].long())[:, 0]).cpu()
            margins.append(margin)
            gaps.append(gap)
            entry = {"equal": bool(np.array_equal(got_row, want_row)), "max_gap": float(gap.max())}
            if not entry["equal"]:
                j = int(np.nonzero(got_row[S:] != want_row[S:])[0][0])
                entry.update(first_diff_step=j, margin=float(margin[j]))
                check(float(margin[j]) < MESH_TIE, f"serve_mesh (b) row {i}: differs from world 1 "
                                                   f"at step {j}, margin {float(margin[j])} >= "
                                                   f"{MESH_TIE}")
            check(float(gap.max()) <= limit, f"serve_mesh (b) row {i}: a token "
                                             f"{float(gap.max())} below world 1's best > {limit}")
            rows_cmp.append(entry)
        b["streams_vs_world1"] = rows_cmp
        b["rows_equal"] = sum(e["equal"] for e in rows_cmp)
        b["world1_top2_margin_median"] = float(torch.cat(margins).median())
        b["token_gap_max"] = float(torch.cat(gaps).max())
        b["token_gap_steps_nonzero"] = int((torch.cat(gaps) > 0).sum())
    row["b_tensor2_gloo"] = b
    del plain
    torch.cuda.empty_cache()
    emit({"phase": "serve_mesh", "model": "llama2-7b width (4 layers) and gpt2-125m",
          "llama": ml, **row, "phase_s": time.perf_counter() - t_phase})
    return counts


def serve_mesh_main():
    """``python3 chip_smoke.py --serve-mesh``: the ``serve_mesh`` phase alone
    (no ``kernels`` line)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_norm as fnorm

    card = smi_card()
    build_all([fa.KERNEL_LIB, fnorm.KERNEL_LIB])
    serve_mesh_phase(torch.Generator(device="cuda").manual_seed(0), card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
    return 1 if failures else 0


# ---------------------------------------------------------------------------
# train_zero_ckpt: ZeRO-sharded checkpoints of a split engine
# ---------------------------------------------------------------------------

# GPT-2 125M (the train phases' B8 S1024 bf16, flash, AdamW) at stage 3 on
# {fsdp: 2}: two processes sharing the card over gloo, 4 rows a rank; the tag
# taken after SAVE_AT of STEPS steps
ZERO_CKPT = {"world": 2, "batch": 8, "seq": 1024, "save_at": 3, "steps": 5}
# K1 on the model's own q, k and v against the plain attention, both rounded
# to bf16: within one bf16 unit of the largest output (K1_O_TOL's 3e-2 is an
# absolute bound for outputs under 4; a layer's outputs here reach 4-8,
# where one unit is 2^-5)
K1_REL_TOL_BF16 = 2.0 ** -7


def zero_ckpt_data(V):
    """The global batches every rank (and the parent) draws alike."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    z = ZERO_CKPT
    return [{"input_ids": torch.randint(0, V, (z["batch"], z["seq"]), generator=gen,
                                        device="cuda")} for _ in range(z["steps"])]


def zero_ckpt_config(stage, async_save=False):
    z = ZERO_CKPT
    return dict(train_config(z["batch"] // z["world"]), mesh={"fsdp": z["world"]},
                zero_optimization={"stage": stage, "stage3_param_persistence_threshold": 0},
                checkpoint={"async_save": async_save})


def rss_rise(fn):
    """``(fn(), the resident set before, its highest rise while fn ran)``:
    VmRSS sampled every 2 ms on a thread of its own (the process's peak
    from getrusage would hide a rise below an earlier peak)."""
    import threading

    before, top, done = rss_bytes(), [0], threading.Event()

    def sample():
        while not done.is_set():
            top[0] = max(top[0], rss_bytes())
            done.wait(0.002)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        got = fn()
    finally:
        done.set()
        thread.join()
    return got, before, max(top[0], rss_bytes()) - before


def zero_ckpt_rank(rank, world, store, out_dir, root):
    """One rank of ``train_zero_ckpt`` (a): a gloo process group over the
    ranks sharing card 0. Run A (seed 0) takes SAVE_AT steps, saves (sync),
    and takes the rest: the uninterrupted stream. Run B (seed 1, the async
    engine) loads that tag, saves it again (async) and takes the same last
    steps while its writer writes, then fences. Each rank reports its loss
    bits, its state's per-leaf checksums after each run and after the load,
    the saves' and the load's seconds, its steps' ms, its host peak RSS
    around each save, its launch counts, its first step's K1 calls held
    against the plain attention, and the foreign modules it imported."""
    import datetime
    import pickle

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.runtime.checkpoint_engine import integrity

    z, out = ZERO_CKPT, {}
    torch.cuda.set_device(0)
    k1, real = [], tf.flash_attention

    def recording(q, k, v, **kw):
        o = real(q, k, v, **kw)
        if len(k1) < 12:  # the first step's forward
            with torch.no_grad():
                want = fa.mha_reference(q, k, v, causal=kw.get("causal", True),
                                        sm_scale=kw.get("sm_scale"), window=kw.get("window"))
                k1.append((tuple(q.shape), float((o.float() - want.float()).abs().max()),
                           float(want.float().abs().max())))
        return o

    def checksums(e):
        """Each gathered param leaf's checksum (the state's other leaves
        are held to the tag in (b) and by the CPU tests)."""
        return integrity.manifest_from_leaves(named_leaves(e.gathered_params()))["leaves"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    def train(e, batches, ms=None):
        bits = []
        for batch in batches:
            loss, dt = timed(lambda: engine_step(e, batch)[0])
            bits.append(int(loss.float().view(torch.int32).item()))
            if ms is not None:
                ms.append(dt * 1e3)
        return bits

    tf.flash_attention = recording
    try:
        comm.init_distributed(mesh_shape={"fsdp": world}, device="cuda:0",
                              init_method=f"file://{store}", rank=rank, world_size=world,
                              dist_backend="gloo",
                              timeout=datetime.timedelta(seconds=MESH_RANKS_TIMEOUT_S),
                              verbose=False)
        model = tf.TransformerModel.from_preset("gpt2-125m", dtype="bfloat16", attn_impl="pallas")
        data = zero_ckpt_data(model.cfg.vocab_size)
        sync_dir, async_dir = os.path.join(root, "sync"), os.path.join(root, "async")
        at = z["save_at"]
        torch.cuda.reset_peak_memory_stats()
        op_builder.reset_launch_counts()
        a = deepspeed_tpu_torch.initialize(model=model, config=zero_ckpt_config(3), seed=0)[0]
        out["step_ms"] = []
        out["losses_a"] = train(a, data[:at], out["step_ms"])
        (_, out["sync_save_s"]), out["sync_rss_before"], out["sync_peak_rise"] = rss_rise(
            lambda: timed(lambda: a.save_checkpoint(sync_dir)))
        out["losses_a"] += train(a, data[at:], out["step_ms"])
        out["final_a"] = checksums(a)
        del a
        b = deepspeed_tpu_torch.initialize(model=model, config=zero_ckpt_config(3, True),
                                           seed=1)[0]
        _, out["load_s"] = timed(lambda: b.load_checkpoint(sync_dir))
        (_, out["async_blocked_s"]), out["async_rss_before"], out["async_peak_rise"] = rss_rise(
            lambda: timed(lambda: b.save_checkpoint(async_dir)))
        out["losses_b"], out["async_steps_s"] = timed(lambda: train(b, data[at:]))
        _, out["async_fence_s"] = timed(b.checkpoint_engine.wait)
        out["final_b"] = checksums(b)
        del b
        if rank == 0:
            import filecmp

            tag = f"global_step{at}"
            files = sorted(os.path.relpath(os.path.join(d, f), os.path.join(sync_dir, tag))
                           for d, _, fs in os.walk(os.path.join(sync_dir, tag)) for f in fs)
            out["tag_files"] = len(files)
            out["tag_bytes"] = tag_bytes(os.path.join(sync_dir, tag))
            out["async_tag_same_bytes"] = all(
                filecmp.cmp(os.path.join(sync_dir, tag, f), os.path.join(async_dir, tag, f),
                            shallow=False) for f in files)
        torch.cuda.synchronize()
        out.update(launches=op_builder.launch_counts(), k1=k1,
                   peak_allocated_bytes=torch.cuda.max_memory_allocated())
    except Exception as e:  # reported by the parent, as a failed check
        import traceback

        out["error"] = f"{type(e).__name__}: {e} {traceback.format_exc()[-1500:]}"
    finally:
        comm.destroy()
    out["foreign_modules"] = sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("jax", "jaxlib", "deepspeed_tpu"))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def train_zero_ckpt_phase(gen, card):
    """ZeRO-sharded checkpoints on the card. (a) Two processes share the
    card over gloo (NCCL refuses two ranks on one GPU): GPT-2 125M (B8
    S1024 bf16, flash, AdamW) at stage 3 on ``{fsdp: 2}`` (``zero_ckpt_rank``):
    the resumed stream and state equal the uninterrupted run's bit for bit,
    the loaded state is the tag's, the async tag's bytes are the sync
    tag's. (b) In this process at world 1 (NCCL), the plain engine at stage
    0 loads the tag (every leaf the tag's, bit for bit) and takes the last
    2 steps; ``zero_to_fp32`` of the tag equals the universal directory's
    ``model_states.npz``, has the reference's shapes for the config and
    maps back (``leaf_from_numpy``) onto the tag's masters bit for bit; the
    universal directory loaded into a stage-1
    engine holds the tag's masters and moments. (c) Each rank launches
    K1-K3 12 and K7/K8 25 times a step. Returns the launch counts of both
    ranks and of (b)."""
    import shutil
    import tempfile

    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.checkpoint import ds_to_universal, load_universal_into_engine
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.runtime.checkpoint_engine import torch_checkpoint_engine as tce
    from deepspeed_tpu_torch.utils import zero_to_fp32

    t_phase = time.perf_counter()
    z = ZERO_CKPT
    at, rest = z["save_at"], z["steps"] - z["save_at"]
    root = os.path.join(checkpoint_dir_root(), f"train_zero_ckpt_{os.getpid()}")
    counts, row = {}, {"phase": "train_zero_ckpt", "model": "gpt2-125m", "stage": 3,
                       "mesh": {"fsdp": z["world"]}, "batch": z["batch"], "seq": z["seq"],
                       "dtype": "bfloat16", "card": card}
    try:
        ranks = spawn_ranks(zero_ckpt_rank, z["world"], root)
        errors = [r.get("error") for r in ranks if r.get("error")]
        check(not errors, f"train_zero_ckpt (a): a rank failed: {errors}")
        if not errors:
            r0 = ranks[0]
            for rank, r in enumerate(ranks):
                check(r["foreign_modules"] == [],
                      f"train_zero_ckpt: rank {rank} imported {r['foreign_modules']}")
                check(r["losses_b"] == r["losses_a"][at:] and r["final_b"] == r["final_a"],
                      f"train_zero_ckpt (a) rank {rank}: the resumed run differs from the "
                      f"uninterrupted one ({r['losses_b']} vs {r['losses_a'][at:]})")
                check(r["losses_a"] == r0["losses_a"] and r["final_a"] == r0["final_a"],
                      f"train_zero_ckpt (a): rank {rank}'s stream differs from rank 0's")
                worst = max(e / top for _, e, top in r["k1"]) if r["k1"] else None
                check(len(r["k1"]) == 12 and worst <= K1_REL_TOL_BF16,
                      f"train_zero_ckpt rank {rank}: K1 against the plain attention {r['k1']}")
                steps = z["steps"] + rest
                for kname in KERNELS:
                    check(r["launches"].get(kname) == 12 * steps,
                          f"train_zero_ckpt rank {rank}: {kname} launched "
                          f"{r['launches'].get(kname)} times, expected 12 x {steps}")
                for kname in NORM_KERNELS:
                    check(r["launches"].get(kname) == 25 * steps,
                          f"train_zero_ckpt rank {rank}: {kname} launched "
                          f"{r['launches'].get(kname)} times, expected 25 x {steps}")
                for k, c in r["launches"].items():
                    counts[k] = counts.get(k, 0) + c
            check(r0["async_tag_same_bytes"],
                  "train_zero_ckpt (a): the async tag's bytes differ from the sync tag's")
            losses = [float(np.array(b, np.int32).view(np.float32)) for b in r0["losses_a"]]
            check(all(np.isfinite(losses)), f"train_zero_ckpt (a): losses {losses}")
            row.update({
                "losses": losses, "resume_bitwise": all(
                    r["losses_b"] == r["losses_a"][at:] and r["final_b"] == r["final_a"]
                    for r in ranks),
                "async_tag_same_bytes": r0["async_tag_same_bytes"],
                "tag_files": r0["tag_files"], "tag_bytes": r0["tag_bytes"],
                "k1_max_abs_err": max(e for r in ranks for _, e, _ in r["k1"]),
                "k1_max_err_over_max_o": max(e / top for r in ranks for _, e, top in r["k1"]),
                **{k: [r[k] for r in ranks] for k in (
                    "sync_save_s", "async_blocked_s", "async_steps_s", "async_fence_s", "load_s",
                    "sync_rss_before", "sync_peak_rise", "async_rss_before", "async_peak_rise",
                    "step_ms", "peak_allocated_bytes", "launches")}})
        # (b) this process at world 1 over NCCL: the tag onto stage 0 and,
        # through the universal directory, onto stage 1
        store = tempfile.mkdtemp(prefix="dstorch_zckpt_")
        deepspeed_tpu_torch.init_distributed(mesh_shape={"fsdp": -1}, device="cuda",
                                             init_method=f"file://{store}/store", rank=0,
                                             world_size=1)
        tag = os.path.join(root, "sync", f"global_step{at}")
        try:
            model = tf.TransformerModel.from_preset("gpt2-125m", dtype="bfloat16",
                                                    attn_impl="pallas")
            data = zero_ckpt_data(model.cfg.vocab_size)
            read, _ = tce.TorchCheckpointEngine().open(tag)
            op_builder.reset_launch_counts()
            conf = dict(train_config(z["batch"]), mesh={"fsdp": -1})
            plain = deepspeed_tpu_torch.initialize(model=model, config=conf, seed=2)[0]
            t0 = time.perf_counter()
            plain.load_checkpoint(os.path.join(root, "sync"))
            torch.cuda.synchronize()
            stage0_load_s = time.perf_counter() - t0
            with open(os.path.join(tag, tce.ARRAYS_DIR, tce.INDEX_FILE)) as fh:
                keys = sorted(json.load(fh))
            got, same = [], []
            for k, t in plain._host_leaves():  # one leaf on the host at a time
                got.append(k)
                if not torch.equal(t, read(k)):
                    same.append(k)
            check(sorted(got) == keys and not same,
                  f"train_zero_ckpt (b): {len(same)} leaves of the stage-0 engine differ from "
                  f"the tag's: {same[:3]}")
            stage0 = [engine_step(plain, batch)[0].item() for batch in data[at:]]
            check(all(np.isfinite(stage0)), f"train_zero_ckpt (b): stage-0 losses {stage0}")
            plain_counts = op_builder.launch_counts()
            paths = plain._state.leaf_paths
            del plain
            udir = os.path.join(root, "universal")
            t0 = time.perf_counter()
            fp32 = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(os.path.join(root, "sync"))
            z2f_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ds_to_universal(os.path.join(root, "sync"), udir)
            universal_s = time.perf_counter() - t0
            with np.load(os.path.join(udir, "model_states.npz")) as npz:
                diff = [k for k in npz.files if not np.array_equal(npz[k], fp32[k])]
                check(sorted(npz.files) == sorted(fp32) and not diff,
                      f"train_zero_ckpt (b): zero_to_fp32 and model_states.npz differ: {diff[:3]}")
            # held against the tag by the other map: the reference's shapes
            # for the config, and back through params_from_numpy's layout the
            # tag's masters, bit for bit
            shapes = zero_to_fp32._flatten(tf.reference_shapes(model.cfg))
            wrong = [k for k in shapes if tuple(fp32[k].shape) != tuple(shapes[k])]
            back = [path for path in paths if not torch.equal(
                tf.leaf_from_numpy(fp32.__getitem__, path),
                read("['master_params']" + "".join(f"[{k!r}]" for k in path)))]
            check(sorted(fp32) == sorted(shapes) and not wrong and not back,
                  f"train_zero_ckpt (b): zero_to_fp32 against the tag's masters: shapes "
                  f"{wrong[:3]}, values {back[:3]}")
            del fp32
            one = deepspeed_tpu_torch.initialize(
                model=model, config=dict(conf, zero_optimization={"stage": 1}), seed=3)[0]
            load_universal_into_engine(one, udir)
            moved, bad = 0, []
            for k, t in one._host_leaves():
                if k.startswith(("['master_params']", "['opt_state'].exp_avg")):
                    moved += 1
                    if not torch.equal(t, read(k)):
                        bad.append(k)
            check(moved and not bad and one.opt_state.step == at,
                  f"train_zero_ckpt (b): the universal directory on stage 1 differs from the "
                  f"tag in {bad[:3]} (step {one.opt_state.step})")
            del one
            for k, c in plain_counts.items():
                counts[k] = counts.get(k, 0) + c
            for kname in KERNELS:
                check(plain_counts.get(kname) == 12 * rest,
                      f"train_zero_ckpt (b): {kname} launched {plain_counts.get(kname)} times")
            row.update({"stage0_losses": stage0, "stage0_leaves_equal_tag": not same,
                        "stage0_load_s": stage0_load_s,
                        "zero_to_fp32_s": z2f_s, "ds_to_universal_s": universal_s,
                        "zero_to_fp32_equals_universal": not diff,
                        "zero_to_fp32_maps_back_to_tag": not wrong and not back,
                        "universal_on_stage1_equals_tag": not bad,
                        "parent_launches": plain_counts})
        finally:
            comm.destroy()
        emit(dict(row, phase_s=time.perf_counter() - t_phase))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


def train_zero_ckpt_main():
    """``python3 chip_smoke.py --train-zero-ckpt``: the ``train_zero_ckpt``
    phase alone (no ``kernels`` line)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_norm as fnorm

    card = smi_card()
    build_all([fa.KERNEL_LIB, fa.BWD_KERNEL_LIB, fnorm.KERNEL_LIB])
    train_zero_ckpt_phase(torch.Generator(device="cuda").manual_seed(0), card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
    return 1 if failures else 0


def train_decoders(gen, card):
    """The four decoder-training phases in order; {path: launch counts} and
    ``train_llama``'s line."""
    llama_counts, llama_row = train_llama_phase(gen, card)
    counts = {"train_llama": llama_counts, "train_mistral": train_mistral_phase(gen, card),
              "train_families": train_families_phase(gen, card),
              "hf_finetune": hf_finetune_phase(gen, card)}
    return counts, llama_row


def train_decoders_main():
    """``python3 chip_smoke.py --train-decoders``: the decoder-training
    phases alone (``train_llama``, ``train_mistral``, ``train_families``,
    ``hf_finetune``; no ``kernels`` line)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_norm as fnorm

    card = smi_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all([fa.KERNEL_LIB, fa.BWD_KERNEL_LIB, fnorm.KERNEL_LIB])
    train_decoders(torch.Generator(device="cuda").manual_seed(0), card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
    return 1 if failures else 0


def train_resume_main():
    """``python3 chip_smoke.py --train-resume``: the ``train_resume`` and
    ``train_supervised`` phases alone (no ``kernels`` line)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_norm as fnorm

    card = smi_card()
    build_all([fa.KERNEL_LIB, fa.BWD_KERNEL_LIB, fnorm.KERNEL_LIB])
    gen = torch.Generator(device="cuda").manual_seed(0)
    train_resume_phase(gen, card)
    train_supervised_phase(gen, card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
    return 1 if failures else 0


def smi_card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    return smi[0] if smi else "nvidia-smi gave nothing"


def decode_step_main():
    """``python3 chip_smoke.py --decode-step``: the serving path's
    ``breakdown`` line alone (GPT-2 350M, B 8 x 128, greedy), so that the
    decode step of another checkout of the port can be set beside this
    one's in one call: a copy of this file in that checkout's root drives
    that checkout's package."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_norm as fnorm

    card = smi_card()
    build_all([fa.KERNEL_LIB, fnorm.KERNEL_LIB])
    model = tf.TransformerModel.from_preset("gpt2-350m", dtype="bfloat16")
    eng = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "bfloat16", "attn_impl": "pallas"}, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, eng.cfg.vocab_size, (8, 128), generator=gen, device="cuda")
    serve_breakdown(eng, toks, gen, card, "greedy_b8_p128")
    return 1 if failures else 0


def serve_pool_main():
    """``python3 chip_smoke.py --serve-pool``: the ``serve_pool`` phase alone
    (its lines, no ``kernels`` line), for work on the serving tick."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_norm as fnorm

    card = smi_card()
    build_all([fa.KERNEL_LIB, fnorm.KERNEL_LIB])
    serve_pool_phase(torch.Generator(device="cuda").manual_seed(0), card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
    return 1 if failures else 0


def spec_main():
    """``python3 chip_smoke.py --spec``: the speculative phases alone
    (``spec_generate*`` and ``serve_pool_spec*``; no ``kernels`` line)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_norm as fnorm

    card = smi_card()
    build_all([fa.KERNEL_LIB, fnorm.KERNEL_LIB])
    gen = torch.Generator(device="cuda").manual_seed(0)
    spec_generate_phase(gen, card)
    serve_pool_spec_phase(gen, card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
    return 1 if failures else 0


def serve_layer_main():
    """``python3 chip_smoke.py --serve-layer``: the serving layer's phases
    alone (``serve_layer_*``; no ``kernels`` line)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_norm as fnorm

    card = smi_card()
    build_all([fa.KERNEL_LIB, fnorm.KERNEL_LIB])
    serve_layer_phase(card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
    return 1 if failures else 0


def serve_fleet_main():
    """``python3 chip_smoke.py --fleet``: the serving fleet's phase alone
    (``serve_fleet``; no ``kernels`` line)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_norm as fnorm

    card = smi_card()
    build_all([fa.KERNEL_LIB, fnorm.KERNEL_LIB])
    serve_fleet_phase(card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
    return 1 if failures else 0


def llama_main():
    """``python3 chip_smoke.py --llama``: the Llama-family phases alone
    (``llama_serve``, ``llama_serve_k7`` and ``mistral_ring``; no ``kernels``
    line)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_norm as fnorm

    card = smi_card()
    build_all([fa.KERNEL_LIB, fnorm.KERNEL_LIB])
    gen = torch.Generator(device="cuda").manual_seed(0)
    llama_serve_phase(gen, card)[2].clear()  # frees its engine
    mistral_ring_phase(gen, card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
    return 1 if failures else 0


def hf_main():
    """``python3 chip_smoke.py --hf``: the HF phases alone (``llama_serve``,
    whose weights ``hf_load_llama`` loads back, then ``hf_load_gpt2`` and
    ``hf_families``; no ``kernels`` line)."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_norm as fnorm

    card = smi_card()
    build_all([fa.KERNEL_LIB, fnorm.KERNEL_LIB])
    gen = torch.Generator(device="cuda").manual_seed(0)
    hf_load_llama_phase(llama_serve_phase(gen, card)[2], card)
    hf_load_gpt2_phase(gen, card)
    hf_families_phase(gen, card)
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
    return 1 if failures else 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    card = smi_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": card,
          "matmul_allow_tf32": False, "cudnn_allow_tf32": False})

    import torch.nn.functional as F

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.decoding import bounded_cache_len
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import block_sparse_attention as bs
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_norm as fnorm
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc

    # ---- build: every kernel library, one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = [fa.KERNEL_LIB, fa.BWD_KERNEL_LIB, bs.FWD_KERNEL_LIB, bs.BWD_KERNEL_LIB,
            fnorm.KERNEL_LIB]
    build_all(libs)
    fwd_out, bwd_out = fa.KERNEL_LIB.compiler_output, fa.BWD_KERNEL_LIB.compiler_output
    bs_fwd_out, bs_bwd_out = bs.FWD_KERNEL_LIB.compiler_output, bs.BWD_KERNEL_LIB.compiler_output
    norm_out = fnorm.KERNEL_LIB.compiler_output
    norm_spills = [line for line in norm_out.splitlines() if "spill" in line
                   and "0 bytes spill stores, 0 bytes spill loads" not in line]
    norm_kernels = sum(1 for line in norm_out.splitlines()
                       if "Function properties for" in line and "fused_norm" in line)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": {os.path.basename(lib.source): lib.build_seconds for lib in libs},
          "ptxas": {
              "block_sparse_fwd_bf16_hd64_tile64": ptxas_summary(
                  bs_fwd_out, "fwd_kernel_wgmmaI13__nv_bfloat16Li64E"),
              "block_sparse_dq_bf16_hd64_tile32": ptxas_summary(
                  bs_bwd_out, "dq_kernelI13__nv_bfloat16Li64ELi32"),
              "block_sparse_dkv_bf16_hd64_tile32": ptxas_summary(
                  bs_bwd_out, "dkv_kernelI13__nv_bfloat16Li64ELi32"),
              "block_sparse_fwd_f32_hd64_tile64": ptxas_summary(
                  bs_fwd_out, "fwd_kernelIfLi64ELi64"),
              "block_sparse_dq_f32_hd64_tile64": ptxas_summary(
                  bs_bwd_out, "dq_kernelIfLi64ELi64"),
              "block_sparse_dkv_f32_hd64_tile64": ptxas_summary(
                  bs_bwd_out, "dkv_kernelIfLi64ELi64"),
              **{f"flash_fwd_{name}": ptxas_summary(fwd_out, tag)
                 for name, tag in FWD_TAGS.items()},
              **{f"flash_bwd_{name}": ptxas_summary(bwd_out, tag)
                 for name, tag in BWD_PTXAS_TAGS.items()},
              **{name: ptxas_summary(norm_out, tag) for name, tag in NORM_TAGS.items()},
          },
          "fused_norm_kernels_built": norm_kernels,
          "fused_norm_kernels_spilling": len(norm_spills)})
    # every instantiation of K7/K8 without a spill (not only the tagged ones),
    # from ptxas's output, kept beside the library when it was built
    check(norm_kernels > 0 and not norm_spills,
          f"fused_norm.cu: ptxas reports spills in {len(norm_spills)} of {norm_kernels} "
          f"kernels ({norm_spills[:3]})")
    # the attention kernels' products in the SASS: HGMMA (wgmma) and no HMMA
    # (mma.sync) in every 16-bit kernel, f32 FMAs only in the f32 kernels
    # (and the 16-bit kernels' few elementwise ones)
    sass = {}
    for key, lib, tags in (("flash_fwd", fa.KERNEL_LIB, FWD_TAGS),
                           ("flash_bwd", fa.BWD_KERNEL_LIB, BWD_PTXAS_TAGS),
                           ("block_sparse_fwd", bs.FWD_KERNEL_LIB, SPARSE_FWD_TAGS),
                           ("block_sparse_bwd", bs.BWD_KERNEL_LIB, SPARSE_BWD_TAGS)):
        found = sass_counts(lib.lib_path(), list(tags.values()))
        sass[key] = {name: found[tag] for name, tag in tags.items()}
    sparse_ptxas = {
        "block_sparse_fwd": {name: ptxas_summary(bs_fwd_out, tag)
                             for name, tag in SPARSE_FWD_TAGS.items()},
        "block_sparse_bwd": {name: ptxas_summary(bs_bwd_out, tag)
                             for name, tag in SPARSE_BWD_TAGS.items()}}
    for key, ptxas in sparse_ptxas.items():
        for name, counts in sass[key].items():
            if isinstance(counts, dict):
                counts["ptxas"] = ptxas[name]
    # K7/K8: the vector path's 16-byte loads and stores, none on the scalar path
    norm_sass = sass_counts(fnorm.KERNEL_LIB.lib_path(), list(NORM_TAGS.values()),
                            ops=("LDG.E.128", "STG.E.128"))
    sass["fused_norm"] = {name: norm_sass[tag] for name, tag in NORM_TAGS.items()}
    for name, counts in sass["fused_norm"].items():
        vector = "_vector_" in name
        check(isinstance(counts, dict) and (counts["LDG.E.128"] > 0 and counts["STG.E.128"] > 0)
              == vector, f"fused_norm {name}: 16-byte loads/stores {counts} on the "
                         f"{'vector' if vector else 'scalar or wide'} path")
    emit({"phase": "build_sass",
          "libraries": [os.path.basename(lib.lib_path())
                        for lib in (fa.KERNEL_LIB, fa.BWD_KERNEL_LIB, bs.FWD_KERNEL_LIB,
                                    bs.BWD_KERNEL_LIB)],
          "block_sparse_fwd_expected_hgmma": SPARSE_FWD_HGMMA,
          "block_sparse_bwd_expected_hgmma": SPARSE_BWD_HGMMA, **sass})
    for name, counts in sass["flash_fwd"].items():
        if not name.startswith("f32"):
            check(isinstance(counts, dict) and counts["HGMMA"] > 0 and counts["HMMA"] == 0,
                  f"flash_fwd {name}: not on wgmma alone in its SASS ({counts})")
    for name, want in BWD_HGMMA.items():
        counts = sass["flash_bwd"][name]
        check(isinstance(counts, dict) and counts["HGMMA"] == want and counts["HMMA"] == 0,
              f"flash_bwd {name}: SASS {counts}, expected {want} HGMMA and no HMMA")
    for key, expected in (("block_sparse_fwd", SPARSE_FWD_HGMMA),
                          ("block_sparse_bwd", SPARSE_BWD_HGMMA)):
        for name, want in expected.items():
            counts, ptx = sass[key][name], sparse_ptxas[key][name]
            check(isinstance(counts, dict) and counts["HGMMA"] == want and counts["HMMA"] == 0,
                  f"{key} {name}: SASS {counts}, expected {want} HGMMA and no HMMA")
            check(not ptx or "0 bytes spill stores" in ptx[0],
                  f"{key} {name}: ptxas reports spills ({ptx})")

    # ---- K1 against its plain version at the paths' shapes, in bf16 (the
    # tensor-core kernel) and, at the training shape, in f32 (the FMA kernel)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = {
        "a_prefill_b8_s128": (8, 128, 16, 16, 64, True, None, bf16),
        "b_prefill_b2_s896": (2, 896, 16, 16, 64, True, None, bf16),
        "c_ragged_b4_s100": (4, 100, 16, 16, 64, True, None, bf16),
        "d_gqa_window64": (2, 512, 8, 2, 64, True, 64, bf16),
        "d_gqa_noncausal": (2, 512, 8, 2, 64, False, None, bf16),
        "e_train_b8_s1024": (8, 1024, 12, 12, 64, True, None, bf16),
        "f_train_b8_s1024_f32": (8, 1024, 12, 12, 64, True, None, f32),
        # the prefills of llama_serve (llama2-7b) and mistral_ring (Mistral
        # 7B: GQA group 4, the 4096-position window)
        "g_llama2_7b_b8_s512": (8, 512, 32, 32, 128, True, None, bf16),
        "h_mistral_7b_b1_s4608_w4096": (1, 4608, 32, 8, 128, True, 4096, bf16),
        # the training shapes of train_llama (llama2-7b, B2 S4096) and
        # train_mistral (Mistral 7B, B1 S8192: GQA group 4, the window band)
        "i_llama_train_b2_s4096_h32_hd128": (2, 4096, 32, 32, 128, True, None, bf16),
        "j_mistral_train_b1_s8192_h32_hkv8_hd128_w4096": (1, 8192, 32, 8, 128, True, 4096,
                                                          bf16),
    }
    k1 = {}
    for name, (B, S, H, Hkv, hd, causal, window, dtype) in shapes.items():
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda", dtype=dtype)
        k = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda", dtype=dtype)
        v = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda", dtype=dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ro, rl = fa._reference_fwd(q, k, v, causal, hd ** -0.5, window)
        d_o = (o.float() - ro.float()).abs().max().item()
        d_lse = (lse - rl).abs().max().item()
        check(d_o <= K1_O_TOL[dtype] and d_lse <= K1_LSE_TOL and bool(torch.isfinite(o).all()),
              f"K1 {name}: |do| {d_o} |dlse| {d_lse}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window is not None:
            ar = torch.arange(S, device="cuda")
            mask = (ar[None, :] <= ar[:, None]) & (ar[:, None] - ar[None, :] < window)
        bound_ms, bound_by = flash_bound(B, S, H, Hkv, hd, causal, window, dtype)
        kernel_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal, window=window))
        row = {
            "phase": "k1", "shape": name, "B": B, "S": S, "H": H, "Hkv": Hkv, "hd": hd,
            "causal": causal, "window": window, "dtype": str(dtype).split(".")[-1],
            "variant": "tensor_core" if dtype in fa.TENSOR_CORE_DTYPES else "f32_fma",
            "max_abs_err_o": d_o, "max_abs_err_lse": d_lse,
            "tol_o": K1_O_TOL[dtype], "tol_lse": K1_LSE_TOL,
            "kernel_ms": kernel_ms,
            "tflops": 4.0 * hd * attention_pairs(S, S, causal, window) * B * H / kernel_ms * 1e-9,
            # the plain version at the training shapes (2**30 scores and more)
            # eagerly: a CUDA graph of its f32 scores would not fit beside
            # the cached warm-up's
            "plain_ms": (events_ms if B * H * S * S >= 2 ** 30 else cuda_ms)(
                lambda: fa._reference_fwd(q, k, v, causal, hd ** -0.5, window)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=H != Hkv)),
            "bound_ms": bound_ms, "bound_by": bound_by, "card": card,
        }
        k1[name] = row
        emit(row)
        del q, k, v, o, lse, ro, rl, qt, kt, vt
    torch.cuda.empty_cache()

    # ---- K2 and K3 against their plain version (_reference_bwd) on the same inputs
    bwd_shapes = {
        "a_train_b8_s1024": (8, 1024, 12, 12, 64, True, None, torch.bfloat16),
        "b_ragged_b4_s100": (4, 100, 16, 16, 64, True, None, torch.bfloat16),
        "c_gqa_window64": (2, 512, 8, 2, 64, True, 64, torch.bfloat16),
        "d_gqa_noncausal": (2, 512, 8, 2, 64, False, None, torch.bfloat16),
        "e_train_b8_s1024_f32": (8, 1024, 12, 12, 64, True, None, torch.float32),
        # the training shapes of train_llama and train_mistral at hd 128
        "f_llama_train_b2_s4096_h32_hd128": (2, 4096, 32, 32, 128, True, None, torch.bfloat16),
        "g_mistral_train_b1_s8192_h32_hkv8_hd128_w4096": (1, 8192, 32, 8, 128, True, 4096,
                                                          torch.bfloat16),
    }
    k23 = {}
    for name, (B, S, H, Hkv, hd, causal, window, dtype) in bwd_shapes.items():
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda", dtype=dtype)
        k = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda", dtype=dtype)
        v = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda", dtype=dtype)
        do = torch.randn(B, S, H, hd, generator=gen, device="cuda", dtype=dtype)
        scale = hd ** -0.5
        o, lse = fa._reference_fwd(q, k, v, causal, scale, window)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
        torch.cuda.synchronize()
        rq, rk, rv = fa._reference_bwd(q, k, v, o, lse, do, causal, scale, window)
        errs = {}
        for gname, got, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
            d = (got.float() - ref.float()).abs().max().item()
            rel = d / ref.float().abs().max().item()
            errs[gname] = (d, rel)
            check(rel <= GRAD_REL_TOL[dtype] and bool(torch.isfinite(got).all()),
                  f"K2/K3 {name}: max |{gname} - plain| {d} ({rel} of max |{gname}|)")
        delta = fa._delta(o, do)
        (k2_bound, k2_by), (k3_bound, k3_by) = flash_bwd_bounds(B, S, H, Hkv, hd, causal,
                                                                window, dtype)
        pairs = attention_pairs(S, S, causal, window) * B * H
        k2_ms = cuda_ms(lambda: fa._cuda_bwd_dq(q, k, v, do, lse, delta, causal, scale, window))
        k3_ms = cuda_ms(lambda: fa._cuda_bwd_dkv(q, k, v, do, lse, delta, causal, scale, window))
        plain_iters = 2 if S >= 1024 else 10
        if B * H * S * S >= 2 ** 30:  # as K1's plain version at these shapes: eagerly
            plain_ms = events_ms(lambda: fa._reference_bwd(q, k, v, o, lse, do, causal, scale,
                                                           window), iters=plain_iters)
        else:
            plain_ms = cuda_ms(lambda: fa._reference_bwd(q, k, v, o, lse, do, causal, scale,
                                                         window), iters=plain_iters, replays=2)
        # the library yardstick, timed only: SDPA forward + backward minus SDPA forward
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        dot = do.transpose(1, 2)
        mask = None
        if window is not None:
            ar = torch.arange(S, device="cuda")
            mask = (ar[None, :] <= ar[:, None]) & (ar[:, None] - ar[None, :] < window)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  is_causal=causal and mask is None,
                                                  enable_gqa=H != Hkv)

        sdpa_fwd_ms = cuda_ms(sdpa)
        sdpa_fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
        row = {
            "phase": "k2_k3", "shape": name, "B": B, "S": S, "H": H, "Hkv": Hkv, "hd": hd,
            "causal": causal, "window": window, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": {g: e[0] for g, e in errs.items()},
            "max_err_over_max_ref": {g: e[1] for g, e in errs.items()},
            "rel_tol": GRAD_REL_TOL[dtype],
            "variant": "tensor_core" if dtype in fa.TENSOR_CORE_DTYPES else "f32_fma",
            "k2_ms": k2_ms, "k3_ms": k3_ms, "plain_bwd_ms": plain_ms,
            "k2_tflops": 6.0 * hd * pairs / k2_ms * 1e-9,
            "k3_tflops": 8.0 * hd * pairs / k3_ms * 1e-9,
            "k2_bound_ms": k2_bound, "k2_bound_by": k2_by,
            "k3_bound_ms": k3_bound, "k3_bound_by": k3_by,
            "sdpa_fwd_ms": sdpa_fwd_ms, "sdpa_fwd_bwd_ms": sdpa_fwd_bwd_ms,
            "sdpa_bwd_ms": sdpa_fwd_bwd_ms - sdpa_fwd_ms, "card": card,
        }
        k23[name] = row
        emit(row)
        del q, k, v, do, o, lse, dq, dk, dv, rq, rk, rv, qt, kt, vt, dot, delta
    torch.cuda.empty_cache()

    # ---- K4, K5 and K6 against their plain versions on the same inputs
    sparse_shapes = {  # (B, S, H, hd, layout config, causal, dtype)
        "a_fixed_b2_s4096": (2, 4096, 12, 64, sc.FixedSparsityConfig(num_heads=12), True,
                             torch.bfloat16),
        "b_fixed_b2_s4096_f32": (2, 4096, 12, 64, sc.FixedSparsityConfig(num_heads=12), True,
                                 torch.float32),
        "c_bigbird_b2_s2048": (2, 2048, 12, 64, sc.BigBirdSparsityConfig(num_heads=12), True,
                               torch.bfloat16),
        "d_bslongformer_b2_s2048_noncausal": (
            2, 2048, 12, 64, sc.BSLongformerSparsityConfig(num_heads=12), False, torch.bfloat16),
        "e_variable_block32_b2_s2048": (
            2, 2048, 12, 64, sc.VariableSparsityConfig(num_heads=12, block=32,
                                                       attention="unidirectional"),
            True, torch.bfloat16),
        "f_zero_row_b1_s512_h4_hd128": (
            1, 512, 4, 128, sc.FixedSparsityConfig(num_heads=4, block=128, num_local_blocks=2),
            True, torch.bfloat16),
        "g_fixed_b2_s1024_f16": (2, 1024, 12, 64, sc.FixedSparsityConfig(num_heads=12), True,
                                 torch.float16),
        # hd 128 over the fixed layout's long global columns (61 tiles)
        "h_fixed_b1_s4096_hd128": (1, 4096, 12, 128, sc.FixedSparsityConfig(num_heads=12), True,
                                   torch.bfloat16),
        "i_fixed_b1_s4096_hd128_f16": (1, 4096, 12, 128, sc.FixedSparsityConfig(num_heads=12),
                                       True, torch.float16),
    }
    k456 = {}
    for name, (B, S, H, hd, conf, causal, dtype) in sparse_shapes.items():
        layout = conf.make_layout(S)
        b = min(conf.block, S)
        zero_rows = None
        if name.startswith("f_"):
            layout[1, 2, :] = 0  # head 1, query block 2 attends nothing
            zero_rows = slice(2 * b, 3 * b)
        q, k, v, do = (torch.randn(B, S, H, hd, generator=gen, device="cuda", dtype=dtype)
                       for _ in range(4))
        scale = hd ** -0.5
        o, lse = bs.block_sparse_attention_fwd(q, k, v, layout, causal=causal, block=conf.block)
        torch.cuda.synchronize()
        ro, rl = bs._reference_fwd(q, k, v, layout, b, causal, scale)
        variant = bs.kernel_variant(dtype, min(b, bs.MAX_TILE))
        again = bs.block_sparse_attention_fwd(q, k, v, layout, causal=causal, block=conf.block)
        fwd_same_bits = all(torch.equal(x, y) for x, y in zip((o, lse), again))
        check(fwd_same_bits, f"K4 {name}: two calls gave different bits")
        again = fwd_in_ascending_order(bs, q, k, v, layout, b, causal, scale)
        fwd_order_same_bits = all(torch.equal(x, y) for x, y in zip((o, lse), again))
        check(fwd_order_same_bits, f"K4 {name}: the launch order changed the bits")
        del again
        before = op_builder.launch_counts()
        dq, dk, dv = bs.block_sparse_attention_bwd(q, k, v, ro, rl, do, layout, causal=causal,
                                                   block=conf.block)
        torch.cuda.synchronize()
        for kname in ("block_sparse_bwd_dq", "block_sparse_bwd_dkv"):
            check(op_builder.LAUNCHES[kname] == before[kname] + 1,
                  f"K5/K6 {name}: {kname} did not launch once")
        again = bs.block_sparse_attention_bwd(q, k, v, ro, rl, do, layout, causal=causal,
                                              block=conf.block)
        same_bits = all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again))
        check(same_bits, f"K5/K6 {name}: two calls gave different bits")
        del again
        rq, rk, rv = bs._reference_bwd(q, k, v, ro, rl, do, layout, b, causal, scale)
        errs = {}
        for gname, got, ref in (("o", o, ro), ("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
            d = (got.float() - ref.float()).abs().max().item()
            rel = d / ref.float().abs().max().item()
            errs[gname] = (d, rel)
            check(rel <= BS_REL_TOL[dtype] and bool(torch.isfinite(got).all()),
                  f"K4-K6 {name}: max |{gname} - plain| {d} ({rel} of max |{gname}|)")
        d_lse = (lse - rl).abs().max().item()
        check(d_lse <= BS_LSE_TOL, f"K4 {name}: max |lse - plain| {d_lse}")
        # K5/K6 on K4's own o and lse, as the model runs them, against the
        # plain backward on the same o and lse
        on_k4 = {}
        got = bs.block_sparse_attention_bwd(q, k, v, o, lse, do, layout, causal=causal,
                                            block=conf.block)
        want = bs._reference_bwd(q, k, v, o, lse, do, layout, b, causal, scale)
        for gname, g, ref in zip(("dq", "dk", "dv"), got, want):
            on_k4[gname] = ((g.float() - ref.float()).abs().max()
                            / ref.float().abs().max()).item()
            check(on_k4[gname] <= BS_REL_TOL[dtype] and bool(torch.isfinite(g).all()),
                  f"K5/K6 {name} on K4's o and lse: {gname} {on_k4[gname]} of max |{gname}|")
        del got, want
        off_exact = None
        if dtype != torch.float32:  # how often each side rounds off the exact gradient
            exact = exact_sparse_bwd(bs, q, k, v, ro, rl, do, layout, b, causal, scale)
            off_exact = {side: {g: rounded_off(got, ex) for g, got, ex in zip(("dq", "dk", "dv"),
                                                                              grads, exact)}
                         for side, grads in (("kernel", (dq, dk, dv)), ("plain", (rq, rk, rv)))}
            del exact
        zero = None
        if zero_rows is not None:
            zero = max(o[:, zero_rows, 1].abs().max().item(),
                       dq[:, zero_rows, 1].abs().max().item())
            check(zero == 0.0, f"K4/K5 {name}: the all-zero layout row gave |o|, |dq| up to {zero}")
        lists = bs.tile_lists(layout, b, causal)
        row_len, col_len = (lists[ptr][1:] - lists[ptr][:-1] for ptr in ("row_ptr", "col_ptr"))
        pairs = attention_pairs(S, S, causal, None, layout=layout, block=b)
        (k4b, k4by, k4f), (k5b, k5by, k5f), (k6b, k6by, k6f) = sparse_bounds(B, S, H, hd, pairs,
                                                                             dtype)
        delta = fa._delta(ro, do)
        k4_ms = cuda_ms(lambda: bs._cuda_fwd(q, k, v, layout, b, causal, scale))
        k5_ms = cuda_ms(lambda: bs._cuda_bwd_dq(q, k, v, do, rl, delta, layout, b, causal, scale))
        k6_ms = cuda_ms(lambda: bs._cuda_bwd_dkv(q, k, v, do, rl, delta, layout, b, causal,
                                                 scale))
        plain_fwd_ms = events_ms(lambda: bs._reference_fwd(q, k, v, layout, b, causal, scale))
        plain_bwd_ms = events_ms(lambda: bs._reference_bwd(q, k, v, ro, rl, do, layout, b,
                                                           causal, scale))
        # the library yardstick, timed only: SDPA over all pairs with the
        # expanded block-and-causal mask; backward = forward + backward - forward
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        dot = do.transpose(1, 2)
        mask = bs._mask(layout, b, S, S, causal, "cuda")[None]

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        sdpa_fwd_ms = cuda_ms(sdpa)
        sdpa_fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot))
        row = {
            "phase": "k4_k6", "shape": name, "B": B, "S": S, "H": H, "hd": hd,
            "layout": type(conf).__name__, "block": b, "causal": causal,
            "dtype": str(dtype).split(".")[-1],
            "kernel_tile": lists["tile"], "listed_tiles_per_head": lists["cols"].size / H,
            "pairs_per_batch_row": pairs, "variant": variant,
            "k4_same_bits_twice": fwd_same_bits,
            "k4_ascending_order_same_bits": fwd_order_same_bits,
            "k5_list_longest": int(row_len.max()), "k5_list_mean": float(row_len.mean()),
            "k6_list_longest": int(col_len.max()), "k6_list_mean": float(col_len.mean()),
            "k5_k6_same_bits_twice": same_bits,
            "max_abs_err": {g: e[0] for g, e in errs.items()},
            "max_err_over_max_ref": {g: e[1] for g, e in errs.items()},
            "max_abs_err_lse": d_lse, "zero_row_max_abs": zero,
            "k5_k6_on_k4_o_lse_err_over_max": on_k4,
            "elements_per_gradient": q.numel(), "rounded_off_exact": off_exact,
            "rel_tol": BS_REL_TOL[dtype], "lse_tol": BS_LSE_TOL,
            "k4_ms": k4_ms, "k5_ms": k5_ms, "k6_ms": k6_ms,
            "k4_tflops": 4.0 * hd * pairs * B / k4_ms * 1e-9,
            "k5_tflops": 6.0 * hd * pairs * B / k5_ms * 1e-9,
            "k6_tflops": 8.0 * hd * pairs * B / k6_ms * 1e-9,
            "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
            "k4_bound_ms": k4b, "k4_bound_by": k4by, "k5_bound_ms": k5b, "k5_bound_by": k5by,
            "k6_bound_ms": k6b, "k6_bound_by": k6by,
            "f32_core_ms": {"k4": k4f, "k5": k5f, "k6": k6f},
            "sdpa_fwd_ms": sdpa_fwd_ms, "sdpa_fwd_bwd_ms": sdpa_fwd_bwd_ms,
            "sdpa_bwd_ms": sdpa_fwd_bwd_ms - sdpa_fwd_ms, "card": card,
        }
        k456[name] = row
        emit(row)
        del q, k, v, do, o, lse, dq, dk, dv, ro, rl, rq, rk, rv, qt, kt, vt, dot, delta, mask
        torch.cuda.empty_cache()

    # ---- K3's GQA head sum, bit for bit: each query head's dk/dv partial
    # rounded to bf16, summed over the group in f32 in head order, rounded once;
    # at hd 64, and at Mistral's heads (32 over 8, hd 128) with a live band
    for B, S, H, Hkv, hd, window in ((2, 512, 8, 2, 64, None), (1, 2048, 32, 8, 128, 512)):
        group = H // Hkv
        q, do = (torch.randn(B, S, H, hd, generator=gen, device="cuda", dtype=torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, hd, generator=gen, device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        o, lse = fa._reference_fwd(q, k, v, True, hd ** -0.5, window)
        _, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=window)
        _, dk1, dv1 = fa.flash_attention_bwd(q, k.repeat_interleave(group, 2),
                                             v.repeat_interleave(group, 2), o, lse, do,
                                             causal=True, window=window)
        torch.cuda.synchronize()
        gqa = {}
        for gname, got, per_head in (("dk", dk, dk1), ("dv", dv, dv1)):
            parts = per_head.reshape(B, S, Hkv, group, hd)
            total = parts[..., 0, :].float()
            for i in range(1, group):
                total = total + parts[..., i, :].float()
            want = total.to(torch.bfloat16)
            gqa[gname] = {"bitwise_equal": bool(torch.equal(got, want)),
                          "max_abs_diff": (got.float() - want.float()).abs().max().item()}
            check(gqa[gname]["bitwise_equal"],
                  f"K3 GQA hd {hd} {gname}: not the per-head-rounded group sum")
        emit({"phase": "k3_gqa_rounding", "B": B, "S": S, "H": H, "Hkv": Hkv, "hd": hd,
              "window": window, "dtype": "bfloat16", **gqa})
        del q, k, v, do, o, lse, dk, dv, dk1, dv1

    k78 = k7_k8_phase(gen, card)
    fused_counts = fused_ops_phase(gen, card)
    torch.cuda.empty_cache()

    # ---- the serving path: GPT-2 350M, pallas (flash) attention
    model = tf.TransformerModel.from_preset("gpt2-350m", dtype="bfloat16")
    eng = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "bfloat16", "attn_impl": "pallas"}, seed=0)
    ref = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "bfloat16", "attn_impl": "xla"}, params=eng.params)
    cfg, V, L = eng.cfg, eng.cfg.vocab_size, eng.cfg.num_layers
    requests = [
        {"name": "greedy_b8_p128_n128", "B": 8, "P": 128, "new": 128, "temperature": 0.0, "top_k": 0},
        {"name": "greedy_b2_p896_n64", "B": 2, "P": 896, "new": 64, "temperature": 0.0, "top_k": 0},
        {"name": "sampled_b4_p100_n32", "B": 4, "P": 100, "new": 32, "temperature": 0.8, "top_k": 50},
    ]
    prompts = {r["name"]: torch.randint(0, V, (r["B"], r["P"]), generator=gen, device="cuda")
               for r in requests}
    eng.generate(prompts[requests[0]["name"]][:, :16], max_new_tokens=4)  # warm-up: cuBLAS, kernel load
    torch.cuda.synchronize()

    op_builder.reset_launch_counts()
    per_request = []
    for r in requests:
        before = op_builder.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(prompts[r["name"]], max_new_tokens=r["new"],
                           temperature=r["temperature"], top_k=r["top_k"],
                           generator=torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = op_builder.launch_counts()
        launched = {k: after[k] - before[k] for k in ("flash_fwd",) + NORM_KERNELS}
        per_request.append((r, out, wall, launched))
    serve_counts = op_builder.launch_counts()

    for r, out, wall, launched in per_request:
        B, P, new = r["B"], r["P"], r["new"]
        shape_ok = tuple(out.shape) == (B, P + new)
        range_ok = bool(((out >= 0) & (out < V)).all())
        check(shape_ok and range_ok, f"{r['name']}: output shape {tuple(out.shape)} / range")
        check(launched["flash_fwd"] == L,
              f"{r['name']}: K1 launched {launched['flash_fwd']} times, expected {L}")
        # one forward for the prompt and one for each new token but the last:
        # 2 L + 1 norms each (two a layer and the final norm), no backward
        norms = (2 * L + 1) * new
        check(launched["fused_norm_fwd"] == norms and launched["fused_norm_bwd"] == 0,
              f"{r['name']}: K7/K8 launched {launched['fused_norm_fwd']}/"
              f"{launched['fused_norm_bwd']} times, expected {norms}/0")
        # prefill logits: pallas engine against the xla-attention engine
        toks = prompts[r["name"]]
        cache_len = bounded_cache_len(P + new, cfg.max_seq_len, eng.config.max_out_tokens)
        with torch.inference_mode():
            lp, _ = tf.forward_with_cache(eng.params, eng.cfg, toks,
                                          tf.init_cache(eng.cfg, B, cache_len, "cuda"), 0)
            lx, _ = tf.forward_with_cache(ref.params, ref.cfg, toks,
                                          tf.init_cache(ref.cfg, B, cache_len, "cuda"), 0)
        lp, lx = lp.float(), lx.float()
        d = (lp - lx).abs().max().item()
        last_x = lx[:, -1]
        top2 = last_x.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * LOGITS_TOL  # rows not within tolerance of a tie
        agree = lp[:, -1].argmax(-1) == last_x.argmax(-1)
        check(bool(torch.isfinite(lp).all()) and d <= LOGITS_TOL,
              f"{r['name']}: prefill logits |pallas - xla| {d} > {LOGITS_TOL}")
        check(bool(agree[decided].all()), f"{r['name']}: top-1 disagrees on decided rows")
        emit({"phase": "generate", "request": r["name"], "batch": B, "prompt": P,
              "new_tokens": new, "temperature": r["temperature"], "top_k": r["top_k"],
              "k1_launches": launched["flash_fwd"], "k7_launches": launched["fused_norm_fwd"],
              "k7_launches_per_forward": launched["fused_norm_fwd"] / new,
              "k8_launches": launched["fused_norm_bwd"], "layers": L, "generate_s": wall,
              "new_tokens_per_s": B * new / wall, "tokens_per_s": B * (P + new) / wall,
              "prefill_logits_max_abs_diff_vs_xla": d, "logits_tol": LOGITS_TOL,
              "top1_agree_rows": int(agree.sum()), "top1_decided_rows": int(decided.sum()),
              "rows": B, "card": card})
    check(serve_counts["flash_fwd"] > 0, "K1 never launched on the serving path")

    # ---- where the time goes: the decode step at the first request's shape
    serve_breakdown(eng, prompts[requests[0]["name"]], gen, card, requests[0]["name"])

    del eng, ref, prompts, per_request
    torch.cuda.empty_cache()

    # ---- the decode slice's other request shapes: int8 weights and KV, then
    # ragged prompts and chunked prefill, each path counted from 0
    int8_counts = decode_int8_phase(gen, card)
    ragged_counts = ragged_chunked_phase(gen, card)
    # ---- the continuous-batching serving tick: GPT-2 125M, bench_serving's
    # geometry, pipeline depths 0 and 1, counted from 0 over both serves
    pool_counts, pool_k7 = serve_pool_phase(gen, card)
    torch.cuda.empty_cache()
    # ---- speculative decoding: bench_decode's draft probe (GPT-2 350M) and
    # bench_serving's speculative pool (GPT-2 125M), each counted from 0
    spec_counts = spec_generate_phase(gen, card)
    pool_spec_counts = serve_pool_spec_phase(gen, card)
    check(spec_counts.get("flash_fwd", 0) > 0 and spec_counts.get("fused_norm_fwd", 0) > 0
          and pool_spec_counts.get("fused_norm_fwd", 0) > 0,
          "speculative paths: K1 never launched on serve_spec or K7 on one of the two")
    # ---- the serving layer over the batching engine: overhead, load, chaos
    # on serve_pool's engine build, counted from 0 over the driven serves
    layer_counts = serve_layer_phase(card)
    torch.cuda.empty_cache()
    # ---- the serving fleet over ServingEngine replicas on one card: the
    # sweep, a kill with migration, a rolling restart, the autoscaler
    fleet_counts = serve_fleet_phase(card)
    torch.cuda.empty_cache()

    # ---- the training path: GPT-2 125M, seq 1024, micro-batch 8, bf16, flash
    # attention, no remat, with the JAX package's bench config; the first
    # step against the xla engine on the same weights, with each layer's
    # q/k/v gradient blocks
    model = tf.TransformerModel.from_preset("gpt2-125m", dtype="bfloat16", attn_impl="pallas")
    engine = deepspeed_tpu_torch.initialize(model=model, config=TRAIN_CONFIG)[0]
    tcfg = engine.model.cfg
    B_T, S_T, V_T = 8, 1024, tcfg.vocab_size
    init_params = tf.map_params(lambda p: p.detach().clone(), engine.master_params)
    batch = {"input_ids": torch.randint(0, V_T, (B_T, S_T), generator=gen, device="cuda")}

    def snapshot(e):
        return [tuple(b.clone() for b in blocks) for blocks in wqkv_grad_blocks(e, tcfg)]

    warmup, steps = 2, 10
    run = timed_training(engine, batch, warmup, steps, snapshot)
    train_counts = run["counts"]
    losses, gnorm0 = run["losses"], run["grad_norm0"]
    med_s = statistics.median(run["step_s"])
    row = training_row("train", tcfg, run, B_T, S_T, steps)

    def wqkv_vs_flash(e):
        rel = [[float((a - b).norm() / b.norm()) for a, b in zip(mine, theirs)]
               for mine, theirs in zip(run["first"], wqkv_grad_blocks(e, tcfg))]
        return {"wqkv_grad_rel_diff_worst_layer": {part: max(layer[i] for layer in rel)
                                                   for i, part in enumerate("qkv")},
                "wqkv_grad_rel_diff_per_layer_qkv": rel}

    # init_params stays for the block-sparse dense-layout check
    row["first_step_vs_xla"] = first_step_vs_xla("train", tcfg, init_params, batch, losses[0],
                                                 gnorm0, wqkv_vs_flash)
    del run["first"]
    emit({"phase": "train", "model": "gpt2-125m", "warmup_steps": warmup, **row, "card": card})

    # ---- the model's gradients through K1-K3 in f32 (TF32 off), 2 layers at
    # the same width: the flash engine against the xla-attention engine
    def f32_grads(cfgs):
        """{key: (loss, {leaf: f32 gradient})} of one f32 step on ``batch``
        for each config, every engine from the first engine's weights."""
        out, f32_params = {}, None
        for key, c in cfgs.items():
            loss, grads, f32_params = f32_step(c, f32_params, batch["input_ids"], "cuda")
            out[key] = (loss, grads)
        return out

    grads = f32_grads({impl: tf.get_config("gpt2-125m", dtype="float32", attn_impl=impl,
                                           num_layers=2) for impl in ("pallas", "xla")})
    f32_rel = leaf_rel(grads["pallas"][1], grads["xla"][1])
    worst = max(f32_rel, key=f32_rel.get)
    f32_dloss = abs(grads["pallas"][0] - grads["xla"][0])
    check(f32_rel[worst] <= F32_GRAD_REL_TOL and f32_dloss <= F32_LOSS_TOL,
          f"train f32: flash vs xla engine: loss {grads['pallas'][0]} vs {grads['xla'][0]}, "
          f"worst leaf {worst} at {f32_rel[worst]} of its max |grad|")
    emit({"phase": "train_f32_grads", "model": "gpt2-125m width, 2 layers", "dtype": "float32",
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "loss_flash": grads["pallas"][0], "loss_xla": grads["xla"][0],
          "loss_abs_diff": f32_dloss, "loss_tol": F32_LOSS_TOL,
          "leaves": len(f32_rel), "worst_leaf": worst, "worst_rel": f32_rel[worst],
          "rel_tol": F32_GRAD_REL_TOL,
          "rel_per_leaf": {k: f32_rel[k] for k in sorted(f32_rel)}, "card": card})
    del grads
    torch.cuda.empty_cache()

    # ---- the model's norms on the card (K7/K8) against the CPU (their plain
    # versions, as every kernel's): one f32 step (TF32 off) of a 2-layer
    # engine at GPT-2 125M's width, the same weights and batch on both
    norm_cfg = tf.get_config("gpt2-125m", dtype="float32", attn_impl="pallas", num_layers=2)
    norm_batch = batch["input_ids"][:2]
    op_builder.reset_launch_counts()
    card_loss, card_grads, card_params = f32_step(norm_cfg, None, norm_batch, "cuda")
    torch.cuda.synchronize()
    norm_counts = op_builder.launch_counts()
    cpu_loss, cpu_grads, _ = f32_step(norm_cfg, card_params, norm_batch, "cpu")
    del card_params
    norm_rel = leaf_rel(card_grads, cpu_grads)
    norm_worst = max(norm_rel, key=norm_rel.get)
    norm_leaves = {k: v for k, v in norm_rel.items() if "ln" in k or "final_norm" in k}
    check(all(norm_counts[k] == 5 for k in NORM_KERNELS),
          f"train_norm_card_vs_cpu: K7/K8 launched {[norm_counts[k] for k in NORM_KERNELS]} "
          f"times in one 2-layer step, expected 5 each")
    check(abs(card_loss - cpu_loss) <= NORM_MODEL_LOSS_TOL
          and norm_rel[norm_worst] <= F32_GRAD_REL_TOL,
          f"train_norm_card_vs_cpu: loss {card_loss} vs CPU {cpu_loss}, worst leaf "
          f"{norm_worst} at {norm_rel[norm_worst]} of its max |grad|")
    emit({"phase": "train_norm_card_vs_cpu", "model": "gpt2-125m width, 2 layers",
          "batch": list(norm_batch.shape), "dtype": "float32",
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "loss_card": card_loss, "loss_cpu": cpu_loss, "loss_abs_diff": abs(card_loss - cpu_loss),
          "loss_tol": NORM_MODEL_LOSS_TOL, "leaves": len(norm_rel), "worst_leaf": norm_worst,
          "worst_rel": norm_rel[norm_worst], "rel_tol": F32_GRAD_REL_TOL,
          "norm_leaves_rel": norm_leaves,
          "launches": {k: norm_counts[k] for k in NORM_KERNELS}, "card": card})
    del card_grads, cpu_grads
    torch.cuda.empty_cache()

    # ---- where the training step's time goes: one step under the profiler;
    # each flash kernel's profiled time per launch beside its CUDA-graph time
    # from the k1 / k2_k3 phases at the same shape
    tk, row = step_breakdown(engine, batch, KERNELS, med_s * 1e3, card)
    graph_ms = {"flash_fwd": k1["e_train_b8_s1024"]["kernel_ms"],
                "flash_bwd_dq": k23["a_train_b8_s1024"]["k2_ms"],
                "flash_bwd_dkv": k23["a_train_b8_s1024"]["k3_ms"]}
    row["profiler_vs_graph_ms_per_launch"] = {
        kname: {"profiler": row["kernels"][kname]["device_s"] * 1e3
                / max(1, row["kernels"][kname]["launches"]), "cuda_graph": graph_ms[kname]}
        for kname in KERNELS}
    emit({"phase": "train_breakdown", **row})
    check(bool(tk), "train breakdown: the profiler saw no device kernel")
    del engine
    torch.cuda.empty_cache()

    # ---- the training path resumed: save, load and resume bit for bit (sync
    # and async), torn and corrupt tags refused, the SDC probe; then the
    # TrainSupervisor under a chaos plan against the fault-free stream
    resume_counts = train_resume_phase(gen, card)
    supervised_counts = train_supervised_phase(gen, card)

    # ---- the block-sparse training path: GPT-2 125M at seq 4096, micro-batch
    # 2, bf16, no remat, the JAX package's long_ctx bench shape
    # (_bench_impl.py:277-296 bench_long_ctx) with the attention switched to
    # the block-sparse kernels and the default layout (the fixed pattern,
    # block 64, 4 local blocks, 1 global block, bidirectional, masked causal)
    smodel = tf.TransformerModel.from_preset("gpt2-125m", dtype="bfloat16", max_seq_len=4096,
                                             attn_impl="block_sparse")
    B_S, S_S = 2, 4096
    sengine = deepspeed_tpu_torch.initialize(model=smodel, config=train_config(B_S))[0]
    scfg = sengine.model.cfg
    sbatch = {"input_ids": torch.randint(0, V_T, (B_S, S_S), generator=gen, device="cuda")}
    srun = timed_training(sengine, sbatch, warmup, steps)
    sparse_counts = srun["counts"]
    smed_s = statistics.median(srun["step_s"])
    # K1-K3 none, K7/K8 by the norm count: the training row's rule
    srow = training_row("train_sparse", scfg, srun, B_S, S_S, steps)
    for kname in SPARSE_KERNELS:
        check(sparse_counts[kname] == scfg.num_layers * steps,
              f"train_sparse: {kname} launched {sparse_counts[kname]} times in {steps} steps, "
              f"expected {scfg.num_layers} per step")
    slayout, sblock = tf._sparse_layout((("mode", "fixed"),), scfg.num_heads, S_S)
    svariant = bs.kernel_variant(torch.bfloat16, min(sblock, bs.MAX_TILE))
    check(svariant == "tensor_core",
          f"train_sparse: K4-K6 at block {sblock} run the {svariant} kernels, not the "
          f"tensor-core ones")
    live_pairs = attention_pairs(S_S, S_S, True, None, layout=slayout, block=sblock)
    attn_dense = 12 * scfg.num_layers * scfg.hidden_size * S_S
    sparse_fpt = (srow["flops_per_token"] - attn_dense
                  + attn_dense * live_pairs / scfg.num_heads / S_S ** 2)
    emit({"phase": "train_sparse", "model": "gpt2-125m", "warmup_steps": warmup, **srow,
          "sparse_attention": "default (fixed, block 64)",
          "live_causal_pairs_per_head": live_pairs / scfg.num_heads,
          "mfu_live_pairs_count": (sparse_fpt * srow["tokens_per_s"]
                                   / PEAK_FLOPS[torch.bfloat16]),
          "flops_per_token_live_pairs": sparse_fpt, "variant": svariant,
          "launches": {k: sparse_counts[k] for k in SPARSE_KERNELS + KERNELS + NORM_KERNELS},
          "launches_per_step": {k: sparse_counts[k] / steps
                                for k in SPARSE_KERNELS + KERNELS + NORM_KERNELS},
          "card": card})

    # ---- the block-sparse kernels in the model with the dense layout (full
    # causal attention): the first bf16 step against the flash engine's first
    # step above (GPT-2 125M B8 S1024, same weights), and in f32 at 2 layers
    # every gradient leaf against the xla engine
    dense_layout = {"mode": "dense", "block": 64}
    dmodel = tf.TransformerModel.from_preset("gpt2-125m", dtype="bfloat16",
                                             attn_impl="block_sparse",
                                             sparse_attention=dense_layout)
    dengine = deepspeed_tpu_torch.initialize(model=dmodel, config=TRAIN_CONFIG,
                                             params=init_params)[0]
    dloss = float(engine_step(dengine, batch)[0])
    dgnorm = dengine.get_global_grad_norm()
    del dengine, init_params
    torch.cuda.empty_cache()
    dgnorm_rel = abs(dgnorm - gnorm0) / gnorm0
    check(abs(dloss - losses[0]) <= TRAIN_LOSS_TOL and dgnorm_rel <= TRAIN_GNORM_REL_TOL,
          f"train_sparse_dense_layout: first step vs flash engine: loss {dloss} vs {losses[0]}, "
          f"grad norm {dgnorm} vs {gnorm0}")
    grads = f32_grads({
        "block_sparse": tf.get_config("gpt2-125m", dtype="float32", attn_impl="block_sparse",
                                      num_layers=2, sparse_attention=dense_layout),
        "xla": tf.get_config("gpt2-125m", dtype="float32", attn_impl="xla", num_layers=2)})
    d_rel = leaf_rel(grads["block_sparse"][1], grads["xla"][1])
    d_worst = max(d_rel, key=d_rel.get)
    d_dloss = abs(grads["block_sparse"][0] - grads["xla"][0])
    check(d_rel[d_worst] <= F32_GRAD_REL_TOL and d_dloss <= F32_LOSS_TOL,
          f"train_sparse_dense_layout f32: block-sparse vs xla engine: loss "
          f"{grads['block_sparse'][0]} vs {grads['xla'][0]}, worst leaf {d_worst} at "
          f"{d_rel[d_worst]} of its max |grad|")
    emit({"phase": "train_sparse_dense_layout", "sparse_attention": dense_layout,
          "bf16_first_step_vs_flash": {
              "model": "gpt2-125m", "batch": B_T, "seq": S_T, "loss": dloss,
              "flash_loss": losses[0], "loss_abs_diff": abs(dloss - losses[0]),
              "grad_norm": dgnorm, "flash_grad_norm": gnorm0, "grad_norm_rel_diff": dgnorm_rel,
              "loss_tol": TRAIN_LOSS_TOL, "grad_norm_rel_tol": TRAIN_GNORM_REL_TOL},
          "f32_vs_xla": {
              "model": "gpt2-125m width, 2 layers",
              "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "loss": grads["block_sparse"][0], "xla_loss": grads["xla"][0],
              "loss_abs_diff": d_dloss, "loss_tol": F32_LOSS_TOL, "leaves": len(d_rel),
              "worst_leaf": d_worst, "worst_rel": d_rel[d_worst], "rel_tol": F32_GRAD_REL_TOL},
          "card": card})
    del grads
    torch.cuda.empty_cache()

    # ---- where the block-sparse training step's time goes
    tk, row = step_breakdown(sengine, sbatch, SPARSE_KERNELS, smed_s * 1e3, card)
    emit({"phase": "train_sparse_breakdown", **row})
    check(bool(tk), "train_sparse breakdown: the profiler saw no device kernel")
    del sengine
    torch.cuda.empty_cache()

    # ---- Llama-family serving: Llama 2 7B (fused and per-token with bucket
    # migration), its weights through an HF checkpoint directory, then
    # Mistral 7B's shape with the rolling cache on and off; one 7B model on
    # the card at a time, each path counted from 0
    llama_counts, llama_k7, handoff = llama_serve_phase(gen, card)
    hf_llama_counts = hf_load_llama_phase(handoff, card)
    ring_counts = mistral_ring_phase(gen, card)
    check(llama_counts.get("flash_fwd", 0) > 0 and llama_counts.get("fused_norm_fwd", 0) > 0
          and ring_counts.get("flash_fwd", 0) > 0 and ring_counts.get("fused_norm_fwd", 0) > 0,
          "llama paths: K1 or K7 never launched on llama_serve or mistral_ring")

    # ---- HF models in: GPT-2 350M from an HF module and a saved directory,
    # then every decoder family the policies convert
    hf_counts = {k: hf_llama_counts.get(k, 0) + c
                 for k, c in hf_load_gpt2_phase(gen, card).items()}
    family_counts = hf_families_phase(gen, card)
    check(hf_counts.get("flash_fwd", 0) > 0 and hf_counts.get("fused_norm_fwd", 0) > 0
          and family_counts.get("fused_norm_fwd", 0) > 0,
          "HF paths: K1 never launched on hf_load, or K7 on hf_load or hf_families")

    # ---- training every decoder family: Llama 2 7B's width (4 layers),
    # Mistral 7B's shape (2 layers, the window band), the six HF families,
    # and a fine-tune from an HF directory back out to one, each path
    # counted from 0
    decoder_counts, _ = train_decoders(gen, card)
    zero_counts = train_zero_phase(gen, card)
    # ---- the tensor-parallel serving mesh: world 1 through NCCL against the
    # engines without a mesh, then tensor 2 as two processes on the card
    mesh_counts = serve_mesh_phase(gen, card)
    # ---- ZeRO-sharded checkpoints: a stage-3 tag of two processes on the
    # card over gloo, resumed, loaded at stage 0 and 1, converted offline
    zero_ckpt_counts = train_zero_ckpt_phase(gen, card)

    e1, a23, a456 = k1["e_train_b8_s1024"], k23["a_train_b8_s1024"], k456["a_fixed_b2_s4096"]
    a78 = k78["a_ln_8192x768_bf16"]

    def bwd_err(grad_names):
        return max(row["max_abs_err"][g] for row in k23.values() for g in grad_names)

    def train_bwd_shapes(kernel):
        """K2's or K3's numbers at the decoder-training shapes (k2_k3 f, g)."""
        return {name: {"max_abs_err": k23[name]["max_abs_err"], "ms": k23[name][f"{kernel}_ms"],
                       "plain_ms": k23[name]["plain_bwd_ms"],
                       "bound_ms": k23[name][f"{kernel}_bound_ms"],
                       "bound_by": k23[name][f"{kernel}_bound_by"],
                       "library_ms": k23[name]["sdpa_bwd_ms"],
                       "tflops": k23[name][f"{kernel}_tflops"]} for name in TRAIN_K23_ROWS}

    def train_norm_shape(kernel):
        """K7's or K8's numbers at train_llama's rows (k7_k8 f)."""
        row = k78["f_rms_8192x4096_bf16"]
        keys = {"ms": f"{kernel}_ms", "bound_ms": f"{kernel}_bound_ms",
                "bound_by": f"{kernel}_bound_by",
                "plain_ms": "plain_fwd_ms" if kernel == "k7" else "plain_bwd_ms",
                "library_ms": "library_fwd_ms" if kernel == "k7" else "library_bwd_ms"}
        return {"shape": "RMSNorm rows 8192 x D 4096 bf16 (train_llama)",
                "max_abs_err": row["max_abs_err"]["out" if kernel == "k7" else "dx"],
                "variant": row["variant"], **{k: row[v] for k, v in keys.items()}}

    def sparse_err(grad_names):
        return max(row["max_abs_err"][g] for row in k456.values() for g in grad_names)

    def launches(kname):
        by_path = {"serve": serve_counts.get(kname, 0),
                   "serve_int8": int8_counts.get(kname, 0),
                   "serve_ragged": ragged_counts.get(kname, 0),
                   "serve_pool": pool_counts.get(kname, 0),
                   "serve_spec": spec_counts.get(kname, 0),
                   "serve_pool_spec": pool_spec_counts.get(kname, 0),
                   "serve_layer": layer_counts.get(kname, 0),
                   "serve_fleet": fleet_counts.get(kname, 0),
                   "train": train_counts.get(kname, 0),
                   "train_resume": resume_counts.get(kname, 0),
                   "train_supervised": supervised_counts.get(kname, 0),
                   "train_sparse": sparse_counts.get(kname, 0),
                   "fused_ops": fused_counts.get(kname, 0),
                   "llama_serve": llama_counts.get(kname, 0),
                   "mistral_ring": ring_counts.get(kname, 0),
                   "hf_load": hf_counts.get(kname, 0),
                   "hf_families": family_counts.get(kname, 0),
                   **{path: c.get(kname, 0) for path, c in decoder_counts.items()},
                   "train_zero": zero_counts.get(kname, 0),
                   "serve_mesh": mesh_counts.get(kname, 0),
                   "train_zero_ckpt": zero_ckpt_counts.get(kname, 0)}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path}

    src = "deepspeed_tpu_torch/ops/csrc"
    pallas = "deepspeed_tpu/ops/pallas"
    sparse_shape = "B2 S4096 H12 hd64 fixed layout causal bf16"
    norm_shape = "LayerNorm rows 8192 x D 768 bf16 (GPT-2 125M, B8 S1024)"
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": f"{src}/flash_fwd.cu",
         "replaces": f"{pallas}/flash_attention.py:85", **launches("flash_fwd"),
         "max_abs_err": max(row["max_abs_err_o"] for row in k1.values()),
         "variant": e1["variant"],
         "shape": "B8 S1024 H12 hd64 causal bf16",
         "ms": e1["kernel_ms"], "plain_ms": e1["plain_ms"], "bound_ms": e1["bound_ms"],
         "bound_by": e1["bound_by"], "library_ms": e1["library_ms"],
         "llama_shapes": {name: {key: k1[name][key] for key in (
             "max_abs_err_o", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "tflops")} for name in ("g_llama2_7b_b8_s512", "h_mistral_7b_b1_s4608_w4096")},
         "llama_train_shapes": {name: {key: k1[name][key] for key in (
             "max_abs_err_o", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "tflops")} for name in TRAIN_K1_ROWS}},
        {"name": "flash_bwd_dq", "route": "cuda", "source": f"{src}/flash_bwd.cu",
         "replaces": f"{pallas}/flash_attention.py:222",
         **launches("flash_bwd_dq"), "max_abs_err": bwd_err(["dq"]), "variant": a23["variant"],
         "shape": "B8 S1024 H12 hd64 causal bf16",
         "ms": a23["k2_ms"], "plain_ms": a23["plain_bwd_ms"], "bound_ms": a23["k2_bound_ms"],
         "bound_by": a23["k2_bound_by"], "library_ms": a23["sdpa_bwd_ms"],
         "llama_train_shapes": train_bwd_shapes("k2")},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": f"{src}/flash_bwd.cu",
         "replaces": f"{pallas}/flash_attention.py:271",
         **launches("flash_bwd_dkv"), "max_abs_err": bwd_err(["dk", "dv"]),
         "variant": a23["variant"],
         "shape": "B8 S1024 H12 hd64 causal bf16",
         "ms": a23["k3_ms"], "plain_ms": a23["plain_bwd_ms"], "bound_ms": a23["k3_bound_ms"],
         "bound_by": a23["k3_bound_by"], "library_ms": a23["sdpa_bwd_ms"],
         "llama_train_shapes": train_bwd_shapes("k3")},
        {"name": "block_sparse_fwd", "route": "cuda", "source": f"{src}/block_sparse_fwd.cu",
         "replaces": f"{pallas}/block_sparse_attention.py:31", **launches("block_sparse_fwd"),
         "max_abs_err": sparse_err(["o"]), "variant": a456["variant"], "shape": sparse_shape,
         "ms": a456["k4_ms"], "plain_ms": a456["plain_fwd_ms"], "bound_ms": a456["k4_bound_ms"],
         "bound_by": a456["k4_bound_by"], "library_ms": a456["sdpa_fwd_ms"]},
        {"name": "block_sparse_bwd_dq", "route": "cuda", "source": f"{src}/block_sparse_bwd.cu",
         "replaces": f"{pallas}/block_sparse_attention.py:69",
         **launches("block_sparse_bwd_dq"), "max_abs_err": sparse_err(["dq"]),
         "variant": a456["variant"], "shape": sparse_shape,
         "ms": a456["k5_ms"], "plain_ms": a456["plain_bwd_ms"], "bound_ms": a456["k5_bound_ms"],
         "bound_by": a456["k5_bound_by"], "library_ms": a456["sdpa_bwd_ms"]},
        {"name": "block_sparse_bwd_dkv", "route": "cuda", "source": f"{src}/block_sparse_bwd.cu",
         "replaces": f"{pallas}/block_sparse_attention.py:99",
         **launches("block_sparse_bwd_dkv"), "max_abs_err": sparse_err(["dk", "dv"]),
         "variant": a456["variant"], "shape": sparse_shape,
         "ms": a456["k6_ms"], "plain_ms": a456["plain_bwd_ms"], "bound_ms": a456["k6_bound_ms"],
         "bound_by": a456["k6_bound_by"], "library_ms": a456["sdpa_bwd_ms"]},
        {"name": "fused_norm_fwd", "route": "cuda", "source": f"{src}/fused_norm.cu",
         "replaces": f"{pallas}/fused_norm.py:37", **launches("fused_norm_fwd"),
         "max_abs_err": max(row["max_abs_err"]["out"] for row in k78.values()),
         "variant": a78["variant"], "shape": norm_shape, "ms": a78["k7_ms"],
         "plain_ms": a78["plain_fwd_ms"],
         "bound_ms": a78["k7_bound_ms"], "bound_by": a78["k7_bound_by"],
         "library_ms": a78["library_fwd_ms"],
         "serve_pool_shape": {key: pool_k7[key] for key in (
             "rows", "D", "dtype", "variant", "max_abs_err", "ms", "plain_ms", "library_ms",
             "bound_ms", "bound_by")},
         "llama_decode_shape": {key: llama_k7[key] for key in (
             "rows", "D", "dtype", "kind", "variant", "max_abs_err", "ms", "plain_ms",
             "library_ms", "bound_ms", "bound_by")},
         "llama_train_shape": train_norm_shape("k7")},
        {"name": "fused_norm_bwd", "route": "cuda", "source": f"{src}/fused_norm.cu",
         "replaces": f"{pallas}/fused_norm.py:55", **launches("fused_norm_bwd"),
         "max_abs_err": max(row["max_abs_err"]["dx"] for row in k78.values()),
         "variant": a78["variant"], "shape": norm_shape, "ms": a78["k8_ms"],
         "plain_ms": a78["plain_bwd_ms"],
         "bound_ms": a78["k8_bound_ms"], "bound_by": a78["k8_bound_by"],
         "library_ms": a78["library_bwd_ms"], "llama_train_shape": train_norm_shape("k8")},
    ]})
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    ENTRIES = {("--decode-step",): decode_step_main, ("--serve-pool",): serve_pool_main,
               ("--spec",): spec_main, ("--serve-layer",): serve_layer_main,
               ("--fleet",): serve_fleet_main, ("--llama",): llama_main, ("--hf",): hf_main,
               ("--train-resume",): train_resume_main,
               ("--train-decoders",): train_decoders_main,
               ("--train-zero",): train_zero_main, ("--serve-mesh",): serve_mesh_main,
               ("--train-zero-ckpt",): train_zero_ckpt_main}
    sys.exit(ENTRIES.get(tuple(sys.argv[1:]), main)())
