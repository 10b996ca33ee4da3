"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path (``deepspeed_tpu_torch.init_inference`` ->
``generate``) on GPT-2 350M at full width with random weights from a seed,
after building every CUDA kernel of that path from the sources in this
checkout and holding each against its plain PyTorch version on the card.
Prints JSON lines as it goes; the line before the last names the card and
its power limit (as nvidia-smi reports them), and the last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero without
that line. Needs one CUDA card; exits non-zero without one. Imports nothing
of JAX or of the reference package.
"""

import json
import subprocess
import sys
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# K1 against mha_reference: the kernel rounds p to the input dtype before
# PV (as the TPU kernel does) where the reference keeps f32, so o differs by
# a few roundings of the input dtype; bf16 keeps 8 mantissa bits, so at
# |o| <= 4 two roundings are up to 3e-2. lse is f32 on both sides.
K1_O_TOL = 3e-2
K1_LSE_TOL = 1e-5
# pallas-engine prefill logits against the xla-attention engine, both bf16
# on the same weights: the two attention paths round at different places
# (bf16 q.k logits on the xla path, bf16 p in the kernel), and the
# difference is carried through 24 residual layers; logits here have a
# spread of about 0.6, so 0.1 is a few bf16 roundings of the residual
# stream. Top-1 must agree on every row whose top-2 margin exceeds twice
# the tolerance (closer rows are ties either path may break).
LOGITS_TOL = 0.1

failures = []


def emit(obj):
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


def ptxas_summary(output, tag):
    """ptxas's stack/spill and register lines for the kernel instantiation
    whose mangled name contains ``tag`` (empty when the library was not
    built in this run)."""
    lines = output.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and tag in line:
            return [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3]]
    return []


def attention_pairs(Sq, Sk, causal, window):
    """(query, key) pairs the masks let through: the work this input needs."""
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= qp - kp < window
    return int(ok.sum())


def flash_bound(B, S, H, Hkv, hd, causal, window, itemsize):
    flops = 4.0 * B * H * hd * attention_pairs(S, S, causal, window)
    nbytes = (2 * B * H * S + 2 * B * Hkv * S) * hd * itemsize + 4 * B * H * S
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
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
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import op_builder

    # ---- build: the path's one kernel library (nvcc, from the checkout's source)
    t0 = time.perf_counter()
    fa.KERNEL_LIB.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": fa.KERNEL_LIB.build_seconds,
          "ptxas_bf16_hd64": ptxas_summary(fa.KERNEL_LIB.compiler_output, "nv_bfloat16Li64")})

    # ---- K1 against its plain version at the path's shapes
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = {
        "a_prefill_b8_s128": (8, 128, 16, 16, 64, True, None),
        "b_prefill_b2_s896": (2, 896, 16, 16, 64, True, None),
        "c_ragged_b4_s100": (4, 100, 16, 16, 64, True, None),
        "d_gqa_window64": (2, 512, 8, 2, 64, True, 64),
        "d_gqa_noncausal": (2, 512, 8, 2, 64, False, None),
    }
    k1 = {}
    for name, (B, S, H, Hkv, hd, causal, window) in shapes.items():
        q = torch.randn(B, S, H, hd, generator=gen, device="cuda", dtype=torch.bfloat16)
        k = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda", dtype=torch.bfloat16)
        v = torch.randn(B, S, Hkv, hd, generator=gen, device="cuda", dtype=torch.bfloat16)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ro, rl = fa._reference_fwd(q, k, v, causal, hd ** -0.5, window)
        d_o = (o.float() - ro.float()).abs().max().item()
        d_lse = (lse - rl).abs().max().item()
        check(d_o <= K1_O_TOL and d_lse <= K1_LSE_TOL and bool(torch.isfinite(o).all()),
              f"K1 {name}: |do| {d_o} |dlse| {d_lse}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if window is not None:
            ar = torch.arange(S, device="cuda")
            mask = (ar[None, :] <= ar[:, None]) & (ar[:, None] - ar[None, :] < window)
        bound_ms, bound_by = flash_bound(B, S, H, Hkv, hd, causal, window, 2)
        row = {
            "phase": "k1", "shape": name, "B": B, "S": S, "H": H, "Hkv": Hkv, "hd": hd,
            "causal": causal, "window": window, "dtype": "bfloat16",
            "max_abs_err_o": d_o, "max_abs_err_lse": d_lse,
            "tol_o": K1_O_TOL, "tol_lse": K1_LSE_TOL,
            "kernel_ms": cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                                                window=window)),
            "plain_ms": cuda_ms(lambda: fa._reference_fwd(q, k, v, causal, hd ** -0.5, window)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                enable_gqa=H != Hkv)),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        k1[name] = row
        emit(row)

    # ---- the main path: GPT-2 350M serving, pallas (flash) attention
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
        before = op_builder.launch_counts()["flash_fwd"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(prompts[r["name"]], max_new_tokens=r["new"],
                           temperature=r["temperature"], top_k=r["top_k"],
                           generator=torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = op_builder.launch_counts()["flash_fwd"] - before
        per_request.append((r, out, wall, launched))
    main_counts = op_builder.launch_counts()

    for r, out, wall, launched in per_request:
        B, P, new = r["B"], r["P"], r["new"]
        shape_ok = tuple(out.shape) == (B, P + new)
        range_ok = bool(((out >= 0) & (out < V)).all())
        check(shape_ok and range_ok, f"{r['name']}: output shape {tuple(out.shape)} / range")
        check(launched == L, f"{r['name']}: K1 launched {launched} times, expected {L}")
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
              "k1_launches": launched, "layers": L, "generate_s": wall,
              "new_tokens_per_s": B * new / wall, "tokens_per_s": B * (P + new) / wall,
              "prefill_logits_max_abs_diff_vs_xla": d, "logits_tol": LOGITS_TOL,
              "top1_agree_rows": int(agree.sum()), "top1_decided_rows": int(decided.sum()),
              "rows": B, "card": card})
    check(main_counts["flash_fwd"] > 0, "K1 never launched on the main path")

    # ---- where the time goes: a short generate at the first request's shape,
    # timed, then again under the profiler for the device's kernel time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    toks, n_new = prompts[requests[0]["name"]], 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(toks, max_new_tokens=n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.inference_mode():
        cache = tf.init_cache(cfg, toks.shape[0], cfg.max_seq_len, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tf.forward_with_cache(eng.params, cfg, toks, cache, 0, last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.generate(toks, max_new_tokens=n_new)
        torch.cuda.synchronize()
    device_events = [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels = [(e.key, e.self_device_time_total / 1e6) for e in device_events]
    device_s = sum(t for _, t in kernels)
    emit({"phase": "breakdown", "request": requests[0]["name"], "new_tokens": n_new,
          "generate_s": wall, "prefill_s": prefill_s,
          "decode_step_ms": (wall - prefill_s) / (n_new - 1) * 1e3,
          "device_kernel_s": device_s if kernels else "not measured",
          "device_busy_share": device_s / wall if kernels else "not measured",
          "k1_device_s": sum(t for k, t in kernels if "flash_fwd_kernel" in k),
          "device_kernel_launches": sum(e.count for e in device_events),
          "top_kernels": [{"name": k[:90], "s": t}
                          for k, t in sorted(kernels, key=lambda kt: -kt[1])[:8]],
          "card": card})

    a = k1["a_prefill_b8_s128"]
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda", "source": "deepspeed_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:85",
        "launches": main_counts["flash_fwd"],
        "max_abs_err": max(row["max_abs_err_o"] for row in k1.values()),
        "ms": a["kernel_ms"], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"], "library_ms": a["library_ms"],
    }]})
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
