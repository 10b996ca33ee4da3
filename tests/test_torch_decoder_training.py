"""Training every decoder family the port serves, against the reference, in
f32 on the CPU: the loss (``deepspeed_tpu_torch.models.transformer.loss_fn``)
and every parameter gradient of a tiny model (2 layers, D 64, 4 heads, V
128) against ``jax.jit(jax.value_and_grad)`` of the reference's ``loss_fn``
on bridged weights, for

- Llama (rope, GQA 4/2, SwiGLU, RMSNorm, untied head), xla and pallas;
- Mistral-like (Llama with a uniform window of 8 at S 32), xla and pallas:
  the window rides the flash band;
- GPT-Neo's per-layer windows (8, 0) with ``attn_scale`` 1.0 (the masked
  path in both packages);
- the decoder variants that ``module_inject``'s policies produce (ALiBi with
  the embedding norm, ALiBi at 6 heads, post-LN, GPT-NeoX, GPT-J), on the
  masked path, and GPT-NeoX on pallas too;
- rope with a block-sparse layout.

The reference's flash and block-sparse kernels run in interpret mode; the
port's autograd functions take their plain versions on CPU tensors. Also:
the flash backward at head dim 128 (Llama 2 7B's MHA and Mistral's group of
4 with a window) against ``jax.vjp`` of the reference's flash kernel; rope
under autograd; the port's flash path against its own masked path at a
length the reference's training forward refuses to tile; the training
features that still raise; the port's init against the reference's
distribution, leaf by leaf; and the first loss that ``chip_smoke.py``
predicts for a tied head behind the embedding norm (BLOOM) against the
port's loss at small widths; and ``chip_smoke.relu_branches``, which pins
a relu's branch where the card's and the CPU's f32 inputs straddle 0.

Tolerances, as in ``tests/test_torch_training.py`` and for the same reason
(f32 on both sides, summation order only): loss 1e-5 absolute; each gradient
leaf max |Δ| / max |ref| <= 1e-4; the flash backward 2e-5 absolute on O(1)
inputs; the cross entropy at the families' vocabularies 2 f32 ulps of the
nll (a vocab-wide sum in another order: at V 250880 and an nll of ~17 the
two sides land 1-2 ulps apart) and 1e-6 on the gradient (bf16: one bf16
rounding, ``tests/test_torch_cross_entropy.py``'s rule). Leaves whose exact gradient is 0 are held to 1e-4 of the tree's
largest gradient instead: the key bias ``bk`` (the softmax cancels it) and
GPT-J's ``ln2``, which its shared LN leaves unused (the reference's
``jax.grad`` gives zeros there, the port's autograd none, taken as zeros).
The rope leaves need no wider bound: XLA's and ATen's sin/cos round the last
bit apart, which moves a rotated q or k by ~1e-7 relative, under the 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.ops.cross_entropy import softmax_cross_entropy as jce
from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu.ops.transformer import inference_ops as jops
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops.cross_entropy import softmax_cross_entropy as tce
from deepspeed_tpu_torch.ops.transformer import inference_ops as tops

LOSS_TOL = 1e-5
GRAD_REL_TOL = 1e-4
FLASH_TOL = 2e-5
V = 128
TINY = dict(vocab_size=V, hidden_size=64, num_layers=2, num_heads=4, max_seq_len=32,
            dtype="float32")
LLAMA = dict(num_kv_heads=2, pos_embedding="rope", norm_type="rmsnorm", activation="silu_glu",
             tie_embeddings=False, use_bias=False, ffn_hidden_size=96)
FAMILIES = {
    "llama": LLAMA,
    "mistral-window8": dict(LLAMA, local_attn_windows=(8, 8)),
    "gpt-neo-windows-8-0": dict(local_attn_windows=(8, 0), attn_scale=1.0),
    # the variants of tests/test_torch_decoder_variants.py
    "alibi-embed-norm": dict(pos_embedding="alibi", embed_norm=True),
    "alibi-6-heads": dict(pos_embedding="alibi", num_heads=6, hidden_size=48),
    "post-ln": dict(norm_position="post", activation="relu"),
    "neox": dict(pos_embedding="rope", rope_dim=8, parallel_residual=True,
                 tie_embeddings=False),
    "gptj": dict(pos_embedding="rope", rope_dim=8, rope_interleaved=True,
                 parallel_residual=True, shared_ln=True, tie_embeddings=False,
                 lm_head_bias=True),
    "llama-block-sparse": dict(LLAMA, attn_impl="block_sparse",
                               sparse_attention={"mode": "fixed", "block": 16,
                                                 "num_local_blocks": 1}),
}
CASES = [("llama", "xla"), ("llama", "pallas"),
         ("mistral-window8", "xla"), ("mistral-window8", "pallas"),
         ("gpt-neo-windows-8-0", "xla"),
         ("alibi-embed-norm", "xla"), ("alibi-6-heads", "xla"), ("post-ln", "xla"),
         ("neox", "xla"), ("neox", "pallas"), ("gptj", "xla"),
         ("llama-block-sparse", None)]
ZERO_GRAD_LEAVES = {"layers.attn.bk"}


def _configs(family, attn_impl, **more):
    over = dict(TINY, **FAMILIES[family], **more)
    if attn_impl is not None:
        over["attn_impl"] = attn_impl
    return jtf.TransformerConfig(**over), ttf.TransformerConfig(**over)


@functools.lru_cache(maxsize=None)
def _numpy_params(family, seed=0):
    """The reference's params, perturbed with seeded noise so that norm
    scales and biases sit away from 1 and 0; built once a module."""
    jcfg, _ = _configs(family, None)
    params = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), jcfg))
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rs.randn(*a.shape)).astype(np.float32), params)


def _tokens(B, S, seed=1):
    return np.random.RandomState(seed).randint(0, V, (B, S)).astype(np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _port_loss_and_grads(tcfg, np_params, tokens):
    """The port's loss and its gradients in the reference's layout; a leaf
    autograd leaves without a gradient (an unused one) counts as zeros."""
    tparams = ttf.params_from_numpy(np_params, tcfg, "cpu")
    ttf.map_params(lambda p: p.requires_grad_(True), tparams)
    loss = ttf.loss_fn(tparams, tcfg, {"input_ids": torch.from_numpy(tokens).long()})
    loss.backward()
    grads = ttf.map_params(lambda p: torch.zeros_like(p) if p.grad is None else p.grad, tparams)
    return loss.item(), dict(_leaves(ttf.params_to_numpy(grads, tcfg)))


def _assert_grads_match(ref, got, zero_leaves=()):
    assert sorted(ref) == sorted(got)
    largest = max(float(np.max(np.abs(g))) for g in ref.values())
    for name, g in ref.items():
        assert got[name].shape == g.shape, name
        d = float(np.max(np.abs(got[name] - g)))
        if name in ZERO_GRAD_LEAVES or name in zero_leaves:
            assert d <= GRAD_REL_TOL * largest, (name, d, largest)
        else:
            assert d <= GRAD_REL_TOL * float(np.max(np.abs(g))), (name, d)


@pytest.mark.parametrize("family,attn_impl", CASES,
                         ids=[f"{f}-{a or 'layout'}" for f, a in CASES])
def test_loss_and_every_grad_match_reference(family, attn_impl):
    jcfg, tcfg = _configs(family, attn_impl)
    np_params = _numpy_params(family)
    tokens = _tokens(2, 32)
    vag = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, {"input_ids": jnp.asarray(tokens)})))
    # finished before the port's side runs (see the cross-entropy test)
    jloss, jgrads = jax.block_until_ready(vag(jax.tree.map(jnp.asarray, np_params)))
    loss, got = _port_loss_and_grads(tcfg, np_params, tokens)
    assert abs(float(jloss) - loss) <= LOSS_TOL
    ref = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    # GPT-J's shared LN leaves ln2 unused: its exact gradient is 0
    zero = {"layers.ln2.scale", "layers.ln2.bias"} if tcfg.shared_ln else set()
    for name in zero:
        assert not np.any(ref[name]) and not np.any(got[name]), name
    _assert_grads_match(ref, got, zero)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_matches_the_reference_distribution(family):
    """The port's init (another generator, so other numbers) against the
    reference's, leaf by leaf in the reference's layout: the same leaves and
    shapes; constant leaves (norm scales, biases) equal; a random leaf's mean
    and standard deviation within 6 standard errors of the reference leaf's
    (n elements: the means within 6 sqrt(2) std / sqrt(n), the stds' ratio
    within 6 / sqrt(n), each side's sample std off by 1 / sqrt(2 n))."""
    jcfg, tcfg = _configs(family, None)
    ref = dict(_leaves(jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(0), jcfg))))
    port = ttf.init(torch.Generator().manual_seed(0), tcfg)
    got = dict(_leaves(ttf.params_to_numpy(port, tcfg)))
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape, name
        if r.std() == 0:
            assert np.array_equal(g, r), name
            continue
        n = r.size
        assert abs(g.mean() - r.mean()) <= 6 * np.sqrt(2) * r.std() / np.sqrt(n), name
        assert abs(g.std() / r.std() - 1) <= 6 / np.sqrt(n), (name, g.std(), r.std())


# (D, heads, V, S): the widths at which a tied head behind the embedding norm
# scores the current token below, near and above ln V
TIED_EMBED_NORM = [(256, 16, 4096, 256), (512, 16, 8192, 256), (384, 6, 4096, 128)]


@pytest.mark.parametrize("width", TIED_EMBED_NORM, ids=lambda w: "d{}-h{}-v{}-s{}".format(*w))
def test_the_first_loss_prediction_for_a_tied_head_behind_the_embedding_norm(width):
    """``chip_smoke.init_loss``, the first loss that the card's training
    phases hold BLOOM to, derived from the init's scales alone, against the
    port's f32 loss of a seeded init (2 layers, ALiBi, the embedding norm, a
    tied head) on random tokens, within 0.1 (a fifth of the card's
    FIRST_LOSS_TOL; the prediction's seeded draw of attention scores and the
    batch's tokens move it by ~0.02)."""
    D, heads, vocab, seq = width
    cfg = ttf.TransformerConfig(vocab_size=vocab, hidden_size=D, num_layers=2, num_heads=heads,
                                max_seq_len=seq, pos_embedding="alibi", embed_norm=True,
                                dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = ttf.init(gen, cfg)
    tokens = torch.randint(0, vocab, (4, seq), generator=gen)
    with torch.no_grad():
        loss = float(ttf.loss_fn(params, cfg, {"input_ids": tokens}))
    assert abs(loss - chip_smoke.init_loss(cfg, seq)) <= 0.1


def test_relu_branches_pin_the_recorded_subgradient():
    """``chip_smoke.relu_branches``, which lets the card's f32 step and the
    CPU's take the same branch where a relu's input straddles 0 between
    them: pinned to its own run's records a step's gradients are unchanged
    bit for bit and nothing straddles; pinned to records with layer 1's
    smallest positive input moved below 0, that one input is counted and
    its unit's ``wi`` gradient moves."""
    _, tcfg = _configs("post-ln", "xla")
    params = ttf.params_from_numpy(_numpy_params("post-ln"), tcfg, "cpu")
    tokens = torch.from_numpy(_tokens(1, 32)).long()

    def step(pinned=None):
        p = ttf.map_params(lambda t: t.clone().requires_grad_(True), params)
        with chip_smoke.relu_branches(pinned) as rec:
            ttf.loss_fn(p, tcfg, {"input_ids": tokens}).backward()
        grads = ttf.map_params(lambda t: torch.zeros_like(t) if t.grad is None else t.grad, p)
        return rec, dict(_leaves(ttf.params_to_numpy(grads, tcfg)))

    rec, grads = step()
    assert len(rec["inputs"]) == tcfg.num_layers
    same, again = step(rec)
    assert same["straddles"] == 0
    assert all(np.array_equal(again[k], g) for k, g in grads.items())
    x = rec["inputs"][1].clone()
    flat = torch.where(x > 0, x, torch.full_like(x, np.inf)).flatten()
    i = int(flat.argmin())
    x.view(-1)[i] = -x.view(-1)[i]
    moved, other = step({"inputs": [rec["inputs"][0], x]})
    assert moved["straddles"] == 1 and moved["straddle_max_abs"] == float(flat[i])
    unit = i % x.shape[-1]
    assert not np.array_equal(other["layers.mlp.wi"][1][:, unit], grads["layers.mlp.wi"][1][:, unit])


def test_the_window_and_gqa_take_the_flash_band_in_training(monkeypatch):
    """Mistral's uniform window and GQA reach the flash kernel's autograd
    function with their kv heads and the window; GPT-Neo's per-layer windows
    and ALiBi stay on the masked path, as in the reference."""
    calls = []
    real = ttf.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw.get("window")))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ttf, "flash_attention", spy)
    tokens = torch.from_numpy(_tokens(1, 32)).long()
    for family, want in (("mistral-window8", [(4, 2, 8)] * 2), ("llama", [(4, 2, None)] * 2),
                         ("gpt-neo-windows-8-0", []), ("alibi-embed-norm", [])):
        _, tcfg = _configs(family, "pallas")
        params = ttf.params_from_numpy(_numpy_params(family), tcfg, "cpu")
        ttf.map_params(lambda p: p.requires_grad_(True), params)
        calls.clear()
        ttf.loss_fn(params, tcfg, {"input_ids": tokens}).backward()
        assert calls == want, family
        assert all(p.grad is not None for p in (params["layers"][0]["attn"]["wqkv"],
                                                params["embed"]["tok"])), family


# name: (B, S, H, Hkv, hd, window); the reference tiles by 32
HD128 = {
    "llama2-7b-mha-hd128": (1, 64, 2, 2, 128, None),
    "mistral-gqa4-window16-hd128": (1, 64, 8, 2, 128, 16),
}


@pytest.mark.parametrize("case", list(HD128))
def test_flash_backward_at_head_dim_128_matches_reference_vjp(case):
    """dq, dk and dv of the port's autograd function at the training
    shapes' head dim, dk and dv with the kv heads' count, against
    ``jax.vjp`` of the reference's flash kernel (interpret mode)."""
    B, S, H, Hkv, hd, window = HD128[case]
    rs = np.random.RandomState(len(case))
    q, do = (rs.randn(B, S, H, hd).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(B, S, Hkv, hd).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, causal=True, window=window,
                                                         block_q=32, block_k=32),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = jax.block_until_ready(vjp(jnp.asarray(do)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, causal=True, window=window)
    got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    assert got[1].shape == (B, S, Hkv, hd) and got[2].shape == (B, S, Hkv, hd)
    for name, r, g in zip(("dq", "dk", "dv"), ref, got):
        assert float(np.max(np.abs(np.asarray(r) - g.numpy()))) <= FLASH_TOL, name


@pytest.mark.parametrize("interleaved,rot_dim", [(False, None), (True, 8)],
                         ids=["half-split", "interleaved-partial"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_under_autograd_matches_reference_vjp(interleaved, rot_dim, dtype):
    """The rotation's gradient: the model's table (``rope_table``) is built
    without a graph, the gradient reaches x alone, through f32 and cast back
    to x's dtype, and it equals ``jax.vjp`` of the reference's rotation bit
    for bit when both rotate with the reference's table."""
    B, S, H, hd = 2, 16, 4, 16
    half = (rot_dim or hd) // 2
    rs = np.random.RandomState(3)
    x, g = (rs.randn(B, S, H, hd).astype(np.float32) for _ in range(2))
    positions = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    assert not any(t.requires_grad for t in tops.rope_table(
        torch.from_numpy(positions).long(), 10000.0, 2 * half))
    freqs = jnp.exp(-np.log(10000.0) * jnp.arange(0, half, dtype=jnp.float32) / half)
    angles = jnp.asarray(positions)[:, :, None].astype(jnp.float32) * freqs[None, None, :]
    table = (torch.from_numpy(np.array(jnp.cos(angles)))[:, :, None, :],
             torch.from_numpy(np.array(jnp.sin(angles)))[:, :, None, :])
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    out = tops.apply_rotary_pos_emb(tx, None, rot_dim=rot_dim, interleaved=interleaved,
                                    table=table)
    (gx,) = torch.autograd.grad(out, tx, torch.from_numpy(g).to(tdt))
    assert out.dtype == tdt and gx.dtype == tdt
    _, vjp = jax.vjp(lambda a: jops.apply_rotary_pos_emb(a, jnp.asarray(positions),
                                                         rot_dim=rot_dim,
                                                         interleaved=interleaved),
                     jnp.asarray(x).astype(jdt))
    (rx,) = jax.block_until_ready(vjp(jnp.asarray(g).astype(jdt)))
    np.testing.assert_array_equal(gx.float().numpy(), np.asarray(rx.astype(jnp.float32)))


def test_the_flash_path_at_a_length_the_reference_will_not_tile_matches_the_masked_path():
    """The port's flash kernels tile any length; the reference's training
    forward refuses S 520 (over 512, not a multiple of 64). There the port's
    flash path is held to its own masked (xla) path: loss 1e-5 and every
    gradient leaf 1e-4 of its max."""
    S = 520
    jcfg, _ = _configs("llama", "pallas", max_seq_len=S)
    np_params = _numpy_params("llama")
    tokens = _tokens(1, S)
    with pytest.raises(ValueError, match="divisible by 64"):
        jtf.loss_fn(jax.tree.map(jnp.asarray, np_params), jcfg,
                    {"input_ids": jnp.asarray(tokens)})
    results = {impl: _port_loss_and_grads(_configs("llama", impl, max_seq_len=S)[1],
                                          np_params, tokens)
               for impl in ("pallas", "xla")}
    assert abs(results["pallas"][0] - results["xla"][0]) <= LOSS_TOL
    _assert_grads_match(results["xla"][1], results["pallas"][1])


# "remat": its offload policy (cpu_checkpointing's host tier) still raises
@pytest.mark.parametrize("over", [dict(dropout=0.1), dict(remat=True, remat_policy="offload"),
                                  dict(random_ltd=True),
                                  dict(pld_enabled=True), dict(causal=False),
                                  dict(type_vocab_size=2), dict(activation="quick_gelu")],
                         ids=["dropout", "remat", "random-ltd", "pld", "bidirectional",
                              "token-types", "quick-gelu"])
def test_the_remaining_training_refusals_name_item_10(over):
    cfg = ttf.TransformerConfig(**dict(TINY, **dict(LLAMA, **over)))
    with pytest.raises(NotImplementedError, match="item 10"):
        ttf.check_trainable(cfg)


# the vocabularies of Llama/Mistral, OPT, Pythia, GPT-J and BLOOM
@pytest.mark.parametrize("vocab", [32000, 50272, 50304, 50400, 250880])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_at_the_families_vocabularies_matches_reference(vocab, dtype):
    rs = np.random.RandomState(vocab)
    logits = torch.from_numpy((2 * rs.randn(2, 4, vocab)).astype(np.float32))
    logits = logits.to(getattr(torch, dtype))
    labels = rs.randint(0, vocab, (2, 4)).astype(np.int32)
    g = rs.randn(2, 4).astype(np.float32)
    jnll, vjp = jax.vjp(lambda x: jce(x, jnp.asarray(labels)),
                        jnp.asarray(logits.float().numpy()).astype(getattr(jnp, dtype)))
    (jgrad,) = vjp(jnp.asarray(g))
    # the port's side runs after the reference's has finished: while XLA's
    # asynchronous CPU work was still running, ATen's vocab-wide sum here
    # came out up to 2.8e-5 off the float64 value in ~1 of 3 runs
    # (ROADMAP.md Queue 3), never once the reference had finished
    jgrad.block_until_ready()
    tl = logits.requires_grad_(True)
    nll = tce(tl, torch.from_numpy(labels).long())
    (nll * torch.from_numpy(g)).sum().backward()
    jnll = np.asarray(jnll)
    assert np.all(np.abs(jnll - nll.detach().numpy()) <= 2 * np.spacing(np.abs(jnll)))
    ref = np.asarray(jgrad.astype(jnp.float32))
    diff = np.abs(ref - tl.grad.float().numpy())
    bound = 1e-6 if dtype == "float32" else 2.0 ** -7 * np.abs(ref) + 1e-6
    assert tl.grad.dtype == tl.dtype and np.all(diff <= bound)
