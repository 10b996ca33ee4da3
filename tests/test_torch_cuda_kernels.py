"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Runs only with an NVIDIA GPU (marker ``cuda``; skips elsewhere, deciding
inside each test). It imports neither JAX nor the reference package, so on
the machine with the card it runs without the repository's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py -m cuda

Tolerances for the flash forward (K1) against ``mha_reference``: the
kernel rounds p to the input dtype before PV (as the TPU kernel does) while
the reference keeps p in f32, so the output differs by a rounding of the
input dtype: two roundings at |o| <= 4 are 3e-2 in bfloat16 (8-bit
mantissa) and 4e-3 in float16; float32 1e-5; lse is f32 on both sides: 1e-5.

Tolerances for the backward kernels (K2 dq, K3 dk/dv) against
``_reference_bwd`` on the same (o, lse, do): the kernels round ds (and, in
K3, p) to the input dtype before the products that use them, as the TPU
kernels do, and round their f32 sums once at the output; the plain version
keeps f32 throughout. Each rounding is unbiased and at most half an ulp
(2**-9 relative in bfloat16, 2**-12 in float16), so the sums differ by a
few such ulps of the gradient's own scale: the bound is 2**-6 (bfloat16),
2**-9 (float16) and 1e-5 (float32, summation order only) times the largest
|gradient| of the reference.
"""

import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops.op_builder import LAUNCHES

pytestmark = pytest.mark.cuda

O_TOL = {torch.bfloat16: 3e-2, torch.float16: 4e-3, torch.float32: 1e-5}
LSE_TOL = 1e-5
GRAD_REL_TOL = {torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -9, torch.float32: 1e-5}
SHAPES = [
    (8, 128, 16, 16, 64, True, None),
    (2, 896, 16, 16, 64, True, None),
    (2, 100, 16, 16, 64, True, None),
    (2, 512, 8, 2, 64, True, 64),
    (2, 512, 8, 2, 64, False, None),
    (1, 300, 4, 1, 128, True, 37),
    (2, 70, 2, 2, 32, False, None),
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel is CUDA C++ with no CPU mode")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window", SHAPES)
def test_flash_kernel_matches_plain_version(dtype, B, S, H, Hkv, hd, causal, window):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(S)
    q = torch.randn(B, S, H, hd, generator=g, device="cuda", dtype=dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device="cuda", dtype=dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device="cuda", dtype=dtype)
    before = LAUNCHES["flash_fwd"]
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_fwd"] == before + 1
    ro, rl = tfa._reference_fwd(q, k, v, causal, hd ** -0.5, window)
    assert o.dtype == dtype and torch.isfinite(o).all()
    assert (o.float() - ro.float()).abs().max().item() <= O_TOL[dtype]
    assert (lse - rl).abs().max().item() <= LSE_TOL


def test_flash_kernel_reads_strided_qkv():
    """q/k/v as views of one fused projection, as the model passes them."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(2, 96, 3 * 4 * 64, generator=g, device="cuda", dtype=torch.bfloat16)
    q, k, v = (t.unflatten(-1, (4, 64)) for t in qkv.split(4 * 64, dim=-1))
    o = tfa.flash_attention(q, k, v)
    ro = tfa.mha_reference(q, k, v)
    assert (o.float() - ro.float()).abs().max().item() <= O_TOL[torch.bfloat16]


def test_flash_kernel_rejects_what_it_does_not_take():
    _need_card()
    q = torch.randn(1, 16, 2, 48, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(q, q, q)
    q = torch.randn(1, 16, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        t = q.transpose(-1, -2).contiguous().transpose(-1, -2)
        tfa.flash_attention(t, t, t)


def _grad_err(got, ref):
    """max |got - ref| over the largest |ref| (the tolerances' unit)."""
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window", SHAPES)
def test_flash_backward_kernels_match_plain_version(dtype, B, S, H, Hkv, hd, causal, window):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(S + 1)
    q = torch.randn(B, S, H, hd, generator=g, device="cuda", dtype=dtype)
    k = torch.randn(B, S, Hkv, hd, generator=g, device="cuda", dtype=dtype)
    v = torch.randn(B, S, Hkv, hd, generator=g, device="cuda", dtype=dtype)
    do = torch.randn(B, S, H, hd, generator=g, device="cuda", dtype=dtype)
    scale = hd ** -0.5
    o, lse = tfa._reference_fwd(q, k, v, causal, scale, window)
    before = dict(LAUNCHES)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
    assert LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
    assert LAUNCHES["flash_fwd"] == before["flash_fwd"]
    rq, rk, rv = tfa._reference_bwd(q, k, v, o, lse, do, causal, scale, window)
    for got, ref in ((dq, rq), (dk, rk), (dv, rv)):
        assert got.shape == ref.shape and got.dtype == dtype and torch.isfinite(got).all()
        assert _grad_err(got, ref) <= GRAD_REL_TOL[dtype]


def test_flash_backward_reads_strided_qkv():
    """Gradients through q/k/v views of one fused projection, as the model
    passes them, against autograd of the plain attention."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(2)
    base = torch.randn(2, 96, 3 * 4 * 64, generator=g, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(2, 96, 4, 64, generator=g, device="cuda", dtype=torch.bfloat16)
    grads = []
    for fn in (tfa.flash_attention, tfa.mha_reference):
        qkv = base.clone().requires_grad_(True)
        q, k, v = (t.unflatten(-1, (4, 64)) for t in qkv.split(4 * 64, dim=-1))
        (fn(q, k, v).float() * w.float()).sum().backward()
        grads.append(qkv.grad)
    assert _grad_err(grads[0], grads[1]) <= 2 * GRAD_REL_TOL[torch.bfloat16]


def test_model_backward_launches_each_kernel_once_per_layer():
    _need_card()
    from deepspeed_tpu_torch.models import transformer as ttf
    from deepspeed_tpu_torch.ops.op_builder import reset_launch_counts

    cfg = ttf.TransformerConfig(vocab_size=128, hidden_size=128, num_layers=3, num_heads=2,
                                max_seq_len=64, dtype="bfloat16", attn_impl="pallas")
    params = ttf.map_params(lambda p: p.to(torch.bfloat16).requires_grad_(True),
                            ttf.init(torch.Generator(device="cuda").manual_seed(0), cfg))
    toks = torch.randint(0, 128, (2, 64), device="cuda")
    reset_launch_counts()
    loss = ttf.loss_fn(params, cfg, {"input_ids": toks})
    loss.backward()
    torch.cuda.synchronize()
    assert LAUNCHES["flash_fwd"] == LAUNCHES["flash_bwd_dq"] == LAUNCHES["flash_bwd_dkv"] == 3
    assert torch.isfinite(loss) and all(torch.isfinite(p.grad).all()
                                        for p in params["layers"][0]["attn"].values())


def test_flash_backward_rejects_a_do_of_another_dtype():
    _need_card()
    q = torch.randn(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
    o, lse = tfa.flash_attention_fwd(q, q, q)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention_bwd(q, q, q, o, lse, o.float())
