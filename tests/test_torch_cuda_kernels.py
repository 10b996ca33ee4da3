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
"""

import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops.op_builder import LAUNCHES

pytestmark = pytest.mark.cuda

O_TOL = {torch.bfloat16: 3e-2, torch.float16: 4e-3, torch.float32: 1e-5}
LSE_TOL = 1e-5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel is CUDA C++ with no CPU mode")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("B,S,H,Hkv,hd,causal,window", [
    (8, 128, 16, 16, 64, True, None),
    (2, 896, 16, 16, 64, True, None),
    (2, 100, 16, 16, 64, True, None),
    (2, 512, 8, 2, 64, True, 64),
    (2, 512, 8, 2, 64, False, None),
    (1, 300, 4, 1, 128, True, 37),
    (2, 70, 2, 2, 32, False, None),
])
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
