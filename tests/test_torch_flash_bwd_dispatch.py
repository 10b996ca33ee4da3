"""The flash backward wrapper's choices, held on the CPU with plain tensors:
which kernels (K2/K3) each dtype runs, and which q/k/v/do rows the
tensor-core kernels' 16-byte copies take as they are and which the wrapper
copies first. On the CPU the backward itself is the plain version, so the
last test also holds that an unaligned view changes nothing there.
"""

import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as tfa


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "tensor_core"),
                                           (torch.float16, "tensor_core"),
                                           (torch.float32, "f32_fma")])
def test_variant_is_chosen_by_dtype(dtype, variant):
    """The dtype alone decides: the tensor-core dtypes' kernel wrappers need
    16-byte aligned rows, the f32 FMA kernels take any."""
    assert (dtype in tfa.TENSOR_CORE_DTYPES) == (variant == "tensor_core")
    q = torch.randn(1, 64, 2, 65).to(dtype)[..., 1:]
    if variant == "tensor_core":
        with pytest.raises(ValueError, match="16-byte aligned"):
            tfa._check_bwd_inputs(q, q, q, q)
    else:
        tfa._check_bwd_inputs(q, q, q, q)  # raises nothing


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_variant_refuses_other_dtypes(dtype):
    assert dtype not in tfa.TENSOR_CORE_DTYPES
    q = torch.zeros(1, 64, 2, 64, dtype=dtype)
    with pytest.raises(TypeError, match="float32/float16/bfloat16"):
        tfa._check_bwd_inputs(q, q, q, q)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_views_of_a_fused_qkv_need_no_copy(hd):
    """The model's q, k and v: views of one (B, S, 3 H hd) projection."""
    H = 4
    qkv = torch.zeros(2, 48, 3 * H * hd, dtype=torch.bfloat16)
    for t in (x.unflatten(-1, (H, hd)) for x in qkv.split(H * hd, dim=-1)):
        assert tfa._rows_16b_aligned(t)
        assert tfa._tensor_core_rows(t) is t


def test_unaligned_rows_are_copied_to_aligned_contiguous_rows():
    base = torch.randn(2, 40, 3, 65, dtype=torch.bfloat16)
    odd_offset = base[..., 1:]  # rows start 2 bytes past a 16-byte boundary
    odd_stride = base[..., :64]  # aligned base, row stride 65 elements
    flat = torch.randn(1 + 2 * 40 * 3 * 64, dtype=torch.float16)
    contiguous_unaligned = flat[1:].view(2, 40, 3, 64)  # contiguous, base 2 bytes off
    for t in (odd_offset, odd_stride, contiguous_unaligned):
        assert not tfa._rows_16b_aligned(t)
        copy = tfa._tensor_core_rows(t)
        assert copy.data_ptr() != t.data_ptr() and copy.is_contiguous()
        assert tfa._rows_16b_aligned(copy) and torch.equal(copy, t)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_wrappers_refuse_unaligned_16_bit_rows(dtype):
    """The tensor-core kernels' wrappers take no unaligned row (the entry
    point copies them first); nothing routes such a row to another kernel."""
    q = torch.randn(1, 64, 2, 65, dtype=dtype)[..., 1:]
    lse = torch.zeros(1, 2, 64, 1)
    delta = torch.zeros(1, 2, 64)
    for fn in (tfa._cuda_bwd_dq, tfa._cuda_bwd_dkv):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(q, q, q, q, lse, delta, True, 0.125, None)


def test_f32_rows_need_no_alignment():
    """The f32 FMA kernels read elements through any strides."""
    q = torch.randn(1, 64, 2, 65)[..., 1:]
    tfa._check_bwd_inputs(q, q, q, q)  # raises nothing


def test_cpu_backward_of_unaligned_views_is_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 70, 2, 33, generator=g)[..., 1:] for _ in range(4))
    o, lse = tfa._reference_fwd(q, k, v, True, 32 ** -0.5, None)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    want = tfa._reference_bwd(q.contiguous(), k.contiguous(), v.contiguous(), o, lse,
                              do.contiguous(), True, 32 ** -0.5, None)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)
