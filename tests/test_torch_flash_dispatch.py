"""The flash wrappers' choices, held on the CPU with plain tensors: which
kernels each dtype runs (the forward K1, the backward K2/K3), and which
q/k/v/do rows the tensor-core kernels' 16-byte copies take as they are and
which the wrapper copies first. The one row check
(``flash_attention._check_kernel_inputs``) runs before any launch, so it is
held here on CPU tensors; the forward's routing to the kernel is held with the
kernel wrapper replaced by a recorder. On the CPU the forward and the
backward themselves are the plain versions, so the last tests also hold that
an unaligned view changes nothing there.
"""

import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as tfa


@pytest.mark.parametrize("operands", [3, 4], ids=["forward", "backward"])
@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "tensor_core"),
                                           (torch.float16, "tensor_core"),
                                           (torch.float32, "f32_fma")])
def test_variant_is_chosen_by_dtype(dtype, variant, operands):
    """The dtype alone decides, for the forward's q, k, v as for the
    backward's q, k, v, do: the tensor-core dtypes' kernel wrappers need
    16-byte aligned rows, the f32 FMA kernels take any."""
    assert (dtype in tfa.TENSOR_CORE_DTYPES) == (variant == "tensor_core")
    q = torch.randn(1, 64, 2, 65).to(dtype)[..., 1:]
    if variant == "tensor_core":
        with pytest.raises(ValueError, match="16-byte aligned"):
            tfa._check_kernel_inputs(*[q] * operands)
    else:
        tfa._check_kernel_inputs(*[q] * operands)  # raises nothing


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_variant_refuses_other_dtypes(dtype):
    assert dtype not in tfa.TENSOR_CORE_DTYPES
    q = torch.zeros(1, 64, 2, 64, dtype=dtype)
    with pytest.raises(TypeError, match="float32/float16/bfloat16"):
        tfa._check_kernel_inputs(q, q, q, q)


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
    """The tensor-core kernels' wrappers (K1, K2, K3) take no unaligned row
    in any operand (the entry points copy them first), and check before they
    build or launch anything; nothing routes such a row to another kernel."""
    bad = torch.randn(1, 64, 2, 65, dtype=dtype)[..., 1:]
    good = torch.randn(1, 64, 2, 64, dtype=dtype)
    lse = torch.zeros(1, 2, 64, 1)
    delta = torch.zeros(1, 2, 64)
    for q, k, v in ((bad, bad, bad), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            tfa._cuda_fwd(q, k, v, True, 0.125, None)
        for fn in (tfa._cuda_bwd_dq, tfa._cuda_bwd_dkv):
            with pytest.raises(ValueError, match="16-byte aligned"):
                fn(q, k, v, q, lse, delta, True, 0.125, None)


def test_f32_rows_need_no_alignment():
    """The f32 FMA kernels, forward and backward, read elements through any
    strides."""
    q = torch.randn(1, 64, 2, 65)[..., 1:]
    tfa._check_kernel_inputs(q, q, q)  # raises nothing
    tfa._check_kernel_inputs(q, q, q, q)


def test_cpu_backward_of_unaligned_views_is_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 70, 2, 33, generator=g)[..., 1:] for _ in range(4))
    o, lse = tfa._reference_fwd(q, k, v, True, 32 ** -0.5, None)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do)
    want = tfa._reference_bwd(q.contiguous(), k.contiguous(), v.contiguous(), o, lse,
                              do.contiguous(), True, 32 ** -0.5, None)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the forward (K1)
# ---------------------------------------------------------------------------


@pytest.fixture
def kernel_calls(monkeypatch):
    """The forward's CUDA branch with K1 replaced by a recorder of the
    tensors it would have been handed."""
    calls = []

    def record(q, k, v, causal, sm_scale, window):
        tfa._check_kernel_inputs(q, k, v)
        calls.append((q, k, v))
        return q, None

    monkeypatch.setattr(tfa, "_device_type", lambda q: "cuda")
    monkeypatch.setattr(tfa, "_cuda_fwd", record)
    return calls


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 1)])
def test_forward_hands_fused_qkv_views_to_the_kernel_uncopied(kernel_calls, hd, H, Hkv):
    """The model's q, k and v, views of one (B, S, (H + 2 Hkv) hd)
    projection (GQA too), reach K1 as they are: no copy on the training or
    serving path."""
    qkv = torch.zeros(2, 48, (H + 2 * Hkv) * hd, dtype=torch.bfloat16)
    q, k, v = qkv.split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
    q, k, v = q.unflatten(-1, (H, hd)), k.unflatten(-1, (Hkv, hd)), v.unflatten(-1, (Hkv, hd))
    tfa.flash_attention_fwd(q, k, v)
    assert len(kernel_calls) == 1
    assert all(got is want for got, want in zip(kernel_calls[0], (q, k, v)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_forward_copies_only_unaligned_16_bit_rows(kernel_calls, dtype):
    """An unaligned 16-bit q, k or v reaches K1 as an aligned contiguous copy
    of the same values, an aligned one as it is; f32 rows are never
    copied."""
    q = torch.randn(2, 40, 4, 65).to(dtype)[..., 1:]
    k = torch.randn(2, 40, 2, 64).to(dtype)
    v = torch.randn(2, 40, 2, 65).to(dtype)[..., :64]
    tfa.flash_attention_fwd(q, k, v)
    got = kernel_calls[0]
    assert got[1] is k
    for sent, given in ((got[0], q), (got[2], v)):
        if dtype in tfa.TENSOR_CORE_DTYPES:
            assert sent is not given and sent.is_contiguous() and tfa._rows_16b_aligned(sent)
            assert torch.equal(sent, given)
        else:
            assert sent is given


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_forward_refuses_a_last_dimension_that_is_not_contiguous(kernel_calls, dtype):
    """The row copy fixes where rows start, not their layout: a q whose last
    dimension is strided is refused for every dtype, as the kernels take
    none."""
    t = torch.randn(1, 16, 64, 2).to(dtype).transpose(-1, -2)
    assert t.stride(-1) != 1 and tfa._tensor_core_rows(t) is t
    with pytest.raises(ValueError, match="contiguous last dimension"):
        tfa.flash_attention_fwd(t, t, t)
    assert not kernel_calls


@pytest.mark.parametrize("window", [None, 24])
def test_cpu_forward_of_unaligned_views_is_the_plain_version(window):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 70, 2, 33, generator=g)[..., 1:] for _ in range(3))
    o, lse = tfa.flash_attention_fwd(q, k, v, window=window)
    want_o, want_lse = tfa._reference_fwd(q.contiguous(), k.contiguous(), v.contiguous(), True,
                                          32 ** -0.5, window)
    assert torch.allclose(o, want_o, rtol=0, atol=1e-6)
    assert torch.allclose(lse, want_lse, rtol=0, atol=1e-6)
