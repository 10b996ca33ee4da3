"""The block-sparse kernels' choices, held on the CPU with plain tensors:
which K4/K5/K6 kernels each (dtype, tile) runs, the tensor-core kernels'
launch order (longest list first, the batch rows of a list in consecutive
blocks) and the 16-byte row rule of their operands. The routing to the
kernels is held with the kernel wrappers replaced by recorders; on the CPU
the forward and the backward themselves are the plain versions.

Last, the arithmetic that lets the tensor-core kernels keep the TPU kernels'
f32 dots: an f32 operand (p or ds) split into 16-bit parts (part 0 =
round16(x), each next part round16 of what is left), each multiplied by a
16-bit partner with exact products and f32 sums. Two parts stay within
2**-16 of the float64 product's largest |value| (measured: a few 1e-6);
the kernels' three bfloat16 parts, and two float16 parts of rows scaled by
powers of two, stay within twice the error of x's own f32 product (a few
1e-7); one rounding of x to 16 bits costs about 1e-3 in bfloat16.

Last of all, the tensor-core K4's arithmetic, emulated in plain PyTorch
(tile by tile, an online softmax, p split into 16-bit parts whose products
are summed per tile in f32, acc = acc * corr + t), against the reference's
Pallas forward run in interpret mode on the CPU, as the reference's own tests
run it. Tolerance: o within one rounding of the input dtype plus summation
order of max |o| (2**-8 in bfloat16, 2**-11 in float16), the kernels' card
tolerance; lse (f32 on both sides) within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import block_sparse_attention as jbs
from deepspeed_tpu_torch.ops import block_sparse_attention as tbs
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc

DTYPES = (torch.float32, torch.float16, torch.bfloat16)


@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_variant_is_chosen_by_dtype_and_tile(dtype, tile):
    """K4, K5 and K6 alike: the tensor-core kernels for the 16-bit dtypes at
    the 64-row tile (a wgmma takes 64 rows), the f32 FMA kernels for float32
    (TF32 on the tensor cores) and for tiles 16 and 32."""
    want = "tensor_core" if dtype != torch.float32 and tile == 64 else "f32_fma"
    assert tbs.kernel_variant(dtype, tile) == want
    assert (dtype in tfa.TENSOR_CORE_DTYPES) == (dtype != torch.float32)


@pytest.mark.parametrize("block,tile", [(16, 16), (32, 32), (64, 64), (128, 64)])
def test_layout_blocks_map_to_the_kernels_tile(block, tile):
    layout = tsc.FixedSparsityConfig(num_heads=2, block=block).make_layout(4 * block)
    assert tbs.tile_lists(layout, block, True)["tile"] == tile


# name: (config class, kwargs); layouts of 16 x 16 blocks of 64 at S 1024
LAYOUTS = {
    "fixed": ("FixedSparsityConfig", {}),
    "bigbird": ("BigBirdSparsityConfig", dict(num_random_blocks=2)),
    "bslongformer": ("BSLongformerSparsityConfig", {}),
    "variable": ("VariableSparsityConfig", dict(local_window_blocks=[2, 3],
                                                global_block_indices=[1])),
    "fixed_per_head": ("FixedSparsityConfig", dict(different_layout_per_head=True,
                                                   num_different_global_patterns=4)),
}


def _launch_blocks(order: np.ndarray, batch: int, panels: int) -> np.ndarray:
    """The (b, h, tile) block, as (b * H + h) * n + tile, that each block
    index of a tensor-core K5/K6 launch works on, decoded as the kernels do:
    panel i % panels of batch row (i / panels) % batch of the list
    order[i / (panels * batch)]; every block index in launch order."""
    i = np.arange(order.size * batch * panels)
    code = order[i // (panels * batch)].astype(np.int64)
    return (i // panels) % batch * order.size + code


@pytest.mark.parametrize("block", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_launch_order_is_every_block_longest_list_first(name, causal, block):
    """row_order (K4, K5) and col_order (K6): each (head, tile) list once, as
    h * n + tile, in non-increasing list length, lists of equal length in
    ascending order; the blocks the kernels launch from it (batch rows, and
    K6's panels at hd 128, of one list one after another) are each (batch,
    head, tile) block once, longest list first."""
    cls, kw = LAYOUTS[name]
    H, S = 4, 1024
    layout = getattr(tsc, cls)(num_heads=H, block=block, **kw).make_layout(S)
    lists = tbs.tile_lists(layout, block, causal)
    n = S // 64
    for order, ptr in (("row_order", "row_ptr"), ("col_order", "col_ptr")):
        got = lists[order]
        assert got.dtype == np.int32
        assert np.array_equal(np.sort(got), np.arange(H * n))
        per_head = np.diff(lists[ptr])  # (h, tile) list lengths
        lengths = per_head[got]
        assert (np.diff(lengths) <= 0).all()
        for length in np.unique(lengths):
            ties = got[lengths == length]
            assert (np.diff(ties) > 0).all()
        if len(np.unique(per_head)) > 1:  # an uneven layout is reordered
            assert not np.array_equal(got, np.arange(H * n))
        for batch, panels in ((1, 1), (3, 1), (2, 2)):
            blocks = _launch_blocks(got, batch, panels)
            assert np.array_equal(np.sort(blocks[::panels]), np.arange(batch * H * n))
            assert (np.diff(per_head[blocks % (H * n)]) <= 0).all()


def test_launch_order_of_the_slices_layout():
    """The training slice's fixed layout (12 heads, S 4096, causal): the
    global columns, live in every row at or below them, lead K6's order;
    the first is head 0's column 3, live in rows 3 to 63."""
    layout = tsc.FixedSparsityConfig(num_heads=12).make_layout(4096)
    lists = tbs.tile_lists(layout, 64, True)
    col_len = np.diff(lists["col_ptr"])
    assert lists["col_order"][0] == 3 and col_len[3] == col_len.max() == 61
    assert lists["col_order"].size == lists["row_order"].size == 12 * 64


def test_forward_blocks_of_the_slices_layout_start_with_its_longest_rows():
    """K4 at the training slice's shape (B2, 12 heads, S 4096, fixed layout,
    causal): the blocks it decodes from row_order (batch row i % 2 of list
    i / 2) are every (b, h, tile) once, longest row list first; the first
    24 are the 12 heads' 19-tile rows (the last query tile, which sees every
    global column), both batch rows of each one after another."""
    B, H = 2, 12
    layout = tsc.FixedSparsityConfig(num_heads=H).make_layout(4096)
    lists = tbs.tile_lists(layout, 64, True)
    row_len = np.diff(lists["row_ptr"])
    blocks = _launch_blocks(lists["row_order"], B, 1)
    assert np.array_equal(np.sort(blocks), np.arange(B * H * 64))
    lengths = row_len[blocks % (H * 64)]
    assert (np.diff(lengths) <= 0).all()
    assert row_len.max() == 19 and (lengths[:2 * H] == 19).all() and lengths[2 * H] < 19
    assert np.array_equal(blocks[:2], [63, H * 64 + 63])  # head 0's tile 63, batch rows 0, 1


def test_launch_orders_are_cached_with_the_lists():
    """One copy of the lists and orders a (layout, block, causal): an equal
    layout hits it, causal or not gives its own, and the orders do not
    depend on the batch size, which the kernels apply."""
    layout = tsc.BigBirdSparsityConfig(num_heads=2).make_layout(512)
    one = tbs._lists_on(layout, 64, True, "cpu")
    assert tbs._lists_on(layout.copy(), 64, True, "cpu") is one
    other = tbs._lists_on(layout, 64, False, "cpu")
    assert other is not one and other[1]["row_order"].numel() == one[1]["row_order"].numel()
    assert one[1]["row_order"].numel() == one[1]["col_order"].numel() == 2 * 512 // 64


# ---------------------------------------------------------------------------
# the 16-byte row rule of the tensor-core variant
# ---------------------------------------------------------------------------


@pytest.fixture
def kernel_calls(monkeypatch):
    """The forward's and the backward's CUDA branches with K4, K5 and K6
    replaced by recorders that run the kernel wrappers' own checks on what
    they are handed."""
    calls = []

    def record_fwd(q, k, v, layout, b, causal, sm_scale):
        tbs._setup(q, k, v, layout, b, causal)
        calls.append(("fwd", q, k, v))
        return q, torch.zeros(q.shape[0], q.shape[2], q.shape[1], 1)

    def recorder(kind):
        def record(q, k, v, do, lse, delta, layout, b, causal, sm_scale):
            tbs._setup(q, k, v, layout, b, causal, do)
            calls.append((kind, q, k, v, do))
            return q if kind == "dq" else (k, v)
        return record

    monkeypatch.setattr(tbs, "_device_type", lambda q: "cuda")
    monkeypatch.setattr(tbs, "_cuda_fwd", record_fwd)
    monkeypatch.setattr(tbs, "_cuda_bwd_dq", recorder("dq"))
    monkeypatch.setattr(tbs, "_cuda_bwd_dkv", recorder("dkv"))
    return calls


def _backward(q, k, v, do, block):
    layout = tsc.FixedSparsityConfig(num_heads=q.shape[2], block=block).make_layout(q.shape[1])
    o = torch.zeros_like(q)
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1], 1)
    return tbs.block_sparse_attention_bwd(q, k, v, o, lse, do, layout, causal=True, block=block)


@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_copies_only_the_tensor_core_variants_unaligned_rows(kernel_calls, dtype,
                                                                      block):
    """An unaligned 16-bit q, k, v or do reaches the tensor-core K5/K6 as an
    aligned contiguous copy of the same values, an aligned one as it is; the
    FMA kernels (f32, tile 32) take every row as it is."""
    q = torch.randn(2, 256, 2, 65).to(dtype)[..., 1:]
    k = torch.randn(2, 256, 2, 64).to(dtype)
    v = torch.randn(2, 256, 2, 65).to(dtype)[..., :64]
    do = torch.randn(2, 256, 2, 65).to(dtype)[..., 1:]
    _backward(q, k, v, do, block)
    assert [c[0] for c in kernel_calls] == ["dq", "dkv"]
    tensor_core = tbs.kernel_variant(dtype, min(block, 64)) == "tensor_core"
    for call in kernel_calls:
        sent_q, sent_k, sent_v, sent_do = call[1:]
        assert sent_k is k
        for sent, given in ((sent_q, q), (sent_v, v), (sent_do, do)):
            if tensor_core:
                assert sent is not given and sent.is_contiguous() and tfa._rows_16b_aligned(sent)
                assert torch.equal(sent, given)
            else:
                assert sent is given


@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_copies_only_the_tensor_core_variants_unaligned_rows(kernel_calls, dtype,
                                                                     block):
    """An unaligned 16-bit q, k or v reaches the tensor-core K4 as an aligned
    contiguous copy of the same values, an aligned one as it is; the FMA
    kernel (f32, tile 32) takes every row as it is."""
    q = torch.randn(2, 256, 2, 65).to(dtype)[..., 1:]
    k = torch.randn(2, 256, 2, 64).to(dtype)
    v = torch.randn(2, 256, 2, 65).to(dtype)[..., :64]
    layout = tsc.FixedSparsityConfig(num_heads=2, block=block).make_layout(256)
    tbs.block_sparse_attention_fwd(q, k, v, layout, causal=True, block=block)
    assert [c[0] for c in kernel_calls] == ["fwd"]
    _, sent_q, sent_k, sent_v = kernel_calls[0]
    assert sent_k is k
    for sent, given in ((sent_q, q), (sent_v, v)):
        if tbs.kernel_variant(dtype, min(block, 64)) == "tensor_core":
            assert sent is not given and sent.is_contiguous() and tfa._rows_16b_aligned(sent)
            assert torch.equal(sent, given)
        else:
            assert sent is given


def test_model_views_of_a_fused_qkv_reach_the_kernels_uncopied(kernel_calls):
    """The model's q, k and v, views of one (B, S, 3 H hd) projection, and a
    contiguous do reach the tensor-core K4, K5 and K6 as they are, through
    the model's entry (autograd) and the backward's."""
    H, hd = 4, 64
    qkv = torch.zeros(2, 256, 3 * H * hd, dtype=torch.bfloat16, requires_grad=True)
    q, k, v = (t.unflatten(-1, (H, hd)) for t in qkv.split(H * hd, dim=-1))
    layout = tsc.FixedSparsityConfig(num_heads=H, block=64).make_layout(256)
    tbs.block_sparse_attention(q, k, v, layout, causal=True, block=64)
    do = torch.zeros(2, 256, H, hd, dtype=torch.bfloat16)
    _backward(q, k, v, do, 64)
    assert [c[0] for c in kernel_calls] == ["fwd", "dq", "dkv"]
    for call in kernel_calls:
        assert all(sent is given for sent, given in zip(call[1:], (q, k, v, do)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_refuses_a_last_dimension_that_is_not_contiguous(kernel_calls, dtype):
    """The row copy fixes where rows start, not their layout: a q whose last
    dimension is strided is refused for every dtype, as the kernels take
    none."""
    t = torch.randn(2, 128, 64, 2).to(dtype).transpose(-1, -2)
    assert t.stride(-1) != 1 and tfa._tensor_core_rows(t) is t
    with pytest.raises(ValueError, match="contiguous last dimension"):
        _backward(t, t, t, torch.zeros_like(t).contiguous(), 64)
    assert not kernel_calls


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_wrappers_refuse_unaligned_16_bit_rows_at_tile_64(dtype):
    """K4's, K5's and K6's wrappers check the rows before they build or
    launch anything: an unaligned 16-bit operand is refused at tile 64 (the
    tensor-core variant) and taken at tile 32 (the FMA kernels). K4's own
    wrapper, ``_cuda_fwd``, refuses it before it touches the card."""
    bad = torch.randn(1, 128, 2, 65, dtype=dtype)[..., 1:]
    good = torch.randn(1, 128, 2, 64, dtype=dtype)
    for q, k, v, do in ((bad, good, good, good), (good, bad, good, good),
                        (good, good, bad, good), (good, good, good, bad)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            tbs._check_kernel_inputs(q, k, v, 64, do, aligned_rows=True)
        layout = tsc.FixedSparsityConfig(num_heads=2, block=64).make_layout(128)
        with pytest.raises(ValueError, match="16-byte aligned"):
            tbs._setup(q, k, v, layout, 64, True, do)
        if do is good:
            with pytest.raises(ValueError, match="16-byte aligned"):
                tbs._cuda_fwd(q, k, v, layout, 64, True, 0.125)
        layout = tsc.FixedSparsityConfig(num_heads=2, block=32).make_layout(128)
        assert tbs._setup(q, k, v, layout, 32, True, do)[0] == "f32_fma"
        assert tbs._setup(q, k, v, layout, 32, True)[0] == "f32_fma"


def test_cpu_backward_of_unaligned_views_is_the_plain_version():
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 128, 2, 33, generator=g)[..., 1:] for _ in range(4))
    layout = tsc.BigBirdSparsityConfig(num_heads=2, block=32).make_layout(128)
    o, lse = tbs._reference_fwd(q, k, v, layout, 32, True, 32 ** -0.5)
    got = tbs.block_sparse_attention_bwd(q, k, v, o, lse, do, layout, causal=True, block=32)
    want = tbs._reference_bwd(q.contiguous(), k.contiguous(), v.contiguous(), o, lse,
                              do.contiguous(), layout, 32, True, 32 ** -0.5)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the split of an f32 operand into 16-bit parts
# ---------------------------------------------------------------------------


def _round16(x: np.ndarray, dtype: str) -> np.ndarray:
    """f32 values rounded to nearest even at 16 bits, back in f32."""
    if dtype == "float16":
        return x.astype(np.float16).astype(np.float32)
    bits = x.astype(np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1)))
    return (bits & np.uint32(0xFFFF0000)).view(np.float32)


def test_bfloat16_rounding_helper_matches_torch():
    scales = 10.0 ** np.arange(-4, 4).repeat(512)
    x = (np.random.RandomState(1).randn(4096) * scales).astype(np.float32)
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert np.array_equal(_round16(x, "bfloat16"), want)


def _operand(kind: str) -> np.ndarray:
    """64 x 4096 f32: a softmax-shaped p, or a random ds."""
    rs = np.random.RandomState(0 if kind == "p" else 1)
    if kind == "ds":
        return (rs.randn(64, 4096) * 1e-2).astype(np.float32)
    s = rs.randn(64, 4096).astype(np.float32) * 2.0
    x = np.exp(s - s.max(-1, keepdims=True))
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _split_product(x, partner, dtype, parts, row_scale):
    """sum over x's 16-bit parts of part @ partner, each product exact and
    summed in f32, as the kernels' split products; with ``row_scale`` each
    row of x first times the power of two that puts its largest |value| in
    [2**14, 2**15) and the product divided by it again (float16's
    scale_rows)."""
    scale = np.ones((x.shape[0], 1))
    if row_scale:
        scale = 2.0 ** (14 - np.floor(np.log2(np.abs(x).max(-1, keepdims=True))))
    rest = (x * scale).astype(np.float32)
    total = np.zeros((x.shape[0], partner.shape[1]), np.float32)
    for _ in range(parts):
        part = _round16(rest, dtype)
        assert np.array_equal(rest - part, rest.astype(np.float64) - part)  # exact in f32
        rest = rest - part
        total = total + (part @ partner).astype(np.float32)
    return total / scale


# (dtype, parts, row_scale): two parts, as first planned, are held within
# 2**-16; the kernels' choice (three bfloat16 parts; two float16 parts of
# rows scaled by powers of two) within twice the error of x's own f32
# product with the partner
SPLITS = [("bfloat16", 2, False), ("float16", 2, False), ("bfloat16", 3, False),
          ("float16", 2, True)]


@pytest.mark.parametrize("operand", ["p", "ds"])
@pytest.mark.parametrize("dtype,parts,row_scale", SPLITS)
def test_split_products_keep_the_f32_operand(dtype, parts, row_scale, operand):
    """x (64 x 4096 f32, a softmax-shaped p or a random ds) times a 16-bit
    partner (4096 x 64), as the kernels' dQ += ds K and dV += p^T dO: the
    sum of its parts' products against the float64 product, over its
    largest |value|. The product of x rounded once to 16 bits is printed
    beside it."""
    x = _operand(operand)
    partner = _round16(np.random.RandomState(2).randn(4096, 64).astype(np.float32), dtype)
    exact = x.astype(np.float64) @ partner.astype(np.float64)
    largest = np.abs(exact).max()

    def err(got):
        return np.abs(got - exact).max() / largest

    split_err = err(_split_product(x, partner, dtype, parts, row_scale))
    f32_err, single_err = err(x @ partner), err(_round16(x, dtype) @ partner)
    print(f"{dtype} {operand} {parts} parts{' scaled' if row_scale else ''}: split "
          f"{split_err:.2e}, f32 product {f32_err:.2e}, single rounding {single_err:.2e}")
    if (dtype, parts, row_scale) in (("bfloat16", 2, False), ("float16", 2, False)):
        assert split_err <= 2.0 ** -16
    else:
        assert split_err <= 2 * f32_err
    assert split_err < single_err


# ---------------------------------------------------------------------------
# the tensor-core K4's arithmetic against the reference's Pallas forward
# ---------------------------------------------------------------------------


def _tensor_core_fwd(q, k, v, layout, block, causal, sm_scale):
    """What the tensor-core K4 computes, step by step in plain PyTorch, on
    16-bit (B, S, H, hd) inputs at tile 64: per block decoded from
    row_order, its row list in ascending order; per tile S = Q K^T in f32
    (exact products), scaled, the diagonal tile masked under causal; the
    online softmax in f32 (m, corr = exp(m - m_new), p = exp(s - m_new),
    l = l corr + sum p); p times 2**14 in float16, split into 16-bit parts
    (three in bfloat16, two in float16), each part's product with V exact
    and summed in f32 into the tile's t; acc = acc corr + t; at the end
    o = acc / (max(l, 1e-20) p_scale) rounded once, lse = m + log(max(l,
    1e-20))."""
    dtype = q.dtype
    parts, p_scale = (2, 2.0 ** 14) if dtype == torch.float16 else (3, 1.0)
    B, S, H, hd = q.shape
    lists = tbs.tile_lists(layout, block, causal)
    nq, tile = S // 64, lists["tile"]
    assert tile == 64
    o = torch.zeros(B, S, H, hd, dtype=dtype)
    lse = torch.zeros(B, H, S, 1)
    for blk in _launch_blocks(lists["row_order"], B, 1):
        b, code = divmod(int(blk), H * nq)
        h, qt = divmod(code, nq)
        rows = slice(qt * 64, qt * 64 + 64)
        qf = q[b, rows, h].float()
        m = torch.full((64,), tbs.NEG_INF)
        l, acc = torch.zeros(64), torch.zeros(64, hd)
        for kt in lists["cols"][lists["row_ptr"][code]:lists["row_ptr"][code + 1]]:
            keys = slice(int(kt) * 64, int(kt) * 64 + 64)
            s = (qf @ k[b, keys, h].float().T) * sm_scale
            if causal and kt == qt:
                s = s.masked_fill(torch.ones(64, 64, dtype=torch.bool).triu(1), tbs.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.where(s == tbs.NEG_INF, torch.zeros(()), torch.exp(s - m_new[:, None]))
            l = l * corr + p.sum(-1)
            rest, t = p * p_scale, torch.zeros(64, hd)
            for _ in range(parts):
                part = rest.to(dtype).float()
                t = t + part @ v[b, keys, h].float()
                rest = rest - part
            acc = acc * corr[:, None] + t
            m = m_new
        lc = l.clamp_min(1e-20)
        o[b, rows, h] = (acc / (lc * p_scale)[:, None]).to(dtype)
        lse[b, h, rows, 0] = m + torch.log(lc)
    return o, lse


# name: (config class, kwargs, causal, all-zero layout row); B1 S256 H2 hd64,
# layout block 64: 4 x 4 tiles a head
TC_LAYOUTS = {
    "fixed_causal": ("FixedSparsityConfig", dict(num_local_blocks=2), True, True),
    "bslongformer": ("BSLongformerSparsityConfig", {}, False, False),
}
TC_TOL = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(TC_LAYOUTS))
def test_tensor_core_forward_arithmetic_matches_the_reference_kernel(name, dtype):
    """The tensor-core K4's arithmetic (``_tensor_core_fwd``) against the
    reference's ``_fwd`` (Pallas, interpret mode) on the same 16-bit
    inputs: o within 2**-8 (bfloat16) / 2**-11 (float16) of max |o|, lse
    within 1e-5; a row whose layout row is all zero gives o = 0 and
    lse = -1e30 + log(1e-20) on both sides."""
    cls, kw, causal, zero_row = TC_LAYOUTS[name]
    B, S, H, hd, block = 1, 256, 2, 64, 64
    layout = getattr(tsc, cls)(num_heads=H, block=block, **kw).make_layout(S)
    if zero_row:
        layout[1, 2, :] = 0  # head 1, rows 128..191
    rs = np.random.RandomState(20 + len(name))
    q, k, v = (torch.from_numpy(rs.randn(B, S, H, hd).astype(np.float32)).to(dtype)
               for _ in range(3))
    scale = hd ** -0.5
    o, lse = _tensor_core_fwd(q, k, v, layout, block, causal, scale)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    qt, kt, vt = (jnp.asarray(t.float().numpy().transpose(0, 2, 1, 3)).astype(jdt)
                  for t in (q, k, v))
    o_ref, lse_ref = jbs._fwd(qt, kt, vt, jnp.asarray(layout), causal, scale, block, True)
    o_ref = torch.from_numpy(np.array(o_ref.astype(jnp.float32)).transpose(0, 2, 1, 3))
    lse_ref = torch.from_numpy(np.array(lse_ref))
    err = (o.float() - o_ref).abs().max() / o_ref.abs().max()
    assert o.dtype == dtype and float(err) <= TC_TOL[dtype]
    assert float((lse - lse_ref).abs().max()) <= 1e-5
    if zero_row:
        assert float(o[:, 128:192, 1].float().abs().max()) == 0.0
        assert float(o_ref[:, 128:192, 1].abs().max()) == 0.0
        assert torch.equal(lse[:, 1, 128:192], lse_ref[:, 1, 128:192])
