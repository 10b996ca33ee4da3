"""The port's ``softmax_cross_entropy`` (``deepspeed_tpu_torch.ops.cross_entropy``)
against the reference's, value and gradient, on the CPU.

Tolerance: 1e-6 absolute on the nll and on the gradient. Both sides run the
same f32 formulas and differ only in the summation order of the vocab-wide
sum; with O(1) logits the nll is O(5), where an f32 ulp is 5e-7. bf16
logits: the nll is f32 on both sides from the same bf16 values (1e-6), and
the gradient comes out in bf16 on both sides. A bf16 gradient value may land
one bf16 rounding apart when the two f32 results straddle a rounding
boundary, so it is held to one bf16 ulp (at most 2**-7 of the value) plus
1e-6; most values match exactly.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.ops.cross_entropy import softmax_cross_entropy as jce
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops.cross_entropy import softmax_cross_entropy as tce

TOL = 1e-6
BF16_REL = 2.0 ** -7


def _case(dtype, B=3, S=17, V=301, seed=0):
    rs = np.random.RandomState(seed)
    logits = rs.randn(B, S, V).astype(np.float32)
    if dtype == "bfloat16":  # the same bf16 values on both sides
        logits = logits.astype(ml_dtypes.bfloat16).astype(np.float32)
    labels = rs.randint(0, V, (B, S)).astype(np.int32)
    g = rs.randn(B, S).astype(np.float32)
    return logits, labels, g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_value_and_grad_match_reference(dtype):
    logits, labels, g = _case(dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jl = jnp.asarray(logits).astype(jdt)
    jnll, vjp = jax.vjp(lambda x: jce(x, jnp.asarray(labels)), jl)
    (jgrad,) = vjp(jnp.asarray(g))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_(True)
    nll = tce(tl, torch.from_numpy(labels).long())
    assert nll.dtype == torch.float32 and nll.shape == (3, 17)
    (nll * torch.from_numpy(g)).sum().backward()
    assert tl.grad.dtype == tl.dtype and jgrad.dtype == jdt
    assert float(np.max(np.abs(np.asarray(jnll) - nll.detach().numpy()))) <= TOL
    _check_grad(jgrad, tl.grad)


def _check_grad(jgrad, grad):
    ref = np.asarray(jgrad.astype(jnp.float32))
    diff = np.abs(ref - grad.float().numpy())
    if grad.dtype == torch.float32:
        assert float(diff.max()) <= TOL
    else:
        assert np.all(diff <= BF16_REL * np.abs(ref) + TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("labels,mask", [(False, False), (True, False), (False, True), (True, True)])
def test_ce_from_logits_with_labels_and_loss_mask_matches_reference(dtype, labels, mask):
    logits, lab, _ = _case(dtype, seed=1)
    toks = np.random.RandomState(2).randint(0, 301, (3, 17)).astype(np.int32)
    batch = {"input_ids": toks}
    if labels:
        batch["labels"] = lab
    if mask:
        batch["loss_mask"] = (np.random.RandomState(3).rand(3, 17) < 0.6).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jbatch = jax.tree.map(jnp.asarray, batch)
    jloss, jgrad = jax.value_and_grad(
        lambda x: jtf._ce_from_logits(x, jbatch, jbatch["input_ids"]))(jnp.asarray(logits).astype(jdt))
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
              for k, v in batch.items()}
    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_(True)
    loss = ttf._ce_from_logits(tl, tbatch, tbatch["input_ids"])
    loss.backward()
    assert abs(float(jloss) - loss.item()) <= TOL
    assert tl.grad.dtype == tl.dtype
    _check_grad(jgrad, tl.grad)


def test_backward_leaves_the_saved_logits_alone():
    logits, labels, g = _case("float32", seed=4)
    tl = torch.from_numpy(logits.copy()).requires_grad_(True)
    (tce(tl, torch.from_numpy(labels).long()) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(tl.detach().numpy(), logits)
