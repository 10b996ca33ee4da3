"""Memory-efficient softmax cross-entropy for large vocabularies.

Counterpart of ``deepspeed_tpu/ops/cross_entropy.py``. The forward is
``nll = logsumexp(logits) - logits[label]`` with f32 math; the backward is
the closed form ``(softmax(logits) - onehot(label)) * g`` emitted in the
logits' dtype. Residuals kept between the two: the logits in their own dtype
(the vocab projection's backward needs them anyway), the f32 lse (..., ) and
the labels. No f32 tensor of the vocabulary's size survives the forward;
each pass makes one as a temporary. Plain PyTorch: the reference has no
kernel here either.
"""

import torch


def _lse_and_gold(logits, labels):
    logits32 = logits.float()
    m = logits32.amax(dim=-1, keepdim=True)
    lse = torch.log((logits32 - m).exp_().sum(dim=-1)) + m[..., 0]
    gold = torch.gather(logits32, -1, labels[..., None].long())[..., 0]
    return lse, gold


class _SoftmaxCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        lse, gold = _lse_and_gold(logits, labels)
        ctx.save_for_backward(logits, lse, labels)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, labels = ctx.saved_tensors
        # in place on one f32 temporary: softmax, minus the one-hot, times g
        grad = logits.to(torch.float32, copy=True).sub_(lse[..., None]).exp_()
        grad.scatter_add_(-1, labels[..., None].long(),
                          torch.full(labels.shape + (1,), -1.0, device=grad.device))
        return grad.mul_(g[..., None].float()).to(logits.dtype), None


def softmax_cross_entropy(logits, labels):
    """Per-token negative log-likelihood.

    Args:
      logits: (..., V) any float dtype (bf16 preferred).
      labels: (...) integer gold indices.

    Returns:
      nll: (...) float32.
    """
    return _SoftmaxCrossEntropy.apply(logits, labels)
