"""User-facing MoE layer.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (reference ``deepspeed/moe/
layer.py`` MoE :16 and ``moe/experts.py``): ``MoE.init(generator) ->
params`` / ``MoE.apply(params, x, generator) -> (out, l_aux, exp_counts)``,
the expert params stacked on a leading E dim that carries the ``expert``
logical axis. Weights keep the reference's layout (``x @ w``), so that a
reference tree applies as it is.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.moe.sharded_moe import MoEGroups, moe_forward


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


class MLPExpert:
    """Default expert: a 2-layer MLP (reference experts are arbitrary
    modules; this mirrors the common FFN expert). ``apply`` takes one
    expert's params and (C, D) tokens, or params stacked over E experts and
    (E, C, D) tokens (one batched product each)."""

    def __init__(self, hidden_size: int, ffn_size: int, activation=_gelu):
        self.hidden_size = hidden_size
        self.ffn_size = ffn_size
        self.activation = activation

    def init(self, generator: torch.Generator, num: Optional[int] = None):
        """One expert's params, or ``num`` experts' stacked."""
        D, F_ = self.hidden_size, self.ffn_size
        lead = () if num is None else (num,)
        dev = generator.device

        def normal(*shape):
            return torch.randn(lead + shape, generator=generator, device=dev)

        return {"wi": normal(D, F_) / math.sqrt(D), "wo": normal(F_, D) / math.sqrt(F_)}

    def apply(self, params, x):
        return torch.matmul(self.activation(torch.matmul(x, params["wi"])), params["wo"])

    def logical_specs(self):
        return {"wi": ("expert", "embed", "mlp"), "wo": ("expert", "mlp", "embed")}


class MoE:
    """Mixture of experts over a stacked expert module.

    Args mirror the reference MoE (moe/layer.py:16): num_experts, k (top-k),
    capacity_factor, eval_capacity_factor, min_capacity, drop_tokens,
    use_rts, noisy_gate_policy, use_residual. ``ep_size`` is the mesh's
    ``expert`` axis (``apply(groups=)``).

    ``use_residual=True`` is PR-MoE (reference moe/layer.py:28,45): a dense
    MLP (same shape as one expert) runs every token, and a learned per-token
    2-way softmax coefficient mixes it with the MoE output:
    ``out = moe * coef[..., :1] + dense * coef[..., 1:2]`` (reference
    moe/layer.py:123 channel order).
    """

    def __init__(
        self,
        hidden_size: int,
        expert=None,
        num_experts: int = 1,
        k: int = 1,
        capacity_factor: float = 1.0,
        eval_capacity_factor: float = 1.0,
        min_capacity: int = 4,
        drop_tokens: bool = True,
        use_rts: bool = True,
        noisy_gate_policy: Optional[str] = None,
        ffn_size: Optional[int] = None,
        use_residual: bool = False,
    ):
        assert k in (1, 2), "only top-1 / top-2 gating supported (reference TopKGate :358)"
        self.hidden_size = hidden_size
        self.expert = expert if expert is not None else MLPExpert(hidden_size, ffn_size or 4 * hidden_size)
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.drop_tokens = drop_tokens
        self.use_rts = use_rts
        self.noisy_gate_policy = noisy_gate_policy
        self.use_residual = use_residual

    def init(self, generator: torch.Generator):
        """Params from ``generator``: the reference's shapes and scales (the
        numbers differ: another generator)."""
        D, dev = self.hidden_size, generator.device
        params = {
            "gate": {"w": torch.randn(D, self.num_experts, generator=generator, device=dev) * 0.02},
            "experts": self.expert.init(generator, self.num_experts),
        }
        if self.use_residual:
            params["residual_mlp"] = self.expert.init(generator)
            params["coefficient"] = {
                "w": torch.randn(D, 2, generator=generator, device=dev) * 0.02,
                "b": torch.zeros(2, device=dev),
            }
        return params

    def logical_specs(self):
        specs = {"gate": {"w": ("embed", None)}}
        if hasattr(self.expert, "logical_specs"):
            specs["experts"] = self.expert.logical_specs()
        else:
            specs["experts"] = None
        if self.use_residual:
            # dense residual expert: expert specs minus the leading E axis
            if specs["experts"] is not None:
                specs["residual_mlp"] = {
                    k: tuple(a for a in v if a != "expert")
                    for k, v in specs["experts"].items()
                }
            else:
                specs["residual_mlp"] = None
            specs["coefficient"] = {"w": ("embed", None), "b": (None,)}
        return specs

    def apply(self, params, x, generator: Optional[torch.Generator] = None, training: bool = True,
              groups: Optional[MoEGroups] = None):
        cf = self.capacity_factor if training else self.eval_capacity_factor
        moe_out, l_aux, exp_counts = moe_forward(
            x,
            params["gate"]["w"],
            self.expert.apply,
            params["experts"],
            k=self.k,
            capacity_factor=cf,
            min_capacity=self.min_capacity,
            generator=generator,
            use_rts=self.use_rts and generator is not None,
            drop_tokens=self.drop_tokens,
            noisy_gate_policy=self.noisy_gate_policy,
            groups=groups,
        )
        if self.use_residual:
            dense_out = self.expert.apply(params["residual_mlp"], x)
            coef_p = params["coefficient"]
            coef = torch.softmax(x @ coef_p["w"] + coef_p["b"], dim=-1)
            # channel 0 scales the expert branch, channel 1 the dense MLP
            # (reference moe/layer.py:123)
            moe_out = moe_out * coef[..., 0:1] + dense_out * coef[..., 1:2]
        return moe_out, l_aux, exp_counts

    __call__ = apply
