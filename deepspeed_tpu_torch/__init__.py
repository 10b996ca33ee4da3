"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu for NVIDIA
Hopper GPUs.

The JAX package ``deepspeed_tpu`` stays the reference; this package mirrors
its module paths and never imports it (nor JAX). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from deepspeed_tpu_torch.version import __version__


def init_inference(model, config=None, params=None, device=None, seed: int = 0,
                   draft_model=None, draft_params=None):
    """Reference: ``deepspeed_tpu.init_inference``. Imported on call, so
    ``import deepspeed_tpu_torch`` stays light."""
    from deepspeed_tpu_torch.inference.engine import init_inference as _init

    return _init(model, config=config, params=params, device=device, seed=seed,
                 draft_model=draft_model, draft_params=draft_params)


def initialize(args=None, model=None, optimizer=None, model_parameters=None, training_data=None,
               lr_scheduler=None, loss_fn=None, params=None, collate_fn=None, config=None,
               config_params=None, device=None, seed=None):
    """Create a training engine (reference: ``deepspeed_tpu.initialize``) on
    one device: a ``TransformerModel`` (or its config) and a config dict or
    JSON path. ``params`` is the reference's numpy tree or this package's
    own, else the weights come from ``seed`` (default: the config's
    ``seed``). Runs on ``cuda`` unless ``device="cpu"``. Returns
    ``(engine, optimizer, training_dataloader, lr_scheduler)``: the third
    is a ``TpuDataLoader`` over ``training_data`` (batched by
    ``collate_fn``), or None without it."""
    from deepspeed_tpu_torch.runtime.config import TpuConfig
    from deepspeed_tpu_torch.runtime.engine import TpuEngine
    from deepspeed_tpu_torch.utils import not_ported

    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("provide config= (dict or path to JSON)")
    if model is None or loss_fn is not None or model_parameters is not None:
        raise not_ported("initialize(loss_fn=..., model_parameters=...) without a TransformerModel")
    engine = TpuEngine(model, TpuConfig(config), params=params, optimizer=optimizer,
                       lr_scheduler=lr_scheduler, device=device, seed=seed,
                       training_data=training_data, collate_fn=collate_fn)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


__all__ = ["__version__", "init_inference", "initialize"]
