"""Package boundaries of the PyTorch/CUDA port: it never imports JAX or the
reference package, and its entry points run on CUDA or raise, never falling
back to the CPU unasked."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.accelerator import get_accelerator
from deepspeed_tpu_torch.models import transformer as ttf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "deepspeed_tpu_torch")
TINY = ttf.TransformerConfig(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                             max_seq_len=64, dtype="float32")


def test_import_pulls_in_neither_jax_nor_the_reference():
    code = ("import sys, deepspeed_tpu_torch\n"
            "from deepspeed_tpu_torch.inference import engine\n"
            "from deepspeed_tpu_torch.ops import flash_attention, cross_entropy\n"
            "from deepspeed_tpu_torch.ops import block_sparse_attention, fused_norm\n"
            "from deepspeed_tpu_torch.ops.transformer import fused_ops\n"
            "from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config\n"
            "from deepspeed_tpu_torch.ops.adam import fused_adam\n"
            "from deepspeed_tpu_torch.runtime import config, engine, lr_schedules\n"
            "from deepspeed_tpu_torch.runtime.zero import config as zero_config\n"
            "from deepspeed_tpu_torch.runtime.fp16 import loss_scaler\n"
            "from deepspeed_tpu_torch.utils import timer\n"
            "from deepspeed_tpu_torch import comm\n"
            "from deepspeed_tpu_torch.comm import comms_logging\n"
            "from deepspeed_tpu_torch.utils import groups\n"
            "from deepspeed_tpu_torch.runtime.zero import sharding, tiling, partitioned\n"
            "from deepspeed_tpu_torch.parallel import partition, tensor_parallel\n"
            "from deepspeed_tpu_torch import checkpoint\n"
            "from deepspeed_tpu_torch.checkpoint import ds_to_universal_cli\n"
            "from deepspeed_tpu_torch.runtime import state_dict_factory\n"
            "from deepspeed_tpu_torch.utils import tensor_fragment, zero_to_fp32\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'deepspeed_tpu'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_module_of_the_package_names_jax_or_the_reference():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    assert len(files) >= 25
    for path in files:
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "deepspeed_tpu"), (path, mod)
    for mod in _imported_modules(os.path.join(ROOT, "chip_smoke.py")):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "deepspeed_tpu"), mod


def test_entry_point_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deepspeed_tpu_torch.init_inference(ttf.TransformerModel(TINY))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deepspeed_tpu_torch.init_inference(ttf.TransformerModel(TINY), device="cuda")
    eng = deepspeed_tpu_torch.init_inference(ttf.TransformerModel(TINY), device="cpu")
    assert eng.device.type == "cpu"
    train = {"train_micro_batch_size_per_gpu": 2, "optimizer": {"type": "AdamW"}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deepspeed_tpu_torch.initialize(model=ttf.TransformerModel(TINY), config=train)
    engine = deepspeed_tpu_torch.initialize(model=ttf.TransformerModel(TINY), config=train,
                                            device="cpu")[0]
    assert engine.device.type == "cpu" and engine.params["embed"]["tok"].device.type == "cpu"


def test_accelerator_resolves_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert get_accelerator().resolve_device() == torch.device("cuda", 0)
    assert get_accelerator().resolve_device("cpu") == torch.device("cpu")
