"""L1-style training traces (port of the GPT half of
:mod:`apex_tpu.testing.l1`).

:func:`trace_gpt` runs the JAX ``_trace_gpt`` loop: a tiny GPT (hidden 64,
2 layers, 4 heads, vocabulary 128, 32 positions, no dropout) trained for
``ITERS`` steps of FusedAdam (lr 1e-3) on one fixed ``[4, 32]`` batch,
recording the mean next-token loss and the global gradient norm of every
step.  With the JAX run's initial parameters (carried over by
:func:`apex_tpu_torch.serving.bridge.from_flax_gpt`) and tokens, the two
traces agree to :func:`compare_traces`' tolerances.

Every config runs the flash attention core: it is the only one ported (the
JAX ``gpt_smoke``, ``gpt_bf16`` and ``gpt_modern`` traces run the
fused-softmax core, which computes the same function; in fp32 the two
differ by rounding only).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.testing.gpt_parallel_train import (
    GPT3DParams,
    init_gpt_params,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import GPTModel
from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    TransformerConfig,
)

__all__ = ["ITERS", "CONFIGS", "trace_config", "trace_gpt", "train_step",
           "global_grad_norm", "compare_traces"]

ITERS = 10
# the JAX package's GPT trace configs (testing/l1.py CONFIGS), by name
CONFIGS = {
    "gpt_smoke": {},
    "gpt_bf16": {"dtype": torch.bfloat16},
    "gpt_flash": {"dtype": torch.bfloat16},
    "gpt_modern": {"position_embedding_type": "rope", "num_query_groups": 2,
                   "swiglu": True},
}


def trace_config(name: str) -> TransformerConfig:
    """The model of trace ``name`` (the JAX ``_trace_gpt`` shape)."""
    return TransformerConfig(
        hidden_size=64, num_layers=2, num_attention_heads=4,
        padded_vocab_size=128, max_position_embeddings=32,
        hidden_dropout=0.0, attention_dropout=0.0, use_flash_attention=True,
        **CONFIGS[name])


def global_grad_norm(params) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32."""
    grads = [p.grad.float() for p in params if p.grad is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def train_step(model: GPTModel, opt: torch.optim.Optimizer, tokens,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One step of the JAX bench/trace step: forward, mean next-token
    loss, backward, optimizer step.  Returns the loss (on the device); the
    gradients stay in ``.grad`` until the next step clears them."""
    opt.zero_grad(set_to_none=True)
    loss = model(tokens, labels=tokens, generator=generator).mean()
    loss.backward()
    opt.step()
    return loss.detach()


def trace_gpt(name: str, *, params: Optional[GPT3DParams] = None,
              tokens: Optional[torch.Tensor] = None, seed: int = 0,
              device=None) -> Dict[str, List[float]]:
    """``{"loss": [...], "grad_norm": [...]}`` over ``ITERS`` steps.

    ``params`` default to :func:`init_gpt_params` from ``seed``, ``tokens``
    to a ``[4, 32]`` batch drawn from ``seed + 1``; ``device`` defaults to
    the CUDA device."""
    device = resolve_device(device)
    cfg = trace_config(name)
    model = GPTModel(cfg, device=device)
    model.load_params(params if params is not None
                      else init_gpt_params(cfg, seed, device=device))
    if tokens is None:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        tokens = torch.randint(0, cfg.padded_vocab_size, (4, 32),
                               generator=gen, device=device)
    tokens = tokens.to(device)
    opt = FusedAdam(model.parameters(), lr=1e-3)
    out: Dict[str, List[float]] = {"loss": [], "grad_norm": []}
    for _ in range(ITERS):
        loss = train_step(model, opt, tokens)
        out["loss"].append(float(loss))
        out["grad_norm"].append(float(global_grad_norm(model.parameters())))
    return out


def compare_traces(got: Dict[str, List[float]],
                   baseline: Dict[str, List[float]],
                   loss_rtol: float = 1e-4,
                   grad_rtol: float = 1e-3) -> List[str]:
    """Per-iteration diff; a list of mismatch descriptions (empty =
    pass), as the JAX package's ``compare_traces``."""
    problems = []
    for key, rtol in (("loss", loss_rtol), ("grad_norm", grad_rtol)):
        a, b = got.get(key, []), baseline.get(key, [])
        if len(a) != len(b):
            problems.append(f"{key}: {len(a)} iters vs baseline {len(b)}")
            continue
        for i, (x, y) in enumerate(zip(a, b)):
            if not np.isclose(x, y, rtol=rtol, atol=1e-7):
                problems.append(
                    f"{key}[{i}]: {x!r} vs baseline {y!r} (rtol {rtol})")
    return problems
