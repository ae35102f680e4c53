"""Model definitions of the port (counterpart of
:mod:`apex_tpu.transformer.testing`), re-exporting the reference's names;
the pooler and the BERT model are not ported yet (ROADMAP.md, section
A.4)."""

from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    CoreAttention,
    Embedding,
    ParallelAttention,
    ParallelMLP,
    ParallelTransformer,
    ParallelTransformerLayer,
    TransformerConfig,
    TransformerLanguageModel,
    parallel_lm_logits,
)
from apex_tpu_torch.transformer.testing.standalone_gpt import (
    GPTModel,
    gpt_loss,
    gpt_next_token_loss,
    init_gpt_layer_stack,
)

__all__ = [
    "TransformerConfig",
    "ParallelMLP",
    "CoreAttention",
    "ParallelAttention",
    "ParallelTransformerLayer",
    "ParallelTransformer",
    "Embedding",
    "TransformerLanguageModel",
    "parallel_lm_logits",
    "GPTModel",
    "gpt_loss",
    "gpt_next_token_loss",
    "init_gpt_layer_stack",
]
