"""Model definitions of the port (counterpart of
:mod:`apex_tpu.transformer.testing`), re-exporting the reference's
names: the transformer LM and its parts, the pooler, GPT and BERT."""

from apex_tpu_torch.transformer.testing.standalone_transformer_lm import (
    CoreAttention,
    Embedding,
    ParallelAttention,
    ParallelMLP,
    ParallelTransformer,
    ParallelTransformerLayer,
    Pooler,
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
from apex_tpu_torch.transformer.testing.standalone_bert import (
    BertModel,
    bert_extended_attention_mask,
)

__all__ = [
    "TransformerConfig",
    "ParallelMLP",
    "CoreAttention",
    "ParallelAttention",
    "ParallelTransformerLayer",
    "ParallelTransformer",
    "Embedding",
    "Pooler",
    "TransformerLanguageModel",
    "parallel_lm_logits",
    "GPTModel",
    "gpt_loss",
    "gpt_next_token_loss",
    "init_gpt_layer_stack",
    "BertModel",
    "bert_extended_attention_mask",
]
