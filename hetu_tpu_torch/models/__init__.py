"""Model zoo of the port: the GPT graph model and serving forward, and
the BERT layer utilities it builds on."""
from .bert import BertLayerNorm, Dropout, Embedding, Linear
from .gpt import (GPTConfig, GPTLMHeadModel, GPTModel, gpt_param_names,
                  gpt_paged_prefill, gpt_paged_step, gpt_paged_suffix_prefill,
                  gpt_serving_params, random_gpt_checkpoint,
                  serving_params_from_numpy)

__all__ = ["GPTConfig", "GPTModel", "GPTLMHeadModel", "gpt_param_names",
           "gpt_serving_params", "serving_params_from_numpy",
           "random_gpt_checkpoint", "gpt_paged_prefill", "gpt_paged_step",
           "gpt_paged_suffix_prefill", "Embedding", "BertLayerNorm",
           "Dropout", "Linear"]
