"""Model zoo of the port: the BERT family, the GPT graph model and its
serving forward."""
from .bert import (BertConfig, BertForMaskedLM, BertForNextSentencePrediction,
                   BertForPreTraining, BertForSequenceClassification,
                   BertLayerNorm, BertModel, Dropout, Embedding, Linear)
from .gpt import (GPTConfig, GPTLMHeadModel, GPTModel, gpt_param_names,
                  gpt_paged_prefill, gpt_paged_step, gpt_paged_suffix_prefill,
                  gpt_serving_params, random_gpt_checkpoint,
                  serving_params_from_numpy)

__all__ = ["BertConfig", "BertModel", "BertForPreTraining",
           "BertForMaskedLM", "BertForNextSentencePrediction",
           "BertForSequenceClassification", "GPTConfig", "GPTModel",
           "GPTLMHeadModel", "gpt_param_names", "gpt_serving_params",
           "serving_params_from_numpy", "random_gpt_checkpoint",
           "gpt_paged_prefill", "gpt_paged_step", "gpt_paged_suffix_prefill",
           "Embedding", "BertLayerNorm", "Dropout", "Linear"]
