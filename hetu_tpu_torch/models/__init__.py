"""Model zoo of the port: the BERT family, the GPT graph model and its
serving forward, the CNN/RNN zoo (``models/cnn.py``: logreg, mlp,
cnn_3_layers, digits_cnn, lenet, alexnet, vgg16/19, resnet18/34, rnn,
lstm), the CTR models (``models/ctr.py``: WDL, DeepFM, DCN, DC), NCF
(``models/ncf.py``), the seq2seq Transformer
(``models/transformer.py``) and the GNNs (``models/gnn.py``: GCN,
GraphSAGE)."""
from .bert import (BertConfig, BertForMaskedLM, BertForNextSentencePrediction,
                   BertForPreTraining, BertForSequenceClassification,
                   BertLayerNorm, BertModel, Dropout, Embedding, Linear)
from .cnn import (alexnet, cnn_3_layers, digits_cnn, lenet, logreg, lstm, mlp,
                  resnet18, resnet34, rnn, vgg16, vgg19)
from .ctr import dc_criteo, dcn_criteo, deepfm_criteo, wdl_adult, wdl_criteo
from .gnn import GCN, SageConv, gcn, gcn_layer, graphsage
from .gpt import (GPTConfig, GPTLMHeadModel, GPTModel, gpt_cached_step,
                  gpt_paged_prefill, gpt_paged_step, gpt_paged_suffix_prefill,
                  gpt_param_names, gpt_prefill, gpt_serving_params,
                  init_kv_cache, random_gpt_checkpoint,
                  serving_params_from_numpy, staged_gpt)
from .ncf import neural_mf
from .transformer import Transformer, TransformerConfig

__all__ = ["BertConfig", "BertModel", "BertForPreTraining",
           "BertForMaskedLM", "BertForNextSentencePrediction",
           "BertForSequenceClassification", "GPTConfig", "GPTModel",
           "GPTLMHeadModel", "gpt_param_names", "gpt_serving_params",
           "serving_params_from_numpy", "random_gpt_checkpoint",
           "init_kv_cache", "gpt_prefill", "gpt_cached_step",
           "gpt_paged_prefill", "gpt_paged_step", "gpt_paged_suffix_prefill",
           "staged_gpt", "Embedding", "BertLayerNorm", "Dropout", "Linear",
           "logreg", "mlp", "cnn_3_layers", "digits_cnn", "lenet", "alexnet",
           "vgg16", "vgg19", "resnet18", "resnet34", "rnn", "lstm",
           "wdl_criteo", "wdl_adult", "deepfm_criteo", "dcn_criteo",
           "dc_criteo", "neural_mf", "Transformer", "TransformerConfig",
           "GCN", "SageConv", "gcn_layer", "gcn", "graphsage"]
