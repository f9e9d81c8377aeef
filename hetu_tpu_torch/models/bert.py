"""BERT family: the configuration, the encoder and the pre-training heads.

Counterpart of ``hetu_tpu/models/bert.py`` (reference parity:
examples/nlp/bert/hetu_bert.py, bert_config.py), built from the same op
vocabulary with the same parameter names letter for letter, so the
name-seeded initializers give both packages the same weights and a
``hetu_tpu`` checkpoint loads unchanged. The GPT graph model builds on
the layer utilities here (``Embedding``, ``BertLayerNorm``,
``Dropout``, ``Linear``).

The attention core runs as composed ops (``batch_matmul_op`` +
``softmax_op`` + probs-dropout) or, with ``use_flash_attention``, as
``flash_attention_op`` under the ``[B, 1, 1, S]`` padding mask: kernel
K1 forward and the composed backward below ``FUSED_BWD_MIN_SEQ``, K2
forward and K3 + K4 backward from it on (``ops/attention.py``). The
flash path skips probs-dropout, as the reference's does. Sequence
parallelism (ring attention) waits for the parallel modes.
"""
from __future__ import annotations

import numpy as np

from .. import initializers as init
from ..ops import (array_reshape_op, batch_matmul_op, broadcastto_op,
                   dropout_op, embedding_lookup_op, flash_attention_op,
                   gelu_op, layer_normalization_op, matmul_op, relu_op,
                   slice_op, softmax_op, softmaxcrossentropy_sparse_op,
                   tanh_op, transpose_op)
from ..ops.variable import Variable

__all__ = ["BertConfig", "BertModel", "BertForPreTraining",
           "BertForMaskedLM", "BertForNextSentencePrediction",
           "BertForSequenceClassification", "Embedding", "BertLayerNorm",
           "Dropout", "Linear"]


class BertConfig:
    """Configuration (reference bert_config.py:4-50)."""

    def __init__(self, vocab_size, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 hidden_act="gelu", hidden_dropout_prob=0.1,
                 attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, output_hidden_states=False,
                 batch_size=None, use_flash_attention=False,
                 sequence_parallel=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.output_hidden_states = output_hidden_states
        self.batch_size = batch_size        # unused; kept for parity
        self.use_flash_attention = use_flash_attention
        # sequence/context parallelism (ring attention over the mesh's
        # "sp" axis): not ported yet, BertSelfAttention refuses it
        self.sequence_parallel = sequence_parallel


def _act(name):
    return {"relu": relu_op, "gelu": gelu_op, "tanh": tanh_op}[name]


# ---------------------------------------------------------------------------
# layer utilities (reference hetu_bert.py:700-745)
# ---------------------------------------------------------------------------

class Embedding:
    def __init__(self, num_embeddings, embedding_dim, name=None,
                 initializer=init.xavier_normal):
        self.weight = initializer(name=name,
                                  shape=(num_embeddings, embedding_dim))

    def __call__(self, input_tensor):
        return embedding_lookup_op(self.weight, input_tensor)


class BertLayerNorm:
    def __init__(self, hidden_size, eps=1e-12, name="layer_norm"):
        self.eps = eps
        self.scale = init.ones(name=name + "_scale", shape=(hidden_size,))
        self.bias = init.zeros(name=name + "_bias", shape=(hidden_size,))

    def __call__(self, x):
        return layer_normalization_op(x, self.scale, self.bias, eps=self.eps)


class Dropout:
    def __init__(self, dropout_prob=None):
        self.dropout_prob = dropout_prob

    def __call__(self, x):
        if not self.dropout_prob:
            return x
        return dropout_op(x, 1.0 - self.dropout_prob)


class Linear:
    """Dense layer over the trailing dim; >2D inputs collapse to 2D for
    the matmul and are restored afterwards (reference
    hetu_bert.py:719-745)."""

    def __init__(self, in_features, out_features, bias=True, activation=None,
                 kernel_initializer=init.xavier_normal,
                 bias_initializer=init.zeros, name="dense"):
        self.activation = activation
        self.in_features = in_features
        self.out_features = out_features
        self.weights = kernel_initializer(name=name + "_weights",
                                          shape=(in_features, out_features))
        self.bias = (bias_initializer(name=name + "_bias",
                                      shape=(out_features,))
                     if bias else None)

    def __call__(self, x, restore_shape=None):
        if restore_shape is not None:
            x = array_reshape_op(x, [-1, self.in_features])
        out = matmul_op(x, self.weights)
        if self.bias is not None:
            out = out + broadcastto_op(self.bias, out)
        if self.activation is not None:
            out = self.activation(out)
        if restore_shape is not None:
            out = array_reshape_op(
                out, list(restore_shape[:-1]) + [self.out_features])
        return out


# ---------------------------------------------------------------------------
# BERT modules
# ---------------------------------------------------------------------------

class BertEmbeddings:
    """Word + position + token-type embeddings (hetu_bert.py:57-99)."""

    def __init__(self, config):
        self.seq_len = config.max_position_embeddings
        self.word_embeddings = Embedding(config.vocab_size,
                                         config.hidden_size,
                                         "word_embeddings")
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             config.hidden_size,
                                             "position_embeddings")
        self.token_type_embeddings = Embedding(config.type_vocab_size,
                                               config.hidden_size,
                                               "token_type_embeddings")
        self.LayerNorm = BertLayerNorm(config.hidden_size,
                                       name="embeddings_layer_norm")
        self.dropout = Dropout(config.hidden_dropout_prob)

    def __call__(self, input_ids, token_type_ids, seq_len=None):
        seq_len = seq_len or self.seq_len
        # int32 ids, as the reference's (a float feed would be cast to
        # the compute dtype)
        position_ids = Variable(
            "position_ids", value=np.arange(seq_len).reshape(1, -1),
            trainable=False, dtype=np.int32)
        words = self.word_embeddings(input_ids)
        positions = self.position_embeddings(position_ids)
        token_types = self.token_type_embeddings(token_type_ids)
        emb = words + token_types
        emb = emb + broadcastto_op(positions, emb)
        return self.dropout(self.LayerNorm(emb))


class BertSelfAttention:
    """Multi-head scaled-dot-product attention (hetu_bert.py:165-227)."""

    def __init__(self, config, name="attn"):
        if config.hidden_size % config.num_attention_heads != 0:
            raise ValueError(
                f"hidden size {config.hidden_size} not a multiple of "
                f"num heads {config.num_attention_heads}")
        self.num_heads = config.num_attention_heads
        self.head_size = config.hidden_size // config.num_attention_heads
        self.hidden_size = config.hidden_size
        self.seq_len = config.max_position_embeddings
        self.use_flash = config.use_flash_attention
        if getattr(config, "sequence_parallel", False):
            raise NotImplementedError(
                "sequence-parallel attention (ring, Ulysses) is not ported "
                "yet: see ROADMAP.md")
        self.query = Linear(config.hidden_size, config.hidden_size,
                            name=name + "_query")
        self.key = Linear(config.hidden_size, config.hidden_size,
                          name=name + "_key")
        self.value = Linear(config.hidden_size, config.hidden_size,
                            name=name + "_value")
        self.dropout = Dropout(config.attention_probs_dropout_prob)

    def _heads(self, x, seq_len):
        x = array_reshape_op(
            x, [-1, seq_len, self.num_heads, self.head_size])
        return transpose_op(x, [0, 2, 1, 3])

    def __call__(self, hidden_states, attention_mask, seq_len=None):
        seq_len = seq_len or self.seq_len
        shape3 = [-1, seq_len, self.hidden_size]
        q = self._heads(self.query(hidden_states, shape3), seq_len)
        k = self._heads(self.key(hidden_states, shape3), seq_len)
        v = self._heads(self.value(hidden_states, shape3), seq_len)

        if self.use_flash:
            # the kernels never hold the probabilities in device memory
            # and apply no probs-dropout (dropout on the output
            # projection still applies), as the reference's flash path
            context = flash_attention_op(q, k, v, attention_mask,
                                         sm_scale=1.0 / float(
                                             np.sqrt(self.head_size)))
        else:
            k = k * (1.0 / float(np.sqrt(self.head_size)))
            scores = batch_matmul_op(q, k, trans_B=True)
            if attention_mask is not None:
                scores = scores + broadcastto_op(attention_mask, scores)
            probs = self.dropout(softmax_op(scores))
            context = batch_matmul_op(probs, v)
        context = transpose_op(context, [0, 2, 1, 3])
        return array_reshape_op(context, [-1, seq_len, self.hidden_size])


class BertSelfOutput:
    def __init__(self, config, name="attn_output"):
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            name=name)
        self.LayerNorm = BertLayerNorm(config.hidden_size,
                                       name=name + "_layer_norm")
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.hidden_size = config.hidden_size
        self.seq_len = config.max_position_embeddings

    def __call__(self, hidden_states, input_tensor, seq_len=None):
        seq_len = seq_len or self.seq_len
        shape3 = [-1, seq_len, self.hidden_size]
        hidden_states = self.dense(hidden_states, shape3)
        hidden_states = self.dropout(hidden_states)
        return self.LayerNorm(hidden_states + input_tensor)


class BertAttention:
    def __init__(self, config, name="attn"):
        self.self = BertSelfAttention(config, name=name)
        self.output = BertSelfOutput(config, name=name + "_output")

    def __call__(self, input_tensor, attention_mask, seq_len=None):
        self_output = self.self(input_tensor, attention_mask, seq_len)
        return self.output(self_output, input_tensor, seq_len)


class BertIntermediate:
    def __init__(self, config, name="intermediate"):
        self.dense = Linear(config.hidden_size, config.intermediate_size,
                            activation=_act(config.hidden_act),
                            name=name)
        self.hidden_size = config.hidden_size
        self.seq_len = config.max_position_embeddings

    def __call__(self, hidden_states, seq_len=None):
        seq_len = seq_len or self.seq_len
        return self.dense(hidden_states, [-1, seq_len, self.hidden_size])


class BertOutput:
    def __init__(self, config, name="ffn_output"):
        self.dense = Linear(config.intermediate_size, config.hidden_size,
                            name=name)
        self.LayerNorm = BertLayerNorm(config.hidden_size,
                                       name=name + "_layer_norm")
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.intermediate_size = config.intermediate_size
        self.seq_len = config.max_position_embeddings

    def __call__(self, hidden_states, input_tensor, seq_len=None):
        seq_len = seq_len or self.seq_len
        shape3 = [-1, seq_len, self.intermediate_size]
        hidden_states = self.dropout(self.dense(hidden_states, shape3))
        return self.LayerNorm(hidden_states + input_tensor)


class BertLayer:
    def __init__(self, config, name="layer"):
        self.attention = BertAttention(config, name=name + "_attn")
        self.intermediate = BertIntermediate(config,
                                             name=name + "_intermediate")
        self.output = BertOutput(config, name=name + "_ffn_output")

    def __call__(self, hidden_states, attention_mask, seq_len=None):
        attention_output = self.attention(hidden_states, attention_mask,
                                          seq_len)
        intermediate_output = self.intermediate(attention_output, seq_len)
        return self.output(intermediate_output, attention_output, seq_len)


class BertEncoder:
    def __init__(self, config):
        self.output_hidden_states = config.output_hidden_states
        self.layer = [BertLayer(config, name=f"layer{i}")
                      for i in range(config.num_hidden_layers)]

    def __call__(self, hidden_states, attention_mask=None, seq_len=None):
        all_hidden = []
        for layer_module in self.layer:
            if self.output_hidden_states:
                all_hidden.append(hidden_states)
            hidden_states = layer_module(hidden_states, attention_mask,
                                         seq_len)
        if self.output_hidden_states:
            all_hidden.append(hidden_states)
            return hidden_states, all_hidden
        return hidden_states


class BertPooler:
    def __init__(self, config):
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            activation=tanh_op, name="pooler")
        self.hidden_size = config.hidden_size

    def __call__(self, hidden_states):
        first = slice_op(hidden_states, (0, 0, 0), (-1, 1, self.hidden_size))
        first = array_reshape_op(first, [-1, self.hidden_size])
        return self.dense(first)


class BertModel:
    """Reference hetu_bert.py:420-484."""

    def __init__(self, config):
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.encoder = BertEncoder(config)
        self.pooler = BertPooler(config)
        self.seq_len = config.max_position_embeddings

    def __call__(self, input_ids, token_type_ids, attention_mask,
                 seq_len=None):
        seq_len = seq_len or self.seq_len
        extended_mask = array_reshape_op(attention_mask, [-1, 1, 1, seq_len])
        extended_mask = (extended_mask + (-1.0)) * 10000.0
        embedding_output = self.embeddings(input_ids, token_type_ids,
                                           seq_len)
        sequence_output = self.encoder(embedding_output, extended_mask,
                                       seq_len)
        pooled_output = self.pooler(sequence_output)
        return sequence_output, pooled_output


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

class BertPredictionHeadTransform:
    def __init__(self, config):
        self.dense_act = Linear(config.hidden_size, config.hidden_size,
                                activation=_act(config.hidden_act),
                                name="mlm_transform")
        self.LayerNorm = BertLayerNorm(config.hidden_size,
                                       name="mlm_transform_layer_norm")
        self.hidden_size = config.hidden_size
        self.seq_len = config.max_position_embeddings

    def __call__(self, hidden_states, seq_len=None):
        seq_len = seq_len or self.seq_len
        shape3 = [-1, seq_len, self.hidden_size]
        return self.LayerNorm(self.dense_act(hidden_states, shape3))


class BertLMPredictionHead:
    """MLM decoder with weights tied to the word-embedding table
    (hetu_bert.py:343-364)."""

    def __init__(self, config, bert_model_embedding_weights):
        self.transform = BertPredictionHeadTransform(config)
        self.decoder_weight = transpose_op(bert_model_embedding_weights)
        self.decoder_bias = init.zeros(name="mlm_decoder_bias",
                                       shape=(config.vocab_size,))
        self.hidden_size = config.hidden_size
        self.vocab_size = config.vocab_size
        self.seq_len = config.max_position_embeddings

    def __call__(self, hidden_states, seq_len=None):
        seq_len = seq_len or self.seq_len
        hidden_states = self.transform(hidden_states, seq_len)
        flat = array_reshape_op(hidden_states, [-1, self.hidden_size])
        logits = matmul_op(flat, self.decoder_weight)
        logits = logits + broadcastto_op(self.decoder_bias, logits)
        return array_reshape_op(logits, [-1, seq_len, self.vocab_size])


class BertPreTrainingHeads:
    def __init__(self, config, bert_model_embedding_weights):
        self.predictions = BertLMPredictionHead(config,
                                                bert_model_embedding_weights)
        self.seq_relationship = Linear(config.hidden_size, 2, name="nsp")

    def __call__(self, sequence_output, pooled_output, seq_len=None):
        return (self.predictions(sequence_output, seq_len),
                self.seq_relationship(pooled_output))


class BertForPreTraining:
    """MLM + NSP pre-training (hetu_bert.py:486-563). Returns
    [prediction_scores, seq_relationship_score, masked_lm_loss,
    next_sentence_loss] when labels are given."""

    def __init__(self, config):
        self.config = config
        self.bert = BertModel(config)
        self.cls = BertPreTrainingHeads(
            config, self.bert.embeddings.word_embeddings.weight)
        self.vocab_size = config.vocab_size

    def __call__(self, input_ids, token_type_ids, attention_mask,
                 masked_lm_labels=None, next_sentence_label=None,
                 seq_len=None):
        sequence_output, pooled_output = self.bert(
            input_ids, token_type_ids, attention_mask, seq_len)
        prediction_scores, seq_relationship_score = self.cls(
            sequence_output, pooled_output, seq_len)
        result = [prediction_scores, seq_relationship_score]
        if masked_lm_labels is not None and next_sentence_label is not None:
            masked_lm_loss = softmaxcrossentropy_sparse_op(
                prediction_scores, masked_lm_labels, ignored_index=-1)
            next_sentence_loss = softmaxcrossentropy_sparse_op(
                seq_relationship_score, next_sentence_label,
                ignored_index=-1)
            result += [masked_lm_loss, next_sentence_loss]
        return result


class BertForMaskedLM:
    def __init__(self, config):
        self.bert = BertModel(config)
        self.cls = BertLMPredictionHead(
            config, self.bert.embeddings.word_embeddings.weight)

    def __call__(self, input_ids, token_type_ids, attention_mask,
                 masked_lm_labels=None, seq_len=None):
        sequence_output, _ = self.bert(input_ids, token_type_ids,
                                       attention_mask, seq_len)
        prediction_scores = self.cls(sequence_output, seq_len)
        if masked_lm_labels is not None:
            loss = softmaxcrossentropy_sparse_op(
                prediction_scores, masked_lm_labels, ignored_index=-1)
            return [prediction_scores, loss]
        return [prediction_scores]


class BertForNextSentencePrediction:
    def __init__(self, config):
        self.bert = BertModel(config)
        self.cls = Linear(config.hidden_size, 2, name="nsp")

    def __call__(self, input_ids, token_type_ids, attention_mask,
                 next_sentence_label=None, seq_len=None):
        _, pooled_output = self.bert(input_ids, token_type_ids,
                                     attention_mask, seq_len)
        score = self.cls(pooled_output)
        if next_sentence_label is not None:
            loss = softmaxcrossentropy_sparse_op(score, next_sentence_label,
                                                 ignored_index=-1)
            return [score, loss]
        return [score]


class BertForSequenceClassification:
    def __init__(self, config, num_labels):
        self.bert = BertModel(config)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_labels,
                                 name="classifier")

    def __call__(self, input_ids, token_type_ids, attention_mask,
                 labels=None, seq_len=None):
        _, pooled_output = self.bert(input_ids, token_type_ids,
                                     attention_mask, seq_len)
        logits = self.classifier(self.dropout(pooled_output))
        if labels is not None:
            loss = softmaxcrossentropy_sparse_op(logits, labels,
                                                 ignored_index=-1)
            return [logits, loss]
        return [logits]
