"""Encoder-decoder Transformer for sequence-to-sequence tasks (counterpart
of ``hetu_tpu/models/transformer.py``; reference parity:
examples/nlp/hetu_transformer.py — the "attention is all you need" MT
model: shared zero-padded token embeddings, sinusoidal positions,
post-norm blocks, causal decoder self-attention, encoder-decoder cross
attention, weight-tied output projection, label-smoothed softmax CE).

The graph is the reference's op for op, with its parameter names, so both
packages draw the same initial values. Attention is composed from
``batch_matmul_op``, ``softmax_op`` and dropout on the probabilities, as
in the reference, which does not route this model through the flash
kernels. Dropout draws other masks than ``jax.random``'s (the per-op
``torch.Generator``), so the two packages agree step for step only at
dropout 0.

The token table is ``concat_op(pad_row, body)``: a non-trainable zero
row for the pad id 0 above the trained rows. The lookup's sparse adjoint
and the tied projection's dense one are summed into one dense adjoint of
the table before ``concat_gradient_op`` hands the body its rows, so the
pad row never moves.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import initializers as init
from ..ops import (array_reshape_op, batch_matmul_op, broadcast_shape_op,
                   broadcastto_op, clip_op, concat_op, div_op, dropout_op,
                   embedding_lookup_op, layer_normalization_op, matmul_op,
                   mul_op, one_hot_op, reduce_sum_op, relu_op, softmax_op,
                   softmaxcrossentropy_op, transpose_op, where_op)
from ..ops.variable import Variable

__all__ = ["TransformerConfig", "Transformer"]

_NEG = -1e9      # additive mask value


@dataclass
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    d_ff: int = 2048
    num_blocks: int = 6
    num_heads: int = 8
    maxlen1: int = 100          # source length
    maxlen2: int = 100          # target length (decoder sees maxlen2-1)
    batch_size: int = 32
    dropout_rate: float = 0.3
    label_smoothing: float = 0.1


def _sinusoid_table(maxlen, width):
    pos = np.arange(maxlen)[:, None]
    dim = np.arange(width)[None, :]
    angle = pos / np.power(10000.0, (dim & ~1) / width)
    table = np.where(dim % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


class Transformer:
    """Builds the training graph: ``loss = model(src, dec_in, target)``
    with [B, T1] / [B, T2-1] / [B, T2-1] int feeds (target is dec_in
    shifted left)."""

    def __init__(self, config: TransformerConfig):
        self.hp = config
        # every parameter and constant node is memoized by name: the
        # builders can be called again (train and validate subgraphs) and
        # share one weight set
        self._nodes = {}
        body = init.xavier_normal(
            (config.vocab_size - 1, config.d_model), name="tok_embed")
        pad_row = init.zeros((1, config.d_model), name="tok_embed_pad",
                             trainable=False)
        self.embeddings = concat_op(pad_row, body, axis=0)

    # -- parameter store ------------------------------------------------
    def _node(self, name, build):
        if name not in self._nodes:
            self._nodes[name] = build()
        return self._nodes[name]

    def _const(self, name, value):
        return self._node(name, lambda: Variable(
            name, value=np.asarray(value, np.float32), trainable=False))

    def _dense(self, x, fan_in, fan_out, name, activation=None):
        w = self._node(name + "_w", lambda: init.xavier_normal(
            (fan_in, fan_out), name=name + "_w"))
        b = self._node(name + "_b", lambda: init.zeros(
            (fan_out,), name=name + "_b"))
        out = matmul_op(x, w)
        out = out + broadcastto_op(b, out)
        return activation(out) if activation else out

    def _layer_norm(self, x, width, name):
        scale = self._node(name + "_scale", lambda: init.ones(
            (width,), name=name + "_scale"))
        bias = self._node(name + "_bias", lambda: init.zeros(
            (width,), name=name + "_bias"))
        return layer_normalization_op(x, scale, bias, eps=1e-8)

    # -- helpers --------------------------------------------------------
    def _pad_bias(self, ids, name):
        """[B, T] ids -> [B, 1, 1, T] additive bias (0 real / -1e9 pad)."""
        hp = self.hp
        zeros = self._const(name + "_zero", np.zeros(1))
        neg = self._const(name + "_neg", np.full(1, _NEG))
        bias = where_op(ids, broadcastto_op(zeros, ids),
                        broadcastto_op(neg, ids))          # [B, T]
        return array_reshape_op(bias, (hp.batch_size, 1, 1, -1))

    def _positions(self, x, ids, seqlen, name):
        """Add the sinusoidal table, zeroed at pad positions."""
        hp = self.hp
        table = self._const(name, _sinusoid_table(seqlen, hp.d_model))
        pos = broadcast_shape_op(
            table, (hp.batch_size, seqlen, hp.d_model), add_axes=(0,))
        ones = self._const(name + "_one", np.ones(1))
        zero = self._const(name + "_zero", np.zeros(1))
        keep = where_op(ids, broadcastto_op(ones, ids),
                        broadcastto_op(zero, ids))          # [B, T]
        keep = array_reshape_op(keep, (hp.batch_size, seqlen, 1))
        return x + mul_op(pos, broadcastto_op(keep, pos))

    def _attention(self, queries, keys, values, key_bias, name,
                   causal=False, q_len=None, kv_len=None):
        """Post-norm residual multi-head attention block."""
        hp = self.hp
        d, h = hp.d_model, hp.num_heads
        dh = d // h

        def split_heads(x2d, seqlen):
            x = array_reshape_op(x2d, (hp.batch_size, seqlen, h, dh))
            return transpose_op(x, (0, 2, 1, 3))        # [B, h, T, dh]

        q2d = array_reshape_op(queries, (-1, d))
        k2d = array_reshape_op(keys, (-1, d))
        v2d = array_reshape_op(values, (-1, d))
        q = split_heads(self._dense(q2d, d, d, name + "_q"), q_len)
        k = split_heads(self._dense(k2d, d, d, name + "_k"), kv_len)
        v = split_heads(self._dense(v2d, d, d, name + "_v"), kv_len)

        scores = batch_matmul_op(q, k, trans_B=True)    # [B, h, Tq, Tk]
        scores = scores * (1.0 / np.sqrt(dh))
        if key_bias is not None:
            scores = scores + broadcastto_op(key_bias, scores)
        if causal:
            tril = self._const(
                name + "_tril", np.tril(np.ones((q_len, q_len))))
            keep = broadcast_shape_op(
                tril, (hp.batch_size, h, q_len, q_len), add_axes=(0, 1))
            neg = self._const(name + "_neg", np.full(1, _NEG))
            scores = where_op(keep, scores, broadcastto_op(neg, scores))

        probs = softmax_op(scores)
        if hp.dropout_rate:
            probs = dropout_op(probs, 1.0 - hp.dropout_rate)
        ctx = batch_matmul_op(probs, v)                 # [B, h, Tq, dh]
        ctx = transpose_op(ctx, (0, 2, 1, 3))
        ctx = array_reshape_op(ctx, (hp.batch_size, q_len, d))
        out = ctx + queries                             # residual
        return self._layer_norm(out, d, name + "_ln")

    def _ffn(self, x, seqlen, name):
        hp = self.hp
        h2d = array_reshape_op(x, (-1, hp.d_model))
        h2d = self._dense(h2d, hp.d_model, hp.d_ff, name + "_in",
                          activation=relu_op)
        h2d = self._dense(h2d, hp.d_ff, hp.d_model, name + "_out")
        out = array_reshape_op(
            h2d, (hp.batch_size, seqlen, hp.d_model)) + x
        return self._layer_norm(out, hp.d_model, name + "_ln")

    def _embed(self, ids):
        hp = self.hp
        x = embedding_lookup_op(self.embeddings, ids)
        return x * (hp.d_model ** 0.5)

    # -- graph builders -------------------------------------------------
    def encode(self, src_ids):
        hp = self.hp
        t1 = hp.maxlen1
        enc = self._embed(src_ids)
        enc = self._positions(enc, src_ids, t1, "enc_pos")
        if hp.dropout_rate:
            enc = dropout_op(enc, 1.0 - hp.dropout_rate)
        src_bias = self._pad_bias(src_ids, "src_mask")
        for i in range(hp.num_blocks):
            enc = self._attention(enc, enc, enc, src_bias,
                                  f"enc{i}_self", q_len=t1, kv_len=t1)
            enc = self._ffn(enc, t1, f"enc{i}_ffn")
        return enc, src_bias

    def decode(self, dec_ids, memory, src_bias):
        hp = self.hp
        t2 = hp.maxlen2 - 1
        dec = self._embed(dec_ids)
        dec = self._positions(dec, dec_ids, t2, "dec_pos")
        if hp.dropout_rate:
            dec = dropout_op(dec, 1.0 - hp.dropout_rate)
        tgt_bias = self._pad_bias(dec_ids, "tgt_mask")
        for i in range(hp.num_blocks):
            dec = self._attention(dec, dec, dec, tgt_bias,
                                  f"dec{i}_self", causal=True,
                                  q_len=t2, kv_len=t2)
            dec = self._attention(dec, memory, memory, src_bias,
                                  f"dec{i}_cross", q_len=t2,
                                  kv_len=hp.maxlen1)
            dec = self._ffn(dec, t2, f"dec{i}_ffn")
        # weight-tied projection onto the embedding table
        dec2d = array_reshape_op(dec, (-1, hp.d_model))
        logits = matmul_op(dec2d, self.embeddings, trans_B=True)
        return array_reshape_op(
            logits, (hp.batch_size, t2, hp.vocab_size))

    def train(self, src_ids, dec_ids, target_ids):
        """Label-smoothed token-level CE loss node ([B, T2-1])."""
        hp = self.hp
        memory, src_bias = self.encode(src_ids)
        logits = self.decode(dec_ids, memory, src_bias)
        onehot = one_hot_op(target_ids, hp.vocab_size)
        eps = hp.label_smoothing
        smoothed = onehot * (1.0 - eps) + eps / hp.vocab_size
        return softmaxcrossentropy_op(logits, smoothed)

    def __call__(self, src_ids, dec_ids, target_ids):
        """Pad-masked mean loss: sum(ce * nonpad) / max(count(nonpad), 1)
        — pad targets (id 0) contribute nothing, and an all-pad batch
        gives loss 0."""
        per_tok = self.train(src_ids, dec_ids, target_ids)    # [B, T2-1]
        one = self._const("loss_one", np.ones(1))
        zero = self._const("loss_zero", np.zeros(1))
        mask = where_op(target_ids, broadcastto_op(one, target_ids),
                        broadcastto_op(zero, target_ids))
        num = reduce_sum_op(mul_op(per_tok, mask), [0, 1])
        count = clip_op(reduce_sum_op(mask, [0, 1]), 1.0, None)
        return div_op(num, count)
