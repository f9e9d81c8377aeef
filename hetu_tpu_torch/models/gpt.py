"""GPT family — the graph model and the serving forward functions.

Counterpart of ``hetu_tpu/models/gpt.py``: a GPT-2-shaped pre-LN
decoder — learned position embeddings, tanh-gelu MLP, LayerNorm before
each sublayer and at the output, untied LM head — as the graph model
:class:`GPTLMHeadModel` (training through ``Executor.run``; causal
flash attention, i.e. kernels K2–K4 at S >= 512) and as the pure
serving functions below. The graph model's parameter names are
:func:`gpt_param_names`, so a training checkpoint feeds the serving
path unchanged. ``use_flash_attention=False`` takes the composed
attention (``batch_matmul_op`` + ``softmax_op`` under a broadcast
causal-mask constant); the sequence-parallel paths wait for the
parallel modes.

Parameters are a plain dict built by :func:`gpt_serving_params` from
the reference's checkpoint names (:func:`gpt_param_names`), so a
``hetu_tpu`` checkpoint (one ``<name>.npy`` per parameter), a live
session's tensors or any ``name -> array`` lookup carries over
unchanged. Linear weights keep the reference's ``[in, out]`` layout.

Two cached decode paths share the layer math: the dense one
(:func:`init_kv_cache`, :func:`gpt_prefill`, :func:`gpt_cached_step`:
one ``[B, H, S_max, D]`` K/V pair per layer, for ``GPTDecoder``) and the
block-paged one (``gpt_paged_*``, for ``ContinuousBatchingEngine``).
Both update their K/V buffers IN PLACE (the reference donates them to
``jax.jit`` instead) and return ``(logits, buffers)`` with the same
buffer list, so call sites read the same in both packages; the
caller's buffers are consumed.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..context import context
from ..device import resolve_device
from ..ops import (array_reshape_op, batch_matmul_op, broadcastto_op,
                   flash_attention_op, reduce_mean_op, ring_attention_op,
                   slice_op, softmax_op, softmaxcrossentropy_sparse_op,
                   split_op, squeeze_op, transpose_op, ulysses_attention_op)
from ..ops.attention import (decode_attention, paged_decode_attention,
                             paged_prefill_attention, prefill_attention)
from ..ops.variable import Variable
from .bert import BertLayerNorm as LayerNorm
from .bert import Dropout, Embedding, Linear, _act

__all__ = ["GPTConfig", "GPTModel", "GPTLMHeadModel", "gpt_param_names",
           "gpt_serving_params", "serving_params_from_numpy",
           "random_gpt_checkpoint", "init_kv_cache", "gpt_prefill",
           "gpt_cached_step", "gpt_paged_prefill", "gpt_paged_step",
           "gpt_paged_suffix_prefill", "staged_gpt"]


class GPTConfig:
    def __init__(self, vocab_size, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=None,
                 hidden_act="gelu", hidden_dropout_prob=0.1,
                 max_position_embeddings=1024, initializer_range=0.02,
                 use_flash_attention=False, sequence_parallel=None):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.use_flash_attention = use_flash_attention
        if sequence_parallel is True:
            sequence_parallel = "ring"
        self.sequence_parallel = sequence_parallel or None


def gpt_param_names(config):
    """Checkpoint names of a ``GPTLMHeadModel``, structured the way the
    serving forward wants them (the reference's layout, name for
    name)."""
    blocks = []
    for i in range(config.num_hidden_layers):
        p = f"gpt_h{i}"
        blocks.append({
            "ln1": (f"{p}_ln1_scale", f"{p}_ln1_bias"),
            "qkv": (f"{p}_attn_qkv_weights", f"{p}_attn_qkv_bias"),
            "proj": (f"{p}_attn_proj_weights", f"{p}_attn_proj_bias"),
            "ln2": (f"{p}_ln2_scale", f"{p}_ln2_bias"),
            "fc": (f"{p}_mlp_fc_weights", f"{p}_mlp_fc_bias"),
            "mlp_proj": (f"{p}_mlp_proj_weights", f"{p}_mlp_proj_bias"),
        })
    return {"wte": "gpt_wte", "wpe": "gpt_wpe", "blocks": blocks,
            "ln_f": ("gpt_ln_f_scale", "gpt_ln_f_bias"),
            "lm_head": "gpt_lm_head_weights"}


def gpt_serving_params(config, lookup, device=None):
    """Serving parameter dict on ``device`` (``cuda`` by default), f32.
    ``lookup(name)`` returns one checkpoint array (a dict's
    ``__getitem__``, an ``np.load`` closure over a checkpoint dir,
    ...) or a tensor (``InferenceSession.params_by_name``): a tensor
    already f32 on ``device`` is used as it is, so the serving path
    shares its storage, and any other is cast or moved on the device
    side, never through the host."""
    dev = resolve_device(device)

    def get(name):
        value = lookup(name)
        if isinstance(value, torch.Tensor):
            return value.to(device=dev, dtype=torch.float32)
        return torch.as_tensor(np.asarray(value, np.float32), device=dev)

    names = gpt_param_names(config)
    out = {"wte": get(names["wte"]), "wpe": get(names["wpe"]),
           "ln_f": tuple(get(n) for n in names["ln_f"]),
           "lm_head": get(names["lm_head"]), "blocks": []}
    for blk in names["blocks"]:
        out["blocks"].append(
            {k: tuple(get(n) for n in v) for k, v in blk.items()})
    return out


def serving_params_from_numpy(tree, device=None):
    """A ``hetu_tpu`` serving pytree (``gpt_serving_params`` output with
    every leaf passed through ``np.asarray``) -> the same structure of
    f32 tensors on ``device``."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return conv(tree)


def random_gpt_checkpoint(config, seed=0):
    """A random ``{name: np.float32 array}`` checkpoint keyed by
    :func:`gpt_param_names`: weights and biases N(0,
    ``initializer_range``), LayerNorm scales 1 + N(0, same). Serves as
    ``lookup=ckpt.__getitem__`` for either package; nothing is
    downloaded."""
    rng = np.random.default_rng(seed)
    std = float(config.initializer_range)
    h, i = config.hidden_size, config.intermediate_size

    def normal(*shape, mean=0.0):
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= std
        x += mean
        return x

    names = gpt_param_names(config)
    ckpt = {names["wte"]: normal(config.vocab_size, h),
            names["wpe"]: normal(config.max_position_embeddings, h),
            names["lm_head"]: normal(h, config.vocab_size)}
    shapes = {"qkv": ((h, 3 * h), (3 * h,)), "proj": ((h, h), (h,)),
              "fc": ((h, i), (i,)), "mlp_proj": ((i, h), (h,))}
    lns = [names["ln_f"]] + [blk[k] for blk in names["blocks"]
                             for k in ("ln1", "ln2")]
    for scale, bias in lns:
        ckpt[scale] = normal(h, mean=1.0)
        ckpt[bias] = normal(h)
    for blk in names["blocks"]:
        for key, (wshape, bshape) in shapes.items():
            ckpt[blk[key][0]] = normal(*wshape)
            ckpt[blk[key][1]] = normal(*bshape)
    return ckpt


def _serve_ln(x, scale_bias, eps=1e-12):
    # population variance, as jnp.var (torch.var defaults to unbiased)
    scale, bias = scale_bias
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.reciprocal(torch.sqrt(var + eps)) * scale \
        + bias


def _serve_act(name):
    """Serving-side activation matching the graph builders' numerics:
    gelu is the tanh approximation."""
    try:
        return {"gelu": lambda x: F.gelu(x, approximate="tanh"),
                "relu": F.relu, "tanh": torch.tanh}[name]
    except KeyError:
        raise ValueError(
            f"unsupported hidden_act for the serving forward: {name!r} "
            f"(gelu/relu/tanh)") from None


def _serve_mlp(x, blk, act):
    h = act(x @ blk["fc"][0] + blk["fc"][1])
    return h @ blk["mlp_proj"][0] + blk["mlp_proj"][1]


def init_kv_cache(config, batch, max_len=None, device=None):
    """Zeroed K/V buffers on ``device`` (``cuda`` by default), one
    ``[B, H, S_max, D]`` f32 pair per layer; the decode functions write
    their rows in place."""
    dev = resolve_device(device)
    nh = config.num_attention_heads
    shape = (int(batch), nh, int(max_len or config.max_position_embeddings),
             config.hidden_size // nh)
    return [{"k": torch.zeros(shape, device=dev),
             "v": torch.zeros(shape, device=dev)}
            for _ in range(config.num_hidden_layers)]


@torch.inference_mode()
def gpt_prefill(params, kv, ids, num_heads, hidden_act="gelu"):
    """Prompt phase: causal forward over ``ids [B, S0]`` that writes rows
    ``0..S0-1`` of every layer's K/V buffers in place. Attention is
    :func:`prefill_attention` — kernel K1 on CUDA. Returns
    ``(logits [B, S0, V], kv)``."""
    act = _serve_act(hidden_act)
    b, s0 = ids.shape
    hidden = params["wte"].shape[1]
    hs = hidden // num_heads
    x = params["wte"][ids] + params["wpe"][:s0][None]
    for blk, layer in zip(params["blocks"], kv):
        h = _serve_ln(x, blk["ln1"])
        qkv = h @ blk["qkv"][0] + blk["qkv"][1]            # [B, S0, 3H]
        q, k, v = (qkv[..., i * hidden:(i + 1) * hidden]
                   .reshape(b, s0, num_heads, hs).transpose(1, 2)
                   for i in range(3))
        layer["k"][:, :, :s0] = k
        layer["v"][:, :, :s0] = v
        ctx = prefill_attention(q, k, v, sm_scale=1.0 / math.sqrt(hs),
                                causal=True)
        ctx = ctx.transpose(1, 2).reshape(b, s0, hidden)
        x = x + (ctx @ blk["proj"][0] + blk["proj"][1])
        x = x + _serve_mlp(_serve_ln(x, blk["ln2"]), blk, act)
    x = _serve_ln(x, params["ln_f"])
    return x @ params["lm_head"], kv


@torch.inference_mode()
def gpt_cached_step(params, kv, tokens, pos, num_heads, hidden_act="gelu"):
    """Cached single-token forward: ``tokens [B]`` at position ``pos`` (an
    int or a 0-d tensor). Writes row ``pos`` of every layer's K/V buffers
    in place and attends over rows ``0..pos`` through
    :func:`decode_attention`. Returns ``(logits [B, V], kv)``."""
    act = _serve_act(hidden_act)
    hidden = params["wte"].shape[1]
    hs = hidden // num_heads
    b = tokens.shape[0]
    x = params["wte"][tokens] + params["wpe"][pos]          # [B, H]
    for blk, layer in zip(params["blocks"], kv):
        h = _serve_ln(x, blk["ln1"])
        qkv = h @ blk["qkv"][0] + blk["qkv"][1]             # [B, 3H]
        q, k, v = (qkv[:, i * hidden:(i + 1) * hidden]
                   .reshape(b, num_heads, hs) for i in range(3))
        layer["k"][:, :, pos] = k
        layer["v"][:, :, pos] = v
        ctx = decode_attention(q, layer["k"], layer["v"], pos,
                               sm_scale=1.0 / math.sqrt(hs))
        x = x + (ctx.reshape(b, hidden) @ blk["proj"][0] + blk["proj"][1])
        x = x + _serve_mlp(_serve_ln(x, blk["ln2"]), blk, act)
    x = _serve_ln(x, params["ln_f"])
    return x @ params["lm_head"], kv


def _pool_scatter(pool, slots, rows):
    """Write ``rows [N, H, D]`` into flat slots of one layer's pooled
    cache ``[num_blocks, block_size, H, D]``, in place. Duplicate slots
    (padded lanes all targeting the scratch block) resolve to SOME
    written row — scratch content is never read unmasked."""
    pool.view(-1, *pool.shape[2:])[slots] = rows


def gpt_paged_prefill(params, pools, ids, slot_idx, num_heads,
                      hidden_act="gelu"):
    """Prompt phase over a block-paged pool: causal forward over ``ids
    [B, P]`` that scatters every position's K/V row into flat pool slots
    ``slot_idx [B, P]`` (padded rows point at the scratch block).
    Attention is :func:`prefill_attention` — kernel K1 on CUDA.
    Returns ``(logits [B, P, V], pools)``."""
    act = _serve_act(hidden_act)
    b, p = ids.shape
    hidden = params["wte"].shape[1]
    hs = hidden // num_heads
    x = params["wte"][ids] + params["wpe"][:p][None]
    flat_slots = slot_idx.reshape(b * p)
    for blk, pool in zip(params["blocks"], pools):
        h = _serve_ln(x, blk["ln1"])
        qkv = h @ blk["qkv"][0] + blk["qkv"][1]           # [B, P, 3H]
        q, k, v = (qkv[..., i * hidden:(i + 1) * hidden]
                   .reshape(b, p, num_heads, hs) for i in range(3))
        _pool_scatter(pool["k"], flat_slots, k.reshape(b * p, num_heads, hs))
        _pool_scatter(pool["v"], flat_slots, v.reshape(b * p, num_heads, hs))
        ctx = prefill_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2),
                                sm_scale=1.0 / math.sqrt(hs), causal=True)
        ctx = ctx.transpose(1, 2).reshape(b, p, hidden)
        x = x + (ctx @ blk["proj"][0] + blk["proj"][1])
        x = x + _serve_mlp(_serve_ln(x, blk["ln2"]), blk, act)
    x = _serve_ln(x, params["ln_f"])
    return x @ params["lm_head"], pools


def gpt_paged_step(params, pools, tokens, positions, slot_idx,
                   write_slots, num_heads, hidden_act="gelu"):
    """Paged single-token forward for a ragged batch: ``tokens [B]`` each
    at its own ``positions [B]``; writes each token's K/V row to
    ``write_slots [B]`` and attends through the slot grid ``slot_idx
    [B, S_bucket]``. Returns ``(logits [B, V], pools)``."""
    act = _serve_act(hidden_act)
    hidden = params["wte"].shape[1]
    hs = hidden // num_heads
    b = tokens.shape[0]
    x = params["wte"][tokens] + params["wpe"][positions]    # [B, H]
    for blk, pool in zip(params["blocks"], pools):
        h = _serve_ln(x, blk["ln1"])
        qkv = h @ blk["qkv"][0] + blk["qkv"][1]             # [B, 3H]
        q, k, v = (qkv[:, i * hidden:(i + 1) * hidden]
                   .reshape(b, num_heads, hs) for i in range(3))
        _pool_scatter(pool["k"], write_slots, k)
        _pool_scatter(pool["v"], write_slots, v)
        ctx = paged_decode_attention(q, pool["k"], pool["v"], slot_idx,
                                     positions,
                                     sm_scale=1.0 / math.sqrt(hs))
        x = x + (ctx.reshape(b, hidden) @ blk["proj"][0] + blk["proj"][1])
        x = x + _serve_mlp(_serve_ln(x, blk["ln2"]), blk, act)
    x = _serve_ln(x, params["ln_f"])
    return x @ params["lm_head"], pools


def gpt_paged_suffix_prefill(params, pools, ids, starts, slot_idx,
                             write_slots, num_heads, hidden_act="gelu"):
    """Prefill a chunk of prompt positions into an existing block table:
    ``ids [B, C]`` starting at token offset ``starts [B]``; rows scatter
    to ``write_slots [B, C]`` and attention gathers the whole history
    through ``slot_idx [B, S_bucket]`` (prefix-cache hits and chunked
    prefill). Returns ``(logits [B, C, V], pools)``."""
    act = _serve_act(hidden_act)
    b, c = ids.shape
    hidden = params["wte"].shape[1]
    hs = hidden // num_heads
    positions = starts[:, None] + torch.arange(c, device=ids.device)[None]
    # padded chunk columns may run past the learned positions; JAX's
    # gather clamps those indices, so clamp the same way
    positions = positions.clamp(max=params["wpe"].shape[0] - 1)
    x = params["wte"][ids] + params["wpe"][positions]
    flat_slots = write_slots.reshape(b * c)
    for blk, pool in zip(params["blocks"], pools):
        h = _serve_ln(x, blk["ln1"])
        qkv = h @ blk["qkv"][0] + blk["qkv"][1]           # [B, C, 3H]
        q, k, v = (qkv[..., i * hidden:(i + 1) * hidden]
                   .reshape(b, c, num_heads, hs) for i in range(3))
        _pool_scatter(pool["k"], flat_slots, k.reshape(b * c, num_heads, hs))
        _pool_scatter(pool["v"], flat_slots, v.reshape(b * c, num_heads, hs))
        ctx = paged_prefill_attention(q, pool["k"], pool["v"], slot_idx,
                                      starts,
                                      sm_scale=1.0 / math.sqrt(hs))
        ctx = ctx.reshape(b, c, hidden)
        x = x + (ctx @ blk["proj"][0] + blk["proj"][1])
        x = x + _serve_mlp(_serve_ln(x, blk["ln2"]), blk, act)
    x = _serve_ln(x, params["ln_f"])
    return x @ params["lm_head"], pools


# ---------------------------------------------------------------------------
# the graph model (reference hetu_tpu/models/gpt.py:347-489)
# ---------------------------------------------------------------------------

class CausalSelfAttention:
    """Multi-head causal attention. On the flash path the causal mask is
    a kernel flag and no [S, S] tensor exists; the composed path
    (``use_flash_attention=False``) adds a broadcast [1, 1, S, S]
    causal-mask constant, as the encoder's composed path adds its
    padding mask. ``sequence_parallel="ring"`` / ``"ulysses"`` takes the
    zigzag causal ring / causal Ulysses over the session mesh's ``"sp"``
    axis (the flash path off it), as the reference routes."""

    def __init__(self, config, name="attn"):
        if config.hidden_size % config.num_attention_heads:
            raise ValueError(
                f"hidden size {config.hidden_size} not a multiple of "
                f"num heads {config.num_attention_heads}")
        self.use_flash = config.use_flash_attention
        self.sequence_parallel = config.sequence_parallel
        self.num_heads = config.num_attention_heads
        self.head_size = config.hidden_size // config.num_attention_heads
        self.hidden_size = config.hidden_size
        self.seq_len = config.max_position_embeddings
        self.name = name
        self.qkv = Linear(config.hidden_size, 3 * config.hidden_size,
                          name=name + "_qkv")
        self.proj = Linear(config.hidden_size, config.hidden_size,
                           name=name + "_proj")
        self.dropout = Dropout(config.hidden_dropout_prob)

    def _split_heads(self, x, seq_len, which):
        # [B*S, 3H] -> [B, S, 3, nh, hs] -> take q/k/v -> [B, nh, S, hs]
        x = array_reshape_op(
            x, [-1, seq_len, 3, self.num_heads, self.head_size])
        x = transpose_op(x, [2, 0, 3, 1, 4])
        piece = split_op(x, [0], [which], [3])
        return squeeze_op(piece, axes=[0])

    def __call__(self, hidden_states, seq_len=None):
        seq_len = seq_len or self.seq_len
        qkv = self.qkv(hidden_states, [-1, 3 * self.hidden_size])
        q, k, v = (self._split_heads(qkv, seq_len, i) for i in range(3))
        scale = 1.0 / float(np.sqrt(self.head_size))
        if self.sequence_parallel == "ring":
            ctx = ring_attention_op(q, k, v, sm_scale=scale, causal=True)
        elif self.sequence_parallel == "ulysses":
            ctx = ulysses_attention_op(q, k, v, sm_scale=scale, causal=True)
        elif self.use_flash:
            ctx = flash_attention_op(q, k, v, sm_scale=scale, causal=True)
        else:
            cmask = Variable(
                self.name + "_causal_mask",
                value=np.where(np.tril(np.ones((seq_len, seq_len), bool)),
                               0.0, -1e9)[None, None].astype(np.float32),
                trainable=False)
            scores = batch_matmul_op(q, k * scale, trans_B=True)
            scores = scores + broadcastto_op(cmask, scores)
            ctx = batch_matmul_op(softmax_op(scores), v)
        ctx = transpose_op(ctx, [0, 2, 1, 3])
        ctx = array_reshape_op(ctx, [-1, seq_len, self.hidden_size])
        out = self.proj(ctx, [-1, seq_len, self.hidden_size])
        return self.dropout(out)


class GPTBlock:
    """Pre-LN decoder block: x += attn(ln1 x); x += mlp(ln2 x)."""

    def __init__(self, config, name="block"):
        self.ln1 = LayerNorm(config.hidden_size, name=name + "_ln1")
        self.attn = CausalSelfAttention(config, name=name + "_attn")
        self.ln2 = LayerNorm(config.hidden_size, name=name + "_ln2")
        self.fc = Linear(config.hidden_size, config.intermediate_size,
                         activation=_act(config.hidden_act),
                         name=name + "_mlp_fc")
        self.proj = Linear(config.intermediate_size, config.hidden_size,
                           name=name + "_mlp_proj")
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.hidden_size = config.hidden_size

    def __call__(self, x, seq_len):
        shape3 = [-1, seq_len, self.hidden_size]
        x = x + self.attn(self.ln1(x), seq_len)
        h = self.fc(self.ln2(x), shape3)
        h = self.proj(h, shape3)
        return x + self.dropout(h)


class GPTModel:
    """Token + position embeddings, N causal blocks, final LayerNorm."""

    def __init__(self, config):
        self.config = config
        self.seq_len = config.max_position_embeddings
        self.wte = Embedding(config.vocab_size, config.hidden_size,
                             "gpt_wte")
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, "gpt_wpe")
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.blocks = [GPTBlock(config, name=f"gpt_h{i}")
                       for i in range(config.num_hidden_layers)]
        self.ln_f = LayerNorm(config.hidden_size, name="gpt_ln_f")

    def __call__(self, input_ids, seq_len=None):
        seq_len = seq_len or self.seq_len
        position_ids = Variable(
            "gpt_position_ids", value=np.arange(seq_len).reshape(1, -1),
            trainable=False, dtype=np.int32)
        x = self.wte(input_ids)
        x = x + broadcastto_op(self.wpe(position_ids), x)
        x = self.dropout(x)
        for block in self.blocks:
            x = block(x, seq_len)
        return self.ln_f(x)


class GPTLMHeadModel:
    """GPTModel + untied LM head; returns (logits, per-position loss)
    when labels are given (labels pre-shifted by the caller, -1 where
    ignored)."""

    def __init__(self, config):
        self.config = config
        self.transformer = GPTModel(config)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              bias=False, name="gpt_lm_head")

    def __call__(self, input_ids, labels=None, seq_len=None):
        seq_len = seq_len or self.config.max_position_embeddings
        hidden = self.transformer(input_ids, seq_len)
        logits = self.lm_head(
            hidden, [-1, seq_len, self.config.vocab_size])
        if labels is None:
            return logits
        return logits, softmaxcrossentropy_sparse_op(logits, labels)


def staged_gpt(config, contexts, learning_rate):
    """:class:`GPTLMHeadModel` with its blocks split evenly over
    ``contexts``, one pipeline stage each, for an ``Executor`` with
    ``gpipe=True`` or ``pipedream=True``: the first stage also holds the
    embeddings, the last the final LayerNorm, the LM head, the mean loss
    over the positions and Adam's ``minimize``. The sequence is
    ``max_position_embeddings`` long, and its position embeddings are
    ``gpt_wpe``'s first S rows taken by a slice (the rows a lookup of
    positions 0..S-1 reads), so the first stage holds no integer
    constant and the table's gradient is dense. Returns (ids, labels,
    loss, optimizer, train_op); labels are pre-shifted, -1 where
    ignored."""
    from ..optimizer import AdamOptimizer
    nstages, layers = len(contexts), config.num_hidden_layers
    if layers % nstages:
        raise ValueError(f"{layers} blocks over {nstages} stages")
    per, seq = layers // nstages, config.max_position_embeddings
    ids = Variable("input_ids", trainable=False)
    labels = Variable("labels", trainable=False)
    model = GPTLMHeadModel(config)
    body = model.transformer
    for s, ctx in enumerate(contexts):
        with context(ctx):
            if s == 0:
                x = body.wte(ids)
                pos = slice_op(body.wpe.weight, (0, 0), (seq, -1))
                x = body.dropout(x + broadcastto_op(pos, x))
            for block in body.blocks[s * per:(s + 1) * per]:
                x = block(x, seq)
            if s == nstages - 1:
                logits = model.lm_head(body.ln_f(x),
                                       [-1, seq, config.vocab_size])
                loss = reduce_mean_op(
                    softmaxcrossentropy_sparse_op(logits, labels), [0, 1])
                opt = AdamOptimizer(learning_rate=learning_rate)
                train_op = opt.minimize(loss)
    return ids, labels, loss, opt, train_op
