"""T5 v1.1 encoder (SD3's third text tower).

Beyond-reference: the reference framework has no T5; SD3 conditioning
optionally appends T5-XXL token embeddings to the CLIP context
(models/mmdit.py).  Architecture follows the public T5 v1.1 encoder:
RMSNorm (no mean subtraction, no bias), UNSCALED dot-product attention with
a shared relative-position bias table (32 buckets, max distance 128, added
to the logits in every layer from block 0's embedding), and the gated-gelu
feed-forward ``wo(gelu(wi_0 x) * wi_1 x)``.  No linear has a bias.

Params are keyed by the HF state-dict names under the internal ``t5.``
prefix (``t5.shared.weight``, ``t5.encoder.block.N.layer.0.SelfAttention.q
.weight`` ...), which is exactly how the sd3 single-file layout ships them
(``text_encoders.t5xxl.transformer.*`` — see nameconv._t5), so both bundled
and standalone T5 checkpoints key directly.

Device notes: relative-position bucket indices are computed host-side at
trace time (static sequence length) so the bias is one gather + transpose;
the sequence is <= 256 tokens, so attention runs its own XLA softmax with
the logits bias added.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from . import blocks as B


@dataclass(frozen=True)
class T5Params:
    d_model: int = 4096
    d_kv: int = 64
    n_head: int = 64
    d_ff: int = 10240
    n_layer: int = 24
    n_vocab: int = 32128
    rel_buckets: int = 32
    rel_max_dist: int = 128


T5_XXL = T5Params()

T5_PAD_ID = 0
T5_EOS_ID = 1


def params_from_spec_shapes(shapes) -> T5Params:
    """Infer the T5 geometry from checkpoint tensor shapes.

    ``shapes`` maps internal names to shape tuples; works for any T5 v1.1
    size (XXL in sd3 bundles, smaller ones in tests)."""
    n_vocab, d_model = shapes["t5.shared.weight"]
    q = shapes["t5.encoder.block.0.layer.0.SelfAttention.q.weight"]
    inner = q[0]  # [out,in] checkpoint layout
    rel = shapes["t5.encoder.block.0.layer.0.SelfAttention"
                 ".relative_attention_bias.weight"]
    n_head = rel[1]
    d_ff = shapes["t5.encoder.block.0.layer.1.DenseReluDense.wi_0.weight"][0]
    n_layer = 0
    while f"t5.encoder.block.{n_layer}.layer.0.layer_norm.weight" in shapes:
        n_layer += 1
    return T5Params(d_model=int(d_model), d_kv=int(inner) // int(n_head),
                    n_head=int(n_head), d_ff=int(d_ff), n_layer=n_layer,
                    n_vocab=int(n_vocab), rel_buckets=int(rel[0]))


def _rms_norm(ctx: B.Ctx, name: str, x, eps: float = 1e-6):
    """T5 LayerNorm: RMS only, f32 statistics, scale weight, no bias."""
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    w = ctx.param(name + ".weight", (x.shape[-1],), B.VEC, jnp.float32)
    return ((xf * jnp.reciprocal(jnp.sqrt(var + eps)))
            .astype(x.dtype) * w.astype(x.dtype))


def _rel_bucket_np(rel_pos: np.ndarray, num_buckets: int,
                   max_dist: int) -> np.ndarray:
    """Bidirectional relative-position bucketing (T5 convention):
    rel_pos = memory_pos - context_pos."""
    nb = num_buckets // 2
    ret = (rel_pos > 0).astype(np.int64) * nb
    n = np.abs(rel_pos)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / math.log(max_dist / max_exact) * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return ret + np.where(n < max_exact, n, large)


def rel_bias_indices(s: int, num_buckets: int = 32,
                     max_dist: int = 128) -> np.ndarray:
    """[s, s] bucket ids for a length-s sequence (host-side, static)."""
    ctx_pos = np.arange(s, dtype=np.int64)[:, None]
    mem_pos = np.arange(s, dtype=np.int64)[None, :]
    return _rel_bucket_np(mem_pos - ctx_pos, num_buckets, max_dist)


def _attention(ctx: B.Ctx, pre: str, x, bias, P: T5Params):
    """Unscaled self-attention with the shared relative-position bias.
    x: [N,S,d]; bias: [1,H,S,S] f32."""
    inner = P.n_head * P.d_kv
    n, s = x.shape[0], x.shape[1]

    def proj(which):
        # B.linear (not a raw ctx.param einsum) so the quantized-pair
        # dispatch applies — int8/int4 weight tiers cover T5 fully
        y = B.linear(ctx, f"{pre}.{which}", x, inner, bias=False)
        return y.reshape(n, s, P.n_head, P.d_kv).transpose(0, 2, 1, 3)

    q, k, v = proj("q"), proj("k"), proj("v")
    logits = jnp.einsum("nhqd,nhkd->nhqk", q, k,
                        preferred_element_type=jnp.float32)
    logits = logits + bias
    w = jnp.exp(logits - jnp.max(logits, axis=-1, keepdims=True))
    w = (w / jnp.sum(w, axis=-1, keepdims=True)).astype(x.dtype)
    o = jnp.einsum("nhqk,nhkd->nhqd", w, v)
    o = o.transpose(0, 2, 1, 3).reshape(n, s, inner)
    return B.linear(ctx, pre + ".o", o, P.d_model, bias=False)


def _ffn(ctx: B.Ctx, pre: str, x, P: T5Params):
    g = B.linear(ctx, pre + ".wi_0", x, P.d_ff, bias=False)
    u = B.linear(ctx, pre + ".wi_1", x, P.d_ff, bias=False)
    return B.linear(ctx, pre + ".wo", B.gelu_tanh(g) * u, P.d_model,
                    bias=False)


def t5_encode_apply(ctx: B.Ctx, tokens, P: T5Params, pre: str = "t5"):
    """Encoder forward.  tokens: int32 [N, S]; returns [N, S, d_model].

    Mirrors the public SD3 pipelines' usage: no padding mask (pad-position
    embeddings participate as context)."""
    tw = ctx.param(pre + ".shared.weight", (P.n_vocab, P.d_model), B.EMBED)
    x = jnp.take(tw, tokens, axis=0).astype(ctx.dtype)
    s = int(tokens.shape[1])
    idx = rel_bias_indices(s, P.rel_buckets, P.rel_max_dist)
    table = ctx.param(
        pre + ".encoder.block.0.layer.0.SelfAttention"
        ".relative_attention_bias.weight",
        (P.rel_buckets, P.n_head), B.EMBED, jnp.float32)
    bias = jnp.take(table.astype(jnp.float32), jnp.asarray(idx), axis=0)
    bias = bias.transpose(2, 0, 1)[None]          # [1, H, S, S]
    for i in range(P.n_layer):
        bpre = f"{pre}.encoder.block.{i}"
        h = _rms_norm(ctx, f"{bpre}.layer.0.layer_norm", x)
        x = x + _attention(ctx, f"{bpre}.layer.0.SelfAttention", h, bias, P)
        h = _rms_norm(ctx, f"{bpre}.layer.1.layer_norm", x)
        x = x + _ffn(ctx, f"{bpre}.layer.1.DenseReluDense", h, P)
    return _rms_norm(ctx, pre + ".encoder.final_layer_norm", x)


def tokenize(texts, n_token: int = 77, tokenizer_json: str = None):
    """Tokenize with a T5 ``tokenizer.json`` (HF tokenizers format — the
    file distributed next to every T5/SD3 checkpoint).  Appends EOS (1) and
    pads with 0 to ``n_token``, truncating like the SD3 pipelines.

    sentencepiece is not vendored; the fast-tokenizer JSON covers the real
    checkpoints and anything tokenizers-compatible works for tests."""
    if tokenizer_json is None:
        raise ValueError("T5 tokenization needs a tokenizer.json path "
                         "(option t5_tokenizer)")
    from tokenizers import Tokenizer
    tok = Tokenizer.from_file(tokenizer_json)
    out = np.full((len(texts), n_token), T5_PAD_ID, np.int32)
    for i, text in enumerate(texts):
        ids = tok.encode(text).ids[:n_token - 1]
        ids = list(ids) + [T5_EOS_ID]
        out[i, :len(ids)] = ids
    return out
