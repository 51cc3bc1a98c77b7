"""Explicit-collective tensor parallelism via shard_map.

The default multi-device path (parallel/mesh.py) uses GSPMD sharding
annotations and lets XLA insert collectives.  This module is the explicit
variant of the same Megatron recipe, written with ``jax.shard_map`` and
hand-placed ``psum`` over the mesh:

* attention: q/k/v projections column-parallel (each device owns
  ``n_head/tp`` heads), out-projection row-parallel, one ``psum`` to combine;
* GEGLU feed-forward: first projection column-parallel (both halves of the
  gate split sharded together), second row-parallel, one ``psum``.

Numerically identical to the single-device blocks (tested to 1e-5 on the
virtual 8-device mesh); useful when you want collective placement to be
explicit and schedulable rather than GSPMD-inferred.
"""
from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import blocks as B
from ..ops.attention import attention
from .mesh import TP_AXIS


def shard_transformer_params(params: Dict[str, jnp.ndarray], pre: str,
                             mesh: Mesh, n_head: int):
    """Place one basic-transformer block's params for the shard_map kernel.

    q/k/v weights are reordered so each device's shard holds whole heads;
    the GEGLU projection is reordered so each shard holds matching halves of
    (value, gate).  Returns a new dict of device arrays.
    """
    tp = mesh.shape[TP_AXIS]
    out = {}

    def col(w):  # [in, out] -> shard out
        return jax.device_put(w, NamedSharding(mesh, P(None, TP_AXIS)))

    def row(w):  # [in, out] -> shard in
        return jax.device_put(w, NamedSharding(mesh, P(TP_AXIS, None)))

    def repl(w):
        return jax.device_put(w, NamedSharding(mesh, P()))

    for name, w in params.items():
        rel = name[len(pre) + 1:] if name.startswith(pre) else name
        if rel.endswith((".attn1.q_proj.weight", ".attn1.k_proj.weight",
                         ".attn1.v_proj.weight", ".attn2.q_proj.weight",
                         ".attn2.k_proj.weight", ".attn2.v_proj.weight")) \
                or rel in ("attn1.q_proj.weight", "attn1.k_proj.weight",
                           "attn1.v_proj.weight", "attn2.q_proj.weight",
                           "attn2.k_proj.weight", "attn2.v_proj.weight"):
            out[name] = col(w)
        elif rel.endswith("out_proj.weight") or rel == "out_proj.weight":
            out[name] = row(w)
        elif rel.endswith("ff.net.0.proj.weight") or \
                rel == "ff.net.0.proj.weight":
            # reorder [in, 2*d] so each shard holds (value_i, gate_i)
            d2 = w.shape[1]
            d = d2 // 2
            val, gate = w[:, :d], w[:, d:]
            parts = []
            for i in range(tp):
                s = slice(i * d // tp, (i + 1) * d // tp)
                parts.extend([val[:, s], gate[:, s]])
            out[name] = col(jnp.concatenate(parts, axis=1))
        elif rel.endswith("ff.net.0.proj.bias") or \
                rel == "ff.net.0.proj.bias":
            d2 = w.shape[0]
            d = d2 // 2
            val, gate = w[:d], w[d:]
            parts = []
            for i in range(tp):
                s = slice(i * d // tp, (i + 1) * d // tp)
                parts.extend([val[s], gate[s]])
            out[name] = jax.device_put(jnp.concatenate(parts),
                                       NamedSharding(mesh, P(TP_AXIS)))
        elif rel.endswith("ff.net.2.weight") or rel == "ff.net.2.weight":
            out[name] = row(w)
        elif rel.endswith((".q_proj.bias", ".k_proj.bias", ".v_proj.bias")):
            out[name] = jax.device_put(w, NamedSharding(mesh, P(TP_AXIS)))
        else:
            out[name] = repl(w)
    return out


def tp_basic_transformer(mesh: Mesh, pre: str, n_head: int, d_model: int):
    """Build a shard_map'ed basic-transformer forward.

    Returns ``f(params, x, c) -> y`` where params are placed by
    :func:`shard_transformer_params`, x: [N,S,d_model], c: [N,Sk,d_ctx];
    all activations replicated at entry/exit, one psum per attention and one
    per feed-forward.
    """
    tp = mesh.shape[TP_AXIS]
    heads_local = n_head // tp
    assert heads_local * tp == n_head

    def local_attn(p, q_in, kv_in, name, causal=False):
        def lin(which, x_, bias):
            w = p[f"{pre}.{name}.{which}.weight"]
            y = jnp.dot(x_, w.astype(x_.dtype))
            bkey = f"{pre}.{name}.{which}.bias"
            if bias and bkey in p:
                y = y + p[bkey].astype(y.dtype)
            return y

        n, sq = q_in.shape[0], q_in.shape[1]
        sk = kv_in.shape[1]
        d_local = d_model // tp
        d_head = d_model // n_head
        q = lin("q_proj", q_in, False).reshape(n, sq, heads_local, d_head)
        k = lin("k_proj", kv_in, False).reshape(n, sk, heads_local, d_head)
        v = lin("v_proj", kv_in, False).reshape(n, sk, heads_local, d_head)
        o = attention(q, k, v, causal=causal).reshape(n, sq, d_local)
        # row-parallel out projection: each device multiplies its slice,
        # psum combines partial sums over the tp axis
        w_out = p[f"{pre}.{name}.out_proj.weight"]
        y = jnp.dot(o, w_out.astype(o.dtype))
        y = jax.lax.psum(y, TP_AXIS)
        bkey = f"{pre}.{name}.out_proj.bias"
        if bkey in p:
            y = y + p[bkey].astype(y.dtype)
        return y

    def local_ff(p, x):
        w0 = p[f"{pre}.ff.net.0.proj.weight"]   # [d, 2*d_inner/tp] reordered
        y = jnp.dot(x, w0.astype(x.dtype))
        b0 = p.get(f"{pre}.ff.net.0.proj.bias")
        if b0 is not None:
            y = y + b0.astype(y.dtype)
        d_local = y.shape[-1] // 2
        val, gate = y[..., :d_local], y[..., d_local:]
        h = val * B.gelu_tanh(gate)
        w2 = p[f"{pre}.ff.net.2.weight"]
        out = jnp.dot(h, w2.astype(h.dtype))
        out = jax.lax.psum(out, TP_AXIS)
        b2 = p.get(f"{pre}.ff.net.2.bias")
        if b2 is not None:
            out = out + b2.astype(out.dtype)
        return out

    def block(p, x, c):
        ctx = B.Ctx(p, dtype=x.dtype)
        r = x
        x = B.layer_norm(ctx, f"{pre}.norm1", x)
        x = local_attn(p, x, x, "attn1") + r
        r = x
        x = B.layer_norm(ctx, f"{pre}.norm2", x)
        x = local_attn(p, x, c, "attn2") + r
        r = x
        x = B.layer_norm(ctx, f"{pre}.norm3", x)
        return local_ff(p, x) + r

    param_specs = P()  # placement done by shard_transformer_params; specs
    # are inferred from the arrays themselves via shard_map's auto mode

    def fwd(params, x, c):
        specs = {k: _spec_of(v) for k, v in params.items()}
        f = jax.shard_map(
            block, mesh=mesh,
            in_specs=(specs, P(), P()),
            out_specs=P(),
            check_vma=False)
        return f(params, x, c)

    return fwd


def _spec_of(v) -> P:
    sh = getattr(v, "sharding", None)
    if isinstance(sh, NamedSharding):
        return sh.spec
    return P()
