"""Sequence/context-parallel attention over an ``sp`` mesh axis.

The reference is strictly single-device and has no sequence parallelism at
all (SURVEY.md section 2.5 lists it as absent); this module is the
long-context scaling layer: the token axis of attention is sharded over the
``sp`` mesh axis and the key/value blocks travel round a ring of devices.

Two collectives patterns, picked by shape:

* **Ring attention** (self/joint attention, ``Sq == Sk``): every device holds
  a ``S/sp`` slice of q, k and v.  A ``lax.scan`` runs ``sp`` steps of the
  online-softmax recurrence — each step contracts the local q block against
  the currently-resident k/v block (f32 accumulators) and then rotates the
  k/v block one hop around the ring with ``lax.ppermute``.  Memory per
  device is O(S/sp); the ppermute hop can overlap with the next block's
  matmul under XLA's async collectives.  This is the standard formulation
  (Liu et al., Ring Attention; jax shard_map manual-SPMD) — the DiT
  families (SD3 S≈4k, Flux S≈4.3k) are the target shapes.

* **Q-sharded cross attention** (``Sk`` small, e.g. the 77-token text
  context): q is sharded over ``sp``, k/v are replicated, each device
  computes its q rows locally — no per-step collectives at all.

Both run inside ``jax.shard_map`` so they compose with the dp (batch) and tp
(heads) axes of the same mesh: specs are ``P(dp, sp, tp, None)`` on
``[B, S, H, D]`` tensors.  Logits and softmax statistics are f32, the PV
contraction runs in the input dtype with an f32 accumulator.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from .mesh import DP_AXIS, SP_AXIS, TP_AXIS


def _qkv_spec():
    return P(DP_AXIS, SP_AXIS, TP_AXIS, None)


def _kv_replicated_spec():
    return P(DP_AXIS, None, TP_AXIS, None)


def _local_attention(q, k, v, scale):
    """Plain softmax attention on local blocks (f32 logits/softmax)."""
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                   preferred_element_type=jnp.float32) * scale
    w = jax.nn.softmax(s, axis=-1).astype(q.dtype)
    return jnp.einsum("bhqk,bkhd->bqhd", w, v,
                      preferred_element_type=jnp.float32).astype(q.dtype)


def _pad_tokens(x, n):
    """Zero-pad axis 1 (tokens) of [B, S, H, D] to ``n`` rows."""
    if x.shape[1] == n:
        return x
    return jnp.pad(x, ((0, 0), (0, n - x.shape[1]), (0, 0), (0, 0)))


def ring_attention(q, k, v, mesh, scale=None):
    """Self-attention with the sequence axis sharded over ``sp``.

    q, k, v: ``[B, S, H, D]`` with ``Sq == Sk``; B divides dp, H divides tp.
    S need not divide sp: the tokens are zero-padded to the next multiple
    and the padded keys masked out (SD3 at 1024px has 4096 + 154 tokens).
    Returns ``[B, S, H, D]`` in q's dtype, sharded the same way.
    Online-softmax accumulation over ``sp`` ring steps: ``sp - 1`` scanned
    steps each compute one block and hop k/v one ring position, the last
    resident block is consumed outside the scan — exactly ``sp - 1``
    ppermute pairs total (lax.scan bodies run uniformly, so a
    skip-on-last-iteration inside the scan would not be eliminated).
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    nsp = mesh.shape[SP_AXIS]
    perm = [(i, (i + 1) % nsp) for i in range(nsp)]
    n_tok = q.shape[1]
    n_pad = -(-n_tok // nsp) * nsp
    blk = n_pad // nsp

    def body(q, k, v):
        b, sq, h, _ = q.shape
        bq = (b, h, sq, 1)
        me = lax.axis_index(SP_AXIS)

        def block(i, m, l, o, kc, vc):
            # statistics and the accumulator stay [b, h, q, .] inside the
            # loop; the one transpose back to [b, q, h, d] is at the end
            s = jnp.einsum("bqhd,bkhd->bhqk", q, kc,
                           preferred_element_type=jnp.float32) * scale
            if n_pad != n_tok:
                # at step i this device holds the block of device me - i;
                # a large finite negative keeps fully padded rows NaN-free
                first = ((me - i) % nsp) * blk
                real = first + jnp.arange(blk) < n_tok
                s = jnp.where(real, s, -1e30)
            m_new = jnp.maximum(m, jnp.max(s, axis=-1, keepdims=True))
            p = jnp.exp(s - m_new)
            alpha = jnp.exp(m - m_new)
            l_new = l * alpha + jnp.sum(p, axis=-1, keepdims=True)
            pv = jnp.einsum("bhqk,bkhd->bhqd", p.astype(vc.dtype), vc,
                            preferred_element_type=jnp.float32)
            return m_new, l_new, o * alpha + pv

        def step(carry, i):
            m, l, o, kc, vc = carry
            m, l, o = block(i, m, l, o, kc, vc)
            kc = lax.ppermute(kc, SP_AXIS, perm)
            vc = lax.ppermute(vc, SP_AXIS, perm)
            return (m, l, o, kc, vc), None

        m = jnp.full(bq, -jnp.inf, jnp.float32)
        l = jnp.zeros(bq, jnp.float32)
        o = jnp.zeros((b, h, sq, v.shape[-1]), jnp.float32)
        kc, vc = k, v
        if nsp > 1:
            (m, l, o, kc, vc), _ = lax.scan(
                step, (m, l, o, kc, vc), jnp.arange(nsp - 1))
        # final block: no wasted hop
        m, l, o = block(nsp - 1, m, l, o, kc, vc)
        return (o / l).transpose(0, 2, 1, 3).astype(q.dtype)

    f = jax.shard_map(body, mesh=mesh, in_specs=(_qkv_spec(),) * 3,
                      out_specs=_qkv_spec(), check_vma=False)
    out = f(_pad_tokens(q, n_pad), _pad_tokens(k, n_pad),
            _pad_tokens(v, n_pad))
    return out[:, :n_tok]


def sp_cross_attention(q, k, v, mesh, scale=None):
    """Cross-attention with q sharded over ``sp`` and k/v replicated.

    For short contexts (the 77-token CLIP rows of the UNet's attn2) a ring
    buys nothing — replicating k/v and splitting the q rows over the mesh is
    collective-free.  Shapes: q ``[B, Sq, H, D]`` (padded to a multiple of
    sp inside), k/v ``[B, Sk, H, D]`` (any Sk).
    """
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    nsp = mesh.shape[SP_AXIS]
    n_tok = q.shape[1]

    def body(q, k, v):
        return _local_attention(q, k, v, scale)

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(_qkv_spec(), _kv_replicated_spec(), _kv_replicated_spec()),
        out_specs=_qkv_spec(), check_vma=False)
    return f(_pad_tokens(q, -(-n_tok // nsp) * nsp), k, v)[:, :n_tok]


def sp_compatible(mesh, b: int, h: int) -> bool:
    """True when (b, h) divide the mesh's (dp, tp) axes (the token axis is
    padded to the sp axis inside)."""
    dp = mesh.shape.get(DP_AXIS, 1)
    tp = mesh.shape.get(TP_AXIS, 1)
    return b % dp == 0 and h % tp == 0
