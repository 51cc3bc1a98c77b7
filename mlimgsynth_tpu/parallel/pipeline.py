"""Pipeline parallelism over a ``pp`` mesh axis (GPipe-style inference).

The reference is strictly single-device; its closest notion is staged
weight residency (``--unet-split``).  This module is true pipeline
parallelism for the transformer DiT families: the block stack is cut into
``pp`` stages of ``L = depth/pp`` consecutive blocks, each stage's weights
live only on its stage devices (a ``[pp, L, ...]`` slab sharded over
``pp``), and microbatches stream through the stages — stage ``s`` works on
microbatch ``t - s`` at tick ``t`` while its neighbours work on adjacent
microbatches, with the activations handed to the next stage each tick via
``lax.ppermute``.

SPMD formulation (every device runs the same program inside
``jax.shard_map``):

* state = the activation pytree this device processes at the current tick
  (bubble ticks process a zero block; outputs are masked by validity);
* one tick = run the local ``L`` blocks, collect the result on the last
  stage when it corresponds to a real microbatch, ppermute the activations
  to the next stage, inject the next microbatch on stage 0;
* ``M + pp - 1`` ticks drain the pipeline for ``M`` microbatches; the
  output buffer (written only by the last stage) is ``psum``'d over ``pp``
  to replicate the result.

Weight memory per device is O(params/pp).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from .mesh import PP_AXIS

# Set by the session when --pp > 1 (read at trace time by the model
# forwards, the same pattern as ops.attention.MESH).
PLAN = None


@dataclass(frozen=True)
class PipelinePlan:
    mesh: object
    pp: int
    n_micro: int = 0      # 0 = one microbatch per sample


def _tree_map(f, *ts):
    return jax.tree_util.tree_map(f, *ts)


def pipeline_apply(mesh, block_fn, slab, acts, n_micro=0, collect=1):
    """Run ``block_fn`` over a pipeline of ``pp`` stages.

    mesh: the session mesh (``pp`` axis size > 1).
    block_fn(block_params, acts) -> acts: one block; ``block_params`` is the
      pytree ``slab`` with the two leading (stage, block) axes indexed away.
    slab: pytree of ``[pp, L, ...]`` arrays (sharded over ``pp`` outside).
    acts: pytree of ``[N, ...]`` inputs (replicated).
    n_micro: microbatch count M (divides N; 0 = M = N).
    collect: index into the acts tuple to return (``[N, ...]``, replicated).
    """
    pp = mesh.shape[PP_AXIS]
    leaves = jax.tree_util.tree_leaves(acts)
    n = leaves[0].shape[0]
    m = n_micro or n
    if m < 1 or n % m:
        raise ValueError(
            f"pipeline microbatch count {m} (MLIS_PP_MICRO) must divide "
            f"the model batch {n}")
    perm = [(i, i + 1) for i in range(pp - 1)]   # stage s -> s+1, 0 gets zeros
    n_tick = m + pp - 1

    def body(slab, *acts):
        s = lax.axis_index(PP_AXIS)
        inp = _tree_map(lambda a: a.reshape(m, n // m, *a.shape[1:]), acts)
        l_blocks = jax.tree_util.tree_leaves(slab)[0].shape[1]

        def run_stage(act):
            for j in range(l_blocks):
                pj = _tree_map(lambda a: a[0, j], slab)
                act = block_fn(pj, act)
            return act

        def inject(t):
            tc = jnp.clip(t, 0, m - 1)
            return _tree_map(
                lambda a: lax.dynamic_index_in_dim(a, tc, 0, False), inp)

        def tick(carry, t):
            act, out = carry
            y = run_stage(act)
            # last stage: store microbatch t-(pp-1) when it is real
            idx = t - (pp - 1)
            valid = jnp.logical_and(s == pp - 1, idx >= 0)
            idxc = jnp.clip(idx, 0, m - 1)
            y_c = y[collect]
            cur = lax.dynamic_index_in_dim(out, idxc, 0, False)
            out = lax.dynamic_update_index_in_dim(
                out, jnp.where(valid, y_c, cur), idxc, 0)
            # hand the activations one stage down the ring; stage 0 takes
            # the next microbatch instead
            y_shift = _tree_map(
                lambda a: lax.ppermute(a, PP_AXIS, perm), y)
            nxt = inject(t + 1)
            act = _tree_map(lambda sh, ij: jnp.where(s == 0, ij, sh),
                            y_shift, nxt)
            return (act, out), None

        zero = _tree_map(lambda a: jnp.zeros_like(a[0]), inp)
        act0 = _tree_map(lambda z, ij: jnp.where(s == 0, ij, z),
                         zero, inject(0))
        out0 = jnp.zeros_like(inp[collect])
        (_, out), _ = lax.scan(tick, (act0, out0), jnp.arange(n_tick))
        # only the last stage wrote; replicate over the pp ring
        out = lax.psum(out, PP_AXIS)
        return out.reshape(n, *out.shape[2:])

    slab_spec = _tree_map(lambda _: P(PP_AXIS), slab)
    f = jax.shard_map(body, mesh=mesh,
                      in_specs=(slab_spec,) + (P(),) * len(acts),
                      out_specs=P(), check_vma=False)
    return f(slab, *acts)
