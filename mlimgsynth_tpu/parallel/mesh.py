"""Multi-device execution: device mesh + sharding rules.

The reference is strictly single-device (SURVEY.md section 2.5); this module
is the scaling layer it lacks: a ``jax.sharding.Mesh`` over
(data, tensor) axes, named shardings for the UNet/CLIP params (attention and
feed-forward matmuls sharded over the ``tp`` axis in Megatron style: qkv
column-parallel, out-projection row-parallel), and batch sharding over ``dp``.
XLA's SPMD partitioner inserts the all-reduce/all-gather collectives (NCCL
on GPUs, whose cards a host joins all to all over NVLink).
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DP_AXIS = "dp"
PP_AXIS = "pp"
SP_AXIS = "sp"
TP_AXIS = "tp"


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, sp: int = 1,
              pp: int = 1, devices=None) -> Mesh:
    """Create a (dp, pp, sp, tp) mesh over the first ``n_devices`` devices.

    ``tp`` is innermost (fastest-varying device index, the most frequent
    collectives: one all-reduce per matmul), ``sp`` next (the ring
    attention ppermute ring), ``pp`` next (stage handoffs are one hop per
    microbatch tick), ``dp`` is outermost (no per-step collectives).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    assert n_devices % (tp * sp * pp) == 0, (n_devices, tp, sp, pp)
    grid = devices.reshape(n_devices // (tp * sp * pp), pp, sp, tp)
    return Mesh(grid, (DP_AXIS, PP_AXIS, SP_AXIS, TP_AXIS))


# Megatron-style tensor-parallel rules for transformer blocks:
# column-parallel (shard output dim), row-parallel (shard input dim).
_TP_RULES = [
    (r"\.(attn1|attn2|attn)\.(q_proj|k_proj|v_proj)\.weight$", P(None, TP_AXIS)),
    (r"\.(attn1|attn2|attn)\.(q_proj|k_proj|v_proj)\.bias$", P(TP_AXIS)),
    (r"\.(attn1|attn2|attn)\.out_proj\.weight$", P(TP_AXIS, None)),
    (r"\.ff\.net\.0\.proj\.weight$", P(None, TP_AXIS)),
    (r"\.ff\.net\.0\.proj\.bias$", P(TP_AXIS)),
    (r"\.ff\.net\.2\.weight$", P(TP_AXIS, None)),
    (r"\.mlp\.fc1\.weight$", P(None, TP_AXIS)),
    (r"\.mlp\.fc1\.bias$", P(TP_AXIS)),
    (r"\.mlp\.fc2\.weight$", P(TP_AXIS, None)),
    # MMDiT (SD3): fused qkv column-parallel, attention out-proj
    # row-parallel (the .mlp rules above already cover both streams' FFNs).
    # GSPMD re-tiles across the packed q/k/v boundary when tp doesn't align
    # with it — correct always, collective-optimal when tp divides heads.
    # attn2 is MMDiT-X's (SD3.5-medium) dual self-attention branch.
    (r"\.(attn|attn2)\.qkv\.weight$", P(None, TP_AXIS)),
    (r"\.(attn|attn2)\.qkv\.bias$", P(TP_AXIS)),
    (r"\.(attn|attn2)\.proj\.weight$", P(TP_AXIS, None)),
    # Flux double-stream blocks: per-stream fused qkv + out-proj + MLP.
    (r"\.(img_attn|txt_attn)\.qkv\.weight$", P(None, TP_AXIS)),
    (r"\.(img_attn|txt_attn)\.qkv\.bias$", P(TP_AXIS)),
    (r"\.(img_attn|txt_attn)\.proj\.weight$", P(TP_AXIS, None)),
    (r"\.(img_mlp|txt_mlp)\.0\.weight$", P(None, TP_AXIS)),
    (r"\.(img_mlp|txt_mlp)\.0\.bias$", P(TP_AXIS)),
    (r"\.(img_mlp|txt_mlp)\.2\.weight$", P(TP_AXIS, None)),
    # Flux single-stream blocks: linear1 emits the [qkv | mlp] concat
    # (column-parallel over the fused output), linear2 merges it back
    # (row-parallel).  Scoped to single_blocks so the generic names don't
    # capture unrelated layers.
    (r"\.single_blocks\.\d+\.linear1\.weight$", P(None, TP_AXIS)),
    (r"\.single_blocks\.\d+\.linear1\.bias$", P(TP_AXIS)),
    (r"\.single_blocks\.\d+\.linear2\.weight$", P(TP_AXIS, None)),
    # T5 v1.1 encoder (SD3's third tower): q/k/v column-parallel, o
    # row-parallel ([in,out] storage, models/t5.py reshapes to heads at
    # trace time — GSPMD propagates the sharding through the reshape);
    # gated-gelu FFN wi_0/wi_1 column, wo row.  No biases in T5.
    (r"\.SelfAttention\.(q|k|v)\.weight$", P(None, TP_AXIS)),
    (r"\.SelfAttention\.o\.weight$", P(TP_AXIS, None)),
    (r"\.DenseReluDense\.(wi_0|wi_1)\.weight$", P(None, TP_AXIS)),
    (r"\.DenseReluDense\.wo\.weight$", P(TP_AXIS, None)),
]


def param_spec(name: str, ndim: int, tp: bool = True) -> P:
    # pipeline-stacked block slabs ([pp, L, ...], parallel/pipeline.py):
    # stage axis over 'pp', independent of the tp toggle
    if ".joint_blocks_p." in name or name.endswith("joint_blocks_p"):
        return P(PP_AXIS)
    if tp:
        for pat, spec in _TP_RULES:
            if re.search(pat, name):
                return spec
    return P()  # replicated


def param_shardings(params: Dict[str, object], mesh: Mesh,
                    tp: bool = True) -> Dict[str, NamedSharding]:
    """NamedSharding for every param; non-tp params replicated."""
    use_tp = tp and mesh.shape.get(TP_AXIS, 1) > 1
    out = {}
    for name, v in params.items():
        spec = param_spec(name, getattr(v, "ndim", 0), tp=use_tp)
        out[name] = NamedSharding(mesh, spec)
    return out


def shard_params(params: Dict[str, object], mesh: Mesh,
                 tp: bool = True) -> Dict[str, object]:
    sh = param_shardings(params, mesh, tp=tp)
    return {k: jax.device_put(v, sh[k]) for k, v in params.items()}


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading (batch) axis over dp, replicate the rest."""
    return NamedSharding(mesh, P(DP_AXIS, *([None] * (ndim - 1))))


def shard_batch(x, mesh: Mesh):
    return jax.device_put(x, batch_sharding(mesh, np.ndim(x)))
