"""Context-parallel prefill of the dense family.

The JAX package's ``repro.models.context_parallel.cp_prefill`` shards the
sequence over the mesh's model axis for the whole forward: shard ``i`` of
``n`` holds tokens ``[i S/n, (i+1) S/n)``, and each layer all-gathers its
weights and the K/V heads of every shard, so each shard attends with its
queries at their absolute offset (``blocked_attention(q_offset=...)``) to
the K/V of the whole sequence. The late shards do more attention work than
the early ones (the causal prefix); that package records the imbalance
and so does this one.

On one card the port runs the ``n`` shards in turn, in lockstep layer by
layer: layer ``l``'s K/V gather needs every shard's layer-``l`` K/V, so the
loop over shards sits inside the loop over layers. The weight gathers are
identities (one device holds every weight whole) and the K/V gather is a
concatenation along the sequence. Each shard's attention is one
``flash_attention`` launch at the shard's offset on the card; under
autograd its gradient is one ``flash_attention_bwd`` launch at that
offset, so ``cp_prefill`` is differentiable, as the JAX package's is. At
one shard the calls are those of ``transformer.prefill``, in its order,
so the logits are bit for bit the ordinary prefill's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import MeshEnv
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, apply_norm, dot
from repro_torch.models.transformer import (_stacked_block_specs,
                                            constrain_params, embed_tokens,
                                            logits_fn, strip_layer_axis,
                                            unbind_layers)


def cp_prefill(cfg: ModelConfig, run: RunConfig, env: MeshEnv, params,
               tokens: torch.Tensor, *,
               seq_shards: Optional[int] = None) -> torch.Tensor:
    """Dense-family context-parallel prefill -> last-position logits
    [B,1,V] f32. ``seq_shards`` is the number of sequence shards, the
    env's model axis by default (1 on one card); it must divide the
    sequence."""
    if cfg.family != "dense" or cfg.rope == "mrope":
        raise ValueError(f"context-parallel prefill covers the dense family "
                         f"without M-RoPE, got {cfg.family!r} with rope "
                         f"{cfg.rope!r}")
    n = env.mesh_shape.get("model", 1) if seq_shards is None else seq_shards
    b, s = tokens.shape
    if n < 1 or s % n:
        raise ValueError(f"{n} sequence shards do not divide {s} tokens")
    s_loc = s // n
    x = embed_tokens(cfg, params, tokens, env)
    xs = list(torch.split(x, s_loc, dim=1)) if n > 1 else [x]
    offsets = [i * s_loc for i in range(n)]
    positions = [(o + torch.arange(s_loc, device=x.device))[None].expand(
        b, s_loc) for o in offsets]
    layer_specs = strip_layer_axis(_stacked_block_specs(cfg))
    for blk in unbind_layers(params["blocks"], cfg.num_layers):
        p = constrain_params(blk, layer_specs, env)
        qkv = [attn.qkv_project(cfg, p["attn"], apply_norm(cfg, p["norm1"],
                                                           xx), pos, env)
               for xx, pos in zip(xs, positions)]
        # the K/V gather across the shards (kv heads only)
        k_full = torch.cat([k for _, k, _ in qkv], dim=1) if n > 1 \
            else qkv[0][1]
        v_full = torch.cat([v for _, _, v in qkv], dim=1) if n > 1 \
            else qkv[0][2]
        for i, ((q, _, _), off) in enumerate(zip(qkv, offsets)):
            a = attn.blocked_attention(q, k_full, v_full, causal=True,
                                       window=cfg.sliding_window,
                                       q_offset=off)
            a = env.constrain(dot(a.reshape(b, s_loc, -1), p["attn"]["wo"]),
                              "batch", "seq", "embed")
            xx = xs[i] + a
            xs[i] = xx + apply_mlp(cfg, p["mlp"],
                                   apply_norm(cfg, p["norm2"], xx), env)
    return logits_fn(cfg, params, xs[-1][:, -1:, :], env)


__all__ = ["cp_prefill"]
