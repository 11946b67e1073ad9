"""Decoder-only LM: the SSM family (Mamba-2), the dense family (GQA
attention with RoPE, M-RoPE or a learned position table) and the MoE
family (attention with a mixture-of-experts FFN, ``models.moe``).

The JAX package's ``repro.models.transformer`` with its per-layer
``jax.lax.scan`` over the stacked ``blocks`` written as a Python loop over
the layer index: layer ``i`` takes ``[i]`` of every stacked tensor, so the
parameter tree keeps the stacked layout and JAX weights carry across leaf
for leaf. Prefill runs each attention layer through the ``flash_attention``
kernel on the card (``models.attention``); decode keeps a stacked KV cache.
An MoE block (every layer of the ``moe`` family, or of a dense stack whose
``moe`` config makes its FFN one) runs ``moe.apply_moe``, and ``forward``
sums its ``lb_loss`` and ``z_loss`` over the layers. The ``hybrid`` family
raises ``NotImplementedError`` until its slice (``ROADMAP.md`` §1), and
``loss_fn`` comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import (MeshEnv, ParamSpec, is_spec,
                                              spec_map, tree_map)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, dot, mlp_specs,
                                       norm_specs)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: the port's model path carries the SSM, "
        f"dense and MoE families; see ROADMAP.md §1 for the slice that adds "
        f"it")


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _block_specs(cfg: ModelConfig, kind: str, is_moe: bool,
                 prefix_layers: tuple = ()) -> dict:
    out = {"norm1": norm_specs(cfg, prefix_layers),
           "norm2": norm_specs(cfg, prefix_layers)}
    if kind == "attn":
        out["attn"] = attn.attn_specs(cfg, prefix_layers)
    else:
        out["ssm"] = ssm_mod.ssm_specs(cfg, prefix_layers)
    if is_moe:
        out["moe"] = moe_mod.moe_specs(cfg, prefix_layers)
    else:
        out["mlp"] = mlp_specs(cfg, prefix_layers=prefix_layers)
    return out


def _stacked_block_specs(cfg: ModelConfig) -> dict:
    if cfg.family == "hybrid":
        raise _not_ported("the hybrid family")
    return _block_specs(cfg, cfg.layer_kinds()[0], cfg.layer_is_moe(0),
                        prefix_layers=(cfg.num_layers,))


def param_specs(cfg: ModelConfig) -> dict:
    specs = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), torch.bfloat16,
                           ("vocab", "embed"), scale=1.0),
        "final_norm": norm_specs(cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), torch.bfloat16,
                                     ("embed", "vocab"))
    if cfg.rope == "none" and cfg.family in ("dense",):
        specs["pos_embed"] = ParamSpec((8192, cfg.d_model), torch.bfloat16,
                                       ("pos", "embed"), scale=0.02)
    specs["blocks"] = _stacked_block_specs(cfg)
    return specs


def strip_layer_axis(specs: dict) -> dict:
    """Per-layer view of stacked block specs."""
    return spec_map(lambda s: ParamSpec(s.shape[1:], s.dtype, s.logical[1:],
                                        s.init, s.scale), specs)


def constrain_params(tree, specs, env: MeshEnv):
    """Per-layer compute view of stored params (a no-op on one device)."""
    return tree_map(lambda s, x: env.constrain_compute(x, *s.logical),
                    specs, tree, is_leaf=is_spec)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree."""
    return tree_map(lambda t: t[i], tree)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _apply_block(cfg: ModelConfig, env: MeshEnv, p: dict, x, positions, *,
                 kind: str, is_moe: bool, mode: str, cache=None, pos=None):
    """One decoder block. Returns (x, new_cache, aux): aux is the MoE
    block's losses (and ``dropped_frac``), empty for a dense FFN."""
    aux = {}
    h = apply_norm(cfg, p["norm1"], x)
    new_cache = cache
    if kind == "attn":
        if mode == "decode":
            a, new_cache = attn.decode_attention(cfg, p["attn"], h, cache,
                                                 pos, env)
        else:
            a = attn.attention_block(cfg, p["attn"], h, positions, env)
    elif mode == "decode":
        a, new_cache = ssm_mod.decode_ssm(cfg, p["ssm"], h, cache, env)
    else:
        a = ssm_mod.apply_ssm(cfg, p["ssm"], h, env)
    x = x + a
    h = apply_norm(cfg, p["norm2"], x)
    if is_moe:
        f, aux = moe_mod.apply_moe(cfg, p["moe"], h, env)
    else:
        f = apply_mlp(cfg, p["mlp"], h, env)
    return x + f, new_cache, aux


def _moe_aux_zero(device) -> dict:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in ("lb_loss", "z_loss")}


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params, tokens, env: MeshEnv):
    x = params["embed"][tokens]
    if "pos_embed" in params:
        s = tokens.shape[1]
        x = x + params["pos_embed"][:s][None]
    return env.constrain(x, "batch", "seq", "embed")


def logits_fn(cfg: ModelConfig, params, x, env: MeshEnv):
    """Logits in the parameters' dtype, then f32 (as the JAX package)."""
    x = apply_norm(cfg, params["final_norm"], x)
    x = env.constrain(x, "batch", None, "embed")
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = dot(x, head).float()
    return env.constrain(logits, "batch", None, "vocab")


def _layer_loop(cfg: ModelConfig, env: MeshEnv, params, x, *, mode: str,
                positions=None, cache=None, pos=None):
    """The JAX ``lax.scan`` over the stacked blocks, as a loop. Returns
    (x, the per-layer caches stacked or None, the layers' ``lb_loss`` and
    ``z_loss`` summed)."""
    layer_specs = strip_layer_axis(_stacked_block_specs(cfg))
    kind, is_moe = cfg.layer_kinds()[0], cfg.layer_is_moe(0)
    caches, aux_sum = [], _moe_aux_zero(x.device)
    for i in range(cfg.num_layers):
        p_layer = constrain_params(_layer(params["blocks"], i), layer_specs,
                                   env)
        x, nc, aux = _apply_block(cfg, env, p_layer, x, positions, kind=kind,
                                  is_moe=is_moe, mode=mode,
                                  cache=None if cache is None
                                  else _layer(cache, i), pos=pos)
        caches.append(nc)
        for k in aux_sum:
            if k in aux:
                aux_sum[k] = aux_sum[k] + aux[k]
    if cache is None:
        return x, None, aux_sum
    return x, tree_map(lambda *ts: torch.stack(ts), caches[0],
                       *caches[1:]), aux_sum


def _hidden(cfg: ModelConfig, env: MeshEnv, params, tokens, *, embeds=None,
            positions=None):
    """The last layer's output [B,S,D] of a full-sequence pass and the MoE
    losses summed over the layers, from the tokens or (the vision stub)
    precomputed ``embeds`` [B,S,D]; positions default to 0..S-1 in every
    row."""
    if embeds is not None:
        x = env.constrain(embeds, "batch", "seq", "embed")
        bsz, seq = embeds.shape[:2]
    else:
        x = embed_tokens(cfg, params, tokens, env)
        bsz, seq = tokens.shape
    if positions is None:
        positions = torch.arange(seq, device=x.device)[None].expand(bsz, seq)
    x, _, aux = _layer_loop(cfg, env, params, x, mode="full",
                            positions=positions)
    return x, aux


def forward(cfg: ModelConfig, run: RunConfig, env: MeshEnv, params, tokens,
            **kw):
    """Full-sequence forward -> (logits [B,S,V] f32, aux): aux holds
    ``lb_loss`` and ``z_loss`` summed over the layers (zeros without MoE
    blocks). ``kw``: ``embeds`` and ``positions``, as in the JAX
    package; its ``moe_mode`` is always ``"gather"`` on the model path, so
    the port takes none (``moe.apply_moe(..., mode="dense")`` is the
    tests' reference)."""
    x, aux = _hidden(cfg, env, params, tokens, **kw)
    return logits_fn(cfg, params, x, env), aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """Decode-state specs, stacked over the layers."""
    if cfg.family == "hybrid":
        raise _not_ported("the hybrid family")
    if cfg.layer_kinds()[0] == "attn":
        return attn.cache_specs(cfg, batch, cache_len, (cfg.num_layers,))
    return ssm_mod.ssm_state_specs(cfg, batch, (cfg.num_layers,))


def decode_step(cfg: ModelConfig, run: RunConfig, env: MeshEnv, params,
                cache, tokens, pos):
    """One decode step. tokens: [B,1]; pos: [B] ([3,B] for mrope; unused
    by the SSM mixer).

    Returns (logits [B,1,V], new_cache).
    """
    x = embed_tokens(cfg, params, tokens, env)
    x = env.constrain(x, "batch", None, "embed")
    x, new_cache, _ = _layer_loop(cfg, env, params, x, mode="decode",
                                  cache=cache, pos=pos)
    return logits_fn(cfg, params, x, env), new_cache


def prefill(cfg: ModelConfig, run: RunConfig, env: MeshEnv, params, tokens,
            **kw):
    """Prefill forward: last-position logits only (serving). The norm and
    the head are row-wise, so only the last position goes through them,
    not the [B,S,V] logits the JAX package computes and then slices; the
    MoE losses are dropped. ``kw`` as in ``forward``."""
    x, _ = _hidden(cfg, env, params, tokens, **kw)
    return logits_fn(cfg, params, x[:, -1:, :], env)


__all__ = ["param_specs", "strip_layer_axis", "constrain_params",
           "embed_tokens", "logits_fn", "forward", "cache_specs",
           "decode_step", "prefill"]
