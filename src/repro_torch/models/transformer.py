"""Decoder-only LM: the SSM family (Mamba-2), the dense family (GQA
attention with RoPE, M-RoPE or a learned position table), the MoE family
(attention with a mixture-of-experts FFN, ``models.moe``) and the hybrid
family (Jamba: Mamba-2 and attention layers in a period, MoE on every
other layer).

The JAX package's ``repro.models.transformer`` with its per-layer
``jax.lax.scan`` over the stacked ``blocks`` written as a Python loop over
the layer index: layer ``i`` takes ``[i]`` of every stacked tensor, so the
parameter tree keeps the stacked layout and JAX weights carry across leaf
for leaf. The hybrid family keeps that package's per-layer ``layers`` tree
keyed ``str(i)`` and its unrolled loop, with a per-layer decode cache (a KV
cache or an SSM state). Prefill runs each attention layer through the
``flash_attention`` kernel on the card (``models.attention``) and each
Mamba-2 layer through ``ssd_scan`` (``models.ssm``); decode keeps a KV
cache. An MoE block runs ``moe.apply_moe``, and ``forward`` sums its
``lb_loss`` and ``z_loss`` over the layers.

``loss_fn`` is the JAX package's masked next-token cross-entropy over f32
logits plus the MoE losses; with grad enabled each layer of a stacked
family is rematerialized as ``run.remat`` says, as that package's
``jax.checkpoint`` around its scan body: ``"full"`` recomputes the whole
layer in the backward, ``"block"`` keeps the projections' outputs
(``aten.mm``, the ``dots_with_no_batch_dims_saveable`` of the JAX policy)
and recomputes the rest. Remat changes memory, never values.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import (MeshEnv, ParamSpec, is_spec,
                                              spec_map, tree_leaves,
                                              tree_map)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, dot, mlp_specs,
                                       norm_specs)


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
    if cfg.family == "hybrid":
        kinds = cfg.layer_kinds()
        specs["layers"] = {str(i): _block_specs(cfg, kinds[i],
                                                cfg.layer_is_moe(i))
                           for i in range(cfg.num_layers)}
    else:
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


def unbind_layers(tree, n: int) -> list:
    """The ``n`` per-layer views of a stacked tree. One ``unbind`` a leaf,
    so autograd stacks the layers' gradients once, not a full-size
    zero-padded gradient per layer as ``t[i]`` would."""
    per_leaf = tree_map(torch.unbind, tree)
    return [tree_map(lambda ts: ts[i], per_leaf,
                     is_leaf=lambda x: isinstance(x, tuple)) for i in range(n)]


# ---------------------------------------------------------------------------
# rematerialization
# ---------------------------------------------------------------------------

REMAT_MODES = ("none", "full", "block")
_SAVED_BY_BLOCK = (torch.ops.aten.mm.default,)


def _block_policy(ctx, op, *args, **kwargs):
    return torch_checkpoint.CheckpointPolicy.MUST_SAVE \
        if op in _SAVED_BY_BLOCK \
        else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(remat: str, fn, *args):
    """``fn(*args)``, checkpointed as ``remat`` says when autograd records
    a gradient through it (``torch.utils.checkpoint``, non-reentrant: a
    recomputed kernel keeps what its own backward needs)."""
    if remat not in REMAT_MODES:
        raise ValueError(f"remat {remat!r} is not one of {REMAT_MODES}")
    if remat == "none" or not torch.is_grad_enabled() or not any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in tree_leaves(args)):
        return fn(*args)
    kw = {}
    if remat == "block":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _block_policy)
    return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)


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
                positions=None, cache=None, pos=None, remat: str = "none"):
    """The JAX ``lax.scan`` over the stacked blocks, or its unrolled loop
    over the hybrid family's ``layers``. Returns (x, the per-layer caches
    (stacked, or keyed ``str(i)`` for the hybrid family) or None, the
    layers' ``lb_loss`` and ``z_loss`` summed). ``remat`` applies to the
    stacked families' full-sequence layers, as the JAX package's
    ``jax.checkpoint`` wraps only its scan body."""
    hybrid = cfg.family == "hybrid"
    if not hybrid:
        layer_specs = strip_layer_axis(_stacked_block_specs(cfg))
        blocks = unbind_layers(params["blocks"], cfg.num_layers)
    kinds = cfg.layer_kinds()
    caches, aux_sum = [], _moe_aux_zero(x.device)
    for i in range(cfg.num_layers):
        if hybrid:
            p_layer = params["layers"][str(i)]
            c_layer = None if cache is None else cache[str(i)]
        else:
            p_layer = constrain_params(blocks[i], layer_specs, env)
            c_layer = None if cache is None else _layer(cache, i)
        block = functools.partial(
            _apply_block, cfg, env, positions=positions, kind=kinds[i],
            is_moe=cfg.layer_is_moe(i), mode=mode, cache=c_layer, pos=pos)
        x, nc, aux = remat_call("none" if hybrid else remat, block, p_layer,
                                x)
        caches.append(nc)
        for k in aux_sum:
            if k in aux:
                aux_sum[k] = aux_sum[k] + aux[k]
    if cache is None:
        return x, None, aux_sum
    if hybrid:
        return x, {str(i): c for i, c in enumerate(caches)}, aux_sum
    return x, tree_map(lambda *ts: torch.stack(ts), caches[0],
                       *caches[1:]), aux_sum


def _hidden(cfg: ModelConfig, env: MeshEnv, params, tokens, *, embeds=None,
            positions=None, remat: str = "none"):
    """The last layer's output [B,S,D] of a full-sequence pass and the MoE
    losses summed over the layers, from the tokens or (the vision stub)
    precomputed ``embeds`` [B,S,D]; positions default to 0..S-1 in every
    row. ``remat`` as in ``loss_fn``."""
    if embeds is not None:
        x = env.constrain(embeds, "batch", "seq", "embed")
        bsz, seq = embeds.shape[:2]
    else:
        x = embed_tokens(cfg, params, tokens, env)
        bsz, seq = tokens.shape
    if positions is None:
        positions = torch.arange(seq, device=x.device)[None].expand(bsz, seq)
    x, _, aux = _layer_loop(cfg, env, params, x, mode="full",
                            positions=positions, remat=remat)
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


def next_token_loss(logits: torch.Tensor, targets: torch.Tensor):
    """(mean NLL over the unmasked targets, their count) from f32 logits
    [B,S,V]; a target of -1 is padding."""
    mask = (targets >= 0).to(torch.float32)
    tsafe = torch.clamp(targets, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tsafe[..., None])[..., 0]
    tokens = torch.sum(mask)
    return torch.sum((lse - tgt) * mask) / torch.clamp(tokens, min=1.0), \
        tokens


def loss_fn(cfg: ModelConfig, run: RunConfig, env: MeshEnv, params, batch):
    """Next-token CE loss. batch: ``tokens`` (or the vision stub's
    ``embeds`` and ``positions``) and ``targets`` [B,S] (-1 = pad).
    Returns (loss + 0.01 lb_loss + 0.001 z_loss, metrics ``loss``,
    ``lb_loss``, ``z_loss``, ``tokens``)."""
    x, aux = _hidden(cfg, env, params, batch.get("tokens"),
                     embeds=batch.get("embeds"),
                     positions=batch.get("positions"), remat=run.remat)
    logits = logits_fn(cfg, params, x, env)
    loss, tokens = next_token_loss(logits, batch["targets"])
    total = loss + 0.01 * aux["lb_loss"] + 0.001 * aux["z_loss"]
    return total, {"loss": loss, "lb_loss": aux["lb_loss"],
                   "z_loss": aux["z_loss"], "tokens": tokens}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """Decode-state specs: stacked over the layers, or per layer (keyed
    ``str(i)``: a KV cache or an SSM state) for the hybrid family."""
    kinds = cfg.layer_kinds()
    if cfg.family == "hybrid":
        return {str(i): attn.cache_specs(cfg, batch, cache_len)
                if kind == "attn" else ssm_mod.ssm_state_specs(cfg, batch)
                for i, kind in enumerate(kinds)}
    if kinds[0] == "attn":
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
           "unbind_layers", "REMAT_MODES", "remat_call", "embed_tokens",
           "logits_fn", "forward", "next_token_loss", "loss_fn",
           "cache_specs", "decode_step", "prefill"]
