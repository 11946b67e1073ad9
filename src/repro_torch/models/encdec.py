"""Encoder-decoder (Whisper-small): a bidirectional encoder over precomputed
frame embeddings (the conv frontend is a stub) and a causal decoder with
cross-attention. Sinusoidal encoder positions, learned decoder positions,
LayerNorm, GELU and a plain FFN, as the released model.

The JAX package's ``repro.models.encdec`` with its per-layer
``jax.lax.scan`` over the stacked ``encoder`` and ``decoder`` trees written
as a loop over the layer index, so JAX weights carry across leaf for leaf.
Prefill runs the encoder's bidirectional attention, the decoder's causal
self-attention and its cross-attention (queries over the decoder's
positions, keys and values projected from the encoder's output) through
the ``flash_attention`` kernel on the card (``models.attention``). Decode
keeps a stacked self-attention KV cache and the encoder's K/V of each
layer (``cross_k``, ``cross_v``); its cross-attention is plain PyTorch, as
the JAX package computes it in jnp outside any Pallas kernel.
``loss_fn`` is that package's masked next-token cross-entropy; with grad
enabled each encoder and decoder layer is recomputed in the backward
unless ``run.remat`` is ``"none"`` (the JAX ``_scan_blocks`` checkpoints
its scan body with the default policy, which saves nothing, for
``"block"`` as for ``"full"``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import (MeshEnv, ParamSpec,
                                              tree_leaves, tree_map)
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_mlp, apply_norm, dot, mlp_specs,
                                       norm_specs, sinusoid_positions)
from repro_torch.models.transformer import (constrain_params, next_token_loss,
                                           remat_call, strip_layer_axis,
                                           unbind_layers)

MAX_DEC_POS = 1 << 16  # structural cap covering decode_32k (real model: 448)


def _enc_block_specs(cfg: ModelConfig, n: int) -> dict:
    return {
        "norm1": norm_specs(cfg, (n,)),
        "attn": attn.attn_specs(cfg, (n,)),
        "norm2": norm_specs(cfg, (n,)),
        "mlp": mlp_specs(cfg, prefix_layers=(n,)),
    }


def _dec_block_specs(cfg: ModelConfig, n: int) -> dict:
    return {
        "norm1": norm_specs(cfg, (n,)),
        "self_attn": attn.attn_specs(cfg, (n,)),
        "norm_x": norm_specs(cfg, (n,)),
        "cross_attn": attn.attn_specs(cfg, (n,)),
        "norm2": norm_specs(cfg, (n,)),
        "mlp": mlp_specs(cfg, prefix_layers=(n,)),
    }


def param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "embed": ParamSpec((cfg.vocab, d), torch.bfloat16, ("vocab", "embed")),
        "dec_pos": ParamSpec((MAX_DEC_POS, d), torch.bfloat16,
                             ("pos", "embed"), scale=0.02),
        "encoder": _enc_block_specs(cfg, cfg.encoder_layers),
        "enc_norm": norm_specs(cfg),
        "decoder": _dec_block_specs(cfg, cfg.num_layers),
        "final_norm": norm_specs(cfg),
    }


def _layers(cfg: ModelConfig, env: MeshEnv, specs_fn, params):
    """Each layer's parameters of a stacked tree, in order (the JAX
    package's scan over it)."""
    layer_specs = strip_layer_axis(specs_fn(cfg, 1))
    n = tree_leaves(params)[0].shape[0]
    for i, p in enumerate(unbind_layers(params, n)):
        yield i, constrain_params(p, layer_specs, env)


def _remat(run: RunConfig) -> str:
    return "none" if run.remat == "none" else "full"


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def encode(cfg: ModelConfig, run: RunConfig, env: MeshEnv, params, frames):
    """frames: [B, T_enc, D] (precomputed conv-stub embeddings)."""
    b, t, d = frames.shape
    x = frames + sinusoid_positions(t, d, frames.device)[None].to(
        frames.dtype)
    x = env.constrain(x, "batch", "seq", "embed")
    positions = _positions(b, t, frames.device)

    def blk(p, xx):
        h = apply_norm(cfg, p["norm1"], xx)
        xx = xx + attn.attention_block(cfg, p["attn"], h, positions, env,
                                       causal=False)
        h = apply_norm(cfg, p["norm2"], xx)
        return xx + apply_mlp(cfg, p["mlp"], h, env)

    for _, p in _layers(cfg, env, _enc_block_specs, params["encoder"]):
        x = remat_call(_remat(run), blk, p, x)
    return apply_norm(cfg, params["enc_norm"], x)


def _decoder_hidden(cfg: ModelConfig, env: MeshEnv, params, tokens,
                    enc_out, remat: str = "none"):
    """The decoder's last layer output [B,S,D] over the encoder's output;
    ``remat`` as ``remat_call`` takes it."""
    b, s = tokens.shape
    x = params["embed"][tokens] + params["dec_pos"][:s][None]
    x = env.constrain(x, "batch", "seq", "embed")
    positions = _positions(b, s, x.device)
    enc_positions = _positions(b, enc_out.shape[1], x.device)

    def blk(p, xx, enc):
        h = apply_norm(cfg, p["norm1"], xx)
        xx = xx + attn.attention_block(cfg, p["self_attn"], h, positions,
                                       env, causal=True)
        h = apply_norm(cfg, p["norm_x"], xx)
        _, kk, kv = attn.qkv_project(cfg, p["cross_attn"], enc,
                                     enc_positions, env)
        xx = xx + attn.attention_block(cfg, p["cross_attn"], h, positions,
                                       env, kv_override=(kk, kv))
        h = apply_norm(cfg, p["norm2"], xx)
        return xx + apply_mlp(cfg, p["mlp"], h, env)

    for _, p in _layers(cfg, env, _dec_block_specs, params["decoder"]):
        x = remat_call(remat, blk, p, x, enc_out)
    return x


def _logits(cfg: ModelConfig, env: MeshEnv, params, x):
    """Logits against the tied embedding, in the parameters' dtype, then
    f32."""
    x = apply_norm(cfg, params["final_norm"], x)
    x = env.constrain(x, "batch", None, "embed")
    logits = dot(x, params["embed"].T).float()
    return env.constrain(logits, "batch", None, "vocab")


def prefill(cfg: ModelConfig, run: RunConfig, env: MeshEnv, params, batch):
    """batch: ``frames`` [B, T_enc, D] and ``tokens`` [B, S] -> the last
    position's logits [B, 1, V]. The norm and the head are row-wise, so
    only the last position goes through them."""
    enc_out = encode(cfg, run, env, params, batch["frames"])
    x = _decoder_hidden(cfg, env, params, batch["tokens"], enc_out)
    return _logits(cfg, env, params, x[:, -1:, :])


def loss_fn(cfg: ModelConfig, run: RunConfig, env: MeshEnv, params, batch):
    """batch: ``frames`` [B,T,D], ``tokens`` [B,S], ``targets`` [B,S] (-1 =
    pad). Returns (loss, metrics ``loss``, ``tokens``)."""
    enc_out = encode(cfg, run, env, params, batch["frames"])
    x = _decoder_hidden(cfg, env, params, batch["tokens"], enc_out,
                        _remat(run))
    loss, tokens = next_token_loss(_logits(cfg, env, params, x),
                                   batch["targets"])
    return loss, {"loss": loss, "tokens": tokens}


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    """Self-attention KV per decoder layer (stacked) and the encoder's K/V
    of each layer."""
    hd = cfg.resolved_head_dim
    n = cfg.num_layers
    cross = ParamSpec((n, batch, cfg.encoder_seq, cfg.n_kv_heads, hd),
                      torch.bfloat16,
                      ("layers", "batch", "kv_seq", None, None), init="zeros")
    return {"self": attn.cache_specs(cfg, batch, cache_len, (n,)),
            "cross_k": cross, "cross_v": cross}


def _cross_decode(cfg: ModelConfig, p: dict, h, ck, cv):
    """One token's cross-attention over the encoder's K/V [B,T,nkv,hd]:
    f32 scores and softmax, as the JAX package's einsums."""
    b = h.shape[0]
    nq, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = attn._project(p, "wq", h, nq, hd, "bq")
    qf = q.float().reshape(b, nkv, nq // nkv, hd)
    s = torch.einsum("bkgd,bpkd->bkgp", qf, ck.float()) / math.sqrt(hd)
    o = torch.einsum("bkgp,bpkd->bkgd", torch.softmax(s, dim=-1), cv.float())
    return dot(o.reshape(b, 1, nq * hd).to(h.dtype), p["wo"])


def decode_step(cfg: ModelConfig, run: RunConfig, env: MeshEnv, params,
                cache, tokens, pos):
    """One decoder token. tokens: [B,1]; pos: [B]; cache: ``self`` (stacked
    KV) and ``cross_k``/``cross_v`` [L,B,T,nkv,hd].

    Returns (logits [B,1,V], new_cache); the cross K/V pass through."""
    dec_pos = params["dec_pos"][torch.clamp(pos, max=MAX_DEC_POS - 1).long()]
    x = params["embed"][tokens] + dec_pos[:, None]
    x = env.constrain(x, "batch", None, "embed")
    self_caches = []
    for i, p in _layers(cfg, env, _dec_block_specs, params["decoder"]):
        h = apply_norm(cfg, p["norm1"], x)
        a, nc = attn.decode_attention(
            cfg, p["self_attn"], h,
            tree_map(lambda t: t[i], cache["self"]), pos, env)
        x = x + a
        self_caches.append(nc)
        h = apply_norm(cfg, p["norm_x"], x)
        x = x + _cross_decode(cfg, p["cross_attn"], h, cache["cross_k"][i],
                              cache["cross_v"][i])
        h = apply_norm(cfg, p["norm2"], x)
        x = x + apply_mlp(cfg, p["mlp"], h, env)
    new_self = tree_map(lambda *ts: torch.stack(ts), self_caches[0],
                        *self_caches[1:])
    return _logits(cfg, env, params, x), dict(cache, self=new_self)


__all__ = ["MAX_DEC_POS", "param_specs", "encode", "prefill", "loss_fn",
           "cache_specs", "decode_step"]
