"""Attention: GQA with RoPE/M-RoPE and sliding windows, the prefill path
through the hand-written ``flash_attention`` kernel, and the decode path
over a KV cache.

The JAX package's ``repro.models.attention`` with its names and dtype
flow: the projections run in the dtype jnp's promotion gives
(``layers.dot``), an f32 bias is cast to the projection's dtype before the
add, and attention is computed in f32 and returned in q's dtype.

``blocked_attention`` is the JAX package's block-grid attention. That
package's ``mode`` and block sizes only schedule its block grid and leave
the function unchanged, and the kernel skips hidden tiles by itself, so
the port has neither: it computes the function through
``kernels.ops.attention``, the CUDA kernel on a CUDA tensor and
``flash_attention_ref`` on a CPU one. ``full_attention`` is that plain
version. ``q_offset`` places a query chunk at its absolute position in
the sequence, as context-parallel prefill (``models.context_parallel``)
passes it; both kernels take it, and so does the backward kernel, so the
call has a gradient at any offset, as the JAX package's does.

``decode_attention`` is plain PyTorch, as the JAX package computes it in
jnp outside any Pallas kernel, so it has no kernel to port. It keeps that
package's precision: bf16 operands with f32 products (the operands are
widened, which costs a copy of the layer's cache), the softmax weights
rounded to the cache's dtype before PV, and the f32 sum divided last.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import MeshEnv, ParamSpec
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import apply_mrope, apply_rope, dot

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def attn_specs(cfg: ModelConfig, prefix_layers: tuple = ()) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    lyr = tuple("layers" for _ in prefix_layers)
    dt = torch.bfloat16
    out = {
        "wq": ParamSpec((*prefix_layers, d, nq * hd), dt,
                        lyr + ("fsdp_row", "heads")),
        "wk": ParamSpec((*prefix_layers, d, nkv * hd), dt,
                        lyr + ("fsdp_row", "heads")),
        "wv": ParamSpec((*prefix_layers, d, nkv * hd), dt,
                        lyr + ("fsdp_row", "heads")),
        "wo": ParamSpec((*prefix_layers, nq * hd, d), dt,
                        lyr + ("heads", "fsdp_row")),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", nq * hd), ("bk", nkv * hd),
                            ("bv", nkv * hd)):
            out[name] = ParamSpec((*prefix_layers, width), torch.float32,
                                  lyr + ("heads",), init="zeros")
    return out


def _project(p: dict, name: str, x: torch.Tensor, heads: int, hd: int,
             bias: Optional[str] = None) -> torch.Tensor:
    y = dot(x, p[name])
    if bias is not None and bias in p:
        y = y + p[bias].to(y.dtype)
    b, s, _ = y.shape
    return y.reshape(b, s, heads, hd)


def _rope(cfg: ModelConfig, x: torch.Tensor, positions) -> torch.Tensor:
    if cfg.rope == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta)
    return x


def qkv_project(cfg: ModelConfig, p: dict, x: torch.Tensor, positions,
                env: MeshEnv):
    """Project + rope. x: [B,S,D] -> q [B,S,nq,hd], k/v [B,S,nkv,hd]."""
    hd = cfg.resolved_head_dim
    q = _rope(cfg, _project(p, "wq", x, cfg.n_heads, hd, "bq"), positions)
    k = _rope(cfg, _project(p, "wk", x, cfg.n_kv_heads, hd, "bk"), positions)
    v = _project(p, "wv", x, cfg.n_kv_heads, hd, "bv")
    q = env.constrain(q, "batch", None, "heads", None)
    k = env.constrain(k, "batch", None, "kv_heads", None)
    v = env.constrain(v, "batch", None, "kv_heads", None)
    return q, k, v


# ---------------------------------------------------------------------------
# prefill: flash_attention
# ---------------------------------------------------------------------------

def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_offset=0) -> torch.Tensor:
    """q: [B,Sq,Hq,hd], k/v: [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd] in q's dtype.

    ``q_offset`` (an int, or a 0-d integer tensor read once on the host;
    context-parallel prefill passes shard index * S_local) shifts the
    causal/window masks when q is a chunk of a longer sequence whose kv
    covers the full range."""
    if isinstance(q_offset, torch.Tensor):
        if q_offset.dim() or q_offset.is_floating_point():
            raise ValueError(f"q_offset must be an int or a 0-d integer "
                             f"tensor, got {q_offset!r}")
        q_offset = int(q_offset.item())
    return ops.attention(q, k, v, causal=causal, window=window,
                         q_offset=int(q_offset))


# reference unblocked attention (small shapes / oracles)
full_attention = ref.flash_attention_ref


# ---------------------------------------------------------------------------
# decode: the KV cache
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, cache_len: int,
                prefix_layers: tuple = ()) -> dict:
    hd = cfg.resolved_head_dim
    if cfg.sliding_window:
        cache_len = min(cache_len, cfg.sliding_window)
    lyr = tuple("layers" for _ in prefix_layers)
    shape = (*prefix_layers, batch, cache_len, cfg.n_kv_heads, hd)
    logical = lyr + ("batch", "kv_seq", None, None)
    return {
        "k": ParamSpec(shape, torch.bfloat16, logical, init="zeros"),
        "v": ParamSpec(shape, torch.bfloat16, logical, init="zeros"),
    }


def decode_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, env: MeshEnv):
    """One-token decode. x: [B,1,D]; cache k/v: [B,C,nkv,hd]; pos: [B]
    (or [3,B] for mrope). Returns (attn_out [B,1,D], new_cache); the
    cache passed in is left as it was."""
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    g = nq // nkv
    b = x.shape[0]
    cache_len = cache["k"].shape[1]

    if cfg.rope == "mrope":
        rope_pos, scalar_pos = pos[..., None], pos[0]     # [3,B,1], [B]
    else:
        rope_pos, scalar_pos = pos[:, None], pos          # [B,1], [B]

    q = _rope(cfg, _project(p, "wq", x, nq, hd, "bq"), rope_pos)
    k_new = _rope(cfg, _project(p, "wk", x, nkv, hd, "bk"), rope_pos)
    v_new = _project(p, "wv", x, nkv, hd, "bv")

    # ring-buffer slot under a sliding window, else the absolute position,
    # clamped: a position past the cache overwrites its last slot
    slot = scalar_pos % cache_len if cfg.sliding_window else torch.clamp(
        scalar_pos, max=cache_len - 1)
    rows = (torch.arange(b, device=x.device), slot.long())
    k_cache = cache["k"].index_put(rows, k_new[:, 0].to(cache["k"].dtype))
    v_cache = cache["v"].index_put(rows, v_new[:, 0].to(cache["v"].dtype))
    k_cache = env.constrain(k_cache, "batch", "kv_seq", None, None)
    v_cache = env.constrain(v_cache, "batch", "kv_seq", None, None)

    # the cache's dtype, f32 products: a product of two bf16 values is
    # exact in f32, so widening both operands gives what jnp's
    # preferred_element_type=float32 gives
    qf = q.to(k_cache.dtype).reshape(b, nkv, g, hd)
    s = torch.einsum("bkgd,bpkd->bkgp", qf.float(), k_cache.float())
    s = s / math.sqrt(hd)
    idx = torch.arange(cache_len, device=x.device)
    if cfg.sliding_window:
        valid = idx[None, :] < torch.clamp(scalar_pos + 1,
                                           max=cache_len)[:, None]
    else:
        valid = idx[None, :] <= scalar_pos[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgp,bpkd->bkgd", e.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out / e.sum(dim=-1)[..., None]
    out = out.reshape(b, 1, nq * hd).to(x.dtype)
    return dot(out, p["wo"]), {"k": k_cache, "v": v_cache}


def attention_block(cfg: ModelConfig, p: dict, x: torch.Tensor, positions,
                    env: MeshEnv, *, causal=True, window=None,
                    kv_override=None):
    """Full-sequence attention (prefill). Returns [B,S,D]."""
    x = env.constrain(x, "batch", None, "embed")
    q, k, v = qkv_project(cfg, p, x, positions, env)
    if kv_override is not None:          # cross attention (enc-dec)
        k, v = kv_override
        causal = False
    w = cfg.sliding_window if window is None else window
    out = blocked_attention(q, k, v, causal=causal, window=w)
    b, s = out.shape[:2]
    out = dot(out.reshape(b, s, -1), p["wo"])
    return env.constrain(out, "batch", "seq", "embed")


__all__ = ["NEG_INF", "attn_specs", "qkv_project", "blocked_attention",
           "full_attention", "cache_specs", "decode_attention",
           "attention_block"]
