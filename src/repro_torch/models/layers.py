"""Shared layer primitives: norms, FFN, rotary embeddings (RoPE / M-RoPE).

Op for op as in the JAX package's ``repro.models.layers``. Two differences
of the frameworks are handled here: ``jax.nn.gelu`` defaults to the tanh
approximation, and jnp promotes the operands of a product (bf16 x f32 ->
f32) where torch refuses mixed dtypes, so ``dot`` casts first.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import MeshEnv, ParamSpec


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over x's last axis in the dtype jnp's promotion gives."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def norm_specs(cfg: ModelConfig, prefix_layers: tuple = ()) -> dict:
    d = cfg.d_model
    lyr = tuple("layers" for _ in prefix_layers)
    spec = {"scale": ParamSpec((*prefix_layers, d), torch.float32,
                               lyr + ("embed",), init="ones")}
    if cfg.norm == "layernorm":
        spec["bias"] = ParamSpec((*prefix_layers, d), torch.float32,
                                 lyr + ("embed",), init="zeros")
    return spec


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        y = x * torch.rsqrt(var + 1e-6) * p["scale"]
    else:
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    return y.to(dtype)


def activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# FFN (dense MLP; MoE waits for its slice)
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None,
              prefix_layers: tuple = ()) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    lyr = tuple("layers" for _ in prefix_layers)
    dt = torch.bfloat16
    out = {"wi": ParamSpec((*prefix_layers, d, f), dt,
                           lyr + ("fsdp_row", "d_ff"))}
    if cfg.glu:
        out["wg"] = ParamSpec((*prefix_layers, d, f), dt,
                              lyr + ("fsdp_row", "d_ff"))
    out["wo"] = ParamSpec((*prefix_layers, f, d), dt,
                          lyr + ("d_ff", "fsdp_row"))
    return out


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor,
              env: MeshEnv) -> torch.Tensor:
    x = env.constrain(x, "batch", None, "embed")
    h = dot(x, p["wi"])
    h = env.constrain(h, "batch", None, "d_ff")
    if cfg.glu:
        g = dot(x, p["wg"])
        h = activation(cfg, g) * h
    else:
        h = activation(cfg, h)
    out = dot(h, p["wo"])
    return env.constrain(out, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] int. Half-rotation convention."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # [hd/2]
    angles = positions[..., None].float() * freqs            # [B, S, hd/2]
    return _rotate(x, angles)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    positions: [3, B, S] (temporal, height, width) ids. ``sections`` gives
    the per-axis share of the hd/2 frequency slots (t/h/w), matching the
    released mrope_section for head_dim 128.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    angles = positions[..., None].float() * freqs            # [3, B, S, hd/2]
    scale = hd // 2 / sum(sections)
    idx = torch.arange(hd // 2, device=x.device)
    # slot i belongs to axis a if it falls in that axis' scaled section
    bounds = torch.tensor([int(round(sum(sections[: i + 1]) * scale))
                           for i in range(3)], device=x.device)
    axis_of = torch.searchsorted(bounds, idx, right=True)    # [hd/2] in 0..2
    angles = torch.gather(angles, 0,
                          axis_of.expand(1, *angles.shape[1:]))[0]
    return _rotate(x, angles)


def sinusoid_positions(seq: int, d: int,
                       device: torch.device = None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


__all__ = ["dot", "norm_specs", "apply_norm", "activation", "mlp_specs",
           "apply_mlp", "rope_freqs", "apply_rope", "apply_mrope",
           "sinusoid_positions"]
