"""State-space mixer: Mamba-2 SSD (state-space duality), chunked matmul form.

The JAX package's ``repro.models.ssm`` op for op, with its dtype flow: the
projections run in the dtype jnp's promotion gives (``layers.dot``), the
conv multiplies the (bf16) input by f32 weights and so returns f32, the
decode step rounds the stored f32 conv history to the input's dtype, and
``y`` is rounded back to the input's dtype before the out-projection.

On a CUDA tensor ``apply_ssm`` takes ``y`` from the hand-written
``ssd_scan`` kernel (``kernels.ops.ssd``), and under autograd its gradient
from the hand-written ``ssd_scan_bwd`` kernel; on a CPU tensor it runs
``ssd_chunked``, what the JAX ``apply_ssm`` runs, and autograd
differentiates it. ``decode_ssm`` is the one-step recurrence and launches
no kernel.

Layout (mamba2): in_proj -> [z, x, B, C, dt]; causal depthwise conv over
(x,B,C); SSD over heads H = d_inner/head_dim; gated RMSNorm; out_proj.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import MeshEnv, ParamSpec
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import chunk_len
from repro_torch.models.layers import dot


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, nheads, conv_dim


def ssm_specs(cfg: ModelConfig, prefix_layers: tuple = ()) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, conv_dim = _dims(cfg)
    lyr = tuple("layers" for _ in prefix_layers)
    pre = prefix_layers
    dt = torch.bfloat16
    f32 = torch.float32
    return {
        "in_proj": ParamSpec((*pre, d, 2 * d_inner + 2 * s.d_state + nheads),
                             dt, lyr + ("fsdp_row", "d_ff")),
        "conv_w": ParamSpec((*pre, s.d_conv, conv_dim), f32,
                            lyr + ("conv", "d_ff"), scale=0.5),
        "conv_b": ParamSpec((*pre, conv_dim), f32, lyr + ("d_ff",),
                            init="zeros"),
        "a_log": ParamSpec((*pre, nheads), f32, lyr + ("d_ff",),
                           init="ssm_a"),
        "d_skip": ParamSpec((*pre, nheads), f32, lyr + ("d_ff",),
                            init="ones"),
        "dt_bias": ParamSpec((*pre, nheads), f32, lyr + ("d_ff",),
                             init="zeros"),
        "norm_scale": ParamSpec((*pre, d_inner), f32, lyr + ("d_ff",),
                                init="ones"),
        "out_proj": ParamSpec((*pre, d_inner, d), dt,
                              lyr + ("d_ff", "fsdp_row")),
    }


def ssm_state_specs(cfg: ModelConfig, batch: int,
                    prefix_layers: tuple = ()) -> dict:
    s = cfg.ssm
    d_inner, nheads, conv_dim = _dims(cfg)
    lyr = tuple("layers" for _ in prefix_layers)
    return {
        "ssd": ParamSpec((*prefix_layers, batch, nheads, s.d_state,
                          s.head_dim), torch.float32,
                         lyr + ("batch", "d_ff", None, None), init="zeros"),
        "conv": ParamSpec((*prefix_layers, batch, s.d_conv - 1, conv_dim),
                          torch.float32, lyr + ("batch", None, "d_ff"),
                          init="zeros"),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, s.d_state, s.d_state,
                                nheads], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: torch.Tensor = None):
    """Depthwise causal conv. x: [B,S,C]; w: [K,C]. history: [B,K-1,C]."""
    k = w.shape[0]
    if history is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = history.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # [B, S+K-1, C]
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    out = out + b
    return F.silu(out), xp[:, -(k - 1):, :]


def ssd_chunked(x, dt, a, bb, cc, d_skip, chunk: int):
    """SSD scan. x: [B,S,H,P]; dt: [B,S,H] (post-softplus); a: [H]
    (negative); bb/cc: [B,S,N]. Returns (y [B,S,H,P] f32, final state
    [B,H,N,P]).
    """
    b, s, h, p = x.shape
    n = bb.shape[-1]
    q = chunk_len(s, chunk)
    nc = s // q
    xr = x.reshape(b, nc, q, h, p).float()
    dtr = dt.reshape(b, nc, q, h)
    br = bb.reshape(b, nc, q, n).float()
    cr = cc.reshape(b, nc, q, n).float()
    alog = dtr * a                                        # [B,nc,Q,H] (<= 0)
    lcum = torch.cumsum(alog, dim=2)                      # within-chunk cumsum

    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for ci in range(nc):
        xq, dtq, bq, cq, lq = (v[:, ci] for v in (xr, dtr, br, cr, lcum))
        # intra-chunk: y_i = sum_{j<=i} exp(L_i - L_j) (C_i.B_j) dt_j x_j;
        # the exponent is masked (not the result): the i<j entries are
        # large positives that would overflow exp()
        ldiff = lq[:, :, None, :] - lq[:, None, :, :]            # [B,Q,Q,H]
        decay = torch.exp(torch.where(tri[None, :, :, None], ldiff,
                                      torch.full_like(ldiff, -1e30)))
        g = torch.einsum("bin,bjn->bij", cq, bq)                 # [B,Q,Q]
        m = g[..., None] * decay * dtq[:, None, :, :]            # [B,Q,Q,H]
        y_intra = torch.einsum("bijh,bjhp->bihp", m, xq)
        # inter-chunk: y_i += exp(L_i) C_i . S_prev
        y_inter = torch.einsum("bin,bhnp->bihp", cq, state) * \
            torch.exp(lq)[..., None]
        # state: S = exp(L_Q) S_prev + sum_j exp(L_Q - L_j) dt_j B_j x_j
        l_last = lq[:, -1:, :]                                   # [B,1,H]
        w = torch.exp(l_last - lq) * dtq                         # [B,Q,H]
        s_new = torch.einsum("bjh,bjn,bjhp->bhnp", w, bq, xq)
        state = torch.exp(l_last[:, 0, :])[:, :, None, None] * state + s_new
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    y = y + x.float() * d_skip[None, None, :, None]
    return y, state


def _gated_norm(y, z, scale):
    y = y * F.silu(z.float())
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return y * torch.rsqrt(var + 1e-6) * scale


def apply_ssm(cfg: ModelConfig, p: dict, x: torch.Tensor, env: MeshEnv):
    """Full-sequence SSD mixer. x: [B,S,D] -> [B,S,D]."""
    s_cfg = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    x = env.constrain(x, "batch", None, "embed")
    zxbcdt = dot(x, p["in_proj"])
    z, xs, bb, cc, dt = _split_proj(cfg, zxbcdt)
    xbc, _ = _causal_conv(torch.cat([xs, bb, cc], dim=-1),
                          p["conv_w"], p["conv_b"])
    xs, bb, cc = torch.split(xbc, [d_inner, s_cfg.d_state, s_cfg.d_state],
                             dim=-1)
    bsz, seq = x.shape[:2]
    xh = xs.reshape(bsz, seq, nheads, s_cfg.head_dim)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    if x.device.type == "cuda":
        y = ops.ssd(xh, dt, a, bb, cc, p["d_skip"], chunk=s_cfg.chunk)
    else:
        y, _ = ssd_chunked(xh, dt, a, bb, cc, p["d_skip"], s_cfg.chunk)
    y = _gated_norm(y.reshape(bsz, seq, d_inner), z, p["norm_scale"])
    out = dot(y.to(x.dtype), p["out_proj"])
    return env.constrain(out, "batch", "seq", "embed")


def decode_ssm(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict,
               env: MeshEnv):
    """Single-token recurrent step. x: [B,1,D]; state: {ssd, conv}."""
    s_cfg = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    zxbcdt = dot(x, p["in_proj"])
    z, xs, bb, cc, dt = _split_proj(cfg, zxbcdt)
    xbc_in = torch.cat([xs, bb, cc], dim=-1)              # [B,1,conv_dim]
    xbc, conv_hist = _causal_conv(xbc_in, p["conv_w"], p["conv_b"],
                                  history=state["conv"])
    xs, bb, cc = torch.split(xbc, [d_inner, s_cfg.d_state, s_cfg.d_state],
                             dim=-1)
    bsz = x.shape[0]
    xh = xs.reshape(bsz, nheads, s_cfg.head_dim).float()
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])      # [B,H]
    a = torch.exp(dt * (-torch.exp(p["a_log"])))          # [B,H]
    bb1, cc1 = bb[:, 0].float(), cc[:, 0].float()
    # S = a S + dt (B outer x); y = C . S + D x
    s_new = a[:, :, None, None] * state["ssd"] + \
        dt[:, :, None, None] * torch.einsum("bn,bhp->bhnp", bb1, xh)
    y = torch.einsum("bn,bhnp->bhp", cc1, s_new) + \
        xh * p["d_skip"][None, :, None]
    y = _gated_norm(y.reshape(bsz, 1, d_inner), z, p["norm_scale"])
    out = dot(y.to(x.dtype), p["out_proj"])
    return out, {"ssd": s_new, "conv": conv_hist.to(state["conv"].dtype)}


__all__ = ["ssm_specs", "ssm_state_specs", "ssd_chunked", "apply_ssm",
           "decode_ssm"]
