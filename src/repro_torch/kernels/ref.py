"""Plain PyTorch versions of the kernels: their semantics, the CPU path, and
what ``chip_smoke.py`` holds each CUDA kernel against on the card.

They mirror ``repro/kernels/ref.py`` (``matmul_ref``,
``flash_attention_ref``, ``ssd_ref``, ``layout_pack_ref``,
``layout_unpack_ref``) op for op.
"""
from __future__ import annotations

import math

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with f32 accumulation, in A's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """q: [B,Sq,Hq,hd]; k/v: [B,Sk,Hkv,hd] (fewer kv heads -> GQA repeat).
    Query row i is at position i + ``q_offset`` in the causal and window
    masks. Returns [B,Sq,Hq,hd] in q's dtype."""
    sq, hq, hd = q.shape[1], q.shape[2], q.shape[3]
    sk, hkv = k.shape[1], k.shape[2]
    if hq != hkv:
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
        v = torch.repeat_interleave(v, hq // hkv, dim=2)
    s = torch.einsum("bqhd,bphd->bhqp", q.float(), k.float()) / math.sqrt(hd)
    qp = torch.arange(sq, device=q.device)[:, None] + q_offset
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    s = torch.where(mask[None, None], s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqp,bphd->bqhd", p, v.float())
    return out.to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor, c: torch.Tensor,
            d_skip: torch.Tensor) -> torch.Tensor:
    """Sequential SSD recurrence (the ground truth the chunked forms must
    match). x: [B,S,H,P]; dt: [B,S,H]; a: [H] (negative); b/c: [B,S,N];
    d_skip: [H]. Returns y: [B,S,H,P] float32.

        S_t = exp(dt_t a) S_{t-1} + dt_t (b_t (x) x_t)
        y_t = c_t . S_t + d x_t
    """
    bs, s, h, p = x.shape
    n = b.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    state = torch.zeros((bs, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        xt, dtt, bt, ct = xf[:, t], dtf[:, t], bf[:, t], cf[:, t]
        decay = torch.exp(dtt * a)[:, :, None, None]            # [B,H,1,1]
        upd = dtt[:, :, None, None] * torch.einsum("bn,bhp->bhnp", bt, xt)
        state = decay * state + upd
        ys.append(torch.einsum("bn,bhnp->bhp", ct, state))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(x.shape)
    return y + xf * d_skip[None, None, :, None]


def layout_pack_ref(w: torch.Tensor, tile=(8, 128)) -> torch.Tensor:
    """Pack [R, C] into tiles [R/tr, C/tc, tr, tc], zero-padded to tile
    multiples (the MXU analogue of the paper's 2.5D texture layout)."""
    tr, tc = tile
    r, c = w.shape
    rp = (tr - r % tr) % tr
    cp = (tc - c % tc) % tc
    wp = torch.nn.functional.pad(w, (0, cp, 0, rp))
    rr, cc = wp.shape
    return wp.reshape(rr // tr, tr, cc // tc, tc).permute(0, 2, 1, 3) \
        .contiguous()


def layout_unpack_ref(t: torch.Tensor, shape) -> torch.Tensor:
    nr, nc, tr, tc = t.shape
    w = t.permute(0, 2, 1, 3).reshape(nr * tr, nc * tc)
    return w[: shape[0], : shape[1]]
