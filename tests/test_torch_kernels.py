"""The port's kernels against the JAX package's, on the sweeps of
``tests/test_kernels.py``: the plain PyTorch versions (what the CPU runs,
and what the CUDA kernels are held to on the card) against
``repro.kernels.ref`` and against the Pallas kernels in interpret mode, at
that file's tolerances. Inputs are drawn with numpy and handed to both.
The CUDA kernels themselves are tested on the card in
``test_torch_cuda.py``."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops, ref
from torch_threads import one_torch_thread  # noqa: F401

MM_SHAPES = [(8, 128, 128), (64, 256, 128), (128, 128, 384), (256, 512, 256),
             (40, 128, 256)]
FA_SHAPES = [(2, 128, 128, 4, 2, 64), (1, 256, 256, 4, 4, 32),
             (2, 64, 64, 2, 1, 16), (1, 128, 128, 8, 8, 128)]
MASKS = [(True, 0), (True, 64), (False, 0)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_plain_matches_reference_and_pallas(m, k, n, dtype):
    rng = np.random.default_rng(m * 7 + k + n)
    aj, at = _both(_normal(rng, (m, k)), dtype)
    bj, bt = _both(_normal(rng, (k, n)), dtype)
    got = ops.matmul(at, bt)
    assert got.dtype == at.dtype and tuple(got.shape) == (m, n)
    tol = 1e-3 if dtype == "float32" else 0.3
    np.testing.assert_allclose(_f32(got), _f32(jax_ref.matmul_ref(aj, bj)),
                               atol=tol, rtol=tol)
    pallas = jax_ops.matmul(aj, bj, block_m=64, block_n=128, block_k=128)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd", FA_SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_attention_plain_matches_reference_and_pallas(b, sq, sk, hq, hkv, hd,
                                                      causal, window):
    rng = np.random.default_rng(sq + hq * 3 + hd)
    qj, qt = _both(_normal(rng, (b, sq, hq, hd)), "float32")
    kj, kt = _both(_normal(rng, (b, sk, hkv, hd)), "float32")
    vj, vt = _both(_normal(rng, (b, sk, hkv, hd)), "float32")
    got = ops.attention(qt, kt, vt, causal=causal, window=window)
    want = jax_ref.flash_attention_ref(qj, kj, vj, causal=causal,
                                       window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5)
    pallas = jax_ops.attention(qj, kj, vj, causal=causal, window=window,
                               block_q=64, block_kv=64)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_plain_dtypes(dtype):
    rng = np.random.default_rng(3)
    qj, qt = _both(_normal(rng, (1, 128, 4, 64)), dtype)
    kj, kt = _both(_normal(rng, (1, 128, 2, 64)), dtype)
    vj, vt = _both(_normal(rng, (1, 128, 2, 64)), dtype)
    got = ops.attention(qt, kt, vt)
    assert got.dtype == qt.dtype
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got),
                               _f32(jax_ref.flash_attention_ref(qj, kj, vj)),
                               atol=tol)
    np.testing.assert_allclose(
        _f32(got), _f32(jax_ops.attention(qj, kj, vj, block_q=64,
                                          block_kv=64)), atol=tol)


# (N, K) -> the number of K splits the plan gives the serving shapes
# (GPT-Neo-1.3B and GPT-Neo-S at 1024 tokens) and odd shapes, among them
# splits of a K that is no multiple of the split count times the K tile
PLAN_CASES = [(2048, 2048, 1), (8192, 2048, 1), (2048, 8192, 1),
              (768, 768, 2), (3072, 768, 2), (768, 3072, 8), (61, 100, 1),
              (770, 130, 1), (50257, 2048, 1), (128, 128, 1),
              (768, 3100, 8), (770, 3074, 2)]


@pytest.mark.parametrize("n,k,splits", PLAN_CASES)
def test_matmul_plan_reads_n_and_k_only(n, k, splits):
    """The CUDA matmul's plan is a function of (N, K) alone, so a row of C
    does not depend on how many rows share the launch, and it is a split of
    K that the kernel takes (one or more ranges, ``SPLITS``), each range at
    least ``SPLIT_MIN_K`` deep."""
    import inspect

    from repro_torch.kernels import streamed_matmul as mm
    assert list(inspect.signature(mm.tile_for.__wrapped__).parameters) == \
        ["n", "k"]
    assert mm.tile_for(n, k) == splits
    assert splits in mm.SPLITS and (splits == 1
                                    or k >= splits * mm.SPLIT_MIN_K)


# tests/test_kernels.py's SSD sweep, its chunked-form case and a length
# whose chunk halves (96 % 64 -> 32)
SSD_SHAPES = [(2, 128, 3, 16, 8, 32), (1, 64, 2, 32, 16, 64),
              (1, 256, 4, 8, 4, 16), (2, 96, 2, 16, 8, 32),
              (1, 96, 2, 16, 8, 64)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_passes_match_jax_chunked_pallas_and_reference(b, s, h, p, n,
                                                           chunk):
    """The CUDA scan's decomposition (chunk states, state passing, chunk
    outputs), stated in plain PyTorch, against the JAX package: its chunked
    form (y and final state; f32 summation order only, atol 1e-4 as the
    port's ssd_chunked is held to it, on |y| up to about 50), the Pallas
    kernel in interpret mode and the sequential reference (the tolerance of
    tests/test_kernels.py, chunked against sequential sums)."""
    from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
    from repro.models.ssm import ssd_chunked as jax_chunked
    from repro_torch.kernels import ssd_scan as ssd
    rng = np.random.default_rng(s * 3 + h)
    ins = (_normal(rng, (b, s, h, p)),
           np.log1p(np.exp(_normal(rng, (b, s, h)))).astype(np.float32),
           -np.exp(_normal(rng, (h,)) * 0.5).astype(np.float32),
           _normal(rng, (b, s, n)), _normal(rng, (b, s, n)),
           _normal(rng, (h,)))
    y, state = ssd.passes(*map(torch.from_numpy, ins), chunk=chunk)
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, s, h, p)
    assert tuple(state.shape) == (b, h, n, p)
    jy, jstate = jax_chunked(*map(jnp.asarray, ins), chunk)
    np.testing.assert_allclose(_f32(y), _f32(jy), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_f32(state), _f32(jstate), atol=1e-4, rtol=0)
    pallas = pallas_ssd(*map(jnp.asarray, ins), chunk=chunk, interpret=True)
    np.testing.assert_allclose(_f32(y), _f32(pallas), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(_f32(y), _f32(jax_ref.ssd_ref(
        *map(jnp.asarray, ins))), atol=2e-3, rtol=1e-3)


def _ssd_grad_inputs(b, s, h, p, n, chunk, swing):
    """The SSD operands of the test above and a cotangent dy. With
    ``swing``, dt a of heads 0 and 1 takes both signs in batch row 0's
    first chunk: L rises 6 nats over its first quarter and falls 6 over
    the next eighth."""
    rng = np.random.default_rng(s * 3 + h)
    ins = [_normal(rng, (b, s, h, p)),
           np.log1p(np.exp(_normal(rng, (b, s, h)))).astype(np.float32),
           -np.exp(_normal(rng, (h,)) * 0.5).astype(np.float32),
           _normal(rng, (b, s, n)), _normal(rng, (b, s, n)),
           _normal(rng, (h,))]
    if swing:
        up, down = chunk // 4, chunk // 8
        ins[2][:2] = -1.0
        ins[1][0, :chunk, :2] = 0.05
        ins[1][0, :up, :2] = -6.0 / up
        ins[1][0, up:up + down, :2] = 6.0 / down
    return ins, _normal(rng, (b, s, h, p))


# the kernel's head groups (ssd_scan_bwd.head_group): 25 heads make 6
# groups of 4 and one of 1; with d_state 16 and chunks of 96 and 48 (no
# multiple of the 64-row tile), the last with dt a of both signs
@pytest.mark.parametrize("b,s,h,p,n,chunk,swing",
                         [(*shape, False) for shape in SSD_SHAPES]
                         + [(1, 128, 3, 16, 8, 64, True),
                            (1, 192, 25, 8, 16, 96, False),
                            (2, 96, 25, 4, 16, 48, True)])
def test_ssd_gradient_matches_jax_vjp_of_chunked_and_reference(
        b, s, h, p, n, chunk, swing):
    """dx, ddt, da, db, dc and dd of y given dy, by the CUDA backward's
    decomposition in plain PyTorch (``ssd_scan_bwd.backward_passes``) and
    by autograd of the forward's passes (``ssd_scan_bwd.plain``, what the
    kernel is held to on the card), against ``jax.vjp`` of the JAX
    package's ``ssd_chunked`` (the cotangent on y only: f32 summation
    order, each gradient within 1e-4 of its largest element; readings up
    to 4.1e-5, da, a sum over batch and steps) and of its sequential
    ``ssd_ref`` (the chunked-versus-sequential tolerance of
    tests/test_kernels.py, atol 2e-3 and rtol 1e-3). The last case has dt
    a of both signs in a chunk."""
    import jax
    from repro.models.ssm import ssd_chunked as jax_chunked
    from repro_torch.kernels import ssd_scan_bwd as sbw
    ins, dy = _ssd_grad_inputs(b, s, h, p, n, chunk, swing)
    _, vjp = jax.vjp(lambda *a: jax_chunked(*a, chunk)[0],
                     *map(jnp.asarray, ins))
    chunked = vjp(jnp.asarray(dy))
    _, vjp = jax.vjp(jax_ref.ssd_ref, *map(jnp.asarray, ins))
    sequential = vjp(jnp.asarray(dy))
    tins, tdy = list(map(torch.from_numpy, ins)), torch.from_numpy(dy)
    for got in (sbw.backward_passes(tdy, *tins, chunk=chunk),
                sbw.plain(tdy, *tins, chunk=chunk)):
        for g, t, want, seq in zip(got, tins, chunked, sequential):
            assert g.dtype == torch.float32 and g.shape == t.shape
            want = _f32(want)
            np.testing.assert_allclose(_f32(g), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max())
            np.testing.assert_allclose(_f32(g), _f32(seq), atol=2e-3,
                                       rtol=1e-3)


def _tc_attention_emulation(q, k, v, causal, window, bq=64, bkv=64):
    """The arithmetic of the bf16 tensor-core ``flash_attention`` kernel,
    written out in PyTorch: for each warpgroup's 64 query rows, the visible
    64-key tiles in order; S = QK^T from bf16 operands summed in f32 (each
    product of two bf16 values is exact in f32); the online softmax in
    base 2 (scores scaled by scale * log2 e, masked scores -1e30, keys past
    Sk left out); P split into bf16 hi = bf16(P) and lo = bf16(P - hi),
    both multiplied by V into one f32 accumulator; acc / max(l, 1e-30)
    rounded to bf16."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale2 = math.log2(math.e) / math.sqrt(hd)
    out = torch.zeros((b, sq, hq, hd))
    for h in range(hq):
        kh = k[:, :, h // (hq // hkv)].float()
        vh = v[:, :, h // (hq // hkv)].float()
        for q0 in range(0, sq, bq):
            qh = q[:, q0:q0 + bq, h].float()
            rows = torch.arange(q0, q0 + qh.shape[1])[:, None]
            m = torch.full(qh.shape[:2], -1e30)
            l = torch.zeros(qh.shape[:2])
            acc = torch.zeros(qh.shape)
            for k0 in range(0, sk, bkv):
                if (causal and q0 + bq - 1 < k0) or \
                        (window and q0 - (k0 + bkv - 1) >= window):
                    continue                      # a hidden tile
                keys = torch.arange(k0, min(k0 + bkv, sk))
                s = (qh @ kh[:, keys].transpose(1, 2)) * scale2
                vis = torch.ones((len(rows), len(keys)), dtype=torch.bool)
                if causal:
                    vis &= rows >= keys[None]
                if window:
                    vis &= rows - keys[None] < window
                s = torch.where(vis, s, torch.tensor(-1e30))
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                hi = p.bfloat16().float()
                lo = (p - hi).bfloat16().float()
                acc = acc * corr[..., None] + hi @ vh[:, keys] + \
                    lo @ vh[:, keys]
                m = m_new
            out[:, q0:q0 + bq, h] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.bfloat16()


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_tc_attention_design_within_one_bf16_ulp(hd, causal, window,
                                                 q_scale):
    """The bf16 kernel's numerical design against the plain version and
    the JAX reference at the card's limits: 2e-2 max abs, and one bf16 ulp
    (2^-7 relative) above a 1e-3 floor. A ragged length (200 = 3 tiles and
    8 rows) and a GQA group of 2; q scaled by 8 gives scores of some tens."""
    rng = np.random.default_rng(hd * 7 + int(q_scale) + window)
    shapes = ((1, 200, 4, hd), (1, 200, 2, hd), (1, 200, 2, hd))
    (qj, qt), (kj, kt), (vj, vt) = (
        _both(_normal(rng, s) * (q_scale if i == 0 else 1.0), "bfloat16")
        for i, s in enumerate(shapes))
    got = _tc_attention_emulation(qt, kt, vt, causal, window).float()
    for want in (ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                         window=window).float(),
                 torch.from_numpy(_f32(jax_ref.flash_attention_ref(
                     qj, kj, vj, causal=causal, window=window)))):
        torch.testing.assert_close(got, want, atol=2e-2, rtol=0)
        torch.testing.assert_close(got, want, atol=1e-3, rtol=2 ** -7)


def test_tc_attention_p_split_keeps_16_bits():
    """hi + lo reproduces an f32 P in (0, 1] within 2^-16 relative (each
    rounding to bf16 is within 2^-8 of its input), where hi alone is off by
    up to 2^-9: the split is what keeps P V at f32 precision."""
    rng = np.random.default_rng(0)
    p = torch.from_numpy(np.exp2(-rng.uniform(0, 30, 1 << 16)).astype(
        np.float32))
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    rel = ((hi + lo - p).abs() / p).max().item()
    assert rel <= 2 ** -16
    assert ((hi - p).abs() / p).max().item() > 2 ** -10



def _tc_attention_bwd_emulation(q, k, v, o, do, causal, window):
    """The rounding points of the bf16 tensor-core ``flash_attention``
    backward, written out in PyTorch: S and dP from bf16 operands summed in
    f32; P = exp2(S scale log2 e - lse log2 e) where the pair is visible,
    else 0, with lse the f32 log-sum-exp of the scaled, masked scores;
    D = rowsum(dO O) in f32 from the forward's bf16 O; P and
    dS = P (dP - D) each rounded once to bf16 before their products, whose
    sums are f32; dq, dk, dv rounded to bf16."""
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    rep = lambda t: torch.repeat_interleave(t.float(), hq // hkv, dim=2)
    qf, kf, vf, dof = q.float(), rep(k), rep(v), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    rows = torch.arange(sq)[:, None]
    keys = torch.arange(sk)[None]
    vis = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        vis &= rows >= keys
    if window:
        vis &= rows - keys < window
    lse = torch.logsumexp(torch.where(vis, s * scale, -torch.inf), dim=-1)
    log2e = math.log2(math.e)
    p = torch.where(vis, torch.exp2(s * (scale * log2e)
                                    - (lse * log2e)[..., None]), 0.0)
    d = (dof * o.float()).sum(-1).transpose(1, 2)            # [b, h, q]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - d[..., None])
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, kf) * scale
    group = lambda t: t.reshape(b, sk, hkv, hq // hkv, hd).sum(3)
    return dq.bfloat16(), group(dk).bfloat16(), group(dv).bfloat16()


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("sk,causal,window",
                         [(200, *m) for m in MASKS] + [(333, False, 0)])
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_tc_attention_bwd_design_within_card_bounds(hd, sk, causal, window,
                                                    q_scale):
    """The bf16 backward kernel's rounding points (P and dS rounded once
    to bf16) against ``flash_attention_bwd.plain``, autograd of the plain
    version in f32, within the card's bounds: relative L2 <= 1e-2 and max
    abs <= 2e-2 max|ref| for each of dq, dk, dv. A ragged length (200 =
    3 tiles and 8 rows), 333 keys for 200 queries (bidirectional, as cross
    attention), a GQA group of 2; q scaled by 8 gives scores of some
    tens."""
    from repro_torch.kernels import flash_attention_bwd as fab
    rng = np.random.default_rng(hd * 5 + int(q_scale) + window + sk)
    q = torch.from_numpy(_normal(rng, (1, 200, 4, hd)) * q_scale).bfloat16()
    k, v = (torch.from_numpy(_normal(rng, (1, sk, 2, hd))).bfloat16()
            for _ in range(2))
    do = torch.from_numpy(_normal(rng, (1, 200, 4, hd))).bfloat16()
    o = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    got = _tc_attention_bwd_emulation(q, k, v, o, do, causal, window)
    want = fab.plain(q, k, v, do, causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g = g.float()
        err = (g - w).abs().max().item()
        rel = ((g - w).norm() / w.norm()).item()
        assert err <= 2e-2 * w.abs().max().item(), (name, err)
        assert rel <= 1e-2, (name, rel)

# (R, C, tr, tc, itemsize, bytes the input and the output start past a
# 16-byte boundary, the path): the native tiles, row padding, column
# padding, runs that are not whole vectors, short runs of whole vectors,
# 1- and 8-byte elements and misaligned pointers
PLAN_PACK_CASES = [
    (2048, 8192, 8, 128, 4, 0, 0, "vector"),
    (8192, 2048, 16, 128, 2, 0, 0, "vector"),
    (70, 256, 8, 128, 4, 0, 0, "vector"),
    (33, 129, 8, 128, 4, 0, 0, "general"),
    (33, 129, 16, 128, 2, 0, 0, "general"),
    (64, 96, 8, 64, 4, 0, 0, "general"),
    (48, 96, 5, 12, 4, 0, 0, "vector"),
    (40, 96, 5, 6, 4, 0, 0, "general"),
    (40, 256, 8, 128, 1, 0, 0, "vector"),
    (40, 256, 8, 128, 8, 0, 0, "vector"),
    (64, 256, 8, 128, 4, 4, 0, "general"),
    (64, 256, 8, 128, 4, 0, 8, "general")]


@pytest.mark.parametrize("r,c,tr,tc,size,w_off,out_off,path",
                         PLAN_PACK_CASES)
def test_pack_plan_path_and_cover(r, c, tr, tc, size, w_off, out_off,
                                  path):
    """``pack_plan`` picks the vector path exactly when the tiles divide
    C, a tile row is whole 16-byte vectors and both pointers are 16-byte
    aligned, whatever R is; and the grid it gives walks every unit of the
    padded output exactly once (a thread per vector, or a warp per run with
    its lanes over the run's units), as the kernel walks any grid: also
    one of 3 blocks, which walks the output with a stride."""
    from repro_torch.kernels import layout_pack as lp
    base = 1 << 20
    plans = [lp.pack_plan(rr, c, tr, tc, size, base + w_off,
                          2 * base + out_off) for rr in (r, 1, r + 1, 3 * r)]
    assert {p.path for p in plans} == {path}
    assert path == ("vector" if c % tc == 0 and tc * size % 16 == 0
                    and w_off % 16 == 0 and out_off % 16 == 0 else "general")
    out_bytes = -(-r // tr) * tr * -(-c // tc) * tc * size
    for plan in (plans[0], plans[0]._replace(blocks=3)):
        assert plan.units * plan.unit_bytes == out_bytes
        assert plan.unit_bytes == (16 if path == "vector" else size)
        assert plan.run * plan.unit_bytes == tc * size
        assert plan.threads == lp.THREADS and plan.blocks >= 1
        walked = np.zeros(plan.units, np.int64)
        if plan.walk == "thread":
            assert lp.THREADS % plan.run == 0
            step = plan.blocks * plan.threads
            for k in range(0, plan.units, step):
                walked[k:k + step] += 1
        else:
            warps = plan.blocks * plan.threads // 32
            for w in range(warps):
                for q in range(w, plan.units // plan.run, warps):
                    for lane in range(32):
                        walked[q * plan.run + lane:(q + 1) * plan.run:32] \
                            += 1
        assert (walked == 1).all()
