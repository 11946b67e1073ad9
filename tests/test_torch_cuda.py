"""The port on the card: its CUDA kernels against their plain versions, the
copy-stream path, the executors and the Mamba-2, dense and MoE model
paths. Every test needs an NVIDIA card
(``cuda`` marker) and skips without one; the file imports no JAX, so it
runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

MM_SHAPES = [(8, 128, 128), (64, 256, 128), (128, 128, 384), (256, 512, 256),
             (40, 128, 256), (37, 100, 61), (33, 130, 770), (1024, 768, 3072),
             (1024, 2048, 2048), (1024, 3072, 768), (1024, 2048, 8192),
             (64, 3100, 768), (33, 3074, 770)]
FA_SHAPES = [(2, 128, 128, 4, 2, 64), (1, 256, 256, 4, 4, 32),
             (2, 64, 64, 2, 1, 16), (1, 128, 128, 8, 8, 128),
             (1, 100, 100, 4, 2, 64), (1, 1024, 1024, 12, 12, 64),
             (1, 1024, 1024, 16, 16, 128), (1, 100, 100, 4, 2, 128),
             (1, 256, 256, 8, 1, 128), (2, 512, 512, 16, 2, 128)]
MASKS = [(True, 0), (True, 64), (False, 0)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _normal(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_streamed_matmul_kernel(dev, m, k, n, dtype):
    from repro_torch.kernels.streamed_matmul import streamed_matmul
    rng = np.random.default_rng(m + k + n)
    a = _normal(rng, (m, k)).to(dev, DTYPES[dtype])
    b = _normal(rng, (k, n), k ** -0.5).to(dev, DTYPES[dtype])
    got = streamed_matmul(a, b)
    torch.cuda.synchronize()
    assert got.dtype == a.dtype
    tol = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), ref.matmul_ref(a, b).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd", FA_SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_kernel(dev, b, sq, sk, hq, hkv, hd, causal, window,
                                dtype):
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(sq + hd)
    q, k, v = (_normal(rng, s).to(dev, DTYPES[dtype])
               for s in ((b, sq, hq, hd), (b, sk, hkv, hd), (b, sk, hkv, hd)))
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    if dtype == "bfloat16":
        # both round an f32 result to bf16: at most one bf16 ulp apart
        # above a floor for outputs near zero
        torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                                   rtol=2 ** -7)


def _bf16_attention_case(dev, b, sq, sk, hq, hkv, hd, causal, window,
                         q_scale=1.0):
    """The bf16 kernel against its plain version at the checks of
    test_flash_attention_kernel: 2e-2 max abs, then one bf16 ulp above a
    floor for outputs near zero."""
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(sq + sk + hq + hd)
    q = _normal(rng, (b, sq, hq, hd), q_scale).to(dev, torch.bfloat16)
    k, v = (_normal(rng, (b, sk, hkv, hd)).to(dev, torch.bfloat16)
            for _ in range(2))
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                               rtol=2 ** -7)


# the Yi-6B head layout at length, a ragged GQA group of 8 under every
# mask, and more keys than queries
@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,causal,window", [
    (1, 2048, 2048, 32, 4, 128, True, 0),
    (1, 1000, 1000, 8, 1, 128, True, 0),
    (1, 1000, 1000, 8, 1, 128, True, 64),
    (1, 1000, 1000, 8, 1, 128, False, 0),
    (1, 64, 320, 4, 2, 64, False, 0)])
def test_flash_attention_bf16_shapes(dev, b, sq, sk, hq, hkv, hd, causal,
                                     window):
    _bf16_attention_case(dev, b, sq, sk, hq, hkv, hd, causal, window)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd", [
    (2, 128, 128, 4, 2, 64), (1, 100, 100, 4, 2, 128),
    (1, 256, 256, 8, 1, 128), (2, 64, 64, 2, 1, 16)])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_bf16_large_scores(dev, b, sq, sk, hq, hkv, hd,
                                           causal, window):
    """q scaled by 8: scores of some tens, so the online rescale and the
    split of P into bf16 hi + lo run over a wide range of exponents."""
    _bf16_attention_case(dev, b, sq, sk, hq, hkv, hd, causal, window,
                         q_scale=8.0)


@pytest.mark.parametrize("hq,hd", [(16, 128), (12, 64)])
def test_flash_attention_f32_serving_shapes(dev, hq, hd):
    """The f32 kernel at the serving shapes (GPT-Neo-1.3B and GPT-Neo-S at
    1024 tokens, causal) within 2e-5 of its plain version, the limit it
    was built to, and the same bits on a second launch."""
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(hq + hd)
    q, k, v = (_normal(rng, (1, 1024, hq, hd)).to(dev) for _ in range(3))
    got = flash_attention(q, k, v)
    again = flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v),
                               atol=2e-5, rtol=0)
    assert torch.equal(got, again)


@pytest.mark.parametrize("k,n,split", [(768, 2048, False), (768, 3072, True),
                                       (3072, 768, True)])
def test_matmul_rows_do_not_depend_on_the_batch(dev, k, n, split):
    """A row of C is the same alone or inside a larger M: one K order,
    the plan chosen from N and K only; where the plan splits K, a second
    kernel adds the partial sums in split order."""
    from repro_torch.kernels.streamed_matmul import streamed_matmul, tile_for
    assert (tile_for(n, k) > 1) == split
    rng = np.random.default_rng(k + n)
    a = _normal(rng, (300, k)).to(dev)
    b = _normal(rng, (k, n), k ** -0.5).to(dev)
    full = streamed_matmul(a, b)
    part = streamed_matmul(a[17:18].clone(), b)
    torch.cuda.synchronize()
    assert torch.equal(full[17:18], part)


def test_dispatch_launches_and_counts(dev):
    rng = np.random.default_rng(0)
    ops.reset_launch_counts()
    a = _normal(rng, (64, 128)).to(dev)
    ops.matmul(a, _normal(rng, (128, 64)).to(dev))
    q = _normal(rng, (1, 64, 2, 64)).to(dev)
    ops.attention(q, q, q)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"streamed_matmul": 1,
                                   "flash_attention": 1, "ssd_scan": 0,
                                   "layout_pack": 0}
    assert ops.launch_counts_by_shape() == {
        "streamed_matmul": {(64, 128, 64): 1},
        "flash_attention": {(1, 64, 64, 2, 2, 64, True, 0, torch.float32):
                            1},
        "ssd_scan": {}, "layout_pack": {}}


def test_kernels_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.streamed_matmul import streamed_matmul
    a = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError):
        streamed_matmul(a, a)
    with pytest.raises(TypeError):
        streamed_matmul(a.half(), a.half().t())
    q = torch.zeros((1, 8, 2, 48), device=dev)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


def test_copy_path_pinned_and_staged(dev):
    from repro_torch.device import HostToDevice, pinned_copy
    arrays = {"w": np.arange(1 << 16, dtype=np.float32).reshape(256, 256),
              "n": np.ones((2, 7), np.float32)}
    pinned = pinned_copy(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(pinned[name], a)
        assert torch.from_numpy(pinned[name]).is_pinned()
    host = pinned["w"]
    staged = np.arange(4096, dtype=np.int8)
    assert not torch.from_numpy(staged).is_pinned()
    h2d = HostToDevice(dev)
    with h2d.copies():
        got = h2d.put(host[64:128])
        got2 = h2d.put(staged)
    h2d.wait(h2d.mark())
    assert torch.equal(got.cpu(), torch.from_numpy(host[64:128]))
    assert torch.equal(got2.cpu(), torch.from_numpy(staged))


def test_executors_on_the_card(dev):
    from repro_torch.configs.gptneo import GPTNEO_S
    from repro_torch.core.plan import plan_always_next
    from repro_torch.core.streaming import (HostModel, PreloadExecutor,
                                            StreamingExecutor)
    cfg = replace(GPTNEO_S, num_layers=2, d_model=256, n_heads=4,
                  n_kv_heads=4, d_ff=1024, vocab=1024, name="gptneo-tiny")
    model = HostModel.build(cfg, seq=128, seed=0, device=dev)
    cpu = HostModel.from_host_weights(cfg, model.host_weights, seq=128,
                                      device="cpu")
    tokens = np.random.default_rng(0).integers(0, 1024, (1, 128),
                                               dtype=np.int32)
    pre = PreloadExecutor(model).run(tokens)
    for quantize in (False, True):
        st = StreamingExecutor(model, plan_always_next(model.graph, 64 << 10),
                               quantize_stream=quantize).run(tokens)
        if not quantize:
            torch.testing.assert_close(st.result, pre.result, atol=1e-5,
                                       rtol=0)
        want = StreamingExecutor(cpu, plan_always_next(cpu.graph, 64 << 10),
                                 quantize_stream=quantize).run(tokens)
        torch.testing.assert_close(st.result.cpu(), want.result, atol=1e-4,
                                   rtol=1e-4)


# (b, s, h, p, n, chunk): tests/test_kernels.py's sweep, a length whose
# chunk halves (96 % 64 -> 32), a ragged chunk (100 -> 50), the
# Mamba-2-130M head shape at a short length, head counts that are no
# multiple of the output pass's group of 4 heads (3, 25), and more chunks
# (64) than the state pass loads at once (8)
SSD_SHAPES = [(2, 128, 3, 16, 8, 32), (1, 64, 2, 32, 16, 64),
              (1, 256, 4, 8, 4, 16), (2, 96, 2, 16, 8, 32),
              (1, 96, 2, 16, 8, 64), (1, 100, 2, 64, 16, 256),
              (2, 512, 3, 64, 128, 256), (1, 512, 25, 64, 128, 256),
              (1, 4096, 3, 16, 8, 64)]
PACK_CASES = [(64, 256), (70, 300), (128, 384), (8, 128), (33, 129),
              (2048, 8192), (8192, 2048)]
# the boundaries of the kernel's two paths (``pack_plan``): (R, C), dtype,
# tile (None: the native one), bytes the input starts past a 16-byte
# boundary, and the path it must take
PACK_PATH_CASES = [((70, 256), torch.float32, None, 0, "vector"),
                   ((33, 129), torch.float32, None, 0, "general"),
                   ((33, 129), torch.bfloat16, None, 0, "general"),
                   ((64, 96), torch.float32, (8, 64), 0, "general"),
                   ((48, 96), torch.float32, (5, 12), 0, "vector"),
                   ((40, 96), torch.float32, (5, 6), 0, "general"),
                   ((40, 256), torch.uint8, None, 0, "vector"),
                   ((40, 256), torch.int64, None, 0, "vector"),
                   ((40, 256), torch.uint8, (8, 100), 0, "general"),
                   ((64, 256), torch.float32, None, 4, "general"),
                   ((64, 256), torch.bfloat16, None, 2, "general"),
                   ((8192, 2048), torch.float32, None, 0, "vector"),
                   ((8192, 2048), torch.bfloat16, None, 0, "vector")]


def _ssd_inputs(rng, b, s, h, p, n, dev):
    x = _normal(rng, (b, s, h, p)).to(dev)
    dt = torch.nn.functional.softplus(_normal(rng, (b, s, h))).to(dev)
    a = -torch.exp(_normal(rng, (h,), 0.5)).to(dev)
    bb, cc = _normal(rng, (b, s, n)).to(dev), _normal(rng, (b, s, n)).to(dev)
    return x, dt, a, bb, cc, _normal(rng, (h,)).to(dev)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_scan_kernel(dev, b, s, h, p, n, chunk):
    """Against the sequential recurrence, at the tolerance of
    tests/test_kernels.py (chunked and sequential sums differ in order)."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    ins = _ssd_inputs(np.random.default_rng(s + n), b, s, h, p, n, dev)
    got = ssd_scan(*ins, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.ssd_ref(*ins), atol=2e-3, rtol=1e-3)


def test_ssd_scan_at_the_mamba2_prefill_shape(dev):
    """The Mamba-2-130M prefill shape (4 x 4096 tokens, 24 heads of 64,
    d_state 128, chunk 256) against the chunked form the CPU path runs:
    f32 summation order only, so within 1e-4 of y's scale."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.ssm import ssd_chunked
    ins = _ssd_inputs(np.random.default_rng(14), 4, 4096, 24, 64, 128, dev)
    got = ssd_scan(*ins, chunk=256)
    want = ssd_chunked(*ins, 256)[0]
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=0)


def test_ssd_scan_reads_strided_views(dev):
    """x, b and c as the model hands them over: slices of one conv output,
    and dt a transposed view; the result is the contiguous inputs'."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    rng = np.random.default_rng(9)
    b, s, h, p, n = 2, 256, 4, 16, 8
    xbc = _normal(rng, (b, s, h * p + 2 * n)).to(dev)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bb, cc = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.nn.functional.softplus(_normal(rng, (b, h, s))).to(dev) \
        .transpose(1, 2)
    a, d = -torch.ones(h, device=dev), torch.ones(h, device=dev)
    got = ssd_scan(x, dt, a, bb, cc, d, chunk=64)
    want = ssd_scan(x.contiguous(), dt.contiguous(), a, bb.contiguous(),
                    cc.contiguous(), d, chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_ssd_scan_rows_do_not_depend_on_the_batch(dev):
    """A batch row's output is the same alone or inside a larger batch:
    no pass of the scan reads across batch rows."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    ins = _ssd_inputs(np.random.default_rng(4), 3, 256, 4, 64, 128, dev)
    full = ssd_scan(*ins, chunk=128)
    one = ssd_scan(*(t[1:2].clone() if t.dim() > 1 else t for t in ins),
                   chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(full[1:2], one)


def _swing_inputs(dev, swing_heads=(1, 4)):
    """Positive x, b and c at the model's chunk (256); in chunk 1 of batch
    row 0, for ``swing_heads``, dt a takes both signs: L rises by 84 nats
    over the chunk's first 64 steps and falls back over the next 16, so
    the output pass's tile right of the apex would factor its decay
    through exp(L_r - L_j) ~ e^83 (and C . S_in through exp(L_r) ~ e^84),
    summed over n: past the f32 range. c is zero on the rows where L is
    above 20, so the reference's rows there stay finite."""
    rng = np.random.default_rng(16)
    b, s, h, p, n, q = 2, 512, 6, 64, 128, 256
    x = rng.uniform(0.5, 1.5, (b, s, h, p))
    bb, cc = rng.uniform(1, 2, (b, s, n)), rng.uniform(1, 2, (b, s, n))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
    a = -np.exp(0.5 * rng.standard_normal(h))
    d = rng.standard_normal(h)
    swing = np.full(q, 0.05)
    swing[:64], swing[64:80] = -84 / 64, 84 / 16
    for hh in swing_heads:
        a[hh] = -1.0
        dt[0, q:, hh] = swing
    cc[0, q:][np.cumsum(-swing) > 20] = 0.0
    return tuple(torch.from_numpy(t.astype(np.float32)).to(dev)
                 for t in (x, dt, a, bb, cc, d))


def test_ssd_scan_with_a_non_monotone_decay(dev):
    """dt a of both signs in a chunk (the reference takes any dt): held
    against the recurrence where the recurrence is finite, at the
    tolerance of test_ssd_scan_kernel. The rows right of the apex's tile
    with c != 0 are among those compared: there a decay factored through
    the tile's left column overflows."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    ins = _swing_inputs(dev)
    got = ssd_scan(*ins, chunk=256)
    want = ref.ssd_ref(*ins)
    torch.cuda.synchronize()
    finite = torch.isfinite(want)
    assert finite[0, 256 + 76:256 + 128, [1, 4]].all()
    torch.testing.assert_close(got[finite], want[finite], atol=2e-3,
                               rtol=1e-3)


def test_ssd_scan_monotone_heads_are_unchanged_by_a_swinging_group(dev):
    """Monotone chunks, falling (a < 0) and rising (a > 0, dt > 0), agree
    with the recurrence; a head whose dt a swings changes nothing in the
    output of the heads of another group of the output pass."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    x, dt, a, bb, cc, d = _swing_inputs(dev, swing_heads=())
    a[:2] = 0.02
    calm = ssd_scan(x, dt, a, bb, cc, d, chunk=256)
    torch.testing.assert_close(calm, ref.ssd_ref(x, dt, a, bb, cc, d),
                               atol=2e-3, rtol=1e-3)
    swung = _swing_inputs(dev, swing_heads=(4,))[1]
    dt2 = dt.clone()
    dt2[..., 4], a2 = swung[..., 4], a.clone()
    a2[4] = -1.0
    got = ssd_scan(x, dt2, a2, bb, cc, d, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(got[:, :, :4], calm[:, :, :4])


def test_fleet_of_two_replicas_on_one_card(dev):
    """Two replicas on cuda:0, each with its own pool, behind the Router,
    replica 1 killed partway: one terminal response per request, served
    outputs equal to a solo forward on the card, pools within budget."""
    from repro_torch.configs.gptneo import GPTNEO_S
    from repro_torch.core.streaming import HostModel, PreloadExecutor
    from repro_torch.serving.replica import FaultPlan, Replica, ReplicaClock
    from repro_torch.serving.router import Router
    from repro_torch.serving.stream import poisson_trace
    cfg = replace(GPTNEO_S, num_layers=2, d_model=128, n_heads=2,
                  n_kv_heads=2, d_ff=256, vocab=256, name="tiny")
    seq = 32
    models = {nm: HostModel.build(replace(cfg, name=nm), seq=seq, seed=i,
                                  device=dev) for i, nm in enumerate("ab")}
    total = sum(sum(w.nbytes for w in m.host_weights.values())
                for m in models.values())
    budget = int(0.6 * total)
    fleet = []
    for rid in range(2):
        rep = Replica(rid, clock=ReplicaClock(exec_time=0.05),
                      device=dev, policy="stream", chunk_bytes=16 << 10,
                      budget_bytes=budget, prefetch=False)
        for nm, m in models.items():
            rep.register(nm, m)
        fleet.append(rep.start())
    trace = poisson_trace({"a": 6.0, "b": 6.0}, 1.5, vocab=cfg.vocab,
                          seq=seq, seed=3)
    router = Router(fleet, timeout_s=0.2, cooldown_s=0.3)
    responses = router.serve(trace, fault_plan=FaultPlan().kill(0.6, 1))
    torch.cuda.synchronize()
    assert sorted(r.req_id for r in responses) == list(range(len(trace)))
    assert router.report(responses)["failed"] == 0
    for r in responses:
        want = PreloadExecutor(models[r.model]).run(
            trace[r.req_id].tokens).result
        torch.testing.assert_close(r.result, want, atol=1e-5, rtol=0)
    for rep in fleet:
        assert rep.engine.peak_memory() <= budget
        assert rep.engine.cache.ledger_balanced()


@pytest.mark.parametrize("r,c", PACK_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_layout_pack_kernel_bit_exact(dev, r, c, dtype):
    from repro_torch.kernels.layout_pack import layout_pack
    w = _normal(np.random.default_rng(r + c), (r, c)).to(dev, DTYPES[dtype])
    got = layout_pack(w)
    want = ref.layout_pack_ref(w, ops.native_tile(w.dtype))
    odd = layout_pack(w, (5, 24))
    torch.cuda.synchronize()
    bits = torch.int16 if w.dtype.itemsize == 2 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    assert torch.equal(odd.view(bits),
                       ref.layout_pack_ref(w, (5, 24)).view(bits))
    assert torch.equal(ops.unpack(got, (r, c)), w)


@pytest.mark.parametrize("shape,dtype,tile,skew,path", PACK_PATH_CASES)
def test_layout_pack_paths_bit_exact(dev, shape, dtype, tile, skew, path):
    """Each side of each boundary of the kernel's two paths, bit for bit
    against the plain version; the input starts ``skew`` bytes past a
    16-byte boundary, and ``pack_plan`` sends it down ``path``."""
    from repro_torch.kernels.layout_pack import layout_pack, pack_plan
    r, c = shape
    rng = np.random.default_rng(r + c + skew)
    n = r * c + skew // dtype.itemsize
    if dtype.is_floating_point:
        flat = _normal(rng, (n,)).to(dtype)
    else:
        info = torch.iinfo(dtype)
        flat = torch.from_numpy(rng.integers(info.min, info.max, n,
                                             endpoint=True)).to(dtype)
    w = flat.to(dev)[skew // dtype.itemsize:].view(r, c)
    assert w.data_ptr() % 16 == skew
    tile = tile or ops.native_tile(dtype)
    got = layout_pack(w, tile)
    torch.cuda.synchronize()
    plan = pack_plan(r, c, *tile, dtype.itemsize, w.data_ptr(),
                     got.data_ptr())
    assert plan.path == path
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[dtype.itemsize]
    assert torch.equal(got.view(bits),
                       ref.layout_pack_ref(w, tile).view(bits))
    assert torch.equal(ops.unpack(got, (r, c)), w)


def test_new_kernels_dispatch_and_count(dev):
    rng = np.random.default_rng(1)
    ops.reset_launch_counts()
    ins = _ssd_inputs(rng, 1, 96, 2, 16, 8, dev)
    ops.ssd(*ins, chunk=64)
    ops.pack(_normal(rng, (10, 20)).to(dev, torch.bfloat16))
    torch.cuda.synchronize()
    assert ops.launch_counts_by_shape()["ssd_scan"] == {
        (1, 96, 2, 16, 8, 32): 1}
    assert ops.launch_counts_by_shape()["layout_pack"] == {
        (10, 20, 16, 128, torch.bfloat16): 1}


def test_mamba_prefill_and_decode_on_the_card(dev):
    """The model path on the card (ssd_scan in every layer's prefill, the
    recurrence in decode) against the same bundle on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ArchConfig, ShapeConfig
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model
    arch = ArchConfig(model=get_arch("mamba2-130m").model.reduced())
    cfg = arch.model
    seq, batch = 96, 2
    out = {}
    gen = torch.Generator().manual_seed(0)
    params, cache, _, _ = model.init_inputs(model.make_step_bundle(
        arch, ShapeConfig("d", seq, batch, "decode"),
        make_host_mesh(device="cpu")), gen, "cpu")
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         dtype=torch.int32)
    for where in ("cpu", dev):
        env = make_host_mesh(device=where)
        pre = model.make_step_bundle(arch, ShapeConfig("p", seq, batch,
                                                       "prefill"), env)
        dec = model.make_step_bundle(arch, ShapeConfig("d", seq, batch,
                                                       "decode"), env)
        p = tree_map(lambda t: t.to(where), params)
        c = tree_map(lambda t: t.to(where), cache)
        ops.reset_launch_counts()
        logits = pre.fn(p, {"tokens": toks.to(where)})
        counted = ops.launch_counts()["ssd_scan"]
        for t in range(4):
            step, c = dec.fn(p, c, toks[:, t:t + 1].to(where),
                             torch.full((batch,), t, dtype=torch.int32,
                                        device=where))
        assert ops.launch_counts()["ssd_scan"] == counted
        out[str(where)] = (logits.cpu(), step.cpu(), counted)
    cpu, card = out["cpu"], out[str(dev)]
    assert cpu[2] == 0 and card[2] == cfg.num_layers
    for i in (0, 1):
        torch.testing.assert_close(card[i], cpu[i], atol=4e-2, rtol=0)


def test_dense_prefill_and_decode_on_the_card(dev):
    """A narrow dense stack at the full models' attention widths (hd 128,
    8 query heads on 1 KV head, 2 layers, bf16) through the model path on
    the card (bf16 flash_attention in every prefill layer, plain PyTorch
    decode) against the same bundle on the CPU. cuBLAS and the CPU round
    bf16 products apart here and there: logits up to about 4 within 0.1
    (the bf16 tolerance of tests/test_torch_dense.py)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ArchConfig, ShapeConfig
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model
    cfg = replace(get_arch("yi-6b").model.reduced(), d_model=256, n_heads=8,
                  n_kv_heads=1, head_dim=128, d_ff=512)
    arch = ArchConfig(model=cfg)
    seq, batch = 128, 2
    key = (batch, seq, seq, 8, 1, 128, True, 0, torch.bfloat16)
    out = {}
    gen = torch.Generator().manual_seed(0)
    params, cache, _, _ = model.init_inputs(model.make_step_bundle(
        arch, ShapeConfig("d", seq, batch, "decode"),
        make_host_mesh(device="cpu")), gen, "cpu")
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         dtype=torch.int32)
    for where in ("cpu", dev):
        env = make_host_mesh(device=where)
        pre = model.make_step_bundle(arch, ShapeConfig("p", seq, batch,
                                                       "prefill"), env)
        dec = model.make_step_bundle(arch, ShapeConfig("d", seq, batch,
                                                       "decode"), env)
        p = tree_map(lambda t: t.to(where), params)
        c = tree_map(lambda t: t.to(where), cache)
        ops.reset_launch_counts()
        logits = pre.fn(p, {"tokens": toks.to(where)})
        counted = ops.launch_counts_by_shape()["flash_attention"]
        for t in range(4):
            step, c = dec.fn(p, c, toks[:, t:t + 1].to(where),
                             torch.full((batch,), t, dtype=torch.int32,
                                        device=where))
        assert ops.launch_counts_by_shape()["flash_attention"] == counted
        out[str(where)] = (logits.cpu(), step.cpu(), counted)
    cpu, card = out["cpu"], out[str(dev)]
    assert cpu[2] == {} and card[2] == {key: cfg.num_layers}
    for i in (0, 1):
        torch.testing.assert_close(card[i], cpu[i], atol=0.1, rtol=0)


def _narrow_moe_cfg(**moe_kw):
    """A narrow MoE stack at the full models' attention widths (hd 128, 8
    query heads on 1 KV head, 2 layers) with 16 experts, top-4."""
    from repro_torch.configs import get_arch
    cfg = replace(get_arch("qwen3-moe-30b-a3b").model.reduced(), d_model=256,
                  n_heads=8, n_kv_heads=1, head_dim=128, d_ff=512)
    return replace(cfg, moe=replace(cfg.moe, n_experts=16, top_k=4, d_ff=128,
                                    **moe_kw))


def _routing(routes: list, forced: list = None):
    """``moe._router``, appending each call's ids to ``routes`` (on the
    host); with ``forced`` (ids taken from the front) it routes by those
    instead, with its own weights at them."""
    from repro_torch.models import moe
    router = moe._router

    def recorded(cfg, p, x2d):
        w, ids, aux = router(cfg, p, x2d)
        routes.append(ids.cpu())
        if forced is None:
            return w, ids, aux
        ids = forced.pop(0).to(x2d.device)
        probs = torch.softmax(x2d.float() @ p["router"].float(), dim=-1)
        w = torch.gather(probs, 1, ids)
        return w / w.sum(-1, keepdim=True), ids, aux
    return recorded


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_moe_prefill_and_decode_on_the_card(dev, f32):
    """The narrow MoE stack through the model path on the card (a
    flash_attention launch in every prefill layer, none in decode) against
    the same bundle on the CPU. With f32 parameters and cache the routes
    agree and logits within 1e-3. In bf16 cuBLAS and the CPU round some
    products one ulp apart, which can flip a near-tied route: at least 80%
    of the routes agree, and with the CPU's routes forced on the card the
    logits agree within 0.1 (tests/test_torch_moe_model.py's bound)."""
    from unittest import mock

    from repro_torch.configs.base import ArchConfig, ShapeConfig
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model, moe
    cfg = _narrow_moe_cfg()
    arch = ArchConfig(model=cfg)
    seq, batch, steps = 128, 2, 4
    dt = torch.float32 if f32 else torch.bfloat16
    key = (batch, seq, seq, 8, 1, 128, True, 0, dt)
    gen = torch.Generator().manual_seed(0)
    params, cache, _, _ = model.init_inputs(model.make_step_bundle(
        arch, ShapeConfig("d", seq, batch, "decode"),
        make_host_mesh(device="cpu")), gen, "cpu")
    if f32:
        params, cache = (tree_map(lambda t: t.float(), tree)
                         for tree in (params, cache))
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         dtype=torch.int32)
    out, cpu_routes = {}, []
    for where in ("cpu", dev):
        env = make_host_mesh(device=where)
        pre = model.make_step_bundle(arch, ShapeConfig("p", seq, batch,
                                                       "prefill"), env)
        dec = model.make_step_bundle(arch, ShapeConfig("d", seq, batch,
                                                       "decode"), env)
        p = tree_map(lambda t: t.to(where), params)
        c = tree_map(lambda t: t.to(where), cache)
        routes = []
        forced = None if where == "cpu" or f32 else list(cpu_routes)
        ops.reset_launch_counts()
        with mock.patch.object(moe, "_router", _routing(routes, forced)):
            logits = pre.fn(p, {"tokens": toks.to(where)})
            counted = ops.launch_counts_by_shape()["flash_attention"]
            for t in range(steps):
                step, c = dec.fn(p, c, toks[:, t:t + 1].to(where),
                                 torch.full((batch,), t, dtype=torch.int32,
                                            device=where))
        assert ops.launch_counts_by_shape()["flash_attention"] == counted
        if where == "cpu":
            cpu_routes = routes
        out[str(where)] = (logits.cpu(), step.cpu(), counted, routes)
    cpu, card = out["cpu"], out[str(dev)]
    assert cpu[2] == {} and card[2] == {key: cfg.num_layers}
    same = [float((a == b).float().mean()) for a, b in zip(card[3], cpu[3])]
    assert len(same) == cfg.num_layers * (1 + steps)
    assert min(same) == 1.0 if f32 else sum(same) / len(same) >= 0.8
    for i in (0, 1):
        torch.testing.assert_close(card[i], cpu[i], atol=1e-3 if f32 else 0.1,
                                   rtol=0)


def test_moe_gather_matches_dense_on_the_card(dev):
    """At ``capacity_factor = E / k`` nothing drops and the gather path
    computes what the dense reference does, in bf16 within
    tests/test_moe.py's 0.06; no kernel of the port launches."""
    from repro_torch.distributed.sharding import init_params
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    cfg = _narrow_moe_cfg(capacity_factor=16 / 4)
    gen = torch.Generator(device=dev).manual_seed(1)
    p = init_params(moe.moe_specs(cfg), gen, dev)
    x = torch.randn((2, 256, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    env = make_host_mesh(device=dev)
    ops.reset_launch_counts()
    yg, aux = moe.apply_moe(cfg, p, x, env, mode="gather")
    yd, _ = moe.apply_moe(cfg, p, x, env, mode="dense")
    assert sum(ops.launch_counts().values()) == 0
    assert float(aux["dropped_frac"]) == 0.0
    assert yg.dtype == torch.bfloat16 and yg.is_cuda
    torch.testing.assert_close(yg.float(), yd.float(), atol=0.06, rtol=0)


def test_moe_gather_is_bit_for_bit_repeatable_on_the_card(dev):
    """Two gather runs on the same input agree bit for bit: the combine
    adds each token's terms in slot order, without atomics (here 2 x 2048
    tokens, some assignments dropped at the config's capacity)."""
    from repro_torch.distributed.sharding import init_params
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    cfg = _narrow_moe_cfg()
    gen = torch.Generator(device=dev).manual_seed(2)
    p = init_params(moe.moe_specs(cfg), gen, dev)
    x = torch.randn((2, 2048, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    env = make_host_mesh(device=dev)
    y1, aux1 = moe.apply_moe(cfg, p, x, env)
    y2, aux2 = moe.apply_moe(cfg, p, x, env)
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))
    assert float(aux1["dropped_frac"]) == float(aux2["dropped_frac"])
