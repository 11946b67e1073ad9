"""The port on the card: its CUDA kernels against their plain versions, the
copy-stream path, the executors and the Mamba-2, dense, MoE, hybrid and
enc-dec model paths. Every test needs an NVIDIA card
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
    floor for outputs near zero. Returns both outputs."""
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
    return got, want


# a chunk of queries at an offset into the keys of the whole sequence
# (context-parallel prefill): (B, Sq, Sk, Hq, Hkv, hd, q_offset), among
# them a ragged chunk and a chunk that ends before the last key
@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,off", [
    (2, 64, 256, 4, 2, 64, 192), (2, 128, 256, 4, 2, 64, 64),
    (1, 100, 300, 4, 2, 128, 200), (1, 256, 1024, 8, 1, 128, 512),
    (2, 64, 64, 2, 1, 16, 0), (1, 96, 320, 4, 4, 32, 130)])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_kernel_at_an_offset(dev, b, sq, sk, hq, hkv, hd,
                                             off, window, dtype):
    """Each kernel at a query offset against its plain version, at the
    tolerances of test_flash_attention_kernel, and the launch counted
    under its offset."""
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(sq + sk + off)
    q, k, v = (_normal(rng, s).to(dev, DTYPES[dtype])
               for s in ((b, sq, hq, hd), (b, sk, hkv, hd), (b, sk, hkv, hd)))
    ops.reset_launch_counts()
    got = flash_attention(q, k, v, causal=True, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert ops.launch_counts_by_shape()["flash_attention"] == {
        (b, sq, sk, hq, hkv, hd, True, window, off, DTYPES[dtype]): 1}
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window,
                                   q_offset=off)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    if dtype == "bfloat16":
        torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                                   rtol=2 ** -7)


@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_shard_rows_equal_the_whole_call(dev, window, dtype):
    """Four chunks of 256 queries at offsets 0, 256, 512 and 768 against
    the keys of all 1024 positions (context-parallel prefill's calls):
    each chunk's rows are bit for bit the whole call's, since the offsets
    are whole query tiles of both kernels (64 and 128 rows) and every row
    sees the same key tiles in the same order."""
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(7)
    q, k, v = (_normal(rng, s).to(dev, DTYPES[dtype])
               for s in ((2, 1024, 8, 128), (2, 1024, 2, 128),
                         (2, 1024, 2, 128)))
    whole = flash_attention(q, k, v, causal=True, window=window)
    for off in (0, 256, 512, 768):
        part = flash_attention(q[:, off:off + 256], k, v, causal=True,
                               window=window, q_offset=off)
        torch.cuda.synchronize()
        assert torch.equal(part, whole[:, off:off + 256]), off


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


# the launch keys of a Whisper-small prefill of 8 x 448 tokens over 1500
# frames (12 heads of 64: the encoder's bidirectional attention, the
# decoder's causal self-attention, its cross-attention; neither length is
# a multiple of the 64-key tile) and of a Jamba prefill of 2 x 4096 (32
# query heads over 8 KV heads of 128, no positions)
@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,causal", [
    (8, 1500, 1500, 12, 12, 64, False), (8, 448, 448, 12, 12, 64, True),
    (8, 448, 1500, 12, 12, 64, False), (2, 4096, 4096, 32, 8, 128, True)],
    ids=["whisper-encoder", "whisper-self", "whisper-cross", "jamba"])
def test_flash_attention_bf16_at_the_hybrid_and_encdec_keys(
        dev, b, sq, sk, hq, hkv, hd, causal):
    """At one bf16 ulp as test_flash_attention_bf16_shapes, and within 1%
    relative L2 over the whole output, which a key tile left out (or a
    ragged tile's tail read as keys) would break."""
    got, want = _bf16_attention_case(dev, b, sq, sk, hq, hkv, hd, causal, 0)
    got, want = got.float(), want.float()
    assert float((got - want).norm() / want.norm()) <= 1e-2


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
                                   "flash_attention": 1,
                                   "flash_attention_bwd": 0, "ssd_scan": 0,
                                   "ssd_scan_bwd": 0, "layout_pack": 0}
    assert ops.launch_counts_by_shape() == {
        "streamed_matmul": {(64, 128, 64): 1},
        "flash_attention": {(1, 64, 64, 2, 2, 64, True, 0, 0,
                             torch.float32): 1},
        "flash_attention_bwd": {}, "ssd_scan": {}, "ssd_scan_bwd": {},
        "layout_pack": {}}


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


def test_pinned_slab_outlives_the_copies_queued_from_it(dev, monkeypatch):
    """A ``pinned_copy`` slab whose every view is dropped while a copy from
    it is still queued (the copy stream held busy by a sleep kernel) is not
    unregistered until that copy's event has completed; then the next
    ``mark`` releases it, and the copy holds the slab's values."""
    import gc
    from repro_torch import device as dv
    unregistered = []
    real = dv._unregister
    ours = {}

    def spy(ptr):
        # whether the copy had landed when this slab was unregistered
        if ptr == ours.get("ptr"):
            unregistered.append(ours["event"].query())
        real(ptr)
    monkeypatch.setattr(dv, "_unregister", spy)
    torch.cuda.synchronize()
    dv.HostToDevice.release_landed()
    host = np.random.default_rng(0).standard_normal(
        64 << 20, dtype=np.float32)             # 256 MiB
    slab = dv.pinned_copy({"w": host})
    ours["ptr"] = slab["w"].ctypes.data
    h2d = dv.HostToDevice(dev)
    with h2d.copies():
        torch.cuda._sleep(1 << 30)              # about half a second
        out = h2d.put(slab["w"])
    ours["event"] = h2d.mark()
    del slab
    gc.collect()
    assert not ours["event"].query(), "the copy landed before the check"
    assert unregistered == []
    ours["event"].synchronize()
    h2d.mark()
    gc.collect()
    assert unregistered == [True]
    assert torch.equal(out.cpu(), torch.from_numpy(host))


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


def _swing_inputs(dev, swing_heads=(1, 4), shape=(2, 512, 6, 64, 128)):
    """Positive x, b and c at the model's chunk (256); in chunk 1 of batch
    row 0, for ``swing_heads``, dt a takes both signs: L rises by 84 nats
    over the chunk's first 64 steps and falls back over the next 16, so
    the output pass's tile right of the apex would factor its decay
    through exp(L_r - L_j) ~ e^83 (and C . S_in through exp(L_r) ~ e^84),
    summed over n: past the f32 range. c is zero on the rows where L is
    above 20, so the reference's rows there stay finite."""
    rng = np.random.default_rng(16)
    (b, s, h, p, n), q = shape, 256
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


def test_ssd_scan_at_the_jamba_prefill_shape(dev):
    """Jamba's Mamba-2 mixer at a 2 x 4096 prefill (128 heads of 64,
    d_state 16, chunk 256) against the chunked form the CPU path runs
    (within 1e-4 of y's scale) and the sequential recurrence (1e-3)."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.ssm import ssd_chunked
    ins = _ssd_inputs(np.random.default_rng(22), 2, 4096, 128, 64, 16, dev)
    got = ssd_scan(*ins, chunk=256)
    want = ssd_chunked(*ins, 256)[0]
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=0)
    torch.testing.assert_close(got, ref.ssd_ref(*ins), atol=1e-3 * scale,
                               rtol=0)


def test_ssd_scan_at_the_jamba_heads_with_a_non_monotone_decay(dev):
    """Jamba's head shape (128 heads of 64, d_state 16) with dt a of both
    signs in a chunk in heads 5 and 70 (test_ssd_scan_with_a_non_monotone
    _decay's swing): held against the recurrence where it is finite."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    ins = _swing_inputs(dev, swing_heads=(5, 70), shape=(2, 512, 128, 64,
                                                         16))
    got = ssd_scan(*ins, chunk=256)
    want = ref.ssd_ref(*ins)
    torch.cuda.synchronize()
    finite = torch.isfinite(want)
    assert finite[0, 256 + 76:256 + 128, [5, 70]].all()
    torch.testing.assert_close(got[finite], want[finite], atol=2e-3,
                               rtol=1e-3)


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
    key = (batch, seq, seq, 8, 1, 128, True, 0, 0, torch.bfloat16)
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
    key = (batch, seq, seq, 8, 1, 128, True, 0, 0, dt)
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


def test_hybrid_prefill_and_decode_on_the_card(dev):
    """The reduced Jamba (one period: 7 Mamba-2 layers, attention at index
    4, MoE on the odd layers) through the model path on the card, f32
    parameters and cache: ``ssd_scan`` in each Mamba-2 layer and
    ``flash_attention`` in the attention layer of the prefill, none in
    decode, against the same bundle on the CPU (routes equal, logits
    within 1e-3)."""
    from unittest import mock

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ArchConfig, ShapeConfig
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model, moe
    cfg = get_arch("jamba-v0.1-52b").model.reduced()
    arch = ArchConfig(model=cfg)
    seq, batch, steps = 96, 2, 4
    gen = torch.Generator().manual_seed(0)
    params, cache, _, _ = model.init_inputs(model.make_step_bundle(
        arch, ShapeConfig("d", seq, batch, "decode"),
        make_host_mesh(device="cpu")), gen, "cpu")
    params, cache = (tree_map(lambda t: t.float(), tree)
                     for tree in (params, cache))
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         dtype=torch.int32)
    out = {}
    for where in ("cpu", dev):
        env = make_host_mesh(device=where)
        pre = model.make_step_bundle(arch, ShapeConfig("p", seq, batch,
                                                       "prefill"), env)
        dec = model.make_step_bundle(arch, ShapeConfig("d", seq, batch,
                                                       "decode"), env)
        p = tree_map(lambda t: t.to(where), params)
        c = tree_map(lambda t: t.to(where), cache)
        routes = []
        ops.reset_launch_counts()
        with mock.patch.object(moe, "_router", _routing(routes)):
            logits = pre.fn(p, {"tokens": toks.to(where)})
            counted = dict(ops.launch_counts())
            for t in range(steps):
                step, c = dec.fn(p, c, toks[:, t:t + 1].to(where),
                                 torch.full((batch,), t, dtype=torch.int32,
                                            device=where))
        assert dict(ops.launch_counts()) == counted
        out[str(where)] = (logits.cpu(), step.cpu(), counted, routes)
    cpu, card = out["cpu"], out[str(dev)]
    assert sum(cpu[2].values()) == 0
    assert card[2]["ssd_scan"] == 7 and card[2]["flash_attention"] == 1
    assert len(card[3]) == 4 * (1 + steps)
    assert all(torch.equal(a, b) for a, b in zip(card[3], cpu[3]))
    for i in (0, 1):
        torch.testing.assert_close(card[i], cpu[i], atol=1e-3, rtol=0)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_encdec_prefill_and_decode_on_the_card(dev, f32):
    """The reduced Whisper (2 encoder and 4 decoder layers over 32 frames)
    through the model path on the card: per prefill one
    ``flash_attention`` launch a layer for the encoder (bidirectional),
    two a decoder layer (causal self-attention, cross-attention of 24
    queries over 32 keys), none in decode, against the same bundle on the
    CPU. Logits within 1e-3 with f32 parameters and cache, within 0.1 in
    bf16 (tests/test_torch_encdec.py's bound)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ArchConfig, ShapeConfig
    from repro_torch.distributed.sharding import tree_map
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model
    cfg = get_arch("whisper-small").model.reduced()
    arch = ArchConfig(model=cfg)
    seq, batch, steps, t_enc = 24, 2, 4, cfg.encoder_seq
    dt = torch.float32 if f32 else torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    params, cache, _, _ = model.init_inputs(model.make_step_bundle(
        arch, ShapeConfig("d", seq, batch, "decode"),
        make_host_mesh(device="cpu")), gen, "cpu")
    frames = torch.randn((batch, t_enc, cfg.d_model), generator=gen).to(dt)
    if f32:
        params, cache = (tree_map(lambda t: t.float(), tree)
                         for tree in (params, cache))
    cache["cross_k"] = torch.randn(cache["cross_k"].shape, generator=gen
                                   ).to(cache["cross_k"].dtype)
    cache["cross_v"] = torch.randn(cache["cross_v"].shape, generator=gen
                                   ).to(cache["cross_v"].dtype)
    toks = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                         dtype=torch.int32)
    out = {}
    for where in ("cpu", dev):
        env = make_host_mesh(device=where)
        pre = model.make_step_bundle(arch, ShapeConfig("p", seq, batch,
                                                       "prefill"), env)
        dec = model.make_step_bundle(arch, ShapeConfig("d", seq, batch,
                                                       "decode"), env)
        p = tree_map(lambda t: t.to(where), params)
        c = tree_map(lambda t: t.to(where), cache)
        ops.reset_launch_counts()
        logits = pre.fn(p, {"frames": frames.to(where),
                            "tokens": toks.to(where)})
        counted = ops.launch_counts_by_shape()["flash_attention"]
        for t in range(steps):
            step, c = dec.fn(p, c, toks[:, t:t + 1].to(where),
                             torch.full((batch,), t, dtype=torch.int32,
                                        device=where))
        assert ops.launch_counts_by_shape()["flash_attention"] == counted
        out[str(where)] = (logits.cpu(), step.cpu(), counted)
    cpu, card = out["cpu"], out[str(dev)]
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    assert cpu[2] == {} and card[2] == {
        (batch, t_enc, t_enc, h, h, hd, False, 0, 0, dt): cfg.encoder_layers,
        (batch, seq, seq, h, h, hd, True, 0, 0, dt): cfg.num_layers,
        (batch, seq, t_enc, h, h, hd, False, 0, 0, dt): cfg.num_layers}
    for i in (0, 1):
        torch.testing.assert_close(card[i], cpu[i],
                                   atol=1e-3 if f32 else 0.1, rtol=0)


# --- training: the flash_attention backward and the train step ---------------

# (B, Sq, Sk, Hq, Hkv, hd, causal, window): GQA, ragged tails, Sq != Sk
# (cross attention), window with and without causal, every head size
FA_BWD_CASES = [(2, 128, 128, 4, 2, 64, True, 0),
                (1, 100, 100, 4, 1, 128, True, 0),
                (2, 77, 150, 4, 4, 32, False, 0),
                (1, 130, 130, 2, 2, 16, True, 48),
                (1, 96, 96, 8, 2, 64, False, 40),
                (1, 64, 200, 2, 1, 128, False, 0)]


def _bwd_inputs(rng, b, sq, sk, hq, hkv, hd, dtype, dev):
    q = _normal(rng, (b, sq, hq, hd)).to(dev, dtype)
    k = _normal(rng, (b, sk, hkv, hd)).to(dev, dtype)
    v = _normal(rng, (b, sk, hkv, hd)).to(dev, dtype)
    do = _normal(rng, (b, sq, hq, hd)).to(dev, dtype)
    return q, k, v, do


def _grads_close(got, want, dtype):
    """dq, dk, dv against autograd of the plain version in f32: relative L2
    <= 1e-2 and max abs <= 2e-2 max|ref| in bf16 (one rounding of each
    output and of O in D = rowsum(dO O)), 1e-4 max|ref| in f32 (summation
    order only)."""
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        g, w = g.float(), w.float()
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        rel = ((g - w).norm() / w.norm()).item()
        lim = 2e-2 if dtype == torch.bfloat16 else 1e-4
        assert err <= lim * scale, (name, err, scale)
        if dtype == torch.bfloat16:
            assert rel <= 1e-2, (name, rel)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,causal,window", FA_BWD_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_forward_keeps_o_and_gives_lse(
        dev, b, sq, sk, hq, hkv, hd, causal, window, dtype):
    """O with the lse pointer equals O without it bit for bit; the lse is
    the log-sum-exp of the scaled, masked f32 scores within 1e-4 (f32
    sums in another order)."""
    import math
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     forward_with_lse)
    rng = np.random.default_rng(sq + sk + hd)
    q, k, v, _ = _bwd_inputs(rng, b, sq, sk, hq, hkv, hd, DTYPES[dtype], dev)
    o, lse = forward_with_lse(q, k, v, causal=causal, window=window)
    assert torch.equal(o, flash_attention(q, k, v, causal=causal,
                                          window=window))
    kk = torch.repeat_interleave(k.float(), hq // hkv, dim=2)
    s = torch.einsum("bqhd,bphd->bhqp", q.float(), kk) / math.sqrt(hd)
    qp = torch.arange(sq, device=dev)[:, None]
    kp = torch.arange(sk, device=dev)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    want = torch.logsumexp(torch.where(mask, s, -torch.inf), dim=-1)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)


# bf16 only: the tensor-core kernels' 128-row blocks at ragged tails (200
# queries, 333 keys), a GQA group of 4 with a window, and hd 32 padded
FA_BWD_BF16_CASES = [(1, 200, 333, 8, 2, 128, True, 0),
                     (1, 300, 300, 8, 2, 64, True, 100),
                     (2, 190, 190, 4, 2, 32, False, 0)]


@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,hd,causal,window,dtype",
    [(*c, d) for c in FA_BWD_CASES for d in sorted(DTYPES)]
    + [(*c, "bfloat16") for c in FA_BWD_BF16_CASES])
def test_flash_attention_bwd_kernel(dev, b, sq, sk, hq, hkv, hd, causal,
                                    window, dtype):
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import forward_with_lse
    rng = np.random.default_rng(7 * sq + sk + hd)
    dt = DTYPES[dtype]
    q, k, v, do = _bwd_inputs(rng, b, sq, sk, hq, hkv, hd, dt, dev)
    o, lse = forward_with_lse(q, k, v, causal=causal, window=window)
    got = fab.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window)
    again = fab.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    window=window)
    torch.cuda.synchronize()
    assert all(g.dtype == dt and g.shape == x.shape
               for g, x in zip(got, (q, k, v)))
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))  # no atomics
    _grads_close(got, fab.plain(q, k, v, do, causal=causal, window=window),
                 dt)


# SHA-256 of the f32 dq, dk, dv bytes at FA_BWD_CASES on the inputs of
# test_flash_attention_bwd_kernel, from the FMA kernels as they were before
# the bf16 path moved to the tensor cores (the "[f32-digest]" lines of
# ``tools/flash_attention_bwd_compare.py --digests`` on an H100)
FA_BWD_F32_SHA256 = {
    (2, 128, 128, 4, 2, 64, True, 0):
        "a05dc9620844660dc1079cbe3b344c0ba9452ab19fc5551685d219c97e3a7e0f",
    (1, 100, 100, 4, 1, 128, True, 0):
        "79f1375076b28d50b392a05b421ba7a1955a9a7f7c4652903eeb45f93d3e88b8",
    (2, 77, 150, 4, 4, 32, False, 0):
        "1b4de65e31f3a2a67311588a07606d22aad0f7b06654db91fa4b973362237ced",
    (1, 130, 130, 2, 2, 16, True, 48):
        "35e896eb5b3c6e853c6985f3af1a2e6677f45a27c4df9703debff64563dfac61",
    (1, 96, 96, 8, 2, 64, False, 40):
        "ff6dcca6e7dfed3e1406393243efc63d5bb1a157899800685364217ca5e11d87",
    (1, 64, 200, 2, 1, 128, False, 0):
        "a99d024a4bfe0ba59a9744c8bf66def723f28ba390829ff0f8ae27c926d7d1db"}


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,causal,window", FA_BWD_CASES)
def test_flash_attention_bwd_f32_outputs_are_unchanged(
        dev, b, sq, sk, hq, hkv, hd, causal, window):
    """The f32 path keeps its FMA kernels: its outputs are bit-equal to
    theirs as recorded."""
    import hashlib
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import forward_with_lse
    rng = np.random.default_rng(7 * sq + sk + hd)
    q, k, v, do = _bwd_inputs(rng, b, sq, sk, hq, hkv, hd, torch.float32,
                              dev)
    o, lse = forward_with_lse(q, k, v, causal=causal, window=window)
    h = hashlib.sha256()
    for t in fab.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     window=window):
        h.update(t.cpu().numpy().tobytes())
    assert h.hexdigest() == FA_BWD_F32_SHA256[
        (b, sq, sk, hq, hkv, hd, causal, window)]


# (Sq, Sk, q_offset, window): the rows at positions past the last key by
# the window or more see no key; the first blind row is Sk + window - 1 -
# q_offset. At offset 48 over 32 keys every row is blind.
@pytest.mark.parametrize("sq,sk,off,window", [
    (96, 40, 0, 16), (96, 64, 32, 16), (32, 32, 48, 8)],
    ids=["offset0", "offset32", "all-blind"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_bwd_row_that_sees_no_key(dev, dtype, sq, sk, off,
                                                  window):
    """A window shorter than Sq - Sk + q_offset leaves the last rows
    without a key: their dq is zero, nothing is inf or NaN, and the rows
    that see keys keep the plain version's gradient (f32 within 1e-4;
    bf16, on the tensor-core kernels, within the bf16 bounds). The plain
    version gives a blind row a uniform softmax over every key, so it is
    held on the seen rows only; where no row sees a key, dk and dv are
    zero. The forward gives a blind row's lse the log of an empty sum
    (-inf) where its query tile meets no key tile, else about -1e30 (the
    masked scores): never NaN or +inf."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import forward_with_lse
    rng = np.random.default_rng(3)
    dt = DTYPES[dtype]
    q, k, v, do = _bwd_inputs(rng, 1, sq, sk, 2, 2, 64, dt, dev)
    o, lse = forward_with_lse(q, k, v, causal=True, window=window,
                              q_offset=off)
    dq, dk, dv = fab.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                         window=window, q_offset=off)
    first_blind = max(0, sk + window - 1 - off)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert torch.isfinite(lse[:, :, :first_blind]).all()
    assert bool((lse[:, :, first_blind:] < -1e29).all())
    assert torch.count_nonzero(dq[:, first_blind:]) == 0
    if first_blind == 0:
        assert torch.count_nonzero(dk) == 0 and torch.count_nonzero(dv) == 0
        return
    seen = slice(0, first_blind)
    want = fab.plain(q[:, seen], k, v, do[:, seen], causal=True,
                     window=window, q_offset=off)
    if dt == torch.bfloat16:
        _grads_close((dq[:, seen], dk, dv), want, dt)
        return
    for got, w in zip((dq[:, seen], dk, dv), want):
        torch.testing.assert_close(got, w, atol=1e-4, rtol=1e-4)


# (B, Sq, Sk, Hq, Hkv, hd, causal, window, q_offset, dtype): the four
# shards of Yi-6B's context-parallel prefill (1024 queries over 4096 keys),
# a ragged bf16 chunk under a window at an offset that is no tile
# multiple, and two f32 chunks (the FMA kernels), one under a window
FA_BWD_OFFSET_CASES = [
    *((2, 1024, 4096, 32, 4, 128, True, 0, off, torch.bfloat16)
      for off in (0, 1024, 2048, 3072)),
    (1, 200, 700, 8, 2, 128, True, 96, 450, torch.bfloat16),
    (1, 100, 300, 4, 2, 64, True, 0, 150, torch.float32),
    (1, 96, 320, 4, 4, 32, True, 64, 130, torch.float32)]


@pytest.mark.parametrize("key", FA_BWD_OFFSET_CASES, ids=str)
def test_flash_attention_bwd_at_an_offset(dev, key):
    """The backward kernel at a query offset against autograd of the plain
    version at that offset (``_grads_close``'s bounds), two runs bit-equal,
    the launch counted under its offset, and exact zeros in dk and dv for
    every key that no query sees (past the chunk's last position, or before
    its first by the window: three quarters of the keys at the first cp
    shard)."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import forward_with_lse
    b, sq, sk, hq, hkv, hd, causal, window, off, dt = key
    rng = np.random.default_rng(sq + sk + off)
    q, k, v, do = _bwd_inputs(rng, b, sq, sk, hq, hkv, hd, dt, dev)
    o, lse = forward_with_lse(q, k, v, causal=causal, window=window,
                              q_offset=off)
    ops.reset_launch_counts()
    got = fab.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window, q_offset=off)
    again = fab.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    window=window, q_offset=off)
    torch.cuda.synchronize()
    assert ops.launch_counts_by_shape()["flash_attention_bwd"] == {key: 2}
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    qp = torch.arange(sq, device=dev)[:, None] + off
    kp = torch.arange(sk, device=dev)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= qp - kp < window
    unseen = ~mask.any(0)         # none at the last cp shard
    for t in got[1:]:
        assert torch.count_nonzero(t[:, unseen]) == 0
    _grads_close(got, fab.plain(q, k, v, do, causal=causal, window=window,
                                q_offset=off), dt)
    with pytest.raises(ValueError, match="q_offset"):
        fab.flash_attention_bwd(q, k, v, o, lse, do, q_offset=-1)


def test_attention_with_grad_at_an_offset_launches_both_kernels(dev):
    """``ops.attention`` under autograd at a query offset goes through
    ``FlashAttention``: both kernels launch at the offset's key and the
    gradients match the plain version's at that offset."""
    from repro_torch.kernels import flash_attention_bwd as fab
    rng = np.random.default_rng(4)
    q, k, v, _ = _bwd_inputs(rng, 1, 64, 192, 4, 2, 64, torch.bfloat16, dev)
    do = _normal(rng, (1, 64, 4, 64)).to(dev, torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ops.reset_launch_counts()
    ops.attention(q, k, v, q_offset=128).backward(do)
    torch.cuda.synchronize()
    key = (1, 64, 192, 4, 2, 64, True, 0, 128, torch.bfloat16)
    assert ops.launch_counts_by_shape()["flash_attention"] == {key: 1}
    assert ops.launch_counts_by_shape()["flash_attention_bwd"] == {key: 1}
    _grads_close((q.grad, k.grad, v.grad),
                 fab.plain(q, k, v, do, q_offset=128), torch.bfloat16)


def test_attention_with_grad_launches_both_kernels(dev):
    from repro_torch.kernels import flash_attention_bwd as fab
    rng = np.random.default_rng(5)
    q, k, v, do = _bwd_inputs(rng, 2, 64, 64, 4, 2, 64, torch.bfloat16, dev)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ops.reset_launch_counts()
    out = ops.attention(q, k, v)
    out.backward(do)
    torch.cuda.synchronize()
    key = (2, 64, 64, 4, 2, 64, True, 0, 0, torch.bfloat16)
    assert ops.launch_counts_by_shape()["flash_attention"] == {key: 1}
    assert ops.launch_counts_by_shape()["flash_attention_bwd"] == {key: 1}
    _grads_close((q.grad, k.grad, v.grad),
                 fab.plain(q, k, v, do), torch.bfloat16)
    with torch.no_grad():
        ops.attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 2


# (b, s, h, p, n, chunk): a length whose chunk halves (96 % 64 -> 32), the
# Mamba-2 head shape, heads that are no multiple of 4 with a chunk of 128
# (25 heads: 6 groups of 4 and one of 1), Jamba's head shape (d_state 16),
# and the head and state widths of Mamba-2-130M (24 heads: 8 groups of 3)
# and of Jamba (128 heads: 8 groups of 16) at their chunk
SSD_BWD_SHAPES = [(2, 96, 4, 16, 8, 64), (1, 512, 3, 64, 128, 256),
                  (1, 256, 25, 64, 128, 128), (1, 512, 8, 64, 16, 256),
                  (1, 1024, 24, 64, 128, 256), (1, 512, 128, 64, 16, 256)]


def _ssd_bwd_inputs(rng, b, s, h, p, n, chunk, swing, dev):
    """dy and the SSD operands as the model hands them over: x, b and c
    slices of one conv output, dt a transposed view. With ``swing``, dt a
    of heads 0 and 1 takes both signs in batch row 0's first chunk: L
    rises 12 nats over its first quarter and falls 12 over the next
    eighth."""
    from repro_torch.kernels.ssd_scan import chunk_len
    xbc = _normal(rng, (b, s, h * p + 2 * n)).to(dev)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bb, cc = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.nn.functional.softplus(_normal(rng, (b, h, s))).to(dev)
    a = -torch.exp(_normal(rng, (h,), 0.5)).to(dev)
    if swing:
        q = chunk_len(s, chunk)
        up, down = q // 4, q // 8
        a[:2] = -1.0
        dt[0, :2, :q] = 0.05
        dt[0, :2, :up], dt[0, :2, up:up + down] = -12.0 / up, 12.0 / down
    dy = _normal(rng, (b, s, h, p)).to(dev)
    return dy, x, dt.transpose(1, 2), a, bb, cc, _normal(rng, (h,)).to(dev)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_BWD_SHAPES)
@pytest.mark.parametrize("swing", [False, True], ids=["monotone", "swing"])
def test_ssd_scan_bwd_kernel(dev, b, s, h, p, n, chunk, swing):
    """The six gradients against autograd of the plain passes on the same
    inputs (the order of f32 sums only: each within 1e-4 of its largest
    element), x, b, c and dt read as strided views; two runs bit-equal;
    the contiguous inputs give the same gradients bit for bit."""
    from repro_torch.kernels import ssd_scan_bwd as sbw
    from repro_torch.kernels.ssd_scan import ssd_scan_saving
    rng = np.random.default_rng(s + h + n)
    dy, *ins = _ssd_bwd_inputs(rng, b, s, h, p, n, chunk, swing, dev)
    y, saved = ssd_scan_saving(*ins, chunk=chunk)
    got = sbw.ssd_scan_bwd(dy, *ins, y, saved, chunk=chunk)
    again = sbw.ssd_scan_bwd(dy, *ins, y, saved, chunk=chunk)
    flat = [t.contiguous() for t in ins]
    y2, saved2 = ssd_scan_saving(*flat, chunk=chunk)
    dense = sbw.ssd_scan_bwd(dy, *flat, y2, saved2, chunk=chunk)
    want = sbw.plain(dy, *ins, chunk=chunk)
    torch.cuda.synchronize()
    for g, g2, g3, w, t in zip(got, again, dense, want, ins):
        assert g.shape == t.shape and g.is_contiguous()
        assert torch.equal(g, g2) and torch.equal(g, g3)
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * w.abs().max().item())


def test_ssd_gradient_launches_both_kernels(dev):
    """``ops.ssd`` under grad on CUDA: one forward and one backward launch
    by the forward's key, and the leaves' gradients of the plain
    version; without grad, the forward alone."""
    from repro_torch.kernels import ssd_scan_bwd as sbw
    rng = np.random.default_rng(2)
    dy, *ins = _ssd_bwd_inputs(rng, 1, 64, 2, 16, 8, 32, False, dev)
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    ops.reset_launch_counts()
    y = ops.ssd(*leaves, chunk=32)
    y.backward(dy)
    torch.cuda.synchronize()
    key = (1, 64, 2, 16, 8, 32)
    assert ops.launch_counts_by_shape()["ssd_scan"] == {key: 1}
    assert ops.launch_counts_by_shape()["ssd_scan_bwd"] == {key: 1}
    for leaf, w in zip(leaves, sbw.plain(dy, *ins, chunk=32)):
        torch.testing.assert_close(leaf.grad, w, rtol=0,
                                   atol=1e-4 * w.abs().max().item())
    with torch.no_grad():
        ops.ssd(*leaves, chunk=32)
    assert ops.launch_counts()["ssd_scan"] == 2
    assert ops.launch_counts()["ssd_scan_bwd"] == 1


def _tiny_arch(name, remat="full"):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RunConfig
    arch = get_arch(name)
    return replace(arch, model=arch.model.reduced(),
                   run_overrides={"t": RunConfig(microbatch=2, remat=remat)})


def _tiny_train(name, dev, remat="full", f32=False):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model
    arch = _tiny_arch(name, remat)
    bundle = model.make_step_bundle(arch, ShapeConfig("t", 64, 4, "train"),
                                    make_host_mesh(device=dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    params, opt, batch = model.init_inputs(bundle, gen, dev)
    if f32:
        params = shd.tree_map(lambda t: t.float(), params)
    opt["step"].zero_()
    batch["tokens"] = torch.randint(0, arch.model.vocab, (4, 64),
                                    generator=gen, device=dev,
                                    dtype=torch.int32)
    batch["targets"] = torch.roll(batch["tokens"], -1, dims=1)
    return bundle, params, opt, batch


@pytest.mark.parametrize("remat", ["none", "full", "block"])
def test_train_step_on_the_card_remat_keeps_values(dev, remat):
    """A reduced Yi-6B step (2 microbatches) through the kernels: finite
    loss, each attention of each microbatch one forward launch (two under
    remat: the recompute) and one backward launch, and the same loss and
    parameters whatever the remat."""
    from repro_torch.distributed import sharding as shd
    bundle, params, opt, batch = _tiny_train("yi-6b", dev, remat)
    base_b, base_p, base_o, _ = _tiny_train("yi-6b", dev, "none")
    ops.reset_launch_counts()
    params, opt, m = bundle.fn(params, opt, batch)
    torch.cuda.synchronize()
    n = bundle.arg_specs[0]["blocks"]["attn"]["wq"].shape[0] * 2
    counts = ops.launch_counts()
    assert counts["flash_attention"] == n * (1 if remat == "none" else 2)
    assert counts["flash_attention_bwd"] == n
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    base_p, _, bm = base_b.fn(base_p, base_o, batch)
    assert torch.equal(m["loss"], bm["loss"])
    assert all(torch.equal(a, b) for a, b in zip(
        shd.tree_leaves(params), shd.tree_leaves(base_p)))


def test_train_step_on_the_card_matches_the_plain_versions(dev):
    """The same f32 step with attention through the kernels and through
    flash_attention_ref on the card: losses within 1e-5 relative,
    gradient norms within 1e-4 relative, and two kernel runs bit-equal."""
    import contextlib
    from unittest import mock
    from repro_torch.distributed import sharding as shd
    runs = []
    for plain in (False, False, True):
        bundle, params, opt, batch = _tiny_train("yi-6b", dev, f32=True)
        ctx = mock.patch.object(ops, "attention", ref.flash_attention_ref) \
            if plain else contextlib.nullcontext()
        with ctx:
            params, opt, m = bundle.fn(params, opt, batch)
        runs.append((m, shd.tree_leaves(params)))
    (m1, p1), (m2, p2), (m3, _) = runs
    assert torch.equal(m1["loss"], m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    torch.testing.assert_close(m1["loss"], m3["loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(m1["grad_norm"], m3["grad_norm"], rtol=1e-4,
                               atol=0)


def test_train_bundles_of_moe_hybrid_and_ssm_match_the_plain(dev):
    """Reduced Qwen3-30B-A3B, Jamba-v0.1-52B and Mamba-2 steps in f32
    through the kernels (each attention and Mamba-2 layer of each of 2
    microbatches: one forward launch, two under remat, and one backward)
    against the same steps with ``ops.attention`` and ``ops.ssd`` through
    their plain versions on the card (the MoE layers route alike in f32):
    losses within 1e-5 relative, gradient norms within 1e-4, and two
    kernel runs bit-equal."""
    import contextlib
    from unittest import mock
    from repro_torch.distributed import sharding as shd
    for name in ("qwen3-moe-30b-a3b", "jamba-v0.1-52b", "mamba2-130m"):
        runs = []
        for plain in (False, False, True):
            bundle, params, opt, batch = _tiny_train(name, dev, f32=True)
            ops.reset_launch_counts()
            ctx = contextlib.ExitStack()
            if plain:
                ctx.enter_context(mock.patch.object(
                    ops, "ssd", lambda *a, chunk: ref.ssd_ref(*a)))
                ctx.enter_context(mock.patch.object(
                    ops, "attention", ref.flash_attention_ref))
            with ctx:
                params, opt, m = bundle.fn(params, opt, batch)
            torch.cuda.synchronize()
            runs.append((m, shd.tree_leaves(params), ops.launch_counts()))
        (m1, p1, c1), (m2, p2, _), (m3, _, c3) = runs
        cfg = _tiny_arch(name).model
        kinds = {k: cfg.layer_kinds().count(k) * 2 for k in ("attn", "ssm")}
        passes = 1 if cfg.family == "hybrid" else 2
        assert c1["flash_attention"] == passes * kinds["attn"], name
        assert c1["flash_attention_bwd"] == kinds["attn"], name
        assert c1["ssd_scan"] == passes * kinds["ssm"], name
        assert c1["ssd_scan_bwd"] == kinds["ssm"], name
        assert sum(c3.values()) == 0, name
        assert torch.isfinite(m1["loss"]) and torch.isfinite(m1["grad_norm"])
        assert torch.equal(m1["loss"], m2["loss"]), name
        assert all(torch.equal(a, b) for a, b in zip(p1, p2)), name
        torch.testing.assert_close(m1["loss"], m3["loss"], rtol=1e-5, atol=0)
        torch.testing.assert_close(m1["grad_norm"], m3["grad_norm"],
                                   rtol=1e-4, atol=0)


def test_moe_backward_is_bit_equal_across_runs(dev):
    """The MoE layer's gradients at Qwen3-30B-A3B's widths (d_model 2048,
    128 experts of width 768, top-8) over 2 x 512 bf16 tokens: two runs
    bit-equal at the config's capacity (some assignments dropped: the
    dispatch adds a token's slots in slot order and the combine writes
    unique rows, no atomics), and at capacity E / k the gather path's
    gradients within 1e-2 relative L2 of the dense mode's (the same
    products over every token, summed in another order)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import init_params
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    cfg = get_arch("qwen3-moe-30b-a3b").model
    env = make_host_mesh(device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    p = init_params(moe.moe_specs(cfg), gen, dev)
    x = torch.randn((2, 512, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(torch.bfloat16)

    def grads(c, mode):
        leaves = {k: v.detach().clone().requires_grad_() for k, v in
                  p.items()}
        xg = x.detach().clone().requires_grad_()
        y, aux = moe.apply_moe(c, leaves, xg, env, mode=mode)
        torch.autograd.backward(
            (y, aux["lb_loss"], aux["z_loss"]),
            (dy, torch.tensor(0.01, device=dev),
             torch.tensor(0.001, device=dev)))
        torch.cuda.synchronize()
        return {"x": xg.grad, **{k: v.grad for k, v in leaves.items()}}, aux
    (g1, aux1), (g2, _) = grads(cfg, "gather"), grads(cfg, "gather")
    assert float(aux1["dropped_frac"]) > 0.0
    for k in g1:
        assert torch.isfinite(g1[k]).all(), k
        assert torch.equal(g1[k].view(torch.uint8), g2[k].view(torch.uint8)), k
    full = replace(cfg, moe=replace(cfg.moe, capacity_factor=128 / 8))
    (gg, aux), (gd, _) = grads(full, "gather"), grads(full, "dense")
    assert float(aux["dropped_frac"]) == 0.0
    for k in gg:
        err = (gg[k].float() - gd[k].float()).norm() / gd[k].float().norm()
        assert err <= 1e-2, (k, err.item())
