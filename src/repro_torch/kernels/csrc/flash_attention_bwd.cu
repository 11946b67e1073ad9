// flash_attention_bwd: the gradient of flash_attention. Given q [B,Sq,Hq,hd],
// k and v [B,Sk,Hkv,hd], the forward's output o and its row log-sum-exp
// lse [B,Hq,Sq] (f32, of the scaled and masked scores) and the output's
// gradient do, it writes dq, dk and dv in q's dtype (f32 or bf16) with f32
// math. Causal and/or sliding window, GQA (dk and dv sum over the query
// heads of their group), Sq != Sk, hd in {16, 32, 64, 128}.
//
// Replaces no Pallas kernel: the JAX package differentiates plain jnp
// attention with jax.value_and_grad (src/repro/training/trainer.py), and
// its Pallas flash_attention (src/repro/kernels/flash_attention.py) has no
// backward. On the card the forward is the hand-written kernel, so its
// gradient is one too.
//
// The computation (FlashAttention-2's backward): with P = exp(scale S -
// lse) recomputed tile by tile from q, k and lse,
//   D  = rowsum(dO * O)                  (pre-pass, one warp a row)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dQ = scale dS K,  dK = scale dS^T Q.
// Three launches and no atomics, so two runs give equal bits:
// * dot_rows_kernel: D, f32 [B,Hq,Sq];
// * dkdv_kernel: a block owns 64 keys of one KV head and walks, for each
//   query head of the group in turn, the query tiles that see them; dK
//   and dV stay in registers;
// * dq_kernel: a block owns 64 queries of one head and walks the key tiles
//   they see; dQ stays in registers.
// Masked pairs (the causal and window masks, keys past Sk, queries past
// Sq) take P = 0 by a test, never by exp of -1e30 minus the lse, so a row
// that sees no key (its lse is -1e30 or -inf) gives no inf - inf: it gets
// a zero dq and adds nothing to dk and dv. (The plain version spreads such
// a row's gradient evenly over v; no model path makes one: they need a
// window shorter than Sq - Sk.)
//
// What bounds it on an H100: operations. At the Yi-6B prefill key (2 x
// 4096, 32 query and 4 KV heads of 128, causal) the gradient is 2.5 times
// the forward's 275 GFLOP, 0.695 ms at the 989 TFLOP/s of the bf16 tensor
// cores. This first version runs all five products on the FMA units in
// f32 (67 TFLOP/s), with the recomputation of S and dP in both kernels
// (seven products where the bound counts five): register tiles of 4 x 4
// scores and 4 x hd/16 outputs a thread, operands in shared memory as f32
// rows padded by 4 floats so 16-byte reads of 8 neighbouring rows do not
// conflict. Tensor cores (wgmma), TMA and one fused dQ/dK/dV pass are the
// work of a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BQ = 64;        // queries a tile
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int PS = BK + 4;    // row stride of the P and dS tiles
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [0, 64) of a [rows, heads, HD] slab (row stride `stride` elements)
// into a shared f32 tile of row stride HD + 4; rows at or past n read as 0
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          size_t stride, int n) {
  constexpr int LD = HD + 4;
  for (int idx = threadIdx.x; idx < 64 * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD;
    dst[r * LD + c] = r < n ? ld(src + (size_t)r * stride + c) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qi, int kj, int sq, int sk,
                                        int causal, int window) {
  bool v = qi < sq && kj < sk;
  if (causal) v = v && qi >= kj;
  if (window) v = v && qi - kj < window;
  return v;
}

// whether any pair of the query tile at q0 and the key tile at k0 is
// visible (the forward's test, on 64 x 64 tiles)
__device__ __forceinline__ bool tile_visible(int q0, int k0, int causal,
                                             int window) {
  bool v = true;
  if (causal) v = q0 + BQ - 1 >= k0;
  if (window) v = v && q0 - (k0 + BK - 1) < window;
  return v;
}

// acc[i][j] = sum_d A[ra + 16 i][d] B[rb + 16 j][d] over shared f32 tiles
// of row stride HD + 4
template <int HD>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* a,
                                         const float* b, int ra, int rb) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(&a[(ra + 16 * i) * LD + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(&b[(rb + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// out[i][c] += sum_t W[rw + 16 i][t] X[t][c0 + c] for t < 64: W a shared
// [64][PS] tile, X a shared [64][HD + 4] tile, NC = HD / 16 columns
template <int HD>
__device__ __forceinline__ void acc_tile(float (&out)[4][HD / 16],
                                         const float* w, const float* x,
                                         int rw, int c0) {
  constexpr int LD = HD + 4;
  constexpr int NC = HD / 16;
#pragma unroll 4
  for (int t = 0; t < 64; ++t) {
    float xv[NC];
    if constexpr (NC % 4 == 0) {
#pragma unroll
      for (int c = 0; c < NC; c += 4) {
        const float4 f = *reinterpret_cast<const float4*>(&x[t * LD + c0 + c]);
        xv[c] = f.x;
        xv[c + 1] = f.y;
        xv[c + 2] = f.z;
        xv[c + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) xv[c] = x[t * LD + c0 + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float wv = w[(rw + 16 * i) * PS + t];
#pragma unroll
      for (int c = 0; c < NC; ++c) out[i][c] = fmaf(wv, xv[c], out[i][c]);
    }
  }
}

// D[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d], one warp a row
template <typename T, int HD>
__global__ void __launch_bounds__(256)
dot_rows_kernel(const T* __restrict__ dout, const T* __restrict__ o,
                float* __restrict__ dsum, int rows, int sq, int hq) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* a = dout + (size_t)row * HD;
  const T* c = o + (size_t)row * HD;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32) s = fmaf(ld(a + d), ld(c + d), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = row % hq, bi = row / hq;  // row = (b * sq + i) * hq + h
    dsum[((size_t)(bi / sq) * hq + h) * sq + bi % sq] = s;
  }
}

template <int HD>
constexpr size_t dkdv_smem() {
  return sizeof(float) *
         (4 * size_t(64) * (HD + 4) + 2 * size_t(64) * PS + 2 * 64);
}

template <int HD>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * size_t(64) * (HD + 4) + size_t(64) * PS + 2 * 64);
}

// One block per (batch * kv head, key tile), the heaviest causal key tiles
// (the first) launching first. Thread (ty, tx) of the 16 x 16 grid owns
// keys ty + 16 i (i < 4); in the score tiles queries tx + 16 j, in dK and
// dV columns tx * HD / 16 .. + HD / 16 - 1.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int hq,
            int hkv, int causal, int window, float scale, int nbkv) {
  constexpr int LD = HD + 4;
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + 64 * LD;
  float* Qs = Vs + 64 * LD;
  float* dOs = Qs + 64 * LD;
  float* Ps = dOs + 64 * LD;
  float* dSs = Ps + 64 * PS;
  float* lse2 = dSs + 64 * PS;  // lse * log2(e) of the tile's queries
  float* Ds = lse2 + 64;

  const int kt = blockIdx.x / nbkv;
  const int bk = blockIdx.x % nbkv;
  const int b = bk / hkv, kvh = bk % hkv;
  const int group = hq / hkv;
  const int k0 = kt * BK;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int c0 = tx * NC;
  const size_t q_stride = (size_t)hq * HD;
  const size_t kv_stride = (size_t)hkv * HD;
  const size_t kv_off = ((size_t)b * sk + k0) * kv_stride + (size_t)kvh * HD;

  load_tile<T, HD>(Ks, k + kv_off, kv_stride, sk - k0);
  load_tile<T, HD>(Vs, v + kv_off, kv_stride, sk - k0);

  float dkacc[4][NC], dvacc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dkacc[i][c] = dvacc[i][c] = 0.f;
  const float scale2 = scale * LOG2E;
  const int nqt = (sq + BQ - 1) / BQ;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const float* lse_h = lse + ((size_t)b * hq + h) * sq;
    const float* d_h = dsum + ((size_t)b * hq + h) * sq;
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      if (!tile_visible(q0, k0, causal, window)) continue;
      const size_t q_off = ((size_t)b * sq + q0) * q_stride + (size_t)h * HD;
      __syncthreads();  // the previous tile's reads are done
      load_tile<T, HD>(Qs, q + q_off, q_stride, sq - q0);
      load_tile<T, HD>(dOs, dout + q_off, q_stride, sq - q0);
      if (threadIdx.x < 64) {
        const int qi = q0 + threadIdx.x;
        lse2[threadIdx.x] = qi < sq ? lse_h[qi] * LOG2E : 0.f;
        Ds[threadIdx.x] = qi < sq ? d_h[qi] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T for keys ty + 16 i, queries tx + 16 j
      float s[4][4], dp[4][4];
      dot_tile<HD>(s, Ks, Qs, ty, tx);
      dot_tile<HD>(dp, Vs, dOs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          const bool vis =
              visible(q0 + qr, k0 + ty + 16 * i, sq, sk, causal, window);
          const float p = vis ? exp2f(fmaf(s[i][j], scale2, -lse2[qr])) : 0.f;
          Ps[(ty + 16 * i) * PS + qr] = p;
          dSs[(ty + 16 * i) * PS + qr] = p * (dp[i][j] - Ds[qr]);
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q
      acc_tile<HD>(dvacc, Ps, dOs, ty, c0);
      acc_tile<HD>(dkacc, dSs, Qs, ty, c0);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = ty + 16 * i;
    if (k0 + kr >= sk) continue;
    const size_t off = ((size_t)b * sk + k0 + kr) * kv_stride +
                       (size_t)kvh * HD + c0;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      st(dk + off + c, dkacc[i][c] * scale);
      st(dv + off + c, dvacc[i][c]);
    }
  }
}

// One block per (batch * head, query tile), the heaviest causal query
// tiles (the last) launching first. Thread (ty, tx) owns queries
// ty + 16 i; in the score tiles keys tx + 16 j, in dQ columns
// tx * HD / 16 .. + HD / 16 - 1.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          T* __restrict__ dq, int sq, int sk, int hq, int hkv, int causal,
          int window, float scale, int nbh) {
  constexpr int LD = HD + 4;
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + 64 * LD;
  float* Ks = dOs + 64 * LD;
  float* Vs = Ks + 64 * LD;
  float* dSs = Vs + 64 * LD;
  float* lse2 = dSs + 64 * PS;
  float* Ds = lse2 + 64;

  const int nqt = (sq + BQ - 1) / BQ;
  const int qt = causal ? nqt - 1 - (int)(blockIdx.x / nbh)
                        : (int)(blockIdx.x / nbh);
  const int bh = blockIdx.x % nbh;
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * BQ;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int c0 = tx * NC;
  const size_t q_stride = (size_t)hq * HD;
  const size_t kv_stride = (size_t)hkv * HD;
  const size_t q_off = ((size_t)b * sq + q0) * q_stride + (size_t)h * HD;

  load_tile<T, HD>(Qs, q + q_off, q_stride, sq - q0);
  load_tile<T, HD>(dOs, dout + q_off, q_stride, sq - q0);
  if (threadIdx.x < 64) {
    const int qi = q0 + threadIdx.x;
    lse2[threadIdx.x] = qi < sq ? lse[(size_t)bh * sq + qi] * LOG2E : 0.f;
    Ds[threadIdx.x] = qi < sq ? dsum[(size_t)bh * sq + qi] : 0.f;
  }

  float dqacc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dqacc[i][c] = 0.f;
  const float scale2 = scale * LOG2E;
  const int nkt = (sk + BK - 1) / BK;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    if (!tile_visible(q0, k0, causal, window)) continue;
    const size_t kv_off = ((size_t)b * sk + k0) * kv_stride + (size_t)kvh * HD;
    __syncthreads();  // the previous tile's reads are done
    load_tile<T, HD>(Ks, k + kv_off, kv_stride, sk - k0);
    load_tile<T, HD>(Vs, v + kv_off, kv_stride, sk - k0);
    __syncthreads();

    // S and dP for queries ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
    dot_tile<HD>(s, Qs, Ks, ty, tx);
    dot_tile<HD>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = ty + 16 * i;
        const bool vis =
            visible(q0 + qr, k0 + tx + 16 * j, sq, sk, causal, window);
        const float p = vis ? exp2f(fmaf(s[i][j], scale2, -lse2[qr])) : 0.f;
        dSs[qr * PS + tx + 16 * j] = p * (dp[i][j] - Ds[qr]);
      }
    __syncthreads();
    // dQ += dS K
    acc_tile<HD>(dqacc, dSs, Ks, ty, c0);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = ty + 16 * i;
    if (q0 + qr >= sq) continue;
    const size_t off = q_off + (size_t)qr * q_stride + c0;
#pragma unroll
    for (int c = 0; c < NC; ++c) st(dq + off + c, dqacc[i][c] * scale);
  }
}

template <typename F>
int configure(F* kernel, size_t smem, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int b, int sq, int sk, int hq, int hkv,
           int causal, int window, float scale, cudaStream_t stream) {
  static bool kv_done = false, q_done = false;
  int err = configure(dkdv_kernel<T, HD>, dkdv_smem<HD>(), kv_done);
  if (err) return err;
  err = configure(dq_kernel<T, HD>, dq_smem<HD>(), q_done);
  if (err) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  const int rows = b * sq * hq;
  dot_rows_kernel<T, HD><<<(rows + 7) / 8, 256, 0, stream>>>(
      dot, static_cast<const T*>(o), dsum, rows, sq, hq);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const int nkt = (sk + BK - 1) / BK;
  dkdv_kernel<T, HD><<<nkt * b * hkv, THREADS, dkdv_smem<HD>(), stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, hq, hkv, causal, window, scale, b * hkv);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const int nqt = (sq + BQ - 1) / BQ;
  dq_kernel<T, HD><<<nqt * b * hq, THREADS, dq_smem<HD>(), stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dq), sq, sk, hq, hkv,
      causal, window, scale, b * hq);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* dsum, void* dq,
             void* dk, void* dv, int b, int sq, int sk, int hq, int hkv,
             int hd, int causal, int window, float scale, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq,
                           sk, hq, hkv, causal, window, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq,
                           sk, hq, hkv, causal, window, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq,
                           sk, hq, hkv, causal, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq,
                            sk, hq, hkv, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o, dout, dq, dk and dv are
// contiguous in the layouts above; lse and dsum (scratch for D) are f32
// [B, Hq, Sq]. Every output element is written. Returns a CUDA error code
// (0 = none).
extern "C" int fm_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dsum, void* dq, void* dk, void* dv,
                                      int b, int sq, int sk, int hq, int hkv,
                                      int hd, int causal, int window,
                                      float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0 || sk <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(dsum);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, dout, l, d, dq, dk, dv, b, sq, sk, hq,
                           hkv, hd, causal, window, scale, s);
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, l, d, dq, dk, dv, b, sq,
                                 sk, hq, hkv, hd, causal, window, scale, s);
}
