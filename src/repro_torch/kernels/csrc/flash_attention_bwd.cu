// flash_attention_bwd: the gradient of flash_attention. Given q [B,Sq,Hq,hd],
// k and v [B,Sk,Hkv,hd], the forward's output o and its row log-sum-exp
// lse [B,Hq,Sq] (f32, of the scaled and masked scores) and the output's
// gradient do, it writes dq, dk and dv in q's dtype (f32 or bf16) with f32
// sums. Causal and/or sliding window, GQA (dk and dv sum over the query
// heads of their group), Sq != Sk, hd in {16, 32, 64, 128}. Query row i
// sits at position i + q_base in both masks (a chunk of a longer sequence
// whose k and v cover it: context-parallel prefill; 0 otherwise), key j at
// j: the masks compare positions, while addresses and the row bound
// (i < Sq) keep the row index. (q_base is this file's name for the
// forward's q_off, since q_off names memory offsets here.) Two sets of
// kernels behind one entry point, as in flash_attention.cu: f32 on the FMA
// units, bf16 on the tensor cores (namespace tc).
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
// * dkdv_kernel: a block owns the keys of one KV head and walks, for each
//   query head of the group in turn, the query tiles that see them; dK
//   and dV stay in registers;
// * dq_kernel: a block owns the queries of one head and walks the key
//   tiles they see; dQ stays in registers.
// S and dP are recomputed in both kernels: seven products where the bound
// counts five. Masked pairs (the causal and window masks, keys past Sk,
// queries past Sq) take P = 0 by a test, never by exp of -1e30 minus the
// lse, so a row that sees no key (its lse is -1e30 or -inf) gives no
// inf - inf: it gets a zero dq and adds nothing to dk and dv. The
// convention for such rows: the plain version (and the JAX package, whose
// mask is the same finite -1e30) gives them a uniform softmax over every
// key and so spreads their gradient evenly over v; the kernel gives them
// none. The two agree on the rows that see a key, which is where the
// tests hold them. No model path makes such a row: it needs a window
// shorter than Sq - Sk + q_base, or a query offset past every key under
// a window. A key that no query sees (at a cp shard, every key past the
// shard's last position) gets exact zeros in dk and dv: its block's walk
// is empty and writes its zero sums.
//
// What bounds it on an H100: operations. At the Yi-6B prefill key (2 x
// 4096, 32 query and 4 KV heads of 128, causal) the gradient is 2.5 times
// the forward's 275 GFLOP, 0.695 ms at the 989 TFLOP/s of the bf16 tensor
// cores.
//
// ---- f32 (the serving precision) ----
// All five products on the FMA units in f32 (67 TFLOP/s): register tiles
// of 4 x 4 scores and 4 x hd/16 outputs a thread over 64 x 64 tiles,
// operands in shared memory as f32 rows padded by 4 floats so 16-byte
// reads of 8 neighbouring rows do not conflict.
//
// ---- bf16 (the dense and enc-dec training paths) ----
// Every product on the tensor cores (wgmma, f32 accumulators), each in a
// form the forward's kernel already uses, so no new descriptor layout:
//   kernel   product                A                     B
//   dK/dV    S^T = K Q^T, dP^T = V dO^T   K, V (smem)      Q, dO (smem, K-major)
//   dK/dV    dV += P^T dO, dK += dS^T Q   registers        dO, Q (smem, MN-major)
//   dQ       S = Q K^T, dP = dO V^T       Q, dO (smem)     K, V (smem, K-major)
//   dQ       dQ += dS K                   registers        K (smem, MN-major)
// The register A operands are P^T, dS^T and dS in wgmma's fragment layout,
// which is the layout of the S^T or S accumulator they come from.
// * A block is two warpgroups and 128 rows of its own (keys in dK/dV,
//   queries in dQ), 64 a warpgroup; it walks tiles of 64 of the other
//   side. Q, K, V and dO stay bf16 in shared memory, 64-column atoms of
//   128-byte rows with the 128-byte swizzle (hd < 64 zero-padded to 64;
//   padded columns of dq, dk and dv are not stored). The block's own rows
//   are loaded once; the walked tiles (dK/dV: Q, dO and the 64 queries'
//   lse and D; dQ: K and V) sit in a ring of 4 stages, filled two tiles
//   ahead by cp.async copies that complete on the stage's full mbarrier
//   and freed when every warp has arrived on its empty mbarrier. No
//   barrier spans the block inside the loop, so the two warpgroups drift
//   apart and each runs its products while the other forms P and dS.
// * A tile is two commit groups, each waited out before its results are
//   read: the two products into S (S^T) and dP (dP^T), then, after P and
//   dS are formed in registers of their own, the one or two products into
//   the accumulators. No register of a product in flight is written (the
//   forward's rule: ptxas serializes wgmma otherwise), and none is live
//   from one tile to the next but dK, dV or dQ, which at hd = 128 keeps
//   dK/dV's 128 accumulators, the 64 of S^T and dP^T and the 32 fragment
//   registers within a thread's 255. Forming P and dS while the other
//   products of the warpgroup run (three or four groups a tile, dS from
//   the bf16 P) measured 3-7% slower on an H100 than this schedule, whose
//   overlap comes from the other warpgroup (PERF.md).
// * Precision: P and dS are rounded once to bf16 as the A operand, with
//   f32 sums (FlashAttention-2's and -3's choice); every bf16 x bf16
//   product is exact in f32. P is exp2(S scale log2 e - lse log2 e) on
//   ex2.approx.
// * The dK/dV grid is one line of (128-key block, batch * KV head), the
//   dQ grid of (128-query block, batch * head), so the heaviest causal
//   blocks launch first. A tile is masked only where the mask cuts it; a
//   tile that no row of a warpgroup sees is masked whole (P = 0) rather
//   than skipped, since a branch around a product serializes wgmma.
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

// whether query row qi (at position qi + q_base) sees key kj
__device__ __forceinline__ bool visible(int qi, int kj, int sq, int sk,
                                        int causal, int window, int q_base) {
  const int qp = qi + q_base;
  bool v = qi < sq && kj < sk;
  if (causal) v = v && qp >= kj;
  if (window) v = v && qp - kj < window;
  return v;
}

// whether any pair of the query tile at position qp0 and the key tile at
// k0 is visible (the forward's test, on 64 x 64 tiles)
__device__ __forceinline__ bool tile_visible(int qp0, int k0, int causal,
                                             int window) {
  bool v = true;
  if (causal) v = qp0 + BQ - 1 >= k0;
  if (window) v = v && qp0 - (k0 + BK - 1) < window;
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
// (the first; a query offset moves every query's causal run by the same
// number of keys, so the first stay the heaviest) launching first. Thread
// (ty, tx) of the 16 x 16 grid owns keys ty + 16 i (i < 4); in the score
// tiles queries tx + 16 j, in dK and dV columns tx * HD / 16 .. + HD / 16
// - 1.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int hq,
            int hkv, int causal, int window, int q_base, float scale,
            int nbkv) {
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
      if (!tile_visible(q0 + q_base, k0, causal, window)) continue;
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
          const bool vis = visible(q0 + qr, k0 + ty + 16 * i, sq, sk,
                                   causal, window, q_base);
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
// tiles (the last, at any query offset) launching first. Thread (ty, tx)
// owns queries ty + 16 i; in the score tiles keys tx + 16 j, in dQ
// columns tx * HD / 16 .. + HD / 16 - 1.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          T* __restrict__ dq, int sq, int sk, int hq, int hkv, int causal,
          int window, int q_base, float scale, int nbh) {
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
    if (!tile_visible(q0 + q_base, k0, causal, window)) continue;
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
        const bool vis = visible(q0 + qr, k0 + tx + 16 * j, sq, sk, causal,
                                 window, q_base);
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
           int causal, int window, int q_base, float scale,
           cudaStream_t stream) {
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
      sq, sk, hq, hkv, causal, window, q_base, scale, b * hkv);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const int nqt = (sq + BQ - 1) / BQ;
  dq_kernel<T, HD><<<nqt * b * hq, THREADS, dq_smem<HD>(), stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dq), sq, sk, hq, hkv,
      causal, window, q_base, scale, b * hq);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* dsum, void* dq,
             void* dk, void* dv, int b, int sq, int sk, int hq, int hkv,
             int hd, int causal, int window, int q_base, float scale,
             cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq,
                           sk, hq, hkv, causal, window, q_base, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq,
                           sk, hq, hkv, causal, window, q_base, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq,
                           sk, hq, hkv, causal, window, q_base, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq,
                            sk, hq, hkv, causal, window, q_base, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- bf16: the tensor-core kernels --------------------------------------

namespace tc {

// The helpers below are copies of flash_attention.cu's (its tc namespace):
// swz, desc, the wgmma fences and products, hold, TileCopy with its
// cp.async copies and mbarriers, and the zero padding of hd < 64. That
// source is not shared: its wgmma pipeline is fragile in ptxas, and an
// edit made for the backward must not move the forward's code.

constexpr int BM = 128;      // rows a block (keys in dK/dV, queries in dQ)
constexpr int BN = 64;       // rows of the walked tile (queries / keys)
constexpr int STAGES = 4;    // depth of the ring of walked tiles
constexpr int THREADS = 256; // two warpgroups, 64 block rows each

// head dim in shared memory: whole 64-column swizzle atoms, hd < 64
// zero-padded (zero columns add nothing to a product over hd, and give
// output columns that are not stored)
__host__ __device__ constexpr int padded(int hd) { return hd < 64 ? 64 : hd; }

template <int HD>
constexpr size_t smem_bytes() {
  // two tiles of BM rows, STAGES pairs of tiles of BN rows, STAGES pairs
  // of BN f32 row values (dK/dV: lse and D of the queries), a full and an
  // empty barrier a stage, and room to align the start to 1024 bytes
  return size_t(2) * padded(HD) * 2 * (BM + STAGES * BN) +
         size_t(8) * STAGES * BN + 16 * STAGES + 1024;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (columns 8c .. 8c + 7) of row r in a
// tile of `rows` rows, stored as 64-column atoms of 128-byte rows with the
// 128-byte swizzle (chunk XOR row mod 8): the layout wgmma's SWIZZLE_128B
// descriptors read, and conflict-free for the 16-byte copies. Atoms start
// on 1024-byte boundaries.
__device__ __forceinline__ uint32_t swz(int rows, int r, int c) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0));
}

// the padding chunks (columns HD .. 63) of a tile of `rows` rows, zeroed
// by the whole block
template <int HD>
__device__ __forceinline__ void zero_pad(unsigned char* tile, int rows) {
  constexpr int PAD = 8 - HD / 8;  // padding chunks a row
  for (int idx = threadIdx.x; idx < rows * PAD; idx += THREADS) {
    const int r = idx / PAD, c = HD / 8 + idx % PAD;
    *reinterpret_cast<uint4*>(tile + swz(rows, r, c)) = make_uint4(0, 0, 0, 0);
  }
}

// wgmma shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of r across the
// asynchronous products
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[64 x 16]^T: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers, B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, "
      "p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A in registers, B MN-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, "
      "p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit; results below 2^-126 flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A thread's share of a tile of ROWS rows of a [rows, heads, HD] slab:
// 16-byte chunk c of tile rows r0 + RP i, at the same offsets in every
// tile, so only the slab and the tile's first row move from one tile to
// the next
template <int HD, int ROWS>
struct TileCopy {
  static constexpr int CH = HD / 8;          // chunks a row
  static constexpr int RP = THREADS / CH;    // rows a pass of the block
  static constexpr int PASSES = ROWS > RP ? ROWS / RP : 1;
  size_t stride;  // elements from one row to the next
  size_t off;     // elements from a slab's row 0 to the thread's chunk
  uint32_t soff;  // the chunk's offset in a tile
  int r0;

  __device__ __forceinline__ explicit TileCopy(size_t stride_)
      : stride(stride_) {
    r0 = threadIdx.x / CH;
    const int c = threadIdx.x % CH;
    off = (size_t)r0 * stride + c * 8;
    soff = swz(ROWS, r0, c);
  }

  // rows row0 .. row0 + ROWS - 1 of the slab into the tile at shared
  // address dst; rows at or past `rows` read as zero
  __device__ __forceinline__ void load(uint32_t dst,
                                       const __nv_bfloat16* slab, int row0,
                                       int rows) const {
    const int n = rows - row0 - r0;  // rows left from the thread's first
    const __nv_bfloat16* src = slab + off + (size_t)row0 * stride;
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      if (RP > ROWS && r0 >= ROWS) break;
      const bool ok = RP * i < n;
      cp_async16(dst + soff + RP * 128 * i,
                 ok ? src + (size_t)RP * i * stride : slab, ok);
    }
  }
};

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
// an arrival on the barrier at bar once this thread's copies so far have
// landed (counted among the barrier's expected arrivals)
__device__ __forceinline__ void mbar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// until the phase of parity `parity` of the barrier at bar has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// d = A B^T for the warpgroup's 64 rows of A (at shared address a, in a
// tile of BM rows) and the BN rows of B (the tile at b): HDP / 16
// products of depth 16, both K-major (the forward's Q K^T)
template <int HDP>
__device__ __forceinline__ void ss_product(float (&d)[BN / 2], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;  // 16 columns, 32 bytes
    wgmma_ss_n64(d, desc(a + (kk >> 2) * BM * 128 + col, 16, 1024),
                 desc(b + (kk >> 2) * BN * 128 + col, 16, 1024), kk > 0);
  }
}

// acc += A B: A [64 x BN] as bf16 register fragments, B the BN x HDP
// tile at b read MN-major (transposed) from its swizzled rows, 16 rows a
// product (the forward's P V)
template <int HDP>
__device__ __forceinline__ void rs_product(float (&acc)[HDP / 2],
                                           const uint32_t (&a)[BN / 16][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t db = desc(b + kk * 16 * 128, BN * 128, 1024);
    if constexpr (HDP == 128) wgmma_rs_n128(acc, a[kk], db);
    else wgmma_rs_n64(acc, a[kk], db);
  }
}

// the bf16 pair (x, y) in one register, x in the low half
__device__ __forceinline__ uint32_t pack(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// whether query row qi (at position qi + q_base) sees key kj
__device__ __forceinline__ bool sees(int qi, int kj, int sq, int sk,
                                     int causal, int window, int q_base) {
  const int qp = qi + q_base;
  bool v = qi < sq && kj < sk;
  if (causal) v = v && qp >= kj;
  if (window) v = v && qp - kj < window;
  return v;
}

// whether some query of positions [qp, qp + nq) sees some key of
// [ka, ka + nk)
__device__ __forceinline__ bool tiles_meet(int qp, int nq, int ka, int nk,
                                           int causal, int window) {
  bool v = true;
  if (causal) v = qp + nq - 1 >= ka;
  if (window) v = v && qp - (ka + nk - 1) < window;
  return v;
}

// whether every query of rows [qa, qa + 64) (positions from qa + q_base)
// sees every key of [ka, ka + 64): such a tile needs no mask
__device__ __forceinline__ bool tile_full(int qa, int ka, int sq, int sk,
                                          int causal, int window,
                                          int q_base) {
  const int qp = qa + q_base;
  bool v = qa + 64 <= sq && ka + 64 <= sk;
  if (causal) v = v && qp >= ka + 63;
  if (window) v = v && qp + 63 - ka < window;
  return v;
}

// P and dS of one 64 x 64 tile of the warpgroup, as bf16 A fragments:
// element e of s and dp (s[4 j + e], the accumulator layout) is row
// r0 + 8 (e >> 1), column 8 j + t2 + (e & 1); register r of column chunk
// kk holds elements 8 kk + 2 r, + 1. P = exp2(s scale2 - lse2) where the
// pair is visible (lse2 = lse log2 e of its query), else 0; dS = P (dp -
// D). QROWS: the rows are queries (dQ) or keys (dK/dV, P^T and dS^T).
// lse2(i) and dd(i) give the query values of element i; query row qi sits
// at position qi + q_base.
template <bool QROWS, typename L, typename Dv>
__device__ __forceinline__ void p_ds(const float (&s)[BN / 2],
                                     const float (&dp)[BN / 2],
                                     uint32_t (&pf)[BN / 16][4],
                                     uint32_t (&dsf)[BN / 16][4], bool full,
                                     int row0, int col0, int r0, int t2,
                                     float scale2, int sq, int sk,
                                     int causal, int window, int q_base,
                                     L lse2, Dv dd) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float p[2], ds[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i = 8 * kk + 2 * r + x;
        float v = ex2(fmaf(s[i], scale2, -lse2(i)));
        if (!full) {
          const int row = row0 + r0 + 8 * ((i & 3) >> 1);
          const int col = col0 + 8 * (i >> 2) + t2 + (i & 1);
          const bool vis =
              QROWS ? sees(row, col, sq, sk, causal, window, q_base)
                    : sees(col, row, sq, sk, causal, window, q_base);
          v = vis ? v : 0.f;
        }
        p[x] = v;
        ds[x] = v * (dp[i] - dd(i));
      }
      pf[kk][r] = pack(p[0], p[1]);
      dsf[kk][r] = pack(ds[0], ds[1]);
    }
}

// One block per (batch * kv head, 128 keys), the heaviest causal key
// blocks (the first, at any query offset) launching first. Warpgroup w
// owns keys k0 + 64 w .. + 63 and walks, for each query head of the group
// in turn, the 64-query tiles that the block's keys see; a thread owns
// key rows r0 and r0 + 8 of them, and in each 8 columns of S^T or dK, dV
// columns t2 and t2 + 1.
// K and V are loaded once; Q, dO and their queries' lse and D come
// through the ring.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int sq, int sk, int hq, int hkv, int causal, int window,
            int q_base, float scale, int nbkv) {
  constexpr int HDP = padded(HD);
  constexpr int MB = BM * HDP * 2;  // bytes of the K or V tile
  constexpr int NB = BN * HDP * 2;  // bytes of one Q or dO tile
  constexpr int NO = HDP / 2;       // dK or dV accumulators a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t Ks = (raw + 1023) & ~1023u;
  const uint32_t Vs = Ks + MB, Qs = Vs + MB, dOs = Qs + STAGES * NB;
  const uint32_t rows_s = dOs + STAGES * NB;  // [STAGES][2][BN] f32
  unsigned char* tiles = smem_raw + (Ks - raw);
  const float* rows = reinterpret_cast<const float*>(tiles + (rows_s - Ks));

  const int kt = blockIdx.x / nbkv;
  const int bk = blockIdx.x % nbkv;
  const int b = bk / hkv, kvh = bk % hkv;
  const int group = hq / hkv;
  const int k0 = kt * BM;
  const int wg = threadIdx.x >> 7;
  const int wl = threadIdx.x & 127;
  const int r0 = ((wl >> 5) << 4) + ((wl & 31) >> 2);
  const int t2 = (wl & 3) * 2;
  const int kw = k0 + 64 * wg;  // the warpgroup's first key

  const size_t q_stride = (size_t)hq * HD;
  const size_t kv_stride = (size_t)hkv * HD;
  const __nv_bfloat16* qb = q + (size_t)b * sq * q_stride;
  const __nv_bfloat16* dob = dout + (size_t)b * sq * q_stride;
  const size_t kv_off = (size_t)b * sk * kv_stride + (size_t)kvh * HD;

  // the query tiles the block's keys see form one run [first, last],
  // empty (n = 0) for keys no query sees: the block then writes zeros
  const int nqt = (sq + BN - 1) / BN;
  int first = nqt, last = -1;
  for (int t = 0; t < nqt; ++t)
    if (tiles_meet(t * BN + q_base, BN, k0, BM, causal, window)) {
      first = min(first, t);
      last = t;
    }
  const int n = last - first + 1;  // tiles of the run, for each head
  const int total = group * n;

  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;

  if (total > 0) {
    const uint32_t full_bar = rows_s + 8 * STAGES * BN;  // STAGES of 8 B
    const uint32_t empty_bar = full_bar + 8 * STAGES;
    if constexpr (HD < HDP) {
      zero_pad<HD>(tiles, BM);
      zero_pad<HD>(tiles + MB, BM);
      for (int t = 0; t < 2 * STAGES; ++t)
        zero_pad<HD>(tiles + 2 * MB + t * NB, BN);
      fence_proxy_async();  // the zeros, before the async-proxy reads
    }
    if (threadIdx.x == 0) {
      for (int t = 0; t < STAGES; ++t) {
        mbar_init(full_bar + 8 * t, THREADS);        // every thread's copies
        mbar_init(empty_bar + 8 * t, THREADS / 32);  // every warp's release
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const TileCopy<HD, BN> qc(q_stride);
    // tile t of the walk: query tile first + t % n of head kvh group +
    // t / n, its Q, dO, lse and D into stage t % STAGES
    auto load = [&](int t) {
      const int h = kvh * group + t / n;
      const int q0 = (first + t % n) * BN;
      const int st = t % STAGES;
      qc.load(Qs + st * NB, qb + (size_t)h * HD, q0, sq);
      qc.load(dOs + st * NB, dob + (size_t)h * HD, q0, sq);
      if (threadIdx.x < 2 * BN) {
        const int i = threadIdx.x & (BN - 1);
        const float* src = (threadIdx.x < BN ? lse : dsum) +
                           ((size_t)b * hq + h) * sq;
        const bool ok = q0 + i < sq;
        cp_async4(rows_s + 4 * (st * 2 * BN + threadIdx.x),
                  ok ? src + q0 + i : src, ok);
      }
    };
    // K and V with the first tile, then the second: each thread's copies
    // complete on the stage's full barrier
    const TileCopy<HD, BM> kc(kv_stride);
    kc.load(Ks, k + kv_off, k0, sk);
    kc.load(Vs, v + kv_off, k0, sk);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t < total) load(t);
      mbar_arrive_copies(full_bar + 8 * t);
    }

    const float scale2 = scale * LOG2E;
    const uint32_t ka = Ks + wg * 64 * 128, va = Vs + wg * 64 * 128;
    for (int it = 0; it < total; ++it) {
      const int st = it % STAGES;
      // tile it + 2 into the stage of tile it - 2 once every warp has
      // released it
      if (it + 2 < total) {
        const int sn = (it + 2) % STAGES;
        if (it + 2 >= STAGES)
          mbar_wait(empty_bar + 8 * sn, (((it + 2) / STAGES) & 1) ^ 1);
        load(it + 2);
        mbar_arrive_copies(full_bar + 8 * sn);
      }
      mbar_wait(full_bar + 8 * st, (it / STAGES) & 1);
      // generic-proxy writes (the copies) before the async-proxy reads of
      // wgmma
      fence_proxy_async();
      const uint32_t qs = Qs + st * NB, dos = dOs + st * NB;
      // S^T = K Q^T and dP^T = V dO^T
      float s[BN / 2], dp[BN / 2];
      wg_fence();
      ss_product<HDP>(s, ka, qs);
      ss_product<HDP>(dp, va, dos);
      wg_commit();
      wg_wait<0>();
      hold(s);
      hold(dp);

      const int q0 = (first + it % n) * BN;
      const float* lse_t = rows + st * 2 * BN;
      const float* d_t = lse_t + BN;
      uint32_t pf[BN / 16][4], dsf[BN / 16][4];
      p_ds<false>(s, dp, pf, dsf,
                  tile_full(q0, kw, sq, sk, causal, window, q_base), kw, q0,
                  r0, t2, scale2, sq, sk, causal, window, q_base,
                  [&](int i) {
                    return lse_t[8 * (i >> 2) + t2 + (i & 1)] * LOG2E;
                  },
                  [&](int i) { return d_t[8 * (i >> 2) + t2 + (i & 1)]; });

      // dV += P^T dO, dK += dS^T Q
      wg_fence();
      rs_product<HDP>(dva, pf, dos);
      rs_product<HDP>(dka, dsf, qs);
      wg_commit();
      wg_wait<0>();
      hold(dva);
      hold(dka);
      // the stage is released for later copies, one arrival a warp
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty_bar + 8 * st);
    }
  }

  const size_t out = kv_off;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = kw + r0 + 8 * half;
    if (key >= sk) continue;
    __nv_bfloat16* dkr = dk + out + (size_t)key * kv_stride;
    __nv_bfloat16* dvr = dv + out + (size_t)key * kv_stride;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(&dkr[8 * j + t2]) =
          __floats2bfloat162_rn(dka[4 * j + 2 * half] * scale,
                                dka[4 * j + 2 * half + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(&dvr[8 * j + t2]) =
          __floats2bfloat162_rn(dva[4 * j + 2 * half],
                                dva[4 * j + 2 * half + 1]);
    }
  }
}

// One block per (batch * head, 128 queries), the heaviest causal query
// blocks (the last, at any query offset) launching first. Warpgroup w
// owns queries q0 + 64 w .. + 63 and walks the 64-key tiles the block's
// queries see;
// a thread owns query rows r0 and r0 + 8 and, in each 8 columns of S or
// dQ, columns t2 and t2 + 1. Q and dO are loaded once; K and V come
// through the ring.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          __nv_bfloat16* __restrict__ dq, int sq, int sk, int hq, int hkv,
          int causal, int window, int q_base, float scale, int nbh) {
  constexpr int HDP = padded(HD);
  constexpr int MB = BM * HDP * 2;  // bytes of the Q or dO tile
  constexpr int NB = BN * HDP * 2;  // bytes of one K or V tile
  constexpr int NO = HDP / 2;       // dQ accumulators a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t Qs = (raw + 1023) & ~1023u;
  const uint32_t dOs = Qs + MB, Ks = dOs + MB, Vs = Ks + STAGES * NB;
  unsigned char* tiles = smem_raw + (Qs - raw);

  const int nqb = (sq + BM - 1) / BM;
  const int qt = causal ? nqb - 1 - (int)(blockIdx.x / nbh)
                        : (int)(blockIdx.x / nbh);
  const int bh = blockIdx.x % nbh;
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * BM;
  const int wg = threadIdx.x >> 7;
  const int wl = threadIdx.x & 127;
  const int r0 = ((wl >> 5) << 4) + ((wl & 31) >> 2);
  const int t2 = (wl & 3) * 2;
  const int qw = q0 + 64 * wg;  // the warpgroup's first query

  const size_t q_stride = (size_t)hq * HD;
  const size_t kv_stride = (size_t)hkv * HD;
  const size_t q_off = (size_t)b * sq * q_stride + (size_t)h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * sk * kv_stride + (size_t)kvh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * sk * kv_stride + (size_t)kvh * HD;

  // the key tiles the block's queries see form one run [first, last]
  const int nkt = (sk + BN - 1) / BN;
  int first = nkt, last = -1;
  for (int t = 0; t < nkt; ++t)
    if (tiles_meet(q0 + q_base, BM, t * BN, BN, causal, window)) {
      first = min(first, t);
      last = t;
    }
  const int n = last - first + 1;

  float dqa[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dqa[i] = 0.f;

  if (n > 0) {
    const uint32_t full_bar = Vs + STAGES * NB;  // STAGES barriers of 8 B
    const uint32_t empty_bar = full_bar + 8 * STAGES;
    if constexpr (HD < HDP) {
      zero_pad<HD>(tiles, BM);
      zero_pad<HD>(tiles + MB, BM);
      for (int t = 0; t < 2 * STAGES; ++t)
        zero_pad<HD>(tiles + 2 * MB + t * NB, BN);
      fence_proxy_async();  // the zeros, before the async-proxy reads
    }
    if (threadIdx.x == 0) {
      for (int t = 0; t < STAGES; ++t) {
        mbar_init(full_bar + 8 * t, THREADS);
        mbar_init(empty_bar + 8 * t, THREADS / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // Q and dO with the first K and V tiles, then the second
    const TileCopy<HD, BM> qc(q_stride);
    qc.load(Qs, q + q_off, q0, sq);
    qc.load(dOs, dout + q_off, q0, sq);
    const TileCopy<HD, BN> kc(kv_stride);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t < n) {
        kc.load(Ks + t * NB, kb, (first + t) * BN, sk);
        kc.load(Vs + t * NB, vb, (first + t) * BN, sk);
      }
      mbar_arrive_copies(full_bar + 8 * t);
    }
    // the lse (times log2 e) and D of the thread's two query rows
    float l2[2], dd[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qi = qw + r0 + 8 * half;
      const bool ok = qi < sq;
      l2[half] = ok ? lse[(size_t)bh * sq + qi] * LOG2E : 0.f;
      dd[half] = ok ? dsum[(size_t)bh * sq + qi] : 0.f;
    }

    const float scale2 = scale * LOG2E;
    const uint32_t qa = Qs + wg * 64 * 128, da = dOs + wg * 64 * 128;
    for (int it = 0; it < n; ++it) {
      const int kt = first + it;
      const int st = it % STAGES;
      if (it + 2 < n) {
        const int sn = (it + 2) % STAGES;
        if (it + 2 >= STAGES)
          mbar_wait(empty_bar + 8 * sn, (((it + 2) / STAGES) & 1) ^ 1);
        kc.load(Ks + sn * NB, kb, (kt + 2) * BN, sk);
        kc.load(Vs + sn * NB, vb, (kt + 2) * BN, sk);
        mbar_arrive_copies(full_bar + 8 * sn);
      }
      mbar_wait(full_bar + 8 * st, (it / STAGES) & 1);
      fence_proxy_async();
      const uint32_t ks = Ks + st * NB, vs = Vs + st * NB;
      // S = Q K^T and dP = dO V^T
      float s[BN / 2], dp[BN / 2];
      wg_fence();
      ss_product<HDP>(s, qa, ks);
      ss_product<HDP>(dp, da, vs);
      wg_commit();
      wg_wait<0>();
      hold(s);
      hold(dp);

      const int k0 = kt * BN;
      uint32_t pf[BN / 16][4], dsf[BN / 16][4];
      p_ds<true>(s, dp, pf, dsf,
                 tile_full(qw, k0, sq, sk, causal, window, q_base), qw, k0,
                 r0, t2, scale2, sq, sk, causal, window, q_base,
                 [&](int i) { return l2[(i & 3) >> 1]; },
                 [&](int i) { return dd[(i & 3) >> 1]; });

      // dQ += dS K
      wg_fence();
      rs_product<HDP>(dqa, dsf, ks);
      wg_commit();
      wg_wait<0>();
      hold(dqa);
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty_bar + 8 * st);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = qw + r0 + 8 * half;
    if (row >= sq) continue;
    __nv_bfloat16* dqr = dq + q_off + (size_t)row * q_stride;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(&dqr[8 * j + t2]) =
          __floats2bfloat162_rn(dqa[4 * j + 2 * half] * scale,
                                dqa[4 * j + 2 * half + 1] * scale);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int b, int sq, int sk, int hq, int hkv,
           int causal, int window, int q_base, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool kv_done = false, q_done = false;
  int err = configure(dkdv_kernel<HD>, smem, kv_done);
  if (err) return err;
  err = configure(dq_kernel<HD>, smem, q_done);
  if (err) return err;
  using T = __nv_bfloat16;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  const int rows = b * sq * hq;
  dot_rows_kernel<T, HD><<<(rows + 7) / 8, 256, 0, stream>>>(
      dot, static_cast<const T*>(o), dsum, rows, sq, hq);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const int nkb = (sk + BM - 1) / BM;
  dkdv_kernel<HD><<<nkb * b * hkv, THREADS, smem, stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, hq, hkv, causal, window, q_base, scale, b * hkv);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;

  const int nqb = (sq + BM - 1) / BM;
  dq_kernel<HD><<<nqb * b * hq, THREADS, smem, stream>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dq), sq, sk, hq, hkv,
      causal, window, q_base, scale, b * hq);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* dsum, void* dq,
             void* dk, void* dv, int b, int sq, int sk, int hq, int hkv,
             int hd, int causal, int window, int q_base, float scale,
             cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq, sk,
                        hq, hkv, causal, window, q_base, scale, s);
    case 32:
      return launch<32>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq, sk,
                        hq, hkv, causal, window, q_base, scale, s);
    case 64:
      return launch<64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq, sk,
                        hq, hkv, causal, window, q_base, scale, s);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, b, sq, sk,
                         hq, hkv, causal, window, q_base, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o, dout, dq, dk and dv are
// contiguous in the layouts above; lse and dsum (scratch for D) are f32
// [B, Hq, Sq]. q_base >= 0 is the position of query row 0 in the masks
// (the forward's q_off). Every output element is written. Returns a CUDA
// error code (0 = none).
extern "C" int fm_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dsum, void* dq, void* dk, void* dv,
                                      int b, int sq, int sk, int hq, int hkv,
                                      int hd, int causal, int window,
                                      int q_base, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0 || sk <= 0 || hq <= 0 || hkv <= 0 ||
      hq % hkv != 0 || q_base < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(dsum);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, dout, l, d, dq, dk, dv, b, sq, sk, hq,
                           hkv, hd, causal, window, q_base, scale, s);
  return tc::dispatch(q, k, v, o, dout, l, d, dq, dk, dv, b, sq, sk, hq, hkv,
                      hd, causal, window, q_base, scale, s);
}
