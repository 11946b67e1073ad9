// flash_attention: fused online-softmax attention, causal and/or sliding
// window, GQA (kv head = q head / (Hq / Hkv)), f32 math, output in q's
// dtype (f32 or bf16). q [B,Sq,Hq,hd], k and v [B,Sk,Hkv,hd], contiguous;
// hd in {16, 32, 64, 128}. Query row i sits at absolute position
// i + q_off in both masks (a chunk of a longer sequence whose k and v
// cover it: context-parallel prefill; 0 otherwise), and key j at j.
// Two kernels behind one entry point: f32 runs
// on the FMA units (flash_kernel), bf16 on the tensor cores
// (tc::flash_tc_kernel). Both write, when given an lse pointer, each
// row's log-sum-exp of the scaled and masked scores (f32 [B,Hq,Sq]), the
// input of the backward in flash_attention_bwd.cu; O does not change.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the
// Pallas kernel with grid (B*H, Sq/bq, Sk/bkv) that carries m, l and acc
// in VMEM scratch across the sequential KV axis, skips invisible blocks,
// and computes both dots in f32 from q, k and v cast to f32. On the card
// one block owns one (batch*head, query tile) and walks the visible KV
// tiles in a loop; m, l and acc stay in registers. Masked scores take
// -1e30 as in the Pallas kernel, keys past Sk take no part, and the
// output is acc / max(l, 1e-30). The grid is one line of (query tile,
// batch*head) items, heads fastest, so the heaviest causal query tiles
// of all heads launch first.
//
// ---- f32 (the serving path) ----
// What bounds it on an H100: at the serving shapes (S = 1024, hd = 64 or
// 128, causal) operations, 4 * S^2 * hd * H / 2 FLOP against a few MB of
// q, k, v and o. It stays off the tensor cores: TF32 would not hold the
// 2e-5 tolerance the serving checks were set for, so the work is to keep
// the FMA pipes fed. The design (FlashAttention-2's, on the FMA units),
// 4 warps a block of 64 queries:
// * Each warp owns 16 query rows; its lanes form a 4 x 8 grid, a lane
//   owning rows ty + 4 i (i < 4) and keys tx + 8 j of each KV tile. Row
//   max and row sum reduce over the 8 lanes of a row with shuffles, and P
//   goes through the warp's own slice of shared memory behind __syncwarp,
//   so the softmax needs no block barrier.
// * Q is copied into shared memory once. K and V each have a two-stage
//   ring filled by 16-byte cp.async copies: tile j + 1 is in flight while
//   tile j is computed, with one block barrier a tile. Row strides of
//   hd + 4 floats keep the 16-byte reads of 8 neighbouring key rows
//   conflict-free.
// * KV tiles are 64 keys for hd <= 64 and 32 for hd = 128 (111 KB a
//   block), so two blocks, 8 warps, share an SM at every head size.
// * What bounds it now: a lane's 4 x 4 (hd = 128) or 4 x 8 score tile
//   reads 1.5-2 bytes of shared memory per FMA in QK^T, above the 1 byte
//   per FMA an SM's shared memory can feed at its full FMA rate, so QK^T
//   runs at about half the FMA peak.
//
// ---- bf16 (the dense model path) ----
// What bounds it: operations on the tensor cores. At the Yi-6B prefill
// (2 x 4096, 32 query and 4 KV heads of 128, causal) a call is 275 GFLOP
// (0.278 ms at 989 TFLOP/s) against 151 MB of q, k, v and o (0.045 ms).
// The design (FlashAttention-3's order, simplified), 2 warpgroups a block
// of 128 queries, 64 a warpgroup, one block an SM:
// * Q, K and V stay bf16 in shared memory, 64-column atoms of 128-byte
//   rows with the 128-byte swizzle, the layout wgmma's descriptors read
//   (hd < 64 zero-padded to 64). K and V tiles of 64 keys sit in a ring
//   of 4 stages, filled two tiles ahead by 16-byte cp.async copies that
//   every thread issues for its share; each thread's copies complete on
//   the stage's full mbarrier (cp.async.mbarrier.arrive.noinc), and a
//   stage comes free when every warp has arrived on its empty mbarrier.
//   No barrier spans the block inside the loop.
// * S = Q K^T is wgmma m64n64k16 from shared memory into f32 registers:
//   each bf16 x bf16 product is exact in f32, so S differs from the
//   Pallas kernel's only in the order of summation.
// * P keeps f32 precision: P = P_hi + P_lo with P_hi = bf16(P) and
//   P_lo = bf16(P - P_hi) (16 bits of P, within 2^-16 of it), and
//   O += P_hi V + P_lo V is wgmma m64nHDk16 with P as the register A
//   operand (the S accumulator layout is the A fragment layout) and V
//   read MN-major (transposed) by its descriptor. This costs 1.5x the
//   tensor-core work of a single-bf16 P.
// * An iteration issues S of tile j and P V of tile j - 1 together, then
//   runs the softmax of tile j on the other units while P V runs, into
//   registers of its own (ptxas hoists the wait for P V above any write
//   to an accumulator of a product). O is rescaled only where a row's
//   max moved in the warp. Scores are scaled by scale * log2(e) (folded
//   into the exponent on tiles the mask does not cut) and exponentiated
//   with ex2.approx; only tiles the mask cuts are masked.
// * What bounds it now (PERF.md): a thread's some 650 instructions a tile
//   (softmax, the P split, copies) beside the products; the tensor cores
//   are busy about half the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

constexpr int BQ = 64;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int WROWS = BQ / WARPS;  // query rows a warp owns
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
__host__ __device__ constexpr int kv_tile() { return HD == 128 ? 32 : 64; }

template <int HD>
constexpr size_t smem_bytes() {
  constexpr int BKV = kv_tile<HD>();
  return sizeof(float) * (size_t(BQ) * (HD + 4) + 4 * size_t(BKV) * (HD + 4) +
                          size_t(BQ) * (BKV + 8));
}

// rows [0, n) of a [rows, heads, HD] slab (row stride `stride` elements)
// into a shared tile of row stride HD + 4 floats; rows past n read as zero
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst,
                                          const T* __restrict__ src,
                                          size_t stride, int n) {
  constexpr int QS = HD + 4;
  constexpr int CHUNKS = HD / 4;  // 4 elements each
#pragma unroll 4
  for (int r = 0; r < ROWS * CHUNKS / THREADS; ++r) {
    const int idx = threadIdx.x + r * THREADS;
    const int row = idx / CHUNKS, d = (idx % CHUNKS) * 4;
    const bool ok = row < n;
    if constexpr (sizeof(T) == 4) {
      cp_async16(&dst[row * QS + d], ok ? &src[(size_t)row * stride + d] : src,
                 ok);
    } else {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) {
        const T* p = &src[(size_t)row * stride + d];
        v = make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]),
                        to_f32(p[3]));
      }
      *reinterpret_cast<float4*>(&dst[row * QS + d]) = v;
    }
  }
}

// whether any (query, key) pair of the query tile at absolute position
// qa and the KV tile at k0 is visible
__device__ __forceinline__ bool tile_visible(int qa, int k0, int bkv,
                                             int causal, int window) {
  const int rel = qa - k0;
  bool vis = true;
  if (causal) vis = rel + BQ - 1 >= 0;
  if (window) vis = vis && (rel - (bkv - 1) < window);
  return vis;
}

// One block per (batch*head, query tile): block x takes query tile x / nbh
// (counted from the last when causal, so the heaviest tiles of every head
// launch first) of batch*head x % nbh. A query offset shifts every tile's
// causal run by the same number of keys, so the last tile stays the
// heaviest; under a window every tile sees at most window keys.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int sq, int sk, int hq, int hkv,
             int causal, int window, int q_off, float scale, int nbh) {
  constexpr int BKV = kv_tile<HD>();
  constexpr int QS = HD + 4;            // row stride of the Q, K, V tiles
  constexpr int PS = BKV + 8;           // row stride of a warp's P rows
  constexpr int NJ = BKV / 8;           // keys a lane owns in a tile
  constexpr int VW = HD >= 32 ? 4 : 2;  // output columns per group
  constexpr int NG = HD / (8 * VW);     // groups of output columns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;             // [2][BKV][QS]
  float* Vs = Ks + 2 * BKV * QS;        // [2][BKV][QS]
  float* Ps = Vs + 2 * BKV * QS;        // [WARPS][WROWS][PS]

  const int nqt = (sq + BQ - 1) / BQ;
  const int item = blockIdx.x;
  const int qt = causal ? nqt - 1 - item / nbh : item / nbh;
  const int bh = item % nbh;
  const int b = bh / hq;
  const int h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * BQ;
  const int qa0 = q0 + q_off;  // the tile's first absolute position
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = lane & 7;   // keys tx + 8 j; output group lane
  const int ty = lane >> 3;  // rows ty + 4 i of the warp's 16

  const size_t q_stride = (size_t)hq * HD;
  const size_t kv_stride = (size_t)hkv * HD;
  const T* qb = q + ((size_t)b * sq + q0) * q_stride + (size_t)h * HD;
  const T* kb = k + (size_t)b * sk * kv_stride + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * sk * kv_stride + (size_t)kvh * HD;

  // the visible KV tiles form one run [first, last]
  const int nkt = (sk + BKV - 1) / BKV;
  int first = nkt, last = -1;
  for (int kt = 0; kt < nkt; ++kt)
    if (tile_visible(qa0, kt * BKV, BKV, causal, window)) {
      first = min(first, kt);
      last = kt;
    }

  load_rows<T, HD, BQ>(Qs, qb, q_stride, min(BQ, sq - q0));
  if (first <= last) {
    const int k0 = first * BKV;
    load_rows<T, HD, BKV>(Ks, kb + (size_t)k0 * kv_stride, kv_stride,
                          min(BKV, sk - k0));
    load_rows<T, HD, BKV>(Vs, vb + (size_t)k0 * kv_stride, kv_stride,
                          min(BKV, sk - k0));
  }
  cp_async_commit();

  const int wrow = warp * WROWS + ty;   // block rows wrow + 4 i
  float* pw = Ps + (warp * WROWS + ty) * PS;
  const float scale2 = scale * LOG2E;
  float m[4], l[4], acc[4][NG * VW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * VW; ++c) acc[i][c] = 0.f;
  }

  for (int kt = first; kt <= last; ++kt) {
    const int slot = (kt - first) & 1;
    const int k0 = kt * BKV;
    const int kn = min(BKV, sk - k0);
    cp_async_wait_all();  // this thread's copies of tile kt (and Q) landed
    __syncthreads();      // everyone's have; tile kt - 1 is consumed
    if (kt + 1 <= last) {
      const int k1 = k0 + BKV;
      load_rows<T, HD, BKV>(Ks + (slot ^ 1) * BKV * QS,
                            kb + (size_t)k1 * kv_stride, kv_stride,
                            min(BKV, sk - k1));
      load_rows<T, HD, BKV>(Vs + (slot ^ 1) * BKV * QS,
                            vb + (size_t)k1 * kv_stride, kv_stride,
                            min(BKV, sk - k1));
    }
    cp_async_commit();
    const float* ks = Ks + slot * BKV * QS;
    const float* vs = Vs + slot * BKV * QS;

    // S = Q K^T for rows wrow + 4 i, keys tx + 8 j
    float s[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(wrow + 4 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tx + 8 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask (only where the tile is cut), online softmax, P -> the warp's
    // rows of shared memory
    bool full = kn == BKV;
    if (causal) full = full && k0 + BKV - 1 <= qa0;
    if (window) full = full && qa0 + BQ - 1 - k0 < window;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = qa0 + wrow + 4 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (full) {
          s[i][j] *= scale2;
          mx = fmaxf(mx, s[i][j]);
        } else {
          const int kj = k0 + tx + 8 * j;
          bool vis = true;
          if (causal) vis = qi >= kj;
          if (window) vis = vis && (qi - kj < window);
          s[i][j] = vis ? s[i][j] * scale2 : NEG_INF;
          if (tx + 8 * j < kn) mx = fmaxf(mx, s[i][j]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p =
            full || tx + 8 * j < kn ? exp2f(s[i][j] - m_new) : 0.f;
        sum += p;
        pw[4 * i * PS + tx + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float corr = exp2f(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NG * VW; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // the warp's P rows are complete

    // acc += P V for rows wrow + 4 i, columns g * 8 * VW + tx * VW + e
#pragma unroll 2
    for (int j = 0; j < BKV; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&pw[4 * i * PS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = &vs[(j + jj) * QS];
        float vv[NG * VW];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int c0 = g * 8 * VW + tx * VW;
          if constexpr (VW == 4) {
            const float4 t = *reinterpret_cast<const float4*>(&vrow[c0]);
            vv[g * 4 + 0] = t.x;
            vv[g * 4 + 1] = t.y;
            vv[g * 4 + 2] = t.z;
            vv[g * 4 + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(&vrow[c0]);
            vv[g * 2 + 0] = t.x;
            vv[g * 2 + 1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                        : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < NG * VW; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = wrow + 4 * i;
    if (q0 + row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)b * sq + q0 + row) * q_stride + (size_t)h * HD;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int c0 = g * 8 * VW + tx * VW;
      if constexpr (sizeof(T) == 4 && VW == 4) {
        *reinterpret_cast<float4*>(&orow[c0]) = make_float4(
            acc[i][g * 4] * inv, acc[i][g * 4 + 1] * inv,
            acc[i][g * 4 + 2] * inv, acc[i][g * 4 + 3] * inv);
      } else {
#pragma unroll
        for (int e = 0; e < VW; ++e)
          orow[c0 + e] = from_f32<T>(acc[i][g * VW + e] * inv);
      }
    }
  }
  // the row's log-sum-exp of the scaled scores, for the backward; m and l
  // are the same in the 8 lanes of a row
  if (lse != nullptr && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + wrow + 4 * i;
      if (row < sq) lse[(size_t)bh * sq + row] = (m[i] + log2f(l[i])) * LN2;
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int sk, int hq, int hkv, int causal, int window,
           int q_off, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int items = b * hq * ((sq + BQ - 1) / BQ);
  flash_kernel<T, HD><<<items, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, hq, hkv,
      causal, window, q_off, scale, b * hq);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int b, int sq, int sk, int hq, int hkv, int hd,
             int causal, int window, int q_off, float scale,
             cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, b, sq, sk, hq, hkv, causal,
                           window, q_off, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, b, sq, sk, hq, hkv, causal,
                           window, q_off, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, b, sq, sk, hq, hkv, causal,
                           window, q_off, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, b, sq, sk, hq, hkv, causal,
                            window, q_off, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- bf16: the tensor-core kernel -------------------------------------

namespace tc {

constexpr int BQ = 128;      // query rows a block, 64 a warpgroup
constexpr int BKV = 64;      // keys a KV tile
constexpr int STAGES = 4;    // depth of the K and V rings
constexpr int THREADS = 256; // two warpgroups

// head dim in shared memory: whole 64-column swizzle atoms, hd < 64
// zero-padded (zero columns of Q and K add nothing to QK^T; those of V
// give output columns that are not stored)
__host__ __device__ constexpr int padded(int hd) { return hd < 64 ? 64 : hd; }

template <int HD>
constexpr size_t smem_bytes() {
  // Q, the K and V rings, a full and an empty barrier a stage, and room
  // to align the start to 1024 bytes
  return size_t(2) * padded(HD) * (BQ + 2 * STAGES * BKV) + 16 * STAGES +
         1024;
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
// tile, so only the tile's first row moves from one tile to the next
template <int HD, int ROWS>
struct TileCopy {
  static constexpr int CH = HD / 8;          // chunks a row
  static constexpr int RP = THREADS / CH;    // rows a pass of the block
  static constexpr int PASSES = ROWS > RP ? ROWS / RP : 1;
  const __nv_bfloat16* src;  // chunk c of slab row r0
  size_t stride;             // elements from one row to the next
  uint32_t soff;             // the chunk's offset in a tile
  int r0;

  __device__ __forceinline__ TileCopy(const __nv_bfloat16* slab,
                                      size_t stride_)
      : stride(stride_) {
    r0 = threadIdx.x / CH;
    const int c = threadIdx.x % CH;
    src = slab + (size_t)r0 * stride + c * 8;
    soff = swz(ROWS, r0, c);
  }

  // slab rows row0 .. row0 + ROWS - 1 into the tile at shared address
  // dst; rows at or past `rows` read as zero
  __device__ __forceinline__ void load(uint32_t dst, int row0,
                                       int rows) const {
    const int n = rows - row0 - r0;  // rows left from the thread's first
#pragma unroll
    for (int i = 0; i < PASSES; ++i) {
      if (RP > ROWS && r0 >= ROWS) break;
      const bool ok = RP * i < n;
      cp_async16(dst + soff + RP * 128 * i,
                 ok ? src + (size_t)(row0 + RP * i) * stride
                    : src - (size_t)r0 * stride,
                 ok);
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

// s = Q K^T for the warpgroup's 64 rows of Q (at shared address qs) and
// the K tile at ks: HDP / 16 products of depth 16, both K-major, issued
// and committed as one group
template <int HDP>
__device__ __forceinline__ void qk_product(float (&s)[BKV / 2], uint32_t qs,
                                           uint32_t ks) {
  hold(s);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;  // 16 columns, 32 bytes
    wgmma_ss_n64(s, desc(qs + (kk >> 2) * BQ * 128 + col, 16, 1024),
                 desc(ks + (kk >> 2) * BKV * 128 + col, 16, 1024), kk > 0);
  }
  wg_commit();
}

// acc += P_hi V + P_lo V with V (at shared address vs) read MN-major
// (transposed) from its swizzled tile, 16 keys a product; issued and
// committed as one group
template <int HDP>
__device__ __forceinline__ void pv_product(float (&acc)[HDP / 2],
                                           const uint32_t (&ph)[BKV / 16][4],
                                           const uint32_t (&pl)[BKV / 16][4],
                                           uint32_t vs) {
  hold(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint64_t dv = desc(vs + kk * 16 * 128, BKV * 128, 1024);
    if constexpr (HDP == 128) {
      wgmma_rs_n128(acc, ph[kk], dv);
      wgmma_rs_n128(acc, pl[kk], dv);
    } else {
      wgmma_rs_n64(acc, ph[kk], dv);
      wgmma_rs_n64(acc, pl[kk], dv);
    }
  }
  wg_commit();
}

// the two bf16 halves of (x, y) in one register, x in the low half
__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// whether any (query, key) pair of `rows` queries from absolute position
// qa and the KV tile at k0 is visible
__device__ __forceinline__ bool visible(int qa, int rows, int k0, int causal,
                                        int window) {
  bool vis = true;
  if (causal) vis = qa + rows - 1 >= k0;
  if (window) vis = vis && qa - (k0 + BKV - 1) < window;
  return vis;
}

// One block per (batch*head, 128-query tile), in the order of the f32
// kernel (heaviest causal tiles first; a query offset moves every tile's
// causal run by the same number of keys, so the last stays the
// heaviest). Warpgroup w owns queries
// q0 + 64 w .. + 63; a thread owns rows r0 and r0 + 8 of them and, in each
// 8 columns of S or O, columns t2 and t2 + 1 (wgmma's accumulator layout).
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int sq, int sk, int hq, int hkv, int causal, int window,
                int q_off, float scale, int nbh) {
  constexpr int HDP = padded(HD);
  constexpr int QB = BQ * HDP * 2;   // bytes of the Q tile
  constexpr int KB = BKV * HDP * 2;  // bytes of one K or V tile
  constexpr int NO = HDP / 2;        // O accumulators a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t Qs = (raw + 1023) & ~1023u;
  const uint32_t Ks = Qs + QB, Vs = Ks + STAGES * KB;
  unsigned char* tiles = smem_raw + (Qs - raw);

  const int nqt = (sq + BQ - 1) / BQ;
  const int item = blockIdx.x;
  const int qt = causal ? nqt - 1 - item / nbh : item / nbh;
  const int bh = item % nbh;
  const int b = bh / hq;
  const int h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * BQ;
  const int wg = threadIdx.x >> 7;
  const int wl = threadIdx.x & 127;
  const int r0 = ((wl >> 5) << 4) + ((wl & 31) >> 2);
  const int t2 = (wl & 3) * 2;
  const int qw = q0 + 64 * wg;  // the warpgroup's first query
  const int qwa = qw + q_off;   // and its absolute position

  const size_t q_stride = (size_t)hq * HD;
  const size_t kv_stride = (size_t)hkv * HD;
  // the slabs of this batch and head: rows of q, k and v
  const __nv_bfloat16* qb = q + (size_t)b * sq * q_stride + (size_t)h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * sk * kv_stride + (size_t)kvh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * sk * kv_stride + (size_t)kvh * HD;

  // the visible KV tiles form one run [first, last]
  const int nkt = (sk + BKV - 1) / BKV;
  int first = nkt, last = -1;
  for (int kt = 0; kt < nkt; ++kt)
    if (visible(q0 + q_off, BQ, kt * BKV, causal, window)) {
      first = min(first, kt);
      last = kt;
    }

  const int n = last - first + 1;  // tiles of the run
  const uint32_t full_bar = Vs + STAGES * KB;  // STAGES barriers of 8 B
  const uint32_t empty_bar = full_bar + 8 * STAGES;
  if constexpr (HD < HDP) {
    zero_pad<HD>(tiles, BQ);
    for (int t = 0; t < 2 * STAGES; ++t) zero_pad<HD>(tiles + QB + t * KB, BKV);
    fence_proxy_async();  // the zeros, before the async-proxy reads
  }
  if (threadIdx.x == 0) {
    for (int t = 0; t < STAGES; ++t) {
      mbar_init(full_bar + 8 * t, THREADS);       // every thread's copies
      mbar_init(empty_bar + 8 * t, THREADS / 32);  // every warp's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Q with the first tile, then the second: each thread's copies of a
  // tile complete on the stage's full barrier
  const TileCopy<HD, BKV> kc(kb, kv_stride), vc(vb, kv_stride);
  TileCopy<HD, BQ>(qb, q_stride).load(Qs, q0, sq);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if (t < n) {
      kc.load(Ks + t * KB, (first + t) * BKV, sk);
      vc.load(Vs + t * KB, (first + t) * BKV, sk);
    }
    mbar_arrive_copies(full_bar + 8 * t);
  }

  const float scale2 = scale * LOG2E;
  float acc[NO], s[BKV / 2];
  // P of the previous tile as bf16 hi + lo in wgmma's A fragment layout
  // (register r of key chunk kk holds columns 8 kk + 2 r, + 1 of s)
  uint32_t ph[BKV / 16][4], pl[BKV / 16][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) ph[kk][r] = pl[kk][r] = 0u;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // Iteration it (tile kt): S of tile kt, then P V of tile kt - 1 (of
  // zeros at the first tile) on the tensor cores, while the softmax of
  // tile kt runs on the other units. No product is in flight from one
  // iteration to the next, and no barrier spans the block: each
  // warpgroup waits only for the stage it reads, so the two drift apart
  // and fill each other's gaps.
  for (int it = 0; it < n; ++it) {
    const int kt = first + it;
    const int st = it % STAGES;
    // tile it + 2 into the stage of tile it - 2 once every warp has
    // released it
    if (it + 2 < n) {
      const int sn = (it + 2) % STAGES;
      if (it + 2 >= STAGES)
        mbar_wait(empty_bar + 8 * sn, (((it + 2) / STAGES) & 1) ^ 1);
      kc.load(Ks + sn * KB, (kt + 2) * BKV, sk);
      vc.load(Vs + sn * KB, (kt + 2) * BKV, sk);
      mbar_arrive_copies(full_bar + 8 * sn);
    }
    mbar_wait(full_bar + 8 * st, (it / STAGES) & 1);
    // generic-proxy writes (the copies) before the async-proxy reads of
    // wgmma
    fence_proxy_async();
    qk_product<HDP>(s, Qs + wg * 64 * 128, Ks + st * KB);
    pv_product<HDP>(acc, ph, pl, Vs + (max(it - 1, 0) % STAGES) * KB);
    wg_wait<1>();  // S done; P V runs on
    hold(s);
    const int k0 = kt * BKV;

    // mask (only where the tile is cut), online softmax; s[4 j + e] is
    // row r0 + 8 (e >> 1), key k0 + 8 j + t2 + (e & 1). A full tile
    // keeps raw scores and folds the scale into the exponent. A tile
    // hidden from all of the warpgroup's rows is masked whole: it adds
    // nothing to a row that has seen a visible key, and what it adds to
    // one that has not is scaled away by exp2(-1e30 - m) = 0 at the first
    // visible key.
    const int kn = min(BKV, sk - k0);
    bool full = kn == BKV;
    if (causal) full = full && k0 + BKV - 1 <= qwa;
    if (window) full = full && qwa + 63 - k0 < window;
    // P goes to registers of its own: s, the product's accumulators, is
    // not written while P V is in flight
    float pf[BKV / 2];
    float mx0 = NEG_INF, mx1 = NEG_INF;
    if (full) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = 8 * j + t2 + (e & 1);
          const int qi = qwa + r0 + 8 * (e >> 1);
          bool vis = true;
          if (causal) vis = qi >= k0 + kj;
          if (window) vis = vis && (qi - k0 - kj < window);
          float x = vis ? s[4 * j + e] * scale2 : NEG_INF;
          if (kj >= kn) x = __int_as_float(0xff800000);  // -inf: no part
          pf[4 * j + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
    }
    const float sc = full ? scale2 : 1.f;
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0 * sc), n1 = fmaxf(m1, mx1 * sc);
    const float c0 = ex2(m0 - n0), c1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
    // P = exp2(S - m) in f32
    if (full) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        pf[4 * j] = ex2(fmaf(s[4 * j], scale2, -n0));
        pf[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale2, -n0));
        pf[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale2, -n1));
        pf[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale2, -n1));
      }
    } else {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        pf[4 * j] = ex2(pf[4 * j] - n0);
        pf[4 * j + 1] = ex2(pf[4 * j + 1] - n0);
        pf[4 * j + 2] = ex2(pf[4 * j + 2] - n1);
        pf[4 * j + 3] = ex2(pf[4 * j + 3] - n1);
      }
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      sum0 += pf[4 * j] + pf[4 * j + 1];
      sum1 += pf[4 * j + 2] + pf[4 * j + 3];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;

    wg_wait<0>();  // P V of tile kt - 1 done: ph, pl and acc are free
    hold(acc);
    // its stage is released for later copies, one arrival a warp
    if (it > 0 && (threadIdx.x & 31) == 0)
      mbar_arrive(empty_bar + 8 * ((it - 1) % STAGES));
    // P split into bf16 hi = bf16(P) and lo = bf16(P - hi)
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = pf[8 * kk + 2 * r], x1 = pf[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        ph[kk][r] = pack(hi);
        pl[kk][r] = pack(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
      }
    // acc rescaled for P V of tile kt, skipped where no row's max moved
    if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        acc[4 * j] *= c0;
        acc[4 * j + 1] *= c0;
        acc[4 * j + 2] *= c1;
        acc[4 * j + 3] *= c1;
      }
    }
  }
  // P V of the last tile
  if (n > 0) {
    pv_product<HDP>(acc, ph, pl, Vs + ((n - 1) % STAGES) * KB);
    wg_wait<0>();
    hold(acc);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = qw + r0 + 8 * half;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(half ? l1 : l0, 1e-30f);
    __nv_bfloat16* orow = o + ((size_t)b * sq + row) * q_stride +
                          (size_t)h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(&orow[8 * j + t2]) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * inv,
                                acc[4 * j + 2 * half + 1] * inv);
  }
  // the row's log-sum-exp of the scaled scores, for the backward; m and l
  // are the same in the 4 lanes of a row
  if (lse != nullptr && (wl & 3) == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = qw + r0 + 8 * half;
      if (row < sq)
        lse[(size_t)bh * sq + row] =
            ((half ? m1 : m0) + log2f(half ? l1 : l0)) * LN2;
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int sk, int hq, int hkv, int causal, int window,
           int q_off, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int items = b * hq * ((sq + BQ - 1) / BQ);
  flash_tc_kernel<HD><<<items, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, sq, sk, hq, hkv, causal, window, q_off, scale, b * hq);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             int b, int sq, int sk, int hq, int hkv, int hd, int causal,
             int window, int q_off, float scale, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, lse, b, sq, sk, hq, hkv, causal, window,
                        q_off, scale, s);
    case 32:
      return launch<32>(q, k, v, o, lse, b, sq, sk, hq, hkv, causal, window,
                        q_off, scale, s);
    case 64:
      return launch<64>(q, k, v, o, lse, b, sq, sk, hq, hkv, causal, window,
                        q_off, scale, s);
    case 128:
      return launch<128>(q, k, v, o, lse, b, sq, sk, hq, hkv, causal, window,
                         q_off, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v and o start on 16-byte
// boundaries. q_off >= 0 is the absolute position of query row 0 in the
// masks. lse is null, or f32 [B, Hq, Sq] that takes each row's
// log-sum-exp of the scaled and masked scores (the backward's input).
// Returns a CUDA error code (0 = none).
extern "C" int fm_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int b, int sq, int sk,
                                  int hq, int hkv, int hd, int causal,
                                  int window, int q_off, float scale,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  if (sk <= 0 || hkv <= 0 || hq % hkv != 0 || q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, l, b, sq, sk, hq, hkv, hd, causal,
                           window, q_off, scale, s);
  return tc::dispatch(q, k, v, o, l, b, sq, sk, hq, hkv, hd, causal, window,
                      q_off, scale, s);
}
