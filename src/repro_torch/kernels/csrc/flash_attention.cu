// flash_attention: fused online-softmax attention, causal and/or sliding
// window, GQA (kv head = q head / (Hq / Hkv)), f32 math, output in q's
// dtype (f32 or bf16). q [B,Sq,Hq,hd], k and v [B,Sk,Hkv,hd], contiguous;
// hd in {16, 32, 64, 128}.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the
// Pallas kernel with grid (B*H, Sq/bq, Sk/bkv) that carries m, l and acc
// in VMEM scratch across the sequential KV axis and skips invisible
// blocks. On the card one block owns one (batch*head, 64-query tile) and
// walks the visible KV tiles in a loop; m, l and acc stay in registers.
//
// What bounds it on an H100: at the serving shapes (S = 1024, hd = 64 or
// 128, causal, f32) it is bound by operations: 4 * S^2 * hd * H / 2 FLOP
// (QK^T and PV under the causal mask) against a few MB of q, k, v and o.
// The scores never touch device memory. The f32 path stays off the tensor
// cores: TF32 would not hold the 2e-5 tolerance the serving checks were
// set for, so the work is to keep the FMA pipes fed.
//
// What held the first version back: K and V shared one shared-memory
// buffer (two exposed load latencies a KV tile), every element was staged
// through a register with an integer division, P went through
// block-shared memory between block-wide barriers, and the grid put the
// heavy causal tiles of one head after another.
//
// The design (FlashAttention-2's, on the FMA units), 4 warps a block:
// * Each warp owns 16 query rows; its lanes form a 4 x 8 grid, a lane
//   owning rows ty + 4 i (i < 4) and keys tx + 8 j of each KV tile. Row
//   max and row sum reduce over the 8 lanes of a row with shuffles, and P
//   goes through the warp's own slice of shared memory behind __syncwarp,
//   so the softmax needs no block barrier.
// * Q is copied into shared memory once. K and V each have a two-stage
//   ring filled by 16-byte cp.async copies: tile j + 1 is in flight while
//   tile j is computed, with one block barrier a tile (bf16 is widened to
//   f32 on its way into the same rings). Row strides of hd + 4 floats
//   keep the 16-byte reads of 8 neighbouring key rows conflict-free.
// * KV tiles are 64 keys for hd <= 64 and 32 for hd = 128 (111 KB a
//   block), so two blocks, 8 warps, share an SM at every head size.
// * Only tiles that the mask cuts (the diagonal, a window's edge, the
//   ragged end of K) are masked; hidden tiles are never visited. The grid
//   is one line of (query tile, batch*head) items, heads fastest, so the
//   heaviest causal query tiles of all heads launch first.
// * What bounds it now: a lane's 4 x 4 (hd = 128) or 4 x 8 score tile
//   reads 1.5-2 bytes of shared memory per FMA in QK^T, above the 1 byte
//   per FMA an SM's shared memory can feed at its full FMA rate, so QK^T
//   runs at about half the FMA peak; hd = 128 needs 32-key tiles to fit
//   two blocks an SM.
// * Scores are scaled by scale * log2(e) and exponentiated with exp2f.
//   Masked scores take -1e30 as in the Pallas kernel; keys past Sk take
//   no part; the output is acc / max(l, 1e-30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// whether any (query, key) pair of the query tile at q0 and the KV tile
// at k0 is visible
__device__ __forceinline__ bool tile_visible(int q0, int k0, int bkv,
                                             int causal, int window) {
  const int rel = q0 - k0;
  bool vis = true;
  if (causal) vis = rel + BQ - 1 >= 0;
  if (window) vis = vis && (rel - (bkv - 1) < window);
  return vis;
}

// One block per (batch*head, query tile): block x takes query tile x / nbh
// (counted from the last when causal, so the heaviest tiles of every head
// launch first) of batch*head x % nbh.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
             int hq, int hkv, int causal, int window, float scale, int nbh) {
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
    if (tile_visible(q0, kt * BKV, BKV, causal, window)) {
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
    if (causal) full = full && k0 + BKV - 1 <= q0;
    if (window) full = full && q0 + BQ - 1 - k0 < window;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + wrow + 4 * i;
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
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int hq, int hkv, int causal, int window,
           float scale, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, hq, hkv, causal,
      window, scale, b * hq);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int sq, int sk, int hq, int hkv, int hd, int causal, int window,
             float scale, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, sq, sk, hq, hkv, causal, window,
                           scale, s);
    case 32:
      return launch<T, 32>(q, k, v, o, b, sq, sk, hq, hkv, causal, window,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, b, sq, sk, hq, hkv, causal, window,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, b, sq, sk, hq, hkv, causal, window,
                            scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v and o start on 16-byte
// boundaries. Returns a CUDA error code (0 = none).
extern "C" int fm_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int b, int sq, int sk, int hq,
                                  int hkv, int hd, int causal, int window,
                                  float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  if (sk <= 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, b, sq, sk, hq, hkv, hd, causal,
                           window, scale, s);
  return dispatch<__nv_bfloat16>(q, k, v, o, b, sq, sk, hq, hkv, hd, causal,
                                 window, scale, s);
}
