// flash_attention: fused online-softmax attention, causal and/or sliding
// window, GQA (kv head = q head / (Hq / Hkv)), f32 math, output in q's
// dtype (f32 or bf16). q [B,Sq,Hq,hd], k and v [B,Sk,Hkv,hd], contiguous;
// hd in {16, 32, 64, 128}.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the
// Pallas kernel with grid (B*H, Sq/bq, Sk/bkv) that carries m, l and acc
// in VMEM scratch across the sequential KV axis and skips invisible
// blocks. On the card one block owns one (batch*head, 64-query tile) and
// walks the KV tiles in a loop; m, l and acc stay in registers.
//
// What bounds it on an H100: at the serving shapes (S = 1024, hd = 64 or
// 128, causal, f32) it is bound by operations: 4 * S^2 * hd * H / 2 FLOP
// (QK^T and PV under the causal mask) against a few MB of q, k, v and o.
// The scores never touch device memory.
//
// What the design does about it: 128 threads per block. A thread owns
// four query rows (ty + 16 i) and eight key columns (tx + 8 j) of each
// 64 x 64 score tile, and hd / 8 output columns, so QK^T and PV both run
// from registers fed by 16-byte shared-memory reads without bank
// conflicts. Row max and row sum reduce over the eight lanes of a row
// with warp shuffles. K and V share one shared buffer (the block loads K,
// takes the scores, then loads V), which keeps the block under 86 KB so
// two blocks share an SM and one's loads overlap the other's math. KV
// tiles that the mask hides entirely are skipped, as in the Pallas kernel,
// and the heaviest causal query tiles are launched first. Masked scores
// take -1e30 as in the Pallas kernel; keys past Sk take no part; the
// output is acc / max(l, 1e-30).
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

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

constexpr size_t smem_bytes(int hd) {
  return sizeof(float) *
         (size_t(BQ) * (hd + 4) + size_t(BKV) * (hd + 4) + size_t(BQ) * (BKV + 4));
}

// rows [0, n) of a [rows, heads, HD] slab (row stride `stride` elements)
// into a padded shared tile; rows past `n` read as zero
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const T* __restrict__ src,
                                          size_t stride, int n) {
  constexpr int PER = ROWS * HD / THREADS;
#pragma unroll 8
  for (int r = 0; r < PER; ++r) {
    const int idx = threadIdx.x + r * THREADS;
    const int row = idx / HD;
    const int d = idx % HD;
    dst[row * dst_stride + d] =
        row < n ? to_f32(src[(size_t)row * stride + d]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
             int hq, int hkv, int causal, int window, float scale) {
  constexpr int QS = HD + 4;          // row stride of the Q and K/V tiles
  constexpr int PS = BKV + 4;         // row stride of the P tile
  constexpr int VW = HD >= 32 ? 4 : 2;  // output columns per group
  constexpr int NG = HD / (8 * VW);     // groups of output columns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KVs = Qs + BQ * QS;
  float* Ps = KVs + BKV * QS;

  const int nqt = (sq + BQ - 1) / BQ;
  // causal: the last query tiles see the most keys; launch them first
  const int qt = causal ? nqt - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 7;   // key columns tx + 8 j; output group lane
  const int ty = tid >> 3;  // query rows ty + 16 i

  const size_t q_stride = (size_t)hq * HD;
  const size_t kv_stride = (size_t)hkv * HD;
  const T* qb = q + ((size_t)b * sq + q0) * q_stride + (size_t)h * HD;
  const T* kb = k + (size_t)b * sk * kv_stride + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * sk * kv_stride + (size_t)kvh * HD;

  load_rows<T, HD, BQ>(Qs, QS, qb, q_stride, min(BQ, sq - q0));

  float m[4], l[4], acc[4][NG * VW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * VW; ++c) acc[i][c] = 0.f;
  }

  const int nkt = (sk + BKV - 1) / BKV;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BKV;
    const int rel = q0 - k0;
    bool visible = true;
    if (causal) visible = rel + BQ - 1 >= 0;
    if (window) visible = visible && (rel - (BKV - 1) < window);
    if (!visible) continue;  // uniform across the block
    const int kn = min(BKV, sk - k0);

    __syncthreads();  // the previous tile's PV reads of KVs and Ps are done
    load_rows<T, HD, BKV>(KVs, QS, kb + (size_t)k0 * kv_stride, kv_stride, kn);
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, columns tx + 8 j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 8 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, online softmax, P -> shared
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + tx + 8 * j;
        bool vis = true;
        if (causal) vis = qi >= kj;
        if (window) vis = vis && (qi - kj < window);
        s[i][j] = vis ? s[i][j] * scale : NEG_INF;
        if (tx + 8 * j < kn) mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = tx + 8 * j < kn ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(ty + 16 * i) * PS + tx + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NG * VW; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // all scores read K; P is complete
    load_rows<T, HD, BKV>(KVs, QS, vb + (size_t)k0 * kv_stride, kv_stride, kn);
    __syncthreads();

    // acc += P V for rows ty + 16 i, columns g * 8 * VW + tx * VW + e
#pragma unroll 2
    for (int j = 0; j < BKV; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PS + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = &KVs[(j + jj) * QS];
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    if (q0 + row >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)b * sq + q0 + row) * q_stride + (size_t)h * HD;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        const int c = g * 8 * VW + tx * VW + e;
        orow[c] = from_f32<T>(acc[i][g * VW + e] * inv);
      }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int hq, int hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, b * hq);
  flash_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, hq, hkv, causal,
      window, scale);
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

// dtype: 0 = float32, 1 = bfloat16. Returns a CUDA error code (0 = none).
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
