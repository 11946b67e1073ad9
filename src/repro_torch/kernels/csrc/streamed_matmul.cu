// streamed_matmul: C[M,N] = A[M,K] @ B[K,N], f32 accumulation, C in A's
// dtype (f32 or bf16).
//
// Replaces: src/repro/kernels/streamed_matmul.py::streamed_matmul, the
// Pallas kernel with grid (M/bm, N/bn, K/bk), K innermost and the f32
// accumulator in VMEM scratch. On the card the sequential K grid axis
// becomes a loop inside each block, and the accumulator lives in registers.
//
// What bounds it on an H100: at the shapes the serving path gives it
// (M = 1024 tokens, K and N the model widths, f32) it is bound by
// operations, not bytes. A (1024,2048,2048) product is 8.6 GFLOP against
// 29 MB of operands: about 128 us at the 67 TFLOP/s f32 rate outside the
// tensor cores, against 9 us to move the bytes at 3.35 TB/s. The kernel
// keeps f32 (no TF32) so its results stay within 1e-4 of the reference.
//
// What the design does about it: each block computes a BM x BN tile of C
// from shared-memory tiles of A and B; each thread holds an 8 x 8 register
// tile, so one pair of 16-byte shared-memory reads feeds 64 FMAs. The next
// K tile is read from device memory into registers while the current one
// is multiplied (two shared buffers, one barrier per K step). Ragged edges
// are masked with zeros. The K reduction runs in one fixed order, with no
// split-K, and the tile shape is chosen from N only, so a row of C does not
// depend on how many other rows share the launch.
// wgmma and TMA are not used yet.
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

constexpr int BK = 16;
constexpr int TM = 8;  // rows of C per thread
constexpr int TN = 8;  // columns of C per thread

// BM x BN tile per block, (BM/TM) * (BN/TN) threads. A thread owns rows
// {ty*4 + i, BM/2 + ty*4 + i} and columns {tx*4 + j, BN/2 + tx*4 + j}
// (i, j < 4), so a warp's shared reads of a K step are conflict-free.
template <typename T, int BM, int BN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
              T* __restrict__ C, int M, int N, int K) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int A_LOADS = BM * BK / THREADS;
  constexpr int B_LOADS = BK * BN / THREADS;
  constexpr int APAD = BM + 4;  // padding spreads the transposed stores
  __shared__ __align__(16) float As[2][BK][APAD];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float a_reg[A_LOADS];
  float b_reg[B_LOADS];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // device memory -> registers; consecutive threads read consecutive k
  // (A) or n (B), and out-of-range elements read as zero
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int r = 0; r < A_LOADS; ++r) {
      const int idx = tid + r * THREADS;
      const int gr = row0 + idx / BK;
      const int gk = k0 + idx % BK;
      a_reg[r] = (gr < M && gk < K) ? to_f32(A[(size_t)gr * K + gk]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < B_LOADS; ++r) {
      const int idx = tid + r * THREADS;
      const int gk = k0 + idx / BN;
      const int gc = col0 + idx % BN;
      b_reg[r] = (gk < K && gc < N) ? to_f32(B[(size_t)gk * N + gc]) : 0.f;
    }
  };
  // registers -> shared; A is stored k-major so a K step reads rows as
  // one 16-byte vector
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int r = 0; r < A_LOADS; ++r) {
      const int idx = tid + r * THREADS;
      As[buf][idx % BK][idx / BK] = a_reg[r];
    }
#pragma unroll
    for (int r = 0; r < B_LOADS; ++r) {
      const int idx = tid + r * THREADS;
      Bs[buf][idx / BN][idx % BN] = b_reg[r];
    }
  };

  const int ntiles = (K + BK - 1) / BK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < ntiles) load_tile((t + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][kk][BM / 2 + ty * 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[cur][kk][BN / 2 + tx * 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < ntiles) store_tile(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4);
      if (c < N) C[(size_t)r * N + c] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN>
void launch(const void* a, const void* b, void* c, int m, int n, int k,
            cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  matmul_kernel<T, BM, BN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. tile: 0 = 64 x 64, 1 = 128 x 128.
// A, B and C are contiguous row-major. Returns cudaGetLastError().
extern "C" int fm_streamed_matmul(const void* a, const void* b, void* c,
                                  int m, int n, int k, int dtype, int tile,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m > 0 && n > 0) {
    if (dtype == 0) {
      if (tile == 1) launch<float, 128, 128>(a, b, c, m, n, k, s);
      else launch<float, 64, 64>(a, b, c, m, n, k, s);
    } else {
      if (tile == 1) launch<__nv_bfloat16, 128, 128>(a, b, c, m, n, k, s);
      else launch<__nv_bfloat16, 64, 64>(a, b, c, m, n, k, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
