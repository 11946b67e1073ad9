// streamed_matmul: C[M,N] = A[M,K] @ B[K,N], f32 accumulation, C in A's
// dtype (f32 or bf16).
//
// Replaces: src/repro/kernels/streamed_matmul.py::streamed_matmul, the
// Pallas kernel with grid (M/bm, N/bn, K/bk), K innermost and the f32
// accumulator in VMEM scratch. On the card the sequential K grid axis
// becomes a loop inside each block, and the accumulator lives in registers.
//
// What bounds it on an H100: at the serving shapes (M = 1024 tokens, K and
// N the model widths, f32) it is bound by operations, not bytes. A
// (1024,2048,2048) product is 8.6 GFLOP against 29 MB of operands: about
// 128 us at the 67 TFLOP/s f32 rate outside the tensor cores, against
// 9 us to move the bytes at 3.35 TB/s. The f32 path stays off the tensor
// cores on purpose: TF32 keeps 10 mantissa bits and a 3xTF32 split changes
// the rounding, and the serving path's checks (1e-4 on a product, 1e-3 on
// a response, de-batched rows equal to solo runs) are set for IEEE f32
// FMAs. So the work is to keep the FMA pipes fed.
//
// What held the first version back: synchronous scalar loads staged
// through registers with one barrier per 16-deep K step (the load latency
// exposed at every step), and 64-thread blocks that left most SMs idle at
// the narrow outputs (N = 768: 2-3x slower than torch.matmul).
//
// The design:
// * A ring of STAGES = 4 shared-memory stages, each 32 deep in K, filled by
//   16-byte cp.async.cg copies (commit_group / wait_group): while tile t
//   is multiplied, tiles t+1 to t+3 are in flight, with one barrier per
//   tile. Rows that are not 16-byte aligned (K or N not a multiple of 4 in
//   f32) fill the same ring with 4-byte cp.async copies; bf16 is widened
//   to f32 on its way into the ring. Only the loads differ: the arithmetic,
//   and so every bit of C, is the same.
// * Warp tiling: a block of 8 warps owns a 128 x 128 tile of C, a warp a
//   32 x 64 sub-tile, its lanes a 4 x 8 grid, each lane 8 rows (ty + 4 i)
//   by 8 columns (two float4 groups 32 apart). A sits row-major in shared
//   memory with rows padded to 36 floats, so the four rows a warp reads at
//   once fall in four different bank quads, and each lane reads two K
//   steps of a row as one 8-byte vector (a broadcast to the 8 lanes that
//   share the row); B rows are read as 16-byte vectors by 8 consecutive
//   lanes. 12 conflict-free shared loads feed 128 FMAs.
// * Registers over occupancy: one block (8 warps) an SM, up to 255
//   registers a thread (167 used, no spills), so the compiler keeps the
//   next K step's fragments in flight; under a 128-register cap for two
//   blocks an SM the same loop spilled. A lane's 8 x 8 tile reads 1 byte
//   of shared memory per FMA, what an SM's shared memory (128 B a clock)
//   feeds at its full FMA rate (128 a clock), so the loop runs at about
//   two thirds of the f32 peak.
// * The split of K is chosen from (N, K), never from M
//   (streamed_matmul.py::tile_for), to fill whole waves of blocks at the
//   serving batch. A split writes its partial sums to a workspace and a
//   second kernel adds them in split order, so a row of C is one fixed
//   sequence of FMAs and additions whatever the number of rows in the
//   launch. Ragged edges are zero-filled by the copies and masked at the
//   store. Grid x runs down M, so a wave of blocks shares B's column
//   panels in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

// 16- or 4-byte asynchronous copy to shared memory; zero-fills when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// how a stage is filled: 16-byte copies (f32, rows 16-byte aligned),
// 4-byte copies (f32, any alignment), or loads widened to f32 (bf16)
enum Load { kAsync16 = 0, kAsync4 = 1, kWiden = 2 };

constexpr int BM = 128, BN = 128;  // C tile of a block
constexpr int BK = 32;             // K depth of a ring stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;       // 8 warps of 32 x 64
constexpr int ASTR = BK + 4;       // row stride of A in shared memory
constexpr int A_STAGE = BM * ASTR;
constexpr int B_STAGE = BK * BN;
constexpr size_t SMEM = sizeof(float) * STAGES * (A_STAGE + B_STAGE);

// Fills ring stages for one block: A[row0:row0+BM, k0:k0+BK] and
// B[k0:k0+BK, col0:col0+BN]; what lies outside the matrices reads as zero.
// Each thread copies the same rows and columns at every k0, so its source
// addresses and row masks are worked out once.
template <typename T, int LOAD>
struct Loader {
  static constexpr int VEC = LOAD == kAsync16 ? 4 : 1;  // elements a copy
  static constexpr int A_STEP = THREADS / (BK / VEC);   // rows between copies
  static constexpr int A_N = BM * BK / VEC / THREADS;   // copies of A a thread
  static constexpr int B_STEP = THREADS / (BN / VEC);
  static constexpr int B_N = BK * BN / VEC / THREADS;

  const T* a;       // A[row0 + a_row, a_k]
  const T* b;       // B[b_row, col0 + b_c]
  unsigned a_rows;  // bit r: row a_row + r * A_STEP lies inside M
  int a_row, a_k, b_row, b_c;
  bool b_in;        // column col0 + b_c (..+VEC) lies inside N

  __device__ __forceinline__ Loader(const T* A, const T* B, int M, int N,
                                    int K, int row0, int col0) {
    const int tid = threadIdx.x;
    a_row = tid / (BK / VEC);
    a_k = (tid % (BK / VEC)) * VEC;
    b_row = tid / (BN / VEC);
    b_c = (tid % (BN / VEC)) * VEC;
    a = A + (size_t)(row0 + a_row) * K + a_k;
    b = B + (size_t)b_row * N + col0 + b_c;
    a_rows = 0;
#pragma unroll
    for (int r = 0; r < A_N; ++r)
      if (row0 + a_row + r * A_STEP < M) a_rows |= 1u << r;
    b_in = col0 + b_c < N;
  }

  __device__ __forceinline__ void load(float* As, float* Bs, const T* A,
                                       const T* B, int N, int K, int k0) {
    const bool k_in = k0 + a_k < K;
#pragma unroll
    for (int r = 0; r < A_N; ++r) {
      const bool ok = k_in && (a_rows >> r & 1u);
      const T* src = a + (size_t)r * A_STEP * K + k0;
      float* dst = &As[(a_row + r * A_STEP) * ASTR + a_k];
      if constexpr (LOAD == kAsync16) cp_async16(dst, ok ? src : A, ok);
      else if constexpr (LOAD == kAsync4) cp_async4(dst, ok ? src : A, ok);
      else *dst = ok ? to_f32(*src) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < B_N; ++r) {
      const int row = k0 + r * B_STEP;
      const bool ok = b_in && row + b_row < K;
      const T* src = b + (size_t)row * N;
      float* dst = &Bs[(b_row + r * B_STEP) * BN + b_c];
      if constexpr (LOAD == kAsync16) cp_async16(dst, ok ? src : B, ok);
      else if constexpr (LOAD == kAsync4) cp_async4(dst, ok ? src : B, ok);
      else *dst = ok ? to_f32(*src) : 0.f;
    }
  }
};

// One block computes a BM x BN tile of C (or, with a split of K, of the
// split's partial sum in ws) from the K tiles of split blockIdx.z.
template <typename T, int LOAD>
__global__ void __launch_bounds__(THREADS, 1)
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
              T* __restrict__ C, float* __restrict__ ws, int M, int N, int K,
              int tiles_per_split, int vec_out) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + STAGES * A_STAGE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int ty = lane >> 3, tx = lane & 7;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int ntiles = (K + BK - 1) / BK;
  const int t0 = blockIdx.z * tiles_per_split;
  const int n = max(0, min(ntiles, t0 + tiles_per_split) - t0);
  Loader<T, LOAD> ld(A, B, M, N, K, row0, col0);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // prologue: the first STAGES - 1 tiles in flight, one group each
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n)
      ld.load(As + s * A_STAGE, Bs + s * B_STAGE, A, B, N, K, (t0 + s) * BK);
    cp_async_commit();
  }

  const int ar = wm * 32 + ty;      // rows ar + 4 i
  const int bc = wn * 64 + tx * 4;  // columns bc + j and bc + 32 + j
  for (int t = 0; t < n; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t landed
    __syncthreads();              // everyone's have; tile t-1 is consumed
    {
      const int nt = t + STAGES - 1;  // refill the stage tile t-1 used
      if (nt < n)
        ld.load(As + (nt % STAGES) * A_STAGE, Bs + (nt % STAGES) * B_STAGE, A,
                B, N, K, (t0 + nt) * BK);
      cp_async_commit();
    }
    const float* as = As + (t % STAGES) * A_STAGE;
    const float* bs = Bs + (t % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 2) {
      float2 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float2*>(&as[(ar + 4 * i) * ASTR + kk]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 b0 =
            *reinterpret_cast<const float4*>(&bs[(kk + q) * BN + bc]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&bs[(kk + q) * BN + bc + 32]);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = q == 0 ? a[i].x : a[i].y;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // C, or this split's slice of the workspace
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ar + 4 * i;
    if (r >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + bc + 32 * h;
      const float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                   acc[i][4 * h + 2], acc[i][4 * h + 3]);
      if (ws != nullptr) {
        float* out = ws + (size_t)blockIdx.z * M * N + (size_t)r * N + c;
        if (vec_out && c + 3 < N) {
          *reinterpret_cast<float4*>(out) = v;
        } else {
          if (c < N) out[0] = v.x;
          if (c + 1 < N) out[1] = v.y;
          if (c + 2 < N) out[2] = v.z;
          if (c + 3 < N) out[3] = v.w;
        }
      } else {
        T* out = C + (size_t)r * N + c;
        if (sizeof(T) == 4 && vec_out && c + 3 < N) {
          *reinterpret_cast<float4*>(out) = v;
        } else {
          if (c < N) out[0] = from_f32<T>(v.x);
          if (c + 1 < N) out[1] = from_f32<T>(v.y);
          if (c + 2 < N) out[2] = from_f32<T>(v.z);
          if (c + 3 < N) out[3] = from_f32<T>(v.w);
        }
      }
    }
  }
}

// C = sum over s of ws[s], added in split order
template <typename T>
__global__ void splitk_reduce(const float* __restrict__ ws, T* __restrict__ C,
                              size_t mn, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s += ws[(size_t)z * mn + i];
    C[i] = from_f32<T>(s);
  }
}

template <typename T, int LOAD>
int launch(const void* a, const void* b, void* c, float* ws, int m, int n,
           int k, int splits, int vec_out, cudaStream_t stream) {
  auto kernel = matmul_kernel<T, LOAD>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int ntiles = (k + BK - 1) / BK;
  const int per = (ntiles + splits - 1) / splits;
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, splits);
  kernel<<<grid, THREADS, SMEM, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      splits > 1 ? ws : nullptr, m, n, k, per, vec_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t mn = (size_t)m * n;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  splitk_reduce<T><<<blocks, 256, 0, stream>>>(ws, static_cast<T*>(c), mn,
                                                splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. splits: the number of K ranges (1 =
// none); with more than one, ws holds splits * m * n f32 partial sums.
// A, B and C are contiguous row-major. Returns a CUDA error code (0 = none).
extern "C" int fm_streamed_matmul(const void* a, const void* b, void* c,
                                  int m, int n, int k, int dtype, int splits,
                                  void* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return 0;
  if (splits < 1 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* w = static_cast<float*>(ws);
  if (dtype == 1)
    return launch<__nv_bfloat16, kWiden>(a, b, c, w, m, n, k, splits, 0, s);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool rows16 = k % 4 == 0 && n % 4 == 0 && aligned(a) && aligned(b);
  const int vec_out = n % 4 == 0 && aligned(c) && (ws == nullptr ||
                                                  aligned(ws));
  if (rows16)
    return launch<float, kAsync16>(a, b, c, w, m, n, k, splits, vec_out, s);
  return launch<float, kAsync4>(a, b, c, w, m, n, k, splits, vec_out, s);
}
