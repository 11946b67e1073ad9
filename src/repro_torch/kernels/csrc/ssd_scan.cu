// ssd_scan: the Mamba-2 SSD chunked scan, f32 throughout.
//
//   y = y_intra + y_inter + d x, per (batch, head), chunk after chunk:
//   L       = cumsum(dt * a) within the chunk                     [Q]
//   y_intra = ((C B^T) o exp(L_i - L_j) [j <= i] o dt_j) X        [Q, P]
//   y_inter = exp(L_i) C . state                                  [Q, P]
//   state   = exp(L_Q) state + sum_j exp(L_Q - L_j) dt_j B_j (x) X_j  [N, P]
//
// x [B,S,H,P] and dt [B,S,H] are read in place through their strides
// (the model hands over views of the conv output); b and c [B,S,N] are
// shared by the heads of a batch row; y [B,S,H,P] is written contiguous.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan, the Pallas kernel
// with grid (B*H, S/Q), the chunk axis sequential and the [N, P] state in
// VMEM scratch, which holds the whole [Q, Q] intra-chunk matrix at once.
//
// What bounds it on an H100: operations. At the Mamba-2-130M prefill shape
// (B 4, S 4096, H 24, P 64, N 128, Q 256) the least work is about 20 GFLOP
// of f32 products (the causal half of C B^T X, and C . state and the state
// update in full) against about 220 MB of operands: about 0.30 ms at the
// 67 TFLOP/s f32 rate outside the tensor cores, 0.066 ms to move the bytes.
//
// What the design does about it (a simple kernel first): one block per
// (batch, head) walks the chunks in order and keeps the state in shared
// memory (N x P f32 = 32 KB at N 128, P 64), so the recurrence never goes
// through device memory. The [Q, Q] matrix (256 KB at Q 256) does not fit
// in a block's 227 KB of shared memory, so the intra-chunk term is tiled:
// for each 64-row tile i of the chunk, and each 64-column tile j <= i, the
// block forms C_i B_j^T (each thread a 4 x 4 register tile), scales it by
// the decay and dt_j with the j > i entries never computed (the Pallas
// kernel masks the exponent before exp; here those terms do not exist),
// and multiplies it into X_j. The inter-chunk term is added per row tile
// before the j loop; the state update is accumulated in registers during
// the last row tile's j loop, which visits every column tile, and written
// back once the chunk's rows are done. The grid has only B*H blocks
// (96 at the prefill shape, on 132 SMs) and uses no tensor cores: a
// chunk-parallel two-pass form and wgmma are later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int TI = 64;        // rows of a chunk per tile (4 per thread)
constexpr int TJ = 64;        // columns of a chunk per tile (4 per thread)
constexpr int PAD = 4;        // keeps float4 alignment, spreads banks
constexpr int PMAX = 64;      // P = 4 x 16 columns of threads
constexpr int NMAX = 128;     // the state update keeps 8 rows of 16 per thread
constexpr int NROWS = NMAX / 16;

struct Args {
  const float* x;
  const float* dt;
  const float* a;
  const float* b;
  const float* c;
  const float* d;
  float* y;
  int B, S, H, P, N, Q;
  long long sxb, sxs, sxh;  // x strides in elements (P stride 1)
  long long sdb, sds, sdh;  // dt strides
  long long sbb, sbs;       // b strides (N stride 1)
  long long scb, scs;       // c strides (N stride 1)
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// shared floats of one block: state, C^T, B^T, X, G^T, the column weights
// of the state update, and dt and cumsum(dt a) of the chunk
__host__ __device__ inline size_t smem_floats(int N, int P, int Q) {
  return (size_t)N * P + (size_t)N * (TI + PAD) + (size_t)N * (TJ + PAD) +
         (size_t)TJ * (P + PAD) + (size_t)TJ * (TI + PAD) + TJ +
         2 * (size_t)round4(Q);
}

// one block per SM at most (its shared memory), so all 255 registers a
// thread may have are there to keep the register tiles out of local memory
__global__ void __launch_bounds__(THREADS, 1) ssd_kernel(Args args) {
  extern __shared__ __align__(16) float smem[];
  const int N = args.N, P = args.P, Q = args.Q;
  float* st = smem;                         // [N][P]
  float* cT = st + N * P;                   // [N][TI + PAD]
  float* bT = cT + N * (TI + PAD);          // [N][TJ + PAD]
  float* xs = bT + N * (TJ + PAD);          // [TJ][P + PAD]
  float* gT = xs + TJ * (P + PAD);          // [TJ][TI + PAD]
  float* ws = gT + TJ * (TI + PAD);         // [TJ]
  float* dts = ws + TJ;                     // [Q]
  float* lc = dts + round4(Q);              // [Q]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bi = blockIdx.x / args.H;
  const int h = blockIdx.x % args.H;
  const float a_h = args.a[h];
  const float d_h = args.d[h];
  const bool pcols = tx * 4 < P;  // this thread owns columns of P
  const int xp = P + PAD;

  const float* xbh = args.x + bi * args.sxb + h * args.sxh;
  const float* dtbh = args.dt + bi * args.sdb + h * args.sdh;
  const float* bb = args.b + bi * args.sbb;
  const float* cb = args.c + bi * args.scb;
  float* ybh = args.y + (long long)bi * args.S * args.H * P + (long long)h * P;
  const long long ys = (long long)args.H * P;  // y's sequence stride

  for (int e = tid; e < N * P; e += THREADS) st[e] = 0.f;

  const int nchunks = args.S / Q;
  const int ntiles = (Q + TI - 1) / TI;
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    const long long t0 = (long long)chunk * Q;
    // dt and the inclusive cumsum of dt * a over the chunk: warp 0, each
    // lane a run of consecutive steps, then a scan of the lanes' totals
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      const int start = tid * per;
      float run = 0.f;
      for (int k = 0; k < per; ++k) {
        const int t = start + k;
        if (t < Q) {
          const float v = dtbh[(t0 + t) * args.sds];
          dts[t] = v;
          run += v * a_h;
          lc[t] = run;
        }
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, tot, off);
        if (tid >= off) tot += o;
      }
      const float excl = tot - run;
      for (int k = 0; k < per; ++k) {
        const int t = start + k;
        if (t < Q) lc[t] += excl;
      }
    }
    __syncthreads();
    const float l_last = lc[Q - 1];

    float sacc[NROWS][4];
#pragma unroll
    for (int k = 0; k < NROWS; ++k)
#pragma unroll
      for (int q = 0; q < 4; ++q) sacc[k][q] = 0.f;

    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * TI;
      const bool last = it == ntiles - 1;
      // C rows of this tile, transposed: cT[n][ii]
      for (int e = tid; e < TI * N; e += THREADS) {
        const int ii = e / N, n = e % N;
        cT[n * (TI + PAD) + ii] =
            i0 + ii < Q ? cb[(t0 + i0 + ii) * args.scs + n] : 0.f;
      }
      __syncthreads();

      // inter-chunk term: acc = exp(L_i) C_i . state
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      if (pcols) {
        for (int n = 0; n < N; ++n) {
          const float4 cv =
              *reinterpret_cast<const float4*>(&cT[n * (TI + PAD) + ty * 4]);
          const float4 sv =
              *reinterpret_cast<const float4*>(&st[n * P + tx * 4]);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float sq[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cr[r], sq[q], acc[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        const float f = i < Q ? __expf(lc[i]) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= f;
      }

      // intra-chunk term over the column tiles j <= i
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TJ;
        const int jmax = min(TJ, Q - j0);
        __syncthreads();  // the previous tile's readers are done
        for (int e = tid; e < TJ * N; e += THREADS) {
          const int jj = e / N, n = e % N;
          bT[n * (TJ + PAD) + jj] =
              jj < jmax ? bb[(t0 + j0 + jj) * args.sbs + n] : 0.f;
        }
        for (int e = tid; e < TJ * P; e += THREADS) {
          const int jj = e / P, p = e % P;
          xs[jj * xp + p] = jj < jmax ? xbh[(t0 + j0 + jj) * args.sxs + p] : 0.f;
        }
        if (last && tid < TJ) {
          const int j = j0 + tid;
          ws[tid] = tid < jmax ? __expf(l_last - lc[j]) * dts[j] : 0.f;
        }
        __syncthreads();

        // G = C_i B_j^T, each thread rows ty*4.. and columns tx*4..
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) g[r][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          const float4 cv =
              *reinterpret_cast<const float4*>(&cT[n * (TI + PAD) + ty * 4]);
          const float4 bv =
              *reinterpret_cast<const float4*>(&bT[n * (TJ + PAD) + tx * 4]);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) g[r][q] = fmaf(cr[r], bq[q], g[r][q]);
        }
        // decay and dt_j; the j > i terms are zero and never exponentiated
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tx * 4 + q;
            g[r][q] = (j <= i && i < Q)
                          ? g[r][q] * __expf(lc[i] - lc[j]) * dts[j]
                          : 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float4*>(&gT[(tx * 4 + q) * (TI + PAD) + ty * 4]) =
              make_float4(g[0][q], g[1][q], g[2][q], g[3][q]);
        __syncthreads();

        if (pcols) {
          // y_i += G X_j
          for (int jj = 0; jj < jmax; ++jj) {
            const float4 gv =
                *reinterpret_cast<const float4*>(&gT[jj * (TI + PAD) + ty * 4]);
            const float4 xv =
                *reinterpret_cast<const float4*>(&xs[jj * xp + tx * 4]);
            const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
            const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(gr[r], xq[q], acc[r][q]);
          }
          // state update: rows n = ty + 16 k, columns tx*4..
          if (last) {
            for (int jj = 0; jj < jmax; ++jj) {
              const float w = ws[jj];
              const float4 xv =
                  *reinterpret_cast<const float4*>(&xs[jj * xp + tx * 4]);
              const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
              for (int k = 0; k < NROWS; ++k) {
                const int n = ty + 16 * k;
                if (n < N) {
                  const float bw = bT[n * (TJ + PAD) + jj] * w;
#pragma unroll
                  for (int q = 0; q < 4; ++q) sacc[k][q] = fmaf(bw, xq[q], sacc[k][q]);
                }
              }
            }
          }
        }
      }

      // y_i = acc + d x_i
      if (pcols) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
          if (i < Q) {
            const float* xr = xbh + (t0 + i) * args.sxs + tx * 4;
            float4 out;
            out.x = acc[r][0] + d_h * xr[0];
            out.y = acc[r][1] + d_h * xr[1];
            out.z = acc[r][2] + d_h * xr[2];
            out.w = acc[r][3] + d_h * xr[3];
            *reinterpret_cast<float4*>(&ybh[(t0 + i) * ys + tx * 4]) = out;
          }
        }
      }
    }

    // every reader of the old state is past a barrier of the last row
    // tile's j loop; now state = exp(L_Q) state + the accumulated update
    __syncthreads();
    if (pcols) {
      const float decay = __expf(l_last);
#pragma unroll
      for (int k = 0; k < NROWS; ++k) {
        const int n = ty + 16 * k;
        if (n < N) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float& s = st[n * P + tx * 4 + q];
            s = fmaf(decay, s, sacc[k][q]);
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Shared memory bytes one block needs (the wrapper checks the card's limit).
extern "C" long long fm_ssd_scan_smem_bytes(int n, int p, int q) {
  return (long long)(smem_floats(n, p, q) * sizeof(float));
}

// x/dt/b/c strides in elements; the last axis of x, b and c has stride 1;
// a and d are [H] contiguous; y is [B,S,H,P] contiguous. P is a multiple
// of 4 and at most 64, N at most 128, Q divides S. Returns
// cudaGetLastError().
extern "C" int fm_ssd_scan(const void* x, const void* dt, const void* a,
                           const void* b, const void* c, const void* d,
                           void* y, int B, int S, int H, int P, int N, int Q,
                           long long sxb, long long sxs, long long sxh,
                           long long sdb, long long sds, long long sdh,
                           long long sbb, long long sbs, long long scb,
                           long long scs, void* stream) {
  if (P % 4 != 0 || P > PMAX || N > NMAX || Q <= 0 || S % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args args{static_cast<const float*>(x), static_cast<const float*>(dt),
            static_cast<const float*>(a),  static_cast<const float*>(b),
            static_cast<const float*>(c),  static_cast<const float*>(d),
            static_cast<float*>(y),        B, S, H, P, N, Q,
            sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs};
  const size_t bytes = smem_floats(N, P, Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0 && S > 0 && H > 0)
    ssd_kernel<<<B * H, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
        args);
  return static_cast<int>(cudaGetLastError());
}
