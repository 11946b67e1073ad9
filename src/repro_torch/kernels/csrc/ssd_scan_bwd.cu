// ssd_scan_bwd: the gradient of the Mamba-2 SSD chunked scan (ssd_scan.cu)
// for dy, f32 throughout, in seven kernels.
//
// The forward, per (batch, head, chunk of Q steps), L = cumsum(dt a) in the
// chunk, M_ij = C_i.B_j exp(L_i - L_j) dt_j for j <= i:
//   y_i   = sum_j M_ij X_j + exp(L_i) C_i . S_in + d X_i
//   S_out = exp(L_Q) S_in + sum_j w_j B_j (x) X_j,  w_j = exp(L_Q - L_j) dt_j
// with S_in of chunk c the S_out of chunk c - 1 (zero for the first).
//
// The gradient, with dS_c the gradient of the state leaving chunk c (zero
// for the last: the final state is no output of ops.ssd):
//   dS_{c-1} = exp(L_Q) dS_c + E_c,  E_c = sum_i exp(L_i) C_i (x) dy_i
//   dX_j  = dt_j v_j + w_j u_j + d dy_j,
//           v_j = sum_{i>=j} C_i.B_j exp(L_i - L_j) dy_i,  u_j = B_j dS_c
//   dG_ij = sum_h exp(L_i - L_j) dt_j (dy_i . X_j)        (j <= i; the
//           heads share b and c, so dG is summed over them before)
//   dC_i  = sum_h exp(L_i) S_in dy_i + sum_{j<=i} dG_ij B_j
//   dB_j  = sum_h w_j dS_c X_j      + sum_{i>=j} dG_ij C_i
//   dL_i  = dy_i . (y_i - d X_i) - dt_i (K_i + T_i)
//           + [i = Q-1] (exp(L_Q) <S_in, dS_c> + sum_j dt_j T_j),
//           K_j = v_j . X_j,  T_j = exp(L_Q - L_j) u_j . X_j
//   (the row terms of L_i, sum_j M_ij (dy_i . X_j) + exp(L_i) dy_i . C_i
//   S_in, are dy_i . (y_i - d X_i), read from the forward's y)
//   d(dt a) is dL's reverse cumsum in the chunk; ddt = a d(dt a) + K + T;
//   da = sum dt d(dt a) and dd = sum dy . X over batch and steps.
// autograd of the plain passes is what the wrapper and chip_smoke.py hold
// it to; kernels/ssd_scan_bwd.py::backward_passes states these terms in
// plain PyTorch.
//
// Replaces no Pallas kernel: the JAX package differentiates the jnp
// ssd_chunked (src/repro/models/ssm.py:93) with jax.value_and_grad. It is
// the gradient of src/repro/kernels/ssd_scan.py:97's function.
//
// What bounds it on an H100: operations. Per head and chunk it does six
// products of the forward's size (E, u, v, the dy . X pairs, S_in dy and
// dS X: four [Q x N x P] and two causal [Q x Q x P]) and, per batch row
// and chunk, two causal [Q x Q x N] (dG B, dG^T C): about 19.9 GFLOP at
// Mamba-2's training key (2, 4096, 24, 64, 128, 256), 0.297 ms at the
// 67 TFLOP/s f32 rate outside the tensor cores; its operands are some
// 260 MB (0.078 ms). This first version is simple and right: each kernel
// stages its operands through shared memory with plain loads and a lane
// holds a small register tile; no cp.async ring, no tensor cores (the
// checks are set for IEEE f32 FMAs).
//
// The forward's workspace is read, not recomputed: L [B,H,S], exp(L_Q)
// [B,H,nc], S_in [B,H,nc,N,P] and C B^T [B,nc,Q64,Q64] (g[j][i] = C_i.B_j,
// causal 64 x 64 tiles), and its output y.
//
// 1. bwd_dstate_kernel, a block per (batch, head, chunk): E_c, an
//    [N x Q] . [Q x P] product, into ds.
// 2. bwd_pass_kernel, a thread per (batch, head, 4 state elements): walks
//    the chunks from the last, in place: ds[c] = running; running =
//    exp(L_Q^c) running + E_c.
// 3. bwd_dx_kernel, a block per (batch, chunk, 64-column tile j, head): u
//    and v as two 4 x 4 lane tiles, then dX, K and T (K, T into [B,H,S]).
// 4. bwd_dg_kernel, a block per (batch, chunk, causal 64 x 64 tile of
//    (i, j)): walks the heads in order, summing exp(L_i - L_j) dt_j
//    (dy_i . X_j) into a 4 x 4 lane tile; writes dG[i][j] (zero where
//    j > i).
// 5. bwd_dbc_kernel, a block per (batch, chunk, 64-row tile): dC of the
//    tile's rows, then dB of the same rows, each a 4 x 8 lane tile over n:
//    the heads in order, then dG against B (or C).
// 6. bwd_dl_kernel, a block per (batch, head, chunk): dL, its reverse
//    cumsum, ddt, and the chunk's parts of da and dd.
// 7. bwd_sums_kernel: da and dd, a thread per head over (batch, chunk).
//
// Sums over heads, chunks and lanes run in one fixed order (no atomics),
// so two runs are bit-equal. Every exponential is one of the forward's own
// terms, exp(L_i - L_j) only where j <= i (masked before exp, never after)
// and never factored, so dt a of both signs gives finite terms wherever
// the reference's are. x, dt, b and c are read through their strides; dy
// and y are contiguous [B,S,H,P]; the gradients are written contiguous.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int QMAX = 256;    // the longest chunk
constexpr int PMAX = 64;
constexpr int NMAX = 128;
constexpr int TR = 64;       // rows (and columns) of a tile
constexpr int KT = 32;       // depth of a staged step
constexpr int TS = TR + 4;   // row stride of a staged [KT][TR] operand
constexpr int NS = NMAX + 4; // row stride of a staged [KT][NMAX] operand
constexpr int THREADS = 256;

struct Args {
  const float* x;
  const float* dt;
  const float* a;
  const float* b;
  const float* c;
  const float* d;
  const float* dy;   // [B,S,H,P]
  const float* y;    // [B,S,H,P] the forward's output
  const float* lw;   // [B,H,S] L
  const float* dec;  // [B,H,nc] exp(L_Q)
  const float* s_in; // [B,H,nc,N,P] S_in
  const float* g;    // [B,nc,q64,q64] g[j][i] = C_i . B_j
  float* dx;         // [B,S,H,P]
  float* ddt;        // [B,S,H]
  float* da;         // [H]
  float* db;         // [B,S,N]
  float* dc;         // [B,S,N]
  float* dd;         // [H]
  float* ds;         // [B,H,nc,N,P] E, then dS
  float* dgs;        // [B,nc,q64,q64] dG[i][j]
  float* kc;         // [B,H,S] K
  float* tq;         // [B,H,S] T
  float* hp;         // [B,H,nc,2] the chunk's parts of da and dd
  int B, S, H, P, N, Q, nc, q64;
  long long sxb, sxs, sxh;  // x strides in elements (P stride 1)
  long long sdb, sds, sdh;  // dt strides
  long long sbb, sbs;       // b strides (N stride 1)
  long long scb, scs;       // c strides (N stride 1)
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float xat(const Args& A, int bi, long long t,
                                     int h, int p) {
  return A.x[bi * A.sxb + t * A.sxs + h * A.sxh + p];
}
__device__ __forceinline__ float dtat(const Args& A, int bi, long long t,
                                      int h) {
  return A.dt[bi * A.sdb + t * A.sds + h * A.sdh];
}
__device__ __forceinline__ long long row4(const Args& A, int bi, long long t,
                                          int h) {
  return ((bi * (long long)A.S + t) * A.H + h) * A.P;  // dy, y, dx rows
}

// acc[r][q] += a[r] b[q] for a 4 x 4 lane tile
__device__ __forceinline__ void fma4x4(float (&acc)[4][4], float4 a,
                                       float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
}

// the sum of v over the block in one fixed order (warps by shuffles, then
// the warps' totals in turn); every thread gets it. red holds 9 floats.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) t += red[w];
    red[8] = t;
  }
  __syncthreads();
  return red[8];
}

// ---- 1. E_c = sum_i exp(L_i) C_i (x) dy_i ----------------------------------
// a lane holds rows n = tn*4 + r and columns p = tp*8 + q of [N x P]
__global__ void __launch_bounds__(THREADS) bwd_dstate_kernel(Args A) {
  __shared__ __align__(16) float cs[KT * NMAX];  // C rows [KT][NMAX]
  __shared__ __align__(16) float ys[KT * PMAX];  // exp(L_i) dy rows [KT][PMAX]
  __shared__ float el[QMAX];
  const int N = A.N, P = A.P, Q = A.Q, H = A.H;
  const int c = blockIdx.x % A.nc, bh = blockIdx.x / A.nc;
  const int bi = bh / H, h = bh % H;
  const long long t0 = (long long)c * Q;
  const int tid = threadIdx.x, tn = tid >> 3, tp = tid & 7;
  for (int i = tid; i < Q; i += THREADS)
    el[i] = __expf(A.lw[(long long)bh * A.S + t0 + i]);
  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  for (int i0 = 0; i0 < Q; i0 += KT) {
    __syncthreads();  // el is in place; the last step's operands are read
    for (int e = tid; e < KT * NMAX; e += THREADS) {
      const int r = e / NMAX, n = e % NMAX, i = i0 + r;
      cs[e] = i < Q && n < N ? A.c[bi * A.scb + (t0 + i) * A.scs + n] : 0.f;
    }
    for (int e = tid; e < KT * PMAX; e += THREADS) {
      const int r = e / PMAX, p = e % PMAX, i = i0 + r;
      ys[e] = i < Q && p < P ? el[i] * A.dy[row4(A, bi, t0 + i, h) + p] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KT; ++k) {
      const float4 cv = ld4(&cs[k * NMAX + tn * 4]);
      const float4 y0 = ld4(&ys[k * PMAX + tp * 8]);
      const float4 y1 = ld4(&ys[k * PMAX + tp * 8 + 4]);
      const float av[4] = {cv.x, cv.y, cv.z, cv.w};
      const float bv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
  }
  float* out = A.ds + ((long long)bh * A.nc + c) * N * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int n = tn * 4 + r;
    if (n >= N) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int p = tp * 8 + q;
      if (p < P) out[n * P + p] = acc[r][q];
    }
  }
}

// ---- 2. the states' gradients, from the last chunk -------------------------
__global__ void bwd_pass_kernel(const float* __restrict__ dec,
                                   float* __restrict__ ds, long long bh_count,
                                   int nc, int np4) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= bh_count * np4) return;
  const long long bh = idx / np4;
  float4* base = reinterpret_cast<float4*>(ds) + bh * nc * np4 + idx % np4;
  const float* f = dec + bh * nc;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    const float4 e = base[(long long)c * np4];
    base[(long long)c * np4] = run;
    const float fc = f[c];
    run.x = fmaf(fc, run.x, e.x);
    run.y = fmaf(fc, run.y, e.y);
    run.z = fmaf(fc, run.z, e.z);
    run.w = fmaf(fc, run.w, e.w);
  }
}

// ---- 3. dX, K and T, per head over a tile of columns j --------------------
// a lane holds rows j = j0 + tj*4 + r and columns p = tp*4 + q; u = B_j dS
// over n, then v = sum_{i>=j} C_i.B_j exp(L_i - L_j) dy_i over i
__global__ void __launch_bounds__(THREADS) bwd_dx_kernel(Args A) {
  __shared__ __align__(16) float as[KT * TS];    // B^T [n][j] or M^T [i][j]
  __shared__ __align__(16) float bs[KT * PMAX];  // dS rows [n][p] or dy [i][p]
  __shared__ float lq[QMAX];
  const int N = A.N, P = A.P, Q = A.Q, H = A.H;
  const int ntiles = A.q64 / TR;
  const int h = blockIdx.x % H;
  int rem = blockIdx.x / H;
  const int jt = rem % ntiles;
  rem /= ntiles;
  const int c = rem % A.nc, bi = rem / A.nc;
  const int j0 = jt * TR;
  const long long t0 = (long long)c * Q;
  const long long bh = (long long)bi * H + h;
  const int tid = threadIdx.x, tj = tid >> 4, tp = tid & 15;
  for (int i = tid; i < Q; i += THREADS) lq[i] = A.lw[bh * A.S + t0 + i];
  const float* dsb = A.ds + (bh * A.nc + c) * N * P;
  const float* gb = A.g + ((long long)bi * A.nc + c) * A.q64 * A.q64;

  float u[4][4], v[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) u[r][q] = v[r][q] = 0.f;
  for (int n0 = 0; n0 < N; n0 += KT) {
    __syncthreads();
    for (int e = tid; e < KT * TR; e += THREADS) {
      const int jl = e / KT, k = e % KT, j = j0 + jl, n = n0 + k;
      as[k * TS + jl] =
          j < Q && n < N ? A.b[bi * A.sbb + (t0 + j) * A.sbs + n] : 0.f;
    }
    for (int e = tid; e < KT * PMAX; e += THREADS) {
      const int k = e / PMAX, p = e % PMAX, n = n0 + k;
      bs[e] = n < N && p < P ? dsb[n * P + p] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KT; ++k)
      fma4x4(u, ld4(&as[k * TS + tj * 4]), ld4(&bs[k * PMAX + tp * 4]));
  }
  for (int i0 = j0; i0 < Q; i0 += KT) {
    __syncthreads();
    for (int e = tid; e < KT * TR; e += THREADS) {
      const int jl = e / KT, k = e % KT, j = j0 + jl, i = i0 + k;
      // the exponent is masked, never the result: L_i - L_j for j > i may
      // be large and positive
      const bool in = i < Q && j <= i;
      as[k * TS + jl] =
          in ? gb[(long long)j * A.q64 + i] * __expf(lq[i] - lq[j]) : 0.f;
    }
    for (int e = tid; e < KT * PMAX; e += THREADS) {
      const int k = e / PMAX, p = e % PMAX, i = i0 + k;
      bs[e] = i < Q && p < P ? A.dy[row4(A, bi, t0 + i, h) + p] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KT; ++k)
      fma4x4(v, ld4(&as[k * TS + tj * 4]), ld4(&bs[k * PMAX + tp * 4]));
  }
  const float d_h = A.d[h], l_last = lq[Q - 1];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + tj * 4 + r;
    float kpart = 0.f, tpart = 0.f, wl = 0.f;
    if (j < Q) {
      const float dtj = dtat(A, bi, t0 + j, h);
      wl = __expf(l_last - lq[j]);
      const long long row = row4(A, bi, t0 + j, h);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = tp * 4 + q;
        if (p >= P) continue;
        const float xv = xat(A, bi, t0 + j, h, p);
        A.dx[row + p] =
            fmaf(dtj, v[r][q], fmaf(wl * dtj, u[r][q], d_h * A.dy[row + p]));
        kpart = fmaf(v[r][q], xv, kpart);
        tpart = fmaf(u[r][q], xv, tpart);
      }
    }
    // the 16 lanes of a row are one half of a warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      kpart += __shfl_xor_sync(0xffffffffu, kpart, off);
      tpart += __shfl_xor_sync(0xffffffffu, tpart, off);
    }
    if (tp == 0 && j < Q) {
      A.kc[bh * A.S + t0 + j] = kpart;
      A.tq[bh * A.S + t0 + j] = wl * tpart;
    }
  }
}

// ---- 4. dG = sum_h exp(L_i - L_j) dt_j (dy_i . X_j), j <= i ---------------
// a lane holds rows i = i0 + ti*4 + r and columns j = j0 + tj*4 + q
__global__ void __launch_bounds__(THREADS) bwd_dg_kernel(Args A) {
  __shared__ __align__(16) float dyt[PMAX * TS];  // dy^T [p][i]
  __shared__ __align__(16) float xt[PMAX * TS];   // X^T [p][j]
  __shared__ float li[TR], lj[TR], dtj[TR];
  const int P = A.P, Q = A.Q, H = A.H;
  const int ntiles = A.q64 / TR;
  const int npairs = ntiles * (ntiles + 1) / 2;
  int pr = blockIdx.x % npairs;
  const int c = (blockIdx.x / npairs) % A.nc;
  const int bi = blockIdx.x / (npairs * A.nc);
  int it = 0;
  while (pr > it) pr -= ++it;
  const int i0 = it * TR, j0 = pr * TR;  // j0 <= i0
  const long long t0 = (long long)c * Q;
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  for (int h = 0; h < H; ++h) {
    __syncthreads();
    for (int e = tid; e < TR * PMAX; e += THREADS) {
      const int rl = e / PMAX, p = e % PMAX;
      const int i = i0 + rl, j = j0 + rl;
      dyt[p * TS + rl] =
          i < Q && p < P ? A.dy[row4(A, bi, t0 + i, h) + p] : 0.f;
      xt[p * TS + rl] = j < Q && p < P ? xat(A, bi, t0 + j, h, p) : 0.f;
    }
    if (tid < TR) {
      const long long lrow = ((long long)bi * H + h) * A.S + t0;
      const int i = i0 + tid, j = j0 + tid;
      li[tid] = i < Q ? A.lw[lrow + i] : 0.f;
      lj[tid] = j < Q ? A.lw[lrow + j] : 0.f;
      dtj[tid] = j < Q ? dtat(A, bi, t0 + j, h) : 0.f;
    }
    __syncthreads();
    float pv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) pv[r][q] = 0.f;
#pragma unroll 8
    for (int k = 0; k < P; ++k)
      fma4x4(pv, ld4(&dyt[k * TS + ti * 4]), ld4(&xt[k * TS + tj * 4]));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = ti * 4 + r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jl = tj * 4 + q;
        const bool in = i0 + il < Q && j0 + jl <= i0 + il;
        const float w = in ? __expf(li[il] - lj[jl]) * dtj[jl] : 0.f;
        acc[r][q] = fmaf(w, pv[r][q], acc[r][q]);
      }
    }
  }
  float* out = A.dgs + ((long long)bi * A.nc + c) * A.q64 * A.q64;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<float4*>(
        &out[(long long)(i0 + ti * 4 + r) * A.q64 + j0 + tj * 4]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// ---- 5. dC and dB of a tile's rows ----------------------------------------
// a lane holds rows ti*4 + r and columns n = tn*4 + q and 64 + tn*4 + q
__global__ void __launch_bounds__(THREADS) bwd_dbc_kernel(Args A) {
  __shared__ __align__(16) float as[KT * TS];  // [k][row of the tile]
  __shared__ __align__(16) float bs[KT * NS];  // [k][n]
  __shared__ float fh[TR];                     // a head's row factors
  const int N = A.N, P = A.P, Q = A.Q, H = A.H;
  const int ntiles = A.q64 / TR;
  const int t = blockIdx.x % ntiles;
  const int c = (blockIdx.x / ntiles) % A.nc;
  const int bi = blockIdx.x / (ntiles * A.nc);
  const int r0 = t * TR;
  const long long t0 = (long long)c * Q;
  const int tid = threadIdx.x, ti = tid >> 4, tn = tid & 15;
  const float* dgb = A.dgs + ((long long)bi * A.nc + c) * A.q64 * A.q64;
  float acc[4][8];

  auto mac = [&]() {
#pragma unroll 8
    for (int k = 0; k < KT; ++k) {
      const float4 av = ld4(&as[k * TS + ti * 4]);
      const float4 b0 = ld4(&bs[k * NS + tn * 4]);
      const float4 b1 = ld4(&bs[k * NS + 64 + tn * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b8[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(a4[r], b8[q], acc[r][q]);
    }
  };
  auto store = [&](float* out) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = r0 + ti * 4 + r;
      if (i >= Q) continue;
      float* row = out + ((long long)bi * A.S + t0 + i) * N;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = (q < 4 ? 0 : 64) + tn * 4 + (q & 3);
        if (n < N) row[n] = acc[r][q];
      }
    }
  };

  // side 0: dC_i = sum_h exp(L_i) S_in dy_i + sum_{j<=i} dG_ij B_j
  // side 1: dB_j = sum_h w_j dS_c X_j + sum_{i>=j} dG_ij C_i
  for (int side = 0; side < 2; ++side) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    for (int h = 0; h < H; ++h) {
      const long long bh = (long long)bi * H + h;
      const float* st = (side == 0 ? A.s_in : A.ds) + (bh * A.nc + c) * N * P;
      __syncthreads();  // fh and the stages are free
      if (tid < TR) {
        const int i = r0 + tid;
        float f = 0.f;
        if (i < Q) {
          const float l = A.lw[bh * A.S + t0 + i];
          f = side == 0 ? __expf(l)
                        : __expf(A.lw[bh * A.S + t0 + Q - 1] - l) *
                              dtat(A, bi, t0 + i, h);
        }
        fh[tid] = f;
      }
      for (int p0 = 0; p0 < P; p0 += KT) {
        __syncthreads();
        for (int e = tid; e < KT * TR; e += THREADS) {
          const int rl = e / KT, k = e % KT, i = r0 + rl, p = p0 + k;
          float v = 0.f;
          if (i < Q && p < P)
            v = fh[rl] * (side == 0 ? A.dy[row4(A, bi, t0 + i, h) + p]
                                    : xat(A, bi, t0 + i, h, p));
          as[k * TS + rl] = v;
        }
        for (int e = tid; e < KT * NMAX; e += THREADS) {
          const int n = e / KT, k = e % KT, p = p0 + k;
          bs[k * NS + n] = n < N && p < P ? st[n * P + p] : 0.f;
        }
        __syncthreads();
        mac();
      }
    }
    // dG against B over j <= i (side 0) or against C over i >= j (side 1);
    // dG is zero where j > i, and its tiles right of the diagonal are
    // never read
    const int k_lo = side == 0 ? 0 : r0;
    const int k_hi = side == 0 ? min(Q, r0 + TR) : Q;
    for (int k0 = k_lo; k0 < k_hi; k0 += KT) {
      __syncthreads();
      for (int e = tid; e < KT * TR; e += THREADS) {
        int rl, k;
        if (side == 0) {  // dG[i = r0 + rl][j = k0 + k], read along j
          rl = e / KT, k = e % KT;
        } else {          // dG[i = k0 + k][j = r0 + rl], read along j
          k = e / TR, rl = e % TR;
        }
        const int row = r0 + rl, kk = k0 + k;
        float v = 0.f;
        if (row < Q && kk < k_hi)
          v = side == 0 ? dgb[(long long)row * A.q64 + kk]
                        : dgb[(long long)kk * A.q64 + row];
        as[k * TS + rl] = v;
      }
      for (int e = tid; e < KT * NMAX; e += THREADS) {
        const int k = e / NMAX, n = e % NMAX, kk = k0 + k;
        float v = 0.f;
        if (kk < k_hi && n < N)
          v = side == 0 ? A.b[bi * A.sbb + (t0 + kk) * A.sbs + n]
                        : A.c[bi * A.scb + (t0 + kk) * A.scs + n];
        bs[k * NS + n] = v;
      }
      __syncthreads();
      mac();
    }
    store(side == 0 ? A.dc : A.db);
  }
}

// ---- 6. dL, d(dt a), ddt and the chunk's parts of da and dd ---------------
__global__ void __launch_bounds__(THREADS) bwd_dl_kernel(Args A) {
  __shared__ float rd[QMAX];  // dy_i . (y_i - d X_i), then dL, then d(dt a)
  __shared__ float red[9];
  const int N = A.N, P = A.P, Q = A.Q, H = A.H;
  const int c = blockIdx.x % A.nc;
  const long long bh = blockIdx.x / A.nc;
  const int bi = (int)(bh / H), h = (int)(bh % H);
  const long long t0 = (long long)c * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float d_h = A.d[h];
  // a warp a row: dy . (y - d X), and the lanes' parts of dy . X
  float ddp = 0.f;
  for (int i = warp; i < Q; i += THREADS / 32) {
    const long long row = row4(A, bi, t0 + i, h);
    float part = 0.f;
    for (int p = lane; p < P; p += 32) {
      const float xv = xat(A, bi, t0 + i, h, p), dyv = A.dy[row + p];
      part = fmaf(dyv, A.y[row + p] - d_h * xv, part);
      ddp = fmaf(dyv, xv, ddp);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) rd[i] = part;
  }
  const float dd_part = block_sum(ddp, red);
  // <S_in, dS_c>
  const float* s1 = A.s_in + (bh * A.nc + c) * N * P;
  const float* s2 = A.ds + (bh * A.nc + c) * N * P;
  float sp = 0.f;
  for (int e = tid; e < N * P; e += THREADS) sp = fmaf(s1[e], s2[e], sp);
  const float sdot = block_sum(sp, red);
  // dL_i, and sum_j dt_j T_j
  float dti = 0.f, ki = 0.f, ti_ = 0.f, tsum = 0.f;
  if (tid < Q) {
    dti = dtat(A, bi, t0 + tid, h);
    ki = A.kc[bh * A.S + t0 + tid];
    ti_ = A.tq[bh * A.S + t0 + tid];
    rd[tid] -= dti * (ki + ti_);
    tsum = dti * ti_;
  }
  const float tall = block_sum(tsum, red);  // its barriers order rd
  if (tid == 0) {
    rd[Q - 1] += A.dec[bh * A.nc + c] * sdot + tall;
    // the reverse cumsum, in order
    float run = 0.f;
    for (int i = Q - 1; i >= 0; --i) {
      run += rd[i];
      rd[i] = run;
    }
  }
  __syncthreads();
  float dap = 0.f;
  if (tid < Q) {
    const float dl = rd[tid];
    A.ddt[(bi * (long long)A.S + t0 + tid) * H + h] =
        A.a[h] * dl + ki + ti_;
    dap = dti * dl;
  }
  const float da_part = block_sum(dap, red);
  if (tid == 0) {
    A.hp[(bh * A.nc + c) * 2] = da_part;
    A.hp[(bh * A.nc + c) * 2 + 1] = dd_part;
  }
}

// ---- 7. da and dd over batch rows and chunks, in order ---------------------
__global__ void bwd_sums_kernel(const float* __restrict__ hp, float* da,
                                 float* dd, int B, int H, int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float sa = 0.f, sd = 0.f;
  for (int bi = 0; bi < B; ++bi) {
    const float* p = hp + ((long long)bi * H + h) * nc * 2;
    for (int c = 0; c < nc; ++c) {
      sa += p[2 * c];
      sd += p[2 * c + 1];
    }
  }
  da[h] = sa;
  dd[h] = sd;
}

int launch(const Args& A, cudaStream_t stream) {
  const long long bh = (long long)A.B * A.H;
  const int ntiles = A.q64 / TR;
  const long long pairs = (long long)ntiles * (ntiles + 1) / 2;
  bwd_dstate_kernel<<<(unsigned)(bh * A.nc), THREADS, 0, stream>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int np4 = A.N * A.P / 4;
  bwd_pass_kernel<<<(unsigned)((bh * np4 + 255) / 256), 256, 0, stream>>>(
      A.dec, A.ds, bh, A.nc, np4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dx_kernel<<<(unsigned)((long long)A.B * A.nc * ntiles * A.H), THREADS,
                  0, stream>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dg_kernel<<<(unsigned)((long long)A.B * A.nc * pairs), THREADS, 0,
                  stream>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dbc_kernel<<<(unsigned)((long long)A.B * A.nc * ntiles), THREADS, 0,
                   stream>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dl_kernel<<<(unsigned)(bh * A.nc), THREADS, 0, stream>>>(A);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_sums_kernel<<<(A.H + 127) / 128, 128, 0, stream>>>(A.hp, A.da, A.dd,
                                                         A.B, A.H, A.nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x/dt/b/c strides in elements; the last axis of x, b and c has stride 1;
// a and d are [H]; dy and y [B,S,H,P] contiguous; lw [B,H,S], dec
// [B,H,nc], s_in [B,H,nc,N,P] and g [B,nc,q64,q64] as ssd_scan.cu's
// fm_ssd_scan left them. Outputs dx [B,S,H,P], ddt [B,S,H], da [H], db and
// dc [B,S,N], dd [H], contiguous f32. Workspace, f32 contiguous: ds
// [B,H,nc,N,P], dgs [B,nc,q64,q64], kc and tq [B,H,S], hp [B,H,nc,2]. P is
// a multiple of 4 and at most 64, N from 1 to 128, Q at most 256 and
// divides S, q64 = Q rounded up to 64. Returns the first launch's
// cudaGetLastError() that is not cudaSuccess, else 0.
extern "C" int fm_ssd_scan_bwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* d, const void* dy, const void* y,
    const void* lw, const void* dec, const void* s_in, const void* g,
    void* dx, void* ddt, void* da, void* db, void* dc, void* dd, void* ds,
    void* dgs, void* kc, void* tq, void* hp, int B, int S, int H, int P,
    int N, int Q, int q64, long long sxb, long long sxs, long long sxh,
    long long sdb, long long sds, long long sdh, long long sbb,
    long long sbs, long long scb, long long scs, void* stream) {
  if (P % 4 != 0 || P > PMAX || N <= 0 || N > NMAX || Q <= 0 || Q > QMAX ||
      S % Q != 0 || q64 != (Q + TR - 1) / TR * TR)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto mf = [](void* p) { return static_cast<float*>(p); };
  Args A{cf(x),   cf(dt),  cf(a),   cf(b),   cf(c),   cf(d),   cf(dy),
         cf(y),   cf(lw),  cf(dec), cf(s_in), cf(g),   mf(dx),  mf(ddt),
         mf(da),  mf(db),  mf(dc),  mf(dd),  mf(ds),  mf(dgs), mf(kc),
         mf(tq),  mf(hp),  B,       S,       H,       P,       N,
         Q,       S / Q,   q64,     sxb,     sxs,     sxh,     sdb,
         sds,     sdh,     sbb,     sbs,     scb,     scs};
  return launch(A, static_cast<cudaStream_t>(stream));
}
