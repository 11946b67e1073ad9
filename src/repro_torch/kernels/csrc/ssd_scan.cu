// ssd_scan: the Mamba-2 SSD chunked scan, f32 throughout, as a
// chunk-parallel scan in four kernels.
//
//   per (batch, head, chunk of Q steps), with L = cumsum(dt * a) in the chunk:
//   y     = (C B^T o exp(L_i - L_j) [j <= i] o dt_j) X + exp(L_i) C . S_in
//           + d x                                                    [Q, P]
//   S_out = exp(L_Q) S_in + sum_j exp(L_Q - L_j) dt_j B_j (x) X_j    [N, P]
//
// x [B,S,H,P] and dt [B,S,H] are read in place through their strides
// (the model hands over views of the conv output); b and c [B,S,N] are
// shared by the heads of a batch row; y [B,S,H,P] is written contiguous.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan, the Pallas kernel
// with grid (B*H, S/Q), the chunk axis sequential and the [N, P] state in
// VMEM scratch. Hopper has no sequential grid axis: blocks run in parallel
// and in no order. The first port walked the chunks in order inside one
// block per (batch, head): 96 blocks of 8 warps on 132 SMs, C B^T formed
// again for every head, at 13.4x its bound.
//
// What bounds it on an H100: operations. At the Mamba-2-130M prefill shape
// (B 4, S 4096, H 24, P 64, N 128, Q 256) the least work is 19.89 GFLOP of
// f32 FMAs (C B^T over the causal pairs once per batch row and chunk; per
// head the causal half of (..) X, C . S_in and the chunk's state update in
// full): 0.297 ms at the 67 TFLOP/s f32 rate outside the tensor cores. Its
// operands are 220 MB (0.066 ms at 3.35 TB/s). The split into passes adds
// workspace traffic: the chunk states [B,H,nc,N,P] (50.3 MB, written by
// pass 1, read and rewritten in place by pass 2, read once per 64-row tile
// by pass 3: about 350 MB, 0.1 ms at the memory rate, some of it served
// from the 50 MB L2) and C B^T [B,nc,Q,Q] (16.8 MB, its causal tiles
// written once and read by pass 3). Fusing the state pass away (a
// look-back between chunk blocks) is later work. No tensor cores: the
// checks are set for IEEE f32 FMAs, so the FMA pipes are what to keep fed.
//
// The only sequential dependency is the [N, P] state handed from chunk to
// chunk, so it is split out and everything else runs in parallel:
//
// 1. chunk_state_kernel, a block per (batch, head, chunk): dt and L by a
//    block-wide scan (L is kept in a [B,H,S] workspace for pass 3), then
//    exp(L_Q), and the chunk's own state dS = B^T (w o X), w_j =
//    exp(L_Q - L_j) dt_j, an [N x Q] . [Q x P] product: 4 warps, each lane
//    an 8 x 8 register tile (1 byte of shared memory per FMA), fed by a
//    two-stage cp.async ring 32 steps deep, three blocks an SM; a lane
//    scales the X rows it copied by w once they land, so the product loop
//    is FMAs only.
// 2. state_pass_kernel, a thread per (batch, head, 4 state elements): walks
//    the chunks, S_in[c] = running; running = exp(L_Q^c) running + dS_c,
//    in place over the workspace, decay then add chunk by chunk as the
//    first port did. Eight chunks' dS are loaded before the walk over them.
// 3. The chunk outputs, in two launches.
//    cb_kernel, a block per (batch, chunk, causal 64 x 64 tile): C B^T
//    once per batch row (not per head), written transposed, [j][i], for
//    chunk_out_kernel's copies. Tiles above the diagonal are never formed.
//    chunk_out_kernel, a block per (batch, chunk, 64-row tile, group of 4
//    heads), a chunk's four row tiles side by side in the grid (they share
//    its C B^T and X in L2). C of the row tile is copied once, transposed,
//    and serves all 4 heads; each head has 2 warps, a lane an 8 x 8 tile of
//    y. One cp.async ring (three stages 32 deep, one barrier a stage)
//    streams S_in, then C B^T rows and X rows for j up to the tile's last
//    row. Left of the tile the decay factors through the tile's left
//    column r: exp(L_i - L_j) = exp(L_i - L_r) exp(L_r - L_j), so C B^T
//    itself is the A operand, shared by the 4 heads, and X's rows are
//    scaled by exp(L_r - L_j) dt_j as they land; exp(L_i - L_r) scales the
//    accumulated rows once. Only the diagonal tile's M = (C B^T) o
//    exp(L_i - L_j) o dt_j is formed element by element in shared memory,
//    one stage ahead and between the FMAs (the j > i terms are zero and
//    never exponentiated). d x is added from the diagonal stages' X rows.
//    The factoring needs L monotone within a chunk, which dt >= 0 (dt
//    after softplus, as the model hands it over) gives.
//
// Copies are 16-byte cp.async where x's, b's and c's rows are 16-byte
// aligned, 4-byte otherwise; the arithmetic is the same either way. No
// pass reads across batch rows, so a row's y does not depend on the batch.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int QMAX = 256;    // the longest chunk
constexpr int PMAX = 64;
constexpr int NMAX = 128;
constexpr int TR = 64;       // rows (and columns) of a C B^T / output tile
constexpr int KT = 32;       // depth of a ring stage
constexpr int UNROLL = 8;    // chunks the state pass loads at once

struct Args {
  const float* x;
  const float* dt;
  const float* a;
  const float* b;
  const float* c;
  const float* d;
  float* y;
  float* lw;   // [B,H,S] L = cumsum(dt a) within each chunk
  float* dec;  // [B,H,nc] exp(L_Q) of each chunk
  float* st;   // [B,H,nc,N,P] dS, then S_in
  float* g;    // [B,nc,Q64,Q64] C B^T transposed: g[j][i] = C_i . B_j
  int B, S, H, P, N, Q, nc, q64;
  long long sxb, sxs, sxh;  // x strides in elements (P stride 1)
  long long sdb, sds, sdh;  // dt strides
  long long sbb, sbs;       // b strides (N stride 1)
  long long scb, scs;       // c strides (N stride 1)
};

// 16- or 4-byte asynchronous copy to shared memory; zero-fills when !pred
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(pred ? 16 : 0));
  else
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[r][q] += a[r] b[q] for an 8 x 8 lane tile
__device__ __forceinline__ void fma8x8(float (&acc)[8][8], float4 a0,
                                       float4 a1, float4 b0, float4 b1) {
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
}

// ---- pass 1: L, exp(L_Q) and the chunk's own state dS ---------------------
constexpr int S1_THREADS = 128;
constexpr int S1_STAGES = 2;
constexpr int S1_B = KT * NMAX;
constexpr int S1_X = KT * PMAX;
constexpr size_t S1_SMEM =
    sizeof(float) * (S1_STAGES * (S1_B + S1_X) + 2 * QMAX + 32);

template <int VEC>
__global__ void __launch_bounds__(S1_THREADS, 3)
chunk_state_kernel(Args args) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                   // [S1_STAGES][KT][NMAX]
  float* xs = bs + S1_STAGES * S1_B;  // [S1_STAGES][KT][PMAX]
  float* ls = xs + S1_STAGES * S1_X;  // [QMAX] L
  float* ws = ls + QMAX;              // [QMAX] w
  float* red = ws + QMAX;             // [32] warp totals

  const int N = args.N, P = args.P, Q = args.Q, H = args.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x % args.nc;
  const int bh = blockIdx.x / args.nc;
  const int bi = bh / H, h = bh % H;
  const long long t0 = (long long)c * Q;
  const float* xp = args.x + bi * args.sxb + h * args.sxh + t0 * args.sxs;
  const float* bp = args.b + bi * args.sbb + t0 * args.sbs;
  const int nsteps = (Q + KT - 1) / KT;

  auto load = [&](int step) {
    const int j0 = step * KT, s = step % S1_STAGES;
    float* bd = bs + s * S1_B;
    float* xd = xs + s * S1_X;
#pragma unroll
    for (int e = tid; e < KT * NMAX / VEC; e += S1_THREADS) {
      const int r = e / (NMAX / VEC), col = (e % (NMAX / VEC)) * VEC;
      const bool ok = j0 + r < Q && col < N;
      cp_async<VEC>(bd + r * NMAX + col,
                    ok ? bp + (j0 + r) * args.sbs + col : args.b, ok);
    }
#pragma unroll
    for (int e = tid; e < KT * PMAX / VEC; e += S1_THREADS) {
      const int r = e / (PMAX / VEC), col = (e % (PMAX / VEC)) * VEC;
      const bool ok = j0 + r < Q && col < P;
      cp_async<VEC>(xd + r * PMAX + col,
                    ok ? xp + (j0 + r) * args.sxs + col : args.x, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < S1_STAGES - 1; ++s) {
    if (s < nsteps) load(s);
    cp_async_commit();
  }

  // dt and the inclusive cumsum of dt * a: lane t owns steps 2t and 2t+1,
  // a warp scan of the pairs, then the warps' totals
  const float a_h = args.a[h];
  const float* dtp = args.dt + bi * args.sdb + h * args.sdh + t0 * args.sds;
  const int i0 = 2 * tid;
  const float d0 = i0 < Q ? dtp[i0 * args.sds] : 0.f;
  const float d1 = i0 + 1 < Q ? dtp[(i0 + 1) * args.sds] : 0.f;
  const float v0 = d0 * a_h, v1 = d1 * a_h;
  const float pair = v0 + v1;
  float inc = pair;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += red[w];
  const float l0 = base + (inc - pair) + v0;
  const float l1 = l0 + v1;
  ls[i0] = l0;
  ls[i0 + 1] = l1;
  __syncthreads();
  const float l_last = ls[Q - 1];
  ws[i0] = i0 < Q ? __expf(l_last - l0) * d0 : 0.f;
  ws[i0 + 1] = i0 + 1 < Q ? __expf(l_last - l1) * d1 : 0.f;
  float* lout = args.lw + (long long)bh * args.S + t0;
  if (i0 < Q) lout[i0] = l0;
  if (i0 + 1 < Q) lout[i0 + 1] = l1;
  if (tid == 0) args.dec[(long long)bh * args.nc + c] = __expf(l_last);
  __syncthreads();

  // dS[n][p]: lane rows n = tn*4 + r (+64), columns p = tp*4 + q (+32)
  const int tn = tid >> 3, tp = tid & 7;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;

  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<S1_STAGES - 2>();
    {
      // this lane's own copies of X have landed: scale them by w_j
      const int j0 = t * KT;
      float* xd = xs + (t % S1_STAGES) * S1_X;
#pragma unroll
      for (int e = tid; e < KT * PMAX / VEC; e += S1_THREADS) {
        const int r = e / (PMAX / VEC), col = (e % (PMAX / VEC)) * VEC;
        const float w = ws[j0 + r];
#pragma unroll
        for (int v = 0; v < VEC; ++v) xd[r * PMAX + col + v] *= w;
      }
    }
    __syncthreads();
    if (t + S1_STAGES - 1 < nsteps) load(t + S1_STAGES - 1);
    cp_async_commit();
    const float* bsrc = bs + (t % S1_STAGES) * S1_B;
    const float* xsrc = xs + (t % S1_STAGES) * S1_X;
#pragma unroll 4
    for (int k = 0; k < KT; ++k)
      fma8x8(acc, ld4(&bsrc[k * NMAX + tn * 4]),
             ld4(&bsrc[k * NMAX + 64 + tn * 4]),
             ld4(&xsrc[k * PMAX + tp * 4]),
             ld4(&xsrc[k * PMAX + 32 + tp * 4]));
  }
  cp_async_wait<0>();

  float* out = args.st + ((long long)bh * args.nc + c) * N * P;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int n = (r < 4 ? 0 : 64) + tn * 4 + (r & 3);
    if (n >= N) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = hf * 32 + tp * 4;
      if (p < P)
        *reinterpret_cast<float4*>(&out[n * P + p]) =
            make_float4(acc[r][4 * hf], acc[r][4 * hf + 1],
                        acc[r][4 * hf + 2], acc[r][4 * hf + 3]);
    }
  }
}

// ---- pass 3a: C B^T, once per batch row and chunk --------------------------
constexpr int CB_THREADS = 256;
constexpr int CB_STR = NMAX + 4;  // C and B rows as they are, padded
constexpr size_t CB_SMEM = sizeof(float) * 2 * TR * CB_STR;

// A block forms one causal 64 x 64 tile (rows i, columns j <= i's tile):
// C and B rows copied as they lie (cp.async), each lane 4 rows i by 4
// columns j (j = tx + 16 q), reading 4 steps of n of a row as one vector.
template <int VEC>
__global__ void __launch_bounds__(CB_THREADS, 3) cb_kernel(Args args) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                // [TR][CB_STR] C rows i
  float* bs = smem + TR * CB_STR;  // [TR][CB_STR] B rows j
  const int N = args.N, Q = args.Q;
  const int ntiles = args.q64 / TR;
  const int npairs = ntiles * (ntiles + 1) / 2;
  int pr = blockIdx.x % npairs;
  const int c = (blockIdx.x / npairs) % args.nc;
  const int bi = blockIdx.x / (npairs * args.nc);
  int it = 0;
  while (pr > it) pr -= ++it;
  const int jt = pr;  // jt <= it
  const int i0 = it * TR, j0 = jt * TR;
  const long long t0 = (long long)c * Q;
  const float* cp = args.c + bi * args.scb + t0 * args.scs;
  const float* bp = args.b + bi * args.sbb + t0 * args.sbs;
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = tid; e < TR * NMAX / VEC; e += CB_THREADS) {
    const int r = e / (NMAX / VEC), n = (e % (NMAX / VEC)) * VEC;
    const bool ci = n < N && i0 + r < Q, bj = n < N && j0 + r < Q;
    cp_async<VEC>(cs + r * CB_STR + n,
                  ci ? cp + (i0 + r) * args.scs + n : args.c, ci);
    cp_async<VEC>(bs + r * CB_STR + n,
                  bj ? bp + (j0 + r) * args.sbs + n : args.b, bj);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int ty = tid >> 4, tx = tid & 15;  // rows i ty*4 + r, columns tx + 16 q
  float g[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) g[r][q] = 0.f;
  for (int n = 0; n < N; n += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      cv[r] = ld4(&cs[(ty * 4 + r) * CB_STR + n]);
      bv[r] = ld4(&bs[(tx + 16 * r) * CB_STR + n]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        g[r][q] = fmaf(cv[r].x, bv[q].x, g[r][q]);
        g[r][q] = fmaf(cv[r].y, bv[q].y, g[r][q]);
        g[r][q] = fmaf(cv[r].z, bv[q].z, g[r][q]);
        g[r][q] = fmaf(cv[r].w, bv[q].w, g[r][q]);
      }
  }
  float* out = args.g + ((long long)bi * args.nc + c) * args.q64 * args.q64;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    *reinterpret_cast<float4*>(
        &out[(long long)(j0 + tx + 16 * q) * args.q64 + i0 + ty * 4]) =
        make_float4(g[0][q], g[1][q], g[2][q], g[3][q]);
}

// ---- pass 2: the states handed from chunk to chunk -------------------------
__global__ void state_pass_kernel(const float* __restrict__ dec,
                                  float* __restrict__ st, long long bh_count,
                                  int nc, int np4) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= bh_count * np4) return;
  const long long bh = idx / np4;
  float4* base = reinterpret_cast<float4*>(st) + bh * nc * np4 + idx % np4;
  const float* dd = dec + bh * nc;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += UNROLL) {
    float4 ds[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c0 + u < nc) ds[u] = base[(long long)(c0 + u) * np4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (c0 + u < nc) {
        base[(long long)(c0 + u) * np4] = run;
        const float f = dd[c0 + u];
        run.x = fmaf(f, run.x, ds[u].x);
        run.y = fmaf(f, run.y, ds[u].y);
        run.z = fmaf(f, run.z, ds[u].z);
        run.w = fmaf(f, run.w, ds[u].w);
      }
    }
  }
}

// ---- pass 3b: the chunk's outputs -----------------------------------------
constexpr int HG = 4;                    // heads of a block, 2 warps each
constexpr int O_THREADS = 64 * HG;
constexpr int O_STAGES = 3;              // slots: step t, t+1 (M), t+2
constexpr int CT_STR = TR + 4;
constexpr int O_B = HG * KT * PMAX;      // S_in or X rows of the 4 heads
constexpr int O_G = KT * TR;             // C B^T rows
constexpr int O_M = HG * KT * TR;        // M of the 4 heads
constexpr size_t O_SMEM = sizeof(float) *
    (NMAX * CT_STR + 2 * HG * QMAX + O_STAGES * (O_B + O_G) + 2 * O_M);

template <int VEC>
__global__ void __launch_bounds__(O_THREADS, 1) chunk_out_kernel(Args args) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                          // [NMAX][CT_STR] C^T of the tile
  float* lh = ct + NMAX * CT_STR;            // [HG][QMAX] L
  float* dth = lh + HG * QMAX;               // [HG][QMAX] dt
  float* ring_b = dth + HG * QMAX;           // [O_STAGES][HG][KT][PMAX]
  float* ring_g = ring_b + O_STAGES * O_B;   // [O_STAGES][KT][TR]
  float* ms = ring_g + O_STAGES * O_G;       // [2][HG][KT][TR]

  const int N = args.N, P = args.P, Q = args.Q, H = args.H, S = args.S;
  const int ntiles = args.q64 / TR;
  const int ngroups = (H + HG - 1) / HG;
  const int it = ntiles - 1 - blockIdx.x % ntiles;  // a chunk's tiles together
  const int rem = blockIdx.x / ntiles;
  const int grp = rem % ngroups;
  const int c = (rem / ngroups) % args.nc;
  const int bi = rem / (ngroups * args.nc);
  const int i0 = it * TR;
  const long long t0 = (long long)c * Q;
  const int jmax = min(Q, i0 + TR);   // columns j < jmax reach this tile
  const int n1 = (N + KT - 1) / KT;   // steps over S_in
  const int nsteps = n1 + (jmax + KT - 1) / KT;

  const int tid = threadIdx.x;
  const float* xb = args.x + bi * args.sxb + t0 * args.sxs;
  const float* gb = args.g + ((long long)bi * args.nc + c) * args.q64 *
                                 args.q64;

  // a step's B operand rows (S_in, or X) into its ring slot ...
  auto load_b = [&](int step) {
    const int s = step % O_STAGES;
    float* bd = ring_b + s * O_B;
    if (step < n1) {
      const int n0 = step * KT;
#pragma unroll
      for (int e = tid; e < O_B / 4; e += O_THREADS) {
        const int hq = e / (KT * PMAX / 4);
        const int r = (e / (PMAX / 4)) % KT, col = (e % (PMAX / 4)) * 4;
        const int h = grp * HG + hq;
        const bool ok = h < H && n0 + r < N && col < P;
        const float* src =
            args.st + ((((long long)bi * H + h) * args.nc + c) * N + n0 + r) *
                          P + col;
        cp_async<4>(bd + (hq * KT + r) * PMAX + col, ok ? src : args.st, ok);
      }
    } else {
      const int j0 = (step - n1) * KT;
#pragma unroll
      for (int e = tid; e < O_B / VEC; e += O_THREADS) {
        const int hq = e / (KT * PMAX / VEC);
        const int r = (e / (PMAX / VEC)) % KT, col = (e % (PMAX / VEC)) * VEC;
        const int h = grp * HG + hq;
        const bool ok = h < H && j0 + r < jmax && col < P;
        const float* src = xb + (j0 + r) * args.sxs + h * args.sxh + col;
        cp_async<VEC>(bd + (hq * KT + r) * PMAX + col, ok ? src : args.x, ok);
      }
    }
  };
  // ... and its C B^T rows, one commit group each, C B^T first: the rows
  // of C B^T are wanted a step before the step (to form M), the B rows at
  // the step, so a step waits for all groups but the last
  auto load_g = [&](int step) {
    if (step < n1) return;
    const int j0 = (step - n1) * KT;
    float* gd = ring_g + (step % O_STAGES) * O_G;
#pragma unroll
    for (int e = tid; e < O_G / 4; e += O_THREADS) {
      const int r = e / (TR / 4), col = (e % (TR / 4)) * 4;
      const bool ok = j0 + r < jmax;
      cp_async<4>(gd + r * TR + col,
                  ok ? gb + (long long)(j0 + r) * args.q64 + i0 + col
                     : args.g, ok);
    }
  };
  auto load = [&](int step) {
    if (step < nsteps) load_g(step);
    cp_async_commit();
    if (step < nsteps) load_b(step);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < O_STAGES - 1; ++s) load(s);

  // C of the row tile, transposed, shared by the 4 heads (a warp reads 8
  // rows x 16 steps of n at once: 8 cache lines, stores 2-way conflicted);
  // L and dt of the chunk for each head (dt with the 4 heads fastest: they
  // lie side by side)
  const float* cp = args.c + bi * args.scb + t0 * args.scs;
  for (int e = tid; e < TR * NMAX / 4; e += O_THREADS) {
    const int r = (e >> 8) * 8 + (e & 7), n = ((e >> 3) & 31) * 4;
    const float* src = cp + (i0 + r) * args.scs + n;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (i0 + r < Q) {
      if constexpr (VEC == 4) {
        if (n < N) {
          const float4 f = *reinterpret_cast<const float4*>(src);
          v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < N) v[q] = src[q];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) ct[(n + q) * CT_STR + r] = v[q];
  }
  for (int e = tid; e < HG * QMAX; e += O_THREADS) {
    const int hq = e / QMAX, i = e % QMAX, h = grp * HG + hq;
    lh[e] = h < H && i < Q ? args.lw[((long long)bi * H + h) * S + t0 + i]
                           : 0.f;
  }
  for (int e = tid; e < HG * QMAX; e += O_THREADS) {
    const int hq = e % HG, i = e / HG, h = grp * HG + hq;
    dth[hq * QMAX + i] =
        h < H && i < Q
            ? args.dt[bi * args.sdb + (t0 + i) * args.sds + h * args.sdh]
            : 0.f;
  }

  const int hq = tid >> 6, u = tid & 63;
  // a lane's rows ti*4 + r (+32) and columns tp*4 + q (+32) of y
  const int ti = u >> 3, tp = u & 7;
  const int h = grp * HG + hq;
  const float d_h = h < H ? args.d[h] : 0.f;
  const float* lq = lh + hq * QMAX;
  const float* dq = dth + hq * QMAX;
  // in forming M a lane owns columns i0 + mc.. of rows k = mk + 4 m
  const int mk = u >> 4, mc = (u & 15) * 4;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  __syncthreads();  // C^T, L and dt are in place
  const float4 l4 = ld4(&lq[i0 + mc]);
  const float li[4] = {l4.x, l4.y, l4.z, l4.w};
  const float l_r = i0 > 0 ? lq[i0 - 1] : 0.f;
  if (i0 > 0) {
    // left of the tile dt_j becomes f_j = exp(L_r - L_j) dt_j (below)
    for (int e = tid; e < HG * i0; e += O_THREADS) {
      const int eh = e / i0, j = e % i0;
      dth[eh * QMAX + j] *=
          __expf(lh[eh * QMAX + i0 - 1] - lh[eh * QMAX + j]);
    }
    __syncthreads();
  }

  // The columns left of the tile (j < i0 <= i) factor through the last of
  // them, r = i0 - 1: exp(L_i - L_j) = exp(L_i - L_r) exp(L_r - L_j), both
  // exponents of one sign (L is monotone in a chunk: dt >= 0), so neither
  // factor overflows where the product does not. Their A operand is then
  // C B^T itself, shared by the 4 heads, and X's rows are scaled by
  // f_j = exp(L_r - L_j) dt_j as they land. Only the diagonal tile's M is
  // formed element by element, its j > i terms zero and never
  // exponentiated. acc holds exp(L_r) C.S_in + sum_{j<=r} .. until it is
  // scaled by exp(L_i - L_r).
  auto diagonal = [&](int t) { return (t - n1) * KT >= i0; };

  // One barrier a step. At step t, step t's B rows and step t+1's C B^T
  // rows have landed; a lane scales the X rows it copied for step t if
  // they lie left of the tile; the block refills the slot step t-1 used
  // with step t+2, and multiplies step t's A (C^T, C B^T, or M formed
  // during step t-1) into its B, forming M of step t+1 if it is diagonal,
  // into the M buffer step t-1 read, between the FMAs, a row of M per 4
  // steps of k, so the exponentials share the issue slots of the FMAs.
  auto step = [&](int t, const float* asrc, int astr) {
    cp_async_wait<1>();
    const int jt = (t - n1) * KT, tn = t + 1, jn = (tn - n1) * KT;
    if (t >= n1 && jt < i0) {
      float* bd = ring_b + (t % O_STAGES) * O_B;
#pragma unroll
      for (int e = tid; e < O_B / VEC; e += O_THREADS) {
        const int eh = e / (KT * PMAX / VEC);
        const int r = (e / (PMAX / VEC)) % KT, col = (e % (PMAX / VEC)) * VEC;
        const float f = dth[eh * QMAX + jt + r];
#pragma unroll
        for (int v = 0; v < VEC; ++v) bd[(eh * KT + r) * PMAX + col + v] *= f;
      }
    }
    __syncthreads();
    load(t + 2);
    const float* bsrc = ring_b + (t % O_STAGES) * O_B + hq * KT * PMAX;
    const bool form = tn >= n1 && tn < nsteps && jn >= i0;
    const float* gsrc = ring_g + (tn % O_STAGES) * O_G;
    float* md = ms + (tn & 1) * O_M + hq * KT * TR;
#pragma unroll 1
    for (int m = 0; m < KT / 4; ++m) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = 4 * m + kk;
        fma8x8(acc, ld4(&asrc[k * astr + ti * 4]),
               ld4(&asrc[k * astr + 32 + ti * 4]),
               ld4(&bsrc[k * PMAX + tp * 4]),
               ld4(&bsrc[k * PMAX + 32 + tp * 4]));
      }
      if (form) {
        // M = C B^T o exp(L_i - L_j) o dt_j for j <= i, each element once
        const int k = mk + 4 * m, j = jn + k;
        const float lj = lq[j], dj = dq[j];
        const float4 gv = ld4(&gsrc[k * TR + mc]);
        const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
        float mv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + mc + q;
          mv[q] = (j <= i && i < Q) ? gg[q] * __expf(li[q] - lj) * dj : 0.f;
        }
        *reinterpret_cast<float4*>(&md[k * TR + mc]) =
            make_float4(mv[0], mv[1], mv[2], mv[3]);
      }
    }
    return bsrc;
  };

  // acc = exp(L_r) C . S_in over the state's rows n ...
  for (int t = 0; t < n1; ++t) step(t, ct + t * KT * CT_STR, CT_STR);
  if (i0 > 0) {
    const float f = __expf(l_r);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] *= f;
  }
  // ... plus C B^T (f o X) over the columns left of the tile ...
  int t = n1;
  for (; t < nsteps && !diagonal(t); ++t)
    step(t, ring_g + (t % O_STAGES) * O_G, TR);
  // ... all scaled by exp(L_i - L_r) ...
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float f =
        __expf(lq[i0 + (r < 4 ? 0 : 32) + ti * 4 + (r & 3)] - l_r);
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] *= f;
  }
  // ... plus M X over the diagonal tile, and d x: the X rows of the tile's
  // own rows are these steps' (where j > i, M adds exact zeros)
  for (; t < nsteps; ++t) {
    const float* xs = step(t, ms + (t & 1) * O_M + hq * KT * TR, TR);
    const int j0 = (t - n1) * KT;
    const int half = j0 == i0 ? 0 : 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 x0 = ld4(&xs[(ti * 4 + r) * PMAX + tp * 4]);
      const float4 x1 = ld4(&xs[(ti * 4 + r) * PMAX + 32 + tp * 4]);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      if (half == 0) {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(d_h, xv[q], acc[r][q]);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          acc[4 + r][q] = fmaf(d_h, xv[q], acc[4 + r][q]);
      }
    }
  }
  cp_async_wait<0>();

  if (h >= H) return;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + (r < 4 ? 0 : 32) + ti * 4 + (r & 3);
    if (i >= Q) continue;
    float* yr = args.y + (((long long)bi * S + t0 + i) * H + h) * P;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = hf * 32 + tp * 4;
      if (p < P)
        *reinterpret_cast<float4*>(&yr[p]) =
            make_float4(acc[r][4 * hf], acc[r][4 * hf + 1], acc[r][4 * hf + 2],
                        acc[r][4 * hf + 3]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int VEC>
int launch(const Args& args, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = allow_smem(chunk_state_kernel<VEC>, S1_SMEM);
    if (err == cudaSuccess) err = allow_smem(cb_kernel<VEC>, CB_SMEM);
    if (err == cudaSuccess) err = allow_smem(chunk_out_kernel<VEC>, O_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int ntiles = args.q64 / TR;
  const long long bh = (long long)args.B * args.H;
  chunk_state_kernel<VEC><<<(unsigned)(bh * args.nc), S1_THREADS, S1_SMEM,
                            stream>>>(args);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pairs = (long long)ntiles * (ntiles + 1) / 2;
  cb_kernel<VEC><<<(unsigned)(args.B * args.nc * pairs), CB_THREADS, CB_SMEM,
                   stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int np4 = args.N * args.P / 4;
  const long long threads = bh * np4;
  state_pass_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      args.dec, args.st, bh, args.nc, np4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ngroups = (args.H + HG - 1) / HG;
  chunk_out_kernel<VEC><<<(unsigned)((long long)ntiles * args.B * args.nc *
                                     ngroups),
                          O_THREADS, O_SMEM, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory bytes of the largest pass's block (the wrapper checks the
// card's limit); the passes' tiles are fixed, so it does not depend on the
// shape, which the wrapper bounds by the limits below.
extern "C" long long fm_ssd_scan_smem_bytes(int, int, int) {
  size_t m = S1_SMEM > CB_SMEM ? S1_SMEM : CB_SMEM;
  return (long long)(m > O_SMEM ? m : O_SMEM);
}

// x/dt/b/c strides in elements; the last axis of x, b and c has stride 1;
// a and d are [H] contiguous; y is [B,S,H,P] contiguous. The workspace,
// f32 and contiguous: lw [B,H,S], dec [B,H,nc], st [B,H,nc,N,P] and g
// [B,nc,q64,q64], q64 = Q rounded up to the 64-row tile (the caller
// sizes g by it; another value is refused). P is a multiple of 4 and at
// most 64, N at most 128, Q at most 256 and divides S. Returns the first
// launch's cudaGetLastError() that is not cudaSuccess, else 0.
extern "C" int fm_ssd_scan(const void* x, const void* dt, const void* a,
                           const void* b, const void* c, const void* d,
                           void* y, void* lw, void* dec, void* st, void* g,
                           int B, int S, int H, int P, int N, int Q, int q64,
                           long long sxb, long long sxs, long long sxh,
                           long long sdb, long long sds, long long sdh,
                           long long sbb, long long sbs, long long scb,
                           long long scs, void* stream) {
  if (P % 4 != 0 || P > PMAX || N > NMAX || Q <= 0 || Q > QMAX ||
      S % Q != 0 || q64 != (Q + TR - 1) / TR * TR)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  Args args{static_cast<const float*>(x), static_cast<const float*>(dt),
            static_cast<const float*>(a), static_cast<const float*>(b),
            static_cast<const float*>(c), static_cast<const float*>(d),
            static_cast<float*>(y), static_cast<float*>(lw),
            static_cast<float*>(dec), static_cast<float*>(st),
            static_cast<float*>(g), B, S, H, P, N, Q, S / Q, q64,
            sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs};
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool rows16 = N % 4 == 0 && sxb % 4 == 0 && sxs % 4 == 0 &&
                      sxh % 4 == 0 && sbb % 4 == 0 && sbs % 4 == 0 &&
                      scb % 4 == 0 && scs % 4 == 0 && aligned(x) &&
                      aligned(b) && aligned(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rows16 ? launch<4>(args, s) : launch<1>(args, s);
}
