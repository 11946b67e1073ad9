// ssd_scan_bwd: the gradient of the Mamba-2 SSD chunked scan (ssd_scan.cu)
// for dy, f32 in and out, in nine kernels; its dense products run on the
// tensor cores as 3xTF32 (below).
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
// plain PyTorch, its sums over heads in this file's groups.
//
// Replaces no Pallas kernel: the JAX package differentiates the jnp
// ssd_chunked (src/repro/models/ssm.py:93) with jax.value_and_grad. It is
// the gradient of src/repro/kernels/ssd_scan.py:97's function.
//
// What bounds it on an H100: operations. Per head and chunk it does six
// products of the forward's size (E, u, v, the dy . X pairs, S_in dy and
// dS X: four [Q x N x P] and two causal [Q x Q x P]) and, per batch row
// and chunk, two causal [Q x Q x N] (dG B, dG^T C): 20.0 GFLOP at
// Mamba-2's training key (2, 4096, 24, 64, 128, 256), 0.2986 ms at the
// 67 TFLOP/s f32 rate outside the tensor cores, or 0.121 ms for the 3x
// products at the 495 TFLOP/s TF32 rate; its operands are some 260 MB
// (0.078 ms). At Jamba's key (2, 4096, 128, 64, 16, 256) 43.7 GFLOP,
// 0.6522 ms (FMA), or 0.265 ms of 3xTF32 products under the 0.3315 ms
// its 1.11 GB of operands take.
//
// The products are mma.sync m16n8k8 TF32 tiles with the 3xTF32 split:
// each f32 operand x is hi = tf32(x) plus lo = tf32(x - hi), and a
// product is lo.hi + hi.lo + hi.hi, summed in f32. The term dropped,
// lo.lo, is under 2^-22 of the product, below the f32 rounding of the
// sums it enters, so the checks stay those of an f32 FMA kernel (every
// gradient within 1e-4 of its largest element). Single-pass TF32 (2^-11)
// would not hold them. The products that reach da directly (u, v) add
// each step of 8 to their sum with an f32 add (warp_mma's SEP), and dL's
// terms and reverse cumsum are summed in f64: da, a sum with
// cancellation, is the gradient that comes nearest its bound on some
// inputs. On an H100 80GB HBM3
// (700 W) this path took 0.78x the time of the same fragments on the FMA
// units at the Mamba-2 key and 0.83x at Jamba's, every gradient within
// 1.65e-5 of its largest element at both, so it is the one kept (the FMA
// variant, measured once in turns, is not kept: PERF.md). Every product stages its operands in
// shared memory through a cp.async ring (two or three stages); a warp
// holds a 16 x 16 to 32 x 64 tile of the product in its mma fragments.
//
// The forward's workspace is read, not recomputed: L [B,H,S], exp(L_Q)
// [B,H,nc], S_in [B,H,nc,N,P] and C B^T [B,nc,Q64,Q64] (g[j][i] = C_i.B_j,
// causal 64 x 64 tiles), and its output y.
//
// The heads are cut into G groups of hg = ceil(H / 8) heads (the wrapper's
// head_group: 8 groups of 3 heads at Mamba-2's 24, of 16 at Jamba's 128),
// so that the sums over heads run on 8 times the blocks; each group's
// part goes to a workspace and the parts are summed in group order.
//
// 1. bwd_dstate_kernel<NP>, a block per (batch, chunk, 1 to 4 heads):
//    E_c, [N x Q] . [Q x P], into ds. Its warps cover the state rows and,
//    where N is 16 or 32, more heads (4 heads of one warp each at N 16),
//    so no lane idles at a small d_state; C's rows serve them all.
// 2. bwd_pass_kernel, a thread per (batch, head, 4 state elements): walks
//    the chunks from the last, in place: ds[c] = running; running =
//    exp(L_Q^c) running + E_c.
// 3. bwd_dx_kernel, a block per (batch, chunk, 64-column tile j, head): u
//    (B rows against dS) and v (M^T against dy rows) in one ring, then,
//    from both staged in shared memory and the rows of x, dy and y, dX,
//    K + T and dL but for the chunk's last-row terms (into [B,H,S]), and
//    the tile's parts of sum_j dt_j T_j and dd.
// 4. bwd_dg_kernel, a block per (batch, chunk, causal 64 x 64 tile of
//    (i, j), head group): a head a ring stage, dy_i . X_j per head, summed
//    with exp(L_i - L_j) dt_j into the group's part of dG (zero where
//    j > i).
// 5. bwd_hsum_kernel<NP>, a block per (batch, chunk, dC or dB, 64-row
//    tile, head group): the group's part of sum_h exp(L_i) S_in dy_i (or
//    sum_h w_j dS_c X_j), a head a ring stage, its rows scaled as they
//    land.
// 6. bwd_gsum_kernel: dG, the groups' parts summed in order.
// 7. bwd_dbc_kernel<NP>, a block per (batch, chunk, dC or dB, 32-row
//    tile): dG against B (or dG^T against C), plus the groups' parts of
//    step 5 in order: 512 blocks at both keys.
// 8. bwd_dl_kernel, a block per (batch, head, chunk): dL's last-row
//    terms, its reverse cumsum, ddt, and the chunk's parts of da and dd.
// 9. bwd_sums_kernel: da and dd, a thread per head over (batch, chunk).
//
// Sums over heads, groups, chunks and lanes run in one fixed order (no
// atomics), so two runs are bit-equal. Every exponential is one of the
// forward's own terms, exp(L_i - L_j) only where j <= i (masked before
// exp, never after) and never factored, so dt a of both signs gives
// finite terms wherever the reference's are. x, dt, b and c are read
// through their strides (rows of x, b and c 16-byte aligned: the wrapper
// copies them where they are not); dy and y are contiguous [B,S,H,P]; the
// gradients are written contiguous.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int QMAX = 256;    // the longest chunk
constexpr int PMAX = 64;     // P is padded to 64 in the staged tiles
constexpr int NMAX = 128;
constexpr int TR = 64;       // rows (and columns) of a tile
constexpr int KT = 32;       // depth of a staged step
constexpr int THREADS = 128; // four warps
constexpr int GROUPS = 8;    // head groups (the wrapper sizes the parts)

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
  float* dgp;        // [B,nc,G,pairs,64,64] the groups' parts of dG
  float* hcp;        // [B,nc,2,G,q64,N] the groups' parts of dC and dB
  float* kc;         // [B,H,S] K
  float* tq;         // [B,H,S] T
  float* hp;         // [B,H,nc,2] the chunk's parts of da and dd
  float* tp;         // [B,H,nc,q64/64,2] a column tile's parts of sum_j
                     // dt_j T_j and of dd
  int B, S, H, P, N, Q, nc, q64, hg, groups, pairs;
  long long sxb, sxs, sxh;  // x strides in elements (P stride 1)
  long long sdb, sds, sdh;  // dt strides
  long long sbb, sbs;       // b strides (N stride 1)
  long long scb, scs;       // c strides (N stride 1)
};

// ---- copies ----------------------------------------------------------------
// 16- or 4-byte asynchronous copy to shared memory; zero-fills when !pred
__device__ __forceinline__ void cp16(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ long long row4(const Args& A, int bi, long long t,
                                          int h) {
  return ((bi * (long long)A.S + t) * A.H + h) * A.P;  // dy, y, dx rows
}
__device__ __forceinline__ const float* xrow(const Args& A, int bi,
                                             long long t, int h) {
  return A.x + bi * A.sxb + t * A.sxs + h * A.sxh;
}
__device__ __forceinline__ float dtat(const Args& A, int bi, long long t,
                                      int h) {
  return A.dt[bi * A.sdb + t * A.sds + h * A.sdh];
}

// ---- the products: m16n8k8 TF32 tiles, 3xTF32 ------------------------------
// A warp adds to acc[MT][NT] (MT 16-row by NT 8-column fragments at rows
// m0, columns n0) the product of a staged A and B over KD steps of k. A
// is [m][k] (AK false) or [k][m] (AK true), B [k][n] (BK true) or [n][k],
// with row strides lda, ldb (4 mod 32 for an [m][k] or [n][k] operand, 8
// or 24 for a [k][.] one: the fragments' loads hit 32 banks).
//
// The tensor cores' f32 sums do not round to nearest: summed into acc
// over a whole product, they bias it by up to some 2^-24 a step. With SEP
// each step of 8 goes into a zeroed fragment first, added to acc with an
// f32 add. dx takes SEP: its u and v reach da through a cancelling sum
// (dL's reverse cumsum), where without SEP and dL's sums in f64 da passed
// 1e-4 of its largest element on a card test at Jamba's d_state
// (1.19e-4); E reaches it only through dS's walk, and the other products
// reach no such sum.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;  // to nearest
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int MT, int NT, bool AK, bool BK, int KD, bool SEP = false>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4],
                                         const float* as, int lda,
                                         const float* bs, int ldb, int m0,
                                         int n0) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  auto ael = [&](int m, int k) {
    return AK ? as[k * lda + m] : as[m * lda + k];
  };
  auto bel = [&](int k, int n) {
    return BK ? bs[k * ldb + n] : bs[n * ldb + k];
  };
#pragma unroll
  for (int k0 = 0; k0 < KD; k0 += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = m0 + mt * 16 + gq;
      split(ael(r, k0 + tq), ah[mt][0], al[mt][0]);
      split(ael(r + 8, k0 + tq), ah[mt][1], al[mt][1]);
      split(ael(r, k0 + tq + 4), ah[mt][2], al[mt][2]);
      split(ael(r + 8, k0 + tq + 4), ah[mt][3], al[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + nt * 8 + gq;
      split(bel(k0 + tq, n), bh[nt][0], bl[nt][0]);
      split(bel(k0 + tq + 4, n), bh[nt][1], bl[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (SEP) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma(t, al[mt], bh[nt]);
          mma(t, ah[mt], bl[nt]);
          mma(t, ah[mt], bh[nt]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[e];
        } else {
          mma(acc[mt][nt], al[mt], bh[nt]);
          mma(acc[mt][nt], ah[mt], bl[nt]);
          mma(acc[mt][nt], ah[mt], bh[nt]);
        }
      }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// the row and column of fragment element e (rows m0 + mt*16 + gq (+8),
// columns n0 + nt*8 + 2 tq (+1))
__device__ __forceinline__ int frow(int m0, int mt, int e) {
  return m0 + mt * 16 + ((threadIdx.x & 31) >> 2) + (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int fcol(int n0, int nt, int e) {
  return n0 + nt * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

// a warp's fragments into rows of a [.][ld] tile
template <int MT, int NT>
__device__ __forceinline__ void stash(const float (&acc)[MT][NT][4],
                                      float* out, int ld, int m0, int n0) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(
            &out[frow(m0, mt, e) * ld + fcol(n0, nt, e)]) =
            make_float2(acc[mt][nt][e], acc[mt][nt][e + 1]);
}

// the sum of v over the block in one fixed order (warps by shuffles, then
// the warps' totals in turn); every thread gets it. red holds 9 floats.
__device__ float block_sum(float v, float* red, int threads) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < threads / 32; ++w) t += red[w];
    red[8] = t;
  }
  __syncthreads();
  return red[8];
}

// ---- 1. E_c = sum_i exp(L_i) C_i (x) dy_i ----------------------------------
// NP is N rounded up to 16, 32, 64 or 128. A block serves HPB heads; each
// head's [NP x 64] tile is split over WPH warps of MT 16-row fragments by
// 8 fragments of P.
template <int NP>
struct Ds {
  static constexpr int HPB = NP == 16 ? 4 : NP == 32 ? 2 : 1;
  static constexpr int WPH = 4 / HPB;
  static constexpr int MT = NP == 128 ? 2 : 1;
  static constexpr int CS = NP + 8;     // C rows [KT][CS]
  static constexpr int YS = PMAX + 8;   // exp(L) dy rows [HPB][KT][YS]
  static constexpr int STAGE = KT * CS + HPB * KT * YS;
  static constexpr int STAGES = 2;
  static constexpr size_t SMEM =
      sizeof(float) * (STAGES * STAGE + HPB * QMAX);
};

template <int NP>
__global__ void __launch_bounds__(THREADS, 3) bwd_dstate_kernel(Args A) {
  using K = Ds<NP>;
  extern __shared__ __align__(16) float smem[];
  static_assert(K::STAGES == 2, "t & 1 picks the stage");
  float* el = smem + K::STAGES * K::STAGE;  // [HPB][QMAX] exp(L)
  const int N = A.N, P = A.P, Q = A.Q, H = A.H;
  const int hblocks = (H + K::HPB - 1) / K::HPB;
  const int hb = blockIdx.x % hblocks;
  const int c = (blockIdx.x / hblocks) % A.nc;
  const int bi = blockIdx.x / (hblocks * A.nc);
  const long long t0 = (long long)c * Q;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int nsteps = (Q + KT - 1) / KT;
  const float* cp = A.c + bi * A.scb + t0 * A.scs;

  // this thread's copies of dy: rows e / 16 of the stage, 4 columns each
  auto dy_copy = [&](int e, int i0, int& hl, int& r, int& col, bool& ok) {
    hl = e / (KT * PMAX / 4);
    const int rem = e % (KT * PMAX / 4);
    r = rem / (PMAX / 4);
    col = (rem % (PMAX / 4)) * 4;
    ok = hb * K::HPB + hl < H && i0 + r < Q && col < P;
  };
  auto load = [&](int step) {
    float* st = smem + (step % K::STAGES) * K::STAGE;
    float* ys = st + KT * K::CS;
    const int i0 = step * KT;
    for (int e = tid; e < KT * NP / 4; e += THREADS) {
      const int r = e / (NP / 4), col = (e % (NP / 4)) * 4;
      const bool ok = i0 + r < Q && col < N;
      cp16(st + r * K::CS + col, ok ? cp + (i0 + r) * A.scs + col : A.c, ok);
    }
    for (int e = tid; e < K::HPB * KT * PMAX / 4; e += THREADS) {
      int hl, r, col;
      bool ok;
      dy_copy(e, i0, hl, r, col, ok);
      cp16(ys + (hl * KT + r) * K::YS + col,
           ok ? A.dy + row4(A, bi, t0 + i0 + r, hb * K::HPB + hl) + col
              : A.dy,
           ok);
    }
  };
  for (int e = tid; e < K::HPB * Q; e += THREADS) {
    const int hl = e / Q, i = e % Q, h = hb * K::HPB + hl;
    el[hl * QMAX + i] =
        h < H ? __expf(A.lw[((long long)bi * H + h) * A.S + t0 + i]) : 0.f;
  }
  __syncthreads();

  const int hw = warp / K::WPH, n0 = (warp % K::WPH) * 16 * K::MT;
  float acc[K::MT][8][4];
  zero(acc);
  // one call of load: t = -1 fills the first stage
  for (int t = -1; t < nsteps; ++t) {
    float* st = smem + (t & 1) * K::STAGE;
    float* ys = st + KT * K::CS;
    if (t >= 0) {
      cp_wait<0>();
      for (int e = tid; e < K::HPB * KT * PMAX / 4; e += THREADS) {
        int hl, r, col;
        bool ok;
        dy_copy(e, t * KT, hl, r, col, ok);
        if (ok) {
          const float f = el[hl * QMAX + t * KT + r];
          float* v = ys + (hl * KT + r) * K::YS + col;
          v[0] *= f, v[1] *= f, v[2] *= f, v[3] *= f;
        }
      }
      __syncthreads();
    }
    if (t + 1 < nsteps) load(t + 1);
    cp_commit();
    if (t < 0) continue;
    warp_mma<K::MT, 8, true, true, KT>(acc, st, K::CS, ys + hw * KT * K::YS,
                                        K::YS, n0, 0);
  }
  const int h = hb * K::HPB + hw;
  if (h >= H) return;
  float* out = A.ds + (((long long)bi * H + h) * A.nc + c) * N * P;
#pragma unroll
  for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int n = frow(n0, mt, e), p = fcol(0, nt, e);
        if (n < N && p < P)
          *reinterpret_cast<float2*>(&out[n * P + p]) =
              make_float2(acc[mt][nt][e], acc[mt][nt][e + 1]);
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
// u = B_j dS over n, then v = sum_{i>=j} C_i.B_j exp(L_i - L_j) dy_i over
// i, in one two-stage ring, into one accumulator (a warp's 32 x 32): u
// goes to shared memory when its steps end, so that four blocks fit an SM
// (128 registers; SEP's temporaries spill a few, and builds that gave them
// more registers and fewer blocks an SM ran slower)
constexpr int DX_AS = KT + 4;             // A [64][DX_AS]: B or M^T rows j
constexpr int DX_BS = PMAX + 8;           // B [KT][DX_BS]: dS or dy rows
constexpr int DX_STAGE = TR * DX_AS + KT * DX_BS;
constexpr int DX_STAGES = 2;
constexpr int UV_S = PMAX + 4;            // u and v rows
constexpr size_t DX_SMEM =
    sizeof(float) * (DX_STAGES * DX_STAGE + TR * UV_S + QMAX);
static_assert(TR * UV_S <= DX_STAGES * DX_STAGE, "v fits the ring");

__global__ void __launch_bounds__(THREADS, 4) bwd_dx_kernel(Args A) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[9];
  float* us = smem + DX_STAGES * DX_STAGE;  // [64][UV_S] u
  float* lq = us + TR * UV_S;               // [QMAX] L
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
  const int tid = threadIdx.x, warp = tid >> 5;
  const float* dsb = A.ds + (bh * A.nc + c) * N * P;
  const float* gb = A.g + ((long long)bi * A.nc + c) * A.q64 * A.q64;
  const float* bp = A.b + bi * A.sbb + t0 * A.sbs;
  const int nu = (N + KT - 1) / KT, nsteps = nu + (Q - j0 + KT - 1) / KT;

  auto load = [&](int s) {
    float* as = smem + (s % DX_STAGES) * DX_STAGE;
    float* bs = as + TR * DX_AS;
    if (s < nu) {  // B rows j over n, dS rows n
      const int n0 = s * KT;
      for (int e = tid; e < TR * KT / 4; e += THREADS) {
        const int jl = e / (KT / 4), k = (e % (KT / 4)) * 4;
        const bool ok = j0 + jl < Q && n0 + k < N;
        cp16(as + jl * DX_AS + k, ok ? bp + (j0 + jl) * A.sbs + n0 + k : A.b,
             ok);
      }
      for (int e = tid; e < KT * PMAX / 4; e += THREADS) {
        const int k = e / (PMAX / 4), p = (e % (PMAX / 4)) * 4;
        const bool ok = n0 + k < N && p < P;
        cp16(bs + k * DX_BS + p, ok ? dsb + (n0 + k) * P + p : A.ds, ok);
      }
    } else {       // C B^T rows j over i (scaled as they land), dy rows i
      const int i0 = j0 + (s - nu) * KT;
      for (int e = tid; e < TR * KT / 4; e += THREADS) {
        const int jl = e / (KT / 4), k = (e % (KT / 4)) * 4;
        const bool ok = j0 + jl < Q && i0 + k < Q;
        cp16(as + jl * DX_AS + k,
             ok ? gb + (long long)(j0 + jl) * A.q64 + i0 + k : A.g, ok);
      }
      for (int e = tid; e < KT * PMAX / 4; e += THREADS) {
        const int k = e / (PMAX / 4), p = (e % (PMAX / 4)) * 4;
        const bool ok = i0 + k < Q && p < P;
        cp16(bs + k * DX_BS + p,
             ok ? A.dy + row4(A, bi, t0 + i0 + k, h) + p : A.dy, ok);
      }
    }
  };
  for (int i = tid; i < Q; i += THREADS) lq[i] = A.lw[bh * A.S + t0 + i];
  __syncthreads();

  const int wm0 = (warp >> 1) * 32, wn0 = (warp & 1) * 32;
  // u for the first nu steps, then v
  float acc[2][4][4];
  zero(acc);
  // one call of load: the steps before 0 fill the ring
  for (int s = 1 - DX_STAGES; s < nsteps; ++s) {
    float* as = smem + ((s + DX_STAGES) % DX_STAGES) * DX_STAGE;
    if (s >= 0) cp_wait<DX_STAGES - 2>();
    if (s >= nu) {
      // this thread's copies of C B^T have landed: M^T[j][i] = g[j][i]
      // exp(L_i - L_j) where j <= i < Q; the exponent is masked, never the
      // result (L_i - L_j for j > i may be large and positive)
      const int i0 = j0 + (s - nu) * KT;
      for (int e = tid; e < TR * KT / 4; e += THREADS) {
        const int jl = e / (KT / 4), k = (e % (KT / 4)) * 4, j = j0 + jl;
        float* m = as + jl * DX_AS + k;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = i0 + k + q;
          m[q] = i < Q && j <= i ? m[q] * __expf(lq[i] - lq[j]) : 0.f;
        }
      }
    }
    if (s >= 0) __syncthreads();
    if (s + DX_STAGES - 1 < nsteps) load(s + DX_STAGES - 1);
    cp_commit();
    if (s < 0) continue;
    if (s == nu) {  // u is done
      stash(acc, us, UV_S, wm0, wn0);
      zero(acc);
    }
    warp_mma<2, 4, false, true, KT, true>(acc, as, DX_AS, as + TR * DX_AS,
                                           DX_BS, wm0, wn0);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free
  float* vs = smem;  // [64][UV_S]
  stash(acc, vs, UV_S, wm0, wn0);
  __syncthreads();
  // 8 lanes a row, 8 columns each: dX, K + T, and dL_j but for the
  // chunk's last-row terms, dy_j . (y_j - d X_j) - dt_j (K_j + T_j), its
  // cancelling terms summed in f64; the tile's parts of sum_j dt_j T_j
  // and of dd
  const float d_h = A.d[h], l_last = lq[Q - 1];
  const int lane8 = tid & 7;
  float tsum = 0.f, ddp = 0.f;
#pragma unroll
  for (int pass = 0; pass < TR / (THREADS / 8); ++pass) {
    const int jl = pass * (THREADS / 8) + (tid >> 3), j = j0 + jl;
    double kpart = 0.0, tpart = 0.0, rpart = 0.0;
    float wl = 0.f, dtj = 0.f;
    if (j < Q) {
      dtj = dtat(A, bi, t0 + j, h);
      wl = __expf(l_last - lq[j]);
      const long long row = row4(A, bi, t0 + j, h);
      const float* xr = xrow(A, bi, t0 + j, h);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = lane8 * 8 + hf * 4;
        if (p >= P) continue;
        const float4 xv = *reinterpret_cast<const float4*>(xr + p);
        const float4 dv = *reinterpret_cast<const float4*>(A.dy + row + p);
        const float4 yv = *reinterpret_cast<const float4*>(A.y + row + p);
        const float4 uv = *reinterpret_cast<const float4*>(&us[jl * UV_S + p]);
        const float4 vv = *reinterpret_cast<const float4*>(&vs[jl * UV_S + p]);
        const float wd = wl * dtj;
        *reinterpret_cast<float4*>(A.dx + row + p) = make_float4(
            fmaf(dtj, vv.x, fmaf(wd, uv.x, d_h * dv.x)),
            fmaf(dtj, vv.y, fmaf(wd, uv.y, d_h * dv.y)),
            fmaf(dtj, vv.z, fmaf(wd, uv.z, d_h * dv.z)),
            fmaf(dtj, vv.w, fmaf(wd, uv.w, d_h * dv.w)));
        kpart = fma((double)vv.x, (double)xv.x, kpart);
        kpart = fma((double)vv.y, (double)xv.y, kpart);
        kpart = fma((double)vv.z, (double)xv.z, kpart);
        kpart = fma((double)vv.w, (double)xv.w, kpart);
        tpart = fma((double)uv.x, (double)xv.x, tpart);
        tpart = fma((double)uv.y, (double)xv.y, tpart);
        tpart = fma((double)uv.z, (double)xv.z, tpart);
        tpart = fma((double)uv.w, (double)xv.w, tpart);
        rpart = fma((double)dv.x, (double)yv.x - (double)d_h * xv.x, rpart);
        rpart = fma((double)dv.y, (double)yv.y - (double)d_h * xv.y, rpart);
        rpart = fma((double)dv.z, (double)yv.z - (double)d_h * xv.z, rpart);
        rpart = fma((double)dv.w, (double)yv.w - (double)d_h * xv.w, rpart);
        ddp = fmaf(dv.x, xv.x, ddp);
        ddp = fmaf(dv.y, xv.y, ddp);
        ddp = fmaf(dv.z, xv.z, ddp);
        ddp = fmaf(dv.w, xv.w, ddp);
      }
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      kpart += __shfl_xor_sync(0xffffffffu, kpart, off);
      tpart += __shfl_xor_sync(0xffffffffu, tpart, off);
      rpart += __shfl_xor_sync(0xffffffffu, rpart, off);
    }
    if (lane8 == 0 && j < Q) {
      const double tj = wl * tpart, kt = kpart + tj;
      A.kc[bh * A.S + t0 + j] = (float)kt;
      A.tq[bh * A.S + t0 + j] = (float)(rpart - dtj * kt);
      tsum = fmaf(dtj, (float)tj, tsum);
    }
  }
  const float tall = block_sum(tsum, red, THREADS);
  const float dall = block_sum(ddp, red, THREADS);
  if (tid == 0) {
    float* out = A.tp + ((bh * A.nc + c) * ntiles + jt) * 2;
    out[0] = tall;
    out[1] = dall;
  }
}

// ---- 4. a head group's part of dG ------------------------------------------
// dG_ij += exp(L_i - L_j) dt_j (dy_i . X_j) for the group's heads in
// order, a head a ring stage: dy rows i and X rows j of the head (both
// [64][DG_S], k = p), and L_i, L_j, dt_j
constexpr int DG_S = PMAX + 4;
constexpr int DG_STAGE = 2 * TR * DG_S + 3 * TR;
constexpr int DG_STAGES = 2;
constexpr size_t DG_SMEM = sizeof(float) * DG_STAGES * DG_STAGE;

__device__ __forceinline__ void pair_of(int pr, int& it, int& jt) {
  it = 0;
  while (pr > it) pr -= ++it;
  jt = pr;  // jt <= it
}

__global__ void __launch_bounds__(THREADS, 3) bwd_dg_kernel(Args A) {
  extern __shared__ __align__(16) float smem[];
  const int P = A.P, Q = A.Q, H = A.H;
  const int pr = blockIdx.x % A.pairs;
  int rem = blockIdx.x / A.pairs;
  const int grp = rem % A.groups;
  rem /= A.groups;
  const int c = rem % A.nc, bi = rem / A.nc;
  int it, jt;
  pair_of(pr, it, jt);
  const int i0 = it * TR, j0 = jt * TR;
  const long long t0 = (long long)c * Q;
  const int h0 = grp * A.hg, hn = min(A.hg, H - h0);
  const int tid = threadIdx.x, warp = tid >> 5;

  auto load = [&](int s) {
    float* dys = smem + (s % DG_STAGES) * DG_STAGE;
    float* xs = dys + TR * DG_S;
    float* lv = xs + TR * DG_S;  // li, lj, dtj
    const int h = h0 + s;
    for (int e = tid; e < TR * PMAX / 4; e += THREADS) {
      const int rl = e / (PMAX / 4), p = (e % (PMAX / 4)) * 4;
      const bool oi = i0 + rl < Q && p < P, oj = j0 + rl < Q && p < P;
      cp16(dys + rl * DG_S + p,
           oi ? A.dy + row4(A, bi, t0 + i0 + rl, h) + p : A.dy, oi);
      cp16(xs + rl * DG_S + p, oj ? xrow(A, bi, t0 + j0 + rl, h) + p : A.x,
           oj);
    }
    if (tid < TR) {
      const float* lrow = A.lw + ((long long)bi * H + h) * A.S + t0;
      const bool oi = i0 + tid < Q, oj = j0 + tid < Q;
      cp4(lv + tid, oi ? lrow + i0 + tid : A.lw, oi);
      cp4(lv + TR + tid, oj ? lrow + j0 + tid : A.lw, oj);
      cp4(lv + 2 * TR + tid,
          oj ? A.dt + bi * A.sdb + (t0 + j0 + tid) * A.sds + h * A.sdh : A.dt,
          oj);
    }
  };
  const int wm0 = (warp >> 1) * 32, wn0 = (warp & 1) * 32;
  float acc[2][4][4];
  zero(acc);
  // one call of load: s = -1 fills the first stage
  for (int s = -1; s < hn; ++s) {
    if (s >= 0) {
      cp_wait<0>();
      __syncthreads();
    }
    if (s + 1 < hn) load(s + 1);
    cp_commit();
    if (s < 0) continue;
    const float* dys = smem + (s % DG_STAGES) * DG_STAGE;
    const float* xs = dys + TR * DG_S;
    const float* lv = xs + TR * DG_S;
    float pv[2][4][4];
    zero(pv);
    warp_mma<2, 4, false, false, PMAX>(pv, dys, DG_S, xs, DG_S, wm0, wn0);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = frow(wm0, mt, e), jl = fcol(wn0, nt, e);
          const bool in = i0 + il < Q && j0 + jl <= i0 + il;
          const float w =
              in ? __expf(lv[il] - lv[TR + jl]) * lv[2 * TR + jl] : 0.f;
          acc[mt][nt][e] = fmaf(w, pv[mt][nt][e], acc[mt][nt][e]);
        }
  }
  float* out = A.dgp + ((((long long)bi * A.nc + c) * A.groups + grp) *
                            A.pairs + pr) * TR * TR;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(
            &out[frow(wm0, mt, e) * TR + fcol(wn0, nt, e)]) =
            make_float2(acc[mt][nt][e], acc[mt][nt][e + 1]);
}

// ---- 5. a head group's part of the head terms of dC and dB ---------------
// side 0: rows i, sum_h exp(L_i) dy_i S_in^T; side 1: rows j, sum_h w_j
// X_j dS^T. A head a ring stage: its 64 rows [64][HS_S] (k = p, scaled by
// the row's factor as they land) and the state [NP][HS_S]; the output
// [64 x NP] over WM x WN warps.
template <int NP>
struct Hs {
  static constexpr int WN = NP == 16 ? 1 : 2;
  static constexpr int WM = 4 / WN;
  static constexpr int MT = TR / (16 * WM);
  static constexpr int NT = NP / (8 * WN);
  static constexpr int S = PMAX + 4;
  static constexpr int STAGE = (TR + NP) * S;
  static constexpr int STAGES = 2;
  static size_t smem(int hg) {
    return sizeof(float) * (STAGES * STAGE + (size_t)hg * TR);
  }
};

template <int NP>
__global__ void __launch_bounds__(THREADS, 3) bwd_hsum_kernel(Args A) {
  using K = Hs<NP>;
  extern __shared__ __align__(16) float smem[];
  float* fac = smem + K::STAGES * K::STAGE;  // [hg][TR] the rows' factors
  const int N = A.N, P = A.P, Q = A.Q, H = A.H;
  const int ntiles = A.q64 / TR;
  const int grp = blockIdx.x % A.groups;
  int rem = blockIdx.x / A.groups;
  const int rt = rem % ntiles;
  rem /= ntiles;
  const int side = rem % 2;
  rem /= 2;
  const int c = rem % A.nc, bi = rem / A.nc;
  const int r0 = rt * TR;
  const long long t0 = (long long)c * Q;
  const int h0 = grp * A.hg, hn = min(A.hg, H - h0);
  const int tid = threadIdx.x, warp = tid >> 5;

  auto load = [&](int s) {
    float* as = smem + (s % K::STAGES) * K::STAGE;
    float* bs = as + TR * K::S;
    const int h = h0 + s;
    for (int e = tid; e < TR * PMAX / 4; e += THREADS) {
      const int rl = e / (PMAX / 4), p = (e % (PMAX / 4)) * 4;
      const bool ok = r0 + rl < Q && p < P;
      const float* src = side == 0 ? A.dy + row4(A, bi, t0 + r0 + rl, h) + p
                                   : xrow(A, bi, t0 + r0 + rl, h) + p;
      cp16(as + rl * K::S + p, ok ? src : A.dy, ok);
    }
    const float* st = (side == 0 ? A.s_in : A.ds) +
                      (((long long)bi * H + h) * A.nc + c) * N * P;
    for (int e = tid; e < NP * PMAX / 4; e += THREADS) {
      const int n = e / (PMAX / 4), p = (e % (PMAX / 4)) * 4;
      const bool ok = n < N && p < P;
      cp16(bs + n * K::S + p, ok ? st + n * P + p : A.ds, ok);
    }
  };
  for (int e = tid; e < hn * TR; e += THREADS) {
    const int hl = e / TR, rl = e % TR, i = r0 + rl, h = h0 + hl;
    float f = 0.f;
    if (i < Q) {
      const float* lrow = A.lw + ((long long)bi * H + h) * A.S + t0;
      f = side == 0 ? __expf(lrow[i])
                    : __expf(lrow[Q - 1] - lrow[i]) * dtat(A, bi, t0 + i, h);
    }
    fac[e] = f;
  }
  __syncthreads();

  const int wm0 = (warp / K::WN) * K::MT * 16;
  const int wn0 = (warp % K::WN) * K::NT * 8;
  float acc[K::MT][K::NT][4];
  zero(acc);
  // one call of load: s = -1 fills the first stage
  for (int s = -1; s < hn; ++s) {
    float* as = smem + ((s + K::STAGES) % K::STAGES) * K::STAGE;
    if (s >= 0) {
      cp_wait<0>();
      for (int e = tid; e < TR * PMAX / 4; e += THREADS) {
        const int rl = e / (PMAX / 4), p = (e % (PMAX / 4)) * 4;
        const float f = fac[s * TR + rl];
        float* v = as + rl * K::S + p;
        v[0] *= f, v[1] *= f, v[2] *= f, v[3] *= f;
      }
      __syncthreads();
    }
    if (s + 1 < hn) load(s + 1);
    cp_commit();
    if (s < 0) continue;
    warp_mma<K::MT, K::NT, false, false, PMAX>(acc, as, K::S, as + TR * K::S,
                                                K::S, wm0, wn0);
  }
  float* out = A.hcp + ((((long long)bi * A.nc + c) * 2 + side) * A.groups +
                        grp) * A.q64 * N;
#pragma unroll
  for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + frow(wm0, mt, e), n = fcol(wn0, nt, e);
        if (r < Q && n < N) out[(long long)r * N + n] = acc[mt][nt][e];
      }
}

// ---- 6. dG: the groups' parts summed in order ------------------------------
__global__ void bwd_gsum_kernel(const float4* __restrict__ dgp,
                                float4* __restrict__ dgs, long long count,
                                int groups, int pairs, int q64) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= count) return;
  constexpr int T4 = TR * TR / 4;
  const int e = idx % T4;
  const int pr = (idx / T4) % pairs;
  const long long bc = idx / T4 / pairs;
  float4 s = dgp[(bc * groups * pairs + pr) * T4 + e];
  for (int g = 1; g < groups; ++g) {
    const float4 v = dgp[((bc * groups + g) * pairs + pr) * T4 + e];
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  int it, jt;
  pair_of(pr, it, jt);
  const int rl = e / (TR / 4), cl = (e % (TR / 4)) * 4;
  dgs[(bc * q64 * q64 + (long long)(it * TR + rl) * q64 + jt * TR + cl) / 4] =
      s;
}

// ---- 7. dC and dB of a 32-row tile -----------------------------------------
// side 0: dC_i = sum_{j<=i} dG_ij B_j; side 1: dB_j = sum_{i>=j} dG_ij C_i;
// then the head terms' group parts are added in order. A three-stage
// ring of dG (rows i over j, or rows i over columns j: dG^T) and B (or C)
// rows; the output [32 x NP] over WM x WN warps.
constexpr int BC_R = 32;
template <int NP>
struct Bc {
  static constexpr int WN = NP >= 64 ? 4 : 2;
  static constexpr int WM = 4 / WN;
  static constexpr int MT = BC_R / (16 * WM);
  static constexpr int NT = NP / (8 * WN);
  static constexpr int A0 = KT + 4;    // side 0: dG [32][A0], k = j
  static constexpr int A1 = BC_R + 8;  // side 1: dG [KT][A1], k = i
  static constexpr int AW = BC_R * A0 > KT * A1 ? BC_R * A0 : KT * A1;
  static constexpr int BS = NP + 8;    // B or C rows [KT][BS]
  static constexpr int STAGE = AW + KT * BS;
  static constexpr int STAGES = 3;
  static constexpr size_t SMEM = sizeof(float) * STAGES * STAGE;
};

template <int NP>
__global__ void __launch_bounds__(THREADS, 3) bwd_dbc_kernel(Args A) {
  using K = Bc<NP>;
  extern __shared__ __align__(16) float smem[];
  const int N = A.N, Q = A.Q;
  const int nrt = A.q64 / BC_R;
  const int rt = blockIdx.x % nrt;
  int rem = blockIdx.x / nrt;
  const int side = rem % 2;
  rem /= 2;
  const int c = rem % A.nc, bi = rem / A.nc;
  const int r0 = rt * BC_R;
  const long long t0 = (long long)c * Q;
  const int tid = threadIdx.x, warp = tid >> 5;
  const float* dgb = A.dgs + ((long long)bi * A.nc + c) * A.q64 * A.q64;
  // side 0 over j < min(Q, r0 + 32); side 1 over i from r0 to Q
  const int k_lo = side == 0 ? 0 : r0;
  const int k_hi = side == 0 ? min(Q, r0 + BC_R) : Q;
  const int nsteps = (k_hi - k_lo + KT - 1) / KT;
  const float* rows = side == 0 ? A.b + bi * A.sbb + t0 * A.sbs
                                : A.c + bi * A.scb + t0 * A.scs;
  const long long rs = side == 0 ? A.sbs : A.scs;

  auto load = [&](int s) {
    float* as = smem + (s % K::STAGES) * K::STAGE;
    float* bs = as + K::AW;
    const int k0 = k_lo + s * KT;
    for (int e = tid; e < BC_R * KT / 4; e += THREADS) {
      if (side == 0) {  // dG[i = r0 + rl][j = k0 + k]
        const int rl = e / (KT / 4), k = (e % (KT / 4)) * 4;
        const bool ok = r0 + rl < Q && k0 + k < k_hi;
        cp16(as + rl * K::A0 + k,
             ok ? dgb + (long long)(r0 + rl) * A.q64 + k0 + k : A.dgs, ok);
      } else {          // dG[i = k0 + k][j = r0 + m]
        const int k = e / (BC_R / 4), m = (e % (BC_R / 4)) * 4;
        const bool ok = k0 + k < k_hi;
        cp16(as + k * K::A1 + m,
             ok ? dgb + (long long)(k0 + k) * A.q64 + r0 + m : A.dgs, ok);
      }
    }
    for (int e = tid; e < KT * NP / 4; e += THREADS) {
      const int k = e / (NP / 4), n = (e % (NP / 4)) * 4;
      const bool ok = k0 + k < k_hi && n < N;
      cp16(bs + k * K::BS + n, ok ? rows + (k0 + k) * rs + n : A.b, ok);
    }
  };
  const int wm0 = (warp / K::WN) * K::MT * 16;
  const int wn0 = (warp % K::WN) * K::NT * 8;
  float acc[K::MT][K::NT][4];
  zero(acc);
  // one call of load: the steps before 0 fill the ring
  for (int s = 1 - K::STAGES; s < nsteps; ++s) {
    if (s >= 0) {
      cp_wait<K::STAGES - 2>();
      __syncthreads();
    }
    if (s + K::STAGES - 1 < nsteps) load(s + K::STAGES - 1);
    cp_commit();
    if (s < 0) continue;
    const float* as = smem + (s % K::STAGES) * K::STAGE;
    if (side == 0)
      warp_mma<K::MT, K::NT, false, true, KT>(acc, as, K::A0, as + K::AW,
                                               K::BS, wm0, wn0);
    else
      warp_mma<K::MT, K::NT, true, true, KT>(acc, as, K::A1, as + K::AW,
                                              K::BS, wm0, wn0);
  }
  cp_wait<0>();
  const float* part = A.hcp + (((long long)bi * A.nc + c) * 2 + side) *
                                  A.groups * A.q64 * N;
  float* out = (side == 0 ? A.dc : A.db) + ((long long)bi * A.S + t0) * N;
#pragma unroll
  for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + frow(wm0, mt, e), n = fcol(wn0, nt, e);
        if (r >= Q || n >= N) continue;
        float sum = 0.f;
        for (int g = 0; g < A.groups; ++g)
          sum += part[((long long)g * A.q64 + r) * N + n];
        out[(long long)r * N + n] = sum + acc[mt][nt][e];
      }
}

// ---- 8. dL's reverse cumsum, ddt and the chunk's parts of da and dd ------
// dL_i but for the last row's terms came from the dx pass (tq, and K + T
// in kc); the last row adds exp(L_Q) <S_in, dS_c> + sum_j dt_j T_j
constexpr int DL_THREADS = 256;
__global__ void __launch_bounds__(DL_THREADS) bwd_dl_kernel(Args A) {
  __shared__ float rd[QMAX];  // dL, then d(dt a)
  __shared__ float red[9];
  const int N = A.N, P = A.P, Q = A.Q, H = A.H;
  const int ntiles = A.q64 / TR;
  const int c = blockIdx.x % A.nc;
  const long long bh = blockIdx.x / A.nc;
  const int bi = (int)(bh / H), h = (int)(bh % H);
  const long long t0 = (long long)c * Q;
  const int tid = threadIdx.x;
  // <S_in, dS_c>
  const float* s1 = A.s_in + (bh * A.nc + c) * N * P;
  const float* s2 = A.ds + (bh * A.nc + c) * N * P;
  float sp = 0.f;
  for (int e = tid; e < N * P; e += DL_THREADS) sp = fmaf(s1[e], s2[e], sp);
  const float sdot = block_sum(sp, red, DL_THREADS);  // orders rd
  float dti = 0.f, kti = 0.f;
  if (tid < Q) {
    dti = dtat(A, bi, t0 + tid, h);
    kti = A.kc[bh * A.S + t0 + tid];
    rd[tid] = A.tq[bh * A.S + t0 + tid];
  }
  __syncthreads();
  if (tid == 0) {
    // the column tiles' parts in order
    const float* tp = A.tp + (bh * A.nc + c) * ntiles * 2;
    float tall = 0.f, dd = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      tall += tp[2 * t];
      dd += tp[2 * t + 1];
    }
    rd[Q - 1] += A.dec[bh * A.nc + c] * sdot + tall;
    A.hp[(bh * A.nc + c) * 2 + 1] = dd;
    // the reverse cumsum, in order, in f64
    double run = 0.0;
    for (int i = Q - 1; i >= 0; --i) {
      run += rd[i];
      rd[i] = (float)run;
    }
  }
  __syncthreads();
  float dap = 0.f;
  if (tid < Q) {
    const float dl = rd[tid];
    A.ddt[(bi * (long long)A.S + t0 + tid) * H + h] = A.a[h] * dl + kti;
    dap = dti * dl;
  }
  const float da_part = block_sum(dap, red, DL_THREADS);
  if (tid == 0) A.hp[(bh * A.nc + c) * 2] = da_part;
}

// ---- 9. da and dd over batch rows and chunks, in order ---------------------
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

template <typename F>
cudaError_t allow_smem(F kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NP>
int launch(const Args& A, cudaStream_t stream) {
  const size_t hs_smem = Hs<NP>::smem(A.hg);
  static size_t hs_allowed = 0;
  static bool configured = false;
  cudaError_t err = cudaSuccess;
  if (!configured) {
    err = allow_smem(bwd_dstate_kernel<NP>, Ds<NP>::SMEM);
    if (err == cudaSuccess) err = allow_smem(bwd_dx_kernel, DX_SMEM);
    if (err == cudaSuccess) err = allow_smem(bwd_dg_kernel, DG_SMEM);
    if (err == cudaSuccess) err = allow_smem(bwd_dbc_kernel<NP>, Bc<NP>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (hs_smem > hs_allowed) {
    err = allow_smem(bwd_hsum_kernel<NP>, hs_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    hs_allowed = hs_smem;
  }
  const long long bh = (long long)A.B * A.H;
  const long long bc = (long long)A.B * A.nc;
  const int ntiles = A.q64 / TR;
  const int hblocks = (A.H + Ds<NP>::HPB - 1) / Ds<NP>::HPB;
  bwd_dstate_kernel<NP><<<(unsigned)(bc * hblocks), THREADS, Ds<NP>::SMEM,
                          stream>>>(A);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int np4 = A.N * A.P / 4;
  bwd_pass_kernel<<<(unsigned)((bh * np4 + 255) / 256), 256, 0, stream>>>(
      A.dec, A.ds, bh, A.nc, np4);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dx_kernel<<<(unsigned)(bc * ntiles * A.H), THREADS, DX_SMEM, stream>>>(
      A);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dg_kernel<<<(unsigned)(bc * A.groups * A.pairs), THREADS, DG_SMEM,
                  stream>>>(A);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_hsum_kernel<NP><<<(unsigned)(bc * 2 * ntiles * A.groups), THREADS,
                        hs_smem, stream>>>(A);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long n4 = bc * A.pairs * TR * TR / 4;
  bwd_gsum_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(A.dgp),
      reinterpret_cast<float4*>(A.dgs), n4, A.groups, A.pairs, A.q64);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dbc_kernel<NP><<<(unsigned)(bc * 2 * (A.q64 / BC_R)), THREADS,
                       Bc<NP>::SMEM, stream>>>(A);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_dl_kernel<<<(unsigned)(bh * A.nc), DL_THREADS, 0, stream>>>(A);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  bwd_sums_kernel<<<(A.H + 127) / 128, 128, 0, stream>>>(A.hp, A.da, A.dd,
                                                         A.B, A.H, A.nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x/dt/b/c strides in elements; the last axis of x, b and c has stride 1,
// and their rows are 16-byte aligned (strides and bases: with N not a
// multiple of 4, b and c rows hold zeros up to the next multiple); a and
// d are [H]; dy and y [B,S,H,P] contiguous and 16-byte aligned; lw
// [B,H,S], dec [B,H,nc], s_in [B,H,nc,N,P] and g [B,nc,q64,q64] as
// ssd_scan.cu's fm_ssd_scan left them. Outputs dx [B,S,H,P], ddt [B,S,H],
// da [H], db and dc [B,S,N], dd [H], contiguous f32. Workspace, f32
// contiguous: ds [B,H,nc,N,P], dgs [B,nc,q64,q64], dgp
// [B,nc,groups,pairs,64,64] and hcp [B,nc,2,groups,q64,N] with hg heads a
// group, groups = ceil(H / hg) and pairs the causal 64 x 64 tiles of a
// chunk, kc and tq [B,H,S], hp [B,H,nc,2], tp [B,H,nc,q64/64,2]. P is a
// multiple of 4 and at
// most 64, N from 1 to 128, Q at most 256 and divides S, q64 = Q rounded
// up to 64. Returns the first launch's cudaGetLastError() that is not
// cudaSuccess, else 0.
extern "C" int fm_ssd_scan_bwd(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* d, const void* dy, const void* y,
    const void* lw, const void* dec, const void* s_in, const void* g,
    void* dx, void* ddt, void* da, void* db, void* dc, void* dd, void* ds,
    void* dgs, void* dgp, void* hcp, void* kc, void* tq, void* hp, void* tp,
    int B, int S, int H, int P, int N, int Q, int q64, int hg, long long sxb,
    long long sxs, long long sxh, long long sdb, long long sds,
    long long sdh, long long sbb, long long sbs, long long scb,
    long long scs, void* stream) {
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int groups = hg > 0 ? (H + hg - 1) / hg : 0;
  if (P % 4 != 0 || P > PMAX || N <= 0 || N > NMAX || Q <= 0 || Q > QMAX ||
      S % Q != 0 || q64 != (Q + TR - 1) / TR * TR || hg <= 0 ||
      groups > GROUPS || sxb % 4 || sxs % 4 || sxh % 4 || sbb % 4 ||
      sbs % 4 || scb % 4 || scs % 4 || !aligned(x) || !aligned(b) ||
      !aligned(c) || !aligned(dy))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto mf = [](void* p) { return static_cast<float*>(p); };
  const int ntiles = q64 / TR;
  Args A{cf(x),   cf(dt),  cf(a),    cf(b),   cf(c),   cf(d),   cf(dy),
         cf(y),   cf(lw),  cf(dec),  cf(s_in), cf(g),  mf(dx),  mf(ddt),
         mf(da),  mf(db),  mf(dc),   mf(dd),  mf(ds),  mf(dgs), mf(dgp),
         mf(hcp), mf(kc),  mf(tq),   mf(hp),  mf(tp),  B,       S,
         H,       P,       N,        Q,       S / Q,   q64,     hg,
         groups,  ntiles * (ntiles + 1) / 2, sxb,      sxs,     sxh,
         sdb,     sds,     sdh,      sbb,     sbs,     scb,     scs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 16) return launch<16>(A, s);
  if (N <= 32) return launch<32>(A, s);
  if (N <= 64) return launch<64>(A, s);
  return launch<128>(A, s);
}
