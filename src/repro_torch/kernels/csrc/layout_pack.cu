// layout_pack: repack a row-major [R, C] matrix into tiles
// [R/tr, C/tc, tr, tc], the rows and columns that pad R and C out to tile
// multiples written as zeros. A pure relayout: the output is the input's
// bits, moved, so it is bit-exact or wrong. Any element of 1, 2, 4 or 8
// bytes; the values are copied as unsigned integers of that width.
//
// Replaces: src/repro/kernels/layout_pack.py::layout_pack, the Pallas
// kernel with grid (R/tr, C/tc) that copies one (tr, tc) block per step
// from a pre-padded input into its tile of the output.
//
// What bounds it on an H100: bytes. It does no arithmetic; it reads R*C
// elements once and writes the padded Rp*Cp once. A 2048 x 8192 f32
// weight (67.1 MB in, 67.1 MB out) needs 0.0401 ms at 3.35 TB/s.
//
// The copy as runs. Output row t of tile (i, j) is tc contiguous elements,
// and so is its source, input row i*tr + t from column j*tc. Call it a
// run. Taken in output order, run q = (i*nC + j)*tr + t (nC = C/tc tiles
// across) is written at q*tc: the output is the runs back to back. So the
// pack is a copy of runs between two permuted addresses, coalesced on both
// sides when a warp copies whole runs.
//
// Which path applies (kernels/layout_pack.py::pack_plan decides, the
// wrapper passes its choice and grid here):
// * vector: C % tc == 0, tc*itemsize a multiple of 16 B, and both pointers
//   16-byte aligned. Then every run and every input row is a whole number
//   of 16-byte vectors (uint4), and the kernel copies vectors. At the
//   native tiles a run is 32 vectors (f32, (8, 128)) or 16 (bf16,
//   (16, 128)). Runs of 8, 16, 32 or 64 vectors take pack_vec<RUN>: a
//   thread owns one vector of a run, found from its index by a shift, and
//   loads UNROLL vectors (64 B) before it stores any; a block covers 16 KB
//   of the output, 4 tiles at the native tiles. Other runs take
//   pack_warp<uint4>: a warp owns a run, its lanes its vectors. Rows past
//   R (the last band when R % tr != 0) are stored as zero vectors by the
//   same stores.
// * general: everything else (columns to pad, runs that are not whole
//   vectors, a misaligned pointer, odd tiles): pack_warp<T> on elements,
//   a warp a run, 4 runs a warp, zeros past R and past C.
// Neither path divides per element or per vector. A thread (or warp)
// finds its first run's (i, j, t) by division once; its later runs are a
// fixed stride ahead, added digit by digit with carries (advance). All
// offsets are 64-bit.
//
// The grid: pack_plan gives each thread UNROLL vectors (each warp 4
// runs), so the grid runs in many waves and a thread's vectors lie a
// grid's width apart: with UNROLL 4, a quarter of the output. The blocks
// in flight then read and write four compact windows that move through
// the matrix together. The card ran this faster than one wave walking
// the whole matrix with a stride, or than 8 vectors a thread, and 2 a
// thread within 1% of it. With a cold L2 each pass shape runs within 6%
// of a plain device copy of the same bytes (cudaMemcpy device to
// device). Streaming cache hints (ld/st.global.cs) ran slower and are
// not used. The kernels are correct for any grid.
//
// What the card measured (NVIDIA H100 80GB HBM3, 700 W), by chip_smoke.py
// phase 8 and tools/layout_pack_compare.py: the pack of a GPT-Neo-1.3B
// layer's six weights in f32 and bf16, 12 launches, takes 0.1789 ms of
// kernel time with a cold L2 against a 0.1803 ms byte bound and 0.1793 ms
// for a plain device copy of the same bytes (PERF.md, section 6).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

// the walk over runs: the grid's geometry and a thread's (or warp's) stride
// in runs, split into the digits of q = (i*nC + j)*tr + t
struct Geo {
  long long runs;  // runs in the output: ceil(R/tr)*tr * nC
  long long step;  // runs between one run of a thread (or warp) and its next
  int R, tr, nC;
  int row;         // input row length, in units (vectors or elements)
  int run;         // units a run
  int st, sj, si;  // step = (si*nC + sj)*tr + st
};

struct Pos {
  int t, j, i;
};

__device__ __forceinline__ Pos position(long long q, const Geo& g) {
  Pos p;
  p.t = static_cast<int>(q % g.tr);
  const long long band_col = q / g.tr;
  p.j = static_cast<int>(band_col % g.nC);
  p.i = static_cast<int>(band_col / g.nC);
  return p;
}

// p moves g.step runs on: each digit below its radix, one carry each
__device__ __forceinline__ void advance(Pos& p, const Geo& g) {
  p.t += g.st;
  int carry = p.t >= g.tr;
  if (carry) p.t -= g.tr;
  p.j += g.sj + carry;
  carry = p.j >= g.nC;
  if (carry) p.j -= g.nC;
  p.i += g.si + carry;
}

// vector path, runs of RUN vectors: a thread per vector of a run
template <int RUN>
__global__ void __launch_bounds__(THREADS)
pack_vec(const uint4* __restrict__ w, uint4* __restrict__ out, Geo g) {
  static_assert(THREADS % RUN == 0, "a block holds whole runs");
  const int v = threadIdx.x % RUN;
  long long q = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x)
                / RUN;
  Pos p = position(q, g);
  while (q < g.runs) {
    uint4 buf[UNROLL];
    long long at[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      at[u] = q;
      buf[u] = uint4{};
      const int r = p.i * g.tr + p.t;
      if (q < g.runs && r < g.R)
        buf[u] = w[static_cast<long long>(r) * g.row + p.j * RUN + v];
      q += g.step;
      advance(p, g);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (at[u] < g.runs) out[at[u] * RUN + v] = buf[u];
  }
}

// a warp per run, its lanes over the run's units (vectors on the vector
// path's other runs, elements on the general path); units past R, or past
// the row's end in the last column of tiles, are zeros
template <typename T>
__global__ void __launch_bounds__(THREADS)
pack_warp(const T* __restrict__ w, T* __restrict__ out, Geo g) {
  const int lane = threadIdx.x % 32;
  long long q = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x)
                / 32;
  Pos p = position(q, g);
  for (; q < g.runs; q += g.step, advance(p, g)) {
    const int r = p.i * g.tr + p.t;
    const int c0 = p.j * g.run;
    const int have = r < g.R ? min(g.run, g.row - c0) : 0;
    const T* src = w + static_cast<long long>(r) * g.row + c0;
    T* dst = out + q * g.run;
    for (int c = lane; c < g.run; c += 32 * UNROLL) {
      T buf[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = c + 32 * u;
        buf[u] = e < have ? src[e] : T{};
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (c + 32 * u < g.run) dst[c + 32 * u] = buf[u];
    }
  }
}

// the walk's geometry: R rows of `row` units, runs of `run` units, tiles
// of tr rows, nc tiles across, `step` runs between a walker's runs
Geo geometry(int R, int row, int tr, int run, int nc, long long step) {
  Geo g;
  g.runs = static_cast<long long>((R + tr - 1) / tr) * tr * nc;
  g.step = step;
  g.R = R;
  g.tr = tr;
  g.nC = nc;
  g.row = row;
  g.run = run;
  g.st = static_cast<int>(step % tr);
  g.sj = static_cast<int>(step / tr % nc);
  g.si = static_cast<int>(step / tr / nc);
  return g;
}

template <typename T>
void launch_warp(const void* w, void* out, const Geo& g, int blocks,
                 cudaStream_t s) {
  pack_warp<T><<<blocks, THREADS, 0, s>>>(static_cast<const T*>(w),
                                          static_cast<T*>(out), g);
}

template <int RUN>
void launch_vec(const void* w, void* out, int R, int row, int tr, int nc,
                int blocks, cudaStream_t s) {
  const Geo g = geometry(R, row, tr, RUN, nc,
                         static_cast<long long>(blocks) * THREADS / RUN);
  pack_vec<RUN><<<blocks, THREADS, 0, s>>>(static_cast<const uint4*>(w),
                                           static_cast<uint4*>(out), g);
}

}  // namespace

// w is [R, C] contiguous; out is [ceil(R/tr), ceil(C/tc), tr, tc]
// contiguous; itemsize is 1, 2, 4 or 8. `vector` (1) or not (0), `blocks`
// and `threads` are pack_plan's: the vector path needs C % tc == 0, runs
// of whole 16-byte vectors and 16-byte aligned pointers, and threads is
// THREADS. Anything else returns cudaErrorInvalidValue without a launch.
// Returns cudaGetLastError().
extern "C" int fm_layout_pack(const void* w, void* out, int R, int C, int tr,
                              int tc, int itemsize, int vector, int blocks,
                              int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0 || C <= 0 || tr <= 0 || tc <= 0 || blocks <= 0 ||
      threads != THREADS)
    return bad;
  const long long warps = static_cast<long long>(blocks) * THREADS / 32;
  if (vector) {
    const long long run_bytes = static_cast<long long>(tc) * itemsize;
    if (C % tc != 0 || run_bytes % 16 != 0 ||
        reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return bad;
    const int run = static_cast<int>(run_bytes / 16);
    const int row = static_cast<int>(static_cast<long long>(C) * itemsize
                                     / 16);
    const int nc = C / tc;
    switch (run) {
      case 8: launch_vec<8>(w, out, R, row, tr, nc, blocks, s); break;
      case 16: launch_vec<16>(w, out, R, row, tr, nc, blocks, s); break;
      case 32: launch_vec<32>(w, out, R, row, tr, nc, blocks, s); break;
      case 64: launch_vec<64>(w, out, R, row, tr, nc, blocks, s); break;
      default:
        launch_warp<uint4>(w, out, geometry(R, row, tr, run, nc, warps),
                           blocks, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const Geo g = geometry(R, C, tr, tc, (C + tc - 1) / tc, warps);
  switch (itemsize) {
    case 1: launch_warp<uint8_t>(w, out, g, blocks, s); break;
    case 2: launch_warp<uint16_t>(w, out, g, blocks, s); break;
    case 4: launch_warp<uint32_t>(w, out, g, blocks, s); break;
    case 8: launch_warp<uint64_t>(w, out, g, blocks, s); break;
    default: return bad;
  }
  return static_cast<int>(cudaGetLastError());
}
