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
// weight (64 MiB in, 64 MiB out) needs about 0.040 ms at 3.35 TB/s.
//
// What the design does about it: one block per output tile, which is
// contiguous in the output, so the block's writes are one coalesced run;
// each row of the tile reads tc consecutive input elements, so the reads
// coalesce too. The padding is decided per element from the bounds, and
// the input is never padded in device memory first (the Pallas wrapper
// pads the whole matrix with jnp.pad before its kernel).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
pack_kernel(const T* __restrict__ w, T* __restrict__ out, int R, int C,
            int tr, int tc, int ncols) {
  const long long tile = blockIdx.x;
  const int i = static_cast<int>(tile / ncols);
  const int j = static_cast<int>(tile % ncols);
  const int r0 = i * tr, c0 = j * tc;
  const int size = tr * tc;
  T* o = out + tile * size;
  for (int e = threadIdx.x; e < size; e += THREADS) {
    const int gr = r0 + e / tc;
    const int gc = c0 + e % tc;
    o[e] = (gr < R && gc < C) ? w[(long long)gr * C + gc] : T(0);
  }
}

template <typename T>
void launch(const void* w, void* out, int R, int C, int tr, int tc,
            cudaStream_t stream) {
  const int nrows = (R + tr - 1) / tr;
  const int ncols = (C + tc - 1) / tc;
  const long long tiles = (long long)nrows * ncols;
  if (tiles > 0)
    pack_kernel<T><<<static_cast<unsigned>(tiles), THREADS, 0, stream>>>(
        static_cast<const T*>(w), static_cast<T*>(out), R, C, tr, tc, ncols);
}

}  // namespace

// w is [R, C] contiguous; out is [ceil(R/tr), ceil(C/tc), tr, tc]
// contiguous; itemsize is 1, 2, 4 or 8. Returns cudaGetLastError().
extern "C" int fm_layout_pack(const void* w, void* out, int R, int C, int tr,
                              int tc, int itemsize, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tr <= 0 || tc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (itemsize) {
    case 1: launch<uint8_t>(w, out, R, C, tr, tc, s); break;
    case 2: launch<uint16_t>(w, out, R, C, tr, tc, s); break;
    case 4: launch<uint32_t>(w, out, R, C, tr, tc, s); break;
    case 8: launch<uint64_t>(w, out, R, C, tr, tc, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
