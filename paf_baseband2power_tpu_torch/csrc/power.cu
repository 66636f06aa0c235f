// Direct power detection on Hopper: int16 I/Q -> |x|^2 -> integrate.
//
// Replaces the on-path Pallas TPU kernels of paf_baseband2power_tpu:
//   * ops/pallas_power.py:baseband2power_pallas (_power_kernel), wire, one window;
//   * ops/pallas_power.py:baseband2power_scrunch_pallas (_scrunch_fused_kernel
//     and _make_scrunch_kernel), wire, nout windows;
//   * ops/pallas_power.py:baseband2power_scrunch_rows_pallas
//     (_rows_power_kernel), series rows, nout windows, pol pairs folded.
// All three compute exact |x|^2 sums of int16 data grouped by channel and
// window, so one kernel family covers them with the layout as a template
// parameter and the window count as an argument. The TPU's tile classes,
// even-nout and power-of-two rules do not carry over: any nout dividing ndf.
//
// Bound: HBM bytes. A full block is 8192 frames x 48 chunks x 7168 B =
// 2.8 GB read once for 336 (x nout) outputs, about 2 integer ops per byte,
// so the kernel's only job is to stream the input at the memory rate:
//   * every thread issues 16-byte loads; neighbouring threads read
//     neighbouring 16-byte vectors, so each warp reads 512 contiguous bytes
//     per frame in both layouts;
//   * a thread walks kFrames frames of one column with a fixed stride, its
//     loads independent of each other (unrolled), to keep enough bytes in
//     flight;
//   * blocks tile (window slab) x (column tile): 10752 blocks of 256 threads
//     at 8192 x 48, many waves over 132 SMs.
// Sums are exact: each thread accumulates in 64-bit integers from the first
// term (four int16 squares reach 2^32), a block folds its threads into at
// most 14 channel bins in shared memory, and one 64-bit integer atomicAdd
// per bin lands in an int64 (nout, nchan) scratch. Integer addition is
// associative, so the result does not depend on the order blocks run in.
// A second tiny kernel converts the scratch to float32, dividing in float64
// for the mean, exactly as the float64 golden model does.

#include <cstdint>

#include <cuda_runtime.h>

#include "geometry.cuh"

namespace {

using namespace pafb2p;

// Rows layout (nseries, ndf, 256) int16 with series = chan * 2 + pol. Column
// c is vector c % 32 of series c / 32; both pols of a channel fold into one
// bin, c / 64.
struct Rows {
  static constexpr int kBins = kThreads / (2 * kVecSeries);
  __device__ static int64_t start(int64_t f, int64_t c, int64_t ndf,
                                  int64_t /*ncol*/) {
    return (c / kVecSeries * ndf + f) * kVecSeries + c % kVecSeries;
  }
  __device__ static int64_t stride(int64_t /*ncol*/) { return kVecSeries; }
  __device__ static int64_t bin_lo(int64_t c) { return c / (2 * kVecSeries); }
  __device__ static int64_t bin_hi(int64_t c) { return bin_lo(c); }
  __device__ static int64_t first_bin(int64_t c0) { return bin_lo(c0); }
};

// |a|^2 + |b|^2 of the two int16 halves of a 32-bit word; <= 2^31 fits.
__device__ __forceinline__ unsigned int sq2(int w) {
  const int a = static_cast<short>(w & 0xffff);
  const int b = w >> 16;
  return static_cast<unsigned int>(a * a) + static_cast<unsigned int>(b * b);
}

// grid.x = nout * slabs per window, grid.y = column tiles.
template <class L>
__global__ void __launch_bounds__(kThreads)
power_kernel(const int4* __restrict__ x, int64_t ndf, int64_t ndf_w,
             int64_t spw, int64_t ncol, int64_t nchan,
             unsigned long long* __restrict__ acc) {
  __shared__ unsigned long long bins[L::kBins];
  if (threadIdx.x < L::kBins) bins[threadIdx.x] = 0;

  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kThreads;
  const int64_t c = c0 + threadIdx.x;
  const Slab sl = block_slab(ndf_w, spw);

  unsigned long long lo = 0, hi = 0;
  if (c < ncol) {
    const int4* p = x + L::start(sl.f0, c, ndf, ncol);
    const int64_t s = L::stride(ncol);
#pragma unroll 8
    for (int i = 0; i < sl.nf; ++i) {
      const int4 v = __ldg(p + i * s);
      lo += static_cast<unsigned long long>(sq2(v.x)) + sq2(v.y);
      hi += static_cast<unsigned long long>(sq2(v.z)) + sq2(v.w);
    }
  }
  __syncthreads();
  const int64_t b0 = L::first_bin(c0);
  if (c < ncol) {
    atomicAdd(&bins[L::bin_lo(c) - b0], lo);
    atomicAdd(&bins[L::bin_hi(c) - b0], hi);
  }
  __syncthreads();
  if (threadIdx.x < L::kBins && b0 + threadIdx.x < nchan &&
      bins[threadIdx.x] != 0) {
    atomicAdd(acc + sl.w * nchan + b0 + threadIdx.x, bins[threadIdx.x]);
  }
}

// out = acc (sum) or acc / divisor (mean), in float64, rounded to float32.
__global__ void finish_kernel(const unsigned long long* __restrict__ acc,
                              float* __restrict__ out, int64_t n,
                              double divisor) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) {
    const double v = static_cast<double>(acc[i]);
    out[i] = static_cast<float>(divisor > 0.0 ? v / divisor : v);
  }
}

template <class L>
int launch_power(const void* x, int64_t ndf, int64_t ncol, int64_t nchan,
                 int64_t nout, void* acc, void* stream) {
  Grid g;
  const cudaError_t e = make_grid(ndf, ncol, nout, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  power_kernel<L><<<g.blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), ndf, g.ndf_w, g.spw, ncol, nchan,
      static_cast<unsigned long long*>(acc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Wire block (ndf, nchk * 3584) int16 -> acc (nout, nchk * 7) int64 += sums.
int pafb2p_power_wire(const void* x, int64_t ndf, int64_t nchk, int64_t nout,
                      void* acc, void* stream) {
  return launch_power<Wire>(x, ndf, nchk * kVecChunk, nchk * kChanChk, nout,
                            acc, stream);
}

// Rows block (nseries, ndf, 256) int16 -> acc (nout, nseries / 2) int64 += sums.
int pafb2p_power_rows(const void* x, int64_t nseries, int64_t ndf,
                      int64_t nout, void* acc, void* stream) {
  if (nseries % 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch_power<Rows>(x, ndf, nseries * kVecSeries, nseries / 2, nout,
                            acc, stream);
}

// acc (nout, nchan) int64 -> out (nout, nchan) float32; divisor <= 0 keeps
// the sum.
int pafb2p_power_finish(const void* acc, void* out, int64_t nout,
                        int64_t nchan, double divisor, void* stream) {
  if (nout <= 0 || nchan <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int64_t n = nout * nchan;
  finish_kernel<<<static_cast<unsigned>((n + threads - 1) / threads), threads,
                  0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(acc), static_cast<float*>(out), n,
      divisor);
  return static_cast<int>(cudaGetLastError());
}

const char* pafb2p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
