// Full-Stokes detection on Hopper: int16 I/Q -> I, Q, U, V -> integrate.
//
// Replaces the Stokes Pallas TPU kernels of paf_baseband2power_tpu:
//   * ops/pallas_power.py:baseband2stokes_pallas (_stokes_kernel), wire,
//     one window;
//   * ops/pallas_power.py:baseband2stokes_scrunch_pallas
//     (_make_stokes_scrunch_kernel), wire, nout windows;
//   * ops/pallas_power.py:baseband2stokes_scrunch_rows_pallas
//     (_make_stokes_rows_packed_kernel and _make_stokes_rows_kernel),
//     series rows, nout windows.
// All of them sum four products of each complex sample pair (x = pol 0,
// y = pol 1) by channel and window:
//     xx = |x|^2, yy = |y|^2, re = Re(x y*), im = Im(x y*),
// so one kernel family covers them with the layout as a template parameter
// and the window count as an argument, on the (frame, 16-byte column) walk
// of power.cu (geometry.cuh). The TPU needed lane rolls to bring y under x;
// here a thread's 16-byte load already holds whole pairs:
//   * wire: one vector is two samples (xr, xi, yr, yi) x 2;
//   * rows: x and y are adjacent series, ndf * 32 vectors apart; a thread
//     loads the same column of both and pairs their 32-bit (re, im) words.
// The TPU's packed and accumulating rows tiles (K7, K8) and its even-nout
// rule do not carry over.
//
// Bound: about 3.5 integer operations per byte (8 multiplies, the adds and
// four 64-bit accumulations per 8-byte pair) against power's 2, so at
// 3.35 TB/s the SMs' integer issue rate is close to the memory rate; this
// first version keeps power.cu's structure and does not trade one for the
// other.
//
// Sums are exact and signed: per sample xx and yy reach 2^31 (unsigned
// 32-bit), re reaches 2^31 (one past INT_MAX, so it is widened before its
// add), im stays within +-2147450880 (int32). Each thread accumulates in
// 64 bits, a block folds its threads into 4 x channel bins in shared memory,
// and one 64-bit atomicAdd per bin lands in an int64 (nout, 4, nchan)
// scratch: two's complement adds are exact mod 2^64 whatever the order, so
// the unsigned atomics give the signed sum. The finish kernel reads the
// scratch as signed, forms I = xx + yy, Q = xx - yy, U = 2 re, V = 2 im in
// int64, and converts to float32 through float64, dividing there for the
// mean, as the float64 golden model does.

#include <cstdint>

#include <cuda_runtime.h>

#include "geometry.cuh"

namespace {

using namespace pafb2p;

// One thread's sums of one channel's four terms.
struct Terms {
  long long xx = 0, yy = 0, re = 0, im = 0;
};

// Adds the pair x = xw, y = yw, each a 32-bit word of int16 (re, im), re in
// the low half.
__device__ __forceinline__ void add_pair(int xw, int yw, Terms& t) {
  const int xr = static_cast<short>(xw & 0xffff), xi = xw >> 16;
  const int yr = static_cast<short>(yw & 0xffff), yi = yw >> 16;
  t.xx += static_cast<unsigned>(xr * xr) + static_cast<unsigned>(xi * xi);
  t.yy += static_cast<unsigned>(yr * yr) + static_cast<unsigned>(yi * yi);
  t.re += static_cast<long long>(xr * yr) + xi * yi;
  t.im += xi * yr - xr * yi;
}

// Wire: column c holds the pairs of groups 2c (.x, .y) and 2c + 1 (.z, .w).
struct StokesWire : Wire {
  __device__ static void accumulate(const int4* x, int64_t f0, int64_t c,
                                    int nf, int64_t ndf, int64_t ncol,
                                    Terms& lo, Terms& hi) {
    const int4* p = x + start(f0, c, ndf, ncol);
    const int64_t s = stride(ncol);
#pragma unroll 8
    for (int i = 0; i < nf; ++i) {
      const int4 v = __ldg(p + i * s);
      add_pair(v.x, v.y, lo);
      add_pair(v.z, v.w, hi);
    }
  }
};

// Rows (nseries, ndf, 256) with series = chan * 2 + pol. Column c is vector
// c % 32 of channel c / 32, read from its x series and its y series; its
// four words are four samples of that channel. One bin per channel; lo and
// hi only split the sums for independent adds.
struct StokesRows {
  static constexpr int kBins = kThreads / kVecSeries;
  __device__ static void accumulate(const int4* x, int64_t f0, int64_t c,
                                    int nf, int64_t ndf, int64_t /*ncol*/,
                                    Terms& lo, Terms& hi) {
    const int4* px =
        x + (c / kVecSeries * 2 * ndf + f0) * kVecSeries + c % kVecSeries;
    const int4* py = px + ndf * kVecSeries;
#pragma unroll 8
    for (int i = 0; i < nf; ++i) {
      const int4 vx = __ldg(px + i * kVecSeries);
      const int4 vy = __ldg(py + i * kVecSeries);
      add_pair(vx.x, vy.x, lo);
      add_pair(vx.y, vy.y, hi);
      add_pair(vx.z, vy.z, lo);
      add_pair(vx.w, vy.w, hi);
    }
  }
  __device__ static int64_t bin_lo(int64_t c) { return c / kVecSeries; }
  __device__ static int64_t bin_hi(int64_t c) { return bin_lo(c); }
  __device__ static int64_t first_bin(int64_t c0) { return bin_lo(c0); }
};

template <int kBins>
__device__ __forceinline__ void add_bins(unsigned long long (*bins)[kBins],
                                         int64_t b, const Terms& t) {
  atomicAdd(&bins[0][b], static_cast<unsigned long long>(t.xx));
  atomicAdd(&bins[1][b], static_cast<unsigned long long>(t.yy));
  atomicAdd(&bins[2][b], static_cast<unsigned long long>(t.re));
  atomicAdd(&bins[3][b], static_cast<unsigned long long>(t.im));
}

// grid.x = nout * slabs per window, grid.y = column tiles. acc is
// (nout, 4, nchan) with the terms in the order xx, yy, re, im.
template <class L>
__global__ void __launch_bounds__(kThreads)
stokes_kernel(const int4* __restrict__ x, int64_t ndf, int64_t ndf_w,
              int64_t spw, int64_t ncol, int64_t nchan,
              unsigned long long* __restrict__ acc) {
  __shared__ unsigned long long bins[4][L::kBins];
  static_assert(4 * L::kBins <= kThreads, "one thread per bin");
  if (threadIdx.x < 4 * L::kBins) (&bins[0][0])[threadIdx.x] = 0;

  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kThreads;
  const int64_t c = c0 + threadIdx.x;
  const Slab sl = block_slab(ndf_w, spw);

  Terms lo, hi;
  if (c < ncol) L::accumulate(x, sl.f0, c, sl.nf, ndf, ncol, lo, hi);
  __syncthreads();
  const int64_t b0 = L::first_bin(c0);
  if (c < ncol) {
    add_bins<L::kBins>(bins, L::bin_lo(c) - b0, lo);
    add_bins<L::kBins>(bins, L::bin_hi(c) - b0, hi);
  }
  __syncthreads();
  if (threadIdx.x < 4 * L::kBins) {
    const int q = threadIdx.x / L::kBins;
    const int b = threadIdx.x % L::kBins;
    if (b0 + b < nchan && bins[q][b] != 0) {
      atomicAdd(acc + (sl.w * 4 + q) * nchan + b0 + b, bins[q][b]);
    }
  }
}

// acc (nout, 4, nchan) signed sums of xx, yy, re, im -> out (nout, 4, nchan)
// I, Q, U, V: exact in int64, then float64 (divided for the mean) -> float32.
__global__ void stokes_finish_kernel(const long long* __restrict__ acc,
                                     float* __restrict__ out, int64_t nout,
                                     int64_t nchan, double divisor) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nout * nchan) return;
  const int64_t base = i / nchan * 4 * nchan + i % nchan;
  const long long xx = acc[base], yy = acc[base + nchan];
  const long long re = acc[base + 2 * nchan], im = acc[base + 3 * nchan];
  const long long s[4] = {xx + yy, xx - yy, 2 * re, 2 * im};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const double v = static_cast<double>(s[q]);
    out[base + q * nchan] = static_cast<float>(divisor > 0.0 ? v / divisor : v);
  }
}

template <class L>
int launch_stokes(const void* x, int64_t ndf, int64_t ncol, int64_t nchan,
                  int64_t nout, void* acc, void* stream) {
  Grid g;
  const cudaError_t e = make_grid(ndf, ncol, nout, &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  stokes_kernel<L><<<g.blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), ndf, g.ndf_w, g.spw, ncol, nchan,
      static_cast<unsigned long long*>(acc));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Wire block (ndf, nchk * 3584) int16 -> acc (nout, 4, nchk * 7) int64 += terms.
int pafb2p_stokes_wire(const void* x, int64_t ndf, int64_t nchk, int64_t nout,
                       void* acc, void* stream) {
  return launch_stokes<StokesWire>(x, ndf, nchk * kVecChunk, nchk * kChanChk,
                                   nout, acc, stream);
}

// Rows block (nseries, ndf, 256) int16 -> acc (nout, 4, nseries / 2) int64
// += terms.
int pafb2p_stokes_rows(const void* x, int64_t nseries, int64_t ndf,
                       int64_t nout, void* acc, void* stream) {
  if (nseries % 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch_stokes<StokesRows>(x, ndf, nseries / 2 * kVecSeries,
                                   nseries / 2, nout, acc, stream);
}

// acc (nout, 4, nchan) int64 terms -> out (nout, 4, nchan) float32 I, Q, U,
// V; divisor <= 0 keeps the sum.
int pafb2p_stokes_finish(const void* acc, void* out, int64_t nout,
                         int64_t nchan, double divisor, void* stream) {
  if (nout <= 0 || nchan <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int64_t n = nout * nchan;
  stokes_finish_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                         threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(acc), static_cast<float*>(out), nout,
      nchan, divisor);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
