// Block geometry shared by the detection kernels (power.cu, stokes.cu).
//
// Both kernel families stream an int16 block as (frame, 16-byte column)
// with 16-byte loads: blocks of kThreads columns, each reading a slab of at
// most kFrames frames of one window. grid.x = nout * slabs per window,
// grid.y = column tiles. A window's last slab is masked, so any nout that
// divides ndf works.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace pafb2p {

constexpr int kThreads = 256;          // columns per block
constexpr int kFrames = 64;            // frames per block (one window slab)
constexpr int kChanChk = 7;            // channels per chunk
constexpr int64_t kVecChunk = 448;     // 16-byte vectors per chunk-frame (7168 B)
constexpr int64_t kVecSeries = 32;     // 16-byte vectors per series-frame (512 B)

// Wire layout (ndf, nchk * 3584) int16. Column c is the c-th 16-byte vector
// of a frame row; its 8 lanes are two 4-lane groups (xr, xi, yr, yi) of
// group index g = 2c and 2c + 1, with g = chunk * 896 + sample * 7 + chan.
struct Wire {
  static constexpr int kBins = 2 * kChanChk;  // 256 columns span <= 2 chunks
  __device__ static int64_t start(int64_t f, int64_t c, int64_t /*ndf*/,
                                  int64_t ncol) {
    return f * ncol + c;
  }
  __device__ static int64_t stride(int64_t ncol) { return ncol; }
  __device__ static int64_t chan(int64_t g) {
    return g / (2 * kVecChunk) * kChanChk + g % kChanChk;
  }
  __device__ static int64_t bin_lo(int64_t c) { return chan(2 * c); }
  __device__ static int64_t bin_hi(int64_t c) { return chan(2 * c + 1); }
  __device__ static int64_t first_bin(int64_t c0) {
    return 2 * c0 / (2 * kVecChunk) * kChanChk;
  }
};

// The frames a block reads: window w, frames [f0, f0 + nf), nf <= kFrames.
struct Slab {
  int64_t w, f0;
  int nf;
};

__device__ inline Slab block_slab(int64_t ndf_w, int64_t spw) {
  Slab s;
  s.w = blockIdx.x / spw;
  s.f0 = s.w * ndf_w + blockIdx.x % spw * kFrames;
  const int64_t left = (s.w + 1) * ndf_w - s.f0;
  s.nf = left < kFrames ? static_cast<int>(left) : kFrames;
  return s;
}

struct Grid {
  int64_t ndf_w;   // frames per window
  int64_t spw;     // slabs per window
  dim3 blocks;
};

// The launch grid of ndf frames x ncol columns in nout windows, or the
// error for a shape no launch can take.
inline cudaError_t make_grid(int64_t ndf, int64_t ncol, int64_t nout,
                             Grid* g) {
  if (ndf <= 0 || ncol <= 0 || nout <= 0 || ndf % nout) {
    return cudaErrorInvalidValue;
  }
  g->ndf_w = ndf / nout;
  g->spw = (g->ndf_w + kFrames - 1) / kFrames;
  const int64_t gx = nout * g->spw;
  const int64_t gy = (ncol + kThreads - 1) / kThreads;
  if (gx > 0x7fffffff || gy > 0xffff) return cudaErrorInvalidConfiguration;
  g->blocks = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  return cudaSuccess;
}

}  // namespace pafb2p
