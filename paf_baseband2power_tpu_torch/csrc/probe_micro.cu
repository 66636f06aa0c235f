// Probe of the spectrometer's tile reshape on Hopper: column sums of int16
// series rows, read narrow or "widened".
//
// Replaces the Pallas TPU kernel benchmarks/probe_wide_reshape.py:micro
// (K11). On the TPU, a tile of R * n1 narrow (256-lane) rows regrouped into
// R wide (n1 * 256-lane) rows costs a cross-lane relayout; the probe timed a
// reduce of the narrow tile against a reduce of the widened one at equal
// bytes. Its output block stays resident across the time axis and is
// assigned, not accumulated, so the TPU kernel returns the column sums of
// the LAST tile of each series while it reads every tile. This kernel returns
// the same function and, like the TPU kernel, reads every tile: one block per
// (series, tile) writes that tile's sums into a (nseries, ntiles, 256)
// partials array, and the caller takes the last tile's row.
//
// kWiden = false walks the tile as R * n1 rows of 256 lanes; kWiden = true as
// R wide rows of n1 * 256 lanes, folding the n1 lane chunks back. The bytes
// and their order in memory are the same: on this card the "widening" is an
// index change, which is what the probe asks.
//
// Bound: HBM bytes (each int16 read once, 16-byte loads, integer adds).
// Sums are exact int32 (a tile of at most 2^16 rows of |x| <= 2^15), converted
// to float32 once.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMicroThreads = 256;     // 8 warps; lane l reads lanes 8l..8l+7
constexpr int kMicroWarps = kMicroThreads / 32;

template <bool kWiden>
__global__ void __launch_bounds__(kMicroThreads)
micro_kernel(const int4* __restrict__ x, float* __restrict__ partial,
             int64_t ndf, int64_t ntiles, int n1, int R) {
  __shared__ int red[kMicroWarps][256];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t s = blockIdx.x / ntiles, t = blockIdx.x % ntiles;
  const int64_t tile = static_cast<int64_t>(R) * n1;
  // row r of the tile is 32 int4 vectors
  const int4* base = x + (s * ndf + t * tile) * 32 + lane;
  int acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  auto add = [&](const int4 v) {
    const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc[2 * k] += static_cast<short>(w[k] & 0xffff);
      acc[2 * k + 1] += w[k] >> 16;
    }
  };
  if constexpr (kWiden) {
    for (int q = warp; q < R; q += kMicroWarps) {       // wide row q
      const int4* row = base + static_cast<int64_t>(q) * n1 * 32;
      for (int m = 0; m < n1; ++m) add(__ldg(row + m * 32));   // chunk m
    }
  } else {
#pragma unroll 4
    for (int64_t r = warp; r < tile; r += kMicroWarps) add(__ldg(base + r * 32));
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) red[warp][8 * lane + k] = acc[k];
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kMicroWarps; ++w) sum += red[w][threadIdx.x];
  partial[(s * ntiles + t) * 256 + threadIdx.x] = static_cast<float>(sum);
}

}  // namespace

extern "C" {

// rows (nseries, ndf, 256) int16, 16-byte aligned -> partial (nseries, ndf /
// (R * n1), 256) float32: each tile's column sums.
int pafb2p_probe_micro(const void* rows, int64_t nseries, int64_t ndf, int n1,
                       int R, int widen, void* partial, void* stream) {
  if (nseries <= 0 || n1 <= 0 || R <= 0 || ndf <= 0 ||
      ndf % (static_cast<int64_t>(R) * n1) || static_cast<int64_t>(R) * n1 > 65536) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t ntiles = ndf / (static_cast<int64_t>(R) * n1);
  const int64_t nblocks = nseries * ntiles;
  if (nblocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* x = static_cast<const int4*>(rows);
  float* p = static_cast<float*>(partial);
  if (widen) {
    micro_kernel<true><<<static_cast<unsigned>(nblocks), kMicroThreads, 0, s>>>(
        x, p, ndf, ntiles, n1, R);
  } else {
    micro_kernel<false><<<static_cast<unsigned>(nblocks), kMicroThreads, 0, s>>>(
        x, p, ndf, ntiles, n1, R);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
