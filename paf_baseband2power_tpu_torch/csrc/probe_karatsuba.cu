// Probe of a 3-real-product (Karatsuba) 128-point DFT on Hopper: planar int16
// rows -> polyphase FIR -> T = (A+B) C, RE = T - B (C+D), IM = T - A (C-D)
// -> |y|^2 summed over windows, the three products on the tensor cores.
//
// Replaces the Pallas TPU kernel of benchmarks/probe_karatsuba.py:run_planar
// (K13, a closure in its main()). A row holds one 128-sample window, planar:
// lanes 0-127 re, 128-255 im. Window w is the FIR sum_k cv[k] row[w - ntap +
// 1 + k] (cv = [c, c], the nfft 128 prototype), the first ntap - 1 windows
// of a series masked. With C + iD = exp(-2 pi i n k / 128) the complex DFT
// (A + iB)(C + iD) takes three real (windows x 128) x (128 x 128) products
// instead of four. Output: (S, 128) float32, natural order, not fftshifted.
//
// Work: one resident block per SM walks (series, tile of R windows) tiles,
// each in sub-tiles of 64 windows, the rows of tc_dft.cuh's tile. Per
// sub-tile the block forms the FIR in fp32 and writes it split, as the
// tile's words (a thread slides over 16 windows of columns 2c, 2c + 1 of A
// and B, reading and converting each row of the ring once; 8 taps, the
// prototype's ntap at the end and 0 before), then runs tcdft::dft_tile
// (mma.sync, 3xBF16; the note there says why) while cp.async brings the
// next sub-tile's int16 rows into a ring in shared memory. The ring holds
// kCap = 72 rows: a sub-tile's 64 and the 7 before them, so the prefetch
// writes only slots whose rows the FIR has used. The DFT tables are loaded
// once per block, not per tile. |y|^2 goes from the accumulators into
// float64 per-thread sums; each tile's sums go to its own slot of a (S,
// ntiles, 128) float64 partials array, which pafb2p_probe_tile_sum adds in
// order (no float atomics: two calls are bit-equal).
//
// Shared memory: the DFT tables 48 KB + the tile 96 KB + the ring 36 KB =
// 180 KB, one block of 8 warps per SM.
//
// Bound: bytes for the function (0.84 ms at 3.35 TB/s for the 2.8 GB
// block); the design's own floor is its products: 3 x 128^2 MACs per
// window, 541 GFLOP per 8192 x 48 block, three times that at 3xBF16, 1.64
// ms at the 989 TFLOP/s of bf16 wgmma. mma.sync reaches a lower share of
// that rate, and the FIR, the loads and |y|^2 run beside the products, not
// under them (PERF.md has the split).

#include <cstdint>

#include <cuda_runtime.h>

#include "tc_dft.cuh"

namespace {

using tcdft::kL;
using tcdft::kRows;
using tcdft::kThreads;
constexpr int kCap = kRows + 8;      // ring rows

struct KarArgs {
  const int* x;           // (S, ndf, 128) int32 words: (lane 2p, 2p + 1)
  const float* cv;        // (ntap, 256)
  double* partial;        // (S, ntiles, 128)
  int64_t S, ndf, ntiles;
  int ntap, R;
};

__global__ void __launch_bounds__(kThreads, 1) karatsuba_kernel(KarArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* tab = reinterpret_cast<float4*>(smem);
  uint32_t* dtile = reinterpret_cast<uint32_t*>(smem + tcdft::kTableBytes);
  int* ring = reinterpret_cast<int*>(smem + tcdft::kTableBytes +
                                     tcdft::kTileBytes);         // kCap x 128

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int ntap = a.ntap;
  // the FIR: this thread's columns 2c, 2c + 1 of A (word c of a row) and
  // of B (word c + 64), 16 windows from 16 q; tap i of 8 weighs row w - 7 +
  // i (cv's taps at the end, 0 before)
  const int c = tid % 64, q = tid / 64;
  float2 ca[8], cb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = i - (8 - ntap);
    ca[i] = cb[i] = make_float2(0.0f, 0.0f);
    if (k >= 0) {
      const float* cvk = a.cv + k * 2 * kL + 2 * c;
      ca[i] = make_float2(cvk[0], cvk[1]);
      cb[i] = make_float2(cvk[kL], cvk[kL + 1]);
    }
  }
  tcdft::load_tables(tab);

  for (int64_t tile = blockIdx.x; tile < a.S * a.ntiles; tile += gridDim.x) {
    const int64_t s = tile / a.ntiles, t = tile % a.ntiles;
    const int64_t w0 = t * a.R, wend = w0 + a.R;
    const int* xs = a.x + s * a.ndf * kL;
    // rows [lo, hi) of the series that exist and lie before wend -> the
    // ring; row w >= w0 - 8 sits in slot (w - w0 + 8) % kCap
    auto fetch = [&](int64_t lo, int64_t hi) {
      lo = lo < 0 ? 0 : lo;
      hi = hi < wend ? hi : wend;
      for (int64_t i = tid; i < (hi - lo) * 32; i += kThreads) {
        const int64_t w = lo + i / 32;
        const int slot = static_cast<int>((w - w0 + 8) % kCap);
        tcdft::cp_async16(ring + slot * kL + (i % 32) * 4,
                          xs + w * kL + (i % 32) * 4);
      }
      tcdft::cp_async_commit();
    };
    fetch(w0 - (ntap - 1), w0 + kRows);

    double acc[tcdft::kNT][2] = {};
    tcdft::Acc y;
    for (int64_t wb = w0; wb < wend; wb += kRows) {
      tcdft::cp_async_wait_all();
      __syncthreads();   // the rows are in; the tile is free
      // FIR of windows wb + 16 q .. + 15 for columns 2c, 2c + 1, sliding
      // over the rows: each row is read and converted once. Rows the ring
      // does not hold (before the series, or stale) are finite and weigh 0.
      {
        int slot = static_cast<int>((wb - w0 + 16 * q + 1) % kCap);
        float2 ra[8], rb[8];
#pragma unroll
        for (int i = 1; i < 8; ++i) {
          ra[i] = tcdft::unpack_int16x2(ring[slot * kL + c]);
          rb[i] = tcdft::unpack_int16x2(ring[slot * kL + c + 64]);
          slot = slot + 1 == kCap ? 0 : slot + 1;
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int i = 0; i < 7; ++i) {
            ra[i] = ra[i + 1];
            rb[i] = rb[i + 1];
          }
          ra[7] = tcdft::unpack_int16x2(ring[slot * kL + c]);
          rb[7] = tcdft::unpack_int16x2(ring[slot * kL + c + 64]);
          slot = slot + 1 == kCap ? 0 : slot + 1;
          float2 za = make_float2(0.0f, 0.0f), zb = za;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            za.x += ca[i].x * ra[i].x;
            za.y += ca[i].y * ra[i].y;
            zb.x += cb[i].x * rb[i].x;
            zb.y += cb[i].y * rb[i].y;
          }
          const int64_t w = wb + 16 * q + j;
          if (w < ntap - 1 || w >= wend) za = zb = make_float2(0.0f, 0.0f);
          tcdft::store_pair(dtile, 16 * q + j, c, za, zb);
        }
      }
      __syncthreads();
      fetch(wb + kRows, wb + 2 * kRows);
      tcdft::dft_tile(dtile, tab, warp_m, warp_n, y);
      // masked and out-of-tile windows are zero rows: they add 0
#pragma unroll
      for (int mt = 0; mt < tcdft::kMT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < tcdft::kNT; ++nt) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float yr = y.t[mt][nt][r] - y.p[mt][nt][r];
            const float yi = y.t[mt][nt][r] - y.q[mt][nt][r];
            acc[nt][r & 1] += static_cast<double>(yr * yr + yi * yi);
          }
        }
      }
    }
    __syncthreads();     // every warp's products done: the tile is free
    double* red = reinterpret_cast<double*>(dtile);   // [warp_m][g][128]
#pragma unroll
    for (int nt = 0; nt < tcdft::kNT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        red[(warp_m * 8 + lane / 4) * kL +
            tcdft::acc_col(warp_n, lane, nt, h)] = acc[nt][h];
      }
    }
    __syncthreads();
    if (tid < kL) {
      double sum = 0.0;
      for (int i = 0; i < 16; ++i) sum += red[i * kL + tid];
      a.partial[(s * a.ntiles + t) * kL + tid] = sum;
    }
  }
}

}  // namespace

extern "C" {

// rows (S, ndf, 256) int16 planar windows -> partial (S, ndf / R, 128)
// float64 per-tile sums. cv (ntap, 256); 1 <= ntap <= 8, R divides ndf.
// c1, c2, c3 are unused: the kernel forms the DFT's matrices itself
// (tcdft::load_tables). They stay in the interface, which an older build
// of this kernel (one that reads them) shares.
int pafb2p_probe_karatsuba(const void* rows, int64_t S, int64_t ndf, int ntap,
                           int R, const void* cv, const void* c1,
                           const void* c2, const void* c3, void* partial,
                           void* stream) {
  if (S <= 0 || ndf <= 0 || R <= 0 || ndf % R || ntap < 1 || ntap > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KarArgs a;
  a.x = static_cast<const int*>(rows);
  a.cv = static_cast<const float*>(cv);
  a.partial = static_cast<double*>(partial);
  a.S = S;
  a.ndf = ndf;
  a.ntiles = ndf / R;
  a.ntap = ntap;
  a.R = R;
  int nblocks = 0;
  const cudaError_t g = tcdft::resident_grid(S * a.ntiles, &nblocks);
  if (g != cudaSuccess) return static_cast<int>(g);
  const size_t smem =
      tcdft::kTableBytes + tcdft::kTileBytes + sizeof(int) * kCap * kL;
  const cudaError_t e = cudaFuncSetAttribute(
      karatsuba_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  karatsuba_kernel<<<nblocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
