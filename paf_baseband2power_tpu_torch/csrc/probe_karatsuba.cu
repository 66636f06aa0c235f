// Probe of a 3-real-product (Karatsuba) 128-point DFT on Hopper: planar int16
// rows -> polyphase FIR -> T = (A+B) C, RE = T - B (C+D), IM = T - A (C-D)
// -> |y|^2 summed over windows.
//
// Replaces the Pallas TPU kernel of benchmarks/probe_karatsuba.py:run_planar
// (K13, a closure in its main()). A row holds one 128-sample window, planar:
// lanes 0-127 re, 128-255 im. Window w is the FIR sum_k cv[k] row[w - ntap +
// 1 + k] (cv = [c, c], the nfft 128 prototype), the first ntap - 1 windows
// of a series masked. With C + iD = exp(-2 pi i n k / 128) the complex DFT
// (A + iB)(C + iD) takes three real (windows x 128) x (128 x 128) products
// instead of four. Output: (S, 128) float32, natural order, not fftshifted.
//
// Work: one block per (series, tile of R windows), walked in sub-tiles of
// 32 windows. The block forms a sub-tile's FIR in fp32 into shared memory,
// transposed (A[n][w], B[n][w]); each thread then owns 4 windows x 4 fine
// channels of all three products, reading the windows as float4 broadcasts
// from shared memory and the three matrices (192 KB, resident in L1/L2)
// through the read-only cache, on the fp32 CUDA cores. |y|^2 goes into
// float64 per-thread sums; each block writes its tile's sums to its own slot
// of a (S, ntiles, 128) float64 partials array, which
// pafb2p_probe_tile_sum adds in order.
//
// Bound: operations. 3 x 128^2 MACs per window, 541 GFLOP per 8192 x 48
// block: 8.1 ms on the fp32 CUDA cores (67 TFLOP/s), 3.3 ms at 3xTF32 on the
// tensor cores, against 0.84 ms of HBM. This first version uses the CUDA
// cores and reads the matrices from L1 at about one load per 4 FMAs;
// wgmma/3xTF32 and register-blocked tiles are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kKarThreads = 256;
constexpr int kTm = 32;              // windows per sub-tile
constexpr int kLd = kTm + 4;         // row stride of the transposed tile
constexpr int kL = 128;

struct KarArgs {
  const int* x;           // (S, ndf, 128) int32 words: (lane 2p, 2p + 1)
  const float* cv;        // (ntap, 256)
  const float* c1;        // C, (128, 128) [n][k]
  const float* c2;        // C + D
  const float* c3;        // C - D
  double* partial;        // (S, ntiles, 128)
  int64_t ndf, ntiles;
  int ntap, R;
};

__global__ void __launch_bounds__(kKarThreads) karatsuba_kernel(KarArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);            // [128][kLd]
  float* Bs = As + kL * kLd;                             // [128][kLd]
  double* red = reinterpret_cast<double*>(Bs + kL * kLd);   // [8][128]
  float* cv = reinterpret_cast<float*>(red + 8 * kL);    // [ntap][256]

  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const int64_t s = blockIdx.x / a.ntiles, t = blockIdx.x % a.ntiles;
  const int64_t w0 = t * a.R, wend = w0 + a.R;
  const int ntap = a.ntap;
  const int* xs = a.x + s * a.ndf * kL;
  for (int i = tid; i < ntap * 2 * kL; i += kKarThreads) cv[i] = a.cv[i];

  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t wb = w0; wb < wend; wb += kTm) {
    __syncthreads();     // cv loaded; the previous sub-tile's reads done
    // FIR of kTm windows, two lanes per thread and step
    for (int i = tid; i < kTm * kL; i += kKarThreads) {
      const int wl = i / kL, p = i % kL;
      const int64_t w = wb + wl;
      float z0 = 0.0f, z1 = 0.0f;
      if (w >= ntap - 1 && w < wend) {
        for (int k = 0; k < ntap; ++k) {
          const int v = __ldg(xs + (w - (ntap - 1) + k) * kL + p);
          z0 += cv[k * 2 * kL + 2 * p] *
                static_cast<float>(static_cast<short>(v & 0xffff));
          z1 += cv[k * 2 * kL + 2 * p + 1] * static_cast<float>(v >> 16);
        }
      }
      float* dst = 2 * p < kL ? As + 2 * p * kLd : Bs + (2 * p - kL) * kLd;
      dst[wl] = z0;
      dst[kLd + wl] = z1;
    }
    __syncthreads();
    float T[4][4], P[4][4], Q[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) T[i][j] = P[i][j] = Q[i][j] = 0.0f;
    }
#pragma unroll 2
    for (int n = 0; n < kL; ++n) {
      const float4 av = *reinterpret_cast<const float4*>(As + n * kLd + 4 * ty);
      const float4 bv = *reinterpret_cast<const float4*>(Bs + n * kLd + 4 * ty);
      const float am[4] = {av.x, av.y, av.z, av.w};
      const float bm[4] = {bv.x, bv.y, bv.z, bv.w};
      float c1[4], c2[4], c3[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = tx + 32 * j;
        c1[j] = __ldg(a.c1 + n * kL + k);
        c2[j] = __ldg(a.c2 + n * kL + k);
        c3[j] = __ldg(a.c3 + n * kL + k);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ab = am[i] + bm[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          T[i][j] += ab * c1[j];
          P[i][j] += bm[i] * c2[j];
          Q[i][j] += am[i] * c3[j];
        }
      }
    }
    // masked and out-of-tile windows are zero rows: they add 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float re = T[i][j] - P[i][j], im = T[i][j] - Q[i][j];
        acc[j] += static_cast<double>(re * re + im * im);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty * kL + tx + 32 * j] = acc[j];
  __syncthreads();
  if (tid < kL) {
    double sum = 0.0;
#pragma unroll
    for (int g = 0; g < 8; ++g) sum += red[g * kL + tid];
    a.partial[(s * a.ntiles + t) * kL + tid] = sum;
  }
}

}  // namespace

extern "C" {

// rows (S, ndf, 256) int16 planar windows -> partial (S, ndf / R, 128)
// float64 per-tile sums. cv (ntap, 256), c1/c2/c3 (128, 128) float32
// [n][k]; 1 <= ntap <= 8, R divides ndf.
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
  a.c1 = static_cast<const float*>(c1);
  a.c2 = static_cast<const float*>(c2);
  a.c3 = static_cast<const float*>(c3);
  a.partial = static_cast<double*>(partial);
  a.ndf = ndf;
  a.ntiles = ndf / R;
  a.ntap = ntap;
  a.R = R;
  const int64_t nblocks = S * a.ntiles;
  if (nblocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = sizeof(float) * 2 * kL * kLd + sizeof(double) * 8 * kL +
                      sizeof(float) * ntap * 2 * kL;
  const cudaError_t e = cudaFuncSetAttribute(
      karatsuba_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  karatsuba_kernel<<<static_cast<unsigned>(nblocks), kKarThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
