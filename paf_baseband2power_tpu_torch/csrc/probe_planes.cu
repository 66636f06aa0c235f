// Probe of the spectrometer on the "planes" layout on Hopper: int16 planes ->
// polyphase FIR per plane -> N1 x 128 four-step DFT -> |y|^2 summed over
// windows.
//
// Replaces the Pallas TPU kernel benchmarks/probe_wide_reshape.py:planes_call
// (K12). The input is series rows re-cut into n1 = nfft / 128 planes,
// (nseries, n1, nrow, 256) int16 with nrow = ndf / n1: plane m holds the
// 128-sample chunk m of every window, so no window is ever widened. The
// output is a one-shot power spectrum per series, (nseries, nfft) float32:
// the first ntap - 1 windows masked, not fftshifted, pols not folded, and
// lane k1 * 128 + k2 holds fine channel n1 * k2 + k1:
//   X[n1 k2 + k1] = sum_n2 W_128^(n2 k2) W_N^(n2 k1) A_k1[n2],
//   A_k1[n2]      = sum_m W_n1^(m k1) z_m[n2]            (stage A)
// where z_m is the FIR of plane m. The probe's stage_a ablations are kept,
// as the same deterministic functions: kFull, kFft8 (the same function as
// full through a radix-2^3 DIF in registers, n1 = 8 only), kNoSwap (only the
// real part of the stage-A twiddles) and kNone (z_0 for every k1). The last
// two are wrong by design: they time stage A's share.
//
// Work: one block per (series, tile of R windows). Per step of W windows
// (W = 2 at nfft 128, else 1) the block loads each plane's next rows into a
// ring in shared memory that also holds the ntap - 1 rows before them, forms
// the FIR of every plane (fp32), runs stage A in registers (one thread per
// (window, n2), all k1 at once) with the twiddle W_N^(n2 k1), writes it
// bit-reversed and runs the 128-point radix-2 DIT FFTs in shared memory, then
// adds |y|^2 in float64 to per-thread accumulators. Each block writes its sums
// to its own slot of a (nseries, ntiles, nfft) float64 partials array;
// pafb2p_probe_tile_sum adds the tiles in order (no float atomics).
//
// Bound: fp32 operations, not HBM: the block is read once (0.84 ms at 3.35
// TB/s for 2.8 GB), but the direct stage A costs 8 n1 flops per sample (64
// at nfft 1024) on top of FIR, FFT and detection. A first version, written
// to be right; tensor-core stage B and a cheaper stage A are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kPlanesThreads = 256;
constexpr int kMaxPer = 1024 / kPlanesThreads;   // nfft / threads, at most

enum StageA { kFull = 0, kFft8 = 1, kNoSwap = 2, kNone = 3 };

struct PlanesArgs {
  const int* x;          // (nseries, n1, nrow, 128) int32 (re, im) words
  const float* coeffs;   // (ntap, nfft)
  double* partial;       // (nseries, ntiles, nfft)
  int64_t nrow, ntiles;
  int ntap, R, stage, W, sp, cap;
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 times_i(float2 a) {   // i * a
  return make_float2(-a.y, a.x);
}

// radix-2^3 DIF of 8 values in natural order (the probe's "fft8" recipe)
__device__ __forceinline__ void fft8(const float2* x, float2* out) {
  const float s = 0.70710678118654752f;   // 1 / sqrt(2)
  float2 t[4], u[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    t[m] = cadd(x[m], x[m + 4]);
    u[m] = csub(x[m], x[m + 4]);
  }
  u[1] = make_float2(s * (u[1].x + u[1].y), s * (u[1].y - u[1].x));  // (1-i)/sqrt2
  u[2] = make_float2(u[2].y, -u[2].x);                               // -i
  u[3] = make_float2(s * (u[3].y - u[3].x), -s * (u[3].x + u[3].y)); // -(1+i)/sqrt2
  const float2* in[2] = {t, u};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2* v = in[h];
    const float2 p0 = cadd(v[0], v[2]), p1 = cadd(v[1], v[3]);
    const float2 q0 = csub(v[0], v[2]);
    const float2 d = csub(v[1], v[3]);
    const float2 q1 = make_float2(d.y, -d.x);                        // -i d
    out[h] = cadd(p0, p1);
    out[2 + h] = cadd(q0, q1);
    out[4 + h] = csub(p0, p1);
    out[6 + h] = csub(q0, q1);
  }
}

template <int N1>
__global__ void __launch_bounds__(kPlanesThreads) planes_kernel(PlanesArgs a) {
  constexpr int nfft = 128 * N1;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* fir = reinterpret_cast<float2*>(smem);               // sp
  float2* buf = fir + a.sp;                                     // sp
  float2* tab = buf + a.sp;                                     // nfft
  double* red = reinterpret_cast<double*>(tab + nfft);          // threads
  float* coef = reinterpret_cast<float*>(red + kPlanesThreads); // ntap * nfft
  int* ring = reinterpret_cast<int*>(coef + a.ntap * nfft);     // N1 x cap x 128

  const int tid = threadIdx.x;
  const int64_t s = blockIdx.x / a.ntiles, t = blockIdx.x % a.ntiles;
  const int64_t w0 = t * a.R, wend = w0 + a.R;
  const int mask = a.cap - 1, W = a.W, sp = a.sp, ntap = a.ntap;
  const int* xs = a.x + s * N1 * a.nrow * 128;

  for (int i = tid; i < nfft; i += kPlanesThreads) {
    double sn, cs;
    sincospi(-2.0 * i / nfft, &sn, &cs);
    tab[i] = make_float2(static_cast<float>(cs), static_cast<float>(sn));
  }
  for (int i = tid; i < ntap * nfft; i += kPlanesThreads) coef[i] = a.coeffs[i];
  // the ntap - 1 rows before the tile (zero before the series starts)
  for (int i = tid; i < (ntap - 1) * N1 * 128; i += kPlanesThreads) {
    const int k = i / (N1 * 128), m = i / 128 % N1, n2 = i % 128;
    const int64_t w = w0 - (ntap - 1) + k;
    ring[(m * a.cap + (w & mask)) * 128 + n2] =
        w >= 0 ? __ldg(xs + (m * a.nrow + w) * 128 + n2) : 0;
  }

  double acc[kMaxPer];
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) acc[m] = 0.0;
  const int per = sp / kPlanesThreads;
  const int64_t first = ntap - 1;     // one-shot: the first windows are masked
  for (int64_t wa = w0; wa < wend; wa += W) {
    for (int i = tid; i < sp; i += kPlanesThreads) {
      const int wi = i / nfft, m = i / 128 % N1, n2 = i % 128;
      const int64_t w = wa + wi;
      ring[(m * a.cap + (w & mask)) * 128 + n2] =
          w < wend ? __ldg(xs + (m * a.nrow + w) * 128 + n2) : 0;
    }
    __syncthreads();
    // FIR of plane m: window w takes rows w - ntap + 1 .. w
    for (int i = tid; i < sp; i += kPlanesThreads) {
      const int wi = i / nfft, m = i / 128 % N1, n2 = i % 128;
      const int64_t w = wa + wi;
      float re = 0.0f, im = 0.0f;
      if (w >= first && w < wend) {
        for (int k = 0; k < ntap; ++k) {
          const int v =
              ring[(m * a.cap + ((w - (ntap - 1) + k) & mask)) * 128 + n2];
          const float c = coef[k * nfft + m * 128 + n2];
          re += c * static_cast<float>(static_cast<short>(v & 0xffff));
          im += c * static_cast<float>(v >> 16);
        }
      }
      fir[i] = make_float2(re, im);
    }
    __syncthreads();
    // stage A for one (window, n2), every k1, then the twiddle W_N^(n2 k1)
    for (int i = tid; i < W * 128; i += kPlanesThreads) {
      const int wi = i / 128, n2 = i % 128;
      float2 x[N1], y[N1];
#pragma unroll
      for (int m = 0; m < N1; ++m) x[m] = fir[(wi * N1 + m) * 128 + n2];
      bool done = false;
      if constexpr (N1 == 8) {
        if (a.stage == kFft8) {
          fft8(x, y);
          done = true;
        }
      }
      if (!done) {
#pragma unroll
        for (int k1 = 0; k1 < N1; ++k1) {
          float2 v = make_float2(0.0f, 0.0f);
          if (a.stage == kNone) {
            v = x[0];
          } else {
#pragma unroll
            for (int m = 0; m < N1; ++m) {
              const float2 w = tab[(m * k1 % N1) * 128];   // W_n1^(m k1)
              v = a.stage == kNoSwap
                      ? make_float2(v.x + w.x * x[m].x, v.y + w.x * x[m].y)
                      : cadd(v, cmul(w, x[m]));
            }
          }
          y[k1] = v;
        }
      }
      const int rev = static_cast<int>(__brev(n2) >> 25);
#pragma unroll
      for (int k1 = 0; k1 < N1; ++k1) {
        buf[(wi * N1 + k1) * 128 + rev] = cmul(tab[n2 * k1], y[k1]);
      }
    }
    __syncthreads();
    // 128-point radix-2 DIT FFTs, sp / 128 of them, W_128^j = tab[j * N1]
    for (int h = 1; h < 128; h <<= 1) {
      const int stride = 64 / h;
      for (int b = tid; b < sp / 2; b += kPlanesThreads) {
        const int f = b / 64, bb = b % 64, jj = bb % h;
        const int i0 = f * 128 + (bb - jj) * 2 + jj;
        const float2 wv = cmul(tab[jj * stride * N1], buf[i0 + h]);
        const float2 u = buf[i0];
        buf[i0] = cadd(u, wv);
        buf[i0 + h] = csub(u, wv);
      }
      __syncthreads();
    }
    // detect: position i is window i / nfft, output lane i % nfft
#pragma unroll
    for (int m = 0; m < kMaxPer; ++m) {
      if (m >= per) break;
      const int i = tid + m * kPlanesThreads;
      const int64_t w = wa + i / nfft;
      if (w < first || w >= wend) continue;
      const float2 y = buf[i];
      acc[m] += static_cast<double>(y.x * y.x + y.y * y.y);
    }
  }

  double* out = a.partial + (s * a.ntiles + t) * nfft;
  if (W == 1) {
#pragma unroll
    for (int m = 0; m < kMaxPer; ++m) {
      if (m < per) out[tid + m * kPlanesThreads] = acc[m];
    }
    return;
  }
  // W = 2 (nfft 128): the two windows of a step share an output lane
  red[tid] = acc[0];
  __syncthreads();
  if (tid < nfft) out[tid] = red[tid] + red[nfft + tid];
}

__global__ void tile_sum_kernel(const double* __restrict__ partial,
                                float* __restrict__ out, int64_t nrows,
                                int64_t ntiles, int64_t width) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nrows * width) return;
  const int64_t r = i / width, j = i % width;
  double s = 0.0;
  for (int64_t t = 0; t < ntiles; ++t) s += partial[(r * ntiles + t) * width + j];
  out[i] = static_cast<float>(s);
}

template <int N1>
int launch_planes(const PlanesArgs& a, int64_t nblocks, size_t smem,
                  cudaStream_t stream) {
  auto kernel = planes_kernel<N1>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(nblocks), kPlanesThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// planes (nseries, n1, nrow, 256) int16 -> partial (nseries, nrow / R, 128 *
// n1) float64 per-tile sums. n1 in {1, 2, 4, 8}, 1 <= ntap <= 8, R divides
// nrow, stage 0 full, 1 fft8 (n1 = 8), 2 noswap, 3 none; coeffs (ntap,
// 128 * n1) float32.
int pafb2p_probe_planes(const void* planes, int64_t nseries, int n1,
                        int64_t nrow, int ntap, int R, int stage,
                        const void* coeffs, void* partial, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (nseries <= 0 || nrow <= 0 || R <= 0 || nrow % R || ntap < 1 ||
      ntap > 8 || stage < kFull || stage > kNone ||
      (stage == kFft8 && n1 != 8)) {
    return static_cast<int>(bad);
  }
  PlanesArgs a;
  a.x = static_cast<const int*>(planes);
  a.coeffs = static_cast<const float*>(coeffs);
  a.partial = static_cast<double*>(partial);
  a.nrow = nrow;
  a.ntiles = nrow / R;
  a.ntap = ntap;
  a.R = R;
  a.stage = stage;
  const int nfft = 128 * n1;
  a.W = nfft < 256 ? 256 / nfft : 1;
  a.sp = a.W * nfft;
  a.cap = 1;
  while (a.cap < ntap - 1 + a.W) a.cap <<= 1;
  const int64_t nblocks = nseries * a.ntiles;
  if (nblocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = sizeof(float2) * (2 * a.sp + nfft) +
                      sizeof(double) * kPlanesThreads +
                      sizeof(float) * ntap * nfft +
                      sizeof(int) * n1 * a.cap * 128;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n1) {
    case 1: return launch_planes<1>(a, nblocks, smem, s);
    case 2: return launch_planes<2>(a, nblocks, smem, s);
    case 4: return launch_planes<4>(a, nblocks, smem, s);
    case 8: return launch_planes<8>(a, nblocks, smem, s);
    default: return static_cast<int>(bad);
  }
}

// partial (nrows, ntiles, width) float64 -> out (nrows, width) float32, the
// tiles added in order.
int pafb2p_probe_tile_sum(const void* partial, void* out, int64_t nrows,
                          int64_t ntiles, int64_t width, void* stream) {
  if (nrows <= 0 || ntiles <= 0 || width <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;
  const int64_t blocks = (nrows * width + threads - 1) / threads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  tile_sum_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partial), static_cast<float*>(out), nrows,
      ntiles, width);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
