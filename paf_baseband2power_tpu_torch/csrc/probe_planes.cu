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
// Work: one resident block per SM walks (series, tile of R windows) tiles,
// each in steps of Wn = 64 / n1 windows: the n1 rows (k1) of each window's
// 128-point DFTs fill the 64 rows of tc_dft.cuh's tile, row wi * n1 + k1.
// Per step the block forms the FIR of every plane (fp32) from a ring of
// int16 rows in shared memory, a thread sliding over the windows of one
// sample n2 of n1 / 2 planes (each row read and converted once; 8 taps, the
// prototype's ntap at the end and 0 before) into fp32 rows kept in the
// tile's place; a thread per (column pair 2c, 2c + 1, quarter of the
// windows) then runs stage A in registers (fft8 for stage_a=fft8, the
// direct sum for full, noswap and none, one branch a window; a quarter turn
// of W_n1 needs no product) and the twiddle W_N^(n2 k1), and once every
// thread has read its rows, writes them split as the tile's words; then
// tcdft::dft_tile (mma.sync, 3xBF16; the note there says why) runs while
// cp.async brings each plane's next rows into the ring. The twiddle is
// applied in registers, not folded into n1 matrices as the JAX probe does,
// so every row shares one set of C, C + D, C - D; it comes from a table of
// W_N^e, e < N, formed in float64 and rounded once, as the JAX probe's.
// The ring holds Wn + 7 rows a plane: a step's and the 7 before them. In a
// thread's accumulators k1 = g % n1 is fixed (n1 divides 8), so |y|^2 goes
// into float64 per-thread sums for its 8 output lanes k1 * 128 + k2; each
// tile's sums go to its own slot of a (nseries, ntiles, nfft) float64
// partials array; pafb2p_probe_tile_sum adds the tiles in order (no float
// atomics). No shared-memory FFT pass and no barrier per FFT stage remain:
// four barriers a step.
//
// Shared memory: the DFT tables 48 KB + the tile 96 KB + the ring n1 x (Wn
// + 7) x 512 B (60 KB at n1 8, 35.5 KB at n1 1) + the twiddle table (8 KB
// at n1 8): 212 KB at most, one block of 8 warps per SM; the FIR's
// coefficients, (ntap, nfft) fp32, come through the read-only cache.
//
// Bound: bytes for the function (0.84 ms for the 2.8 GB block); the design's
// own floor is its products, 3 x 128^2 MACs per row, 541 GFLOP per 8192 x
// 48 block at nfft 1024, three times that at 3xBF16: 1.64 ms at the 989
// TFLOP/s of bf16 wgmma.

#include <cstdint>

#include <cuda_runtime.h>

#include "tc_dft.cuh"

namespace {

using tcdft::kL;
using tcdft::kRows;
using tcdft::kThreads;

enum StageA { kFull = 0, kFft8 = 1, kNoSwap = 2, kNone = 3 };

struct PlanesArgs {
  const int* x;          // (nseries, n1, nrow, 128) int32 (re, im) words
  const float* coeffs;   // (ntap, nfft)
  double* partial;       // (nseries, ntiles, nfft)
  int64_t nseries, nrow, ntiles;
  int ntap, R, stage;
};

template <int N1>
struct Geometry {
  static constexpr int kWn = kRows / N1;          // windows per step
  static constexpr int kCap = kWn + 7;            // ring rows per plane
  static constexpr size_t kSmem = tcdft::kTableBytes + tcdft::kTileBytes +
                                  sizeof(int) * N1 * kCap * kL +
                                  sizeof(float2) * (kL * N1 + N1);
};

// where element (row, col) of the fp32 rows of the FIR and stage A is
// stored: swizzled so that consecutive columns of a row meet distinct banks
__device__ __forceinline__ int plane_index(int row, int col) {
  return row * kL + (col ^ ((row & 3) << 3));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// W_n^j = exp(-2 pi i j / n), formed in float64
__device__ __forceinline__ float2 twiddle(int j, int n) {
  double sn, cs;
  sincospi(-2.0 * j / n, &sn, &cs);
  return make_float2(static_cast<float>(cs), static_cast<float>(sn));
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

// stage A of one window, every k1: y[k1] = sum_m W_n1^(m k1) x[m] (kFull,
// and kFft8 through fft8), its real twiddles only (kNoSwap), or x[0]
// W_n1^j x for a j of a quarter turn (4 j % n1 == 0), exactly: 1, -i, -1, i
template <int N1>
__device__ __forceinline__ float2 quarter(int j, float2 x) {
  switch (4 * j / N1) {
    case 0: return x;
    case 1: return make_float2(x.y, -x.x);
    case 2: return make_float2(-x.x, -x.y);
    default: return make_float2(-x.y, x.x);
  }
}

template <int S, int N1>
__device__ __forceinline__ void stage_a(const float2 (&x)[N1], float2 (&y)[N1],
                                        const float2* tw_a) {
  if constexpr (S == kFft8) {
    fft8(x, y);
  } else {
#pragma unroll
    for (int k1 = 0; k1 < N1; ++k1) {
      float2 u = S == kNone ? x[0] : make_float2(0.0f, 0.0f);
      if constexpr (S != kNone) {
#pragma unroll
        for (int m = 0; m < N1; ++m) {
          // W_n1^(m k1): a quarter turn is exact and needs no product
          const int j = m * k1 % N1;
          const bool exact = 4 * j % N1 == 0;
          if constexpr (S == kNoSwap) {
            const float wx = exact ? quarter<N1>(j, make_float2(1.0f, 0.0f)).x
                                   : tw_a[j].x;
            if (!exact || wx != 0.0f) {
              u = make_float2(u.x + wx * x[m].x, u.y + wx * x[m].y);
            }
          } else {
            u = cadd(u, exact ? quarter<N1>(j, x[m]) : cmul(tw_a[j], x[m]));
          }
        }
      }
      y[k1] = u;
    }
  }
}

template <int N1>
__global__ void __launch_bounds__(kThreads, 1) planes_kernel(PlanesArgs a) {
  using G = Geometry<N1>;
  constexpr int nfft = kL * N1;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* tab = reinterpret_cast<float4*>(smem);
  uint32_t* dtile = reinterpret_cast<uint32_t*>(smem + tcdft::kTableBytes);
  // the FIR's and stage A's rows in fp32, in the tile's place until the
  // tile is written
  float* re = reinterpret_cast<float*>(dtile);
  float* im = re + kRows * kL;
  int* ring = reinterpret_cast<int*>(smem + tcdft::kTableBytes +
                                     tcdft::kTileBytes);  // N1 x kCap x 128
  float2* tw = reinterpret_cast<float2*>(ring + N1 * G::kCap * kL);
  float2* tw_a = tw + nfft;                // W_n1^j, j < n1

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;
  const int ntap = a.ntap, stage = a.stage;
  // the FIR: a thread's sample n2 and half q (tap i of 8 weighs row w - 7
  // + i); stage A: its column pair c and quarter h of the step's windows
  constexpr int kFirM = N1 == 1 ? 1 : N1 / 2;   // FIR: planes a thread
  constexpr int kFirW = N1 == 1 ? G::kWn / 2 : G::kWn;   // and windows
  constexpr int kWq = G::kWn / 4;
  const int n2 = tid % kL, q = tid / kL;
  const int c = tid % tcdft::kWords, h = tid / tcdft::kWords;
  tcdft::load_tables(tab);
  for (int i = tid; i < nfft + N1; i += kThreads) {
    tw[i] = i < nfft ? twiddle(i, nfft) : twiddle(i - nfft, N1);
  }

  for (int64_t tile = blockIdx.x; tile < a.nseries * a.ntiles;
       tile += gridDim.x) {
    const int64_t s = tile / a.ntiles, t = tile % a.ntiles;
    const int64_t w0 = t * a.R, wend = w0 + a.R;
    const int* xs = a.x + s * N1 * a.nrow * kL;
    // rows [lo, hi) of every plane that exist and lie before wend -> the
    // ring; row w >= w0 - 8 sits in slot (w - w0 + 8) % kCap of its plane
    auto fetch = [&](int64_t lo, int64_t hi) {
      lo = lo < 0 ? 0 : lo;
      hi = hi < wend ? hi : wend;
      const int64_t n = hi - lo;
      for (int64_t i = tid; i < N1 * n * 32; i += kThreads) {
        const int m = static_cast<int>(i / (n * 32));
        const int64_t w = lo + i / 32 % n;
        const int slot = static_cast<int>((w - w0 + 8) % G::kCap);
        tcdft::cp_async16(ring + (m * G::kCap + slot) * kL + (i % 32) * 4,
                          xs + (m * a.nrow + w) * kL + (i % 32) * 4);
      }
      tcdft::cp_async_commit();
    };
    fetch(w0 - (ntap - 1), w0 + G::kWn);

    double acc[tcdft::kNT][2] = {};
    tcdft::Acc y;
    for (int64_t wa = w0; wa < wend; wa += G::kWn) {
      tcdft::cp_async_wait_all();
      __syncthreads();   // the rows are in; the planes are free
      // FIR of planes kFirM q .. + kFirM - 1 for windows wa + kFirW q' + j
      // (q' = q at n1 1, else 0), sliding over each plane's rows: each row
      // is read and converted once. Rows the ring does not hold (before the
      // series, or stale) are finite and weigh 0. Window wi, plane m goes to
      // row wi n1 + m of the tile, where stage A reads it and writes its
      // own outputs in its place.
#pragma unroll
      for (int mi = 0; mi < kFirM; ++mi) {
        const int m = kFirM * q % N1 + mi;
        float c8[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = i - (8 - ntap);
          c8[i] = k < 0 ? 0.0f : __ldg(a.coeffs + k * nfft + m * kL + n2);
        }
        const int wi0 = N1 == 1 ? kFirW * q : 0;
        const int* rows = ring + m * G::kCap * kL + n2;
        int slot = static_cast<int>((wa - w0 + wi0 + 1) % G::kCap);
        float2 r[8];
#pragma unroll
        for (int i = 1; i < 8; ++i) {
          r[i] = tcdft::unpack_int16x2(rows[slot * kL]);
          slot = slot + 1 == G::kCap ? 0 : slot + 1;
        }
#pragma unroll
        for (int j = 0; j < kFirW; ++j) {
#pragma unroll
          for (int i = 0; i < 7; ++i) r[i] = r[i + 1];
          r[7] = tcdft::unpack_int16x2(rows[slot * kL]);
          slot = slot + 1 == G::kCap ? 0 : slot + 1;
          float2 z = make_float2(0.0f, 0.0f);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            z.x += c8[i] * r[i].x;
            z.y += c8[i] * r[i].y;
          }
          const int64_t w = wa + wi0 + j;
          if (w < ntap - 1 || w >= wend) z = make_float2(0.0f, 0.0f);
          const int at = plane_index((wi0 + j) * N1 + m, n2);
          re[at] = z.x;
          im[at] = z.y;
        }
      }
      __syncthreads();
      // stage A and the twiddle of samples 2c, 2c + 1 of windows kWq h ..
      // + kWq - 1, held in registers until every thread has read its rows
      float2 u0[kWq][N1], u1[kWq][N1];
#pragma unroll
      for (int j = 0; j < kWq; ++j) {
        float2 x0[N1], x1[N1], v[N1];
#pragma unroll
        for (int m = 0; m < N1; ++m) {
          const int at = plane_index((kWq * h + j) * N1 + m, 2 * c);
          const float2 r = *reinterpret_cast<const float2*>(re + at);
          const float2 i = *reinterpret_cast<const float2*>(im + at);
          x0[m] = make_float2(r.x, i.x);
          x1[m] = make_float2(r.y, i.y);
        }
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          switch (stage) {
            case kNoSwap: stage_a<kNoSwap>(side ? x1 : x0, v, tw_a); break;
            case kNone: stage_a<kNone>(side ? x1 : x0, v, tw_a); break;
            case kFft8:     // n1 8 only (the entry point refuses the rest)
              if constexpr (N1 == 8) {
                stage_a<kFft8>(side ? x1 : x0, v, tw_a);
                break;
              }
              [[fallthrough]];
            default: stage_a<kFull>(side ? x1 : x0, v, tw_a); break;
          }
#pragma unroll
          for (int k1 = 0; k1 < N1; ++k1) {
            const float2 t = k1 == 0 ? v[0]
                                     : cmul(tw[(2 * c + side) * k1], v[k1]);
            (side ? u1 : u0)[j][k1] = t;
          }
        }
      }
      __syncthreads();
      // rows (kWq h + j) n1 + k1 of the tile, word c
#pragma unroll
      for (int j = 0; j < kWq; ++j) {
#pragma unroll
        for (int k1 = 0; k1 < N1; ++k1) {
          tcdft::store_pair(dtile, (kWq * h + j) * N1 + k1, c,
                            make_float2(u0[j][k1].x, u1[j][k1].x),
                            make_float2(u0[j][k1].y, u1[j][k1].y));
        }
      }
      __syncthreads();
      fetch(wa + G::kWn, wa + 2 * G::kWn);
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
      for (int c = 0; c < 2; ++c) {
        red[(warp_m * 8 + lane / 4) * kL +
            tcdft::acc_col(warp_n, lane, nt, c)] = acc[nt][c];
      }
    }
    __syncthreads();
    // lane k1 * 128 + k2: the rows g = k1, k1 + n1, ... of both warp rows
    double* out = a.partial + (s * a.ntiles + t) * nfft;
    for (int j = tid; j < nfft; j += kThreads) {
      const int k1 = j / kL, k2 = j % kL;
      double sum = 0.0;
      for (int wm = 0; wm < 2; ++wm) {
        for (int g = k1; g < 8; g += N1) sum += red[(wm * 8 + g) * kL + k2];
      }
      out[j] = sum;
    }
  }
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
int launch_planes(const PlanesArgs& a, cudaStream_t stream) {
  auto kernel = planes_kernel<N1>;
  const size_t smem = Geometry<N1>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int nblocks = 0;
  const cudaError_t g = tcdft::resident_grid(a.nseries * a.ntiles, &nblocks);
  if (g != cudaSuccess) return static_cast<int>(g);
  kernel<<<nblocks, kThreads, smem, stream>>>(a);
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
  a.nseries = nseries;
  a.nrow = nrow;
  a.ntiles = nrow / R;
  a.ntap = ntap;
  a.R = R;
  a.stage = stage;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n1) {
    case 1: return launch_planes<1>(a, s);
    case 2: return launch_planes<2>(a, s);
    case 4: return launch_planes<4>(a, s);
    case 8: return launch_planes<8>(a, s);
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
