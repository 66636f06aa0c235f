// PFB spectrometer on Hopper: int16 I/Q -> polyphase FIR -> FFT -> power or
// full Stokes -> a waterfall of nout spectra.
//
// Replaces the fused Pallas TPU kernels of paf_baseband2power_tpu:
//   * ops/pallas_pfb.py:pfb_spectra_fused (_spectra_kernel): FIR + nfft-point
//     DFT + power or Stokes + nout spectra, wire or series rows, with the
//     overlap-save carry;
//   * ops/pallas_pfb.py:pfb_power_fused (_fused_kernel): the nfft = 128,
//     nout = 1 power case of the same computation, so the same kernel.
// The TPU corner-turned the wire block into series rows because Mosaic could
// not read it, split its fp32 DFT into three bf16 MXU passes and tiled to
// (8, 128); none of that carries over. Here any power-of-two nfft from 2 to
// 1024 (series rows 128-1024, the JAX package's rows rule), 1 <= ntap <= 8
// and any nout the golden takes (wpg >= ntap - 1) work.
//
// Work: one block of 8 warps per (coarse channel, tile of window end slots).
// Both pols of the channel go through the block together: a wire load of 8
// bytes is one (x, y) sample pair; rows read the same sample of series 2 ch
// and 2 ch + 1. Per step of W = sp / nfft windows, sp = max(4 nfft, 1024)
// samples per pol, the block
//   1. loads the step's samples of both pols into a ring in shared memory of
//      R = ntap - 1 + W rows of nfft pairs, which also holds the ntap - 1
//      rows before them, so the FIR stencil carries across steps and each
//      sample is read from device memory once per tile (the wire layout's
//      56-byte stride between a channel's samples is left to L2: the 7
//      channels of a chunk are neighbouring blocks and read the same
//      sectors); then one barrier;
//   2. runs 2 W FFTs, one per (window, pol), each in the registers of one
//      warp (of P = min(nfft, 32) lanes of one; nfft < 32 puts 32 / nfft
//      FFTs side by side in a warp), with no barrier: lane p forms the FIR
//      outputs of points n = p + P j, j < m = nfft / P, straight from the
//      ring into registers; an m-point radix-2 FFT in its registers (m a
//      template parameter, fully unrolled); the twiddles W_nfft^(p k1); a
//      P-point radix-2 FFT across the lanes in log2(P) __shfl_xor_sync
//      stages. Lane p then holds bin k1 + m k2 in register i, k1 = brev_m(i)
//      and k2 = brev_P(p), and writes it to position i P + p of the window
//      in shared memory (consecutive lanes, consecutive addresses); then one
//      barrier;
//   3. detects |x|^2 + |y|^2 or I, Q, U, V per position and adds it, in
//      float64, to the thread's accumulators: a thread owns the same
//      positions, so the same bins, in every window of the tile.
// Window w of the block ends in row slot e (rows are nfft samples) and lands
// in spectrum e / wpg. Tiles never straddle spectra. Slots e < ntap - 1 read
// the carry, or do not exist one-shot. Each block writes its float64 sums to
// its own slot of a partials array, each position to its bin; a finish
// kernel adds a spectrum's tiles in a fixed order (no float atomics: results
// do not vary from run to run), divides for the mean, fftshifts and writes
// float32 (nout, ns, nchan, nfft).
//
// Bound: HBM bytes. The 2.8 GB block is read once (0.84 ms at 3.35 TB/s);
// the function's least arithmetic (FIR 4 ntap, FFT 5 log2 nfft, detection
// flops per complex sample) takes less. What the kernel adds on top: ntap
// ring and coefficient reads from shared memory per point, one write and
// one read of each spectrum, 2 log2(P) lane shuffles per point and two
// barriers per step; the first version of this kernel, with log2(nfft)
// shared-memory radix-2 passes and a barrier each, took 19x its bound.
// This one takes 5x at nfft 128 and 12x at nfft 1024 Stokes on an H100
// (PERF.md): at nfft 1024 only one block of 8 warps fits an SM (153 KB of
// shared memory, 195 registers), so a step's loads and FFTs do not overlap.
//
// Accuracy: fp32 FIR and FFT (about log2(nfft) rounding steps, well under
// the 2e-5 peak-normalized bound against the float64 reference); sums over
// up to 2^19 windows in float64. Twiddles computed in double, stored as
// float. No fast-math.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "geometry.cuh"

namespace {

using namespace pafb2p;

constexpr int kPfbThreads = 256;
constexpr int kWarps = kPfbThreads / 32;
constexpr int kMinStep = 1024;     // samples per pol per step, at least
constexpr int kMinWindows = 4;     // windows per step, at least: an FFT a warp
constexpr int kMaxNfft = 1024;
constexpr int kMaxNtap = 8;
constexpr int64_t kPairsChunk = 896;   // 8-byte (x, y) pairs per chunk-frame

struct PfbArgs {
  const void* x;         // wire (ndf, nchk * 3584) or rows (nseries, ndf, 256)
  const int* hist;       // carry (nseries, halo) int32 (re, im) words, or null
  const float* coeffs;   // (ntap, nfft)
  double* partial;       // (nout * nsub, nchan, ns, nfft)
  int64_t nchk, nchan, nsamp, nblk, wpg, nsub, ts, halo;
  int nfft, log2n, ntap, sp, w, rows;
};

// Wire: the pair of channel ch at sample p is int2 (x word, y word).
struct PfbWire {
  __device__ static int2 load(const PfbArgs& a, int64_t ch, int64_t p) {
    const int64_t f = p >> 7, s = p & 127;
    const int64_t chk = ch / kChanChk, chan = ch % kChanChk;
    return __ldg(static_cast<const int2*>(a.x) + (f * a.nchk + chk) *
                 kPairsChunk + s * kChanChk + chan);
  }
};

// Rows: series 2 ch (x) and 2 ch + 1 (y), nsamp int32 words each.
struct PfbRows {
  __device__ static int2 load(const PfbArgs& a, int64_t ch, int64_t p) {
    const int* px = static_cast<const int*>(a.x) + 2 * ch * a.nsamp + p;
    return make_int2(__ldg(px), __ldg(px + a.nsamp));
  }
};

// Sample p of channel ch: the block for 0 <= p < nblk * nfft, the carry for
// p < 0 (zero without one), zero past the last window row.
template <class L>
__device__ __forceinline__ int2 load_pair(const PfbArgs& a, int64_t ch,
                                          int64_t p) {
  if (p >= 0) {
    return p < a.nblk * a.nfft ? L::load(a, ch, p) : make_int2(0, 0);
  }
  if (a.hist == nullptr) return make_int2(0, 0);
  const int* h = a.hist + 2 * ch * a.halo + a.halo + p;
  return make_int2(h[0], h[a.halo]);
}

__device__ __forceinline__ float re16(int w) {
  return static_cast<float>(static_cast<short>(w & 0xffff));
}
__device__ __forceinline__ float im16(int w) {
  return static_cast<float>(w >> 16);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 twiddle(int k, int n) {  // W_n^k
  double s, c;
  sincospi(-2.0 * k / n, &s, &c);
  return make_float2(static_cast<float>(c), static_cast<float>(s));
}

__device__ __forceinline__ int bit_reverse(int x, int bits) {
  return bits ? static_cast<int>(__brev(static_cast<unsigned>(x)) >>
                                 (32 - bits))
              : 0;
}

__host__ __device__ constexpr int log2i(int n) {
  return n > 1 ? 1 + log2i(n / 2) : 0;
}

// In-register M-point radix-2 decimation in frequency: natural order in,
// bit-reversed out (a[i] = A[brev_M(i)]). twm[q] = W_M^q, q < M / 2. One
// loop of constant trip count per stage, so every index is known at compile
// time and a stays in registers.
template <int M, int S = 0>
__device__ __forceinline__ void register_fft(float2 (&a)[M],
                                             const float2* twm) {
  if constexpr ((1 << S) < M) {
    constexpr int half = M >> (S + 1);
#pragma unroll
    for (int k = 0; k < M / 2; ++k) {
      const int i = k % half, b = k / half * 2 * half;
      const float2 u = a[b + i], v = a[b + i + half];
      const float2 d = make_float2(u.x - v.x, u.y - v.y);
      const int q = i << S;                   // W_(2 half)^i = W_M^q
      a[b + i] = make_float2(u.x + v.x, u.y + v.y);
      a[b + i + half] = q == 0 ? d
                        : 4 * q == M ? make_float2(d.y, -d.x)
                                     : cmul(d, twm[q]);
    }
    register_fft<M, S + 1>(a, twm);
  }
}

// Shared memory of one block, in bytes, and its carve-up (all 8-byte units
// but the coefficients, last).
inline size_t pfb_smem(int rows, int sp, int nfft, int ntap, int ns) {
  return sizeof(int2) * rows * nfft + sizeof(float2) * 2 * sp +
         sizeof(double) * kPfbThreads * ns +
         sizeof(float2) * (nfft + kMaxNfft / 64 + 5 * 32) +
         sizeof(float) * ntap * nfft;
}

// One block per (channel, tile); blockIdx.x = tile * nchan + channel, so the
// 7 channels of a chunk run side by side. kM = max(nfft / 32, 1) points per
// lane. The body of the two kernels below.
template <class L, bool kStokes, int kM>
__device__ __forceinline__ void pfb_body(const PfbArgs& a) {
  constexpr int ns = kStokes ? 4 : 1;
  // positions per thread and step (sp / 256), and distinct ones (bins)
  constexpr int kPer = kM / 2 > 4 ? kM / 2 : 4;
  constexpr int kBins = kM / 8 > 1 ? kM / 8 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nfft = a.nfft, sp = a.sp, W = a.w, R = a.rows;
  int2* ring = reinterpret_cast<int2*>(smem);               // R x nfft pairs
  float2* buf = reinterpret_cast<float2*>(ring + R * nfft);  // 2 x sp
  double* red = reinterpret_cast<double*>(buf + 2 * sp);     // ns x threads
  float2* tw = reinterpret_cast<float2*>(red + kPfbThreads * ns);  // nfft
  float2* twm = tw + nfft;                                   // kM / 2
  float2* tws = twm + kMaxNfft / 64;                         // 5 x 32
  float* coef = reinterpret_cast<float*>(tws + 5 * 32);      // ntap x nfft

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = kM > 1 ? 32 : nfft;           // lanes per FFT
  const int lp = a.log2n - log2i(kM);         // log2(P)
  const int G = 32 >> lp;                     // FFTs side by side per warp
  const int p = lane & (P - 1);
  const int64_t ch = blockIdx.x % a.nchan;
  const int64_t tile = blockIdx.x / a.nchan;
  const int64_t g = tile / a.nsub;
  const int64_t e0 = g * a.wpg + tile % a.nsub * a.ts;
  const int64_t e_end = min(e0 + a.ts, (g + 1) * a.wpg);
  const int64_t first = a.hist != nullptr ? 0 : a.ntap - 1;

  // tw[k1 * 32 + p] = W_nfft^(p k1) (kM > 1), twm[q] = W_kM^q; tws[s * 32
  // + p]: lane p's factor in the cross-lane stage h = 16 >> s, where a lane
  // with bit h set takes (other - own) W_2h^(p mod h), the other other + own
  for (int i = tid; i < (kM > 1 ? nfft : 0); i += kPfbThreads) {
    tw[i] = twiddle((i & 31) * (i >> 5), nfft);
  }
  for (int i = tid; i < kM / 2; i += kPfbThreads) twm[i] = twiddle(i, kM);
  for (int i = tid; i < 5 * 32; i += kPfbThreads) {
    const int h = 16 >> (i >> 5), l = i & 31;
    tws[i] = l & h ? twiddle(l & (h - 1), 2 * h) : make_float2(1.0f, 0.0f);
  }
  for (int i = tid; i < a.ntap * nfft; i += kPfbThreads) coef[i] = a.coeffs[i];

  // ring row r % R holds samples p0 + r nfft ..; the first ntap - 1 rows are
  // the ones before the tile's first window end slot
  const int64_t p0 = (e0 - a.ntap + 1) * nfft;
  for (int64_t q = tid; q < a.halo; q += kPfbThreads) {
    ring[q] = load_pair<L>(a, ch, p0 + q);
  }

  double acc[kBins][ns];
#pragma unroll
  for (int b = 0; b < kBins; ++b) {
#pragma unroll
    for (int q = 0; q < ns; ++q) acc[b][q] = 0.0;
  }
  const int64_t nsteps = (e_end - e0 + W - 1) / W;
  int base = 0;    // ring row of the step's first window: (st W) % R
  for (int64_t st = 0; st < nsteps; ++st) {
    // 1. the step's rows ntap - 1 + st W .. into the ring
    const int64_t qbase = a.halo + st * sp;
    for (int i = tid; i < sp; i += kPfbThreads) {
      int row = base + a.ntap - 1 + (i >> a.log2n);
      row -= row >= R ? R : 0;
      ring[row * nfft + (i & (nfft - 1))] = load_pair<L>(a, ch, p0 + qbase + i);
    }
    __syncthreads();
    // 2. FFT units u = (window j, pol): G side by side per warp
    for (int u = warp * G + (lane >> lp); u < 2 * W; u += kWarps * G) {
      const int pol = u >= W, j = u - pol * W;
      float2 v[kM];
#pragma unroll
      for (int i = 0; i < kM; ++i) v[i] = make_float2(0.0f, 0.0f);
      for (int t = 0; t < a.ntap; ++t) {
        int row = base + j + t;
        row -= row >= R ? R : 0;
        const int2* rp = ring + row * nfft + p;
        const float* cp = coef + t * nfft + p;
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          const int2 s2 = rp[i * 32];
          const int wv = pol ? s2.y : s2.x;
          const float c = cp[i * 32];
          v[i].x += c * re16(wv);
          v[i].y += c * im16(wv);
        }
      }
      register_fft<kM>(v, twm);
      if (kM > 1) {
#pragma unroll
        for (int i = 1; i < kM; ++i) {
          v[i] = cmul(v[i], tw[bit_reverse(i, log2i(kM)) * 32 + p]);
        }
      }
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const int h = 16 >> s;
        if (h >= P) continue;
        const float2 w = tws[s * 32 + p];
        const float sg = p & h ? -1.0f : 1.0f;
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          const float2 o = make_float2(__shfl_xor_sync(0xffffffffu, v[i].x, h),
                                       __shfl_xor_sync(0xffffffffu, v[i].y, h));
          v[i] = cmul(make_float2(o.x + sg * v[i].x, o.y + sg * v[i].y), w);
        }
      }
      float2* out = buf + pol * sp + j * nfft + p;
#pragma unroll
      for (int i = 0; i < kM; ++i) out[i * P] = v[i];
    }
    __syncthreads();
    // 3. detect: thread position i = window (i / nfft), position i % nfft
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = tid + r * kPfbThreads;
      const int64_t e = e0 + st * W + (i >> a.log2n);
      if (e >= e_end || e < first) continue;
      const float2 x = buf[i], y = buf[sp + i];
      const float pxx = x.x * x.x + x.y * x.y;
      const float pyy = y.x * y.x + y.y * y.y;
      const int b = r % kBins;
      if constexpr (kStokes) {
        acc[b][0] += static_cast<double>(pxx + pyy);
        acc[b][1] += static_cast<double>(pxx - pyy);
        acc[b][2] += static_cast<double>(2.0f * (x.x * y.x + x.y * y.y));
        acc[b][3] += static_cast<double>(2.0f * (x.y * y.x - x.x * y.y));
      } else {
        acc[b][0] += static_cast<double>(pxx + pyy);
      }
    }
    base += W;
    base -= base >= R ? R : 0;
  }

  // position i P + p holds bin brev_m(i) + m brev_P(p)
  const auto bin = [&](int pos) {
    return bit_reverse(pos >> lp, log2i(kM)) +
           kM * bit_reverse(pos & (P - 1), lp);
  };
  double* out = a.partial + (tile * a.nchan + ch) * ns * nfft;
  if (nfft >= kPfbThreads) {
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      const int k = bin(tid + b * kPfbThreads);
#pragma unroll
      for (int q = 0; q < ns; ++q) out[q * nfft + k] = acc[b][q];
    }
    return;
  }
  // 256 / nfft threads share a position: add them in a fixed order
#pragma unroll
  for (int q = 0; q < ns; ++q) red[q * kPfbThreads + tid] = acc[0][q];
  __syncthreads();
  if (tid < nfft) {
    const int k = bin(tid);
#pragma unroll
    for (int q = 0; q < ns; ++q) {
      double s = 0.0;
      for (int c = tid; c < kPfbThreads; c += nfft) {
        s += red[q * kPfbThreads + c];
      }
      out[q * nfft + k] = s;
    }
  }
}

// partial (nout * nsub, nchan, ns, nfft) -> out (nout, ns, nchan, nfft): the
// nsub tiles of each spectrum added in order, divided (div0 for spectrum 0,
// div for the rest; <= 0 keeps the sum), fftshifted per coarse channel.
__global__ void pfb_finish_kernel(const double* __restrict__ partial,
                                  float* __restrict__ out, int64_t nchan,
                                  int64_t nfft, int64_t nout, int64_t nsub,
                                  int64_t ns, int shift, double div0,
                                  double div) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nout * ns * nchan * nfft) return;
  const int64_t kk = i % nfft;
  const int64_t ch = i / nfft % nchan;
  const int64_t q = i / (nfft * nchan) % ns;
  const int64_t g = i / (nfft * nchan * ns);
  const int64_t k = shift ? (kk + nfft / 2) % nfft : kk;
  double s = 0.0;
  for (int64_t sub = 0; sub < nsub; ++sub) {
    s += partial[(((g * nsub + sub) * nchan + ch) * ns + q) * nfft + k];
  }
  const double d = g == 0 ? div0 : div;
  out[i] = static_cast<float>(d > 0.0 ? s / d : s);
}

// nfft <= 128: ptxas's own choice of registers (44-64, no spills, 4-5
// blocks per SM). nfft >= 256: a minimum of one block per SM lets the
// 8-32-point register FFTs have the registers they need (94-195, 1-2 blocks
// per SM; at nfft 1024 shared memory allows one anyway); without it ptxas
// spilled some instantiations to keep to 64 or 128 registers.
template <class L, bool kStokes, int kM>
__global__ void __launch_bounds__(kPfbThreads) pfb_kernel(PfbArgs a) {
  pfb_body<L, kStokes, kM>(a);
}
template <class L, bool kStokes, int kM>
__global__ void __launch_bounds__(kPfbThreads, 1) pfb_kernel_wide(PfbArgs a) {
  pfb_body<L, kStokes, kM>(a);
}

template <class L, bool kStokes, int kM>
int launch_pfb_m(const PfbArgs& a, int64_t nblocks, size_t smem,
                 cudaStream_t stream) {
  void (*kernel)(PfbArgs);
  if constexpr (kM >= 8) {
    kernel = pfb_kernel_wide<L, kStokes, kM>;
  } else {
    kernel = pfb_kernel<L, kStokes, kM>;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(nblocks), kPfbThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation of nfft's points per lane, max(nfft / 32, 1); rows
// take nfft 128-1024 only (the JAX package's rows rule)
template <class L, bool kStokes>
int launch_pfb(const PfbArgs& a, int64_t nblocks, size_t smem,
               cudaStream_t stream) {
  constexpr bool wire = std::is_same<L, PfbWire>::value;
  switch (a.nfft >> 5) {
    case 0:
    case 1:
      if constexpr (wire) {
        return launch_pfb_m<L, kStokes, 1>(a, nblocks, smem, stream);
      }
      break;
    case 2:
      if constexpr (wire) {
        return launch_pfb_m<L, kStokes, 2>(a, nblocks, smem, stream);
      }
      break;
    case 4: return launch_pfb_m<L, kStokes, 4>(a, nblocks, smem, stream);
    case 8: return launch_pfb_m<L, kStokes, 8>(a, nblocks, smem, stream);
    case 16: return launch_pfb_m<L, kStokes, 16>(a, nblocks, smem, stream);
    default: return launch_pfb_m<L, kStokes, 32>(a, nblocks, smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// One block, wire (ndf, nchk * 3584) or rows (nchk * 14, ndf, 256; nfft
// 128-1024) int16,
// -> partial (nout * nsub, nchk * 7, ns, nfft) float64 sums, ns = 4 (Stokes)
// or 1. coeffs (ntap, nfft) float32; hist (nchk * 14, (ntap - 1) * nfft, 2)
// int16 or null (one-shot). ts: window end slots per tile, a multiple of
// the step's max(4, 1024 / nfft) windows; nsub = ceil(wpg / ts) tiles per
// spectrum.
int pafb2p_pfb(const void* x, int rows, int64_t ndf, int64_t nchk,
               int64_t nfft, int64_t ntap, int64_t nout, int stokes,
               const void* coeffs, const void* hist, int64_t ts, int64_t nsub,
               void* partial, void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (nfft < 2 || nfft > kMaxNfft || (nfft & (nfft - 1)) || ntap < 1 ||
      ntap > kMaxNtap || ndf <= 0 || nchk <= 0 || nout <= 0) {
    return static_cast<int>(bad);
  }
  PfbArgs a;
  a.x = x;
  a.hist = static_cast<const int*>(hist);
  a.coeffs = static_cast<const float*>(coeffs);
  a.partial = static_cast<double*>(partial);
  a.nchk = nchk;
  a.nchan = nchk * kChanChk;
  a.nsamp = ndf * 128;
  if (a.nsamp % nfft) return static_cast<int>(bad);
  a.nblk = a.nsamp / nfft;
  if (a.nblk % nout) return static_cast<int>(bad);
  a.wpg = a.nblk / nout;
  if (a.wpg < (ntap > 2 ? ntap - 1 : 1)) return static_cast<int>(bad);
  a.nfft = static_cast<int>(nfft);
  a.log2n = 0;
  while ((1 << a.log2n) < a.nfft) ++a.log2n;
  a.ntap = static_cast<int>(ntap);
  a.halo = (ntap - 1) * nfft;
  a.sp = kMinWindows * a.nfft > kMinStep ? kMinWindows * a.nfft : kMinStep;
  a.w = a.sp / a.nfft;
  if (ts <= 0 || ts % a.w || nsub != (a.wpg + ts - 1) / ts) {
    return static_cast<int>(bad);
  }
  a.ts = ts;
  a.nsub = nsub;
  a.rows = a.ntap - 1 + a.w;
  const int64_t nblocks = nout * nsub * a.nchan;
  if (nblocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = pfb_smem(a.rows, a.sp, a.nfft, a.ntap, stokes ? 4 : 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows) {
    return stokes ? launch_pfb<PfbRows, true>(a, nblocks, smem, s)
                  : launch_pfb<PfbRows, false>(a, nblocks, smem, s);
  }
  return stokes ? launch_pfb<PfbWire, true>(a, nblocks, smem, s)
                : launch_pfb<PfbWire, false>(a, nblocks, smem, s);
}

// partial (nout * nsub, nchan, ns, nfft) float64 -> out (nout, ns, nchan *
// nfft) float32, divided by div0 (spectrum 0) and div (the others) unless
// they are <= 0, fftshifted when shift is set.
int pafb2p_pfb_finish(const void* partial, void* out, int64_t nchan,
                      int64_t nfft, int64_t nout, int64_t nsub, int64_t ns,
                      int shift, double div0, double div, void* stream) {
  if (nchan <= 0 || nfft <= 0 || nout <= 0 || nsub <= 0 || ns <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;
  const int64_t n = nout * ns * nchan * nfft;
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  pfb_finish_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partial), static_cast<float*>(out), nchan,
      nfft, nout, nsub, ns, shift, div0, div);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
