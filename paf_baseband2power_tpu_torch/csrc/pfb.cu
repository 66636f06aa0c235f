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
// 1024, 1 <= ntap <= 8 and any nout the golden takes (wpg >= ntap - 1) work.
//
// Work: one block per (coarse channel, tile of window end slots). Both pols
// of the channel go through the block together: a wire load of 8 bytes is
// one (x, y) sample pair; rows read the same sample of series 2 ch and
// 2 ch + 1. Per step the block
//   1. loads the next sp = max(nfft, 256) samples of both pols into a ring
//      in shared memory that also holds the (ntap - 1) * nfft samples before
//      them, so the FIR stencil carries across steps and each sample is
//      read from device memory once per tile (the wire layout's 56-byte
//      stride between a channel's samples is left to L2: the 7 channels of
//      a chunk are neighbouring blocks and read the same sectors);
//   2. forms W = sp / nfft windows per pol in fp32 (FIR: ntap shifted rows
//      times the coefficients, kept in shared memory), written in
//      bit-reversed order;
//   3. runs radix-2 decimation-in-time FFTs in shared memory, twiddles
//      computed in double and stored as float;
//   4. detects |x|^2 + |y|^2 or I, Q, U, V per window and adds it, in
//      float64, to the thread's accumulators (a thread owns fixed fine
//      channels for the whole tile).
// Window w of the block ends in row slot e (rows are nfft samples) and lands
// in spectrum e / wpg. Tiles never straddle spectra. Slots e < ntap - 1 read
// the carry, or do not exist one-shot. Each block writes its float64 sums to
// its own slot of a partials array; a finish kernel adds a spectrum's tiles
// in a fixed order (no float atomics: results do not vary from run to run),
// divides for the mean, fftshifts and writes float32 (nout, ns, nchan, nfft).
//
// Bound: shared memory and fp32 throughput, not HBM. The 2.8 GB block is read
// once (0.84 ms at 3.35 TB/s), but every complex sample then takes ntap FIR
// multiply-adds and log2(nfft) radix-2 butterfly passes through shared
// memory with a barrier each. A first version, written to be right; faster
// FFTs (radix 4/8 in registers, one warp per FFT) are later work.
//
// Accuracy: fp32 FIR and FFT (about log2(nfft) rounding steps, well under
// the 2e-5 peak-normalized bound against the float64 reference); sums over
// up to 2^19 windows in float64. No fast-math.

#include <cstdint>

#include <cuda_runtime.h>

#include "geometry.cuh"

namespace {

using namespace pafb2p;

constexpr int kPfbThreads = 256;
constexpr int kMinStep = 256;      // samples per pol per step, at least
constexpr int kMaxNfft = 1024;
constexpr int kMaxNtap = 8;
constexpr int64_t kPairsChunk = 896;   // 8-byte (x, y) pairs per chunk-frame

struct PfbArgs {
  const void* x;         // wire (ndf, nchk * 3584) or rows (nseries, ndf, 256)
  const int* hist;       // carry (nseries, halo) int32 (re, im) words, or null
  const float* coeffs;   // (ntap, nfft)
  double* partial;       // (nout * nsub, nchan, ns, nfft)
  int64_t nchk, nchan, nsamp, nblk, wpg, nsub, ts, halo;
  int nfft, log2n, ntap, sp, w, cap;
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

// Shared memory of one block, in bytes, and its carve-up (all 8-byte units).
inline size_t pfb_smem(int cap, int sp, int nfft, int ntap, int ns) {
  return sizeof(int2) * cap + sizeof(double) * kPfbThreads * ns +
         sizeof(float2) * (2 * sp + nfft / 2) + sizeof(float) * ntap * nfft;
}

// One block per (channel, tile); blockIdx.x = tile * nchan + channel, so the
// 7 channels of a chunk run side by side.
template <class L, bool kStokes>
__global__ void __launch_bounds__(kPfbThreads) pfb_kernel(PfbArgs a) {
  constexpr int ns = kStokes ? 4 : 1;
  constexpr int kMaxPer = kMaxNfft / kPfbThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  int2* ring = reinterpret_cast<int2*>(smem);              // cap pairs
  double* red = reinterpret_cast<double*>(ring + a.cap);    // ns x threads
  float2* buf = reinterpret_cast<float2*>(red + kPfbThreads * ns);  // 2 x sp
  float2* tw = buf + 2 * a.sp;                              // nfft / 2
  float* coef = reinterpret_cast<float*>(tw + a.nfft / 2);  // ntap x nfft

  const int tid = threadIdx.x;
  const int nfft = a.nfft, sp = a.sp, mask = a.cap - 1;
  const int64_t ch = blockIdx.x % a.nchan;
  const int64_t tile = blockIdx.x / a.nchan;
  const int64_t g = tile / a.nsub;
  const int64_t e0 = g * a.wpg + tile % a.nsub * a.ts;
  const int64_t e_end = min(e0 + a.ts, (g + 1) * a.wpg);
  const int64_t first = a.hist != nullptr ? 0 : a.ntap - 1;

  for (int i = tid; i < nfft / 2; i += kPfbThreads) {
    double s, c;
    sincospi(-2.0 * i / nfft, &s, &c);
    tw[i] = make_float2(static_cast<float>(c), static_cast<float>(s));
  }
  for (int i = tid; i < a.ntap * nfft; i += kPfbThreads) coef[i] = a.coeffs[i];

  // ring position q holds sample p0 + q; the first (ntap - 1) * nfft are the
  // rows before the tile's first window end slot
  const int64_t p0 = (e0 - a.ntap + 1) * nfft;
  for (int64_t q = tid; q < a.halo; q += kPfbThreads) {
    ring[q & mask] = load_pair<L>(a, ch, p0 + q);
  }

  double acc[kMaxPer][ns];
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) {
#pragma unroll
    for (int q = 0; q < ns; ++q) acc[m][q] = 0.0;
  }
  const int per = sp / kPfbThreads;
  const int64_t nsteps = (e_end - e0 + a.w - 1) / a.w;
  for (int64_t st = 0; st < nsteps; ++st) {
    const int64_t qbase = a.halo + st * sp;
    for (int i = tid; i < sp; i += kPfbThreads) {
      ring[(qbase + i) & mask] = load_pair<L>(a, ch, p0 + qbase + i);
    }
    __syncthreads();
    // FIR: window j of the step starts at ring position st * sp + j * nfft
    for (int i = tid; i < 2 * sp; i += kPfbThreads) {
      const int pol = i >= sp;
      const int rem = i - pol * sp;
      const int n = rem & (nfft - 1);
      const int64_t q0 = st * sp + rem;
      float re = 0.0f, im = 0.0f;
      for (int t = 0; t < a.ntap; ++t) {
        const int2 v = ring[(q0 + static_cast<int64_t>(t) * nfft) & mask];
        const int wv = pol ? v.y : v.x;
        const float c = coef[t * nfft + n];
        re += c * re16(wv);
        im += c * im16(wv);
      }
      const int rev = a.log2n ? static_cast<int>(__brev(n) >> (32 - a.log2n))
                              : 0;
      buf[pol * sp + (rem - n) + rev] = make_float2(re, im);
    }
    __syncthreads();
    // radix-2 DIT: 2 W FFTs of nfft points, nfft / 2 butterflies each
    for (int h = 1; h < nfft; h <<= 1) {
      const int stride = nfft / (2 * h);
      for (int b = tid; b < sp; b += kPfbThreads) {
        const int f = b / (nfft / 2), bb = b % (nfft / 2);
        const int jj = bb % h;
        const int i0 = f * nfft + (bb - jj) * 2 + jj;
        const float2 w = tw[jj * stride];
        const float2 u = buf[i0], v = buf[i0 + h];
        const float2 wv = make_float2(w.x * v.x - w.y * v.y,
                                      w.x * v.y + w.y * v.x);
        buf[i0] = make_float2(u.x + wv.x, u.y + wv.y);
        buf[i0 + h] = make_float2(u.x - wv.x, u.y - wv.y);
      }
      __syncthreads();
    }
    // detect: thread position i = window (i / nfft) and fine channel i % nfft
#pragma unroll
    for (int m = 0; m < kMaxPer; ++m) {
      if (m >= per) break;
      const int i = tid + m * kPfbThreads;
      const int64_t e = e0 + st * a.w + (i >> a.log2n);
      if (e >= e_end || e < first) continue;
      const float2 x = buf[i], y = buf[sp + i];
      const float pxx = x.x * x.x + x.y * x.y;
      const float pyy = y.x * y.x + y.y * y.y;
      if constexpr (kStokes) {
        acc[m][0] += static_cast<double>(pxx + pyy);
        acc[m][1] += static_cast<double>(pxx - pyy);
        acc[m][2] += static_cast<double>(2.0f * (x.x * y.x + x.y * y.y));
        acc[m][3] += static_cast<double>(2.0f * (x.y * y.x - x.x * y.y));
      } else {
        acc[m][0] += static_cast<double>(pxx + pyy);
      }
    }
  }

  double* out = a.partial + (tile * a.nchan + ch) * ns * nfft;
  if (a.w == 1) {
#pragma unroll
    for (int m = 0; m < kMaxPer; ++m) {
      if (m >= per) break;
#pragma unroll
      for (int q = 0; q < ns; ++q) out[q * nfft + tid + m * kPfbThreads] =
          acc[m][q];
    }
    return;
  }
  // W windows per step share a fine channel: add them in a fixed order
#pragma unroll
  for (int q = 0; q < ns; ++q) red[q * kPfbThreads + tid] = acc[0][q];
  __syncthreads();
  if (tid < nfft) {
#pragma unroll
    for (int q = 0; q < ns; ++q) {
      double s = 0.0;
      for (int j = 0; j < a.w; ++j) s += red[q * kPfbThreads + j * nfft + tid];
      out[q * nfft + tid] = s;
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

template <class L, bool kStokes>
int launch_pfb(const PfbArgs& a, int64_t nblocks, size_t smem,
               cudaStream_t stream) {
  auto kernel = pfb_kernel<L, kStokes>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(nblocks), kPfbThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One block, wire (ndf, nchk * 3584) or rows (nchk * 14, ndf, 256) int16,
// -> partial (nout * nsub, nchk * 7, ns, nfft) float64 sums, ns = 4 (Stokes)
// or 1. coeffs (ntap, nfft) float32; hist (nchk * 14, (ntap - 1) * nfft, 2)
// int16 or null (one-shot). ts: window end slots per tile, a multiple of
// max(256 / nfft, 1); nsub = ceil(wpg / ts) tiles per spectrum.
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
  a.sp = a.nfft > kMinStep ? a.nfft : kMinStep;
  a.w = a.sp / a.nfft;
  if (ts <= 0 || ts % a.w || nsub != (a.wpg + ts - 1) / ts) {
    return static_cast<int>(bad);
  }
  a.ts = ts;
  a.nsub = nsub;
  a.cap = 1;
  while (a.cap < a.halo + a.sp) a.cap <<= 1;
  const int64_t nblocks = nout * nsub * a.nchan;
  if (nblocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = pfb_smem(a.cap, a.sp, a.nfft, a.ntap, stokes ? 4 : 1);
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
