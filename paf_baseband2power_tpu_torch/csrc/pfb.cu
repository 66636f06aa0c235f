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
// Both pols of the channel go through the block together: a wire sample
// pair is 8 bytes (x, y); rows take the same sample of series 2 ch and
// 2 ch + 1 (4 bytes each). Per step of W = sp / nfft windows, sp =
// max(4 nfft, 1024) samples per pol, the block
//   1. stages a step's samples of both pols into a ring in shared memory of
//      R = ntap - 1 + D W rows of nfft pairs, D the stages (plan_pfb): the
//      ntap - 1 rows before a step's first window, so the FIR stencil
//      carries across steps and each sample is read from device memory
//      once per tile, and D steps. The wide kernels (nfft >= 256, one or two
//      blocks an SM) copy with cp.async: with D = 2 the copies of step
//      st + 1 are issued before step st's FFTs, into the rows step st - 1
//      read, and waited for (cp.async.wait_group, then one barrier) only
//      before step st + 1's, so the loads run under the FFTs; the halo and
//      step 0 are issued before the twiddles are computed. With D = 1 a
//      step's copies are waited for before its FFTs. At nfft <= 128 four or
//      five blocks an SM hide the loads' latency: D = 1, and the samples
//      are loaded through registers before one barrier. (The wire layout's
//      56-byte stride between a channel's samples gives TMA no box and is
//      left to L2: the 7 channels of a chunk are neighbouring blocks and
//      read the same sectors.)
//   2. runs 2 W FFTs, one per (window, pol), each in the registers of one
//      warp (of P = min(nfft, 32) lanes of one; nfft < 32 puts 32 / nfft
//      FFTs side by side in a warp), with no barrier: lane p forms the FIR
//      outputs of points n = p + P j, j < m = nfft / P, straight from the
//      ring into registers; an m-point radix-2 FFT in its registers (m a
//      template parameter, fully unrolled); the twiddles W_nfft^(p k1);
//      then the P-point factor over the lanes. At nfft <= 128 it is a
//      radix-2 FFT across the lanes in log2(P) __shfl_xor_sync stages: lane
//      p then holds bin k1 + m k2 in register i, k1 = brev_m(i) and k2 =
//      brev_P(p), and writes it to position i P + p of the window in shared
//      memory (consecutive lanes, consecutive addresses). The wide kernels
//      (m = 8-32) transpose instead, through the warp's own nfft slot of
//      that window: lane p stores register r at float2 r 32 + (p ^ r L), L
//      = 32 / m; lane q = c L + l loads points p = l + L i of row c into
//      register i (the swizzle leaves both conflict-free), runs a second
//      m-point register FFT, the twiddles W_32^(l k) and log2(L) shuffle
//      stages across the L lanes of a column (none at nfft 1024), and
//      writes register i, bin brev_m(c) + m (brev_m(i) + m brev_L(l)), to
//      position i 32 + q. At nfft 1024 that took the kernel from 6.4x its
//      bound to 5.6x, 7.0x to 6.1x in Stokes, on an H100 (PERF.md). Then
//      one barrier;
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
// shared-memory radix-2 passes and a barrier each, took 19x its bound. At
// nfft >= 256 registers allow one or two blocks of 8 warps an SM (at nfft
// 1024 one, with ~181 KB of shared memory at D = 2), too few to hide the
// loads behind other blocks' arithmetic, so each block hides them behind
// its own FFTs: at nfft 1024 this one takes 6x its bound, 7x in Stokes, on
// an H100 (PERF.md), where loading before the FFTs took 11x and 12x.
//
// Accuracy: fp32 FIR and FFT (about log2(nfft) rounding steps, well under
// the 2e-5 peak-normalized bound against the float64 reference); sums over
// up to 2^19 windows in float64. Twiddles computed in double, stored as
// float. No fast-math.

#include <atomic>
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
constexpr size_t kMaxSmem = 232448;    // dynamic shared memory of a block
constexpr int kWideM = 8;   // points per lane of the wide kernels (nfft >= 256)
constexpr int kMaxDevices = 16;   // devices whose stages plan_pfb keeps

struct PfbArgs {
  const void* x;         // wire (ndf, nchk * 3584) or rows (nseries, ndf, 256)
  const int* hist;       // carry (nseries, halo) int32 (re, im) words, or null
  const float* coeffs;   // (ntap, nfft)
  double* partial;       // (nout * nsub, nchan, ns, nfft)
  int64_t nchk, nchan, nsamp, nblk, wpg, nsub, ts, halo;
  int nfft, log2n, ntap, sp, w, depth, rows;
};

// An asynchronous copy of 4 or 8 bytes from device to shared memory; a
// thread's copies complete in the groups it commits, in order.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(kBytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most kPending of the thread's newest groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Wire: the pair of channel ch at sample p is int2 (x word, y word).
struct PfbWire {
  __device__ static const int2* at(const PfbArgs& a, int64_t ch, int64_t p) {
    const int64_t f = p >> 7, s = p & 127;
    const int64_t chk = ch / kChanChk, chan = ch % kChanChk;
    return static_cast<const int2*>(a.x) + (f * a.nchk + chk) * kPairsChunk +
           s * kChanChk + chan;
  }
  __device__ static int2 load(const PfbArgs& a, int64_t ch, int64_t p) {
    return __ldg(at(a, ch, p));
  }
  __device__ static void copy(int2* dst, const PfbArgs& a, int64_t ch,
                              int64_t p) {
    cp_async<8>(dst, at(a, ch, p));
  }
};

// Rows: series 2 ch (x) and 2 ch + 1 (y), nsamp int32 words each.
struct PfbRows {
  __device__ static const int* at(const PfbArgs& a, int64_t ch, int64_t p) {
    return static_cast<const int*>(a.x) + 2 * ch * a.nsamp + p;
  }
  __device__ static int2 load(const PfbArgs& a, int64_t ch, int64_t p) {
    const int* px = at(a, ch, p);
    return make_int2(__ldg(px), __ldg(px + a.nsamp));
  }
  __device__ static void copy(int2* dst, const PfbArgs& a, int64_t ch,
                              int64_t p) {
    const int* px = at(a, ch, p);
    cp_async<4>(&dst->x, px);
    cp_async<4>(&dst->y, px + a.nsamp);
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

// The same sample into *dst as copies that land when the thread's group is
// waited for (a zero at once).
template <class L>
__device__ __forceinline__ void copy_pair(int2* dst, const PfbArgs& a,
                                          int64_t ch, int64_t p) {
  if (p >= 0 && p < a.nblk * a.nfft) {
    L::copy(dst, a, ch, p);
  } else if (p < 0 && a.hist != nullptr) {
    const int* h = a.hist + 2 * ch * a.halo + a.halo + p;
    cp_async<4>(&dst->x, h);
    cp_async<4>(&dst->y, h + a.halo);
  } else {
    *dst = make_int2(0, 0);
  }
}

// Copies of pairs i < n from sample p on into the ring, pair i to ring row
// (row0 + i / nfft) % R, row0 < R. They stay in flight without unrolling
// the loop, which would cost registers.
template <class L>
__device__ __forceinline__ void copy_run(int2* ring, const PfbArgs& a,
                                         int64_t ch, int64_t p, int n,
                                         int row0) {
#pragma unroll 1
  for (int i = threadIdx.x; i < n; i += kPfbThreads) {
    int row = row0 + (i >> a.log2n);
    row -= row >= a.rows ? a.rows : 0;
    copy_pair<L>(ring + row * a.nfft + (i & (a.nfft - 1)), a, ch, p + i);
  }
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

// Rows of the sample ring with depth stages: the ntap - 1 before a step's
// first window and depth steps of W.
__host__ __device__ constexpr int ring_rows(int depth, int w, int ntap) {
  return ntap - 1 + depth * w;
}

// Shared-memory reduction slots: only where threads share a bin.
__host__ __device__ constexpr int red_slots(int nfft, int ns) {
  return nfft < kPfbThreads ? kPfbThreads * ns : 0;
}

// Shared memory of one block, in bytes, and its carve-up (all 8-byte units
// but the coefficients, last).
inline size_t pfb_smem(int depth, int sp, int nfft, int ntap, int ns) {
  return sizeof(int2) * ring_rows(depth, sp / nfft, ntap) * nfft +
         sizeof(float2) * 2 * sp + sizeof(double) * red_slots(nfft, ns) +
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
  double* red = reinterpret_cast<double*>(buf + 2 * sp);     // red_slots
  float2* tw = reinterpret_cast<float2*>(red + red_slots(nfft, ns));  // nfft
  float2* twm = tw + nfft;                                   // kM / 2
  float2* tws = twm + kMaxNfft / 64;                         // 5 x 32
  float* coef = reinterpret_cast<float*>(tws + 5 * 32);      // ntap x nfft

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = kM > 1 ? 32 : nfft;           // lanes per FFT
  const int lp = a.log2n - log2i(kM);         // log2(P)
  const int G = 32 >> lp;                     // FFTs side by side per warp
  const int p = lane & (P - 1);
  // the wide kernels copy their samples (step 1) and take the FFT's P-point
  // lane factor as a transpose and a kM-point register FFT, then kL = 32 /
  // kM lanes a column (step 2); the others load, and span all P lanes
  constexpr bool kWide = kM >= kWideM;
  constexpr int kL = kWide ? 32 / kM : 1;
  const int span = kWide ? kL : P;            // lanes the shuffle stages span
  const int64_t ch = blockIdx.x % a.nchan;
  const int64_t tile = blockIdx.x / a.nchan;
  const int64_t g = tile / a.nsub;
  const int64_t e0 = g * a.wpg + tile % a.nsub * a.ts;
  const int64_t e_end = min(e0 + a.ts, (g + 1) * a.wpg);
  const int64_t first = a.hist != nullptr ? 0 : a.ntap - 1;

  // ring row r % R holds samples p0 + r nfft ..; the first ntap - 1 rows are
  // the ones before the tile's first window end slot. Step s stages rows
  // ntap - 1 + s W ... The wide kernels copy (plan_pfb): the halo and, with
  // two stages, step 0 go first, so that the set-up below runs while they
  // are in flight. The others load, after the set-up.
  const int64_t p0 = (e0 - a.ntap + 1) * nfft;
  if constexpr (kWide) {
    copy_run<L>(ring, a, ch, p0, static_cast<int>(a.halo), 0);
    if (a.depth == 2) copy_run<L>(ring, a, ch, p0 + a.halo, sp, a.ntap - 1);
    cp_async_commit();
  }

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
  if constexpr (!kWide) {
    for (int64_t q = tid; q < a.halo; q += kPfbThreads) {
      ring[q] = load_pair<L>(a, ch, p0 + q);
    }
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
    // 1. the rows of step st + depth - 1 into those that step st - 1's FIR
    // read last (every warp left them at its barrier after the FFTs); with
    // copies, then wait for step st's rows: with two stages the copies of
    // step st + 1 stay in flight through this step's FFTs
    if constexpr (kWide) {
      if (st + a.depth - 1 < nsteps) {
        const int row0 = base + a.ntap - 1 + (a.depth - 1) * W;
        copy_run<L>(ring, a, ch, p0 + a.halo + (st + a.depth - 1) * sp, sp,
                    row0 - (row0 >= R ? R : 0));
      }
      cp_async_commit();
      if (a.depth == 2) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      const int64_t qbase = a.halo + st * sp;
      for (int i = tid; i < sp; i += kPfbThreads) {
        int row = base + a.ntap - 1 + (i >> a.log2n);
        row -= row >= R ? R : 0;
        ring[row * nfft + (i & (nfft - 1))] =
            load_pair<L>(a, ch, p0 + qbase + i);
      }
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
      float2* slot = buf + pol * sp + j * nfft;
      if constexpr (kWide) {
        // lane p's register r (point k1 = brev(r) of its 32-point column)
        // to row r, at p ^ (r kL): conflict-free, as is lane q = c kL + l
        // taking points p = l + kL i of row c into register i
#pragma unroll
        for (int r = 0; r < kM; ++r) slot[r * 32 + (p ^ (r * kL))] = v[r];
        __syncwarp();
        const int c = lane / kL, l = lane % kL;
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          v[i] = slot[c * 32 + ((l + kL * i) ^ (c * kL))];
        }
        __syncwarp();
        register_fft<kM>(v, twm);
        if constexpr (kL > 1) {   // W_32^(l k) = W_nfft^(kM l k)
#pragma unroll
          for (int i = 1; i < kM; ++i) {
            v[i] = cmul(v[i], tw[bit_reverse(i, log2i(kM)) * 32 + kM * l]);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const int h = 16 >> s;
        if (h >= span) continue;
        const float2 w = tws[s * 32 + p];
        const float sg = p & h ? -1.0f : 1.0f;
#pragma unroll
        for (int i = 0; i < kM; ++i) {
          const float2 o = make_float2(__shfl_xor_sync(0xffffffffu, v[i].x, h),
                                       __shfl_xor_sync(0xffffffffu, v[i].y, h));
          v[i] = cmul(make_float2(o.x + sg * v[i].x, o.y + sg * v[i].y), w);
        }
      }
      float2* out = slot + p;
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

  // position i P + p holds bin brev_m(i) + m brev_P(p); after a transpose,
  // position i 32 + q, q = c kL + l, bin brev_m(c) + m (brev_m(i) + m
  // brev_kL(l))
  const auto bin = [&](int pos) {
    if constexpr (kWide) {
      const int q = pos & 31;
      return bit_reverse(q / kL, log2i(kM)) +
             kM * (bit_reverse(pos >> 5, log2i(kM)) +
                   kM * bit_reverse(q % kL, log2i(kL)));
    } else {
      return bit_reverse(pos >> lp, log2i(kM)) +
             kM * bit_reverse(pos & (P - 1), lp);
    }
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
// spilled some instantiations to keep to 64 or 128 registers. At nfft 512
// (kM = 16) a minimum of two, which shared memory allows: uncapped, the
// transposed FFT took 131 registers in Stokes, one block an SM, and ran
// 8-16% slower than the lane stages (PERF.md); capped, 103-113, no spill.
template <class L, bool kStokes, int kM>
__global__ void __launch_bounds__(kPfbThreads) pfb_kernel(PfbArgs a) {
  pfb_body<L, kStokes, kM>(a);
}
template <class L, bool kStokes, int kM>
__global__ void __launch_bounds__(kPfbThreads, kM == 16 ? 2 : 1)
    pfb_kernel_wide(PfbArgs a) {
  pfb_body<L, kStokes, kM>(a);
}

using PfbKernel = void (*)(PfbArgs);

// The stages of the sample ring (a.depth, a.rows) and the block's shared
// memory. The wide kernels (nfft >= 256: one or two blocks an SM, so only
// the block's own FFTs can hide its loads) take two stages, a step's FFTs
// running while the next step's samples are copied, where they fit and
// leave an SM as many blocks as one stage does; else one: a step's samples
// are copied before its FFTs (at nfft 512 ntap 8 two stages would leave
// one block an SM instead of two, and ran 16-24% slower, PERF.md). The
// occupancy API answers once per kernel, device and ntap. At nfft <= 128
// four or five blocks an SM hide the loads' latency: one stage, loaded
// (copies at one or two stages ran up to 4% slower there, PERF.md).
template <class L, bool kStokes, int kM>
cudaError_t plan_pfb(PfbArgs& a, PfbKernel kernel, size_t* smem) {
  constexpr int ns = kStokes ? 4 : 1;
  const size_t one = pfb_smem(1, a.sp, a.nfft, a.ntap, ns);
  const size_t two = pfb_smem(2, a.sp, a.nfft, a.ntap, ns);
  if (one > kMaxSmem) return cudaErrorInvalidValue;
  a.depth = 1;
  if (kM >= kWideM && two <= kMaxSmem) {
    static std::atomic<int> found[kMaxDevices][kMaxNtap + 1];   // 0: not yet
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    std::atomic<int>* known = dev < kMaxDevices ? &found[dev][a.ntap] : nullptr;
    a.depth = known != nullptr ? known->load() : 0;
    if (a.depth == 0) {
      int blocks1 = 0, blocks2 = 0;
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(two));
      if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks1, kernel,
                                                          kPfbThreads, one);
      }
      if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks2, kernel,
                                                          kPfbThreads, two);
      }
      if (e != cudaSuccess) return e;
      a.depth = blocks2 >= blocks1 ? 2 : 1;
      if (known != nullptr) known->store(a.depth);
    }
  }
  a.rows = ring_rows(a.depth, a.w, a.ntap);
  *smem = a.depth == 2 ? two : one;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

// *depth: the stages of a launch made; *lanes: the cross-lane shuffle
// stages of its FFTs.
template <class L, bool kStokes, int kM>
int launch_pfb_m(PfbArgs& a, int64_t nblocks, cudaStream_t stream,
                 int* depth, int* lanes) {
  PfbKernel kernel;
  if constexpr (kM >= kWideM) {
    kernel = pfb_kernel_wide<L, kStokes, kM>;
  } else {
    kernel = pfb_kernel<L, kStokes, kM>;
  }
  size_t smem;
  cudaError_t e = plan_pfb<L, kStokes, kM>(a, kernel, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(nblocks), kPfbThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e == cudaSuccess) {
    *depth = a.depth;
    *lanes = kM >= kWideM ? log2i(32 / kM) : a.log2n - log2i(kM);
  }
  return static_cast<int>(e);
}

// the instantiation of nfft's points per lane, max(nfft / 32, 1); rows
// take nfft 128-1024 only (the JAX package's rows rule)
template <class L, bool kStokes>
int launch_pfb(PfbArgs& a, int64_t nblocks, cudaStream_t stream,
               int* depth, int* lanes) {
  constexpr bool wire = std::is_same<L, PfbWire>::value;
  switch (a.nfft >> 5) {
    case 0:
    case 1:
      if constexpr (wire) {
        return launch_pfb_m<L, kStokes, 1>(a, nblocks, stream, depth, lanes);
      }
      break;
    case 2:
      if constexpr (wire) {
        return launch_pfb_m<L, kStokes, 2>(a, nblocks, stream, depth, lanes);
      }
      break;
    case 4:
      return launch_pfb_m<L, kStokes, 4>(a, nblocks, stream, depth, lanes);
    case 8:
      return launch_pfb_m<L, kStokes, 8>(a, nblocks, stream, depth, lanes);
    case 16:
      return launch_pfb_m<L, kStokes, 16>(a, nblocks, stream, depth, lanes);
    default:
      return launch_pfb_m<L, kStokes, 32>(a, nblocks, stream, depth, lanes);
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
// spectrum. *depth: the stages of the sample ring the launch took, 2 (a
// step's samples copied during the step before) or 1 (before its FFTs).
// *lanes: the cross-lane shuffle stages of the launch's FFTs (0 where a
// transpose in shared memory takes the lane factor).
int pafb2p_pfb(const void* x, int rows, int64_t ndf, int64_t nchk,
               int64_t nfft, int64_t ntap, int64_t nout, int stokes,
               const void* coeffs, const void* hist, int64_t ts, int64_t nsub,
               void* partial, void* stream, int* depth, int* lanes) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (nfft < 2 || nfft > kMaxNfft || (nfft & (nfft - 1)) || ntap < 1 ||
      ntap > kMaxNtap || ndf <= 0 || nchk <= 0 || nout <= 0) {
    return static_cast<int>(bad);
  }
  PfbArgs a{};
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
  const int64_t nblocks = nout * nsub * a.nchan;
  if (nblocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows) {
    return stokes ? launch_pfb<PfbRows, true>(a, nblocks, s, depth, lanes)
                  : launch_pfb<PfbRows, false>(a, nblocks, s, depth, lanes);
  }
  return stokes ? launch_pfb<PfbWire, true>(a, nblocks, s, depth, lanes)
                : launch_pfb<PfbWire, false>(a, nblocks, s, depth, lanes);
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
