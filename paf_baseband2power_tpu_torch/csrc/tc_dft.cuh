// A 128-point complex DFT of a tile of 64 rows on Hopper's tensor cores, as
// three real products in split precision (3xBF16), shared by the probe
// kernels K12 (csrc/probe_planes.cu) and K13 (csrc/probe_karatsuba.cu).
//
// With C + iD = exp(-2 pi i n k / 128) (C, C + D, C - D: the matrices of
// probes/_common.py:dft_matrices, [n][k]) the DFT of rows A + iB takes
// three real products instead of four:
//   T = (A + B) C,   RE = T - B (C + D),   IM = T - A (C - D).
// Input: the tile in shared memory, kRows rows of 128 values of each of A,
// B and S = A + B, each split into bf16 hi and lo (store_pair, from fp32),
// two values to a word (tile_index). The kernels' FIR or stage A writes
// it, so a value is split once and not again by each of the four warps
// that read its row. dft_tile leaves T, P = B (C + D) and Q = A (C - D) of
// a warp's part of the tile in fp32 registers; the caller forms RE = T - P,
// IM = T - Q.
//
// Instruction: mma.sync.aligned.m16n8k16 (bf16 in, fp32 accumulate), not
// wgmma. wgmma reads its B operand from shared memory in its own swizzled
// layout, so the DFT's signs (below) could not be applied in registers and
// the whole matrices would have to be stored; mma.sync takes fragments
// from registers. It reaches a lower share of the tensor cores' peak than
// wgmma; it is the simpler kernel.
//
// Precision: 3xBF16, the JAX probes' own split. Each fp32 operand x is split
// as hi = bf16(x), lo = bf16(x - hi) (cvt.rn.bf16x2.f32, round to nearest
// even, two values an instruction) and x y ~ hi_x lo_y + lo_x hi_y + hi_x
// hi_y; the lo x lo term, ~2^-16 relative, is dropped. The probes' bound is
// 2e-5 peak-normalized against float64 (probes/_common.py:PARITY_BOUND).
// The kernels' arithmetic emulated on the CPU (probes/_common.py:
// split_dft_power, tests/test_torch_probes.py) reads 2.4e-6 to 4.3e-6 for
// 3xBF16 at the probes' check sizes, 4.6x inside the bound; plain TF32
// reads 2.0e-4 to 3.2e-4, 10-16x over it; 3xTF32 about 1e-7. The emulation
// sums the products in float64: it models neither the fp32 accumulators
// nor the tensor cores' own summation. On the card (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py phase 7, probes/probe_compare.py) the kernels read
// up to 9.42e-6 (K12 at 8192 x 48) and 5.07e-6 (28 x 128), 2.1x inside
// the bound: about twice the emulation's error. 3xBF16 is
// taken for speed: an m16n8k16 bf16 mma.sync covers twice the K of the
// m16n8k8 tf32 one, and the split costs one cvt for two values where
// cvt.rna.tf32.f32 takes four instructions for one (PERF.md has the two
// builds' times on the card).
//
// Shared memory: the three matrices split into hi and lo would take 3 x 2 x
// 32 KB = 192 KB. The DFT's symmetry needs only the quadrant n, k < 64:
// W[n + 64][k] = (-1)^k W[n][k] and W[n][k + 64] = (-1)^n W[n][k]. The
// quadrant of each matrix, hi and lo, in mma fragment order is 3 x 4
// k-steps x 8 column tiles x 32 lanes x 16 B = 48 KB (kTableBytes), loaded
// by load_tables. (-1)^n for the columns k >= 64 is an XOR of the sign of
// the upper value of each data word (n odd). (-1)^k for the rows n >= 64
// follows the accumulators: an accumulator's column has the parity of r, so
// the odd columns are negated before and after the second half of n. The
// kernels form the quadrant themselves (dft_entry), so no matrix is read
// from global memory and none other than the DFT can be passed. The tile
// takes 6 x 16 KB = 96 KB (kTileBytes), unpadded:
// tile_index swizzles the word by the row so that a fragment load, 8 rows x
// 4 words, meets 32 distinct banks.
//
// Work: 8 warps (kThreads), 2 along the rows x 4 along the columns; a warp
// owns 32 rows (kMT = 2 m-tiles of 16) x 32 columns (kNT = 4 n-tiles of 8):
// 3 x 2 x 4 x 4 = 96 fp32 accumulators a thread. Per k-step of 16 it loads
// 2 x 4 x 6 data words and 12 matrix fragments (16 bytes each, hi and lo
// together) for 72 mma.sync, the 24 of each term of 3xBF16 in a row.
//
// Accumulator r of (mt, nt) in a thread holds row 32 warp_m + 16 mt + g +
// 8 (r >> 1), column 32 warp_n + 8 nt + 2 t + (r & 1) (acc_col).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tcdft {

constexpr int kL = 128;                 // points of the DFT
constexpr int kRows = 64;               // rows of a tile
constexpr int kThreads = 256;           // 8 warps: 2 (rows) x 4 (columns)
constexpr int kMT = 2;                  // m-tiles of 16 rows per warp
constexpr int kNT = 4;                  // n-tiles of 8 columns per warp
constexpr int kTableFloat4 = 3 * 4 * 8 * 32;
constexpr int kTableBytes = kTableFloat4 * 16;          // 49,152
// the tile: each of A, B and S = A + B split into bf16 hi and lo, a row's
// 128 values as 64 bf16x2 words (values n and n + 1 in word n / 2)
constexpr int kWords = kL / 2;
constexpr int kPartWords = kRows * kWords;
constexpr int kTileBytes = 6 * kPartWords * 4;           // 98,304
enum Part { kAHi = 0, kALo, kBHi, kBLo, kSHi, kSLo };

struct Acc {
  float t[kMT][kNT][4];     // (A + B) C
  float p[kMT][kNT][4];     // B (C + D)
  float q[kMT][kNT][4];     // A (C - D)
};

// where word c (values 2c, 2c + 1) of a row of a part is stored: the word
// is swizzled by the row so that a fragment load, 8 rows x 4 words, meets
// 32 distinct banks
__device__ __forceinline__ int tile_index(int part, int row, int c) {
  return part * kPartWords + row * kWords + (c ^ ((row & 7) << 2));
}

__device__ __forceinline__ int acc_col(int warp_n, int lane, int nt, int r) {
  return 32 * warp_n + 8 * nt + 2 * (lane % 4) + (r & 1);
}

// PTX wrappers
// {lo, hi} -> bf16x2, round to nearest even (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}

// d += a b for one 16 x 8 x 16 tile of bf16 (the PTX ISA's layout)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
// end of PTX wrappers

// Entry (n, k) of matrix mat (0: C, 1: C + D, 2: C - D), formed in float64
// and rounded to fp32, as probes/_common.py:dft_matrices forms it.
__device__ __forceinline__ float dft_entry(int mat, int n, int k) {
  double sn, cs;
  sincospi(-2.0 * ((n * k) % kL) / kL, &sn, &cs);
  return static_cast<float>(mat == 0 ? cs : mat == 1 ? cs + sn : cs - sn);
}

// hi and lo of x, each bf16 (round to nearest even), as fp32
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack_bf16x2(x0, x1);
  lo = pack_bf16x2(x0 - __uint_as_float(hi << 16),
                   x1 - __uint_as_float(hi & 0xffff0000u));
}

// tab[((mat * 4 + ks) * 8 + nt) * 32 + lane] = {hi b0, hi b1, lo b0, lo b1}
// of matrix mat, each bf16x2: b0 = M[16 ks + 2t, + 1][8 nt + g], b1 = M[16 ks
// + 2t + 8, + 9][8 nt + g]: the quadrant n, k < 64, formed by dft_entry.
// Every thread of the block takes part; the caller synchronises before the
// first dft_tile.
__device__ __forceinline__ void load_tables(float4* tab) {
  for (int i = threadIdx.x; i < kTableFloat4; i += blockDim.x) {
    const int lane = i % 32, nt = i / 32 % 8, ks = i / 256 % 4, mat = i / 1024;
    const int n = 16 * ks + 2 * (lane % 4), k = 8 * nt + lane / 4;
    float b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nj = n + (j & 1) + 8 * (j >> 1);
      b[j] = dft_entry(mat, nj, k);
    }
    uint32_t h0, l0, h1, l1;
    split2(b[0], b[1], h0, l0);
    split2(b[2], b[3], h1, l1);
    tab[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                         __uint_as_float(l0), __uint_as_float(l1));
  }
}

// an int32 word of two int16 lanes (low, high) as two floats
__device__ __forceinline__ float2 unpack_int16x2(int v) {
  return make_float2(static_cast<float>(static_cast<short>(v & 0xffff)),
                     static_cast<float>(v >> 16));
}

// One block of kThreads per SM walks the tiles (the DFT tables take 96 KB
// and fill it): the grid for ntiles tiles.
inline cudaError_t resident_grid(int64_t ntiles, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  *grid = static_cast<int>(ntiles < sms ? ntiles : sms);
  return e;
}

// word c of a row of the tile from values 2c, 2c + 1 of A (a) and B (b)
__device__ __forceinline__ void store_pair(uint32_t* tile, int row, int c,
                                           float2 a, float2 b) {
  uint32_t h[3], l[3];
  split2(a.x, a.y, h[0], l[0]);
  split2(b.x, b.y, h[1], l[1]);
  split2(a.x + b.x, a.y + b.y, h[2], l[2]);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    tile[tile_index(2 * q, row, c)] = h[q];
    tile[tile_index(2 * q + 1, row, c)] = l[q];
  }
}

// a fragment of 16 rows x 16 columns, split into bf16x2 hi and lo
struct Split {
  uint32_t hi[4], lo[4];
};

// term 0, 1, 2 of d += x m in 3xBF16: hi_x lo_m, lo_x hi_m, hi_x hi_m, of
// m's fragment f = {hi b0, hi b1, lo b0, lo b1}
__device__ __forceinline__ void mma_term(float (&d)[4], const Split& x,
                                         const float4& f, int term) {
  if (term == 0) {
    mma_bf16(d, x.hi, __float_as_uint(f.z), __float_as_uint(f.w));
  } else if (term == 1) {
    mma_bf16(d, x.lo, __float_as_uint(f.x), __float_as_uint(f.y));
  } else {
    mma_bf16(d, x.hi, __float_as_uint(f.x), __float_as_uint(f.y));
  }
}

// acc = -acc in the odd columns (r = 1, 3) of every accumulator
__device__ __forceinline__ void negate_odd_columns(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int r = 1; r < 4; r += 2) {
        acc.t[mt][nt][r] = -acc.t[mt][nt][r];
        acc.p[mt][nt][r] = -acc.p[mt][nt][r];
        acc.q[mt][nt][r] = -acc.q[mt][nt][r];
      }
    }
  }
}

// The warp's part of the tile's three products, from the tile of
// store_pair and the tables of load_tables.
__device__ __forceinline__ void dft_tile(const uint32_t* tile,
                                         const float4* tab, int warp_m,
                                         int warp_n, Acc& acc) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc.t[mt][nt][r] = acc.p[mt][nt][r] = acc.q[mt][nt][r] = 0.0f;
      }
    }
  }
  // columns k >= 64: (-1)^n on the data, the odd n of each word
  const uint32_t dsign = warp_n >= 2 ? 0x80000000u : 0u;
  const float4* wtab = tab + (warp_n % 2) * kNT * 32 + lane;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    // rows n >= 64 weigh column k by (-1)^k, and in an accumulator the
    // column's parity is r's: the odd columns are negated around the
    // second half, whose products then add with the quadrant's own signs
    if (half) negate_odd_columns(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int c = 32 * half + 8 * ks + t;
      Split xa[kMT], xb[kMT], xs[kMT];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int row = 32 * warp_m + 16 * mt + g;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = tile_index(0, row + 8 * (r & 1), c + 4 * (r >> 1));
          xa[mt].hi[r] = tile[i + kAHi * kPartWords] ^ dsign;
          xa[mt].lo[r] = tile[i + kALo * kPartWords] ^ dsign;
          xb[mt].hi[r] = tile[i + kBHi * kPartWords] ^ dsign;
          xb[mt].lo[r] = tile[i + kBLo * kPartWords] ^ dsign;
          xs[mt].hi[r] = tile[i + kSHi * kPartWords] ^ dsign;
          xs[mt].lo[r] = tile[i + kSLo * kPartWords] ^ dsign;
        }
      }
      float4 f[kNT][3];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int mat = 0; mat < 3; ++mat) {
          f[nt][mat] = wtab[(mat * 4 + ks) * 8 * 32 + nt * 32];
        }
      }
      // the three terms, smallest first; a term's 24 products are
      // independent, so a product waits on its accumulator 24 apart
#pragma unroll
      for (int term = 0; term < 3; ++term) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_term(acc.t[mt][nt], xs[mt], f[nt][0], term);
            mma_term(acc.p[mt][nt], xb[mt], f[nt][1], term);
            mma_term(acc.q[mt][nt], xa[mt], f[nt][2], term);
          }
        }
      }
    }
  }
  negate_odd_columns(acc);
}

}  // namespace tcdft
