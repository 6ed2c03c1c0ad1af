// The mixed-radix FFT engine in shared memory, for an axis of any length
// n <= 4096, on grids that are not powers of two: the resident slice loop
// K6 (resident.cu) runs it whole; the persistent passes K4, K5 and K8
// (tile_async.cuh) take its plan and its large-prime stage sk_generic and
// run their other stages with tile_pass.
//
// Order: Stockham autosort. Every stage reads one shared-memory buffer and
// writes the other, so the transform takes natural order in and gives
// natural order out, at twice the shared memory of an in-place transform.
// No digit reversal is needed anywhere: the Fresnel plane is read at its
// natural kx row, and the k-space store is a plain fftshift.
//
// Stages: n = R_1 R_2 ... R_k, radix 16 first, then 8/4/2, then the odd
// primes 31 down to 3, then any remaining prime p (e.g. 509 of
// 1018 = 2 * 509). A stage of radix R with Ns = R_1 ... R_{i-1} reads, for
// item j < n/R, x_r = in[j + r n/R] * W^(r k n/(Ns R)) with k = j mod Ns,
// takes the length-R DFT y_q = sum_r x_r W^(q r n/R), and writes y_q at
// out[(j / Ns) Ns R + k + q Ns]. For R = 2, 4, 8, 16 and the odd primes up
// to 31 the item's R values sit in registers (sk_pass): a radix-2 network
// for powers of two, and for odd R the symmetric form that pairs x_r with
// x_(R-r), a quarter of a direct product's multiplies. A larger prime p
// takes sk_generic, which computes each output on its own, a direct sum of
// p terms (p^2 work per point group). Measured on an H100 (700 W) at
// 16 x 1023^2 = 3 * 11 * 31 (PERF.md): the symmetric radix-31 pass in
// registers took a row pass from 1.37 to 0.51 ms against the direct sum; a
// direct product in registers for 17..31 spills and loses; a recurrence
// for the direct sum's twiddles serialises the sum and loses to the table
// reads.
//
// A tile holds 2^logc columns side by side, element (i, c) at
// s[(i << logc) + c]. W = exp(-2 pi i / n) comes from a table of all n
// powers computed in float64 on the host; the inverse conjugates it and is
// unnormalized.

#pragma once

#include <cuda_runtime.h>

#include "fft_pow2.cuh"

namespace {

constexpr int kMaxFactors = 12;   // 2^12 = 4096

struct MixedPlan {
  int n;
  int nf;
  int f[kMaxFactors];
};

// Host: the stage radices of n (see the note above). n >= 2.
inline MixedPlan make_plan(int n) {
  MixedPlan p{};
  p.n = n;
  int m = n;
  while (m % 16 == 0) { p.f[p.nf++] = 16; m /= 16; }
  for (int r : {8, 4, 2}) {
    if (m % r == 0) { p.f[p.nf++] = r; m /= r; }
  }
  for (int r : {31, 29, 23, 19, 17, 13, 11, 7, 5, 3}) {
    while (m % r == 0) { p.f[p.nf++] = r; m /= r; }
  }
  for (int r = 37; m > 1; r += 2) {
    while (m % r == 0) { p.f[p.nf++] = r; m /= r; }
  }
  return p;
}

template <bool kInv>
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw,
                                          int m) {
  const float2 w = __ldg(&tw[m]);
  return kInv ? make_float2(w.x, -w.y) : w;
}

// Bit reversal of q < R (R a power of two), folded at compile time in the
// unrolled loops below.
__host__ __device__ constexpr int brev(int q, int R) {
  int r = 0;
  for (int b = 1; b < R; b <<= 1) {
    r = (r << 1) | (q & 1);
    q >>= 1;
  }
  return r;
}

// One Stockham stage of radix R (R values of an item in registers). The
// stage twiddles W^(r k n/(Ns R)) are the powers of one table entry, taken
// by recurrence (at most 30 products, a few ulp). The R-point DFT is a
// radix-2 network for R = 2^m (DIF, its bit-reversed output read back in
// order at the store) and, for odd R, the symmetric form below; w holds
// the twiddles W^(m n/R), m <= R/2, that either reads.
template <int R, bool kInv>
__device__ void sk_pass(const float2* __restrict__ in,
                        float2* __restrict__ out, int n, int logc, int ns,
                        const float2* __restrict__ tw, int tid, int nt) {
  constexpr bool kPow2 = (R & (R - 1)) == 0;
  const int nr = n / R;
  const int stride = n / (ns * R);
  const int cmask = (1 << logc) - 1;
  const int items = nr << logc;
  constexpr int kW = (R + 1) / 2;    // the DFT twiddles either form reads
  float2 w[kW];
#pragma unroll
  for (int m = 0; m < kW; ++m) w[m] = twiddle<kInv>(tw, m * nr);
  for (int b = tid; b < items; b += nt) {
    const int c = b & cmask;
    const int j = b >> logc;
    const int k = j % ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = in[((j + r * nr) << logc) + c];
    if (k != 0) {
      const float2 wk = twiddle<kInv>(tw, k * stride);
      float2 wr = wk;
#pragma unroll
      for (int r = 1; r < R; ++r) {
        v[r] = cmul(v[r], wr);
        wr = cmul(wr, wk);
      }
    }
    const int base = (j - k) * R + k;
    if constexpr (kPow2) {
#pragma unroll
      for (int half = R / 2; half >= 1; half >>= 1) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (i & half) continue;
          const float2 x = v[i];
          const float2 y = v[i + half];
          v[i] = cadd(x, y);
          v[i + half] = cmul(csub(x, y), w[(i & (half - 1)) * (R / (2 * half))]);
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        out[((base + q * ns) << logc) + c] = v[brev(q, R)];
      }
    } else {
      // Odd R: pair v_r with v_(R-r). With a_r = v_r + v_(R-r),
      // b_r = v_r - v_(R-r), c_m = cos(2 pi m/R), s_m = sin(2 pi m/R):
      // y_q = A_q -/+ i B_q and y_(R-q) = A_q +/- i B_q (forward/inverse),
      // A_q = v_0 + sum_r a_r c_(qr), B_q = sum_r b_r s_(qr), r, q <= H.
      constexpr int H = (R - 1) / 2;
      float2 acc0 = v[0];
#pragma unroll
      for (int r = 1; r <= H; ++r) {
        const float2 x = v[r];
        const float2 y = v[R - r];
        v[r] = cadd(x, y);
        v[R - r] = csub(x, y);
        acc0 = cadd(acc0, v[r]);
      }
      out[(base << logc) + c] = acc0;
#pragma unroll
      for (int q = 1; q <= H; ++q) {
        float2 A = v[0];
        float2 B = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int r = 1; r <= H; ++r) {
          const int m = (q * r) % R;
          // w[m] = (c_m, -/+ s_m); c_(R-m) = c_m, s_(R-m) = -s_m
          const float cm = m <= H ? w[m].x : w[R - m].x;
          const float sm = m <= H ? -w[m].y : w[R - m].y;
          A.x += v[r].x * cm;
          A.y += v[r].y * cm;
          B.x += v[R - r].x * sm;
          B.y += v[R - r].y * sm;
        }
        out[((base + q * ns) << logc) + c] = make_float2(A.x + B.y, A.y - B.x);
        out[((base + (R - q) * ns) << logc) + c] =
            make_float2(A.x - B.y, A.y + B.x);
      }
    }
  }
}

// One Stockham stage of a generic prime radix p: each output on its own,
// a direct sum of p terms, every twiddle read from the table.
template <bool kInv>
__device__ void sk_generic(const float2* __restrict__ in,
                           float2* __restrict__ out, int n, int p, int logc,
                           int ns, const float2* __restrict__ tw, int tid,
                           int nt) {
  const int nr = n / p;
  const int stride = n / (ns * p);
  const int cmask = (1 << logc) - 1;
  const int items = n << logc;
  const int span = ns * p;
  for (int b = tid; b < items; b += nt) {
    const int c = b & cmask;
    const int o = b >> logc;
    const int blk = o / span;
    const int rem = o - blk * span;
    const int q = rem / ns;
    const int k = rem - q * ns;
    const int j = blk * ns + k;
    const int step = (k + q * ns) * stride;     // < n
    float2 acc = in[(j << logc) + c];
    int e = 0;
    for (int s = 1; s < p; ++s) {
      e += step;
      if (e >= n) e -= n;
      acc = cadd(acc, cmul(in[((j + s * nr) << logc) + c],
                           twiddle<kInv>(tw, e)));
    }
    out[(o << logc) + c] = acc;
  }
}

// The whole transform on the tile in `a`, using `b` as the second buffer;
// returns the buffer that holds the result. The caller syncs before it;
// it ends with __syncthreads().
template <bool kInv>
__device__ float2* stockham(float2* a, float2* b, const MixedPlan& pl,
                            int logc, const float2* __restrict__ tw, int tid,
                            int nt) {
  int ns = 1;
  for (int i = 0; i < pl.nf; ++i) {
    const int r = pl.f[i];
    switch (r) {
      case 2: sk_pass<2, kInv>(a, b, pl.n, logc, ns, tw, tid, nt); break;
      case 3: sk_pass<3, kInv>(a, b, pl.n, logc, ns, tw, tid, nt); break;
      case 4: sk_pass<4, kInv>(a, b, pl.n, logc, ns, tw, tid, nt); break;
      case 5: sk_pass<5, kInv>(a, b, pl.n, logc, ns, tw, tid, nt); break;
      case 7: sk_pass<7, kInv>(a, b, pl.n, logc, ns, tw, tid, nt); break;
      case 8: sk_pass<8, kInv>(a, b, pl.n, logc, ns, tw, tid, nt); break;
      case 16: sk_pass<16, kInv>(a, b, pl.n, logc, ns, tw, tid, nt); break;
      case 11: sk_pass<11, kInv>(a, b, pl.n, logc, ns, tw, tid, nt); break;
      case 13: sk_pass<13, kInv>(a, b, pl.n, logc, ns, tw, tid, nt); break;
      case 17: sk_pass<17, kInv>(a, b, pl.n, logc, ns, tw, tid, nt); break;
      case 19: sk_pass<19, kInv>(a, b, pl.n, logc, ns, tw, tid, nt); break;
      case 23: sk_pass<23, kInv>(a, b, pl.n, logc, ns, tw, tid, nt); break;
      case 29: sk_pass<29, kInv>(a, b, pl.n, logc, ns, tw, tid, nt); break;
      case 31: sk_pass<31, kInv>(a, b, pl.n, logc, ns, tw, tid, nt); break;
      default: sk_generic<kInv>(a, b, pl.n, r, logc, ns, tw, tid, nt);
    }
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
    ns *= r;
  }
  return a;
}

// The engine as the tile functions of tiles.cuh see it (natural order on
// both sides of each transform; two buffers, no pad slots).
struct MixedEng {
  static constexpr int kBuffers = 2;
  static int slot_rows(int n) { return n; }
  const float2* tw;   // exp(-2 pi i m / n), m < n
  MixedPlan plan;
  int n;
  __device__ __forceinline__ int row(int i) const { return i; }
  __device__ __forceinline__ int kslot(int k) const { return k; }
  __device__ __forceinline__ float2* fwd(float2* a, float2* b, int logc,
                                         int tid, int nt) const {
    return stockham<false>(a, b, plan, logc, tw, tid, nt);
  }
  __device__ __forceinline__ float2* inv(float2* a, float2* b, int logc,
                                         int tid, int nt) const {
    return stockham<true>(a, b, plan, logc, tw, tid, nt);
  }
};

inline MixedEng mixed_eng(const void* tw, int n) {
  return MixedEng{(const float2*)tw, make_plan(n), n};
}

}  // namespace
