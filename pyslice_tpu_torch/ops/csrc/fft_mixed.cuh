// The mixed-radix Stockham FFT for an axis of any length n <= 4096 on
// grids that are not powers of two: its plan (the stage radices) and its
// large-prime stage sk_generic. The persistent passes K4, K5, K8 and the
// mixed-radix K6 (tile_async.cuh) run their other stages with tile_pass.
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
// to 31 the item's R values sit in registers (tile_pass): a radix-2
// network for powers of two, and for odd R the symmetric form that pairs
// x_r with x_(R-r), a quarter of a direct product's multiplies. A larger
// prime p takes sk_generic, which computes each output on its own, a
// direct sum of p terms (p^2 work per point group). Measured on an H100
// (700 W) at 16 x 1023^2 = 3 * 11 * 31 (PERF.md): the symmetric radix-31
// pass in registers took a row pass from 1.37 to 0.51 ms against the
// direct sum; a direct product in registers for 17..31 spills and loses;
// a recurrence for the direct sum's twiddles serialises the sum and loses
// to the table reads.
//
// A tile holds 2^logc columns side by side, element (i, c) at
// s[(i << logc) + c]. W = exp(-2 pi i / n) comes from a table of all n
// powers computed in float64 on the host; the inverse conjugates it and is
// unnormalized.

#pragma once

#include <cuda_runtime.h>

#include "complex.cuh"

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

// An axis's engine: its twiddle table (exp(-2 pi i m / n), m < n), plan
// and length.
struct MixedEng {
  const float2* tw;
  MixedPlan plan;
  int n;
};

inline MixedEng mixed_eng(const void* tw, int n) {
  return MixedEng{(const float2*)tw, make_plan(n), n};
}

}  // namespace
