// The power-of-two FFT engine in shared memory of kernel C (fused_step.cu)
// alone. A, B, K7 and K6's power-of-two instantiation keep their
// transforms in registers (fft_regs.cuh).
//
// C's forward is an in-place FFT in shared memory, run as passes of up to
// four radix-2 stages held in registers (radix 16: a 1024-point transform
// is three passes and barriers), decimation in frequency (natural in,
// bit-reversed out). A tile holds 2^logc columns side by side, element
// (i, c) at s[(pad(i) << logc) + c]; rows are padded by one slot every 32,
// so the passes' strided accesses spread over the banks. Twiddles
// exp(-2 pi i m / n), m < n/2, are computed in float64 on the host and
// read as float32 from device memory.

#pragma once

#include "complex.cuh"

namespace {

__device__ __forceinline__ int bit_reverse(int i, int logn) {
  return logn == 0 ? 0 : (int)(__brev((unsigned)i) >> (32 - logn));
}

// Shared-memory slot of tile row i: one pad slot every 32 rows, so the
// strided accesses of the register passes below do not pile onto one bank.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Up to kMaxLogRadix consecutive radix-2 stages in registers. Work item b
// (column c = b mod 2^logc, group g) holds the R = 2^LR tile rows
// e0 + j*2^lo, j < R, runs stages lo + LR - 1 down to lo on them (DIF) and
// writes them back in place: one shared-memory round trip for LR stages.
// Stage st pairs rows i and i + 2^st; its twiddle is
// tw[(i mod 2^st) << (logn-1-st)]. The caller syncs between passes.
template <int LR>
__device__ __forceinline__ void fft_pass(float2* s, int logn, int logc,
                                         int lo,
                                         const float2* __restrict__ tw,
                                         int tid, int nthreads) {
  constexpr int R = 1 << LR;
  const int cmask = (1 << logc) - 1;
  const int items = 1 << (logn - LR + logc);
  for (int b = tid; b < items; b += nthreads) {
    const int c = b & cmask;
    const int g = b >> logc;
    const int k = g & ((1 << lo) - 1);
    const int e0 = ((g >> lo) << (lo + LR)) + k;
    float2 v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = s[(pad(e0 + (j << lo)) << logc) + c];
#pragma unroll
    for (int tt = 0; tt < LR; ++tt) {
      const int t = LR - 1 - tt;
      const int st = lo + t;
      const int hl = 1 << t;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j & hl) continue;
        const float2 w =
            __ldg(&tw[(k + ((j & (hl - 1)) << lo)) << (logn - 1 - st)]);
        const float2 a = v[j];
        const float2 u = v[j + hl];
        v[j] = cadd(a, u);
        v[j + hl] = cmul(csub(a, u), w);
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) s[(pad(e0 + (j << lo)) << logc) + c] = v[j];
  }
}

// Radix 16 (a 1024-point transform is three passes). Measured on an H100
// at 16 x 1024^2, radix 16 beat radix 8 and radix 32 for the first A + B,
// which ran this engine: radix 32 needs ~160 registers a thread, which
// leaves one column block per SM.
constexpr int kMaxLogRadix = 4;

// fft_pass<lr> for a run-time lr <= LRMAX; only radices up to LRMAX are
// compiled, so the largest one sets the kernels' register count.
template <int LRMAX>
__device__ __forceinline__ void fft_pass_lr(int lr, float2* s, int logn,
                                            int logc, int lo,
                                            const float2* __restrict__ tw,
                                            int tid, int nthreads) {
  if (lr == LRMAX) {
    fft_pass<LRMAX>(s, logn, logc, lo, tw, tid, nthreads);
  } else if constexpr (LRMAX > 1) {
    fft_pass_lr<LRMAX - 1>(lr, s, logn, logc, lo, tw, tid, nthreads);
  }
}

// Forward FFT along the rows of a (n, 2^logc) tile in shared memory,
// element (i, c) at s[(pad(i) << logc) + c]: natural order in, bit-reversed
// out (decimation in frequency). Ends with __syncthreads(); the caller
// syncs before it.
__device__ void fft_dif(float2* s, int logn, int logc,
                        const float2* __restrict__ tw, int tid,
                        int nthreads) {
  for (int hi = logn - 1; hi >= 0; hi -= kMaxLogRadix) {
    const int lr = hi + 1 < kMaxLogRadix ? hi + 1 : kMaxLogRadix;
    fft_pass_lr<kMaxLogRadix>(lr, s, logn, logc, hi - lr + 1, tw, tid,
                              nthreads);
    __syncthreads();
  }
}

inline int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace
