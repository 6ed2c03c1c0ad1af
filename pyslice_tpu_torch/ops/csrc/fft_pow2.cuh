// The power-of-two FFT engine in shared memory: kernel C (fused_step.cu)
// and the resident slice loop's radix-16 instantiation K6 (resident.cu,
// through tiles.cuh). A, B and K7 keep their transforms in registers
// (fft_regs.cuh) and take only this header's complex helpers and row
// modes.
//
// Each 1-D transform is an in-place FFT in shared memory, run as passes of
// up to four radix-2 stages held in registers (radix 16: a 1024-point
// transform is three passes and barriers): the forward is decimation in
// frequency (natural in, bit-reversed out) and the inverse decimation in
// time (bit-reversed in, natural out). A tile holds 2^logc columns side by
// side, element (i, c) at s[(pad(i) << logc) + c]; rows are padded by one
// slot every 32, so the passes' strided accesses spread over the banks.
// Twiddles exp(-2 pi i m / n), m < n/2, are computed in float64 on the host
// and read as float32 from device memory.

#pragma once

#include <cuda_runtime.h>

namespace {

enum RowMode { kFirst = 0, kMid = 1, kLast = 2, kOnly = 3 };

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

__device__ __forceinline__ float2 cscale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

__device__ __forceinline__ int bit_reverse(int i, int logn) {
  return logn == 0 ? 0 : (int)(__brev((unsigned)i) >> (32 - logn));
}

// Shared-memory slot of tile row i: one pad slot every 32 rows, so the
// strided accesses of the register passes below do not pile onto one bank.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Up to kMaxLogRadix consecutive radix-2 stages in registers. Work item b
// (column c = b mod 2^logc, group g) holds the R = 2^LR tile rows
// e0 + j*2^lo, j < R, runs stages lo .. lo+LR-1 on them (largest first for
// the forward, DIF; smallest first for the inverse, DIT) and writes them
// back in place: one shared-memory round trip for LR stages. Stage st pairs
// rows i and i + 2^st; its twiddle is tw[(i mod 2^st) << (logn-1-st)],
// conjugated for the inverse. The caller syncs between passes.
template <int LR, bool kInverse>
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
      const int t = kInverse ? tt : LR - 1 - tt;
      const int st = lo + t;
      const int hl = 1 << t;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j & hl) continue;
        const float2 w =
            __ldg(&tw[(k + ((j & (hl - 1)) << lo)) << (logn - 1 - st)]);
        const float2 a = v[j];
        const float2 u = v[j + hl];
        if (kInverse) {
          const float2 uw = cmul_conj(u, w);
          v[j] = cadd(a, uw);
          v[j + hl] = csub(a, uw);
        } else {
          v[j] = cadd(a, u);
          v[j + hl] = cmul(csub(a, u), w);
        }
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
template <int LRMAX, bool kInverse>
__device__ __forceinline__ void fft_pass_lr(int lr, float2* s, int logn,
                                            int logc, int lo,
                                            const float2* __restrict__ tw,
                                            int tid, int nthreads) {
  if (lr == LRMAX) {
    fft_pass<LRMAX, kInverse>(s, logn, logc, lo, tw, tid, nthreads);
  } else if constexpr (LRMAX > 1) {
    fft_pass_lr<LRMAX - 1, kInverse>(lr, s, logn, logc, lo, tw, tid,
                                     nthreads);
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
    fft_pass_lr<kMaxLogRadix, false>(lr, s, logn, logc, hi - lr + 1, tw,
                                     tid, nthreads);
    __syncthreads();
  }
}

// Inverse FFT (unnormalized) on the same tile layout: bit-reversed order
// in, natural out (decimation in time). Ends with __syncthreads().
__device__ void ifft_dit(float2* s, int logn, int logc,
                         const float2* __restrict__ tw, int tid,
                         int nthreads) {
  for (int lo = 0; lo < logn; lo += kMaxLogRadix) {
    const int lr = logn - lo < kMaxLogRadix ? logn - lo : kMaxLogRadix;
    fft_pass_lr<kMaxLogRadix, true>(lr, s, logn, logc, lo, tw, tid,
                                    nthreads);
    __syncthreads();
  }
}

// The engine as the tile functions of tiles.cuh see it: slot row of
// element i, slot row of frequency k after the forward (bit-reversed), and
// the two transforms, in place (the second buffer is not used). Host side:
// the buffers a tile needs and the slot rows of each (pad slots included).
struct Pow2Eng {
  static constexpr int kBuffers = 1;
  static int slot_rows(int n) { return n + (n >> 5); }
  const float2* tw;   // exp(-2 pi i m / n), m < n/2
  int n;
  int logn;
  __device__ __forceinline__ int row(int i) const { return pad(i); }
  __device__ __forceinline__ int kslot(int k) const {
    return bit_reverse(k, logn);
  }
  __device__ __forceinline__ float2* fwd(float2* a, float2*, int logc,
                                         int tid, int nt) const {
    fft_dif(a, logn, logc, tw, tid, nt);
    return a;
  }
  __device__ __forceinline__ float2* inv(float2* a, float2*, int logc,
                                         int tid, int nt) const {
    ifft_dit(a, logn, logc, tw, tid, nt);
    return a;
  }
};

inline int ilog2(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace
