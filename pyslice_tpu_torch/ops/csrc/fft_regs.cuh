// The register-resident FFT engine of kernels A and B (fused_step.cu), K7
// (fused_step_adjoint.cu) and K6's power-of-two instantiation
// (resident.cu): a power-of-two transform of n = 128 .. 4096 values on
// T = n / 32 threads, each holding 32 of them in registers from the load
// to the store.
//
// Thread t of a transform holds element t + T m of it in v[m], m < 32: the
// load, the store and the pass's products all read or write the wave
// directly at those elements (A: T neighbouring threads read a row's T
// neighbouring values; B: the tile's lanes, its columns, sit side by side
// within a warp). The transform is the Stockham stages of radix 32 and
// then the rest (1024: 32 x 32; 2048: 32 x 32 x 2; 4096: 32 x 32 x 4;
// 128, 256, 512: 32 x 4, 8, 16). A stage of radix R runs 32 / R
// butterflies a thread, j = t + b T, whose inputs x[j + q n/R] are already
// v[b + q 32/R]; its outputs go back to the same slots, so after the last
// stage v[m] again holds element t + T m, in natural order. Between two
// stages (one exchange for n <= 1024, two above) the values pass through
// shared memory: each thread writes its butterflies' outputs at their
// Stockham positions (j - k) R + k + p ns and reads its next inputs, with
// one barrier. So B's forward, its product and its inverse, and A's
// inverse, product and forward, run on values that never leave the
// registers between the two transforms, and a 1024-point transform costs
// one exchange, against the five shared-memory round trips of a
// radix-16 pass engine.
//
// The 32-point DFT is a radix-2 network whose constants cos/sin(2 pi m /
// 32) sit in the constant bank (indices that are compile-time constants
// once the loops unroll), multiplications by 1 and by -/+i skipped. The
// stage twiddles W^(q k) are the powers of one entry of the half table
// (device memory, float64-computed on the host), by recurrence, as
// tile_pass takes them.
//
// Shared memory: the tile buffer holds a tile, element e of lane c at
// pad(e) ls + c lc (pad: one slot every 32 elements). B's lanes are
// neighbouring columns (ls = lanes, lc = 1), A's rows (ls = 1, lc = a
// padded row). A radix-32 stage writes element 32 j + p and reads t + T m,
// both free of bank conflicts with that padding.

#pragma once

#include "tile_async.cuh"

namespace {

constexpr int kRegE = 32;          // values a thread holds
constexpr int kRegMaxStages = 3;   // 4096 = 32 x 32 x 4
constexpr int kRegThreads = 256;   // A's largest block

// cos and sin of 2 pi m / 32, m < 16, float64 rounded to float32.
struct W32 {
  float c[16];
  float s[16];
};

__host__ __device__ constexpr W32 make_w32() {
  W32 t{};
  for (int m = 0; m < 16; ++m) {
    t.c[m] = (float)taylor_cos(kTwoPi * m / 32);
    t.s[m] = (float)taylor_sin(kTwoPi * m / 32);
  }
  return t;
}

__constant__ W32 k_w32 = make_w32();

// a * exp(-/+ 2 pi i m / R) (forward / inverse), m < R / 2 a compile-time
// constant once unrolled.
template <int R, bool kInv>
__device__ __forceinline__ float2 mul_w(float2 a, int m) {
  if (m == 0) return a;
  if (4 * m == R) {
    return kInv ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
  }
  const int i = m * (32 / R);
  const float c = k_w32.c[i];
  const float s = kInv ? k_w32.s[i] : -k_w32.s[i];
  return make_float2(a.x * c - a.y * s, a.x * s + a.y * c);
}

// The R-point DFT of butterfly b of the thread's values, v[b + q 32/R],
// q < R, in natural order in and out (a DIF network; its bit-reversed
// output is read back in order).
template <int R, bool kInv>
__device__ __forceinline__ void dft_slots(float2 (&v)[kRegE], int b) {
  constexpr int S = kRegE / R;
  float2 a[R];
#pragma unroll
  for (int q = 0; q < R; ++q) a[q] = v[b + q * S];
#pragma unroll
  for (int half = R / 2; half >= 1; half >>= 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i & half) continue;
      const float2 x = a[i];
      const float2 y = a[i + half];
      a[i] = cadd(x, y);
      a[i + half] =
          mul_w<R, kInv>(csub(x, y), (i & (half - 1)) * (R / (2 * half)));
    }
  }
#pragma unroll
  for (int p = 0; p < R; ++p) v[b + p * S] = a[brev(p, R)];
}

// One Stockham stage of radix R after ns values of stride (ns = 1: the
// first): butterfly j = t + b T takes its inputs, times W_(ns R)^(q k)
// with k = j mod ns, through the R-point DFT.
template <int R, bool kInv>
__device__ __forceinline__ void reg_stage(float2 (&v)[kRegE], int t, int T,
                                          int n, int ns,
                                          const float2* __restrict__ tw) {
  constexpr int S = kRegE / R;
  const int stride = n / (ns * R);
#pragma unroll
  for (int b = 0; b < S; ++b) {
    if (ns > 1) {
      const float2 w = twiddle<kInv>(tw, ((t + b * T) & (ns - 1)) * stride);
      float2 wr = w;
#pragma unroll
      for (int q = 1; q < R; ++q) {
        v[b + q * S] = cmul(v[b + q * S], wr);
        if (q + 1 < R) wr = cmul(wr, w);
      }
    }
    dft_slots<R, kInv>(v, b);
  }
}

// Element e of the tile's lane in the tile buffer (cofs: the lane's
// offset c lc).
struct XMap {
  int ls;
  int cofs;
  __device__ __forceinline__ int operator()(int e) const {
    return (e + (e >> 5)) * ls + cofs;
  }
};

// A stage's outputs to their Stockham positions (j - k) R + k + p ns.
template <int R>
__device__ __forceinline__ void reg_put(const float2 (&v)[kRegE],
                                        float2* buf, XMap xm, int t, int T,
                                        int ns) {
  constexpr int S = kRegE / R;
#pragma unroll
  for (int b = 0; b < S; ++b) {
    const int j = t + b * T;
    const int k = j & (ns - 1);
    const int y0 = (j - k) * R + k;
#pragma unroll
    for (int p = 0; p < R; ++p) buf[xm(y0 + p * ns)] = v[b + p * S];
  }
}

// The geometry of a transform: the half twiddle table of n, the threads a
// transform and the stages (host: reg_geo).
struct RegGeo {
  const float2* tw;
  int n;
  int T;
  int nf;
  int f[kRegMaxStages];
};

inline RegGeo reg_geo(const void* tw, int n) {
  RegGeo g{};
  g.tw = (const float2*)tw;
  g.n = n;
  g.T = n / kRegE;
  int m = n;
  while (m >= kRegE) {
    g.f[g.nf++] = kRegE;
    m /= kRegE;
  }
  if (m > 1) g.f[g.nf++] = m;
  return g;
}

// The transform of the thread's values (element t + T m in v[m], natural
// order in and out), every thread of the block taking part, exchanging
// through the tile buffer `buf` (a barrier before each write, so that the
// last exchange's reads are done). The stages run in a loop with the
// radix picked at run time: straight-line code would let the compiler
// hoist a pass's product loads into the stage after it and run out of
// registers (B spilled 236 bytes so).
template <bool kInv>
__device__ void reg_fft(float2 (&v)[kRegE], const RegGeo& g, float2* buf,
                        XMap xm, int t) {
  int ns = 1;
  for (int s = 0; s < g.nf; ++s) {
    const int R = g.f[s];
    const bool put = s + 1 < g.nf;
    if (put) __syncthreads();
    switch (R) {
      case 32:
        reg_stage<32, kInv>(v, t, g.T, g.n, ns, g.tw);
        if (put) reg_put<32>(v, buf, xm, t, g.T, ns);
        break;
      case 16:
        reg_stage<16, kInv>(v, t, g.T, g.n, ns, g.tw);
        if (put) reg_put<16>(v, buf, xm, t, g.T, ns);
        break;
      case 8:
        reg_stage<8, kInv>(v, t, g.T, g.n, ns, g.tw);
        if (put) reg_put<8>(v, buf, xm, t, g.T, ns);
        break;
      case 4:
        reg_stage<4, kInv>(v, t, g.T, g.n, ns, g.tw);
        if (put) reg_put<4>(v, buf, xm, t, g.T, ns);
        break;
      default:
        reg_stage<2, kInv>(v, t, g.T, g.n, ns, g.tw);
        if (put) reg_put<2>(v, buf, xm, t, g.T, ns);
    }
    if (put) {
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kRegE; ++m) v[m] = buf[xm(t + g.T * m)];
    }
    ns *= R;
  }
}

// v[m] *= f[m stride] * scale for the thread's values, f its factors: the
// complex plane in device memory from the thread's first element
// (kGlobal), or slots in shared memory (A's phase form: the thread's own;
// K7: its row's). kU factors are loaded before any is used, with no select
// on a loaded value.
template <bool kGlobal>
__device__ __forceinline__ void mul_plane(float2 (&v)[kRegE],
                                          const float2* __restrict__ f,
                                          int stride, float scale) {
  constexpr int kU = 4;
#pragma unroll
  for (int m0 = 0; m0 < kRegE; m0 += kU) {
    float2 q[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int k = (m0 + u) * stride;
      q[u] = kGlobal ? __ldg(&f[k]) : f[k];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      v[m0 + u] = cscale(cmul(v[m0 + u], q[u]), scale);
    }
  }
}

// Host: whether a tile plan is one A and B take: a pow2 axis n of 128 to
// 4096, 2^logc lanes (at most 32) that divide the other axis, a block of
// whole warps within max_threads.
inline bool reg_plan_ok(int n, int other, int logc,
                        int max_threads = kRegThreads) {
  const int threads = (n / kRegE) << logc;
  return n >= 128 && n <= 4096 && (n & (n - 1)) == 0 && logc >= 0 &&
         logc <= 5 && (1 << logc) <= other && other % (1 << logc) == 0 &&
         threads >= 32 && threads <= max_threads;
}

// Host: the tile buffer of a plan, in bytes.
inline size_t reg_smem(int n, int logc) {
  return ((size_t)(n + (n >> 5)) << logc) * sizeof(float2);
}

}  // namespace
