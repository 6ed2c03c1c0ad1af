// The register-resident mixed-radix FFT engine of K5 and K4
// (fused_step_odd.cu col_pass_mr_reg_kernel, row_pass_mr_reg_kernel):
// fft_regs.cuh's design carried to an axis that is no power of two. The
// axis n = N1 x N2 splits into two groups, N1 its
// first Stockham stage radix (fft_mixed.cuh make_plan) and N2 the product
// of the others, each at most kMrE and odd (1023 = 31 x 33, 33 = 11 x 3).
// A transform takes T = max(N1, N2) threads, each holding at most kMrE
// values in registers, and one exchange through shared memory:
//
//   forward   thread t < N2 holds x[t + N2 m], m < N1 (as loaded). The
//             radix-N1 DFT (Stockham, ns = 1) writes its outputs straight
//             to the exchange, element t N1 + q. A barrier. Thread j < N1
//             reads elements j + N1 r, r < N2, times the stage twiddles
//             W_n^(j r), and takes their radix-N2 DFT in registers (the
//             group's own Stockham stages, inner twiddles W_N2 compile-time
//             constants): it then holds X[j + N1 q], q < N2, natural order.
//   inverse   the radix-N2 stage first (ns = 1): thread j's inputs are the
//             values X[j + N1 r] it already holds, so a forward transform,
//             a product at the natural positions and this stage never leave
//             the registers (B's property). It writes element j N2 + q. A
//             barrier. Thread t < N2 reads elements t + N2 r, r < N1, times
//             W_n^(-t r), and the radix-N1 DFT leaves it x[t + N2 q]: the
//             positions it loaded, natural order.
//
// So a pass (forward, product, inverse) costs two exchanges through shared
// memory (K5 runs both through one buffer, four barriers a tile), against
// 2 x 3 stage round trips, each with a table read, and the tile's copies
// on the persistent tiles of tile_async.cuh.
//
// Every radix is odd and takes the symmetric form of tile_pass (x_r paired
// with x_(R-r)), its constants cos/sin(2 pi m / R) from the constant bank
// at compile-time indices (k_mr, float64 rounded to float32 as
// tile_async.cuh's k_dft). The stage twiddles W_n^(a b), a < N1, b < N2
// (a b < n: no reduction), are the float64-computed table's entries,
// copied once a block into shared memory as a table of N1 rows of N2
// (mr_table), read without bank conflicts (odd N2).
//
// The exchange is a caller's functor (element e of the transform to a slot
// of shared memory): K5 keeps the tile's lanes, its columns, side by side
// (slot e L + c for lane c of L); with odd N1 and N2 a half warp's 8-byte
// accesses then fall on distinct banks at every step. K4 keeps its rows
// one after another (slot c n + e), its threads walking a row.

#pragma once

#include "tile_async.cuh"

namespace {

constexpr int kMrE = 33;   // the most values a thread holds (a group)

// cos and sin of 2 pi m / R for R <= kMrE, m <= R / 2.
struct MrConsts {
  float c[kMrE + 1][kMrE / 2 + 1];
  float s[kMrE + 1][kMrE / 2 + 1];
};

__host__ __device__ constexpr MrConsts make_mr_consts() {
  MrConsts t{};
  for (int r = 2; r <= kMrE; ++r) {
    for (int m = 0; 2 * m <= r; ++m) {
      const double x = kTwoPi * m / r;
      t.c[r][m] = (float)taylor_cos(x);
      t.s[r][m] = (float)taylor_sin(x);
    }
  }
  return t;
}

__constant__ MrConsts k_mr = make_mr_consts();

// a * exp(-/+ 2 pi i m / R) (forward / inverse), m a compile-time constant
// once unrolled; multiplications by 1 skipped.
template <int R, bool kInv>
__device__ __forceinline__ float2 mul_mr_w(float2 a, int m) {
  m %= R;
  if (m == 0) return a;
  const bool hi = 2 * m > R;
  const float c = k_mr.c[R][hi ? R - m : m];
  const float s0 = hi ? -k_mr.s[R][R - m] : k_mr.s[R][m];   // sin(2 pi m/R)
  const float s = kInv ? s0 : -s0;
  return make_float2(a.x * c - a.y * s, a.x * s + a.y * c);
}

// The R-point DFT (R odd, >= 3) of get(r), r < R, each output y_q handed
// to put(q, y_q) as soon as it is formed: with a_r = x_r + x_(R-r),
// b_r = x_r - x_(R-r), y_q = A_q -/+ i B_q and y_(R-q) = A_q +/- i B_q,
// A_q = x_0 + sum_r a_r cos(2 pi qr/R), B_q = sum_r b_r sin(2 pi qr/R).
template <int R, bool kInv, class Get, class Put>
__device__ __forceinline__ void mr_dft(Get get, Put put) {
  constexpr int H = (R - 1) / 2;
  const float2 x0 = get(0);
  float2 a[H + 1];
  float2 b[H + 1];
  float2 y0 = x0;
#pragma unroll
  for (int r = 1; r <= H; ++r) {
    const float2 p = get(r);
    const float2 m = get(R - r);
    a[r] = cadd(p, m);
    b[r] = csub(p, m);
    y0 = cadd(y0, a[r]);
  }
  put(0, y0);
#pragma unroll
  for (int q = 1; q <= H; ++q) {
    float2 A = x0;
    float2 B = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      const int m = (q * r) % R;
      const float cm = m <= H ? k_mr.c[R][m] : k_mr.c[R][R - m];
      const float s0 = m <= H ? k_mr.s[R][m] : -k_mr.s[R][R - m];
      const float sm = kInv ? -s0 : s0;
      A.x += a[r].x * cm;
      A.y += a[r].y * cm;
      B.x += b[r].x * sm;
      B.y += b[r].y * sm;
    }
    put(q, make_float2(A.x + B.y, A.y - B.x));
    put(R - q, make_float2(A.x - B.y, A.y + B.x));
  }
}

// The N-point DFT of v[0 .. N), natural order in and out, as the Stockham
// stages R, Rest... in registers (NS: the product of the stages before):
// item j < N / R takes v[j + r N/R] times W_N^(r k N/(NS R)), k = j mod NS,
// and its outputs go to (j - k) R + k + q NS.
template <bool kInv, int N, int NS, int R, int... Rest>
__device__ __forceinline__ void mr_group(float2 (&v)[kMrE]) {
  constexpr int M = N / R;
  float2 o[N];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int k = j % NS;
    mr_dft<R, kInv>(
        [&](int r) {
          return mul_mr_w<N, kInv>(v[j + r * M], r * k * (N / (NS * R)));
        },
        [&](int q, float2 y) { o[(j - k) * R + k + q * NS] = y; });
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = o[i];
  if constexpr (sizeof...(Rest) > 0) mr_group<kInv, N, NS * R, Rest...>(v);
}

// An axis n = N1 x N2: the first stage's radix R1 and the group's stages.
template <int R1, int... R2>
struct MrAxis {
  static constexpr int N1 = R1;
  static constexpr int N2 = (R2 * ... * 1);
  static constexpr int n = N1 * N2;
  static constexpr int T = N1 > N2 ? N1 : N2;   // threads a transform
  static_assert(N1 % 2 == 1 && N2 % 2 == 1 && N1 <= kMrE && N2 <= kMrE &&
                    sizeof...(R2) >= 1,
                "two odd groups of at most kMrE values");

  // The radix-N2 DFT of v[0 .. N2) in registers.
  template <bool kInv>
  __device__ __forceinline__ static void group(float2 (&v)[kMrE]) {
    mr_group<kInv, N2, 1, R2...>(v);
  }
};

// The block's table of stage twiddles in shared memory: tws[a N2 + b] =
// W_n^(a b), a < N1, b < N2, from tw, the n-entry float64-computed table.
// The caller fences it with a barrier before the first read.
template <class Ax>
__device__ __forceinline__ void mr_table(float2* tws,
                                         const float2* __restrict__ tw) {
  for (int i = threadIdx.x; i < Ax::n; i += blockDim.x) {
    tws[i] = tw[(i / Ax::N2) * (i % Ax::N2)];
  }
}

// Forward, first stage (thread t < N2, v[m] = x[t + N2 m], m < N1): the
// radix-N1 DFT, its outputs to the exchange, xs(e) the slot of element e.
template <class Ax, class Slot>
__device__ __forceinline__ void mr_fwd_first(float2 (&v)[kMrE], int t,
                                             Slot xs) {
  mr_dft<Ax::N1, false>([&](int r) { return v[r]; },
                        [&](int q, float2 y) { *xs(t * Ax::N1 + q) = y; });
}

// Forward, second stage (thread j < N1, after a barrier): elements
// j + N1 r times W_n^(j r), then the radix-N2 group; v[q] = X[j + N1 q].
template <class Ax, class Slot>
__device__ __forceinline__ void mr_fwd_second(float2 (&v)[kMrE], int j,
                                              Slot xs, const float2* tws) {
  v[0] = *xs(j);
#pragma unroll
  for (int r = 1; r < Ax::N2; ++r) {
    v[r] = cmul(*xs(j + Ax::N1 * r), tws[j * Ax::N2 + r]);
  }
  Ax::template group<false>(v);
}

// Inverse, first stage's outputs: thread j < N1, once it has taken the
// radix-N2 group of the values it holds (Ax::group<true>), puts them to
// the exchange at j N2 + q.
template <class Ax, class Slot>
__device__ __forceinline__ void mr_inv_put(const float2 (&v)[kMrE], int j,
                                           Slot xs) {
#pragma unroll
  for (int q = 0; q < Ax::N2; ++q) *xs(j * Ax::N2 + q) = v[q];
}

// Inverse, second stage (thread t < N2, after a barrier): elements
// t + N2 r times W_n^(-t r), the radix-N1 DFT, each output x[t + N2 q]
// (unnormalized) handed to put(q, value).
template <class Ax, class Slot, class Put>
__device__ __forceinline__ void mr_inv_second(float2 (&v)[kMrE], int t,
                                              Slot xs, const float2* tws,
                                              Put put) {
  v[0] = *xs(t);
#pragma unroll
  for (int r = 1; r < Ax::N1; ++r) {
    const float2 w = tws[r * Ax::N2 + t];
    v[r] = cmul(*xs(t + Ax::N2 * r), make_float2(w.x, -w.y));
  }
  mr_dft<Ax::N1, true>([&](int r) { return v[r]; }, put);
}

// Host: the shared memory of a block: the exchange buffer of 2^logc lanes
// of n, and the twiddle table.
inline size_t mr_reg_smem(int n, int logc) {
  return ((size_t)n << logc) * sizeof(float2) + (size_t)n * sizeof(float2);
}

}  // namespace
