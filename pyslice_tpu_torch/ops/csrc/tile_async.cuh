// The tiles of the persistent mixed-radix passes K4 (the row pass) and K5
// (the column pass) of fused_step_odd.cu: their stage routine, the copies
// of a tile between device memory and shared memory that their producer
// warps run (cp.async in, plain stores out) while their consumer warps
// transform, and each pass's transform of one tile (row_tile_compute,
// col_tile_compute). K6 and K8 keep the tile functions of tiles.cuh and
// the stage routine sk_pass of fft_mixed.cuh.
//
// Layout as in tiles.cuh: a tile holds 2^logc lanes side by side (K5: the
// wave's columns; K4: its rows), element (i, c) at s[(i << logc) + c],
// natural order on both sides of each transform (the Stockham engine).
//
// tile_pass is sk_pass with two changes: the R-point DFT's constants
// cos/sin(2 pi m / R) come from a __constant__ table at indices that are
// compile-time constants once the loops are unrolled, so they are
// constant-bank operands of the multiply-adds and take no registers
// (sk_pass holds them in a per-thread array, 16 float2 for R = 31); and an
// operand (TileProp for K5, RowT for K4) may multiply each value as it is
// loaded. The table is computed in float64 at compile time and rounded to
// float32, as the twiddle table is on the host. The stages, their order,
// the twiddle table and the 1/n scale are those of fft_mixed.cuh.

#pragma once

#include <cstdint>
#include <type_traits>

#include "fft_mixed.cuh"

namespace {

constexpr double kTwoPi = 6.283185307179586476925286766559;

// Taylor series of sin and cos, for 0 <= x <= pi: float64 roundoff.
__host__ __device__ constexpr double taylor_sin(double x) {
  double term = x;
  double sum = x;
  for (int k = 1; k < 24; ++k) {
    term *= -x * x / ((2.0 * k) * (2.0 * k + 1.0));
    sum += term;
  }
  return sum;
}

__host__ __device__ constexpr double taylor_cos(double x) {
  double term = 1.0;
  double sum = 1.0;
  for (int k = 1; k < 24; ++k) {
    term *= -x * x / ((2.0 * k - 1.0) * (2.0 * k));
    sum += term;
  }
  return sum;
}

// cos and sin of 2 pi m / R for the radices in registers (R <= 31) and
// m <= R / 2.
struct DftConsts {
  float c[32][16];
  float s[32][16];
};

__host__ __device__ constexpr DftConsts make_dft_consts() {
  DftConsts t{};
  for (int r = 2; r < 32; ++r) {
    for (int m = 0; m < 16 && 2 * m <= r; ++m) {
      const double x = kTwoPi * m / r;
      t.c[r][m] = (float)taylor_cos(x);
      t.s[r][m] = (float)taylor_sin(x);
    }
  }
  return t;
}

__constant__ DftConsts k_dft = make_dft_consts();

// exp(-/+ 2 pi i m / R) (forward / inverse), m <= R / 2.
template <int R, bool kInv>
__device__ __forceinline__ float2 dft_w(int m) {
  return make_float2(k_dft.c[R][m], kInv ? k_dft.s[R][m] : -k_dft.s[R][m]);
}

// The operands of a stage's loads: at(i, c) is the factor of element i of
// lane c. NoOp: none.
struct NoOp {
  static constexpr bool kActive = false;
};

// K5's: the Fresnel plane at the tile's columns, prop + y0 of the (nx, ny)
// plane (the row length ny, the tile's first column y0), times the scale
// 1/n; zero past the last column.
struct TileProp {
  static constexpr bool kActive = true;
  const float2* __restrict__ prop;
  int ny;
  int y0;
  float scale;
  __device__ __forceinline__ float2 at(int i, int c) const {
    const float2 p = y0 + c < ny ? __ldg(&prop[(size_t)i * ny + c])
                                 : make_float2(0.0f, 0.0f);
    return cscale(p, scale);
  }
};

// K4's: the transmission at the tile's rows, t + x0 n of the (nx, n) plane
// (lane c is row x0 + c, of which `rows` - c remain), times the scale. t
// is the complex plane or, with kPhase, sv is the phase sigma*V, from which
// cos/sin are taken here (sincosf, no fast-math: the phases run to tens of
// radians). A lane past the plane's last row reads that row (the lane is
// never stored). The loads carry no branch and no select, so an unrolled
// loop issues them all before it waits for any.
template <bool kPhase>
struct RowT {
  static constexpr bool kActive = true;
  const float2* __restrict__ t;
  const float* __restrict__ sv;
  int n;
  int rows;
  float scale;
  __device__ __forceinline__ float2 at(int i, int c) const {
    const size_t k = (size_t)min(c, rows - 1) * n + i;
    float2 v;
    if constexpr (kPhase) {
      sincosf(__ldg(&sv[k]), &v.y, &v.x);
    } else {
      v = __ldg(&t[k]);
    }
    return cscale(v, scale);
  }
};

// One Stockham stage of radix R, R values of an item in registers: the
// work of sk_pass (fft_mixed.cuh), with the DFT constants from k_dft and
// the stage twiddles from `tws`, the block's copy of the twiddle table in
// shared memory (in L1 the streaming tile copies would evict it). With an
// active operand each value read is multiplied by m.at(i, c) as it is
// loaded: the pass's product, with no pass of its own.
// j mod ns is taken with a float reciprocal: exact for j < 2^20, as the
// error of (j + 1/2) / ns stays far below its distance 1/(2 ns) from an
// integer.
template <int R, bool kInv, class Op>
__device__ void tile_pass(const float2* __restrict__ in,
                          float2* __restrict__ out, const Op& m, int n,
                          int logc, int ns, const float2* tws, int tid,
                          int nt) {
  constexpr bool kPow2 = (R & (R - 1)) == 0;
  const int nr = n / R;
  const int stride = n / (ns * R);
  const int cmask = (1 << logc) - 1;
  const int items = nr << logc;
  const float inv_ns = 1.0f / (float)ns;
  for (int b = tid; b < items; b += nt) {
    const int c = b & cmask;
    const int j = b >> logc;
    const int k = j - ns * (int)(((float)j + 0.5f) * inv_ns);
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = in[((j + r * nr) << logc) + c];
    if constexpr (Op::kActive) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = cmul(v[r], m.at(j + r * nr, c));
    }
    if (k != 0) {
      const float2 w = tws[k * stride];
      const float2 wk = kInv ? make_float2(w.x, -w.y) : w;
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
          v[i + half] = cmul(csub(x, y),
                             dft_w<R, kInv>((i & (half - 1)) * (R / (2 * half))));
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        out[((base + q * ns) << logc) + c] = v[brev(q, R)];
      }
    } else {
      // The symmetric odd-radix form of sk_pass: with a_r = v_r + v_(R-r),
      // b_r = v_r - v_(R-r), y_q = A_q -/+ i B_q and y_(R-q) = A_q +/- i B_q,
      // A_q = v_0 + sum_r a_r cos(2 pi qr/R), B_q = sum_r b_r sin(2 pi qr/R).
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
          // cos(2 pi m/R) and -/+ sin(2 pi m/R), from the table's m <= H
          const float cm = m <= H ? k_dft.c[R][m] : k_dft.c[R][R - m];
          const float s0 = m <= H ? k_dft.s[R][m] : -k_dft.s[R][R - m];
          const float sm = kInv ? -s0 : s0;
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

// One stage of radix r on the tile in `a` into `b`: tile_pass for the
// radices in registers, with the twiddles of `tws` (shared memory);
// sk_generic (fft_mixed.cuh) for a larger prime, with those of `tw`
// (device memory, as its __ldg reads need). sk_generic takes no operand:
// a stage with one must be in registers (the hosts check the first).
template <bool kInv, class Op>
__device__ void tile_stage(int r, const float2* a, float2* b, const Op& m,
                           int n, int logc, int ns, const float2* tws,
                           const float2* __restrict__ tw, int tid, int nt) {
  switch (r) {
    case 2: tile_pass<2, kInv>(a, b, m, n, logc, ns, tws, tid, nt); break;
    case 3: tile_pass<3, kInv>(a, b, m, n, logc, ns, tws, tid, nt); break;
    case 4: tile_pass<4, kInv>(a, b, m, n, logc, ns, tws, tid, nt); break;
    case 5: tile_pass<5, kInv>(a, b, m, n, logc, ns, tws, tid, nt); break;
    case 7: tile_pass<7, kInv>(a, b, m, n, logc, ns, tws, tid, nt); break;
    case 8: tile_pass<8, kInv>(a, b, m, n, logc, ns, tws, tid, nt); break;
    case 16: tile_pass<16, kInv>(a, b, m, n, logc, ns, tws, tid, nt); break;
    case 11: tile_pass<11, kInv>(a, b, m, n, logc, ns, tws, tid, nt); break;
    case 13: tile_pass<13, kInv>(a, b, m, n, logc, ns, tws, tid, nt); break;
    case 17: tile_pass<17, kInv>(a, b, m, n, logc, ns, tws, tid, nt); break;
    case 19: tile_pass<19, kInv>(a, b, m, n, logc, ns, tws, tid, nt); break;
    case 23: tile_pass<23, kInv>(a, b, m, n, logc, ns, tws, tid, nt); break;
    case 29: tile_pass<29, kInv>(a, b, m, n, logc, ns, tws, tid, nt); break;
    case 31: tile_pass<31, kInv>(a, b, m, n, logc, ns, tws, tid, nt); break;
    default:
      if constexpr (!Op::kActive) {
        sk_generic<kInv>(a, b, n, r, logc, ns, tw, tid, nt);
      }
  }
}

// Asynchronous copies global -> shared (cp.async, sm_80 and later) of 8 or
// 16 bytes; with ok false nothing is read and the destination is
// zero-filled. A thread's copies complete in the order of its commit
// groups; cp_async_wait_all() waits for all of them, and a barrier after
// it makes every thread's copies visible.
__device__ __forceinline__ void cp_async8(float2* dst, const float2* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float2* dst, const float2* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A barrier among the first nt threads of the block (named barrier 1; nt a
// multiple of 32), which leaves the block's other warps running.
__device__ __forceinline__ void bar_sync_first(int nt) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
}

// A barrier among the block's last nt threads (named barrier 2; nt a
// multiple of 32).
__device__ __forceinline__ void bar_sync_last(int nt) {
  asm volatile("bar.sync 2, %0;\n" ::"r"(nt) : "memory");
}

// A column tile's copies (K5): columns y0 .. y0 + 2^logc - 1 of probe p,
// in shared memory at s (element (i, c) at s[(i << logc) + c]). vec16: 16
// bytes a copy (column pairs), for an even ny and 16-byte aligned tensors
// (every row's segment then starts 16-byte aligned); 8 bytes otherwise (an
// odd ny puts every other row's segment 8 bytes off).
struct TileCopy {
  float2* s;
  const float2* in;
  int n;
  int ny;
  int p;
  int y0;
  int logc;
  bool vec16;

  // Issue the copies of the tile from `in` (cp.async; the caller commits
  // and waits); columns past ny are zero-filled.
  __device__ void issue(int tid, int nt) const {
    const float2* src = in + (size_t)p * n * ny + y0;
    const int lu = vec16 ? logc - 1 : logc;     // copy units a row, log2
    const int umask = (1 << lu) - 1;
    const int tot = n << lu;
    for (int q = tid; q < tot; q += nt) {
      const int c = (q & umask) << (vec16 ? 1 : 0);
      const bool ok = y0 + c < ny;     // ny even: y0 + c + 1 < ny too
      const float2* g = ok ? src + (size_t)(q >> lu) * ny + c : in;
      if (vec16) {
        cp_async16(s + (q << 1), g, ok);
      } else {
        cp_async8(s + q, g, ok);
      }
    }
  }

  // Store the tile to the same columns of `out`, those below ny.
  __device__ void store(float2* out, int tid, int nt) const {
    float2* dst = out + (size_t)p * n * ny + y0;
    const int lu = vec16 ? logc - 1 : logc;
    const int umask = (1 << lu) - 1;
    const int tot = n << lu;
#pragma unroll 4
    for (int q = tid; q < tot; q += nt) {
      const int c = (q & umask) << (vec16 ? 1 : 0);
      if (y0 + c >= ny) continue;
      float2* g = dst + (size_t)(q >> lu) * ny + c;
      if (vec16) {
        *reinterpret_cast<float4*>(g) = reinterpret_cast<const float4*>(s)[q];
      } else {
        *g = s[q];
      }
    }
  }
};

// A row tile's copies (K4): rows x0 .. x0 + 2^logc - 1 of probe p (rows of
// n elements), element i of row x0 + r at s[(i << logc) + r]. Slot q holds
// row q mod 2^logc, so a warp's 32 copies fill 32 neighbouring slots and
// read 32 / 2^logc elements of each of the tile's rows. 8 bytes a copy: a
// row's neighbouring elements sit 2^logc slots apart.
struct RowTileCopy {
  float2* s;
  const float2* in;
  int n;
  int nx;
  int p;
  int x0;
  int logc;

  // Issue the copies of the tile from `in` (cp.async; the caller commits
  // and waits); rows past nx are zero-filled.
  __device__ void issue(int tid, int nt) const {
    const float2* src = in + ((size_t)p * nx + x0) * n;
    const int rmask = (1 << logc) - 1;
    const int tot = n << logc;
    for (int q = tid; q < tot; q += nt) {
      const int r = q & rmask;
      const bool ok = x0 + r < nx;
      cp_async8(s + q, ok ? src + (size_t)r * n + (q >> logc) : in, ok);
    }
  }

  // Store the tile to the same rows of `out`, those below nx.
  __device__ void store(float2* out, int tid, int nt) const {
    float2* dst = out + ((size_t)p * nx + x0) * n;
    const int rmask = (1 << logc) - 1;
    const int tot = n << logc;
#pragma unroll 4
    for (int q = tid; q < tot; q += nt) {
      const int r = q & rmask;
      if (x0 + r < nx) dst[(size_t)r * n + (q >> logc)] = s[q];
    }
  }
};

// K5's transform of the tile whose copies have landed in `cur` (`spare`
// the second buffer; `tws` the twiddle table in shared memory), on the
// first nt threads: FFT_x, x prop / n, IFFT_x, the result in `cur`
// (2 nf stages, each from one buffer into the other). The product with
// prop / n is taken in the first inverse stage's loads. The plan has at
// least two stages and a first stage in registers (every size the host
// sends). The stages are fenced by bar_sync_first(nt); it ends with one.
__device__ void col_tile_compute(const MixedEng& ex, float2* cur,
                                 float2* spare, const float2* tws,
                                 const TileProp& m, int logc, int tid,
                                 int nt) {
  const MixedPlan& pl = ex.plan;
  float2* a = cur;
  float2* b = spare;
  int ns = 1;
  for (int i = 0; i < 2 * pl.nf; ++i) {
    const bool inv = i >= pl.nf;
    const int si = inv ? i - pl.nf : i;
    const int r = pl.f[si];
    if (si == 0) ns = 1;
    if (!inv) {
      tile_stage<false>(r, a, b, NoOp{}, ex.n, logc, ns, tws, ex.tw, tid, nt);
    } else if (si == 0) {
      tile_stage<true>(r, a, b, m, ex.n, logc, ns, tws, ex.tw, tid, nt);
    } else {
      tile_stage<true>(r, a, b, NoOp{}, ex.n, logc, ns, tws, ex.tw, tid, nt);
    }
    bar_sync_first(nt);
    float2* t = a;
    a = b;
    b = t;
    ns *= r;
  }
}

// K4's transform of the tile whose copies have landed in `cur` (`spare`
// the second buffer, `tws` the twiddle table in shared memory), on the
// first nt threads, by mode:
//   first: x t, FFT_y      mid: IFFT_y, x t / n, FFT_y
//   last:  IFFT_y, x t / n only: x t
// (m carries t and the scale). With the complex plane the product is
// taken in the first forward stage's loads (first, mid); otherwise (the
// phase, whose sincosf in a stage's loads would not fit the registers
// beside the stage's values, or no forward stage) in a pass of its own
// after the inverse stages. The result ends in `cur` after an even count
// of stages, in `spare` after an odd one. A first forward stage is in
// registers (every size the host sends). Fenced by bar_sync_first(nt); it
// ends with one.
template <bool kPhase>
__device__ void row_tile_compute(const MixedEng& ey, float2* cur,
                                 float2* spare, const float2* tws,
                                 const RowT<kPhase>& m, int mode, int logc,
                                 int tid, int nt) {
  const MixedPlan& pl = ey.plan;
  const bool fwd = mode == kFirst || mode == kMid;
  float2* a = cur;
  float2* b = spare;
  auto stages = [&](auto inv, auto op) {
    int ns = 1;
    for (int i = 0; i < pl.nf; ++i) {
      const int r = pl.f[i];
      if (i == 0) {
        tile_stage<decltype(inv)::value>(r, a, b, op, ey.n, logc, ns, tws,
                                         ey.tw, tid, nt);
      } else {
        tile_stage<decltype(inv)::value>(r, a, b, NoOp{}, ey.n, logc, ns,
                                         tws, ey.tw, tid, nt);
      }
      bar_sync_first(nt);
      float2* t = a;
      a = b;
      b = t;
      ns *= r;
    }
  };
  if (mode == kMid || mode == kLast) stages(std::true_type{}, NoOp{});
  if (kPhase || !fwd) {
    // kU factors a thread before it multiplies, so that their loads overlap
    constexpr int kU = 8;
    const int cmask = (1 << logc) - 1;
    const int tot = ey.n << logc;
    for (int q0 = tid; q0 < tot; q0 += kU * nt) {
      float2 f[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int q = min(q0 + u * nt, tot - 1);
        f[u] = m.at(q >> logc, q & cmask);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int q = q0 + u * nt;
        if (q < tot) a[q] = cmul(a[q], f[u]);
      }
    }
    bar_sync_first(nt);
  }
  if (!fwd) return;
  if constexpr (kPhase) {
    stages(std::false_type{}, NoOp{});
  } else {
    stages(std::false_type{}, m);
  }
}

}  // namespace
