// The tiles of the persistent mixed-radix passes K4 (the row pass) and K5
// (the column pass) of fused_step_odd.cu, K8 (the adjoint's backward row
// pass) of fused_step_adjoint_odd.cu and the mixed-radix instantiation of
// K6 (the resident slice loop) of resident.cu: their stage routine, the
// copies of a tile between device memory and shared memory that their
// producer warps run (cp.async in, plain stores out) while their consumer
// warps transform, each pass's transform of one tile (row_tile_compute,
// col_tile_compute, pair_tile_compute), and the persistent walk and launch
// sizing they share (persistent_tiles, persistent_grid, plan_ok). A, B, K7
// and K6's power-of-two instantiation run the register engine of
// fft_regs.cuh, which takes persistent_grid and the DFT helpers from here.
//
// Layout: a tile holds 2^logc lanes side by side (K5: the wave's columns;
// K4: its rows; K8: its rows' pair members, lane 2r + c member c of row
// r), element (i, c) at s[(i << logc) + c], natural order on both sides of
// each transform (the Stockham order).
//
// tile_pass runs one Stockham stage of radix R with the item's R values
// in registers: the R-point DFT's constants cos/sin(2 pi m / R) come from
// a __constant__ table at indices that are compile-time constants once
// the loops are unrolled, so they are constant-bank operands of the
// multiply-adds and take no registers; and an operand (TileProp for K5,
// RowT for K4) may multiply each value as it is loaded. The table is
// computed in float64 at compile time and rounded to float32, as the
// twiddle table is on the host. The stage order, the twiddle table and
// the 1/n scale are those of fft_mixed.cuh.

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

// K4's and K8's: the transmission at the tile's rows, t + x0 n of the
// (nx, n) plane (lane c is row x0 + (c >> kLaneShift), of which `rows`
// remain from x0; K8's lanes 2r and 2r + 1 share row r), times the scale.
// t is the complex plane or, with kPhase, sv is the phase sigma*V, from
// which cos/sin are taken here (sincosf, no fast-math: the phases run to
// tens of radians). A lane past the plane's last row reads that row (the
// lane is never stored). The loads carry no branch and no select, so an
// unrolled loop issues them all before it waits for any.
template <bool kPhase, int kLaneShift = 0>
struct RowT {
  static constexpr bool kActive = true;
  const float2* __restrict__ t;
  const float* __restrict__ sv;
  int n;
  int rows;
  float scale;
  __device__ __forceinline__ float2 at(int i, int c) const {
    const size_t k = (size_t)min(c >> kLaneShift, rows - 1) * n + i;
    float2 v;
    if constexpr (kPhase) {
      sincosf(__ldg(&sv[k]), &v.y, &v.x);
    } else {
      v = __ldg(&t[k]);
    }
    return cscale(v, scale);
  }
};

// One Stockham stage of radix R, R values of an item in registers (see
// fft_mixed.cuh for the stage), with the DFT constants from k_dft and the
// stage twiddles from `tws`, the block's copy of the twiddle table in
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
      // The symmetric odd-radix form: with a_r = v_r + v_(R-r),
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

// The 8-byte copies of a tile that another block may have written since
// this kernel began (K6's state, between two of its grid barriers): slot q
// of s < tot from src(q), zero where src(q) is null. cp.async.ca would
// fill through L1, which may hold the slot's address from an earlier
// phase, so these are loads through L2 (ld.global.cg) into registers and
// stores to shared memory, kU loads a thread in flight before the first
// store. Synchronous, so the caller needs no commit or wait.
template <class Src>
__device__ __forceinline__ void l2_copy8(float2* s, int tot, int tid, int nt,
                                         Src src) {
  constexpr int kU = 16;
  for (int q0 = tid; q0 < tot; q0 += kU * nt) {
    float2 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = q0 + u * nt;
      const float2* g = q < tot ? src(q) : nullptr;
      v[u] = g != nullptr ? __ldcg(g) : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = q0 + u * nt;
      if (q < tot) s[q] = v[u];
    }
  }
}

// A column tile's copies (K5, K6): columns y0 .. y0 + 2^logc - 1 of probe
// p, in shared memory at s (element (i, c) at s[(i << logc) + c]). vec16:
// 16 bytes a copy (column pairs, cp.async.cg, through L2), for an even ny
// and 16-byte aligned tensors (every row's segment then starts 16-byte
// aligned); 8 bytes otherwise (an odd ny puts every other row's segment 8
// bytes off): cp.async.ca, or with kL2 l2_copy8.
template <bool kL2 = false>
struct TileCopyT {
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
    if (kL2 && !vec16) {
      l2_copy8(s, tot, tid, nt, [&](int q) -> const float2* {
        const int c = q & umask;
        return y0 + c < ny ? src + (size_t)(q >> lu) * ny + c : nullptr;
      });
      return;
    }
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

using TileCopy = TileCopyT<false>;

// A row tile's copies (rows of n elements). K4's (kPair 0): rows x0 .. x0
// + 2^logc - 1 of probe p, lane c row x0 + c. K8's (kPair 1): rows x0 ..
// x0 + 2^(logc-1) - 1 of pair p of the (2 P, nx, n) stream, lane c member
// c & 1 (plane 2p + (c & 1)) of row x0 + (c >> 1); the two members of a
// row sit nx n elements apart. Element i of lane c at s[(i << logc) + c].
// Slot q holds lane q mod 2^logc, so a warp's 32 copies fill 32
// neighbouring slots and read 32 / 2^logc elements of each of the tile's
// lanes. 8 bytes a copy: a lane's neighbouring elements sit 2^logc slots
// apart: cp.async.ca, or with kL2 l2_copy8.
template <int kPair, bool kL2 = false>
struct RowTileCopy {
  float2* s;
  const float2* in;
  int n;
  int nx;
  int p;
  int x0;
  int logc;

  // Lane c's row: its offset from the tensor's start, in elements.
  __device__ __forceinline__ size_t row(int c) const {
    return ((size_t)((p << kPair) + (c & kPair)) * nx + x0 + (c >> kPair)) *
           n;
  }

  // Issue the copies of the tile from `in` (cp.async; the caller commits
  // and waits); rows past nx are zero-filled.
  __device__ void issue(int tid, int nt) const {
    const int cmask = (1 << logc) - 1;
    const int tot = n << logc;
    if constexpr (kL2) {
      l2_copy8(s, tot, tid, nt, [&](int q) -> const float2* {
        const int c = q & cmask;
        return x0 + (c >> kPair) < nx ? in + row(c) + (q >> logc) : nullptr;
      });
      return;
    }
    for (int q = tid; q < tot; q += nt) {
      const int c = q & cmask;
      const bool ok = x0 + (c >> kPair) < nx;
      cp_async8(s + q, ok ? in + row(c) + (q >> logc) : in, ok);
    }
  }

  // Store the tile to the same rows of `out`, those below nx.
  __device__ void store(float2* out, int tid, int nt) const {
    const int cmask = (1 << logc) - 1;
    const int tot = n << logc;
#pragma unroll 4
    for (int q = tid; q < tot; q += nt) {
      const int c = q & cmask;
      if (x0 + (c >> kPair) < nx) out[row(c) + (q >> logc)] = s[q];
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

// One transform on the tile in `a` (`b` the second buffer, `tws` the
// twiddle table): the plan's stages, each from one buffer into the other
// and fenced by bar_sync_first(nt), the first stage's loads multiplied by
// `op`. On return `a` holds the result and `b` the other buffer.
template <bool kInv, class Op>
__device__ void tile_transform(const MixedEng& e, float2*& a, float2*& b,
                               const float2* tws, const Op& op, int logc,
                               int tid, int nt) {
  const MixedPlan& pl = e.plan;
  int ns = 1;
  for (int i = 0; i < pl.nf; ++i) {
    const int r = pl.f[i];
    if (i == 0) {
      tile_stage<kInv>(r, a, b, op, e.n, logc, ns, tws, e.tw, tid, nt);
    } else {
      tile_stage<kInv>(r, a, b, NoOp{}, e.n, logc, ns, tws, e.tw, tid, nt);
    }
    bar_sync_first(nt);
    float2* t = a;
    a = b;
    b = t;
    ns *= r;
  }
}

// The product of every value of the tile in `a` with m.at(i, c), a pass of
// its own on the first nt threads: kU factors a thread are loaded before
// it multiplies, so that their loads overlap. Ends with bar_sync_first(nt).
template <class Op>
__device__ void product_pass(float2* a, const Op& m, int n, int logc, int tid,
                             int nt) {
  constexpr int kU = 8;
  const int cmask = (1 << logc) - 1;
  const int tot = n << logc;
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
  const bool fwd = mode == kFirst || mode == kMid;
  float2* a = cur;
  float2* b = spare;
  if (mode == kMid || mode == kLast) {
    tile_transform<true>(ey, a, b, tws, NoOp{}, logc, tid, nt);
  }
  if (kPhase || !fwd) product_pass(a, m, ey.n, logc, tid, nt);
  if (!fwd) return;
  if constexpr (kPhase) {
    tile_transform<false>(ey, a, b, tws, NoOp{}, logc, tid, nt);
  } else {
    tile_transform<false>(ey, a, b, tws, m, logc, tid, nt);
  }
}

// K8's transform of one (row tile, pair) whose copies have landed in `cur`
// (`spare` the second buffer, `tws` the twiddle table), on the first nt
// threads. Lane 2r + c of the tile is member c of row r (w0 = a, w1 =
// lambda). IFFT_y of every lane (no operand), then the vbar pass: item q
// is element i = q >> (logc - 1) of row r = q & (2^(logc-1) - 1), whose
// two members are one 16-byte word of the tile, a4[q]; it adds
//   nsig * Im(conj(w1) w0)        (nsig = -sigma / n^2: each member owes 1/n)
// to vb[q], the block's vbar rows in shared memory, zeroed at the row
// tile's first pair (`first`) and stored to the rows of `vbar` below
// m.rows at its last (`final`). The same thread takes the same items at
// every pair, in pair order: no atomics, and the same inputs give the
// same bits. Then by mode:
//   mid, complex plane:  FFT_y, x t / n in the first forward stage's loads
//   mid, phase:          x t / n in the vbar pass (sincosf there, not in a
//                        stage's loads, where it would spill), FFT_y
//   last:                x 1 / n in the vbar pass; the real-space pair is
//                        the result
// The pass loads kU items a thread (the phase's sv too, at a clamped row)
// before it uses any, with no select on a loaded value. The result ends in
// `cur` (mid: 2 nf stages) or, after an odd nf, in `spare` (last). Fenced
// by bar_sync_first(nt); it ends with one.
template <bool kPhase>
__device__ void pair_tile_compute(const MixedEng& ey, float2* cur,
                                  float2* spare, const float2* tws,
                                  float* vb, float* __restrict__ vbar,
                                  const RowT<kPhase, 1>& m, bool last,
                                  bool first, bool final, float nsig,
                                  int logc, int tid, int nt) {
  const int n = ey.n;
  const int logr = logc - 1;
  const int rmask = (1 << logr) - 1;
  const int items = n << logr;
  if (first) {
    for (int q = tid; q < items; q += nt) vb[q] = 0.0f;
  }
  float2* a = cur;
  float2* b = spare;
  tile_transform<true>(ey, a, b, tws, NoOp{}, logc, tid, nt);
  float4* a4 = reinterpret_cast<float4*>(a);
  const bool writes = kPhase || last;     // the pass writes the pair back
  constexpr int kU = 4;
  for (int q0 = tid; q0 < items; q0 += kU * nt) {
    float4 w[kU];
    float2 f[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = min(q0 + u * nt, items - 1);
      w[u] = a4[q];
      if constexpr (kPhase) {
        f[u] = m.at(q >> logr, (q & rmask) << 1);
      } else {
        f[u] = make_float2(m.scale, 0.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = q0 + u * nt;
      if (q < items) {
        const float4 v = w[u];      // (w0.x, w0.y, w1.x, w1.y)
        const float acc = vb[q] + nsig * (v.z * v.y - v.w * v.x);
        if (!final) {
          vb[q] = acc;
        } else if ((q & rmask) < m.rows) {
          vbar[(size_t)(q & rmask) * n + (q >> logr)] = acc;
        }
        if (writes) {
          const float2 w0 = cmul(make_float2(v.x, v.y), f[u]);
          const float2 w1 = cmul(make_float2(v.z, v.w), f[u]);
          a4[q] = make_float4(w0.x, w0.y, w1.x, w1.y);
        }
      }
    }
  }
  bar_sync_first(nt);
  if (last) return;
  if constexpr (kPhase) {
    tile_transform<false>(ey, a, b, tws, NoOp{}, logc, tid, nt);
  } else {
    tile_transform<false>(ey, a, b, tws, m, logc, tid, nt);
  }
}

// --- the persistent walk of K4, K5 and K8 ---------------------------------

// The most threads a block, the producer warps included (the plans keep to
// it, so the register cap is 65536 / 384 = 170), the producer threads, and
// the tile buffers.
constexpr int kMaxThreads = 384;
constexpr int kProducers = 96;
constexpr int kBuffers = 3;

// The persistent walk over n_units units of `per` items each: the block
// takes units u = blockIdx.x + k gridDim.x (the grid at most n_units) and
// each unit's items v = u per + s, s = 0 .. per - 1, in that order. K4 and
// K5: a unit is a (probe, tile) pair and per is 1, so tile u = blockIdx.x
// + k gridDim.x; K8: a unit is a row tile and its items are the pairs, in
// pair order. smem holds three tile buffers of `slots` slots. The block's
// last kProducers threads are the producers: while the other warps, the
// consumers, transform item v in `cur` and `spare` (compute(cur, spare, v,
// tid, nt)), they store the block's previous result from `next` and then
// copy the block's next item into it (cp.async, and wait for the copies);
// a block-wide barrier an item hands the buffers over. The transform ends
// in `cur`, or in `spare` after an odd count of stages (`odd`), and that
// buffer becomes the next item's `next`. tile(s, v) is item v's copy
// (TileCopy, RowTileCopy) in buffer s. Every block of the grid has a unit
// (K6, whose grid fits the larger of its phases, calls it only on blocks
// that have one).
template <class Tile, class Compute>
__device__ void persistent_tiles(float2* smem, size_t slots, int n_units,
                                 int per, bool odd, float2* out, Tile tile,
                                 Compute compute) {
  const int tid = threadIdx.x;
  const int nc = blockDim.x - kProducers;    // consumer threads
  const bool producer = tid >= nc;
  const int b = blockIdx.x;
  const int g = gridDim.x;
  const int n_items = per * ((n_units - 1 - b) / g + 1);
  auto item = [&](int j) {
    const int k = j / per;
    return (b + k * g) * per + (j - k * per);
  };
  float2* cur = smem;                 // this item
  float2* spare = smem + slots;       // the Stockham pair's second buffer
  float2* next = smem + 2 * slots;    // the last result, then the next item
  if (producer) {
    tile(cur, item(0)).issue(tid - nc, kProducers);
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();
  for (int j = 0; j < n_items; ++j) {
    if (!producer) {
      compute(cur, spare, item(j), tid, nc);
    } else {
      if (j > 0) {
        tile(next, item(j - 1)).store(out, tid - nc, kProducers);
        bar_sync_last(kProducers);
      }
      if (j + 1 < n_items) {
        tile(next, item(j + 1)).issue(tid - nc, kProducers);
        cp_async_commit();
        cp_async_wait_all();
      }
    }
    __syncthreads();          // `next` has landed; item j's result is done
    float2* res = odd ? spare : cur;
    float2* other = odd ? cur : spare;
    cur = next;
    spare = other;
    next = res;
  }
  if (producer) tile(next, item(n_items - 1)).store(out, tid - nc, kProducers);
}

// Host: opt `kernel` in to smem bytes of shared memory and size its
// persistent grid, the blocks the occupancy query fits on the card, at
// most `units`. info receives the grid, blocks per SM, SMs and smem.
template <class K>
cudaError_t persistent_grid(K kernel, int block, size_t smem, long units,
                            int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         block, smem);
  }
  if (err != cudaSuccess) return err;
  long grid = (long)per_sm * sms;
  if (grid > units) grid = units;
  info[0] = (int)grid;
  info[1] = per_sm;
  info[2] = sms;
  info[3] = (int)smem;
  return grid < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// Host: whether a tile plan (logc, consumer threads) is one the kernels
// take on an axis of this plan: 1 to 8 lanes, whole consumer warps within
// kMaxThreads with the producers, and a first stage in registers (the one
// that takes the pass's product).
bool plan_ok(const MixedPlan& pl, int logc, int threads) {
  return logc >= 0 && logc <= 3 && threads >= 32 && threads % 32 == 0 &&
         threads + kProducers <= kMaxThreads && pl.nf >= 1 && pl.f[0] <= 31;
}

}  // namespace
