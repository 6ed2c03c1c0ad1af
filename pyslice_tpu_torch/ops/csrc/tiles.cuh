// The per-tile work of the slice step, written once for both FFT engines
// (Pow2Eng of fft_pow2.cuh, MixedEng of fft_mixed.cuh): row_tile, col_tile
// and kconv_tile for the resident slice loop K6 (resident.cu, both
// engines). The persistent mixed-radix passes K4 and K5 (fused_step_odd.cu)
// and K8 (fused_step_adjoint_odd.cu) have their own tiles
// (tile_async.cuh), and so do A, B (fused_step.cu) and K7
// (fused_step_adjoint.cu), on the register-resident engine of
// fft_regs.cuh.
//
// An engine E gives: E::n, the axis length; row(i), the slot row of
// element i in a tile (s[(row(i) << logc) + c]); kslot(k), the element
// index at which frequency k sits after the forward transform
// (bit-reversed for Pow2Eng, k itself for MixedEng); fwd / inv on the tile
// in buffer a with b as the spare, returning the buffer with the result.
//
// The wave is (P, nx, ny) complex64 in natural order at every tile
// boundary. Each tile function syncs on entry (the previous tile's reads
// of shared memory are done) and reads its whole tile before it writes,
// so `out` may equal `in`.

#pragma once

#include "fft_mixed.cuh"
#include "fft_pow2.cuh"

namespace {

// Row tile: rows x0 .. x0 + 2^logc - 1 of probe p, one transform along y
// each (ny = ey.n), side by side as the tile's columns. Modes (as kernel A):
//   first: x t, FFT_y      mid: IFFT_y, x t, FFT_y
//   last:  IFFT_y, x t     only: x t
// t is the (nx, ny) complex plane of this slice, or, when t == nullptr,
// sv is the phase sigma*V from which cos/sin are taken here. Rows past nx
// (the ragged last tile) are zero-filled and not stored.
template <class E>
__device__ void row_tile(const E& ey, float2* a, float2* b, float2* out,
                         const float2* in, const float2* __restrict__ t,
                         const float* __restrict__ sv, int p, int x0, int nx,
                         int logc, int mode, int tid, int nt) {
  const int n = ey.n;
  const int tot = n << logc;
  const bool inv = (mode == kMid || mode == kLast);
  const bool fwd = (mode == kFirst || mode == kMid);
  const size_t plane = (size_t)p * nx;
  __syncthreads();
  for (int q = tid; q < tot; q += nt) {
    const int r = q / n;
    const int i = q - r * n;
    const int x = x0 + r;
    a[(ey.row(inv ? ey.kslot(i) : i) << logc) + r] =
        x < nx ? in[(plane + x) * n + i] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  float2* s = inv ? ey.inv(a, b, logc, tid, nt) : a;
  const float scale = inv ? 1.0f / (float)n : 1.0f;
  for (int q = tid; q < tot; q += nt) {
    const int r = q / n;
    const int i = q - r * n;
    const int x = x0 + r;
    if (x >= nx) continue;
    const size_t ti = (size_t)x * n + i;
    float2 tv;
    if (t != nullptr) {
      tv = t[ti];
    } else {
      sincosf(sv[ti], &tv.y, &tv.x);
    }
    const int si = (ey.row(i) << logc) + r;
    const float2 v = cscale(cmul(s[si], tv), scale);
    if (fwd) {
      s[si] = v;
    } else {
      out[(plane + x) * n + i] = v;
    }
  }
  if (!fwd) return;
  __syncthreads();
  const float2* o = ey.fwd(s, s == a ? b : a, logc, tid, nt);
  for (int q = tid; q < tot; q += nt) {
    const int r = q / n;
    const int i = q - r * n;
    const int x = x0 + r;
    if (x < nx) out[(plane + x) * n + i] = o[(ey.row(ey.kslot(i)) << logc) + r];
  }
}

// Column tile: columns y0 .. y0 + 2^logc - 1 of probe p (nx = ex.n rows).
// FFT_x, x prop / nx, IFFT_x; prop is the natural-order (nx, ny) Fresnel
// plane. Columns past ny are zero-filled and not stored.
template <class E>
__device__ void col_tile(const E& ex, float2* a, float2* b, float2* out,
                         const float2* in, const float2* __restrict__ prop,
                         int p, int y0, int ny, int logc, int tid, int nt) {
  const int n = ex.n;
  const int cmask = (1 << logc) - 1;
  const int tot = n << logc;
  const size_t plane = (size_t)p * n * ny;
  __syncthreads();
  for (int q = tid; q < tot; q += nt) {
    const int i = q >> logc;
    const int y = y0 + (q & cmask);
    a[(ex.row(i) << logc) + (q & cmask)] =
        y < ny ? in[plane + (size_t)i * ny + y] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  float2* s = ex.fwd(a, b, logc, tid, nt);
  const float scale = 1.0f / (float)n;
  for (int q = tid; q < tot; q += nt) {
    const int kx = q >> logc;
    const int y = y0 + (q & cmask);
    if (y >= ny) continue;
    const int si = (ex.row(ex.kslot(kx)) << logc) + (q & cmask);
    s[si] = cmul(s[si], cscale(prop[(size_t)kx * ny + y], scale));
  }
  __syncthreads();
  const float2* o = ex.inv(s, s == a ? b : a, logc, tid, nt);
  for (int q = tid; q < tot; q += nt) {
    const int i = q >> logc;
    const int y = y0 + (q & cmask);
    if (y < ny) out[plane + (size_t)i * ny + y] = o[(ex.row(i) << logc) + (q & cmask)];
  }
}

// k-space tile: FFT_x of columns y0 .. of probe p, stored fftshifted over
// both axes: frequency (kx, y) goes to ((kx + nx/2) mod nx,
// (y + ny/2) mod ny), the store form of fftshift, right for odd and even
// lengths alike. `out` must not alias `in`.
template <class E>
__device__ void kconv_tile(const E& ex, float2* a, float2* b,
                           float2* __restrict__ out, const float2* in, int p,
                           int y0, int ny, int logc, int tid, int nt) {
  const int n = ex.n;
  const int cmask = (1 << logc) - 1;
  const int tot = n << logc;
  const size_t plane = (size_t)p * n * ny;
  __syncthreads();
  for (int q = tid; q < tot; q += nt) {
    const int i = q >> logc;
    const int y = y0 + (q & cmask);
    a[(ex.row(i) << logc) + (q & cmask)] =
        y < ny ? in[plane + (size_t)i * ny + y] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  const float2* s = ex.fwd(a, b, logc, tid, nt);
  for (int q = tid; q < tot; q += nt) {
    const int kx = q >> logc;
    const int y = y0 + (q & cmask);
    if (y >= ny) continue;
    const int ox = kx + (n >> 1) < n ? kx + (n >> 1) : kx + (n >> 1) - n;
    const int oy = y + (ny >> 1) < ny ? y + (ny >> 1) : y + (ny >> 1) - ny;
    out[plane + (size_t)ox * ny + oy] =
        s[(ex.row(ex.kslot(kx)) << logc) + (q & cmask)];
  }
}

}  // namespace
