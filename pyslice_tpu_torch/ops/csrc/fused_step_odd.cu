// Mixed-radix slice-step kernels K4 and K5 for Hopper (sm_90a): the
// two-pass chain on grids whose axes are not powers of two.
//
// Replaces the Pallas TPU kernels of pyslice_tpu/ops/fused_step_odd.py:
//   K4  row pass     <- _kernel_a via _call_a  (pallas_call at fused_step_odd.py:272)
//   K5  column pass  <- _kernel_b via _call_b  (pallas_call at fused_step_odd.py:304)
//
// The TPU kernels split each axis n = d * m into digit tiles, so that every
// access is a static middle-dimension index and stage 2 is an (m, m) MXU
// matrix product; the wave moves between kernels in digit-scrambled
// layouts. None of that is needed here: the wave stays (P, nx, ny)
// complex64 in natural order at every kernel boundary, and each transform
// is the Stockham engine of fft_mixed.cuh in shared memory, natural order
// in and out. Both kernels run on the tile code of tile_async.cuh: K4 is
// kernel A's four modes on row tiles, K5 kernel B on column tiles.
//
// What bounds them on an H100: at 16 x 1023^2 a pass moves the 134 MB wave
// in and out once and reads one 8 MB plane, 276 MB, ~0.082 ms at 3.35 TB/s
// (data sheet). The FFT work is larger than the pow2 engine's: 1023 =
// 3 * 11 * 31 runs three register stages, the radix-31 one ~8 complex
// multiply-adds a point with the symmetric odd-radix form; a prime above
// 31, such as 509 (1018 = 2 * 509), is a direct sum of ~500 terms a point,
// which loses to the plain torch.fft passes at every such prime measured
// (37 to 509), so dispatch sends those axes to the plain loop
// (fused_step_odd.py kernel_preferred_mr; PERF.md).
//
// Both kernels have one design, which K8 (fused_step_adjoint_odd.cu)
// shares: the walk persistent_tiles and its sizing persistent_grid live in
// tile_async.cuh. Persistent blocks, one an SM at 1023 (the
// occupancy query), walk the (probe, tile) pairs, tile u = blockIdx.x +
// k gridDim.x, probe-major: the blocks in flight cover about one probe,
// and the next probe reads the t or prop plane (8 MB at 1023^2) again
// while it can still sit in the 50 MB L2. A block holds three tile
// buffers: the Stockham pair
// of the tile it transforms and a third, and a copy of the twiddle table
// (the tile copies would evict it from L1). Its warps are split: the
// consumers run the stages, while three producer warps store the block's
// previous result from the third buffer and then copy its next tile into
// it (cp.async), so device memory is read and written while the stages run
// rather than between them. The DFT constants are constant-bank operands
// (tile_pass), and the pass's product is taken in a stage's loads. The
// tile width and the consumer count are the host's plan
// (ops/fused_step_odd.py tile_plan): at 1023, 8 lanes
// (204,600 bytes with the table) and 288 consumers, 92% of them busy in
// the radix-31 stage; the tile narrows to 4 lanes from 1163 and to 2 from
// 2236 (4096: 229,376 bytes).
//
// K5 (a tile is 2^logc columns): FFT_x, x prop / n in the first inverse
// stage's loads, IFFT_x. Copies and stores are 16 bytes where every row
// segment is 16-byte aligned (even ny), 8 bytes otherwise; the 16-byte
// path is 5-6% faster at 1152^2. Measured (PERF.md,
// scripts/time_col_pass_mr.py, H100 at 700 W): 0.35 ms at 16 x 1023^2
// against 0.53 ms for the two-blocks-an-SM design it replaced, 0.65
// against 1.04 ms at 32 planes; bounds 0.082 and 0.162 ms. On the axes
// whose stages split into two odd groups of at most 33 values and for
// which it is built (1023, 513), K5 runs instead on the register engine
// of fft_regs_mr.cuh (col_pass_mr_reg_kernel): 0.21 ms at 16 x 1023^2,
// 0.39 at 32 planes (PERF.md).
//
// K4 (a tile is 2^logc rows, each one transform along y): kernel A's
// modes, x t (/ ny) in the first forward stage's loads (first, mid), or
// in a pass of its own after the inverse stages (last) or alone (only); t
// is the complex plane or the phase sigma*V (sincosf in the loads). A
// row tile is one contiguous span of device memory, but its slots put a
// row's neighbouring elements 2^logc apart, so its copies are 8 bytes
// each, a warp's 32 filling 32 neighbouring slots. Its time is in PERF.md
// beside the one-block-a-tile K4 it replaced (0.51 ms at 16 x 1023^2,
// whose synchronous loads and stores, fenced by barriers, took 0.22 ms
// with no transform at all). On the axes of REG_MR_AXES K4 runs instead on
// the register engine of fft_regs_mr.cuh (row_pass_mr_reg_kernel, rows
// of n = N1 x N2): in mid the inverse leaves each thread holding the
// positions from which the forward's first stage starts, so x t / n is
// taken in registers between the two transforms, two exchanges a row:
// 0.22 ms at 16 x 1023^2 against the tiles' 0.35 (PERF.md).
//
// No fast-math (sincosf for the phase mode, whose arguments run to tens of
// radians). Plain C interface for ctypes: each function launches on the
// given stream and returns the CUDA error as an int.

#include "fft_regs_mr.cuh"
#include "tile_async.cuh"

namespace {

// K5: tile u is columns (u % tpp) << logc .. of probe u / tpp, tpp tiles
// a probe; FFT_x, x prop / n, IFFT_x (col_tile_compute, 2 nf stages).
__global__ void __launch_bounds__(kMaxThreads, 1)
col_pass_mr_kernel(float2* out, const float2* in,
                   const float2* __restrict__ prop, MixedEng ex, int ny,
                   int logc, int tpp, int n_tiles, int vec16) {
  extern __shared__ __align__(16) float2 smem16[];
  const int n = ex.n;
  const size_t slots = (size_t)n << logc;
  float2* tws = smem16 + 3 * slots;   // the twiddle table
  for (int i = threadIdx.x; i < n; i += blockDim.x) tws[i] = ex.tw[i];
  persistent_tiles(
      smem16, slots, n_tiles, 1, false, out,
      [&](float2* s, int v) {
        return TileCopy{s, in, n, ny, v / tpp, (v % tpp) << logc, logc,
                        vec16 != 0};
      },
      [&](float2* cur, float2* spare, int u, int tid, int nt) {
        const int y0 = (u % tpp) << logc;
        col_tile_compute(ex, cur, spare, tws,
                         TileProp{prop + y0, ny, y0, 1.0f / (float)n}, logc,
                         tid, nt);
      });
}

// K4: tile u is rows (u % tpp) << logc .. of probe u / tpp (rows of ny =
// ey.n), tpp tiles a probe; kernel A's `mode` (row_tile_compute). t is the
// (nx, ny) complex plane or, with kPhase, sv the phase.
template <bool kPhase>
__global__ void __launch_bounds__(kMaxThreads, 1)
row_pass_mr_kernel(float2* out, const float2* in,
                   const float2* __restrict__ t, const float* __restrict__ sv,
                   MixedEng ey, int nx, int logc, int tpp, int n_tiles,
                   int mode) {
  extern __shared__ __align__(16) float2 smem16[];
  const int n = ey.n;
  const size_t slots = (size_t)n << logc;
  float2* tws = smem16 + 3 * slots;   // the twiddle table
  for (int i = threadIdx.x; i < n; i += blockDim.x) tws[i] = ey.tw[i];
  // stages: nf for first and last, 2 nf for mid, none for only
  const bool odd = (mode == kFirst || mode == kLast) && (ey.plan.nf & 1);
  const float scale = (mode == kMid || mode == kLast) ? 1.0f / (float)n
                                                      : 1.0f;
  persistent_tiles(
      smem16, slots, n_tiles, 1, odd, out,
      [&](float2* s, int v) {
        return RowTileCopy<0>{s, in, n, nx, v / tpp, (v % tpp) << logc,
                              logc};
      },
      [&](float2* cur, float2* spare, int u, int tid, int nt) {
        const size_t x0 = (size_t)((u % tpp) << logc);
        const RowT<kPhase> m{kPhase ? nullptr : t + x0 * n,
                             kPhase ? sv + x0 * n : nullptr, n,
                             nx - (int)x0, scale};
        row_tile_compute(ey, cur, spare, tws, m, mode, logc, tid, nt);
      });
}

// K5 on the register engine of fft_regs_mr.cuh, for the axes of
// REG_MR_AXES (ops/fused_step_odd.py: 1023 = 31 | 11 x 3, 513 = 19 | 3 x 3
// x 3). Tile u is columns (u % tpp) << kMrLogc .. of probe u / tpp;
// thread tid is lane c = tid mod 2^kMrLogc, the tile's column y, and
// t = tid >> kMrLogc of the T a transform, so a warp's loads are four row
// segments of the tile's eight columns (B's layout). Thread t < N2 loads
// rows t + N2 m of its column straight into registers; FFT_x, x prop / n,
// IFFT_x; the thread stores the rows it loaded. prop is read at the rows
// the thread holds after the forward, every load issued before the
// forward's second stage: with one block an SM (168 registers at 1023)
// nothing else on the SM would hide them. Both transforms exchange
// through one buffer (slot e 2^kMrLogc + c), four barriers a tile: a
// second buffer (two barriers) ran 5-6% slower at 1023 (PERF.md), its
// 65 KB taken from the SM's L1. A column past ny (the last tile) reads
// column ny - 1 and stores nothing. `out` may equal `in`: a tile is read
// whole before any of it is written.
constexpr int kMrLogc = 3;

template <int R1, int... R2>
__global__ void __launch_bounds__(MrAxis<R1, R2...>::T << kMrLogc, 1)
col_pass_mr_reg_kernel(float2* out, const float2* in,
                       const float2* __restrict__ prop,
                       const float2* __restrict__ tw, int ny, int tpp,
                       int n_tiles) {
  using Ax = MrAxis<R1, R2...>;
  constexpr int n = Ax::n;
  constexpr int logc = kMrLogc;
  extern __shared__ __align__(16) float2 smem16[];
  float2* tws = smem16 + (n << logc);     // after the exchange buffer
  mr_table<Ax>(tws, tw);
  const int c = threadIdx.x & ((1 << logc) - 1);
  const int t = threadIdx.x >> logc;
  float2* const xc = smem16 + c;
  const auto xs = [&](int e) { return xc + (e << logc); };
  const float scale = 1.0f / (float)n;
  const int step = Ax::N2 * ny;    // below 2^31 / kMrE: n ny <= 4096^2
  const int pstep = Ax::N1 * ny;
  __syncthreads();
  for (int u = blockIdx.x; u < n_tiles; u += gridDim.x) {
    const int y = ((u % tpp) << logc) + c;
    const int yc = min(y, ny - 1);
    const size_t col = (size_t)(u / tpp) * n * ny + (size_t)t * ny + yc;
    const float2* pr = prop + (size_t)t * ny + yc;
    float2 v[kMrE];
    if (t < Ax::N2) {
#pragma unroll
      for (int m = 0; m < Ax::N1; ++m) v[m] = in[col + m * step];
      mr_fwd_first<Ax>(v, t, xs);
    }
    __syncthreads();
    if (t < Ax::N1) {
      float2 f[Ax::N2];
#pragma unroll
      for (int q = 0; q < Ax::N2; ++q) f[q] = __ldg(&pr[q * pstep]);
      mr_fwd_second<Ax>(v, t, xs, tws);
#pragma unroll
      for (int q = 0; q < Ax::N2; ++q) v[q] = cscale(cmul(v[q], f[q]), scale);
      Ax::template group<true>(v);
    }
    __syncthreads();    // the forward's reads are done
    if (t < Ax::N1) mr_inv_put<Ax>(v, t, xs);
    __syncthreads();
    if (t < Ax::N2) {
      float2* dst = out + col;
      mr_inv_second<Ax>(v, t, xs, tws, [&](int q, float2 x) {
        if (y < ny) dst[q * step] = x;
      });
    }
    __syncthreads();    // the inverse's reads are done
  }
}

// Host: launch K5's register kernel on the axis R1 | R2... (see
// fs_col_pass_mr_reg).
template <int R1, int... R2>
int launch_col_reg(float2* out, const float2* in, const float2* prop,
                   const float2* tw, int n_probes, int ny, int logc,
                   int threads, int* info, cudaStream_t stream) {
  using Ax = MrAxis<R1, R2...>;
  if (logc != kMrLogc || threads != Ax::T << kMrLogc) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = col_pass_mr_reg_kernel<R1, R2...>;
  const size_t smem = mr_reg_smem(Ax::n, kMrLogc);
  const int tpp = (ny + (1 << kMrLogc) - 1) >> kMrLogc;
  const long tiles = (long)n_probes * tpp;
  const cudaError_t err = persistent_grid(kernel, threads, smem, tiles, info);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)info[0], threads, smem, stream>>>(out, in, prop, tw, ny,
                                                       tpp, (int)tiles);
  return (int)cudaGetLastError();
}

// K4 on the register engine, for the axes of REG_MR_AXES (ny = N1 x N2).
// Tile u is rows (u % tpp) << kMrLogc .. of probe u / tpp; thread tid is
// the tile's row c = tid / T and k = tid mod T of the T a transform, so a
// warp's threads walk neighbouring elements of a row (a row is contiguous:
// the reverse of K5's lane-fastest map). The exchange keeps the rows one
// after another (slot c n + e): with n, N1 and N2 odd, a half warp's
// 8-byte accesses fall on distinct banks at every step but where it spans
// two rows. By mode:
//   first  thread k < N2 loads x[k + N2 m] and t there, x t, the forward
//          (one exchange); thread j < N1 stores X[j + N1 q]
//   mid    thread j < N1 loads X[j + N1 r], the inverse's radix-N2 group,
//          the exchange; thread k < N2 then holds x[k + N2 q], the forward's
//          first stage's inputs, takes x t / n in registers, and the forward
//          follows (two exchanges through one buffer, four barriers a tile);
//          thread j stores X[j + N1 q], the positions it loaded
//   last   the inverse, x t / n, thread k stores x[k + N2 q] (one exchange)
//   only   thread k < N2: x t at x[k + N2 m], no exchange
// t is the complex plane or, with kPhase, sv the phase (sincosf where the
// factor is used). Its loads are issued before the inverse's second stage
// (or with the wave's, in first and only): with one block an SM nothing
// else on the SM would hide them. A row past nx (the last tile) reads row
// nx - 1 and stores nothing. `out` may equal `in`: a row is read whole
// before any of it is written.
template <bool kPhase, int R1, int... R2>
__global__ void __launch_bounds__(MrAxis<R1, R2...>::T << kMrLogc, 1)
row_pass_mr_reg_kernel(float2* out, const float2* in,
                       const float2* __restrict__ t,
                       const float* __restrict__ sv,
                       const float2* __restrict__ tw, int nx, int tpp,
                       int n_tiles, int mode) {
  using Ax = MrAxis<R1, R2...>;
  constexpr int n = Ax::n;
  constexpr int N1 = Ax::N1;
  constexpr int N2 = Ax::N2;
  extern __shared__ __align__(16) float2 smem16[];
  float2* tws = smem16 + (n << kMrLogc);     // after the exchange buffer
  mr_table<Ax>(tws, tw);
  const int c = threadIdx.x / Ax::T;
  const int k = threadIdx.x - c * Ax::T;
  float2* const xr = smem16 + c * n;
  const auto xs = [&](int e) { return xr + e; };
  const bool inv = mode == kMid || mode == kLast;
  const bool fwd = mode == kFirst || mode == kMid;
  const float scale = inv ? 1.0f / (float)n : 1.0f;
  __syncthreads();
  for (int u = blockIdx.x; u < n_tiles; u += gridDim.x) {
    const int x = ((u % tpp) << kMrLogc) + c;
    const int xc = min(x, nx - 1);
    const size_t row = ((size_t)(u / tpp) * nx + xc) * n;
    const float2* src = in + row;
    float2* dst = out + row;
    float2 v[kMrE];
    if (inv) {
      if (k < N1) {
#pragma unroll
        for (int r = 0; r < N2; ++r) v[r] = src[k + N1 * r];
        Ax::template group<true>(v);
        mr_inv_put<Ax>(v, k, xs);
      }
      __syncthreads();
    }
    if (k < N2) {
      // t at x[k + N2 m], m < N1: the plane's values, or the phase's
      float2 f[N1];
      float p[N1];
      const size_t tk = (size_t)xc * n + k;
#pragma unroll
      for (int m = 0; m < N1; ++m) {
        if constexpr (kPhase) {
          p[m] = __ldg(&sv[tk + N2 * m]);
        } else {
          f[m] = __ldg(&t[tk + N2 * m]);
        }
      }
      if (inv) {
        mr_inv_second<Ax>(v, k, xs, tws, [&](int m, float2 y) { v[m] = y; });
      } else {
#pragma unroll
        for (int m = 0; m < N1; ++m) v[m] = src[k + N2 * m];
      }
#pragma unroll
      for (int m = 0; m < N1; ++m) {
        float2 w;
        if constexpr (kPhase) {
          sincosf(p[m], &w.y, &w.x);
        } else {
          w = f[m];
        }
        v[m] = cscale(cmul(v[m], w), scale);
      }
      if (!fwd && x < nx) {
#pragma unroll
        for (int m = 0; m < N1; ++m) dst[k + N2 * m] = v[m];
      }
    }
    if (inv) __syncthreads();    // the inverse's reads are done
    if (!fwd) continue;
    if (k < N2) mr_fwd_first<Ax>(v, k, xs);
    __syncthreads();
    if (k < N1) {
      mr_fwd_second<Ax>(v, k, xs, tws);
      if (x < nx) {
#pragma unroll
        for (int q = 0; q < N2; ++q) dst[k + N1 * q] = v[q];
      }
    }
    __syncthreads();    // the forward's reads are done
  }
}

// Host: launch K4's register kernel on the axis R1 | R2... (see
// fs_row_pass_mr_reg).
template <int R1, int... R2>
int launch_row_reg(float2* out, const float2* in, const float2* t,
                   const float* sv, const float2* tw, int n_probes, int nx,
                   int mode, int logc, int threads, int* info,
                   cudaStream_t stream) {
  using Ax = MrAxis<R1, R2...>;
  if (logc != kMrLogc || threads != Ax::T << kMrLogc || mode < kFirst ||
      mode > kOnly) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = sv != nullptr ? row_pass_mr_reg_kernel<true, R1, R2...>
                                    : row_pass_mr_reg_kernel<false, R1, R2...>;
  const size_t smem = mr_reg_smem(Ax::n, kMrLogc);
  const int tpp = (nx + (1 << kMrLogc) - 1) >> kMrLogc;
  const long tiles = (long)n_probes * tpp;
  const cudaError_t err = persistent_grid(kernel, threads, smem, tiles, info);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)info[0], threads, smem, stream>>>(out, in, t, sv, tw, nx,
                                                       tpp, (int)tiles, mode);
  return (int)cudaGetLastError();
}

// Host: the shared memory of a tile of 2^logc lanes of n and the table.
size_t tile_smem(int n, int logc) {
  return (kBuffers * ((size_t)n << logc) + n) * sizeof(float2);
}

}  // namespace

extern "C" {

// K4. t the complex plane, or sv the phase (t null). logc and threads
// (the consumers; the block adds the producers): the tile plan
// (ops/fused_step_odd.py tile_plan). info receives the grid, blocks
// per SM, SMs and the dynamic shared memory in bytes.
int fs_row_pass_mr(void* out, const void* in, const void* t, const void* sv,
                   const void* tw, int n_probes, int nx, int ny, int mode,
                   int logc, int threads, int* info, void* stream) {
  const MixedEng ey = mixed_eng(tw, ny);
  if (!plan_ok(ey.plan, logc, threads) || mode < kFirst || mode > kOnly) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = tile_smem(ny, logc);
  const int block = threads + kProducers;
  const int tpp = (nx + (1 << logc) - 1) >> logc;
  const long tiles = (long)n_probes * tpp;
  const auto kernel = sv != nullptr ? row_pass_mr_kernel<true>
                                    : row_pass_mr_kernel<false>;
  const cudaError_t err = persistent_grid(kernel, block, smem, tiles, info);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)info[0], block, smem, (cudaStream_t)stream>>>(
      (float2*)out, (const float2*)in, (const float2*)t, (const float*)sv,
      ey, nx, logc, tpp, (int)tiles, mode);
  return (int)cudaGetLastError();
}

// K5. logc and threads (the consumers; the block adds the producers):
// the tile plan (ops/fused_step_odd.py tile_plan). info receives the
// grid, blocks per SM, SMs and the dynamic shared memory in bytes.
int fs_col_pass_mr(void* out, const void* in, const void* prop,
                   const void* tw, int n_probes, int nx, int ny, int logc,
                   int threads, int* info, void* stream) {
  const MixedEng ex = mixed_eng(tw, nx);
  if (!plan_ok(ex.plan, logc, threads) || ex.plan.nf < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = tile_smem(nx, logc);
  const int block = threads + kProducers;
  const int tpp = (ny + (1 << logc) - 1) >> logc;
  const long tiles = (long)n_probes * tpp;
  const cudaError_t err =
      persistent_grid(col_pass_mr_kernel, block, smem, tiles, info);
  if (err != cudaSuccess) return (int)err;
  const int vec16 = logc >= 1 && ny % 2 == 0 &&
                    (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0;
  col_pass_mr_kernel<<<(unsigned)info[0], block, smem,
                       (cudaStream_t)stream>>>(
      (float2*)out, (const float2*)in, (const float2*)prop, ex, ny, logc,
      tpp, (int)tiles, vec16);
  return (int)cudaGetLastError();
}

// K5 on the register engine, for an axis nx of REG_MR_AXES
// (ops/fused_step_odd.py col_plan): logc and threads, the plan's lanes
// (log2) and block, must be those of the axis's instantiation below; tw
// the full twiddle table of nx. info as K5's. Any other axis or plan is
// refused (cudaErrorInvalidValue).
int fs_col_pass_mr_reg(void* out, const void* in, const void* prop,
                       const void* tw, int n_probes, int nx, int ny,
                       int logc, int threads, int* info, void* stream) {
  float2* o = (float2*)out;
  const float2* i = (const float2*)in;
  const float2* p = (const float2*)prop;
  const float2* w = (const float2*)tw;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (nx) {
    case 1023:
      return launch_col_reg<31, 11, 3>(o, i, p, w, n_probes, ny, logc,
                                       threads, info, s);
    case 513:
      return launch_col_reg<19, 3, 3, 3>(o, i, p, w, n_probes, ny, logc,
                                         threads, info, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K4 on the register engine, for an axis ny of REG_MR_AXES
// (ops/fused_step_odd.py row_plan): the arguments of fs_row_pass_mr, logc
// and threads those of the axis's instantiation below; tw the full
// twiddle table of ny. Any other axis, plan or mode is refused
// (cudaErrorInvalidValue).
int fs_row_pass_mr_reg(void* out, const void* in, const void* t,
                       const void* sv, const void* tw, int n_probes, int nx,
                       int ny, int mode, int logc, int threads, int* info,
                       void* stream) {
  float2* o = (float2*)out;
  const float2* i = (const float2*)in;
  const float2* tp = (const float2*)t;
  const float* ph = (const float*)sv;
  const float2* w = (const float2*)tw;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ny) {
    case 1023:
      return launch_row_reg<31, 11, 3>(o, i, tp, ph, w, n_probes, nx, mode,
                                       logc, threads, info, s);
    case 513:
      return launch_row_reg<19, 3, 3, 3>(o, i, tp, ph, w, n_probes, nx, mode,
                                         logc, threads, info, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
