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
// against 1.04 ms at 32 planes; bounds 0.082 and 0.162 ms.
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
// with no transform at all).
//
// No fast-math (sincosf for the phase mode, whose arguments run to tens of
// radians). Plain C interface for ctypes: each function launches on the
// given stream and returns the CUDA error as an int.

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

}  // extern "C"
