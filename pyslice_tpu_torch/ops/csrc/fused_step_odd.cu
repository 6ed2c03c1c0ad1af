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
// in and out. K4 has kernel A's four modes on row_tile (tiles.cuh); K5 is
// kernel B on its own tile code (col_tile_async.cuh).
//
// What bounds them on an H100: at 16 x 1023^2 a pass moves the 134 MB wave
// in and out once and reads one 8 MB plane, 276 MB, ~0.082 ms at 3.35 TB/s
// (data sheet). The FFT work is larger than the pow2 engine's: 1023 =
// 3 * 11 * 31 runs three register stages, the radix-31 one ~8 complex
// multiply-adds a point with the symmetric odd-radix form; a prime above
// 31, such as 509 (1018 = 2 * 509), is a direct sum of ~500 terms a point.
// K4 (PERF.md): 0.51 ms a launch at 16 x 1023^2, cuFFT's plain version
// 0.71 ms; 14 ms at 1018^2. Its tile's load and store are loops of one
// 8-byte access a thread, fenced by barriers (the "only" mode, staging with
// no transform, takes 0.22 ms).
//
// K5 is built against both. Persistent blocks, one an SM at 1023 (the
// occupancy query), walk the (probe, column tile) pairs, tile u =
// blockIdx.x + k gridDim.x. A block holds three tile buffers: the
// Stockham pair of the tile it transforms and a third, and a copy of the
// twiddle table (the tile copies would evict it from L1). Its warps are
// split: the consumers run the stages, while three producer warps store
// the block's previous result from the third buffer and then copy its
// next tile into it (cp.async), so device memory is read and written
// while the stages run rather than between them. The product with prop / n
// is taken in the first inverse stage's loads, and the DFT constants are
// constant-bank operands (k5_pass). The tile width and the consumer count
// are the host's plan (ops/fused_step_odd.py col_tile_plan): at 1023,
// 8 columns (64-byte row segments, 204,600 bytes with the table) and 288
// consumers, 92% of them busy in the radix-31 stage. Copies and stores are
// 16 bytes where every row segment is 16-byte aligned (even ny), 8 bytes
// otherwise; the 16-byte path is 5-6% faster at 1152^2. Measured
// (PERF.md, scripts/time_col_pass_mr.py, H100 at 700 W): 0.35 ms at
// 16 x 1023^2 against 0.53 ms for the two-blocks-an-SM design it replaced,
// 0.65 against 1.04 ms at 32 planes; bounds 0.082 and 0.162 ms.
//
// Shared memory of K4: a tile of 2^logc rows takes two buffers of
// 8 n 2^logc bytes (Stockham ping-pong); the width is chosen so a tile
// stays at or under 64 KB (1023: 4 rows, 65,472 bytes), above the 48 KB
// default, so the launches opt in with cudaFuncSetAttribute.
//
// No fast-math (sincosf for the phase mode, whose arguments run to tens of
// radians). Plain C interface for ctypes: each function launches on the
// given stream and returns the CUDA error as an int.

#include "col_tile_async.cuh"
#include "tiles.cuh"

namespace {

constexpr int kThreads = 256;
// Two blocks an SM: the register cap (128) that allows it took K4 from 2.3
// to 1.4 ms at 16 x 1023^2 (PERF.md).
constexpr int kMinBlocks = 2;
constexpr int kSmemLimit = 72 * 1024;

// K5: the most threads a block, the producer warps included (the plan
// keeps to it, so the register cap is 65536 / 384 = 170), the producer
// threads, and the tile buffers.
constexpr int kK5MaxThreads = 384;
constexpr int kK5Producers = 96;
constexpr int kK5Buffers = 3;

// Tile width 2^logc for an axis of n: two buffers of 8 n 2^logc bytes
// within 64 KB, 1 to 8 wide.
int mixed_logc(int n) {
  int logc = 0;
  while (logc < 3 && 2 * 8 * n * (2 << logc) <= 65536 + 1024) ++logc;
  return logc;
}

size_t mixed_tile_bytes(int n, int logc) {
  return (size_t)2 * n * (1 << logc) * sizeof(float2);
}

// K4: grid (row tiles, probes).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
row_pass_mr_kernel(float2* out, const float2* in,
                   const float2* __restrict__ t, const float* __restrict__ sv,
                   MixedEng ey, int nx, int logc, int mode) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* b = smem + ((size_t)ey.n << logc);
  row_tile(ey, a, b, out, in, t, sv, blockIdx.y, blockIdx.x << logc, nx,
           logc, mode, threadIdx.x, blockDim.x);
}

// K5: persistent blocks over the n_tiles (probe, column tile) pairs, tpp
// tiles a probe; tile u is columns (u % tpp) << logc .. of probe u / tpp.
// The block's last kK5Producers threads are the producers: while the other
// warps, the consumers, transform tile u in `cur` and `spare`, they store
// the block's previous tile from `next` and then copy tile u + gridDim.x
// into it (cp.async, and wait for the copies); a block-wide barrier a tile
// hands the buffers over. The transform ends in `cur`, which becomes the
// next tile's `next`. The grid is at most n_tiles.
__global__ void __launch_bounds__(kK5MaxThreads, 1)
col_pass_mr_kernel(float2* out, const float2* in,
                   const float2* __restrict__ prop, MixedEng ex, int ny,
                   int logc, int tpp, int n_tiles, int vec16) {
  extern __shared__ __align__(16) float2 smem16[];
  const int tid = threadIdx.x;
  const int nc = blockDim.x - kK5Producers;    // consumer threads
  const bool producer = tid >= nc;
  const int n = ex.n;
  const size_t slots = (size_t)n << logc;
  float2* cur = smem16;               // this tile
  float2* spare = smem16 + slots;     // the Stockham pair's second buffer
  float2* next = smem16 + 2 * slots;  // the last result, then the next tile
  float2* tws = smem16 + 3 * slots;   // the twiddle table
  for (int i = tid; i < n; i += blockDim.x) tws[i] = ex.tw[i];
  auto tile = [&](float2* s, int v) {
    return TileCopy{s, in, n, ny, v / tpp, (v % tpp) << logc, logc,
                    vec16 != 0};
  };
  int u = blockIdx.x;
  if (producer) {
    tile(cur, u).issue(tid - nc, kK5Producers);
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();
  for (; u < n_tiles; u += gridDim.x) {
    const int un = u + gridDim.x;
    if (!producer) {
      const int y0 = (u % tpp) << logc;
      col_tile_compute(ex, cur, spare, tws,
                       TileProp{prop + y0, ny, y0, 1.0f / (float)n}, logc,
                       tid, nc);
    } else {
      if (u != (int)blockIdx.x) {
        tile(next, u - gridDim.x).store(out, tid - nc, kK5Producers);
        bar_sync_last(kK5Producers);
      }
      if (un < n_tiles) {
        tile(next, un).issue(tid - nc, kK5Producers);
        cp_async_commit();
        cp_async_wait_all();
      }
    }
    __syncthreads();          // `next` has landed and `cur` holds tile u
    float2* t = cur;
    cur = next;
    next = t;
  }
  if (producer) tile(next, u - gridDim.x).store(out, tid - nc, kK5Producers);
}

}  // namespace

extern "C" {

int fs_row_pass_mr(void* out, const void* in, const void* t, const void* sv,
                   const void* tw, int n_probes, int nx, int ny, int mode,
                   void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      row_pass_mr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (err != cudaSuccess) return (int)err;
  const int logc = mixed_logc(ny);
  const dim3 grid((nx + (1 << logc) - 1) >> logc, n_probes);
  row_pass_mr_kernel<<<grid, kThreads, mixed_tile_bytes(ny, logc),
                       (cudaStream_t)stream>>>(
      (float2*)out, (const float2*)in, (const float2*)t, (const float*)sv,
      mixed_eng(tw, ny), nx, logc, mode);
  return (int)cudaGetLastError();
}

// K5. logc and threads (the consumers; the block adds the producers):
// the tile plan (ops/fused_step_odd.py col_tile_plan). info receives the
// grid, blocks per SM, SMs and the dynamic shared memory in bytes.
int fs_col_pass_mr(void* out, const void* in, const void* prop,
                   const void* tw, int n_probes, int nx, int ny, int logc,
                   int threads, int* info, void* stream) {
  const MixedEng ex = mixed_eng(tw, nx);
  const int block = threads + kK5Producers;
  if (logc < 0 || logc > 3 || threads < 32 || block > kK5MaxThreads ||
      threads % 32 != 0 || ex.plan.nf < 2 || ex.plan.f[0] > 31) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem =
      (kK5Buffers * ((size_t)nx << logc) + nx) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      col_pass_mr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, col_pass_mr_kernel, block, smem);
  }
  if (err != cudaSuccess) return (int)err;
  const int tpp = (ny + (1 << logc) - 1) >> logc;
  const long tiles = (long)n_probes * tpp;
  long grid = (long)per_sm * sms;
  if (grid > tiles) grid = tiles;
  info[0] = (int)grid;
  info[1] = per_sm;
  info[2] = sms;
  info[3] = (int)smem;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  const int vec16 = logc >= 1 && ny % 2 == 0 &&
                    (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0;
  col_pass_mr_kernel<<<(unsigned)grid, block, smem,
                       (cudaStream_t)stream>>>(
      (float2*)out, (const float2*)in, (const float2*)prop, ex, ny, logc,
      tpp, (int)tiles, vec16);
  return (int)cudaGetLastError();
}

}  // extern "C"
