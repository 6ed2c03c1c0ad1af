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
// in and out. K4 has kernel A's four modes and K5 is kernel B, on the tile
// functions of tiles.cuh.
//
// What bounds them on an H100: at 16 x 1023^2 a pass moves the 134 MB wave
// in and out once, ~0.08 ms at 3.35 TB/s (data sheet). The FFT work is
// larger than the pow2 engine's: 1023 = 3 * 11 * 31 runs three register
// stages, the radix-31 one ~8 complex multiply-adds a point with the
// symmetric odd-radix form; a prime above 31, such as 509 (1018 = 2 * 509),
// is a direct sum of ~500 terms a point. Measured (PERF.md): 0.51 ms a
// launch at 16 x 1023^2, against the 0.08 ms floor and cuFFT's 0.71 ms for
// the plain version; 14 ms at 1018^2. The design keeps the wave's
// device-memory traffic at one read and one write per pass; the staging
// through shared memory (~0.2 ms for the "only" mode, with no transform)
// is what a later version would cut.
//
// Shared memory: a tile of 2^logc rows or columns takes two buffers of
// 8 n 2^logc bytes (Stockham ping-pong); the width is chosen so a tile
// stays at or under 64 KB (1023: 4 columns, 65,472 bytes), above the 48 KB
// default, so the launches opt in with cudaFuncSetAttribute.
//
// No fast-math (sincosf for the phase mode, whose arguments run to tens of
// radians). Plain C interface for ctypes: each function launches on the
// given stream and returns the CUDA error as an int.

#include "tiles.cuh"

namespace {

constexpr int kThreads = 256;
// Two blocks an SM: the register cap (128) that allows it costs no spills
// and took K4 and K5 from 2.3 to 1.4 ms at 16 x 1023^2 (PERF.md).
constexpr int kMinBlocks = 2;
constexpr int kSmemLimit = 72 * 1024;

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

// K5: grid (column tiles, probes).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
col_pass_mr_kernel(float2* out, const float2* in,
                   const float2* __restrict__ prop, MixedEng ex, int ny,
                   int logc) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* b = smem + ((size_t)ex.n << logc);
  col_tile(ex, a, b, out, in, prop, blockIdx.y, blockIdx.x << logc, ny, logc,
           threadIdx.x, blockDim.x);
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

int fs_col_pass_mr(void* out, const void* in, const void* prop,
                   const void* tw, int n_probes, int nx, int ny,
                   void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      col_pass_mr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemLimit);
  if (err != cudaSuccess) return (int)err;
  const int logc = mixed_logc(nx);
  const dim3 grid((ny + (1 << logc) - 1) >> logc, n_probes);
  col_pass_mr_kernel<<<grid, kThreads, mixed_tile_bytes(nx, logc),
                       (cudaStream_t)stream>>>(
      (float2*)out, (const float2*)in, (const float2*)prop,
      mixed_eng(tw, nx), ny, logc);
  return (int)cudaGetLastError();
}

}  // extern "C"
