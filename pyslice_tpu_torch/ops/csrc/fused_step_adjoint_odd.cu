// Kernel K8 for Hopper (sm_90a): the backward row pass of the O(1)-memory
// multislice adjoint on grids whose axes are not powers of two.
//
// Replaces the Pallas TPU kernel of pyslice_tpu/ops/fused_step_adjoint.py:
//   K8  pair-packed row pass, odd grids  <- _kernel_a_bwd_odd via
//       _call_a_bwd_odd (pallas_call at fused_step_adjoint.py:346)
//
// The same work as K7 (fused_step_adjoint.cu; tiles.cuh: pair_row_tile) on
// the mixed-radix Stockham engine of fft_mixed.cuh, which K4 and K5 use:
// the pair stream, the transmission plane and vbar all stay in natural
// order. The TPU kernel's digit-split tiles and its (dx, mx, dy, my) vbar
// stripe layout were limits of Pallas on the TPU and are not carried over.
//
// What bounds it on an H100: the pair stream in and out once, ~0.27 GB or
// ~0.08 ms at 3.35 TB/s for 16 pairs x 1023^2 (data sheet), and the
// mixed-radix FFT work, which for the one-block-a-tile K4 at 16 x 1023^2
// was 0.51 ms a launch against that floor (PERF.md). K8 does that K4's
// mid-mode work on twice the rows, so it should take about twice its
// time; the vbar sum adds one multiply-add a point and one store a plane.
// K4 has since become a persistent kernel with producer warps
// (tile_async.cuh), whose row tile K8 does not share yet.
//
// Shared memory: two Stockham buffers of 2^(logr+1) columns plus the vbar
// rows: 73,656 bytes at 1023 (two rows), above the 48 KB default, so the
// launch opts in with cudaFuncSetAttribute (up to ~144 KB at 4096, one
// row). Two blocks an SM (__launch_bounds__(256, 2)).
//
// No fast-math (sincosf for the phase mode). Plain C interface for ctypes:
// the function launches on the given stream and returns the CUDA error as
// an int.

#include "tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
row_pass_bwd_mr_kernel(float2* out, const float2* in,
                       const float2* __restrict__ t,
                       const float* __restrict__ sv, float* __restrict__ vbar,
                       MixedEng ey, int n_pairs, int nx, int logr, int last,
                       float nsigma) {
  extern __shared__ float2 smem[];
  const size_t cols = (size_t)ey.n << (logr + 1);
  pair_row_tile(ey, smem, smem + cols, (float*)(smem + 2 * cols), out, in, t,
                sv, vbar, n_pairs, blockIdx.x << logr, nx, logr, last != 0,
                nsigma, threadIdx.x, blockDim.x);
}

}  // namespace

extern "C" {

int fs_row_pass_bwd_mr(void* out, const void* in, const void* t,
                       const void* sv, void* vbar, const void* tw,
                       int n_pairs, int nx, int ny, int last, float nsigma,
                       void* stream) {
  const int logr = pair_tile_logr<MixedEng>(ny);
  const size_t bytes = pair_tile_bytes<MixedEng>(ny, logr);
  const cudaError_t err = cudaFuncSetAttribute(
      row_pass_bwd_mr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (nx + (1 << logr) - 1) >> logr;
  row_pass_bwd_mr_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (float2*)out, (const float2*)in, (const float2*)t, (const float*)sv,
      (float*)vbar, mixed_eng(tw, ny), n_pairs, nx, logr, last, nsigma);
  return (int)cudaGetLastError();
}

}  // extern "C"
