// Kernel K7 for Hopper (sm_90a): the backward row pass of the O(1)-memory
// multislice adjoint, on power-of-two grids.
//
// Replaces the Pallas TPU kernel of pyslice_tpu/ops/fused_step_adjoint.py:
//   K7  pair-packed row pass  <- _kernel_a_bwd via _call_a_bwd
//                                (pallas_call at fused_step_adjoint.py:148)
//
// The backward chain (ops/fused_step_adjoint.py) runs the conjugated slice
// step on a stream of (a, lambda) pairs, (2 P, nx, ny) complex64 with rows
// 2p and 2p + 1 holding pair p, in natural order at every kernel boundary.
// Kernels A (entry) and B (column pass) of fused_step.cu serve it as they
// are, with conj(t) and conj(P); K7 is the one new piece: between its IFFT_y
// and the next transmission it holds the real-space pair, where the
// potential cotangent row
//     vbar(x, :) = -sigma * sum_p Im(conj(lambda_p) a_p)
// is a product of values already in shared memory. The TPU kernel summed it
// over a sequential pair grid axis into its output block; here one block
// owns 2^logr rows of vbar and loops over the pairs in order
// (tiles.cuh: pair_row_tile), so the sum is deterministic and needs neither
// atomics nor a second pass. Modes: mid (IFFT_y, vbar, x conj(t), FFT_y)
// and last (IFFT_y, vbar, real-space store).
//
// What bounds it on an H100 (reckoned from the data sheet, not measured):
// at 16 pairs x 1024^2 a launch reads and writes the 256 MB pair stream
// once, plus the t plane, ~0.52 GB or ~0.16 ms at 3.35 TB/s, with the FFT
// work of 32 A passes (~3.4 GFLOP, ~0.05 ms at 67 TFLOP/s). It is
// memory-bound like A, so it keeps every intermediate in shared memory and
// adds no device-memory traffic for vbar beyond its one store. The sum
// over pairs is sequential within a block; the grid is nx / 2^logr blocks
// (512 at 1024^2), which keeps the card busy at any pair count.
//
// Shared memory: a tile of 2^logr rows x 2 members on the radix-16 engine
// (fft_pow2.cuh), plus the vbar rows: 41,984 bytes at 1024 (two rows),
// 83,968 at 4096 (one row), opted in with cudaFuncSetAttribute.
//
// No fast-math (sincosf for the phase mode). Plain C interface for ctypes:
// the function launches on the given stream and returns the CUDA error as
// an int.

#include "tiles.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads, 2)
row_pass_bwd_kernel(float2* out, const float2* in,
                    const float2* __restrict__ t, const float* __restrict__ sv,
                    float* __restrict__ vbar, Pow2Eng ey, int n_pairs, int nx,
                    int logr, int vb_offset, int last, float nsigma) {
  extern __shared__ float2 smem[];
  pair_row_tile(ey, smem, nullptr, (float*)(smem + vb_offset), out, in, t, sv,
                vbar, n_pairs, blockIdx.x << logr, nx, logr, last != 0,
                nsigma, threadIdx.x, blockDim.x);
}

}  // namespace

extern "C" {

int fs_row_pass_bwd(void* out, const void* in, const void* t, const void* sv,
                    void* vbar, const void* tw, int n_pairs, int nx, int ny,
                    int last, float nsigma, void* stream) {
  const int logr = pair_tile_logr<Pow2Eng>(ny);
  const size_t bytes = pair_tile_bytes<Pow2Eng>(ny, logr);
  const cudaError_t err = cudaFuncSetAttribute(
      row_pass_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int vb_offset = Pow2Eng::slot_rows(ny) << (logr + 1);
  const int grid = (nx + (1 << logr) - 1) >> logr;
  row_pass_bwd_kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (float2*)out, (const float2*)in, (const float2*)t, (const float*)sv,
      (float*)vbar, Pow2Eng{(const float2*)tw, ny, ilog2(ny)}, n_pairs, nx,
      logr, vb_offset, last, nsigma);
  return (int)cudaGetLastError();
}

}  // extern "C"
