// K6, the resident slice loop for Hopper (sm_90a): every slice of a frame
// in one launch.
//
// Replaces two Pallas TPU kernels:
//   #5  _kernel_resident   (pallas_call at pyslice_tpu/ops/fused_step_resident.py:250),
//       power-of-two grids -> resident_kernel<Pow2Eng>
//   #8  _kernel            (pallas_call at pyslice_tpu/ops/fused_step_odd_resident.py:369),
//       odd and mixed-radix grids -> resident_kernel<MixedEng>
// One CUDA kernel, templated on the FFT engine (fft_pow2.cuh's radix-16
// engine, fft_mixed.cuh's Stockham engine), covers both.
//
// On the TPU the grid (probes, nz) runs in order on one core and the wave
// stays in VMEM scratch between slices. A Hopper block has 227 KB of shared
// memory, and even a 16-SM cluster's distributed shared memory (~3.6 MB)
// does not hold a 1024^2 complex64 wave (8 MB). The 50 MB L2 does. So this
// is a persistent cooperative kernel: launched with
// cudaLaunchCooperativeKernel at no more blocks than can be resident at
// once, it walks the slices itself,
//
//   s = 0:          row phase  "first"  (x t_0, FFT_y)       psi -> state
//   s = 1 .. nz-1:  grid sync, column phase (FFT_x, x P, IFFT_x) on state,
//                   grid sync, row phase "mid" (IFFT_y, x t_s, FFT_y),
//                   or "last" (IFFT_y, x t_s) into out on the last slice
//   k space:        the last row phase runs as "mid", then grid sync and a
//                   column phase FFT_x stored fftshifted into out
//
// with cooperative_groups::this_grid().sync() between phases. The state is
// a device buffer the wrapper allocates (P nx ny complex64); at the sizes
// the dispatch sends here (P nx ny < 3 * 2^20 points, <= 24 MB) it stays in
// L2 between phases. Each block takes row tiles and column tiles of the
// phase in a grid-stride loop.
//
// What bounds it (reckoned, not measured): at 1 x 1024^2 x 14 slices the
// chain's 28 launches carry ~3 us of launch gap each; a slice's
// device-memory traffic is under 20 MB (the t plane and the Fresnel plane;
// the wave sits in L2), so the loop is bound by the FFT work in shared
// memory and by the grid barriers (~2 per slice). With one probe a phase
// has only nx rows or ny / 2^logc column tiles, so the launch narrows the
// tiles until a phase has K6Shape::kTilesPerBlock tiles for each SM.
//
// The grid may be at most cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// SMs for the launch's dynamic shared memory; the launch returns
// cudaErrorCooperativeLaunchTooLarge above that, and the wrapper raises.

#include <cooperative_groups.h>

#include "tiles.cuh"

namespace cg = cooperative_groups;

namespace {

// Block size and the least tiles a phase gives each block, by engine
// (measured on an H100 at 700 W, PERF.md). The radix-16 engine needs
// 128 registers a thread, so 256-thread blocks run two to an SM. The
// mixed-radix engine needs 168 and runs one block an SM: 384 threads (the
// most that fit) and wider tiles took K6 at 1 x 1023^2 x 14 from 3.45 to
// 2.70 ms against 256 threads; a 128-register cap for two blocks spills
// and is slower.
template <class E>
struct K6Shape {
  static constexpr int kThreads = 256;
  static constexpr int kTilesPerBlock = 2;
};
template <>
struct K6Shape<MixedEng> {
  static constexpr int kThreads = 384;
  static constexpr int kTilesPerBlock = 1;
};

template <class E>
__global__ void __launch_bounds__(K6Shape<E>::kThreads, 1)
resident_kernel(float2* __restrict__ out, float2* state,
                                const float2* __restrict__ psi,
                                const float2* __restrict__ t,
                                const float* __restrict__ sv,
                                const float2* __restrict__ prop, E ex, E ey,
                                int n_probes, int nz, int logc_r, int logc_c,
                                size_t b_off, int kspace) {
  extern __shared__ float2 smem[];
  float2* a = smem;
  float2* b = smem + b_off;
  cg::grid_group grid = cg::this_grid();
  const int nx = ex.n;
  const int ny = ey.n;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t plane = (size_t)nx * ny;
  const int rtiles = (nx + (1 << logc_r) - 1) >> logc_r;
  const int ctiles = (ny + (1 << logc_c) - 1) >> logc_c;
  const int rwork = n_probes * rtiles;
  const int cwork = n_probes * ctiles;

  for (int u = blockIdx.x; u < rwork; u += gridDim.x) {
    row_tile(ey, a, b, state, psi, t, sv, u / rtiles,
             (u % rtiles) << logc_r, nx, logc_r, kFirst, tid, nt);
  }
  for (int s = 1; s < nz; ++s) {
    grid.sync();
    for (int u = blockIdx.x; u < cwork; u += gridDim.x) {
      col_tile(ex, a, b, state, state, prop, u / ctiles,
               (u % ctiles) << logc_c, ny, logc_c, tid, nt);
    }
    grid.sync();
    const bool last = (s == nz - 1) && !kspace;
    const float2* ts = t != nullptr ? t + s * plane : nullptr;
    const float* svs = sv != nullptr ? sv + s * plane : nullptr;
    for (int u = blockIdx.x; u < rwork; u += gridDim.x) {
      row_tile(ey, a, b, last ? out : state, state, ts, svs, u / rtiles,
               (u % rtiles) << logc_r, nx, logc_r, last ? kLast : kMid, tid,
               nt);
    }
  }
  if (kspace) {
    grid.sync();
    for (int u = blockIdx.x; u < cwork; u += gridDim.x) {
      kconv_tile(ex, a, b, out, state, u / ctiles, (u % ctiles) << logc_c,
                 ny, logc_c, tid, nt);
    }
  }
}

// Widest tile (2^logc, at most 2^max_logc) whose phase still has `target`
// tiles, for `lines` rows or columns a probe.
int narrow_logc(int max_logc, int n_probes, int lines, int target) {
  int logc = max_logc;
  while (logc > 0 &&
         (long)n_probes * ((lines + (1 << logc) - 1) >> logc) < target) {
    --logc;
  }
  return logc;
}

// Widest tile within 64 KB of shared memory for engine E and axis n.
template <class E>
int max_logc(int n) {
  int logc = 0;
  while (logc < 4 && (size_t)E::kBuffers * E::slot_rows(n) * (2 << logc) *
                             sizeof(float2) <= 66560) {
    ++logc;
  }
  return logc;
}

template <class E>
int launch(E ex, E ey, void* out, void* state, const void* psi,
           const void* t, const void* sv, const void* prop, int n_probes,
           int nz, int kspace, int blocks, int* info, cudaStream_t stream) {
  auto kernel = resident_kernel<E>;
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const int nx = ex.n;
  const int ny = ey.n;
  const int target = K6Shape<E>::kTilesPerBlock * sms;
  const int logc_r = narrow_logc(max_logc<E>(ny), n_probes, nx, target);
  const int logc_c = narrow_logc(max_logc<E>(nx), n_probes, ny, target);
  const size_t slots_r = (size_t)E::slot_rows(ny) << logc_r;
  const size_t slots_c = (size_t)E::slot_rows(nx) << logc_c;
  // the second buffer (mixed radix) starts after the larger tile
  const size_t b_off = slots_r > slots_c ? slots_r : slots_c;
  const size_t smem = E::kBuffers * b_off * sizeof(float2);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  const int threads = K6Shape<E>::kThreads;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  const long rtiles = (long)n_probes * ((nx + (1 << logc_r) - 1) >> logc_r);
  const long ctiles = (long)n_probes * ((ny + (1 << logc_c) - 1) >> logc_c);
  const long work = rtiles > ctiles ? rtiles : ctiles;
  long grid = (long)per_sm * sms;
  if (grid > work) grid = work;
  if (blocks > 0) grid = blocks;
  info[0] = (int)grid;
  info[1] = per_sm;
  info[2] = sms;
  info[3] = (int)smem;
  info[4] = 1 << logc_r;
  info[5] = 1 << logc_c;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  float2* o = (float2*)out;
  float2* st = (float2*)state;
  const float2* ps = (const float2*)psi;
  const float2* tt = (const float2*)t;
  const float* svv = (const float*)sv;
  const float2* pr = (const float2*)prop;
  int lr = logc_r;
  int lc = logc_c;
  size_t bo = E::kBuffers == 2 ? b_off : 0;
  void* args[] = {&o, &st, &ps, &tt, &svv, &pr, &ex, &ey,
                  &n_probes, &nz, &lr, &lc, &bo, &kspace};
  return (int)cudaLaunchCooperativeKernel((void*)kernel, dim3((unsigned)grid),
                                          dim3(threads), args, smem, stream);
}

}  // namespace

extern "C" {

// One frame's slice loop. psi (P, nx, ny) is read, state (same shape) is
// scratch, out receives the exit wave or, with kspace, fftshift(fft2(.)).
// t: (nz, nx, ny) complex planes, or nullptr and sv the (nz, nx, ny) phase
// sigma*V. twx / twy: the engine's twiddle tables (pow2: n/2 entries,
// mixed: n). blocks > 0 overrides the grid size. info receives grid,
// blocks per SM, SMs, dynamic shared memory bytes, row and column tile
// widths.
int fs_resident_loop(void* out, void* state, const void* psi, const void* t,
                     const void* sv, const void* prop, const void* twx,
                     const void* twy, int n_probes, int nx, int ny, int nz,
                     int pow2, int kspace, int blocks, int* info,
                     void* stream) {
  if (pow2) {
    const Pow2Eng ex{(const float2*)twx, nx, ilog2(nx)};
    const Pow2Eng ey{(const float2*)twy, ny, ilog2(ny)};
    return launch(ex, ey, out, state, psi, t, sv, prop, n_probes, nz, kspace,
                  blocks, info, (cudaStream_t)stream);
  }
  return launch(mixed_eng(twx, nx), mixed_eng(twy, ny), out, state, psi, t,
                sv, prop, n_probes, nz, kspace, blocks, info,
                (cudaStream_t)stream);
}

}  // extern "C"
