// Fused multislice slice-step kernels A, B and C for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of pyslice_tpu/ops/fused_step.py:
//   A  row pass     <- _kernel_a via _call_a  (pallas_call at fused_step.py:472)
//   B  column pass  <- _kernel_b via _call_b  (pallas_call at fused_step.py:503)
//   C  k conversion <- _kernel_c via _call_c  (pallas_call at fused_step.py:423)
//
// Layout: the wave is (P, nx, ny) complex64, interleaved (float2), in its
// natural order at every kernel boundary. The FFT engine (fft_pow2.cuh)
// runs radix-16 passes in shared memory: the forward leaves bit-reversed
// order and the inverse consumes it. The bit reversal costs no data movement:
// A reads or writes its row through bit-reversed shared-memory addresses,
// B multiplies the Fresnel plane at the bit-reversed kx row between its
// forward and inverse, and C folds both the bit reversal and the fftshift
// into its store index. Twiddles exp(-2 pi i m / n), m < n/2, are computed
// in float64 on the host and read as float32 from device memory.
//
// What bounds them on an H100 (reckoned from the data sheet, not measured):
// one slice at 16 x 1024^2 reads and writes the 128 MiB wave twice (A and
// B) plus the transmission and Fresnel planes, about 0.55 GB, or about
// 0.17 ms at 3.35 TB/s; its FFT work is about 3.4 GFLOP, under 0.1 ms on the
// FP32 cores. The step is memory-bound, so each kernel reads and writes the
// wave once and keeps every intermediate in shared memory or registers.
//
// No fast-math: the transmission phase sigma*V runs to tens of radians,
// where __sinf/__cosf lose the accuracy the 1e-6 residual bar needs, so the
// in-kernel phase mode uses sincosf.
//
// Plain C interface for ctypes: each function launches on the given stream
// and returns cudaGetLastError() as an int.

#include "fft_pow2.cuh"

namespace {

// Kernel A, the row pass; replaces _kernel_a (pyslice_tpu/ops/fused_step.py,
// launched by _call_a). Floor at 16 x 1024^2: 264 MB moved (wave in and
// out, t plane), ~0.08 ms at 3.35 TB/s. Block (tx, ty) threads; row
// x = blockIdx.x * ty + threadIdx.y of probe blockIdx.y, n = 2^logn values,
// lives in shared memory. Modes (as in the TPU kernel):
//   first: x t, FFT_y      mid: IFFT_y, x t, FFT_y
//   last:  IFFT_y, x t     only: x t
// t is a precomputed (cos, sin) plane, or, when t == nullptr, the phase
// sigma*V from which cos/sin are taken here (the capacity mode). `out` may
// equal `in`: a block reads its rows whole before it writes.
__global__ void row_pass_kernel(float2* out, const float2* in,
                                const float2* __restrict__ t,
                                const float* __restrict__ sv,
                                const float2* __restrict__ tw,
                                int nx, int logn, int mode) {
  extern __shared__ float2 smem[];
  const int n = 1 << logn;
  const int tx = threadIdx.x;
  const int ntx = blockDim.x;
  float2* s = smem + threadIdx.y * pad(n);
  const int x = blockIdx.x * blockDim.y + threadIdx.y;
  const size_t row = ((size_t)blockIdx.y * nx + x) << logn;
  const size_t trow = (size_t)x << logn;
  const bool inv = (mode == kMid || mode == kLast);
  const bool fwd = (mode == kFirst || mode == kMid);

  for (int i = tx; i < n; i += ntx) {
    s[pad(inv ? bit_reverse(i, logn) : i)] = in[row + i];
  }
  __syncthreads();
  if (inv) ifft_dit(s, logn, 0, tw, tx, ntx);

  const float scale = inv ? 1.0f / (float)n : 1.0f;
  for (int i = tx; i < n; i += ntx) {
    float2 tv;
    if (t != nullptr) {
      tv = t[trow + i];
    } else {
      sincosf(sv[trow + i], &tv.y, &tv.x);
    }
    const float2 v = cscale(cmul(s[pad(i)], tv), scale);
    if (fwd) {
      s[pad(i)] = v;
    } else {
      out[row + i] = v;
    }
  }
  if (!fwd) return;
  __syncthreads();
  fft_dif(s, logn, 0, tw, tx, ntx);
  for (int i = tx; i < n; i += ntx) {
    out[row + i] = s[pad(bit_reverse(i, logn))];
  }
}

// Kernel B, the column pass; replaces _kernel_b (launched by _call_b).
// Floor as A's. FFT_x, x Fresnel plane / nx, IFFT_x. One block
// per (tile of 2^logc adjacent columns, probe); the (nx, 2^logc) tile lives
// in shared memory, so each row's columns load and store as one coalesced
// segment. `prop` is the natural-order (nx, ny) plane; after the forward,
// tile row i holds kx = bitrev(i), so the multiply reads prop's row
// bitrev(i). `out` may equal `in`.
__global__ void col_pass_kernel(float2* out, const float2* in,
                                const float2* __restrict__ prop,
                                const float2* __restrict__ tw,
                                int logn, int ny, int logc) {
  extern __shared__ float2 s[];
  const int cmask = (1 << logc) - 1;
  const int tot = 1 << (logn + logc);
  const int y0 = blockIdx.x << logc;
  const size_t base = ((size_t)blockIdx.y << logn) * ny + y0;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  for (int e = tid; e < tot; e += nthr) {
    s[(pad(e >> logc) << logc) + (e & cmask)] =
        in[base + (size_t)(e >> logc) * ny + (e & cmask)];
  }
  __syncthreads();
  fft_dif(s, logn, logc, tw, tid, nthr);
  const float scale = 1.0f / (float)(1 << logn);
  for (int e = tid; e < tot; e += nthr) {
    const int i = e >> logc;
    const int kx = bit_reverse(i, logn);
    const float2 pv = prop[(size_t)kx * ny + y0 + (e & cmask)];
    const int si = (pad(i) << logc) + (e & cmask);
    s[si] = cmul(s[si], cscale(pv, scale));
  }
  __syncthreads();
  ifft_dit(s, logn, logc, tw, tid, nthr);
  for (int e = tid; e < tot; e += nthr) {
    out[base + (size_t)(e >> logc) * ny + (e & cmask)] =
        s[(pad(e >> logc) << logc) + (e & cmask)];
  }
}

// Kernel C; replaces _kernel_c (launched by _call_c) and the
// unpermute_shift_indices gather after it. Floor: 256 MB, ~0.08 ms at
// 16 x 1024^2. The last FFT_x of the k-space conversion, storing
// fftshift(.) over both axes: tile row i holds kx = bitrev(i), stored at
// row (kx + nx/2) mod nx, and column y at (y + ny/2) mod ny. A tile never
// wraps, since 2^logc divides ny/2. `out` must not alias `in`.
__global__ void kconvert_kernel(float2* __restrict__ out,
                                const float2* __restrict__ in,
                                const float2* __restrict__ tw,
                                int logn, int ny, int logc) {
  extern __shared__ float2 s[];
  const int n = 1 << logn;
  const int cmask = (1 << logc) - 1;
  const int tot = 1 << (logn + logc);
  const int y0 = blockIdx.x << logc;
  const size_t plane = ((size_t)blockIdx.y << logn) * ny;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  for (int e = tid; e < tot; e += nthr) {
    s[(pad(e >> logc) << logc) + (e & cmask)] =
        in[plane + (size_t)(e >> logc) * ny + y0 + (e & cmask)];
  }
  __syncthreads();
  fft_dif(s, logn, logc, tw, tid, nthr);
  const int ys = (y0 + (ny >> 1)) & (ny - 1);
  for (int e = tid; e < tot; e += nthr) {
    const int i = e >> logc;
    const int ox = (bit_reverse(i, logn) + (n >> 1)) & (n - 1);
    out[plane + (size_t)ox * ny + ys + (e & cmask)] =
        s[(pad(i) << logc) + (e & cmask)];
  }
}

constexpr int kColThreads = 256;
constexpr int kRowThreads = 128;
// Shared memory the column kernels may ask for (above the 48 KB default):
// a 64 KB tile plus its pad slots.
constexpr int kColSmemLimit = 72 * 1024;

// Columns per B/C tile for an axis of length n: 64 KB of data (plus pad
// slots), 2 to 16 columns.
int tile_cols(int n) {
  int c = 8192 / n;
  if (c > 16) c = 16;
  if (c < 2) c = 2;
  return c;
}

size_t tile_bytes(int n, int cols) {
  return (size_t)(n + (n >> 5)) * cols * sizeof(float2);
}

}  // namespace

extern "C" {

int fs_row_pass(void* out, const void* in, const void* t, const void* sv,
                const void* tw, int n_probes, int nx, int ny, int mode,
                void* stream) {
  const int logn = ilog2(ny);
  // threads per row: one per work item of a full-radix pass, 32 to 128
  int tx = ny >> kMaxLogRadix;
  if (tx < 32) tx = 32;
  if (tx > kRowThreads) tx = kRowThreads;
  const int ty = kRowThreads / tx;           // rows per block, divides nx
  const dim3 grid(nx / ty, n_probes);
  const dim3 block(tx, ty);
  row_pass_kernel<<<grid, block, tile_bytes(ny, ty), (cudaStream_t)stream>>>(
      (float2*)out, (const float2*)in, (const float2*)t, (const float*)sv,
      (const float2*)tw, nx, logn, mode);
  return (int)cudaGetLastError();
}

int fs_col_pass(void* out, const void* in, const void* prop, const void* tw,
                int n_probes, int nx, int ny, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      col_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kColSmemLimit);
  if (err != cudaSuccess) return (int)err;
  const int logn = ilog2(nx);
  const int tc = tile_cols(nx);
  const dim3 grid(ny / tc, n_probes);
  col_pass_kernel<<<grid, kColThreads, tile_bytes(nx, tc),
                    (cudaStream_t)stream>>>(
      (float2*)out, (const float2*)in, (const float2*)prop,
      (const float2*)tw, logn, ny, ilog2(tc));
  return (int)cudaGetLastError();
}

int fs_kconvert(void* out, const void* in, const void* tw, int n_probes,
                int nx, int ny, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kconvert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kColSmemLimit);
  if (err != cudaSuccess) return (int)err;
  const int logn = ilog2(nx);
  const int tc = tile_cols(nx);
  const dim3 grid(ny / tc, n_probes);
  kconvert_kernel<<<grid, kColThreads, tile_bytes(nx, tc),
                    (cudaStream_t)stream>>>(
      (float2*)out, (const float2*)in, (const float2*)tw, logn, ny,
      ilog2(tc));
  return (int)cudaGetLastError();
}

}  // extern "C"
