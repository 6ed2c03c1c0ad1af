// Fused multislice slice-step kernels A, B and C for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of pyslice_tpu/ops/fused_step.py:
//   A  row pass     <- _kernel_a via _call_a  (pallas_call at fused_step.py:472)
//   B  column pass  <- _kernel_b via _call_b  (pallas_call at fused_step.py:503)
//   C  k conversion <- _kernel_c via _call_c  (pallas_call at fused_step.py:423)
//
// Layout: the wave is (P, nx, ny) complex64, interleaved (float2), in its
// natural order at every kernel boundary.
//
// What bounds A and B on an H100: a pass at 16 x 1024^2 reads and writes
// the 128 MiB wave once and reads one 8 MiB plane, 276.8 MB, 0.0826 ms at
// 3.35 TB/s (data sheet); its FFT work, 1.7 GFLOP, is 0.025 ms on the FP32
// cores. The first kernels (one block a tile, its values loaded into
// shared memory, radix-16 passes there with a barrier and a device-memory
// twiddle for every butterfly, then stored) took 0.23 (A mid) and 0.26 ms
// (B); so did the producer/consumer tile walk of K4 and K5 on these axes,
// and a walk whose first and last stages read and wrote the wave: every
// one of them spends its time in shared-memory stages and the barriers
// between them, with few warps an SM to hide them (PERF.md).
//
// A and B run the register-resident engine of fft_regs.cuh instead:
// persistent blocks walk the (probe, tile) pairs; each thread loads its 32
// values of a transform straight from the wave, and they stay in its
// registers through every stage, the pass's product and (B, A mid) the
// second transform, until it stores them. A 1024-point transform is two
// radix-32 stages with one exchange through shared memory between them;
// B and A mid take two exchanges, first and last one, only none. The
// product is taken on the values in registers, in natural order, so the
// Fresnel plane and the transmission are read at their natural elements
// with the same coalesced pattern as the wave.
//
// C keeps the in-place radix-16 engine of fft_pow2.cuh: the forward leaves
// bit-reversed order, which C folds with the fftshift into its store
// index. Twiddles exp(-2 pi i m / n), m < n/2, are computed in float64 on
// the host.
//
// No fast-math: the transmission phase sigma*V runs to tens of radians,
// where __sinf/__cosf lose the accuracy the 1e-6 residual bar needs, so the
// in-kernel phase mode uses sincosf.
//
// Plain C interface for ctypes: each function launches on the given stream
// and returns cudaGetLastError() as an int.

#include "fft_pow2.cuh"
#include "fft_regs.cuh"

namespace {

// A's launch bound in its transform modes, threads and blocks an SM (168
// registers a thread: no spills with either t form); `only` takes
// kRegThreads, one block, and the registers it needs.
constexpr int kRowThreads = 128;
constexpr int kRowBlocks = 3;
constexpr int kColPassThreads = 512;   // B's block

// Kernel A, the row pass; replaces _kernel_a (pyslice_tpu/ops/fused_step.py,
// launched by _call_a). Tile u is rows (u % tpp) << logc .. of probe
// u / tpp; thread tid takes element t + T m of row c, t = tid mod T,
// c = tid / T (T = ny / 32 threads a row). Modes as in the TPU kernel:
//   first: x t, FFT_y      mid: IFFT_y, x t / ny, FFT_y
//   last:  IFFT_y, x t / ny only: x t
// t is the (nx, ny) complex plane or, with kPhase, sv the phase sigma*V
// (cos/sin taken here: the capacity mode and TPU kernel #1,
// transmit_pallas, as `only`). One instantiation a mode: `only` (no
// transform, no shared memory) loads, multiplies and stores kU values at a
// time, in few registers, so that many of its blocks share an SM and hide
// sincosf. In the transform modes the phase's cos/sin are taken at the
// start of each tile, before the thread loads its values, with few
// registers live, and kept in the thread's own slots of shared memory
// (after the tile buffer) until the product reads them back. `out`
// may equal `in`: a tile is read whole before any of it is written
// (`only`: each value is read before it is written, by the thread that
// writes it).
template <bool kPhase, int kMode>
__global__ void __launch_bounds__(kMode == kOnly ? kRegThreads : kRowThreads,
                                  kMode == kOnly ? 1 : kRowBlocks)
row_pass_kernel(float2* out, const float2* in, const float2* __restrict__ tp,
                const float* __restrict__ sv, RegGeo g, int nx, int logc,
                int tpp, int n_tiles) {
  extern __shared__ __align__(16) float2 xs[];
  constexpr bool kInv = kMode == kMid || kMode == kLast;
  constexpr bool kFwd = kMode == kFirst || kMode == kMid;
  const int n = g.n;
  const int T = g.T;
  const int t = threadIdx.x & (T - 1);
  const int c = threadIdx.x / T;
  const int rowslots = n + (n >> 5);
  const XMap xm{1, c * rowslots};
  const float scale = kInv ? 1.0f / (float)n : 1.0f;
  for (int u = blockIdx.x; u < n_tiles; u += gridDim.x) {
    const int x = ((u % tpp) << logc) + c;
    const size_t row = ((size_t)(u / tpp) * nx + x) * n + t;
    const float2* tx = kPhase ? nullptr : tp + ((size_t)x * n + t);
    const float* sx = kPhase ? sv + ((size_t)x * n + t) : nullptr;
    if constexpr (kMode == kOnly) {
      constexpr int kU = 8;
#pragma unroll 1
      for (int m0 = 0; m0 < kRegE; m0 += kU) {
        float2 v[kU];
#pragma unroll
        for (int m = 0; m < kU; ++m) v[m] = in[row + (m0 + m) * T];
        float2 f[kU];
#pragma unroll
        for (int m = 0; m < kU; ++m) {
          const int k = (m0 + m) * T;
          if constexpr (kPhase) {
            f[m].x = __ldg(&sx[k]);
          } else {
            f[m] = __ldg(&tx[k]);
          }
        }
        if constexpr (kPhase) {
#pragma unroll
          for (int m = 0; m < kU; ++m) sincosf(f[m].x, &f[m].y, &f[m].x);
        }
#pragma unroll
        for (int m = 0; m < kU; ++m) {
          out[row + (m0 + m) * T] = cmul(v[m], f[m]);
        }
      }
    } else {
      float2* slots = xs + (rowslots << logc) + threadIdx.x;
      if constexpr (kPhase) {
        // every phase loaded before the first sincosf, whose branch would
        // otherwise hold each load back behind the one before
        float ph[kRegE];
#pragma unroll
        for (int m = 0; m < kRegE; ++m) ph[m] = __ldg(&sx[m * T]);
#pragma unroll
        for (int m = 0; m < kRegE; ++m) {
          float2 f;
          sincosf(ph[m], &f.y, &f.x);
          slots[m * blockDim.x] = f;
        }
      }
      float2 v[kRegE];
#pragma unroll
      for (int m = 0; m < kRegE; ++m) v[m] = in[row + m * T];
      if constexpr (kInv) reg_fft<true>(v, g, xs, xm, t);
      if constexpr (kPhase) {
        mul_plane<false>(v, slots, blockDim.x, scale);
      } else {
        mul_plane<true>(v, tx, T, scale);
      }
      if constexpr (kFwd) reg_fft<false>(v, g, xs, xm, t);
#pragma unroll
      for (int m = 0; m < kRegE; ++m) out[row + m * T] = v[m];
    }
  }
}

template <bool kPhase>
auto row_kernel(int mode) {
  return mode == kFirst  ? row_pass_kernel<kPhase, kFirst>
         : mode == kMid  ? row_pass_kernel<kPhase, kMid>
         : mode == kLast ? row_pass_kernel<kPhase, kLast>
                         : row_pass_kernel<kPhase, kOnly>;
}

// Kernel B, the column pass; replaces _kernel_b (launched by _call_b).
// Tile u is columns (u % tpp) << logc .. of probe u / tpp; thread tid
// takes element (row) t + T m of column c, c = tid mod 2^logc,
// t = tid >> logc, so a warp's loads are 32 / 2^logc row segments of the
// tile's 2^logc columns. FFT_x, x prop / nx (prop the natural-order
// Fresnel plane, read at the thread's own rows), IFFT_x, the values in
// registers throughout. `out` may equal `in`. Bound: kColPassThreads, one
// block an SM (128 registers); the tile as wide as they allow (nx = 4096:
// 4 columns, 1024: 16), since the blocks running at once share the
// sectors and DRAM bursts of their row segments only through L2, and
// narrower tiles measured slower (PERF.md).
__global__ void __launch_bounds__(kColPassThreads, 1)
col_pass_kernel(float2* out, const float2* in,
                const float2* __restrict__ prop, RegGeo g, int ny, int logc,
                int tpp, int n_tiles) {
  extern __shared__ __align__(16) float2 xs[];
  const int n = g.n;
  const int c = threadIdx.x & ((1 << logc) - 1);
  const int t = threadIdx.x >> logc;
  const XMap xm{1 << logc, c};
  const float scale = 1.0f / (float)n;
  const int step = g.T * ny;    // below 2^31 / 32: n ny <= 4096^2
  for (int u = blockIdx.x; u < n_tiles; u += gridDim.x) {
    const int y = ((u % tpp) << logc) + c;
    const size_t col = (size_t)(u / tpp) * n * ny + (size_t)t * ny + y;
    float2 v[kRegE];
#pragma unroll
    for (int m = 0; m < kRegE; ++m) v[m] = in[col + m * step];
    reg_fft<false>(v, g, xs, xm, t);
    mul_plane<true>(v, prop + (size_t)t * ny + y, step, scale);
    reg_fft<true>(v, g, xs, xm, t);
#pragma unroll
    for (int m = 0; m < kRegE; ++m) out[col + m * step] = v[m];
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
// Shared memory kernel C may ask for (above the 48 KB default): a 64 KB
// tile plus its pad slots.
constexpr int kColSmemLimit = 72 * 1024;

// Columns per C tile for an axis of length n: 64 KB of data (plus pad
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

// A. t the complex plane, or sv the phase (t null); tw the half twiddle
// table of ny. logc (2^logc rows a tile): the tile plan (ops/fused_step.py
// reg_tile_plan). info receives the grid,
// blocks per SM, SMs and the dynamic shared memory in bytes.
int fs_row_pass(void* out, const void* in, const void* t, const void* sv,
                const void* tw, int n_probes, int nx, int ny, int mode,
                int logc, int* info, void* stream) {
  const int bound = mode == kOnly ? kRegThreads : kRowThreads;
  if (!reg_plan_ok(ny, nx, logc) || mode < kFirst || mode > kOnly ||
      (ny / kRegE) << logc > bound) {
    return (int)cudaErrorInvalidValue;
  }
  const RegGeo g = reg_geo(tw, ny);
  const int threads = g.T << logc;
  // the tile buffer; with the phase, the factor slots too
  const size_t smem =
      mode == kOnly ? 0
                    : reg_smem(ny, logc) +
                          (sv != nullptr ? kRegE * threads * sizeof(float2)
                                         : 0);
  const int tpp = nx >> logc;
  const long tiles = (long)n_probes * tpp;
  const auto kernel =
      sv != nullptr ? row_kernel<true>(mode) : row_kernel<false>(mode);
  const cudaError_t err = persistent_grid(kernel, threads, smem, tiles, info);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)info[0], threads, smem, (cudaStream_t)stream>>>(
      (float2*)out, (const float2*)in, (const float2*)t, (const float*)sv, g,
      nx, logc, tpp, (int)tiles);
  return (int)cudaGetLastError();
}

// B. tw the half twiddle table of nx; logc (2^logc columns a tile) and
// info as A's.
int fs_col_pass(void* out, const void* in, const void* prop, const void* tw,
                int n_probes, int nx, int ny, int logc, int* info,
                void* stream) {
  if (!reg_plan_ok(nx, ny, logc, kColPassThreads)) {
    return (int)cudaErrorInvalidValue;
  }
  const RegGeo g = reg_geo(tw, nx);
  const int threads = g.T << logc;
  const size_t smem = reg_smem(nx, logc);
  const int tpp = ny >> logc;
  const long tiles = (long)n_probes * tpp;
  const cudaError_t err =
      persistent_grid(col_pass_kernel, threads, smem, tiles, info);
  if (err != cudaSuccess) return (int)err;
  col_pass_kernel<<<(unsigned)info[0], threads, smem, (cudaStream_t)stream>>>(
      (float2*)out, (const float2*)in, (const float2*)prop, g, ny, logc, tpp,
      (int)tiles);
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
