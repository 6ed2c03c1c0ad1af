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
// is a product of values already on the chip. The TPU kernel summed it over
// a sequential pair grid axis into its output block; here one block owns
// its rows of vbar and loops over the pairs in order, so the sum is
// deterministic and needs neither atomics nor a second pass. Modes: mid
// (IFFT_y, vbar, x t, FFT_y) and last (IFFT_y, vbar, real-space store); t is
// the caller's conjugated plane or negated phase.
//
// What bounds it on an H100: at 16 pairs x 1024^2 a launch reads and writes
// the 256 MiB pair stream once, reads the t plane and writes vbar, 549.5 MB
// or 0.164 ms at 3.35 TB/s (data sheet), with the FFT work of 32 A passes
// (~3.4 GFLOP, ~0.05 ms at 67 TFLOP/s). So every intermediate stays on the
// chip, and t is read once a launch.
//
// The design is A's mid mode (fused_step.cu) on both members of each pair,
// on the register-resident engine of fft_regs.cuh. A block owns 2^logr
// rows for the whole launch (persistent blocks walk the row tiles): T =
// ny / 32 threads a row member, each holding elements t + T m of it in
// registers from the load to the store, through the IFFT, the vbar sum,
// the product and the FFT. Its rows' t (or the cos/sin of their phase) is
// loaded once, before the pair loop, into shared memory: one read of t
// and one sincosf an element for the launch, not one a pair.
//
// The two members of a row sit in the two halves of one warp (a member's
// threads: H = min(T, 16) neighbours, then the other member's H, then the
// next H of the first, ...), so after the IFFT a thread swaps half of its
// values with its partner by __shfl_xor_sync: each thread then holds both
// members of 16 of its row's elements, t + T (i + 16 c) for member c, and
// adds their product to its 16 vbar accumulators, its own slots of shared
// memory. Each vbar element has one owner for the whole pair loop: the sum
// is taken in pair order and stored once, the same bits launch after
// launch.
//
// Launch bound: A's, 168 registers a thread, with blocks of up to 384
// threads (4096: one row, both members, 256 threads, one block an SM). A
// 1024 tile is 2 rows, 128 threads, three blocks an SM (12 warps). Measured
// and not kept (PERF.md): the accumulators in registers under a
// 128-register bound (four blocks an SM, all 512 row tiles of 1024^2 in
// one wave; 204-360 bytes of spills, 8-22% slower); t read every pair
// instead of its rows in shared memory; a cp.async copy of each thread's
// next pair into shared memory while it transforms the current one (7%
// faster at 1024^2, 5-12% slower at every other size).
//
// No fast-math (sincosf for the phase mode). Plain C interface for ctypes:
// the function launches on the given stream and returns the CUDA error as
// an int.

#include "fft_regs.cuh"

namespace {

constexpr int kPairThreads = 384;
constexpr int kPairBlocks = 1;
constexpr int kHalf = kRegE / 2;   // the vbar elements a thread owns

// Row tile u is rows u << logr .. of every pair. Thread tid: member c, row
// r of the tile, transform thread t (see above). t is the (nx, ny) complex
// plane or, with kPhase, sv the phase; none with kLast. After the tile
// buffer: the factors of element t + T m of row r at ts[(m rows + r) T +
// t] (not with kLast), then the vbar slots, i < 16 of thread tid at
// vs[i blockDim.x + tid]. vbar = nsig2 * sum_p Im(conj(w1) w0) of the
// unscaled IFFT values, nsig2 = -sigma / ny^2. `out` may equal `in`: each
// value is read by the thread that writes it, before it writes it.
template <bool kPhase, bool kLast>
__global__ void __launch_bounds__(kPairThreads, kPairBlocks)
row_pass_bwd_kernel(float2* out, const float2* in,
                    const float2* __restrict__ tp, const float* __restrict__ sv,
                    float* __restrict__ vbar, RegGeo g, int n_pairs, int nx,
                    int logr, float nsig2) {
  extern __shared__ __align__(16) float2 xs[];
  const int n = g.n;
  const int T = g.T;
  const int H = T < 16 ? T : 16;
  const int tid = threadIdx.x;
  const int c = (tid / H) & 1;
  const int rest = tid / (2 * H);
  const int t = (tid & (H - 1)) + H * (rest & (T / H - 1));
  const int r = rest / (T / H);
  const int rows = 1 << logr;
  const int rowslots = n + (n >> 5);
  const XMap xm{1, (2 * r + c) * rowslots};
  float2* ts = xs + (rowslots << (logr + 1));
  float* vs = (float*)(ts + (kLast ? 0 : n << logr)) + tid;
  ts += r * T + t;
  const int fstride = rows * T;
  const int vstride = blockDim.x;
  const float scale = 1.0f / (float)n;
  const size_t plane = (size_t)nx * n;
  const int n_tiles = nx >> logr;
  for (int u = blockIdx.x; u < n_tiles; u += gridDim.x) {
    const int x = (u << logr) + r;
    if constexpr (!kLast) {
      // The tile's factors, half of a row's from each member's thread
      // (element t + T (2 i + c)). The last tile's were last read before
      // the first barrier of its last FFT. The phase's cos/sin four at a
      // time, each four loaded before the first sincosf: all sixteen at
      // once spilled 12-20 bytes, and this runs once a tile.
      const size_t k0 = (size_t)x * n + t + (size_t)c * T;
      if constexpr (kPhase) {
#pragma unroll 1
        for (int i0 = 0; i0 < kHalf; i0 += 4) {
          float ph[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ph[j] = __ldg(&sv[k0 + 2 * (i0 + j) * T]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float2 f;
            sincosf(ph[j], &f.y, &f.x);
            ts[(2 * (i0 + j) + c) * fstride] = f;
          }
        }
      } else {
        float2 f[kHalf];
#pragma unroll
        for (int i = 0; i < kHalf; ++i) f[i] = __ldg(&tp[k0 + 2 * i * T]);
#pragma unroll
        for (int i = 0; i < kHalf; ++i) ts[(2 * i + c) * fstride] = f[i];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kHalf; ++i) vs[i * vstride] = 0.0f;
    size_t e = ((size_t)c * nx + x) * n + t;
    for (int p = 0; p < n_pairs; ++p, e += 2 * plane) {
      float2 v[kRegE];
#pragma unroll
      for (int m = 0; m < kRegE; ++m) v[m] = in[e + m * T];
      reg_fft<true>(v, g, xs, xm, t);
      // vbar: member c keeps elements t + T (i + 16 c), i < 16, and hands
      // its partner the other 16
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float2 send = c ? v[i] : v[i + kHalf];
        const float2 mine = c ? v[i + kHalf] : v[i];
        float2 other;
        other.x = __shfl_xor_sync(0xffffffffu, send.x, H);
        other.y = __shfl_xor_sync(0xffffffffu, send.y, H);
        const float2 w0 = c ? other : mine;
        const float2 w1 = c ? mine : other;
        vs[i * vstride] += w1.x * w0.y - w1.y * w0.x;
      }
      if constexpr (kLast) {
#pragma unroll
        for (int m = 0; m < kRegE; ++m) out[e + m * T] = cscale(v[m], scale);
      } else {
        mul_plane<false>(v, ts, fstride, scale);
        reg_fft<false>(v, g, xs, xm, t);
#pragma unroll
        for (int m = 0; m < kRegE; ++m) out[e + m * T] = v[m];
      }
    }
    float* vb = vbar + (size_t)x * n + t + (size_t)c * kHalf * T;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) vb[i * T] = vs[i * vstride] * nsig2;
  }
}

}  // namespace

extern "C" {

// K7. t the complex plane, or sv the phase (t null), neither for last; tw
// the half twiddle table of ny. logc: 2^logc lanes a tile, lane 2 r + c
// member c of row r (ops/fused_step.py pair_reg_plan). info receives the
// grid, blocks per SM, SMs and the dynamic shared memory in bytes.
int fs_row_pass_bwd(void* out, const void* in, const void* t, const void* sv,
                    void* vbar, const void* tw, int n_pairs, int nx, int ny,
                    int last, float nsigma, int logc, int* info,
                    void* stream) {
  const int logr = logc - 1;
  if (ny < 128 || ny > 4096 || (ny & (ny - 1)) != 0 || logr < 0 ||
      logr > 4 || nx < (1 << logr) || nx % (1 << logr) != 0 ||
      n_pairs < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const RegGeo g = reg_geo(tw, ny);
  const int threads = g.T << logc;
  if (threads % 32 != 0 || threads > kPairThreads) {
    return (int)cudaErrorInvalidValue;
  }
  // the tile buffer; in mid mode the factor rows; the vbar slots
  const size_t smem =
      reg_smem(ny, logc) +
      (last ? 0 : ((size_t)ny << logr) * sizeof(float2)) +
      (size_t)kHalf * threads * sizeof(float);
  const auto kernel = last ? row_pass_bwd_kernel<false, true>
                      : sv != nullptr ? row_pass_bwd_kernel<true, false>
                                      : row_pass_bwd_kernel<false, false>;
  const long tiles = nx >> logr;
  const cudaError_t err = persistent_grid(kernel, threads, smem, tiles, info);
  if (err != cudaSuccess) return (int)err;
  const float nsig2 = (float)((double)nsigma / ((double)ny * ny));
  kernel<<<(unsigned)info[0], threads, smem, (cudaStream_t)stream>>>(
      (float2*)out, (const float2*)in, (const float2*)t, (const float*)sv,
      (float*)vbar, g, n_pairs, nx, logr, nsig2);
  return (int)cudaGetLastError();
}

}  // extern "C"
