// The TACAW time FFT for Hopper (sm_90a), one kernel: for a block of exit
// waves x (P, T, nx, ny) complex64 it writes the float32 intensity
//
//   out[p, (f + T/2) mod T, kx, ky] =
//       | sum_t (x[p, t, kx, ky] - mean_t x[p, ., kx, ky]) exp(-2 pi i f t / T) |^2
//
// which is |fftshift_t(fft_t(x - mean_t x))|^2 with fftshift's T/2 shift
// (T // 2 for odd T).
//
// Replaces no Pallas kernel: the JAX package (pyslice_tpu/analysis/
// tacaw.py) leaves this FFT to XLA. It was added because the port's plain
// chain (analysis/tacaw.py _time_fft_block: mean, subtraction, torch.fft,
// roll, abs, square, then a copy of each probe chunk into the output) made
// six passes over the waves and a seventh over the intensity, ~20x the
// time the card needs for the work (PERF.md).
//
// What bounds it on an H100: the waves read once and the intensity
// written once, 12 bytes a point, 20.1 GB at 16 x 100 x 1023^2, 6.0 ms at
// 3.35 TB/s (data sheet). The arithmetic is ~5 T log2 T flops a column of
// T points, far below the FP32 rate, so what counts is the bytes in flight.
//
// Design. A block owns 2^logc neighbouring k-points (columns of the
// flattened nx ny plane) of one probe across all T frames: a tile of T
// rows of 2^logc columns, element (t, c) at s[(t << logc) + c], the tile
// layout of fft_mixed.cuh and tile_async.cuh. Its threads copy the tile
// into shared memory with cp.async (8 bytes a copy: with an odd nx ny
// every other frame row starts 8 bytes off a 16-byte boundary), one
// column a thread and every (256 / 2^logc)-th row, so a warp reads
// neighbouring addresses of a row; columns past the plane are zero-filled
// and never stored. Each thread sums its rows of its column in float32,
// and the partial sums meet in shared memory as the column means. Then the
// Stockham stages of make_plan(T) (tf_pass, tile_pass's stage with the
// float64-built twiddles in shared memory): the first subtracts the means
// from the values it reads, the last squares its results in registers and
// stores row f to output row (f + T/2) mod T, so fftshift is an index and
// not a pass; a warp stores neighbouring floats of a row. The tile thus
// crosses shared memory once in, once a stage, and not at all on the way
// out. The mean is subtracted before the transform, as the plain chain
// does: zeroing bin 0 instead would put the large zero-frequency term
// through the float32 stages and its roundoff into every other bin.
//
// The tile width is the host's plan (analysis/time_fft.py plan): the widest,
// up to 32 columns, whose block fits half an SM's shared memory, so that
// several blocks share an SM and one block's copies are in flight while
// another runs its stages: 32 columns at T = 100 (54,304 bytes, four
// blocks an SM), 16 at T = 400 (107,776 bytes, two). The kernel is
// instantiated for the largest stage radix of the plan (8, 16 or 31), so
// that the register cap of four blocks an SM holds where the radices are
// small. Any stride of the four axes is taken
// (a [..., layer] view of a recorded-layers block reads with a ky stride
// of n_layers); the output is contiguous.
//
// Measured (PERF.md; H100 at 700 W, 16 x 100 x 1023^2): 10.7 ms, 56% of
// the bound; the stores bound it. The copies in and the shifted stores
// alone, with no transform, take 61% of the bound's rate at 32 columns and
// 79% at 64, where the reads alone reach 85%: a tile's output rows are
// 128-byte segments scattered over T rows of the plane. 64 columns halve
// the blocks an SM and lose more than the longer segments give; a
// persistent block that copies its next tile while it transforms this one
// (three buffers) lost too (15-28 ms).

#include <cstdint>

#include "tile_async.cuh"

namespace {

constexpr int kTfThreads = 256;
constexpr int kTfMaxLogc = 5;

// Shared memory of a block: the twiddle table (n), the partial sums (one a
// thread), the column means (2^logc) and the Stockham pair (2 n 2^logc),
// complex64 each.
size_t tf_smem(int n, int logc) {
  return 8 * ((size_t)n + kTfThreads + (1u << logc) +
              2 * ((size_t)n << logc));
}

// A stage's result into the other buffer of the pair.
struct ToTile {
  float2* s;
  int logc;
  __device__ __forceinline__ void operator()(int row, int c, float2 v) const {
    s[(row << logc) + c] = v;
  }
};

// The last stage's result: |v|^2 of row f to output row (f + n/2) mod n,
// columns below `cols` (the tile's columns inside the plane). dst is the
// probe's output at the tile's first column, rows kplane apart.
struct ToIntensity {
  float* dst;
  long long kplane;
  int cols;
  int n;
  __device__ __forceinline__ void operator()(int row, int c, float2 v) const {
    if (c < cols) {
      const int half = n >> 1;
      const int fo = row + half < n ? row + half : row + half - n;
      dst[(long long)fo * kplane + c] = v.x * v.x + v.y * v.y;
    }
  }
};

// One forward Stockham stage of radix R on the tile in `in`: tile_pass
// (tile_async.cuh) with two changes. With kSub (the first stage) each
// value read has its column's mean subtracted, so the mean-free tile is
// never written; and each result goes to emit(row, column, value): the
// other buffer (ToTile), or for the last stage the intensity
// (ToIntensity), so the transform's last result is squared in registers
// and never written to shared memory.
template <int R, bool kSub, class Emit>
__device__ __forceinline__ void tf_pass(const float2* __restrict__ in,
                                        const float2* mean, const Emit& emit,
                                        int n, int logc, int ns,
                                        const float2* tws, int tid, int nt) {
  constexpr bool kPow2 = (R & (R - 1)) == 0;
  const int nr = n / R;
  const int stride = n / (ns * R);
  const int cmask = (1 << logc) - 1;
  const int items = nr << logc;
  const float inv_ns = 1.0f / (float)ns;
  for (int b = tid; b < items; b += nt) {
    const int c = b & cmask;
    const int j = b >> logc;
    const int k = j - ns * (int)(((float)j + 0.5f) * inv_ns);
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = in[((j + r * nr) << logc) + c];
    if constexpr (kSub) {
      const float2 m = mean[c];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = csub(v[r], m);
    }
    if (k != 0) {
      const float2 wk = tws[k * stride];
      float2 wr = wk;
#pragma unroll
      for (int r = 1; r < R; ++r) {
        v[r] = cmul(v[r], wr);
        wr = cmul(wr, wk);
      }
    }
    const int base = (j - k) * R + k;
    if constexpr (kPow2) {
#pragma unroll
      for (int half = R / 2; half >= 1; half >>= 1) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (i & half) continue;
          const float2 x = v[i];
          const float2 y = v[i + half];
          v[i] = cadd(x, y);
          v[i + half] = cmul(
              csub(x, y), dft_w<R, false>((i & (half - 1)) * (R / (2 * half))));
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) emit(base + q * ns, c, v[brev(q, R)]);
    } else {
      constexpr int H = (R - 1) / 2;
      float2 acc0 = v[0];
#pragma unroll
      for (int r = 1; r <= H; ++r) {
        const float2 x = v[r];
        const float2 y = v[R - r];
        v[r] = cadd(x, y);
        v[R - r] = csub(x, y);
        acc0 = cadd(acc0, v[r]);
      }
      emit(base, c, acc0);
#pragma unroll
      for (int q = 1; q <= H; ++q) {
        float2 A = v[0];
        float2 B = make_float2(0.0f, 0.0f);
#pragma unroll
        for (int r = 1; r <= H; ++r) {
          const int m = (q * r) % R;
          const float cm = m <= H ? k_dft.c[R][m] : k_dft.c[R][R - m];
          const float sm = m <= H ? k_dft.s[R][m] : -k_dft.s[R][R - m];
          A.x += v[r].x * cm;
          A.y += v[r].y * cm;
          B.x += v[R - r].x * sm;
          B.y += v[R - r].y * sm;
        }
        emit(base + q * ns, c, make_float2(A.x + B.y, A.y - B.x));
        emit(base + (R - q) * ns, c, make_float2(A.x - B.y, A.y + B.x));
      }
    }
  }
}

// One stage of radix r, instantiated for the radices up to kMaxR only (the
// register cap of the kernel follows the largest).
template <int kMaxR, bool kSub, class Emit>
__device__ void tf_stage(int r, const float2* a, const float2* mean,
                         const Emit& e, int n, int logc, int ns,
                         const float2* tws, int tid, int nt) {
  switch (r) {
    case 2: tf_pass<2, kSub>(a, mean, e, n, logc, ns, tws, tid, nt); return;
    case 3: tf_pass<3, kSub>(a, mean, e, n, logc, ns, tws, tid, nt); return;
    case 4: tf_pass<4, kSub>(a, mean, e, n, logc, ns, tws, tid, nt); return;
    case 5: tf_pass<5, kSub>(a, mean, e, n, logc, ns, tws, tid, nt); return;
    case 7: tf_pass<7, kSub>(a, mean, e, n, logc, ns, tws, tid, nt); return;
    case 8: tf_pass<8, kSub>(a, mean, e, n, logc, ns, tws, tid, nt); return;
    default: break;
  }
  if constexpr (kMaxR >= 16) {
    switch (r) {
      case 11: tf_pass<11, kSub>(a, mean, e, n, logc, ns, tws, tid, nt); return;
      case 13: tf_pass<13, kSub>(a, mean, e, n, logc, ns, tws, tid, nt); return;
      case 16: tf_pass<16, kSub>(a, mean, e, n, logc, ns, tws, tid, nt); return;
      default: break;
    }
  }
  if constexpr (kMaxR >= 31) {
    switch (r) {
      case 17: tf_pass<17, kSub>(a, mean, e, n, logc, ns, tws, tid, nt); return;
      case 19: tf_pass<19, kSub>(a, mean, e, n, logc, ns, tws, tid, nt); return;
      case 23: tf_pass<23, kSub>(a, mean, e, n, logc, ns, tws, tid, nt); return;
      case 29: tf_pass<29, kSub>(a, mean, e, n, logc, ns, tws, tid, nt); return;
      case 31: tf_pass<31, kSub>(a, mean, e, n, logc, ns, tws, tid, nt); return;
      default: break;
    }
  }
}

// Blocks an SM that the launch bounds ask for: four where every radix is
// at most 16, two for the radices up to 31.
template <int kMaxR>
constexpr int tf_min_blocks() {
  return kMaxR <= 16 ? 4 : 2;
}

// Grid (tiles of the plane, probes). in: element strides sp, st, sx, sy;
// out: contiguous (P, n, nx ny). kplane = nx ny.
template <int kMaxR>
__global__ void __launch_bounds__(kTfThreads, tf_min_blocks<kMaxR>())
    time_fft_kernel(float* __restrict__ out, const float2* __restrict__ in,
                    const float2* __restrict__ tw, MixedPlan plan, int ny,
                    int kplane, long long sp, long long st, long long sx,
                    long long sy, int logc) {
  extern __shared__ float2 smem[];
  const int n = plan.n;
  const int cols = 1 << logc;
  const int cmask = cols - 1;
  const int tid = threadIdx.x;
  const int nt = kTfThreads;
  float2* tws = smem;
  float2* part = tws + n;
  float2* mean = part + kTfThreads;
  float2* a = mean + cols;
  float2* b = a + ((size_t)n << logc);

  const int p = blockIdx.y;
  const int k0 = blockIdx.x << logc;
  const int c = tid & cmask;             // this thread's column (nt % cols == 0)
  const int r0 = tid >> logc;            // its first row
  const int rstep = nt >> logc;          // and the step between its rows
  const int k = k0 + c;
  const bool ok = k < kplane;
  const int kk = ok ? k : k0;            // a column of the plane either way
  const int kx = kk / ny;
  const float2* src = in + (long long)p * sp + (long long)kx * sx +
                      (long long)(kk - kx * ny) * sy;
  for (int t = r0; t < n; t += rstep) {
    cp_async8(&a[(t << logc) + c], src + (long long)t * st, ok);
  }
  cp_async_commit();
  for (int i = tid; i < n; i += nt) tws[i] = tw[i];
  cp_async_wait_all();

  // the column means: this thread's rows (its own copies, landed), then
  // the partial sums of the column's threads
  float2 s = make_float2(0.0f, 0.0f);
  for (int t = r0; t < n; t += rstep) s = cadd(s, a[(t << logc) + c]);
  part[tid] = s;
  __syncthreads();
  if (tid < cols) {
    float2 m = make_float2(0.0f, 0.0f);
    for (int g = 0; g < rstep; ++g) m = cadd(m, part[(g << logc) + tid]);
    mean[tid] = cscale(m, 1.0f / (float)n);
  }
  __syncthreads();

  // the stages, a -> b -> a ...; the first subtracts the means as it
  // reads, the last stores the intensity
  const ToIntensity store{out + (long long)p * n * kplane + k0, kplane,
                          min(cols, kplane - k0), n};
  float2* x = a;
  float2* y = b;
  int ns = 1;
#pragma unroll 1
  for (int i = 0; i < plan.nf; ++i) {
    const int r = plan.f[i];
    const bool last = i + 1 == plan.nf;
    if (i == 0 && last) {
      tf_stage<kMaxR, true>(r, x, mean, store, n, logc, ns, tws, tid, nt);
    } else if (i == 0) {
      tf_stage<kMaxR, true>(r, x, mean, ToTile{y, logc}, n, logc, ns, tws,
                            tid, nt);
    } else if (last) {
      tf_stage<kMaxR, false>(r, x, mean, store, n, logc, ns, tws, tid, nt);
    } else {
      tf_stage<kMaxR, false>(r, x, mean, ToTile{y, logc}, n, logc, ns, tws,
                             tid, nt);
    }
    __syncthreads();
    float2* t = x;
    x = y;
    y = t;
    ns *= r;
  }
}

template <int kMaxR>
int tf_launch(float* out, const float2* in, const float2* tw,
              const MixedPlan& plan, int n_probes, int nx, int ny,
              long long sp, long long st, long long sx, long long sy,
              int logc, int* info, cudaStream_t stream) {
  const auto kernel = time_fft_kernel<kMaxR>;
  const size_t smem = tf_smem(plan.n, logc);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kTfThreads, smem);
  }
  if (err != cudaSuccess) return (int)err;
  const int kplane = nx * ny;
  const unsigned tiles = (unsigned)((kplane + (1 << logc) - 1) >> logc);
  info[0] = (int)tiles;
  info[1] = per_sm;
  info[2] = kMaxR;
  info[3] = (int)smem;
  kernel<<<dim3(tiles, (unsigned)n_probes), kTfThreads, smem, stream>>>(
      out, in, tw, plan, ny, kplane, sp, st, sx, sy, logc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The time FFT of an (n_probes, n, nx, ny) complex64 block `in` with
// element strides (sp, st, sx, sy) into the contiguous float32 `out` of
// the same shape; tw the full twiddle table of n (exp(-2 pi i m / n), m <
// n); logc the plan's tile width (analysis/time_fft.py plan). Refused
// (cudaErrorInvalidValue): n outside [2, 4096], a stage radix above 31,
// a tile wider than 2^5 columns, a block past the shared memory an SM
// offers, or a plane of 2^31 points or more. info receives the tiles of a
// probe, the blocks an SM the occupancy query gives, the instantiation's
// largest radix and the dynamic shared memory in bytes.
int tf_time_fft(void* out, const void* in, const void* tw, int n_probes,
                int n, int nx, int ny, long long sp, long long st,
                long long sx, long long sy, int logc, int* info,
                void* stream) {
  if (n < 2 || n > 4096 || logc < 0 || logc > kTfMaxLogc || n_probes < 1 ||
      n_probes > 65535 || nx < 1 || ny < 1 ||
      (long long)nx * ny >= (1LL << 31) || tf_smem(n, logc) > 232448) {
    return (int)cudaErrorInvalidValue;
  }
  const MixedPlan plan = make_plan(n);
  int rmax = 0;
  for (int i = 0; i < plan.nf; ++i) rmax = plan.f[i] > rmax ? plan.f[i] : rmax;
  if (rmax > 31) return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
  float* o = (float*)out;
  const float2* x = (const float2*)in;
  const float2* w = (const float2*)tw;
  if (rmax <= 8) {
    return tf_launch<8>(o, x, w, plan, n_probes, nx, ny, sp, st, sx, sy,
                        logc, info, s);
  }
  if (rmax <= 16) {
    return tf_launch<16>(o, x, w, plan, n_probes, nx, ny, sp, st, sx, sy,
                         logc, info, s);
  }
  return tf_launch<31>(o, x, w, plan, n_probes, nx, ny, sp, st, sx, sy,
                       logc, info, s);
}

}  // extern "C"
