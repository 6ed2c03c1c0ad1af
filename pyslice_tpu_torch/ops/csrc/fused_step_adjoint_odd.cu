// Kernel K8 for Hopper (sm_90a): the backward row pass of the O(1)-memory
// multislice adjoint on grids whose axes are not powers of two.
//
// Replaces the Pallas TPU kernel of pyslice_tpu/ops/fused_step_adjoint.py:
//   K8  pair-packed row pass, odd grids  <- _kernel_a_bwd_odd via
//       _call_a_bwd_odd (pallas_call at fused_step_adjoint.py:346)
//
// The work of K7 (fused_step_adjoint.cu, on the register engine of
// fft_regs.cuh) on the mixed-radix Stockham engine, for the (2 P, nx, ny)
// pair stream whose rows 2p and 2p + 1 are (a_p, lambda_p): IFFT_y of both
// members, vbar += -sigma Im(conj(lambda_p) a_p) summed over p in pair
// order, then in mid mode x t (the caller's conjugated plane, or the
// negated phase) and FFT_y, in last mode the real-space pair. The pair
// stream, the transmission plane and vbar all stay in natural order. The
// TPU kernel's digit-split tiles and its (dx, mx, dy, my) vbar stripe
// layout were limits of Pallas on the TPU and are not carried over.
//
// What bounds it on an H100: the pair stream in and out once and one t
// plane, 548 MB or 0.164 ms at 3.35 TB/s for 16 pairs x 1023^2 (data
// sheet), against which the design before this one took 0.96 ms (PERF.md):
// one block a tile, synchronous loads fenced by barriers, Stockham stages
// with their DFT constants in per-thread arrays (112/304 bytes of spills).
//
// The design is K4's and K5's (tile_async.cuh): persistent blocks whose
// three producer warps store the previous result and copy the next item
// into a third buffer (cp.async) while the consumers run tile_pass stages
// with constant-bank DFT constants. A tile is 2^logc lanes, lane 2r + c
// member c of row r, 2^(logc-1) rows (RowTileCopy<1>). The walk is row
// tile by row tile, each through all pairs in order (persistent_tiles with
// per = n_pairs), so the producers prefetch pair p + 1 of the same rows
// while pair p transforms, and the block's vbar rows stay in shared memory
// from the row tile's first pair to its last: the sum is taken in pair
// order by one thread an element, without atomics, and the same inputs
// give bit-identical vbar and output. pair_tile_compute holds the modes.
// Measured (PERF.md, scripts/time_col_pass_mr.py, H100 at 700 W): 0.64 ms
// in mid mode at 16 pairs x 1023^2 against 0.96 for the design it
// replaced.
//
// Shared memory (ops/fused_step_odd.py pair_tile_plan): three tile
// buffers, the twiddle table and the vbar rows, 8 (3 (n << logc) + n) +
// 4 n 2^(logc-1) bytes: 8 lanes (4 rows) up to n = 1076 (220,968 bytes at
// 1023, one block an SM, 256 row tiles on 132 SMs at nx = 1023), 4 lanes
// up to 2075, 2 lanes up to 3874. Above that (3968, 4096) not even two
// lanes fit beside the table, so the table stays in device memory, where
// sk_generic reads it anyway (kSharedTable false: 52 n bytes, 212,992 at
// 4096). The other way out, two buffers without prefetch, would give up
// the overlap of copies and stages that is this design's point; the table
// reads are one twiddle an item a stage, and they hit in L2.
//
// On the axes of REG_MR_AXES (1023 = 31 | 11 x 3, 513 = 19 | 3 x 3 x 3) K8
// runs instead on the register engine of fft_regs_mr.cuh
// (row_pass_bwd_mr_reg_kernel), as K4 and K5 do: a pair member's row stays
// in registers from the inverse's first stage to its store, one exchange
// through shared memory a transform, the two members of a position meet
// through a hand-off row in shared memory, and the next pair's rows are
// copied into shared memory while this pair transforms (below). Measured
// (PERF.md, scripts/time_col_pass_mr.py --tiles, H100 at 700 W): 1.62 ms
// in mid mode at 64 pairs x 1023^2 against the tiles' 2.45.
//
// No fast-math (sincosf for the phase mode). Plain C interface for ctypes:
// each function launches on the given stream and returns the CUDA error as
// an int.

#include "fft_regs_mr.cuh"
#include "tile_async.cuh"

namespace {

// K8: unit u is rows u << (logc - 1) .. of every pair; item v is pair
// v % n_pairs of row tile v / n_pairs. t is the (nx, ny) complex plane or,
// with kPhase, sv the phase; neither is read in last mode.
template <bool kPhase, bool kSharedTable>
__global__ void __launch_bounds__(kMaxThreads, 1)
row_pass_bwd_mr_kernel(float2* out, const float2* in,
                       const float2* __restrict__ t,
                       const float* __restrict__ sv, float* __restrict__ vbar,
                       MixedEng ey, int n_pairs, int nx, int logc,
                       int n_tiles, int last, float nsigma) {
  extern __shared__ __align__(16) float2 smem16[];
  const int n = ey.n;
  const size_t slots = (size_t)n << logc;
  const float2* tws = ey.tw;
  float* vb = reinterpret_cast<float*>(smem16 + 3 * slots);
  if constexpr (kSharedTable) {
    float2* table = smem16 + 3 * slots;
    for (int i = threadIdx.x; i < n; i += blockDim.x) table[i] = ey.tw[i];
    tws = table;
    vb = reinterpret_cast<float*>(table + n);
  }
  const int logr = logc - 1;
  // stages: 2 nf for mid, nf for last
  const bool odd = last && (ey.plan.nf & 1);
  const float nsig = nsigma / ((float)n * (float)n);
  persistent_tiles(
      smem16, slots, n_tiles, n_pairs, odd, out,
      [&](float2* s, int v) {
        return RowTileCopy<1>{s, in, n, nx, v % n_pairs,
                              (v / n_pairs) << logr, logc};
      },
      [&](float2* cur, float2* spare, int v, int tid, int nt) {
        const int p = v % n_pairs;
        const size_t x0 = (size_t)((v / n_pairs) << logr);
        const RowT<kPhase, 1> m{kPhase ? nullptr : t + x0 * n,
                                kPhase ? sv + x0 * n : nullptr, n,
                                nx - (int)x0, 1.0f / (float)n};
        pair_tile_compute(ey, cur, spare, tws, vb, vbar + x0 * n, m,
                          last != 0, p == 0, p == n_pairs - 1, nsig, logc,
                          tid, nt);
      });
}

// Host: K8's shared memory: the tile buffers, the twiddle table where it
// sits there, and 2^(logc-1) vbar rows of n floats.
size_t pair_tile_smem(int n, int logc, bool shared_table) {
  return (kBuffers * ((size_t)n << logc) + (shared_table ? n : 0)) *
             sizeof(float2) +
         ((size_t)n << (logc - 1)) * sizeof(float);
}

// K8 on the register engine of fft_regs_mr.cuh, for the axes of
// REG_MR_AXES (ops/fused_step_odd.py pair_plan; rows of ny = N1 x N2). A
// block walks items j: pair j mod P of its row tile j / P (row tiles u =
// blockIdx.x + i gridDim.x, rows kPairRows u ..), so it takes each row
// tile through the pairs in order. Lane c = tid / T is member c & 1 of row
// c >> 1 (a at 2r, lambda at 2r + 1), k = tid mod T of the T a transform
// walking neighbouring elements of the row, as K4's register kernel. An
// item:
//   rows     the item's 2 kPairRows rows are in shared memory (`next`),
//            copied there (cp.async) while the item before transformed
//   inverse  thread j < N1 reads X[j + N1 r] of its member's row, the
//            radix-N2 group, the exchange; a barrier, then the next item's
//            copies are issued into the rows just read; thread k < N2 then
//            holds x[k + N2 m], m < N1 (unnormalized), and the a-thread
//            puts its values to the row's hand-off row
//   vbar     after the barrier that ends the inverse's reads, the
//            lambda-thread of the same k reads a there and adds
//              nsig * Im(conj(lambda) a)     (nsig = -sigma / n^2)
//            to its N1 sums in the block's vbar rows in shared memory,
//            zeroed at the row tile's first pair and stored to vbar at its
//            last: one owner an element, the pairs in order, no atomics,
//            so the same inputs give the same bits
//   mid      x t / n, the forward (one exchange), thread j < N1 stores
//            X[j + N1 q], the positions it read
//   last     x 1 / n, thread k stores x[k + N2 m]
// and a last barrier, after the next item's copies have landed. The
// hand-off rows are a buffer of their own, so that they need no barrier of
// their own: four barriers an item in mid (K4's) and three in last. t / n
// (the complex plane t, or with kPhase cos and sin of the phase sv) is put
// in shared memory once a row tile, at its first pair, so that no thread
// holds it in registers across the inverse (with 31 values of t a thread
// the kernel spilled at 1023) and the phase's sincosf runs once a row
// tile; neither is read in last mode. The V-bar sums sit in shared memory
// for the same reason (in registers they spilled 288 bytes). A row past
// nx (the last tile) reads row nx - 1 and stores nothing. `out` may equal
// `in`: an item's rows are read whole before any of them is written, and
// the next item's are other rows.
constexpr int kPairLogc = 3;                      // lanes a block: 8
constexpr int kPairRows = 1 << (kPairLogc - 1);   // pair rows a block: 4

template <bool kPhase, int R1, int... R2>
__global__ void __launch_bounds__(MrAxis<R1, R2...>::T << kPairLogc, 1)
row_pass_bwd_mr_reg_kernel(float2* out, const float2* in,
                           const float2* __restrict__ t,
                           const float* __restrict__ sv,
                           float* __restrict__ vbar,
                           const float2* __restrict__ tw, int n_pairs,
                           int nx, int n_tiles, int last, float nsig) {
  using Ax = MrAxis<R1, R2...>;
  constexpr int n = Ax::n;
  constexpr int N1 = Ax::N1;
  constexpr int N2 = Ax::N2;
  constexpr int kSlots = n << kPairLogc;      // a buffer of the block's lanes
  extern __shared__ __align__(16) float2 smem16[];
  float2* next = smem16 + kSlots;             // the next item's rows
  float2* hand = next + kSlots;               // the hand-off rows
  float2* ts = hand + kPairRows * n;          // the row tile's t / n
  float2* tws = ts + kPairRows * n;           // the stage twiddles
  float* vbs = reinterpret_cast<float*>(tws + n);   // the vbar rows
  mr_table<Ax>(tws, tw);
  const int c = threadIdx.x / Ax::T;
  const int k = threadIdx.x - c * Ax::T;
  const bool lam = (c & 1) != 0;
  float2* const xr = smem16 + c * n;
  const auto xs = [&](int e) { return xr + e; };
  const float2* const nr = next + c * n;
  float2* const hr = hand + (c >> 1) * n;
  const float2* const tr = ts + (c >> 1) * n;
  float* const vb = vbs + (c >> 1) * n + k;   // this thread's sums, N2 apart
  const float scale = 1.0f / (float)n;
  // item j of the block: pair j mod P of its row tile j / P; its copy
  // (cp.async, 8 bytes: a row of odd n is 8 bytes off 16 every other row)
  // puts lane l's row at next + l n
  const int n_items = ((n_tiles - 1 - (int)blockIdx.x) / gridDim.x + 1) *
                      n_pairs;
  const auto issue = [&](int j) {
    const int u = blockIdx.x + (j / n_pairs) * gridDim.x;
    const int p = j % n_pairs;
    for (int q = threadIdx.x; q < kSlots; q += blockDim.x) {
      const int l = q / n;
      const int xl = min(u * kPairRows + (l >> 1), nx - 1);
      cp_async8(next + q, in + ((size_t)(2 * p + (l & 1)) * nx + xl) * n +
                              (q - l * n), true);
    }
    cp_async_commit();
  };
  issue(0);
  cp_async_wait_all();
  __syncthreads();
  for (int j = 0; j < n_items; ++j) {
    const int u = blockIdx.x + (j / n_pairs) * gridDim.x;
    const int p = j % n_pairs;
    const int x = u * kPairRows + (c >> 1);
    const int xc = min(x, nx - 1);
    float2* dst = out + ((size_t)(2 * p + (c & 1)) * nx + xc) * n;
    if (p == 0) {
      if (lam && k < N2) {
#pragma unroll
        for (int m = 0; m < N1; ++m) vb[N2 * m] = 0.0f;
      }
      // the row tile's t / n, read after the next barrier but one
      for (int q = threadIdx.x; !last && q < kPairRows * n;
           q += blockDim.x) {
        const size_t g = (size_t)min(u * kPairRows + q / n, nx - 1) * n +
                         q % n;
        float2 w;
        if constexpr (kPhase) {
          sincosf(__ldg(&sv[g]), &w.y, &w.x);
        } else {
          w = __ldg(&t[g]);
        }
        ts[q] = cscale(w, scale);
      }
    }
    float2 v[kMrE];
    if (k < N1) {
#pragma unroll
      for (int r = 0; r < N2; ++r) v[r] = nr[k + N1 * r];
      Ax::template group<true>(v);
      mr_inv_put<Ax>(v, k, xs);
    }
    __syncthreads();    // the item's rows read: the next item's copies
    if (j + 1 < n_items) issue(j + 1);
    if (k < N2) {
      mr_inv_second<Ax>(v, k, xs, tws, [&](int m, float2 y) { v[m] = y; });
      if (!lam) {
#pragma unroll
        for (int m = 0; m < N1; ++m) hr[k + N2 * m] = v[m];
      }
    }
    __syncthreads();    // the inverse's reads are done, a handed over
    if (k < N2) {
      if (lam) {
#pragma unroll
        for (int m = 0; m < N1; ++m) {
          const float2 a = hr[k + N2 * m];
          vb[N2 * m] += nsig * (v[m].x * a.y - v[m].y * a.x);
        }
      }
#pragma unroll
      for (int m = 0; m < N1; ++m) {
        v[m] = last ? cscale(v[m], scale) : cmul(v[m], tr[k + N2 * m]);
      }
      if (last && x < nx) {
#pragma unroll
        for (int m = 0; m < N1; ++m) dst[k + N2 * m] = v[m];
      }
    }
    if (!last) {
      if (k < N2) mr_fwd_first<Ax>(v, k, xs);
      __syncthreads();
      if (k < N1 && x < nx) {
        mr_fwd_second<Ax>(v, k, xs, tws);
#pragma unroll
        for (int q = 0; q < N2; ++q) dst[k + N1 * q] = v[q];
      }
    }
    if (p == n_pairs - 1 && lam && k < N2 && x < nx) {
#pragma unroll
      for (int m = 0; m < N1; ++m) {
        vbar[(size_t)x * n + k + N2 * m] = vb[N2 * m];
      }
    }
    cp_async_wait_all();
    __syncthreads();    // the exchange's reads done, the next rows landed
  }
}

// Host: the register K8's shared memory: the exchange buffer and the next
// item's buffer, each of 2^kPairLogc lanes of n, kPairRows hand-off rows,
// kPairRows rows of t / n, the table of stage twiddles and kPairRows vbar
// rows of n floats.
size_t pair_reg_smem(int n) {
  return ((size_t)n * (2 << kPairLogc) + (size_t)n * (2 * kPairRows + 1)) *
             sizeof(float2) +
         (size_t)n * kPairRows * sizeof(float);
}

// Host: launch the register K8 on the axis R1 | R2... (see
// fs_row_pass_bwd_mr_reg).
template <int R1, int... R2>
int launch_pair_reg(float2* out, const float2* in, const float2* t,
                    const float* sv, float* vbar, const float2* tw,
                    int n_pairs, int nx, int last, float nsigma, int logc,
                    int threads, int* info, cudaStream_t stream) {
  using Ax = MrAxis<R1, R2...>;
  if (logc != kPairLogc || threads != Ax::T << kPairLogc || n_pairs < 1 ||
      (!last && t == nullptr && sv == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = !last && sv != nullptr
                          ? row_pass_bwd_mr_reg_kernel<true, R1, R2...>
                          : row_pass_bwd_mr_reg_kernel<false, R1, R2...>;
  const size_t smem = pair_reg_smem(Ax::n);
  const int tiles = (nx + kPairRows - 1) / kPairRows;
  const cudaError_t err = persistent_grid(kernel, threads, smem, tiles, info);
  if (err != cudaSuccess) return (int)err;
  const float nsig = nsigma / ((float)Ax::n * (float)Ax::n);
  kernel<<<(unsigned)info[0], threads, smem, stream>>>(
      out, in, t, sv, vbar, tw, n_pairs, nx, tiles, last, nsig);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K8. t the complex plane, or sv the phase (t null); both null in last
// mode. logc, threads (the consumers; the block adds the producers) and
// shared_table (the twiddle table in shared memory, else device memory):
// the tile plan (ops/fused_step_odd.py pair_tile_plan). info receives the
// grid, blocks per SM, SMs and the dynamic shared memory in bytes.
int fs_row_pass_bwd_mr(void* out, const void* in, const void* t,
                       const void* sv, void* vbar, const void* tw,
                       int n_pairs, int nx, int ny, int last, float nsigma,
                       int logc, int threads, int shared_table, int* info,
                       void* stream) {
  const MixedEng ey = mixed_eng(tw, ny);
  if (!plan_ok(ey.plan, logc, threads) || logc < 1 || n_pairs < 1 ||
      (!last && t == nullptr && sv == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = pair_tile_smem(ny, logc, shared_table != 0);
  const int block = threads + kProducers;
  const int rows = 1 << (logc - 1);
  const int tiles = (nx + rows - 1) / rows;
  const bool phase = !last && sv != nullptr;
  const auto kernel =
      phase ? (shared_table ? row_pass_bwd_mr_kernel<true, true>
                            : row_pass_bwd_mr_kernel<true, false>)
            : (shared_table ? row_pass_bwd_mr_kernel<false, true>
                            : row_pass_bwd_mr_kernel<false, false>);
  const cudaError_t err = persistent_grid(kernel, block, smem, tiles, info);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)info[0], block, smem, (cudaStream_t)stream>>>(
      (float2*)out, (const float2*)in, (const float2*)t, (const float*)sv,
      (float*)vbar, ey, n_pairs, nx, logc, tiles, last, nsigma);
  return (int)cudaGetLastError();
}

// K8 on the register engine, for an axis ny of REG_MR_AXES
// (ops/fused_step_odd.py pair_plan): the arguments of fs_row_pass_bwd_mr
// but shared_table, logc and threads those of the axis's instantiation
// below; tw the full twiddle table of ny. Any other axis or plan is
// refused (cudaErrorInvalidValue).
int fs_row_pass_bwd_mr_reg(void* out, const void* in, const void* t,
                           const void* sv, void* vbar, const void* tw,
                           int n_pairs, int nx, int ny, int last,
                           float nsigma, int logc, int threads, int* info,
                           void* stream) {
  float2* o = (float2*)out;
  const float2* i = (const float2*)in;
  const float2* tp = (const float2*)t;
  const float* ph = (const float*)sv;
  float* vb = (float*)vbar;
  const float2* w = (const float2*)tw;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ny) {
    case 1023:
      return launch_pair_reg<31, 11, 3>(o, i, tp, ph, vb, w, n_pairs, nx,
                                        last, nsigma, logc, threads, info, s);
    case 513:
      return launch_pair_reg<19, 3, 3, 3>(o, i, tp, ph, vb, w, n_pairs, nx,
                                          last, nsigma, logc, threads, info,
                                          s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
