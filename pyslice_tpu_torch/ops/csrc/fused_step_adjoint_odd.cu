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
// No fast-math (sincosf for the phase mode). Plain C interface for ctypes:
// the function launches on the given stream and returns the CUDA error as
// an int.

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

}  // extern "C"
