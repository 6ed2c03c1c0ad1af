// K6, the resident slice loop for Hopper (sm_90a): every slice of a frame
// in one launch.
//
// Replaces two Pallas TPU kernels:
//   #5  _kernel_resident   (pallas_call at pyslice_tpu/ops/fused_step_resident.py:250),
//       power-of-two grids -> resident_reg_kernel (the register engine)
//   #8  _kernel            (pallas_call at pyslice_tpu/ops/fused_step_odd_resident.py:369),
//       odd and mixed-radix grids -> resident_mr_kernel (the persistent
//       mixed-radix tiles)
//
// On the TPU the grid (probes, nz) runs in order on one core and the wave
// stays in VMEM scratch between slices. A Hopper block has 227 KB of shared
// memory, and even a 16-SM cluster's distributed shared memory (~3.6 MB)
// does not hold a 1024^2 complex64 wave (8 MB). The 50 MB L2 does. So K6
// is a persistent cooperative kernel: launched with
// cudaLaunchCooperativeKernel at no more blocks than can be resident at
// once, it walks the slices itself,
//
//   s = 0:          row phase  "first"  (x t_0, FFT_y)       psi -> state
//   s = 1 .. nz-1:  grid sync, column phase (FFT_x, x P / nx, IFFT_x) on
//                   state, grid sync, row phase "mid" (IFFT_y, x t_s / ny,
//                   FFT_y), or "last" (IFFT_y, x t_s / ny) into out on the
//                   last slice
//   k space:        the last row phase runs as "mid", then grid sync and a
//                   column phase FFT_x stored fftshifted into out, frequency
//                   (kx, y) at ((kx + nx/2) mod nx, (y + ny/2) mod ny), the
//                   store form of fftshift (right for odd n too)
//
// with cooperative_groups::this_grid().sync() between phases. The state is
// a device buffer the wrapper allocates (P nx ny complex64); at the sizes
// the dispatch sends here (P nx ny < 3 * 2^20 points, <= 24 MB) it stays in
// L2 between phases. Each block walks row tiles and column tiles of each
// phase in a grid-stride loop. The state is written by other blocks in the
// phase before, so it is read through L2 (ld.global.cg, cp.async.cg), never
// through L1 or the read-only path; psi, t, sigma*V and the Fresnel plane
// are read-only for the launch.
//
// The engines are those of the two-pass chains, phase by phase:
//
// * Power-of-two grids (resident_reg_kernel): the register engine of
//   fft_regs.cuh. A row phase is kernel A's body (fused_step.cu
//   row_pass_kernel): a thread loads its 32 values of a row straight from
//   the wave, runs IFFT_y, x t and FFT_y on them in registers (with the
//   phase sigma*V, every phase of the thread is loaded before the first
//   sincosf and its cos/sin kept in the thread's own shared-memory slots)
//   and stores them. A column phase is kernel B's (col_pass_kernel):
//   FFT_x, x prop / nx, IFFT_x in registers. The k-space tail is B's FFT_x,
//   stored shifted: the engine leaves natural order, so the shift is the
//   store index alone. One block shape serves both phases: 2^logc lanes of
//   n / 32 threads each (the same count of threads on both axes), at most
//   128 threads, under A's launch bound (128 x 3: 168 registers a thread,
//   its transforms beside the product's loads without spills); the block
//   narrows, down to one warp, only while a phase would have fewer tiles
//   than a quarter of the SMs (ops/fused_step_resident.py resident_plan:
//   narrower blocks measured slower at 1 x 512^2 and 1 x 1024^2). At
//   1 x 1024^2: 4-row and 4-column tiles of 128 threads, 256 tiles a
//   phase, one 33,792-byte exchange buffer (66,560 bytes with the phase's
//   slots), three blocks an SM. A 4-column tile reads 32-byte row
//   segments, one L2 sector each.
//
// * Other grids (resident_mr_kernel): K4's and K5's persistent tiles
//   (tile_async.cuh). Each phase is one persistent walk: three producer
//   warps store the block's previous tile and copy its next one while 288
//   consumer threads run the tile_pass stages (DFT constants in the
//   constant bank): rows K4's modes, columns K5's pass, the k-space tail
//   one forward transform, each product (t, the Fresnel plane) a
//   product_pass of its own. A walk leaves no copy in flight (its
//   producers wait for every group they commit), so nothing crosses a
//   grid barrier. The state's 8-byte copies are loads through L2
//   (l2_copy8), its 16-byte ones cp.async.cg. The block keeps both axes'
//   twiddle tables in shared memory beside three tile buffers. The tiles
//   are as wide as K4's (8 lanes at 1023, 212,784 bytes with the tables)
//   and narrow only while the narrower tiling still gives each tile a
//   block of its own (1 x 387^2: 4 lanes). At one probe a phase is one
//   tile a block, its stages most of its time; with code of its own in
//   each phase (the walk and its transforms inlined at each, as in K4 and
//   K5) a block's first tile in a phase ran its stages from cold
//   instruction caches, about three times slower than its second. So
//   every phase goes through one call of the walk, every tile through one
//   inverse and one forward transform in code, and each stage is a
//   function of its own (k6_pass): each stage's code exists once and the
//   phases share it (1.48 -> 0.93 ms at 1 x 1023^2 on an H100 at 700 W,
//   PERF.md). Called from the three walks of each phase instead, the
//   stages spilled 76-92 bytes around each call; inlined into the one
//   walk, they ran 27% slower.
//
// What bounds it: at 1 x 1024^2 x 14 slices a launch reads psi and the t
// stack and writes the exit wave, (2 + 14) 8 MB (the state and the Fresnel
// plane sit in L2), 0.040 ms at 3.35 TB/s; its FFT work is 2.9 GFLOP,
// 0.043 ms at 67 TFLOP/s FP32 (data sheet). It runs 27 phases and 26 grid
// barriers (27 with k space). Measured on an H100 at 700 W (PERF.md): the
// barriers alone (fs_resident_barriers) take ~0.035 ms; the design before
// this one (one block a tile, radix-16 or Stockham stages in shared
// memory with a barrier each and a device-memory twiddle a butterfly)
// took 0.80 ms at 1024^2 and 1.38 ms at 1023^2, this one ~0.40 and ~0.93.
//
// The grid may be at most cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// SMs for the launch's block and dynamic shared memory; the launch returns
// cudaErrorCooperativeLaunchTooLarge above that, and the wrapper raises.
//
// No fast-math (sincosf for the phase form, whose arguments run to tens of
// radians). Plain C interface for ctypes: each function launches on the
// given stream and returns the CUDA error as an int.

#include <cooperative_groups.h>

#include "fft_regs.cuh"

namespace cg = cooperative_groups;

namespace {

// The register engine's launch bound: A's transform modes (fused_step.cu).
constexpr int kRegResThreads = 128;
constexpr int kRegResBlocks = 3;


// --- power-of-two grids: the register engine ---------------------------------

// Row tile u of a row phase (A's body, kMode first / mid / last): rows
// (u % tpp) << logc .. of probe u / tpp; thread tid takes element t + T m
// of row c, t = tid mod T, c = tid / T (T = ny / 32). t is the slice's
// (nx, ny) complex plane or, with kPhase, sv its phase. The thread's phase
// slots follow the tile buffer. `out` may equal `in`: each value is read
// by the thread that writes it, before it writes it.
template <bool kPhase, int kMode>
__device__ __forceinline__ void reg_row_tile(
    float2* out, const float2* in, const float2* __restrict__ tp,
    const float* __restrict__ sv, const RegGeo& g, float2* xs, int nx,
    int logc, int tpp, int u) {
  constexpr bool kInv = kMode == kMid || kMode == kLast;
  constexpr bool kFwd = kMode == kFirst || kMode == kMid;
  const int n = g.n;
  const int T = g.T;
  const int t = threadIdx.x & (T - 1);
  const int c = threadIdx.x / T;
  const int rowslots = n + (n >> 5);
  const XMap xm{1, c * rowslots};
  const float scale = kInv ? 1.0f / (float)n : 1.0f;
  const int x = ((u % tpp) << logc) + c;
  const size_t row = ((size_t)(u / tpp) * nx + x) * n + t;
  const size_t k0 = (size_t)x * n + t;
  float2* slots = xs + (rowslots << logc) + threadIdx.x;
  if constexpr (kPhase) {
    // kPh phases at a time, each kPh loaded before the first of their
    // sincosf, whose branch would otherwise hold each load back behind the
    // one before (A loads all 32 at once; in K6's kernel, which holds
    // every mode, that spilled 40 bytes; 4, 8 and 16 at a time do not)
    constexpr int kPh = 16;
#pragma unroll 1
    for (int m0 = 0; m0 < kRegE; m0 += kPh) {
      float ph[kPh];
#pragma unroll
      for (int j = 0; j < kPh; ++j) ph[j] = __ldg(&sv[k0 + (m0 + j) * T]);
#pragma unroll
      for (int j = 0; j < kPh; ++j) {
        float2 f;
        sincosf(ph[j], &f.y, &f.x);
        slots[(m0 + j) * blockDim.x] = f;
      }
    }
  }
  float2 v[kRegE];
#pragma unroll
  for (int m = 0; m < kRegE; ++m) v[m] = __ldcg(&in[row + m * T]);
  if constexpr (kInv) reg_fft<true>(v, g, xs, xm, t);
  if constexpr (kPhase) {
    mul_plane<false>(v, slots, blockDim.x, scale);
  } else {
    mul_plane<true>(v, tp + k0, T, scale);
  }
  if constexpr (kFwd) reg_fft<false>(v, g, xs, xm, t);
#pragma unroll
  for (int m = 0; m < kRegE; ++m) out[row + m * T] = v[m];
}

// Column tile u of a column phase (B's body): columns (u % tpp) << logc ..
// of probe u / tpp (nx = g.n rows); thread tid takes element (row)
// t + T m of column c, c = tid mod 2^logc, t = tid >> logc. Without
// kKspace: FFT_x, x prop / nx, IFFT_x, stored in place. With kKspace:
// FFT_x, frequency kx = t + T m stored at row (kx + nx/2) mod nx =
// t + T ((m + 16) mod 32) and column (y + ny/2) mod ny of `out`.
template <bool kKspace>
__device__ __forceinline__ void reg_col_tile(float2* out, const float2* in,
                                             const float2* __restrict__ prop,
                                             const RegGeo& g, float2* xs,
                                             int ny, int logc, int tpp,
                                             int u) {
  const int n = g.n;
  const int c = threadIdx.x & ((1 << logc) - 1);
  const int t = threadIdx.x >> logc;
  const XMap xm{1 << logc, c};
  const int step = g.T * ny;    // below 2^31 / 32: n ny <= 4096^2
  const int y = ((u % tpp) << logc) + c;
  const size_t base = (size_t)(u / tpp) * n * ny + (size_t)t * ny;
  float2 v[kRegE];
#pragma unroll
  for (int m = 0; m < kRegE; ++m) v[m] = __ldcg(&in[base + y + m * step]);
  reg_fft<false>(v, g, xs, xm, t);
  if constexpr (kKspace) {
    const int ys = (y + (ny >> 1)) & (ny - 1);
#pragma unroll
    for (int m = 0; m < kRegE; ++m) {
      out[base + ys + ((m + kRegE / 2) & (kRegE - 1)) * step] = v[m];
    }
  } else {
    mul_plane<true>(v, prop + (size_t)t * ny + y, step, 1.0f / (float)n);
    reg_fft<true>(v, g, xs, xm, t);
#pragma unroll
    for (int m = 0; m < kRegE; ++m) out[base + y + m * step] = v[m];
  }
}

// K6 on power-of-two grids. Row tiles of 2^logc_r rows (A), column tiles
// of 2^logc_c columns (B); blockDim.x = (ny / 32) << logc_r =
// (nx / 32) << logc_c. t is the (nz, nx, ny) complex stack or, with
// kPhase, sv the phase stack.
template <bool kPhase>
__global__ void __launch_bounds__(kRegResThreads, kRegResBlocks)
resident_reg_kernel(float2* out, float2* state, const float2* psi,
                    const float2* __restrict__ t,
                    const float* __restrict__ sv,
                    const float2* __restrict__ prop, RegGeo gx, RegGeo gy,
                    int n_probes, int nz, int logc_r, int logc_c,
                    int kspace) {
  extern __shared__ __align__(16) float2 xs[];
  cg::grid_group grid = cg::this_grid();
  const int nx = gx.n;
  const int ny = gy.n;
  const size_t plane = (size_t)nx * ny;
  const int rtpp = nx >> logc_r;
  const int ctpp = ny >> logc_c;
  const int rwork = n_probes * rtpp;
  const int cwork = n_probes * ctpp;
  for (int u = blockIdx.x; u < rwork; u += gridDim.x) {
    reg_row_tile<kPhase, kFirst>(state, psi, t, sv, gy, xs, nx, logc_r,
                                 rtpp, u);
  }
  for (int s = 1; s < nz; ++s) {
    grid.sync();
    for (int u = blockIdx.x; u < cwork; u += gridDim.x) {
      reg_col_tile<false>(state, state, prop, gx, xs, ny, logc_c, ctpp, u);
    }
    grid.sync();
    const float2* ts = kPhase ? nullptr : t + s * plane;
    const float* svs = kPhase ? sv + s * plane : nullptr;
    if (s == nz - 1 && !kspace) {
      for (int u = blockIdx.x; u < rwork; u += gridDim.x) {
        reg_row_tile<kPhase, kLast>(out, state, ts, svs, gy, xs, nx, logc_r,
                                    rtpp, u);
      }
    } else {
      for (int u = blockIdx.x; u < rwork; u += gridDim.x) {
        reg_row_tile<kPhase, kMid>(state, state, ts, svs, gy, xs, nx, logc_r,
                                   rtpp, u);
      }
    }
  }
  if (kspace) {
    grid.sync();
    for (int u = blockIdx.x; u < cwork; u += gridDim.x) {
      reg_col_tile<true>(out, state, nullptr, gx, xs, ny, logc_c, ctpp, u);
    }
  }
}

// --- other grids: the persistent mixed-radix tiles ---------------------------

// One Stockham stage of K6's mixed-radix transforms: tile_pass with no
// operand (the products are passes of their own), compiled once as a
// function of its own and called, so that it has every register to
// itself (inlined into the walk, with the walk's state live around it,
// the same stages ran 27% slower on an H100, PERF.md).
template <int R, bool kInv>
__device__ __noinline__ void k6_pass(const float2* in, float2* out, int n,
                                     int logc, int ns, const float2* tws,
                                     int tid, int nt) {
  tile_pass<R, kInv>(in, out, NoOp{}, n, logc, ns, tws, tid, nt);
}

// A transform of the tile in `a` (`b` the second buffer) on the first nt
// threads, each stage fenced by bar_sync_first(nt); on return `a` holds
// the result. A prime above 31 takes sk_generic's direct sum on the
// device-memory table.
template <bool kInv>
__device__ __forceinline__ void k6_transform(const MixedEng& e, float2*& a,
                                             float2*& b, const float2* tws,
                                             int logc, int tid, int nt) {
  int ns = 1;
  for (int i = 0; i < e.plan.nf; ++i) {
    const int r = e.plan.f[i];
    switch (r) {
      case 2: k6_pass<2, kInv>(a, b, e.n, logc, ns, tws, tid, nt); break;
      case 3: k6_pass<3, kInv>(a, b, e.n, logc, ns, tws, tid, nt); break;
      case 4: k6_pass<4, kInv>(a, b, e.n, logc, ns, tws, tid, nt); break;
      case 5: k6_pass<5, kInv>(a, b, e.n, logc, ns, tws, tid, nt); break;
      case 7: k6_pass<7, kInv>(a, b, e.n, logc, ns, tws, tid, nt); break;
      case 8: k6_pass<8, kInv>(a, b, e.n, logc, ns, tws, tid, nt); break;
      case 16: k6_pass<16, kInv>(a, b, e.n, logc, ns, tws, tid, nt); break;
      case 11: k6_pass<11, kInv>(a, b, e.n, logc, ns, tws, tid, nt); break;
      case 13: k6_pass<13, kInv>(a, b, e.n, logc, ns, tws, tid, nt); break;
      case 17: k6_pass<17, kInv>(a, b, e.n, logc, ns, tws, tid, nt); break;
      case 19: k6_pass<19, kInv>(a, b, e.n, logc, ns, tws, tid, nt); break;
      case 23: k6_pass<23, kInv>(a, b, e.n, logc, ns, tws, tid, nt); break;
      case 29: k6_pass<29, kInv>(a, b, e.n, logc, ns, tws, tid, nt); break;
      case 31: k6_pass<31, kInv>(a, b, e.n, logc, ns, tws, tid, nt); break;
      default: sk_generic<kInv>(a, b, e.n, r, logc, ns, e.tw, tid, nt);
    }
    bar_sync_first(nt);
    float2* t = a;
    a = b;
    b = t;
    ns *= r;
  }
}

enum PhaseKind { kRowPhase, kColPhase, kKspacePhase };

// The copies of a phase's tiles: a row tile (K4's) or a column tile
// (K5's), both through L2, stored in place or, in the k-space tail,
// shifted: frequency (kx, y) to ((kx + nx/2) mod nx, (y + ny/2) mod ny),
// 8 bytes a store (a shifted row segment may wrap).
struct PhaseTile {
  int kind;
  RowTileCopy<0, true> r;
  TileCopyT<true> c;

  __device__ void issue(int tid, int nt) const {
    if (kind == kRowPhase) {
      r.issue(tid, nt);
    } else {
      c.issue(tid, nt);
    }
  }

  __device__ void store(float2* out, int tid, int nt) const {
    if (kind == kRowPhase) {
      r.store(out, tid, nt);
      return;
    }
    if (kind == kColPhase) {
      c.store(out, tid, nt);
      return;
    }
    const int n = c.n;
    const int cmask = (1 << c.logc) - 1;
    const int tot = n << c.logc;
    float2* dst = out + (size_t)c.p * n * c.ny;
    for (int q = tid; q < tot; q += nt) {
      const int i = q >> c.logc;
      const int y = c.y0 + (q & cmask);
      if (y >= c.ny) continue;
      const int ox = i + (n >> 1) < n ? i + (n >> 1) : i + (n >> 1) - n;
      const int oy =
          y + (c.ny >> 1) < c.ny ? y + (c.ny >> 1) : y + (c.ny >> 1) - c.ny;
      dst[(size_t)ox * c.ny + oy] = c.s[q];
    }
  }
};

// K6 on other grids: consumers blockDim.x - kProducers. Row tiles of
// 2^logc_r rows (K4's), column tiles of 2^logc_c columns (K5's); three
// buffers of `slots` slots, then the twiddle tables of x and y. t is the
// (nz, nx, ny) complex stack or, with kPhase, sv the phase stack. vec16:
// the column tiles' 16-byte copies (an even ny, aligned tensors).
//
// Every phase runs through one call of the walk, and every tile through
// one inverse and one forward transform in code (a loop of two steps
// around the pass's product), whose stages are the calls of k6_pass: so
// every phase runs the same stage code. With a walk and its transforms
// inlined at each phase, as K4's and K5's are, each phase ran code of its
// own, and a block's first tile in every phase ran its stages cold, three
// times slower than its second (PERF.md).
template <bool kPhase>
__global__ void __launch_bounds__(kMaxThreads, 1)
resident_mr_kernel(float2* out, float2* state, const float2* psi,
                   const float2* __restrict__ t, const float* __restrict__ sv,
                   const float2* __restrict__ prop, MixedEng ex, MixedEng ey,
                   int n_probes, int nz, int logc_r, int logc_c, int slots,
                   int vec16, int kspace) {
  extern __shared__ __align__(16) float2 smem16[];
  cg::grid_group grid = cg::this_grid();
  const int nx = ex.n;
  const int ny = ey.n;
  const size_t plane = (size_t)nx * ny;
  float2* twx = smem16 + 3 * (size_t)slots;
  float2* twy = twx + nx;
  // ordered before any stage by the first barrier of the first walk
  for (int i = threadIdx.x; i < nx; i += blockDim.x) twx[i] = ex.tw[i];
  for (int i = threadIdx.x; i < ny; i += blockDim.x) twy[i] = ey.tw[i];
  const int rtpp = (nx + (1 << logc_r) - 1) >> logc_r;
  const int ctpp = (ny + (1 << logc_c) - 1) >> logc_c;
  const int rwork = n_probes * rtpp;
  const int cwork = n_probes * ctpp;
  const bool vec = vec16 != 0;
  // phase 2s: slice s's row phase; 2s - 1: the column phase before it;
  // 2 nz - 1: the k-space tail
  const int n_phases = 2 * nz - 1 + (kspace ? 1 : 0);
  for (int ph = 0; ph < n_phases; ++ph) {
    if (ph > 0) grid.sync();
    const int kind = ph == 2 * nz - 1 ? kKspacePhase
                     : (ph & 1)       ? kColPhase
                                      : kRowPhase;
    const bool row = kind == kRowPhase;
    const int s = ph >> 1;
    const int mode = !row                         ? kMid
                     : s == 0                     ? kFirst
                     : (s == nz - 1 && !kspace)   ? kLast
                                                  : kMid;
    // the two transforms around the product: 0 none, 1 inverse, 2 forward
    const int dir0 = row ? (mode == kFirst ? 0 : 1) : 2;
    const int dir1 = row                  ? (mode == kLast ? 0 : 2)
                     : kind == kColPhase  ? 1
                                          : 0;
    const MixedEng& e = row ? ey : ex;
    const int nf = e.plan.nf;
    const bool odd = (((dir0 != 0) + (dir1 != 0)) * nf) & 1;
    const float2* src = (row && s == 0) ? psi : state;
    float2* dst = (mode == kLast || kind == kKspacePhase) ? out : state;
    const int work = row ? rwork : cwork;
    if (blockIdx.x >= work) continue;
    persistent_tiles(
        smem16, slots, work, 1, odd, dst,
        [&](float2* sb, int v) {
          return PhaseTile{
              kind,
              RowTileCopy<0, true>{sb, src, ny, nx, v / rtpp,
                                   (v % rtpp) << logc_r, logc_r},
              TileCopyT<true>{sb, state, nx, ny, v / ctpp,
                              (v % ctpp) << logc_c, logc_c, vec}};
        },
        [&](float2* cur, float2* spare, int u, int tid, int nt) {
          float2* a = cur;
          float2* b = spare;
          const float2* tws = row ? twy : twx;
          const int logc = row ? logc_r : logc_c;
#pragma unroll 1
          for (int k = 0; k < 2; ++k) {
            if (k == 1) {
              if (row) {
                // K4's product: t (/ ny after an inverse)
                const size_t x0 = (size_t)((u % rtpp) << logc_r);
                const size_t k0 = s * plane + x0 * ny;
                const float scale = mode == kFirst ? 1.0f : 1.0f / (float)ny;
                product_pass(a,
                             RowT<kPhase>{kPhase ? nullptr : t + k0,
                                          kPhase ? sv + k0 : nullptr, ny,
                                          nx - (int)x0, scale},
                             ny, logc_r, tid, nt);
              } else if (kind == kColPhase) {
                // K5's: the Fresnel plane / nx
                const int y0 = (u % ctpp) << logc_c;
                product_pass(a, TileProp{prop + y0, ny, y0, 1.0f / (float)nx},
                             nx, logc_c, tid, nt);
              }
            }
            const int dir = k == 0 ? dir0 : dir1;
            if (dir == 1) {
              k6_transform<true>(e, a, b, tws, logc, tid, nt);
            } else if (dir == 2) {
              k6_transform<false>(e, a, b, tws, logc, tid, nt);
            }
          }
        });
  }
}

// The grid barriers of a K6 launch and nothing else (the barrier floor).
__global__ void barrier_kernel(int n_syncs) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n_syncs; ++i) grid.sync();
}

// Host: opt `kernel` in to smem bytes of shared memory and size its
// cooperative grid: the blocks the occupancy query fits on the card, at
// most `work`, or `blocks` where it is positive. info: grid, blocks per
// SM, SMs, smem.
template <class K>
cudaError_t cooperative_grid(K kernel, int threads, size_t smem, long work,
                             int blocks, int* info) {
  cudaError_t err = persistent_grid(kernel, threads, smem, work, info);
  if (err == cudaSuccess && blocks > 0) info[0] = blocks;
  return err;
}

}  // namespace

extern "C" {

// One frame's slice loop. psi (P, nx, ny) is read, state (same shape) is
// scratch, out receives the exit wave or, with kspace, fftshift(fft2(.)).
// t: (nz, nx, ny) complex planes, or nullptr and sv the (nz, nx, ny) phase
// sigma*V. twx / twy: the twiddle tables (pow2: n/2 entries, mixed: n).
// threads, logc_r, logc_c: the plan (ops/fused_step_resident.py
// resident_plan): the block, and 2^logc_r rows a row tile and 2^logc_c
// columns a column tile. blocks > 0 overrides the grid size. info receives
// the grid, blocks per SM, SMs and the dynamic shared memory in bytes.
int fs_resident_loop(void* out, void* state, const void* psi, const void* t,
                     const void* sv, const void* prop, const void* twx,
                     const void* twy, int n_probes, int nx, int ny, int nz,
                     int pow2, int kspace, int threads, int logc_r,
                     int logc_c, int blocks, int* info, void* stream) {
  if (nz < 2 || n_probes < 1) return (int)cudaErrorInvalidValue;
  const bool phase = sv != nullptr;
  float2* o = (float2*)out;
  float2* st = (float2*)state;
  const float2* ps = (const float2*)psi;
  const float2* tt = (const float2*)t;
  const float* svv = (const float*)sv;
  const float2* pr = (const float2*)prop;
  const long rows = (long)n_probes * ((nx + (1 << logc_r) - 1) >> logc_r);
  const long cols = (long)n_probes * ((ny + (1 << logc_c) - 1) >> logc_c);
  const long work = rows > cols ? rows : cols;
  if (pow2) {
    if (!reg_plan_ok(ny, nx, logc_r, kRegResThreads) ||
        !reg_plan_ok(nx, ny, logc_c, kRegResThreads) ||
        (ny / kRegE) << logc_r != threads ||
        (nx / kRegE) << logc_c != threads) {
      return (int)cudaErrorInvalidValue;
    }
    RegGeo gx = reg_geo(twx, nx);
    RegGeo gy = reg_geo(twy, ny);
    // the exchange buffer (the same for both phases); with the phase, the
    // threads' factor slots
    const size_t smem = reg_smem(ny, logc_r) +
                        (phase ? kRegE * threads * sizeof(float2) : 0);
    const auto kernel =
        phase ? resident_reg_kernel<true> : resident_reg_kernel<false>;
    cudaError_t err =
        cooperative_grid(kernel, threads, smem, work, blocks, info);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&o,  &st,       &ps, &tt,     &svv,    &pr,    &gx,
                    &gy, &n_probes, &nz, &logc_r, &logc_c, &kspace};
    return (int)cudaLaunchCooperativeKernel((void*)kernel, dim3(info[0]),
                                            dim3(threads), args, smem,
                                            (cudaStream_t)stream);
  }
  MixedEng ex = mixed_eng(twx, nx);
  MixedEng ey = mixed_eng(twy, ny);
  const int consumers = threads - kProducers;
  if (!plan_ok(ey.plan, logc_r, consumers) ||
      !plan_ok(ex.plan, logc_c, consumers) || ex.plan.nf < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t slots_r = (size_t)ny << logc_r;
  const size_t slots_c = (size_t)nx << logc_c;
  int slots = (int)(slots_r > slots_c ? slots_r : slots_c);
  const size_t smem = (3 * (size_t)slots + nx + ny) * sizeof(float2);
  const auto kernel =
      phase ? resident_mr_kernel<true> : resident_mr_kernel<false>;
  cudaError_t err =
      cooperative_grid(kernel, threads, smem, work, blocks, info);
  if (err != cudaSuccess) return (int)err;
  // the column phases copy and store the state alone
  int vec16 = logc_c >= 1 && ny % 2 == 0 && (uintptr_t)state % 16 == 0;
  void* args[] = {&o,  &st,       &ps, &tt,     &svv,    &pr,    &ex,    &ey,
                  &n_probes, &nz, &logc_r, &logc_c, &slots, &vec16, &kspace};
  return (int)cudaLaunchCooperativeKernel((void*)kernel, dim3(info[0]),
                                          dim3(threads), args, smem,
                                          (cudaStream_t)stream);
}

// The barrier floor: n_syncs grid barriers in a cooperative launch of grid
// blocks of `threads` with smem bytes of dynamic shared memory (those of a
// K6 launch) and nothing else.
int fs_resident_barriers(int grid, int threads, int smem, int n_syncs,
                         void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      barrier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&n_syncs};
  return (int)cudaLaunchCooperativeKernel((void*)barrier_kernel, dim3(grid),
                                          dim3(threads), args, (size_t)smem,
                                          (cudaStream_t)stream);
}

}  // extern "C"
