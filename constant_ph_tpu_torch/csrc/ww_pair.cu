// Water-water pair block on the cell tiles, hand-written for Hopper
// (sm_90a). Bound to PyTorch through a plain C entry point loaded with
// ctypes (constant_ph_tpu_torch/tiled/cuda_ww.py).
//
// Replaces: the TPU kernel constant_ph_tpu/tiled/pallas_ww.py
// _chunk_pair_kernel (:240, launched by _run_chunks, wrapped by
// water_water_pallas_fast), which computes the same function as the XLA
// hot path constant_ph_tpu/tiled/forces.py water_water_fast.
//
// Function, for each of R replicas r (a batch; R = 1 for one state): wx
// (R, 3, G, A) float32 contiguous water coordinates, A = 3W slots per cell
// (O, H1, H2 of molecule k in slots 3k, 3k+1, 3k+2; empty slots parked far
// outside the box, all three on one point), box (R, 3) on the device -> f
// (R, 3, G, A) forces, e_out (R, 2) = (e_lj, e_coul), n_out (R,) = the
// atom pairs evaluated.
//
// Slab entry (the x-slab decomposition, parallel/spatial.py): wx holds a
// rank's gxo owned x-layers of the global grid plus one ghost x-layer on
// each side (gxo + 2 layers, raw coordinates as the neighbouring ranks
// hold them), the slab's first global x index and the global gx; f and the
// energies cover the owned cells only. The kernel reads a stencil
// neighbour from the local array (no x wrap) and takes its image shift
// from the neighbour's global x index (y and z wrap as on the whole grid).
// The whole grid is the case xo = 0: no ghosts, the neighbour wrapped in
// the array, first index 0. Both give an owned cell the same pairs with
// the same bits, so a slab's forces are the whole grid's rows. Coulomb on all atom pairs with the degree-10
// Chebyshev screening fits g1, g2 in t = min(2r/rc - 1, 1) (DSF or erfc
// style); 12-6 shifted LJ on O-O pairs only; r^2 clamped at R2_MIN; pairs
// beyond rc masked. Parked slots drop out through the cutoff, so there is
// no validity mask. The 27-cell stencil (26 neighbours with their periodic
// image shifts, plus the own cell) defines which pairs exist.
//
// Bound: operations. The function needs each unordered atom pair inside
// rc once (~2.4 M pairs at 24,001 atoms, rc 8 A, ~78 FP32 operations
// each: ~3 us at the 67 TFLOP/s FP32 peak); wx in and f out are 0.87 MB
// (~0.3 us at 3.35 TB/s). The kernel evaluates each in-range pair from
// both of its molecules (i-side sums, below) and whole molecule pairs
// (~9 M atom pairs at those tiles), and before that stages the stencil
// and tests candidates, so it stays well above that bound: staging,
// candidate tests and pair arithmetic each take a share of its time.
//
// Displacements. Every atom pair's dx = (x_i - x_j) - s, s the image shift
// of j's stencil segment: the difference of the two stored coordinates
// first, the shift last. In IEEE float32 fl(a - b) = -fl(b - a), and the
// pair seen from j has the opposite shift, so its dx is exactly -dx and
// its r^2 the same bits: both shares of a pair fall on the same side of
// rc and the forces are exactly antisymmetric (the JAX block and the plain
// version apply +-f once a pair). The staged tiles hold the unshifted
// coordinates.
//
// Molecule-pair cull (exact). Work is done per water molecule. Each
// molecule's radius rho = max(|H1 - O|, |H2 - O|) is computed on the fly
// (~1 A for water, 0 for a parked molecule). A molecule pair (i, j) is
// skipped when |O_i - O_j| >= rc + rho_i + rho_j + CULL_MARGIN, with j's
// image shift subtracted after the difference. By the triangle inequality every atom pair of a
// skipped molecule pair is then >= rc + CULL_MARGIN apart, and the pair
// term is multiplied by in_rc = 0 for it: skipping changes nothing. The
// argument holds for any geometry (FIRE from a raw lattice, stretched
// molecules, parked slots). Rounding: a difference of two stored floats
// is exact to 2^-24 of itself, so both r^2 in the cull and r^2 of an atom
// pair are within a few ulp of their exact values, relative to the
// distance and not to the coordinates; CULL_MARGIN = 0.01 A is >100x
// that at rc; the shift subtracted last adds one rounding of the same
// size. Pairs that survive the cull but lie beyond rc are masked by
// in_rc as before. The molecule pair j = i in the own cell is skipped: its
// 9 pairs are same-molecule pairs, which the function excludes.
// The cull runs in two steps. A block first lists the stencil molecules
// within rc + rho_max + rho_j + CULL_MARGIN of the box around its own i
// molecules' O (rho_max the largest of their radii): a molecule left out
// is one the per-pair test would skip for every i of the block, since
// each O_i lies in the box. Then each warp tests only that list against
// its i molecule. A block of real molecules keeps the real molecules of
// the stencil and drops the parked ones; a block of parked molecules
// keeps almost nothing.
//
// Accumulation: i-side-only sums over the full stencil. Every unordered
// pair is computed from both of its molecules; no atomics, no j-side
// write-back, each element of f written by exactly one lane (zeros for
// parked slots, whose cull keeps nothing). Energies count every pair twice
// and carry a global 0.5; they go to per-block partial sums and a second
// pass, one block a replica, adds each replica's in a fixed order. Every sum has a fixed order
// (lists in stencil and lane order, fixed shuffle trees), so the same
// inputs give bitwise-identical outputs on every launch.
//
// Layout. Grid (ceil(W / 16), G, R): a block of 16 warps takes 16
// molecules of a cell of one replica, one i molecule per warp (864 blocks
// a replica at the 6^3 production grid and W = 56). blockIdx.z picks the
// replica: a block offsets wx, box, f and its partials by it and does
// nothing else differently, so a batched launch gives each replica bit
// for bit what a launch on that replica alone gives. R <= 65535
// (gridDim.z). It stages the whole stencil of its cell once: 27
// tiles x 3 dims x A floats (54 KB at A = 168, 74 KB at A = 228), copied
// with cp.async in 16-byte pieces (rows are 16-byte aligned: W is a
// multiple of 4, so A is a multiple of 12), unshifted. One pass then
// stores the 27 W radii; the segments' image shifts stay in a 27 x 3
// table. Staging coordinates of all
// three atoms, rather than O and rho alone with the survivors' H read
// from L2, keeps the candidate and pair loops on shared memory. The
// staging is paid once per block, so a block takes 16 molecules rather
// than 8; at 64 registers a thread (__launch_bounds__(512, 2)) and ~68
// KB of shared memory at A = 168, two blocks share an SM. Shared memory
// above 48 KB is dynamic and needs
// cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// Passes. The whole stencil takes 1134 W + 4096 bytes, which fits a block
// up to W = 200. Above that the wrapper (tiled/cuda_ww.py) stages it in
// passes: 3 passes of one dx plane (9 segments) each, the own tile staged
// once beside them (418 W + 4096 bytes: 91 KB at W = 208, two blocks an
// SM up to W = 252). A pass stages its segments, lists its candidates and
// flushes its survivors before the next overwrites them; each warp's i
// molecule, its force sums and its energy sums stay in registers across
// the passes. The warp's k-th surviving molecule pair goes to lane k % 32
// whatever the pass boundaries, so every lane adds the same pairs in the
// same order and passes give bitwise the one-pass outputs. Where one pass
// fits, the kernel runs the one-pass code (MULTI = false) at the same
// launch configuration as before passes existed.
//
// Warp-uniform work: the i molecule's 9 coordinates sit in registers.
// Lanes test 64 listed candidates a round, two each (O-O distance against
// the cull radius), and compact the survivors with __ballot_sync into a
// per-warp ring of 128 entries in shared memory, in lane order. Whenever
// 32 are queued (and once at the end for the rest), each lane takes one
// surviving molecule pair and does all 9 atom pairs, O-O LJ included, so
// every lane of a warp runs the same branch. The warp's 9 force sums go
// through a shuffle tree and one lane writes them.
//
// Tensor cores do not apply: each pair is an rsqrt, two 10-term Horner
// chains and masks, not a product of matrices. r^2 as a matrix product
// would run in TF32, whose ~3 digits cannot place r^2 against rc^2; the
// port keeps coordinates and forces in float32 (docs/DESIGN.md section 7).
//
// Kept on purpose: t is clamped at 1 and r^2 at R2_MIN. A surviving pair
// may still be far beyond rc; unclamped, the Horner polynomial overflows
// to inf, and inf * in_rc(0) is NaN. rsqrtf stands for lax.rsqrt; the
// file builds without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int NCOEF = 11;          // degree-10 screening fits
constexpr int WARPS = 16;          // warps per block, one i molecule each
constexpr int NT = 32 * WARPS;
constexpr int NSEG = 27;           // 26 neighbours + own cell
constexpr int SELF_SEG = 13;       // offset (0, 0, 0)
constexpr int RING = 128;          // survivor ring per warp (< 96 queued)
constexpr float R2_MIN = 1.0e-4f;
constexpr float CULL_MARGIN = 0.01f;   // A
constexpr unsigned FULL = 0xffffffffu;

// layout of the host parameter array (tiled/cuda_ww.py _PARAM_ORDER)
enum {
  P_C1 = 0, P_C2 = NCOEF, P_KOO = 2 * NCOEF, P_KOH, P_KHH, P_C6, P_C12,
  P_ESH, P_C6X6, P_C12X12, P_RC, P_RC2, P_TWO_OVER_RC, P_E_SH, P_F_SH,
  P_COUNT
};

struct WWParams {
  float c1[NCOEF];
  float c2[NCOEF];
  float kOO, kOH, kHH;             // QQR2E * q_i * q_j
  float c6, c12, esh, c6x6, c12x12;
  float rc, rc2, two_over_rc, e_sh, f_sh;
  int dsf;
  int gxa, gy, gz, W;              // x-layers of the tile array; y, z; W
  int xo;                          // first owned layer of the array (0, 1)
  int gxo;                         // owned x-layers (gxa - 2 xo)
  int x_first, gx_glob;            // global x of owned layer 0; global gx
  int spp;                         // stencil segments staged a pass
};

int blocks_per_cell(int W) { return (W + WARPS - 1) / WARPS; }

// stencil segments staged at a time when the stencil is taken in `passes`
int segs_per_pass(int passes) { return (NSEG + passes - 1) / passes; }

// dynamic shared memory: staged segments, radii, candidate list, survivor
// rings; with more than one pass, also the own tile and its radii
size_t smem_bytes(int W, int passes) {
  const size_t spp = segs_per_pass(passes);
  const size_t staged = spp + (passes > 1 ? 1 : 0);
  return sizeof(float) * staged * (3 * 3 * W + W)
         + sizeof(short) * (spp * W + WARPS * RING);
}

__device__ __forceinline__ int wrap_cell(int c, int g, float L, float* sh) {
  if (c < 0) { *sh = -L; return c + g; }
  if (c >= g) { *sh = L; return c - g; }
  *sh = 0.f;
  return c;
}

// the image shift of a neighbour at global index c of a periodic axis of g
__device__ __forceinline__ float image_shift(int c, int g, float L) {
  return c < 0 ? -L : (c >= g ? L : 0.f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Stages segments [s_first, s_first + n_seg) of the stencil into x ([n_seg]
// [3][A], 16 bytes per cp.async; row = 3 * segment + dim), unshifted, and
// stores each molecule's radius in rho ([n_seg][W]). G: cells of the tile
// array.
__device__ __forceinline__ void stage(
    float* x, float* rho, const float* __restrict__ wx, int s_first,
    int n_seg, const int* seg_cell, int W, int G) {
  const int A = 3 * W;
  const int A4 = A / 4;
  for (int k = threadIdx.x; k < n_seg * 3 * A4; k += NT) {
    const int row = k / A4;
    const int c = 4 * (k - row * A4);
    const int s = row / 3;
    cp_async16(x + row * A + c,
               wx + (size_t)((row - 3 * s) * G + seg_cell[s_first + s]) * A
                   + c);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int c = threadIdx.x; c < n_seg * W; c += NT) {
    const int s = c / W;
    const float* b = x + s * 3 * A + 3 * (c - s * W);
    float h1 = 0.f, h2 = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float o = b[d * A];
      const float x1 = b[d * A + 1];
      const float x2 = b[d * A + 2];
      h1 += (x1 - o) * (x1 - o);
      h2 += (x2 - o) * (x2 - o);
    }
    rho[c] = sqrtf(fmaxf(h1, h2));
  }
  __syncthreads();
}

// MULTI = false: the whole stencil is staged at once (one pass). MULTI =
// true: it is staged p.spp segments at a time, the own tile beside them.
template <bool MULTI>
__global__ void __launch_bounds__(NT, 2)
ww_pair_kernel(const float* __restrict__ wx, const float* __restrict__ box,
               float* __restrict__ f, float* __restrict__ e_part,
               int* __restrict__ n_part, const WWParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int seg_cell[NSEG];
  __shared__ float seg_shift[NSEG * 3];
  __shared__ float ibox[7];                  // i box lo, hi; max rho
  __shared__ int wnear[2][WARPS];
  __shared__ float wsum[2][WARPS];
  __shared__ int wcnt[WARPS];

  const int W = p.W;
  const int A = 3 * W;
  const int G = p.gxa * p.gy * p.gz;         // cells of the tile array
  const int Go = p.gxo * p.gy * p.gz;        // owned cells (f, the grid)
  const int spp = MULTI ? p.spp : NSEG;      // segments a pass
  const int own_tiles = MULTI ? 1 : 0;
  float* sx = smem;                          // [spp][3][A], shifted
  float* own_x = sx + spp * 3 * A;           // [3][A] (MULTI)
  float* rho = own_x + own_tiles * 3 * A;    // [spp][W]
  float* own_rho = rho + spp * W;            // [W] (MULTI)
  // candidates as (segment << 8) | molecule: W < 256 (the wrapper takes
  // W <= 252)
  short* cand = reinterpret_cast<short*>(own_rho + own_tiles * W);
  short* ring = cand + spp * W;              // [WARPS][RING]
  const int cell = blockIdx.y;               // owned cell
  // this block's replica
  wx += (size_t)blockIdx.z * 3 * G * A;
  f += (size_t)blockIdx.z * 3 * Go * A;
  box += 3 * blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  ring += warp * RING;

  if (tid < NSEG) {
    const int cz = cell % p.gz;
    const int cy = (cell / p.gz) % p.gy;
    const int cx = cell / (p.gz * p.gy);     // owned layer
    const int ox = tid / 9 - 1;
    // the neighbour's layer in the array (a slab has its ghosts there),
    // its shift from its global x index
    const float shx = image_shift(p.x_first + cx + ox, p.gx_glob, box[0]);
    float shy, shz, unused;
    const int nx = p.xo ? cx + 1 + ox
                        : wrap_cell(cx + ox, p.gxa, box[0], &unused);
    const int ny = wrap_cell(cy + (tid / 3) % 3 - 1, p.gy, box[1], &shy);
    const int nz = wrap_cell(cz + tid % 3 - 1, p.gz, box[2], &shz);
    seg_cell[tid] = (nx * p.gy + ny) * p.gz + nz;
    seg_shift[3 * tid] = shx;
    seg_shift[3 * tid + 1] = shy;
    seg_shift[3 * tid + 2] = shz;
  }
  __syncthreads();

  // one pass: the whole stencil now, the own tile at segment SELF_SEG;
  // passes: the own tile alone now, the stencil pass by pass below
  if (MULTI)
    stage(own_x, own_rho, wx, SELF_SEG, 1, seg_cell, W, G);
  else
    stage(sx, rho, wx, 0, NSEG, seg_cell, W, G);
  const float* own = MULTI ? own_x : sx + SELF_SEG * 3 * A;
  const float* rho_own = MULTI ? own_rho : rho + SELF_SEG * W;

  const unsigned lanes_below = (1u << lane) - 1u;
  const int m_first = blockIdx.x * WARPS;    // the block's i molecules
  const int m_end = m_first + WARPS < W ? m_first + WARPS : W;

  // the box around the block's i molecules' O and their largest radius
  if (tid == 0) {
    float lo[3] = {own[3 * m_first], own[A + 3 * m_first],
                   own[2 * A + 3 * m_first]};
    float hi[3] = {lo[0], lo[1], lo[2]};
    float rmax = 0.f;
    for (int mi = m_first; mi < m_end; ++mi) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        lo[d] = fminf(lo[d], own[d * A + 3 * mi]);
        hi[d] = fmaxf(hi[d], own[d * A + 3 * mi]);
      }
      rmax = fmaxf(rmax, rho_own[mi]);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      ibox[d] = lo[d];
      ibox[3 + d] = hi[d];
    }
    ibox[6] = rmax;
  }
  __syncthreads();

  // the warp's i molecule: its 9 coordinates and its force sums stay in
  // registers across the passes
  const int mi = m_first + warp;
  const bool active = mi < m_end;
  float xi[3][3] = {};                       // [atom][dim]
  float fi[3][3] = {};
  float lim_i = 0.f;
  if (active) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int d = 0; d < 3; ++d) xi[a][d] = own[d * A + 3 * mi + a];
    lim_i = p.rc + CULL_MARGIN + rho_own[mi];
  }
  float elj = 0.f, ecoul = 0.f;
  int kept = 0;                              // molecule pairs evaluated
  int head = 0, cnt = 0;                     // queued survivors

  for (int s0 = 0; s0 < NSEG; s0 += spp) {
    const int ns = NSEG - s0 < spp ? NSEG - s0 : spp;
    if (MULTI) {
      __syncthreads();                       // every warp is done with the
                                             // last pass's segments
      stage(sx, rho, wx, s0, ns, seg_cell, W, G);
    }
    // candidates: the staged molecules within rc + rho_max + rho_j +
    // CULL_MARGIN of that box, in stencil order. A molecule left out is
    // one every i molecule of the block would cull.
    int ncand = 0;
    for (int base = 0; base < ns * W; base += 2 * NT) {
      bool near[2];
      int code[2];
      unsigned ballot[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = base + h * NT + tid;
        near[h] = false;
        code[h] = 0;
        if (c < ns * W) {
          const int s = c / W;
          const int m = c - s * W;
          const float* b = sx + s * 3 * A + 3 * m;
          float dd = 0.f;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float x = b[d * A] + seg_shift[3 * (s0 + s) + d];
            const float e = fmaxf(fmaxf(ibox[d] - x, x - ibox[3 + d]), 0.f);
            dd += e * e;
          }
          const float lim = p.rc + CULL_MARGIN + ibox[6] + rho[c];
          near[h] = dd < lim * lim;
          code[h] = ((s0 + s) << 8) | m;
        }
        ballot[h] = __ballot_sync(FULL, near[h]);
        if (lane == 0) wnear[h][warp] = __popc(ballot[h]);
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int at = ncand;
        for (int k = 0; k < WARPS; ++k) {
          at += k < warp ? wnear[h][k] : 0;
          ncand += wnear[h][k];
        }
        if (near[h]) cand[at + __popc(ballot[h] & lanes_below)] =
            static_cast<short>(code[h]);
      }
      __syncthreads();
    }
    if (!active) continue;

    const int rounds = (ncand + 63) / 64;    // 64 candidates a round
    for (int r = 0; r <= rounds; ++r) {
      if (r < rounds) {
        // two candidates per lane, tested before either is queued
        bool keep[2];
        int code[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 64 * r + 32 * h + lane;
          keep[h] = false;
          code[h] = k < ncand ? cand[k] : SELF_SEG << 8 | mi;
          const int s = code[h] >> 8;
          const int m = code[h] & 255;
          if (!(s == SELF_SEG && m == mi)) {
            const float* b = sx + (s - s0) * 3 * A + 3 * m;
            const float dx = (xi[0][0] - b[0]) - seg_shift[3 * s];
            const float dy = (xi[0][1] - b[A]) - seg_shift[3 * s + 1];
            const float dz = (xi[0][2] - b[2 * A]) - seg_shift[3 * s + 2];
            const float lim = lim_i + rho[(s - s0) * W + m];
            keep[h] = dx * dx + dy * dy + dz * dz < lim * lim;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned ballot = __ballot_sync(FULL, keep[h]);
          if (keep[h])
            ring[(head + cnt + __popc(ballot & lanes_below)) & (RING - 1)] =
                static_cast<short>(code[h]);
          cnt += __popc(ballot);
        }
      }
      // whenever 32 are queued, and at the end of the pass for the rest:
      // one surviving molecule pair per lane. The warp's survivor number k
      // (counted over all passes) goes to lane k % 32, so every lane sums
      // the same pairs in the same order however the stencil is staged
      while (cnt >= 32 || (r == rounds && cnt > 0)) {
        __syncwarp();
        const int take = cnt < 32 ? cnt : 32;
        const int j = (lane - kept) & 31;    // this lane's place in the batch
        const int e = j < take ? ring[(head + j) & (RING - 1)] : -1;
        __syncwarp();
        head = (head + take) & (RING - 1);
        cnt -= take;
        kept += take;
        if (e < 0) continue;
        const float* bj = sx + ((e >> 8) - s0) * 3 * A + 3 * (e & 255);
        const float* sj = seg_shift + 3 * (e >> 8);
        const float shx = sj[0], shy = sj[1], shz = sj[2];
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const float xj = bj[b], yj = bj[A + b], zj = bj[2 * A + b];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            // the difference first, the shift last: exactly antisymmetric
            const float dx = (xi[a][0] - xj) - shx;
            const float dy = (xi[a][1] - yj) - shy;
            const float dz = (xi[a][2] - zj) - shz;
            const float r2 = fmaxf(dx * dx + dy * dy + dz * dz, R2_MIN);
            const float in_rc = r2 < p.rc2 ? 1.f : 0.f;
            const float inv_r = rsqrtf(r2);
            const float inv_r2 = inv_r * inv_r;
            const float rr = r2 * inv_r;
            const float t = fminf(rr * p.two_over_rc - 1.f, 1.f);
            float g1 = p.c1[NCOEF - 1];
            float g2 = p.c2[NCOEF - 1];
#pragma unroll
            for (int k = NCOEF - 2; k >= 0; --k) {
              g1 = g1 * t + p.c1[k];
              g2 = g2 * t + p.c2[k];
            }
            float u = g1 * inv_r;
            float w = g2 * inv_r2 * inv_r;
            if (p.dsf) {
              u = u - p.e_sh + p.f_sh * (rr - p.rc);
              w = w - p.f_sh * inv_r;
            }
            const float kqq = a == 0 ? (b == 0 ? p.kOO : p.kOH)
                                     : (b == 0 ? p.kOH : p.kHH);
            ecoul += kqq * (u * in_rc);
            float h = kqq * (w * in_rc);
            if (a == 0 && b == 0) {        // O-O: LJ (unrolled, uniform)
              const float inv_r6 = inv_r2 * inv_r2 * inv_r2;
              elj += ((p.c12 * inv_r6 - p.c6) * inv_r6 - p.esh) * in_rc;
              h += (p.c12x12 * inv_r6 - p.c6x6) * inv_r6 * inv_r2 * in_rc;
            }
            fi[a][0] += h * dx;
            fi[a][1] += h * dy;
            fi[a][2] += h * dz;
          }
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int d = 0; d < 3; ++d) fi[a][d] = warp_sum(fi[a][d]);
    if (lane == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int d = 0; d < 3; ++d)
          f[(size_t)(d * Go + cell) * A + 3 * mi + a] = fi[a][d];
    }
  }

  elj = warp_sum(elj);
  ecoul = warp_sum(ecoul);
  if (lane == 0) {
    wsum[0][warp] = elj;
    wsum[1][warp] = ecoul;
    wcnt[warp] = kept;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.f, b = 0.f;
    int n = 0;
    for (int k = 0; k < WARPS; ++k) {
      a += wsum[0][k];
      b += wsum[1][k];
      n += wcnt[k];
    }
    const int blk =
        (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    // every pair was seen from both of its molecules
    e_part[2 * blk] = 0.5f * a;
    e_part[2 * blk + 1] = 0.5f * b;
    n_part[blk] = 9 * n;
  }
}

// (e_lj, e_coul) and the pairs evaluated of replica blockIdx.x =
// fixed-order sums of its nblk per-block partials
__global__ void __launch_bounds__(NT)
energy_sum_kernel(const float* __restrict__ e_part,
                  const int* __restrict__ n_part, int nblk,
                  float* __restrict__ e_out, int* __restrict__ n_out) {
  __shared__ float s[2][NT];
  __shared__ int sn[NT];
  const int t = threadIdx.x;
  e_part += (size_t)2 * nblk * blockIdx.x;
  n_part += (size_t)nblk * blockIdx.x;
  e_out += 2 * blockIdx.x;
  n_out += blockIdx.x;
  float a = 0.f, b = 0.f;
  int n = 0;
  for (int k = t; k < nblk; k += NT) {
    a += e_part[2 * k];
    b += e_part[2 * k + 1];
    n += n_part[k];
  }
  s[0][t] = a;
  s[1][t] = b;
  sn[t] = n;
  __syncthreads();
  for (int st = NT / 2; st > 0; st >>= 1) {
    if (t < st) {
      s[0][t] += s[0][t + st];
      s[1][t] += s[1][t + st];
      sn[t] += sn[t + st];
    }
    __syncthreads();
  }
  if (t == 0) {
    e_out[0] = s[0][0];
    e_out[1] = s[1][0];
    n_out[0] = sn[0];
  }
}

// raise the kernel's dynamic shared memory limit once per new maximum, so
// that later calls (and a CUDA graph capturing them) only launch; then
// launch both kernels
template <bool MULTI>
int launch(const float* wx, const float* box, float* f, float* e_part,
           int* n_part, float* e_out, int* n_out, const WWParams& p, int R,
           size_t smem, cudaStream_t s) {
  static size_t smem_allowed = 0;
  cudaError_t err;
  if (smem > smem_allowed) {
    err = cudaFuncSetAttribute(ww_pair_kernel<MULTI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        ww_pair_kernel<MULTI>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  const dim3 grid(blocks_per_cell(p.W), p.gxo * p.gy * p.gz, R);
  ww_pair_kernel<MULTI><<<grid, NT, smem, s>>>(wx, box, f, e_part, n_part,
                                               p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  energy_sum_kernel<<<R, NT, 0, s>>>(e_part, n_part, grid.x * grid.y,
                                     e_out, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ww_pair_param_count() { return P_COUNT; }

// blocks of the pair kernel a replica: the caller allocates 3 scratch
// words each
int ww_pair_blocks(int G, int W) { return G * blocks_per_cell(W); }

// bytes of dynamic shared memory a block of the pair kernel takes when the
// stencil is staged in `passes`
int ww_pair_smem_bytes(int W, int passes) {
  return static_cast<int>(smem_bytes(W, passes));
}

// Launches both kernels on `stream` for R replicas, the stencil staged in
// `passes` (1: all 27 segments at once); returns the CUDA error (0 = ok).
// e_part: 2 floats per block, n_part: 1 int per block (scratch, R *
// ww_pair_blocks of the owned cells each); e_out: (R, 2) (e_lj, e_coul);
// n_out: (R,) atom pairs evaluated. gxa: x-layers of wx; slab = 0: the
// whole periodic grid (x_first 0, gx_glob = gxa); slab = 1: gxa - 2 owned
// layers between two ghost layers, the first owned one at global x
// x_first of gx_glob.
int ww_pair_forward(const float* wx, const float* box, float* f,
                    float* e_part, int* n_part, float* e_out, int* n_out,
                    int gxa, int gy, int gz, int W, const float* prm,
                    int dsf, int passes, int R, int slab, int x_first,
                    int gx_glob, void* stream) {
  WWParams p;
  for (int k = 0; k < NCOEF; ++k) {
    p.c1[k] = prm[P_C1 + k];
    p.c2[k] = prm[P_C2 + k];
  }
  p.kOO = prm[P_KOO];
  p.kOH = prm[P_KOH];
  p.kHH = prm[P_KHH];
  p.c6 = prm[P_C6];
  p.c12 = prm[P_C12];
  p.esh = prm[P_ESH];
  p.c6x6 = prm[P_C6X6];
  p.c12x12 = prm[P_C12X12];
  p.rc = prm[P_RC];
  p.rc2 = prm[P_RC2];
  p.two_over_rc = prm[P_TWO_OVER_RC];
  p.e_sh = prm[P_E_SH];
  p.f_sh = prm[P_F_SH];
  p.dsf = dsf;
  p.gxa = gxa;
  p.xo = slab ? 1 : 0;
  p.gxo = gxa - 2 * p.xo;
  p.x_first = x_first;
  p.gx_glob = gx_glob;
  p.gy = gy;
  p.gz = gz;
  p.W = W;
  p.spp = segs_per_pass(passes);
  const size_t smem = smem_bytes(W, passes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes > 1)
    return launch<true>(wx, box, f, e_part, n_part, e_out, n_out, p, R, smem,
                        s);
  return launch<false>(wx, box, f, e_part, n_part, e_out, n_out, p, R, smem,
                       s);
}

}  // extern "C"
