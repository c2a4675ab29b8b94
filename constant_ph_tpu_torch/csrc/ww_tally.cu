// Full-tally water-water block on the cell tiles, hand-written for Hopper
// (sm_90a). Bound to PyTorch through a plain C entry point loaded with
// ctypes (constant_ph_tpu_torch/tiled/cuda_ww.py, water_water_tally_cuda).
//
// Replaces: the TPU kernel constant_ph_tpu/tiled/pallas_ww.py
// make_ww_kernel -> inner `kernel` (:88, launched by its pallas_call,
// wrapped by water_water_pallas with pack_water_tiles; Abramowitz-Stegun
// erfc from _erfc_pos). Plain PyTorch version of the same function:
// tiled/forces.py water_water_tally_plain.
//
// Function, for each of R replicas (a batch; R = 1 for one state): packed
// tiles wt (R, G, 8, A) float32 contiguous, G = gx*gy*gz cells, A = 3W
// slots (O, H1, H2 of molecule k in slots 3k, 3k+1, 3k+2; rows x, y, z,
// charge, LJ mask, validity, 0, 0), and box (R, 3) on the device -> out
// (R, G, 8, A): per slot force x, y, z, eatom_lj, eatom_coul, phi, 0, 0;
// count (R,) = the atom pairs evaluated. For each cell, all 27
// neighbour offsets (the cell itself at offset 13) with i-side-only sums:
//   - per-pair minimum image, dx -= L * rint(dx / L) (round half to even,
//     as jnp.round);
//   - pair weight = valid_i * valid_j, times not-same-molecule on the self
//     offset only; masked pairs get r^2 = rc^2 + 1 BEFORE 1/r^2 (parked
//     slots sit 1e4 A away and min image can fold them anywhere);
//   - 12-6 shifted LJ weighted by the LJ masks of both slots;
//   - Coulomb with erfc from the Abramowitz-Stegun 7.1.26 polynomial and
//     expf (not erfcf: the kernel computes what the TPU kernel computes),
//     in DSF or 'cut' style, masked at rc;
//   - phi_i = QQR2E * sum_j q_j u(r_ij) with the same masks;
//   - the eatom rows carry 0.5 (each pair is tallied on both atoms).
// Needs grid >= 3 per dim, so the 27 offsets are distinct cells.
//
// Bound: operations. The tiles are 0.9 MB in and 0.9 MB out at 24,001
// atoms; the function needs each unordered atom pair inside rc once (~2.3
// M pairs at those tiles, ~67 FP32 operations each with an expf, a sqrtf
// and four IEEE divisions: ~2.3 us at the 67 TFLOP/s FP32 peak). No
// tensor core applies (no product of matrices; TF32 could not place r^2
// against rc^2). The kernel computes each pair from both of its atoms
// (i-side sums), whole molecule pairs at a time, and before that stages
// the stencil and tests candidates, so it stays well above that bound.
//
// Molecule-pair cull (exact). A j molecule is skipped for an i molecule
// only when one of these holds; each leaves every atom pair of the two
// molecules with a term that is exactly 0, so skipping changes nothing:
// (a) Distance. The minimum-image O-O distance, computed as the pair
//     term computes dx, is >= rc + rho_i + rho_max + CULL_MARGIN, where
//     rho = max(|H1 - O|, |H2 - O|) from the raw stored coordinates and
//     rho_max is the largest rho of the live molecules of the block's
//     stencil (>= rho_j: a stricter test than rule (a) with rho_j). The
//     raw |H - O| bounds the torus distance of H and O from above, and
//     the minimum-image distance on the periodic box is a metric, so by
//     the triangle inequality every atom pair of a skipped molecule pair
//     is >= rc apart and carries in_rc = 0. Rounding: each minimum-image
//     component is within a few ulp of the coordinates' magnitude of its
//     exact value (~1e-5 A for coordinates within a few box lengths of
//     the box); CULL_MARGIN = 0.01 A is far above that. Parked molecules
//     never reach this test (rule b), so their ~1e4 A coordinates do not
//     enter it.
// (b) Validity. All three validity entries of the j molecule (or of the
//     i molecule) are 0: every weight is 0, r^2 is pushed to rc^2 + 1 and
//     every term is exactly 0. Parked slots go out this way, never by
//     geometry; a parked i molecule's slots are written as zeros.
// (c) Same molecule: j = i on the self offset 13, whose 9 pairs the
//     same-molecule mask zeroes.
// The cull runs in two steps. A block first lists the live stencil
// molecules whose O lies within rc + rho_i_max + rho_max + 2 CULL_MARGIN
// of the box around its own live i molecules' O, the distance taken on
// the torus (per dimension, the minimum image of O_j against the box's
// centre, less the box's half-width). Since every O_i of the block lies
// in that box, a molecule left out is one that rule (a) skips for every i
// of the block; the extra margin covers the rounding of the box's centre
// and half-width. Then each warp tests only that list against its own i
// molecule.
//
// Layout. Grid (ceil(W / 12), G, R): a block of 12 warps takes 12
// molecules of a cell of one replica, one i molecule per warp (1,080
// blocks a replica at the 6^3 production grid and W = 52). blockIdx.z
// picks the replica: a block offsets wt, box, out and count by it and
// does nothing else differently, so a batched launch gives each replica
// bit for bit what a launch on that replica alone gives. R <= 65535
// (gridDim.z). A block whose 12 molecules are all parked writes
// zeros and stops before staging. Otherwise it stages the 6 used rows of
// its cell's 27 tiles once (x, y, z, q, LJ mask, validity: 101 KB at A =
// 156, 109 KB at A = 168, 148 KB at A = 228), copied with cp.async in
// 16-byte pieces (rows are 16-byte aligned: W is a multiple of 4, so A is
// a multiple of 12). No per-molecule radius array is kept beside it (the
// cull uses the stencil's largest radius), and a survivor ring of 64
// shorts a warp suffices, so a block takes at most 111 KB at A <= 168 and
// two blocks share an SM. Shared memory above 48 KB is dynamic and needs
// cudaFuncAttributeMaxDynamicSharedMemorySize. Block size: the staging
// allows two blocks an SM, so the registers a thread may hold set the
// warps a block can have. At 16 warps (64 registers) the pair loop
// spilled and the kernel ran slower than at 12 (80 registers, no spills,
// __launch_bounds__(384, 2)); smaller blocks also leave fewer idle warps
// in a cell's last, partly filled block.
//
// Passes. The whole stencil takes 1998 W + 1536 bytes, which fits a block
// up to W = 112. Above that the wrapper (tiled/cuda_ww.py) stages it in
// passes, the own tile staged once beside them: 3 passes of 9 offsets
// take 738 W + 1536 bytes (151 KB at W = 208, one block an SM), 9 passes
// of 3 offsets 294 W + 1536 (61 KB at W = 208, two blocks an SM up to W
// = 252), and the wrapper takes the fewest passes that keep two blocks an
// SM. rho_max is the largest radius over all 27 offsets, read from device
// memory before the first pass, so the cull is the one-pass cull: no
// per-pass radius. A pass stages its offsets, lists its candidates and
// flushes its survivors before the next overwrites them; each warp's 18
// sums stay in registers across the passes. The warp's k-th surviving
// molecule pair goes to lane k % 32 whatever the pass boundaries, so
// every lane adds the same pairs in the same order and passes give
// bitwise the one-pass outputs. A block of parked molecules still stops
// before any staging. Where one pass fits, the kernel runs the one-pass
// code (MULTI = false) at the same launch configuration as before passes
// existed.
//
// Warp-uniform work: lanes test 32 listed candidates a round (O-O
// distance against the cull radius) and compact the survivors with
// __ballot_sync into the warp's ring, in lane order. Whenever 32 are
// queued (and once at the end for the rest), each lane takes one surviving
// molecule pair and does all 9 atom pairs, exactly as the plain version
// does each pair (min image with rintf, R2_MIN clamp, weights, A-S erfc
// with expf, DSF or 'cut', IEEE divisions and sqrtf; no approximate
// intrinsics; the file builds without --use_fast_math). The i molecule's
// values are broadcast reads of the staged own tile. LJ is evaluated
// where the two slots' mask product is nonzero (the O-O pair of packed
// water tiles); elsewhere its term is exactly 0. Each lane keeps 3 atoms
// x 6 outputs; a fixed shuffle tree adds them over the warp and one lane
// writes each output element, rows 6-7 as zeros.
//
// Determinism: no atomics on floats. The candidate list and the rings are
// in stencil and lane order and every sum has a fixed order, so the same
// inputs give bitwise-identical outputs on every launch. The evaluated
// pair count (9 per molecule pair kept) is one integer atomicAdd per
// block, exact in any order.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 12;          // warps per block, one i molecule each
constexpr int NT = 32 * WARPS;
constexpr int NROW = 8;            // rows of a packed tile / output
constexpr int NIN = 6;             // rows staged: x y z q lj valid
constexpr int NOUT = 6;            // rows computed: fx fy fz elj ecoul phi
constexpr int NOFF = 27;
constexpr int SELF_OFF = 13;       // offset (0, 0, 0)
constexpr int RING = 64;           // survivor ring per warp (< 64 queued)
constexpr float R2_MIN = 1.0e-4f;
constexpr float CULL_MARGIN = 0.01f;   // A
constexpr unsigned FULL = 0xffffffffu;

// layout of the host parameter array (tiled/cuda_ww.py _PARAM_ORDER)
enum {
  P_C6 = 0, P_C12, P_ESH, P_C6X6, P_C12X12, P_RC, P_RC2, P_FAR, P_ALPHA,
  P_TWO_OVER_SQRT_PI, P_QQR2E, P_E_SH, P_F_SH, P_COUNT
};

struct TallyParams {
  float c6, c12, esh, c6x6, c12x12;
  float rc, rc2, far, alpha, two_over_sqrt_pi, qqr2e, e_sh, f_sh;
  int gx, gy, gz, W;
  int opp;                         // stencil offsets staged a pass
};

int blocks_per_cell(int W) { return (W + WARPS - 1) / WARPS; }

// stencil offsets staged at a time when the stencil is taken in `passes`
int offs_per_pass(int passes) { return (NOFF + passes - 1) / passes; }

// dynamic shared memory: the staged offsets, the candidate list and the
// survivor rings; with more than one pass, also the own tile
size_t smem_bytes(int W, int passes) {
  const size_t opp = offs_per_pass(passes);
  const size_t staged = opp + (passes > 1 ? 1 : 0);
  return sizeof(float) * staged * NIN * 3 * W
         + sizeof(short) * (opp * W + WARPS * RING);
}

__device__ __forceinline__ int wrap_cell(int c, int g) {
  return c < 0 ? c + g : (c >= g ? c - g : c);
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// the minimum image of one component, as every pair term computes it
__device__ __forceinline__ float min_image(float d, float L, float iL) {
  return d - L * rintf(d * iL);
}

// b: a molecule's O slot in row 0 of a tile of row length A (staged, or
// the packed tile in device memory)
__device__ __forceinline__ bool parked(const float* b, int A) {
  return b[5 * A] == 0.f && b[5 * A + 1] == 0.f && b[5 * A + 2] == 0.f;
}

__device__ __forceinline__ float radius(const float* b, int A) {
  float h1 = 0.f, h2 = 0.f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float o = b[d * A];
    const float x1 = b[d * A + 1] - o;
    const float x2 = b[d * A + 2] - o;
    h1 += x1 * x1;
    h2 += x2 * x2;
  }
  return sqrtf(fmaxf(h1, h2));
}

// erfc(x) for x >= 0, Abramowitz-Stegun 7.1.26; expmx2 = exp(-x^2)
__device__ __forceinline__ float erfc_pos(float x, float expmx2) {
  const float t = 1.f / (1.f + 0.3275911f * x);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return poly * expmx2;
}

// The 9 atom pairs of the i molecule at bi and the j molecule at bj (each
// its O slot in a staged tile), added to acc[i atom][output row]. The i
// molecule's values are read from shared memory on every use (volatile):
// held in registers they would take 18 more a thread and spill.
template <bool DSF, bool SCREENED>
__device__ __forceinline__ void molecule_pair(
    const float* bj, int A, const volatile float* bi, const float (&L)[3],
    const float (&iL)[3], const TallyParams& p, float (&acc)[3][NOUT]) {
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const float xj = bj[b], yj = bj[A + b], zj = bj[2 * A + b];
    const float qj = bj[3 * A + b], ljj = bj[4 * A + b], vj = bj[5 * A + b];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float dx = min_image(bi[a] - xj, L[0], iL[0]);
      const float dy = min_image(bi[A + a] - yj, L[1], iL[1]);
      const float dz = min_image(bi[2 * A + a] - zj, L[2], iL[2]);
      float r2 = dx * dx + dy * dy + dz * dz;
      const float w = bi[5 * A + a] * vj;
      r2 = w > 0.f ? fmaxf(r2, R2_MIN) : p.far;
      const float in_rc = r2 < p.rc2 ? 1.f : 0.f;
      const float inv_r2 = 1.f / r2;
      const float r = sqrtf(r2);

      float f_lj = 0.f;
      const float lj = bi[4 * A + a] * ljj;
      if (lj != 0.f) {             // else the LJ terms are exactly 0
        const float ljp = lj * in_rc;
        const float inv_r6 = inv_r2 * inv_r2 * inv_r2;
        acc[a][3] += ((p.c12 * inv_r6 - p.c6) * inv_r6 - p.esh) * ljp;
        f_lj = (p.c12x12 * inv_r6 - p.c6x6) * inv_r6 * inv_r2 * ljp;
      }

      float erfc_ar = 1.f, gauss = 0.f;
      if (SCREENED) {
        const float ar = p.alpha * r;
        const float expmx2 = expf(-ar * ar);
        erfc_ar = erfc_pos(ar, expmx2);
        gauss = p.two_over_sqrt_pi * ar * expmx2;
      }
      float u = erfc_ar / r;
      float wr = (erfc_ar + gauss) * inv_r2 / r;
      if (DSF) {
        u = u - p.e_sh + p.f_sh * (r - p.rc);
        wr = wr - p.f_sh / r;
      }
      u *= in_rc;
      wr *= in_rc;
      const float kqq = p.qqr2e * bi[3 * A + a] * qj;
      const float fpair = f_lj + kqq * wr;
      acc[a][0] += fpair * dx;
      acc[a][1] += fpair * dy;
      acc[a][2] += fpair * dz;
      acc[a][4] += kqq * u;
      acc[a][5] += qj * u;
    }
  }
}

// Stages the 6 used rows of offsets [s_first, s_first + n_off) into st
// ([n_off][NIN][A], 16 bytes per cp.async; row = NIN * offset + packed
// row). The caller waits (cp_async_wait_all + __syncthreads).
__device__ __forceinline__ void stage(float* st, const float* __restrict__ wt,
                                      int s_first, int n_off,
                                      const int* seg_cell, int A) {
  const int A4 = A / 4;
  for (int k = threadIdx.x; k < n_off * NIN * A4; k += NT) {
    const int row = k / A4;
    const int c = 4 * (k - row * A4);
    const int s = row / NIN;
    cp_async16(st + row * A + c,
               wt + ((size_t)seg_cell[s_first + s] * NROW + (row - s * NIN))
                   * A + c);
  }
}

// MULTI = false: the whole stencil is staged at once (one pass). MULTI =
// true: it is staged p.opp offsets at a time, the own tile beside them.
template <bool DSF, bool SCREENED, bool MULTI>
__global__ void __launch_bounds__(NT, 2)
ww_tally_kernel(const float* __restrict__ wt, const float* __restrict__ box,
                float* __restrict__ out, int* __restrict__ count,
                const TallyParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int seg_cell[NOFF];
  __shared__ float ibox[8];  // i box centre, half-width; rho_i max, rho_max
  __shared__ float wred[WARPS];
  __shared__ int wnum[WARPS];

  const int W = p.W;
  const int A = 3 * W;
  const int cell = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this block's replica
  const size_t rep_off = (size_t)blockIdx.z * p.gx * p.gy * p.gz * NROW * A;
  wt += rep_off;
  out += rep_off;
  box += 3 * blockIdx.z;
  count += blockIdx.z;
  const int m_first = blockIdx.x * WARPS;    // the block's i molecules
  const int m_end = m_first + WARPS < W ? m_first + WARPS : W;
  float* out_c = out + (size_t)cell * NROW * A;

  // a block whose i molecules are all parked writes zeros and stops
  const int ns = 3 * (m_end - m_first);
  const bool live = tid < ns &&
      wt[((size_t)cell * NROW + 5) * A + 3 * m_first + tid] != 0.f;
  if (!__syncthreads_or(live)) {
    for (int k = tid; k < NROW * ns; k += NT) {
      const int r = k / ns;
      out_c[r * A + 3 * m_first + (k - r * ns)] = 0.f;
    }
    return;
  }

  const int opp = MULTI ? p.opp : NOFF;      // offsets a pass
  float* st = smem;                          // [opp][NIN][A]
  float* own_t = st + opp * NIN * A;         // [NIN][A] (MULTI)
  // candidates as (offset << 8) | molecule: W < 256 (the wrapper takes
  // W <= 252)
  short* cand = reinterpret_cast<short*>(own_t + (MULTI ? NIN * A : 0));
  short* ring = cand + opp * W + warp * RING;

  if (tid < NOFF) {
    const int cz = cell % p.gz;
    const int cy = (cell / p.gz) % p.gy;
    const int cx = cell / (p.gz * p.gy);
    const int nx = wrap_cell(cx + tid / 9 - 1, p.gx);
    const int ny = wrap_cell(cy + (tid / 3) % 3 - 1, p.gy);
    const int nz = wrap_cell(cz + tid % 3 - 1, p.gz);
    seg_cell[tid] = (nx * p.gy + ny) * p.gz + nz;
  }
  __syncthreads();
  // one pass: the whole stencil now; passes: the own tile now, the
  // stencil pass by pass below
  if (MULTI)
    stage(own_t, wt, SELF_OFF, 1, seg_cell, A);
  else
    stage(st, wt, 0, NOFF, seg_cell, A);

  const float L[3] = {box[0], box[1], box[2]};
  const float iL[3] = {1.f / L[0], 1.f / L[1], 1.f / L[2]};
  const float* own = MULTI ? own_t : st + SELF_OFF * NIN * A;

  // the largest radius of the stencil's live molecules (over all 27
  // offsets, whatever is staged: the cull with it is exact); with passes
  // read from device memory while the own tile is copied in
  float rmax = 0.f;
  if (MULTI) {
    for (int c = tid; c < NOFF * W; c += NT) {
      const int s = c / W;
      const float* b = wt + (size_t)seg_cell[s] * NROW * A + 3 * (c - s * W);
      if (!parked(b, A)) rmax = fmaxf(rmax, radius(b, A));
    }
    cp_async_wait_all();
    __syncthreads();
  } else {
    cp_async_wait_all();
    __syncthreads();
    for (int c = tid; c < NOFF * W; c += NT) {
      const int s = c / W;
      const float* b = st + s * NIN * A + 3 * (c - s * W);
      if (!parked(b, A)) rmax = fmaxf(rmax, radius(b, A));
    }
  }
  rmax = warp_max(rmax);
  if (lane == 0) wred[warp] = rmax;
  __syncthreads();
  // the box around the block's live i molecules' O (there is one: the
  // block is live) and their largest radius
  if (tid == 0) {
    float r = 0.f;
    for (int k = 0; k < WARPS; ++k) r = fmaxf(r, wred[k]);
    float lo[3] = {}, hi[3] = {}, ri = 0.f;
    bool first = true;
    for (int mi = m_first; mi < m_end; ++mi) {
      const float* b = own + 3 * mi;
      if (parked(b, A)) continue;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float x = b[d * A];
        lo[d] = first ? x : fminf(lo[d], x);
        hi[d] = first ? x : fmaxf(hi[d], x);
      }
      first = false;
      ri = fmaxf(ri, radius(b, A));
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      ibox[d] = 0.5f * (lo[d] + hi[d]);
      ibox[3 + d] = 0.5f * (hi[d] - lo[d]);
    }
    ibox[6] = ri;
    ibox[7] = r;
  }
  __syncthreads();
  const float rho_max = ibox[7];
  const unsigned lanes_below = (1u << lane) - 1u;
  const float lim_b = p.rc + ibox[6] + rho_max + 2.f * CULL_MARGIN;

  // the warp's i molecule; its 18 sums stay in registers across the passes
  const int mi = m_first + warp;
  const bool has_i = mi < m_end;
  const float* bi = own + 3 * (has_i ? mi : m_first);
  const bool work = has_i && !parked(bi, A);
  float acc[3][NOUT] = {};
  float xi[3] = {}, lim2 = 0.f;
  if (work) {
    xi[0] = bi[0];                           // O of molecule i
    xi[1] = bi[A];
    xi[2] = bi[2 * A];
    const float lim = p.rc + radius(bi, A) + rho_max + CULL_MARGIN;
    lim2 = lim * lim;
  }
  int kept = 0;                              // molecule pairs evaluated
  int head = 0, cnt = 0;                     // queued survivors

  for (int s0 = 0; s0 < NOFF; s0 += opp) {
    const int no = NOFF - s0 < opp ? NOFF - s0 : opp;
    if (MULTI) {
      __syncthreads();                       // every warp is done with the
                                             // last pass's offsets
      stage(st, wt, s0, no, seg_cell, A);
      cp_async_wait_all();
      __syncthreads();
    }
    // candidates: the live staged molecules whose O is within rc +
    // rho_i_max + rho_max + 2 CULL_MARGIN of that box on the torus, in
    // stencil order. A molecule left out is one every i of the block
    // culls.
    int ncand = 0;
    for (int base = 0; base < no * W; base += NT) {
      const int c = base + tid;
      bool near = false;
      int code = 0;
      if (c < no * W) {
        const int s = c / W;
        const int m = c - s * W;
        const float* b = st + s * NIN * A + 3 * m;
        if (!parked(b, A)) {
          float dd = 0.f;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float x = min_image(b[d * A] - ibox[d], L[d], iL[d]);
            const float e = fmaxf(fabsf(x) - ibox[3 + d], 0.f);
            dd += e * e;
          }
          near = dd < lim_b * lim_b;
        }
        code = ((s0 + s) << 8) | m;
      }
      const unsigned ballot = __ballot_sync(FULL, near);
      if (lane == 0) wnum[warp] = __popc(ballot);
      __syncthreads();
      int at = ncand;
      for (int k = 0; k < WARPS; ++k) {
        at += k < warp ? wnum[k] : 0;
        ncand += wnum[k];
      }
      if (near) cand[at + __popc(ballot & lanes_below)] =
          static_cast<short>(code);
      __syncthreads();
    }
    if (!work) continue;

    const int rounds = (ncand + 31) / 32;
    for (int r = 0; r <= rounds; ++r) {
      if (r < rounds) {
        const int k = 32 * r + lane;
        bool keep = false;
        int code = 0;
        if (k < ncand) {
          code = cand[k];
          const int s = code >> 8;
          const int m = code & 255;
          if (!(s == SELF_OFF && m == mi)) {
            const float* b = st + (s - s0) * NIN * A + 3 * m;
            const float dx = min_image(xi[0] - b[0], L[0], iL[0]);
            const float dy = min_image(xi[1] - b[A], L[1], iL[1]);
            const float dz = min_image(xi[2] - b[2 * A], L[2], iL[2]);
            keep = dx * dx + dy * dy + dz * dz < lim2;
          }
        }
        const unsigned ballot = __ballot_sync(FULL, keep);
        if (keep)
          ring[(head + cnt + __popc(ballot & lanes_below)) & (RING - 1)] =
              static_cast<short>(code);
        cnt += __popc(ballot);
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
        if (e >= 0)
          molecule_pair<DSF, SCREENED>(
              st + ((e >> 8) - s0) * NIN * A + 3 * (e & 255), A, bi, L, iL,
              p, acc);
      }
    }
  }

  if (has_i) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int r = 0; r < NOUT; ++r) acc[a][r] = warp_sum(acc[a][r]);
    // lane 3 * row + atom writes one element; rows 6-7 are zeros
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < NOUT; ++r) {
      // every pair's energy is tallied half on each of its two atoms
      const float scale = (r == 3 || r == 4) ? 0.5f
                          : (r == 5 ? p.qqr2e : 1.f);
#pragma unroll
      for (int a = 0; a < 3; ++a)
        if (lane == 3 * r + a) v = acc[a][r] * scale;
    }
    if (lane < 3 * NROW)
      out_c[(lane / 3) * A + 3 * mi + lane % 3] = v;
  }

  if (lane == 0) wnum[warp] = kept;
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < WARPS; ++k) n += wnum[k];
    if (n) atomicAdd(count, 9 * n);
  }
}

template <bool DSF, bool SCREENED, bool MULTI>
int launch(const float* wt, const float* box, float* out, int* count,
           const TallyParams& p, int R, size_t smem, cudaStream_t s) {
  // raise the kernel's dynamic shared memory limit once per new maximum,
  // so that later calls (and a CUDA graph capturing them) only launch
  static size_t smem_allowed = 0;
  cudaError_t err;
  if (smem > smem_allowed) {
    err = cudaFuncSetAttribute(ww_tally_kernel<DSF, SCREENED, MULTI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(ww_tally_kernel<DSF, SCREENED, MULTI>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed = smem;
  }
  err = cudaMemsetAsync(count, 0, sizeof(int) * R, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks_per_cell(p.W), p.gx * p.gy * p.gz, R);
  ww_tally_kernel<DSF, SCREENED, MULTI><<<grid, NT, smem, s>>>(
      wt, box, out, count, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool DSF, bool SCREENED>
int launch_passes(const float* wt, const float* box, float* out, int* count,
                  const TallyParams& p, int passes, int R, cudaStream_t s) {
  const size_t smem = smem_bytes(p.W, passes);
  if (passes > 1)
    return launch<DSF, SCREENED, true>(wt, box, out, count, p, R, smem, s);
  return launch<DSF, SCREENED, false>(wt, box, out, count, p, R, smem, s);
}

}  // namespace

extern "C" {

int ww_tally_param_count() { return P_COUNT; }

// bytes of dynamic shared memory a block of the kernel takes when the
// stencil is staged in `passes`
int ww_tally_smem_bytes(int W, int passes) {
  return static_cast<int>(smem_bytes(W, passes));
}

// Launches the kernel on `stream` for R replicas, the stencil staged in
// `passes` (1: all 27 offsets at once); returns the CUDA error (0 = ok).
// count: R ints, each set to its replica's atom pairs evaluated.
int ww_tally_forward(const float* wt, const float* box, float* out,
                     int* count, int gx, int gy, int gz, int W,
                     const float* prm, int dsf, int screened, int passes,
                     int R, void* stream) {
  TallyParams p;
  p.c6 = prm[P_C6];
  p.c12 = prm[P_C12];
  p.esh = prm[P_ESH];
  p.c6x6 = prm[P_C6X6];
  p.c12x12 = prm[P_C12X12];
  p.rc = prm[P_RC];
  p.rc2 = prm[P_RC2];
  p.far = prm[P_FAR];
  p.alpha = prm[P_ALPHA];
  p.two_over_sqrt_pi = prm[P_TWO_OVER_SQRT_PI];
  p.qqr2e = prm[P_QQR2E];
  p.e_sh = prm[P_E_SH];
  p.f_sh = prm[P_F_SH];
  p.gx = gx;
  p.gy = gy;
  p.gz = gz;
  p.W = W;
  p.opp = offs_per_pass(passes);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dsf)
    return screened ? launch_passes<true, true>(wt, box, out, count, p,
                                                passes, R, s)
                    : launch_passes<true, false>(wt, box, out, count, p,
                                                 passes, R, s);
  return screened ? launch_passes<false, true>(wt, box, out, count, p,
                                               passes, R, s)
                  : launch_passes<false, false>(wt, box, out, count, p,
                                                passes, R, s);
}

}  // extern "C"
