// Water-water pair block on the cell tiles, hand-written for Hopper
// (sm_90a). Bound to PyTorch through a plain C entry point loaded with
// ctypes (constant_ph_tpu_torch/tiled/cuda_ww.py).
//
// Replaces: the TPU kernel constant_ph_tpu/tiled/pallas_ww.py
// _chunk_pair_kernel (:240, launched by _run_chunks, wrapped by
// water_water_pallas_fast), which computes the same function as the XLA
// hot path constant_ph_tpu/tiled/forces.py water_water_fast.
//
// Function: wx (3, G, A) float32 contiguous water coordinates, A = 3W
// slots per cell (O, H1, H2 of each molecule consecutive; empty slots
// parked far outside the box), box (3,) on the device ->
//   f (3, G, A) forces, e_out = (e_lj, e_coul).
// Coulomb on all atom pairs with the degree-10 Chebyshev screening fits
// g1, g2 in t = min(2r/rc - 1, 1) (DSF or erfc style); 12-6 shifted LJ on
// O-O pairs only; r^2 clamped at R2_MIN; pairs beyond rc masked. Parked
// slots drop out through the cutoff, so there is no validity mask.
//
// Accumulation (scheme ii): the full 26-neighbour stencil plus the self
// cell, with i-side-only sums. Every unordered pair is computed from both
// of its atoms, which doubles the pair arithmetic of the half stencil but
// needs no atomics and no j-side write-back, so forces are deterministic
// and each output element is written by exactly one thread. Energies
// count every pair twice and carry a global 0.5; they go to per-block
// partial sums and a second one-block pass adds those in a fixed order.
//
// Bound: operations. wx is 0.5 MB at 24,001 atoms, while one evaluation
// is ~80 FP32 operations for each of G*A*(13.5*A) ~ 8e7 pairs (half
// stencil; this kernel does 27*A*A per cell, about twice that). No tensor
// core applies (rsqrt, two 10-term Horner fits, masks), so the ceiling is
// the card's non-tensor FP32 rate. What the design does about it: one
// block per (cell, 32 i atoms); 8 thread rows split the j loop, so a
// 24k-atom system launches ~1.3-1.7 k blocks of 256 threads for 132 SMs.
// Each neighbour tile (3*A floats, <= 2.7 KB) is staged in shared memory
// once per block with its periodic image shift added while loading
// (replacing jnp.roll + _roll_shift), and every warp reads the same j
// (broadcast, no bank conflicts). The LJ term runs inside the same pair
// loop, only where i and j are both O. The 8 partial sums of each i are
// added in a fixed order through shared memory.
//
// Kept on purpose: t is clamped at 1 and r^2 at R2_MIN. Parked slots sit
// ~1e4 A away; unclamped, the Horner polynomial overflows to inf, and
// inf * in_rc(0) is NaN. rsqrtf stands for lax.rsqrt; the file builds
// without --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int NCOEF = 11;          // degree-10 screening fits
constexpr int TI = 32;             // i atoms per block (threadIdx.x)
constexpr int TJ = 8;              // j lanes per i atom (threadIdx.y)
constexpr int NT = TI * TJ;
constexpr int NSEG = 27;           // 26 neighbours + self
constexpr int SELF_SEG = 13;       // offset (0, 0, 0)
constexpr float R2_MIN = 1.0e-4f;

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
  int gx, gy, gz, A;
};

__device__ __forceinline__ int wrap_cell(int c, int g, float L, float* sh) {
  if (c < 0) { *sh = -L; return c + g; }
  if (c >= g) { *sh = L; return c - g; }
  *sh = 0.f;
  return c;
}

__global__ void __launch_bounds__(NT)
ww_pair_kernel(const float* __restrict__ wx, const float* __restrict__ box,
               float* __restrict__ f, float* __restrict__ e_part,
               const WWParams p) {
  extern __shared__ float sj[];    // 3 * A: the staged neighbour tile
  __shared__ float red[3][TJ][TI];
  __shared__ float ered[2][NT];

  const int A = p.A;
  const int G = p.gx * p.gy * p.gz;
  const int cell = blockIdx.y;
  const int cz = cell % p.gz;
  const int cy = (cell / p.gz) % p.gy;
  const int cx = cell / (p.gz * p.gy);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TI + tx;
  const int i = blockIdx.x * TI + tx;
  const bool has_i = i < A;
  const float Lx = box[0], Ly = box[1], Lz = box[2];

  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (has_i) {
    xi = wx[(0 * G + cell) * A + i];
    yi = wx[(1 * G + cell) * A + i];
    zi = wx[(2 * G + cell) * A + i];
  }
  const int imol = i / 3;
  const bool iO = (i % 3) == 0;
  const float kO = iO ? p.kOO : p.kOH;   // charge product with a j O
  const float kH = iO ? p.kOH : p.kHH;   // ... with a j H

  float fx = 0.f, fy = 0.f, fz = 0.f, elj = 0.f, ecoul = 0.f;

  for (int s = 0; s < NSEG; ++s) {
    float shx, shy, shz;
    const int nx = wrap_cell(cx + s / 9 - 1, p.gx, Lx, &shx);
    const int ny = wrap_cell(cy + (s / 3) % 3 - 1, p.gy, Ly, &shy);
    const int nz = wrap_cell(cz + s % 3 - 1, p.gz, Lz, &shz);
    const int ncell = (nx * p.gy + ny) * p.gz + nz;
    const bool self_seg = s == SELF_SEG;

    __syncthreads();               // the previous tile is no longer read
    for (int a = tid; a < A; a += NT) {
      sj[a] = wx[(0 * G + ncell) * A + a] + shx;
      sj[A + a] = wx[(1 * G + ncell) * A + a] + shy;
      sj[2 * A + a] = wx[(2 * G + ncell) * A + a] + shz;
    }
    __syncthreads();
    if (!has_i) continue;

    for (int j = ty; j < A; j += TJ) {
      const float dx = xi - sj[j];
      const float dy = yi - sj[A + j];
      const float dz = zi - sj[2 * A + j];
      const float r2 = fmaxf(dx * dx + dy * dy + dz * dz, R2_MIN);
      const float in_rc = r2 < p.rc2 ? 1.f : 0.f;
      const float inv_r = rsqrtf(r2);
      const float inv_r2 = inv_r * inv_r;
      const float r = r2 * inv_r;
      const float t = fminf(r * p.two_over_rc - 1.f, 1.f);
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
        u = u - p.e_sh + p.f_sh * (r - p.rc);
        w = w - p.f_sh * inv_r;
      }
      const bool jO = (j % 3) == 0;
      const bool same_mol = self_seg && (j / 3 == imol);
      const float kqq = same_mol ? 0.f : (jO ? kO : kH);
      ecoul += kqq * (u * in_rc);
      float h = kqq * (w * in_rc);
      if (iO && jO && !same_mol) {
        const float inv_r6 = inv_r2 * inv_r2 * inv_r2;
        elj += ((p.c12 * inv_r6 - p.c6) * inv_r6 - p.esh) * in_rc;
        h += (p.c12x12 * inv_r6 - p.c6x6) * inv_r6 * inv_r2 * in_rc;
      }
      fx += h * dx;
      fy += h * dy;
      fz += h * dz;
    }
  }

  red[0][ty][tx] = fx;
  red[1][ty][tx] = fy;
  red[2][ty][tx] = fz;
  ered[0][tid] = elj;
  ered[1][tid] = ecoul;
  __syncthreads();
  if (ty < 3 && has_i) {           // thread row d adds dimension d
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < TJ; ++k) acc += red[ty][k][tx];
    f[(ty * G + cell) * A + i] = acc;
  }
  for (int st = NT / 2; st > 0; st >>= 1) {
    if (tid < st) {
      ered[0][tid] += ered[0][tid + st];
      ered[1][tid] += ered[1][tid + st];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    // every pair was seen from both of its atoms
    e_part[2 * b] = 0.5f * ered[0][0];
    e_part[2 * b + 1] = 0.5f * ered[1][0];
  }
}

// (e_lj, e_coul) = fixed-order sum of the per-block partials
__global__ void __launch_bounds__(NT)
energy_sum_kernel(const float* __restrict__ e_part, int nblk,
                  float* __restrict__ e_out) {
  __shared__ float s[2][NT];
  const int t = threadIdx.x;
  float a = 0.f, b = 0.f;
  for (int k = t; k < nblk; k += NT) {
    a += e_part[2 * k];
    b += e_part[2 * k + 1];
  }
  s[0][t] = a;
  s[1][t] = b;
  __syncthreads();
  for (int st = NT / 2; st > 0; st >>= 1) {
    if (t < st) {
      s[0][t] += s[0][t + st];
      s[1][t] += s[1][t + st];
    }
    __syncthreads();
  }
  if (t == 0) {
    e_out[0] = s[0][0];
    e_out[1] = s[1][0];
  }
}

}  // namespace

extern "C" {

int ww_pair_param_count() { return P_COUNT; }

// floats of scratch the caller allocates for the per-block partials
int ww_pair_scratch_floats(int G, int A) {
  return 2 * G * ((A + TI - 1) / TI);
}

// Launches both kernels on `stream`; returns cudaGetLastError() (0 = ok).
int ww_pair_forward(const float* wx, const float* box, float* f,
                    float* e_part, float* e_out, int gx, int gy, int gz,
                    int A, const float* prm, int dsf, void* stream) {
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
  p.gx = gx;
  p.gy = gy;
  p.gz = gz;
  p.A = A;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((A + TI - 1) / TI, gx * gy * gz);
  const dim3 block(TI, TJ);
  ww_pair_kernel<<<grid, block, 3 * A * sizeof(float), s>>>(wx, box, f,
                                                           e_part, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  energy_sum_kernel<<<1, NT, 0, s>>>(e_part, grid.x * grid.y, e_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
