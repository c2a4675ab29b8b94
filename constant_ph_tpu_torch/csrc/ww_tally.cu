// Full-tally water-water block on the cell tiles, hand-written for Hopper
// (sm_90a). Bound to PyTorch through a plain C entry point loaded with
// ctypes (constant_ph_tpu_torch/tiled/cuda_ww.py, water_water_tally_cuda).
//
// Replaces: the TPU kernel constant_ph_tpu/tiled/pallas_ww.py
// make_ww_kernel -> inner `kernel` (launched by its pallas_call, wrapped by
// water_water_pallas with pack_water_tiles; Abramowitz-Stegun erfc from
// _erfc_pos). Plain PyTorch version of the same function:
// tiled/forces.py water_water_tally_plain.
//
// Function: packed tiles wt (G, 8, A) float32 contiguous, G = gx*gy*gz
// cells, A = 3W slots (rows x, y, z, charge, LJ mask, validity, 0, 0), and
// box (3,) on the device -> out (G, 8, A): per slot force x, y, z,
// eatom_lj, eatom_coul, phi, 0, 0. For each cell, all 27 neighbour offsets
// (the cell itself at offset 13) with i-side-only sums:
//   - per-pair minimum image, dx -= L * rint(dx / L) (round half to even,
//     as jnp.round);
//   - pair weight = valid_i * valid_j, times not-same-molecule on the self
//     offset only; masked pairs get r^2 = rc^2 + 1 BEFORE 1/r^2 (parked
//     slots sit 1e4 A away and min image can fold them anywhere);
//   - 12-6 shifted LJ weighted by the O masks of both slots;
//   - Coulomb with erfc from the Abramowitz-Stegun 7.1.26 polynomial and
//     expf (not erfcf: the kernel computes what the TPU kernel computes),
//     in DSF or 'cut' style, masked at rc;
//   - phi_i = QQR2E * sum_j q_j u(r_ij) with the same masks.
// Needs grid >= 3 per dim, so the 27 offsets are distinct cells.
//
// Bound: operations. The tiles are 0.9 MB in and 0.9 MB out at 24,001
// atoms, while one evaluation does G * A * 27 * A ~ 1.6e8 pair
// evaluations (twice the G * A^2 * 13.5 unordered pairs the function
// needs) of ~70 FP32 operations with an expf, a sqrtf and four IEEE
// divisions each; no tensor core applies. Design: as csrc/ww_pair.cu, one
// block per (cell, 32 i slots), 8 thread rows splitting the j loop
// (~1.3 k blocks of 256 threads for 132 SMs); a loop over the 27 offsets
// inside the block takes the place of the TPU's sequential 4th grid
// dimension. Each neighbour tile (6 rows of A floats, <= 5.5 KB) is
// staged in shared memory once per offset and read as a broadcast. Each
// output element is written by exactly one thread after a fixed-order sum
// of its 8 partials, so there are no atomics and the result is
// deterministic. The totals e_lj / e_coul are sums of rows 3 / 4, taken by
// the caller.

#include <cuda_runtime.h>

namespace {

constexpr int TI = 32;             // i slots per block (threadIdx.x)
constexpr int TJ = 8;              // j lanes per i slot (threadIdx.y)
constexpr int NT = TI * TJ;
constexpr int NROW = 8;            // rows of a packed tile / output
constexpr int NIN = 6;             // rows staged: x y z q lj valid
constexpr int NOUT = 6;            // rows computed: fx fy fz elj ecoul phi
constexpr int NOFF = 27;
constexpr int SELF_OFF = 13;       // offset (0, 0, 0)
constexpr float R2_MIN = 1.0e-4f;
static_assert(TJ == NROW, "thread row r writes output row r");

// layout of the host parameter array (tiled/cuda_ww.py _PARAM_ORDER)
enum {
  P_C6 = 0, P_C12, P_ESH, P_C6X6, P_C12X12, P_RC, P_RC2, P_FAR, P_ALPHA,
  P_TWO_OVER_SQRT_PI, P_QQR2E, P_E_SH, P_F_SH, P_COUNT
};

struct TallyParams {
  float c6, c12, esh, c6x6, c12x12;
  float rc, rc2, far, alpha, two_over_sqrt_pi, qqr2e, e_sh, f_sh;
  int dsf, screened;
  int gx, gy, gz, A;
};

__device__ __forceinline__ int wrap_cell(int c, int g) {
  return c < 0 ? c + g : (c >= g ? c - g : c);
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

__global__ void __launch_bounds__(NT)
ww_tally_kernel(const float* __restrict__ wt, const float* __restrict__ box,
                float* __restrict__ out, const TallyParams p) {
  extern __shared__ float sj[];    // NIN * A: the staged neighbour tile
  __shared__ float red[NOUT][TJ][TI];

  const int A = p.A;
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
  const float iLx = 1.f / Lx, iLy = 1.f / Ly, iLz = 1.f / Lz;

  const float* self = wt + static_cast<size_t>(cell) * NROW * A;
  float xi = 0.f, yi = 0.f, zi = 0.f, qi = 0.f, lji = 0.f, vi = 0.f;
  if (has_i) {
    xi = self[i];
    yi = self[A + i];
    zi = self[2 * A + i];
    qi = self[3 * A + i];
    lji = self[4 * A + i];
    vi = self[5 * A + i];
  }
  const int imol = i / 3;
  const float kqi = p.qqr2e * qi;

  float fx = 0.f, fy = 0.f, fz = 0.f, elj = 0.f, ecoul = 0.f, phi = 0.f;

  for (int k = 0; k < NOFF; ++k) {
    const int nx = wrap_cell(cx + k / 9 - 1, p.gx);
    const int ny = wrap_cell(cy + (k / 3) % 3 - 1, p.gy);
    const int nz = wrap_cell(cz + k % 3 - 1, p.gz);
    const float* tile =
        wt + static_cast<size_t>((nx * p.gy + ny) * p.gz + nz) * NROW * A;
    const bool self_off = k == SELF_OFF;

    __syncthreads();               // the previous tile is no longer read
    for (int a = tid; a < NIN * A; a += NT) sj[a] = tile[a];
    __syncthreads();
    if (!has_i) continue;

    for (int j = ty; j < A; j += TJ) {
      float dx = xi - sj[j];
      float dy = yi - sj[A + j];
      float dz = zi - sj[2 * A + j];
      dx = dx - Lx * rintf(dx * iLx);
      dy = dy - Ly * rintf(dy * iLy);
      dz = dz - Lz * rintf(dz * iLz);
      float r2 = dx * dx + dy * dy + dz * dz;
      float w = vi * sj[5 * A + j];
      if (self_off && j / 3 == imol) w = 0.f;
      r2 = w > 0.f ? fmaxf(r2, R2_MIN) : p.far;
      const float in_rc = r2 < p.rc2 ? 1.f : 0.f;
      const float inv_r2 = 1.f / r2;
      const float r = sqrtf(r2);

      const float ljp = lji * sj[4 * A + j] * in_rc;
      const float inv_r6 = inv_r2 * inv_r2 * inv_r2;
      elj += ((p.c12 * inv_r6 - p.c6) * inv_r6 - p.esh) * ljp;
      const float f_lj = (p.c12x12 * inv_r6 - p.c6x6) * inv_r6 * inv_r2 * ljp;

      float erfc_ar = 1.f, gauss = 0.f;
      if (p.screened) {
        const float ar = p.alpha * r;
        const float expmx2 = expf(-ar * ar);
        erfc_ar = erfc_pos(ar, expmx2);
        gauss = p.two_over_sqrt_pi * ar * expmx2;
      }
      float u = erfc_ar / r;
      float wr = (erfc_ar + gauss) * inv_r2 / r;
      if (p.dsf) {
        u = u - p.e_sh + p.f_sh * (r - p.rc);
        wr = wr - p.f_sh / r;
      }
      u *= in_rc;
      wr *= in_rc;
      const float qj = sj[3 * A + j];
      const float kqq = kqi * qj;
      const float fpair = f_lj + kqq * wr;
      fx += fpair * dx;
      fy += fpair * dy;
      fz += fpair * dz;
      ecoul += kqq * u;
      phi += qj * u;
    }
  }

  red[0][ty][tx] = fx;
  red[1][ty][tx] = fy;
  red[2][ty][tx] = fz;
  red[3][ty][tx] = elj;
  red[4][ty][tx] = ecoul;
  red[5][ty][tx] = phi;
  __syncthreads();
  if (has_i) {                     // thread row r adds and writes row r
    float acc = 0.f;
    if (ty < NOUT) {
#pragma unroll
      for (int k = 0; k < TJ; ++k) acc += red[ty][k][tx];
      // every pair's energy is tallied half on each of its two atoms
      if (ty == 3 || ty == 4) acc *= 0.5f;
      if (ty == 5) acc *= p.qqr2e;
    }
    out[(static_cast<size_t>(cell) * NROW + ty) * A + i] = acc;
  }
}

}  // namespace

extern "C" {

int ww_tally_param_count() { return P_COUNT; }

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
int ww_tally_forward(const float* wt, const float* box, float* out, int gx,
                     int gy, int gz, int A, const float* prm, int dsf,
                     int screened, void* stream) {
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
  p.dsf = dsf;
  p.screened = screened;
  p.gx = gx;
  p.gy = gy;
  p.gz = gz;
  p.A = A;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((A + TI - 1) / TI, gx * gy * gz);
  const dim3 block(TI, TJ);
  ww_tally_kernel<<<grid, block, NIN * A * sizeof(float), s>>>(wt, box, out,
                                                               p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
