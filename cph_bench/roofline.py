"""The yardstick of kernel K1 (constant_ph_tpu_torch/csrc/ww_pair.cu, the
water-water pair block): the work its inputs need, the card's published
peaks, and the least time that follows.

FLOP a pair, from K1's pair loop (ww_pair.cu, the 9 atom pairs of a
molecule pair), an FMA counted as 2 and rsqrt, min, max and a compare as
1 each: the displacement, difference first and image shift last (6); r²
(5), its clamp at R2_MIN (1) and the cutoff test (1); rsqrt, 1/r² and r
(3); t = 2r/rc − 1 and its clamp (3); the two degree-10 Horner chains of
the screening fits (40); u and w (3); the energy sum kqq·(u·in_rc) (3);
the force factor kqq·(w·in_rc) (2); the three force sums (6): 73 for
every atom pair under 'cut'. DSF adds its two shifts (6): 79. The O–O
ninth of the pairs adds LJ: 1/r⁶ (2), the shifted 12-6 energy and its
sum (6), the force factor and its sum (6): 14. So 73 + 14/9 = 74.56
('cut') and 79 + 14/9 = 80.56 ('dsf'). The count is the function's, not
the kernel's: each unordered atom pair of different waters inside rc
once, whatever the kernel evaluates twice or culls.

The pair count is this benchmark's own copy (a later change to the
port's ``tiled.forces.water_pairs_in_cutoff`` does not move it), taken
from atom positions with the minimum image."""
from __future__ import annotations

import subprocess

import torch

FLOP_PER_PAIR = {"cut": 73 + 14 / 9, "dsf": 79 + 14 / 9}
# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def water_pairs_in_cutoff(x, box, rc, rows=2048):
    """Unordered pairs of atoms of different waters with r² < rc², for
    water positions x (M, 3, 3) (molecule, atom, xyz) float32 and box
    (3,). An int."""
    a = x.reshape(-1, 3)
    mol = torch.arange(x.shape[0], device=x.device).repeat_interleave(3)
    n = 0
    for i in range(0, a.shape[0], rows):
        dx = a[i:i + rows, None, :] - a[None, :, :]
        dx = dx - box * torch.round(dx / box)
        r2 = torch.clamp(torch.sum(dx * dx, dim=-1), min=1.0e-4)
        other = mol[i:i + rows, None] != mol[None, :]
        n += int(torch.sum((r2 < rc * rc) & other))
    return n // 2


def k1_least_seconds(pairs, n_atoms_tiles, style):
    """The least time of one K1 evaluation that needs ``pairs`` pairs:
    the larger of its FP32 work over the FP32 peak and its bytes (the
    tiles in, the forces out, float32) over HBM bandwidth."""
    return max(pairs * FLOP_PER_PAIR[style] / PEAK_FP32_FLOPS,
               2 * 3 * n_atoms_tiles * 4 / PEAK_BYTES_PER_S)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them; the
    peaks above assume the full 700 W."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or "not read"
