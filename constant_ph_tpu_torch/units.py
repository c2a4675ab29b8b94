"""Unit system: LAMMPS "real" units, fixed explicitly.

The reference implicitly assumes LAMMPS-real units (kcal/mol energies, fs
time, Å lengths, atomic charges in e, masses in g/mol) — e.g. the λ mass of
20 u at fix_constant_pH.cpp:95-96 and the R·T·ln(10) pH term at
fix_constant_pH.cpp:111. We fix the same system explicitly so every constant
has a documented value.

Derived conversion factors:

- ``MVV2E``: (g/mol)·(Å/fs)² → kcal/mol.
  1 g/mol · (1 Å/fs)² = 1e-3 kg/mol · (1e5 m/s)² = 1e7 J/mol = 1e7/4184 kcal/mol.
- ``FTM2V``: (kcal/mol/Å) / (g/mol) → Å/fs² (acceleration), the inverse of MVV2E.
- ``QQR2E``: Coulomb prefactor so that U = QQR2E · q_i q_j / r is in kcal/mol
  with q in e and r in Å (LAMMPS-real value).
"""

# Boltzmann constant, kcal/(mol·K). Equals the molar gas constant R in these
# per-mole units — the "R" of the reference's R·T·ln(10) pH driving term
# (fix_constant_pH.cpp:111).
BOLTZ = 0.0019872067

# (g/mol)(Å/fs)^2 -> kcal/mol
MVV2E = 1.0e7 / 4184.0  # = 2390.0573613766730

# (kcal/mol/Å)/(g/mol) -> Å/fs^2
FTM2V = 1.0 / MVV2E

# Coulomb constant: kcal·Å/(mol·e^2)
QQR2E = 332.06371

# natural log of 10 (the reference's broken `ln(10)`, fix_constant_pH.cpp:111)
LN10 = 2.302585092994046

# femtoseconds per nanosecond (for ns/day throughput reporting)
FS_PER_NS = 1.0e6

# P·V work conversion for the MC barostat: 1 atm·Å³ in kcal/mol.
# 101325 Pa · 1e-30 m³ = 1.01325e-25 J; × N_A (6.02214076e23 /mol)
# = 6.1019e-2 J/mol = 6.1019e-2/4184 kcal/mol.
ATM_A3_TO_KCAL = 101325.0 * 1e-30 * 6.02214076e23 / 4184.0


def kT(temperature: float) -> float:
    """Thermal energy in kcal/mol at the given temperature (K)."""
    return BOLTZ * temperature
