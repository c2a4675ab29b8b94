"""System container: everything a run needs, bundled."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from constant_ph_tpu_torch.forcefield import BondedParams, ForceField
from constant_ph_tpu_torch.lambda_dyn import LambdaSpec
from constant_ph_tpu_torch.ops.constraints import RigidTriatomic
from constant_ph_tpu_torch.state import SystemState


@dataclasses.dataclass
class System:
    """A fully specified simulation: force field + initial state (+ bonded
    terms, rigid-water constraints, λ sites and the titratable-H group)."""

    ff: ForceField
    state: SystemState
    bonded: Optional[BondedParams] = None
    constraints: Optional[RigidTriatomic] = None
    spec: Optional[LambdaSpec] = None
    groupH_mask: Optional[torch.Tensor] = None   # (N,) bool
