"""System container: everything a run needs, bundled."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from constant_ph_tpu_torch.engine import Engine, EngineConfig
from constant_ph_tpu_torch.forcefield import BondedParams, ForceField
from constant_ph_tpu_torch.lambda_dyn import BiasParams, LambdaSpec
from constant_ph_tpu_torch.neighbors import NeighborParams
from constant_ph_tpu_torch.ops.bonded import bonded_forces
from constant_ph_tpu_torch.ops.constraints import RigidTriatomic
from constant_ph_tpu_torch.state import SystemState


@dataclasses.dataclass
class System:
    """A fully specified simulation: force field + initial state +
    neighbour-list sizing (+ bonded terms, rigid-water constraints, λ
    sites and the titratable-H group)."""

    ff: ForceField
    state: SystemState
    nbr_params: NeighborParams
    bonded: Optional[BondedParams] = None
    constraints: Optional[RigidTriatomic] = None
    spec: Optional[LambdaSpec] = None
    groupH_mask: Optional[torch.Tensor] = None   # (N,) bool

    def make_engine(self, config: EngineConfig,
                    bias: BiasParams = BiasParams(), kspace_fn=None,
                    extra_potentials=()) -> Engine:
        """The reference Engine of this system."""
        bonded_fn = None
        if self.bonded is not None and int(self.bonded.bond_idx.shape[0]):
            bp = self.bonded

            def bonded_fn(x, box):
                return bonded_forces(x, box, bp)

        return Engine(self.ff, self.nbr_params, config, spec=self.spec,
                      bias=bias, bonded_fn=bonded_fn, kspace_fn=kspace_fn,
                      constraints=self.constraints,
                      extra_potentials=extra_potentials)
