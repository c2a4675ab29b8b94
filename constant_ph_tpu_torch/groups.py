"""Named atom groups and the non-finite guard (port of
constant_ph_tpu/groups.py).

The reference resolves group names to bitmasks and tests membership with
`mask[i] & bit` (fix_constant_pH.cpp:39-46, 164, 266); here they are named
boolean masks over the atom axis, with masked-reduction helpers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from constant_ph_tpu_torch import resolve_device


class Groups:
    def __init__(self, n_atoms: int, device="cuda"):
        self.n_atoms = n_atoms
        self.device = resolve_device(device)
        self._masks: dict = {"all": torch.ones((n_atoms,), dtype=torch.bool,
                                               device=self.device)}

    def define(self, name: str, ids=None, mask=None) -> torch.Tensor:
        """Define a group by atom ids or a boolean mask (ref: group
        command)."""
        if mask is None:
            mask = np.zeros((self.n_atoms,), dtype=bool)
            mask[np.asarray(ids, dtype=np.int64)] = True
        m = torch.as_tensor(np.asarray(mask, dtype=bool), device=self.device)
        self._masks[name] = m
        return m

    def find(self, name: str) -> torch.Tensor:
        """Lookup (the group->find analog); KeyError mirrors the
        reference's 'Cannot find the ... group' validation
        (fix_constant_pH.cpp:40)."""
        if name not in self._masks:
            raise KeyError(f"cannot find group '{name}'")
        return self._masks[name]

    def count(self, name: str) -> int:
        """group->count analog (the 3-atom water group check,
        fix_constant_pH.cpp:44-46)."""
        return int(torch.sum(self.find(name)))

    def union(self, *names: str) -> torch.Tensor:
        m = self.find(names[0])
        for n in names[1:]:
            m = m | self.find(n)
        return m

    @staticmethod
    def masked_sum(values, mask):
        return torch.sum(torch.where(mask, values, torch.zeros_like(values)))


def _leaves(tree, path=""):
    """(path, tensor) for every tensor of a dataclass / dict / list /
    tuple tree, paths spelt as jax.tree_util.keystr spells them."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")


def check_finite(tree, name: str = "state"):
    """Failure-detection guard (SURVEY.md §5.3): host-side NaN/Inf check of
    a dataclass or dict of tensors; raises naming the offending leaf. One
    host sync per floating leaf."""
    for path, leaf in _leaves(tree):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"non-finite values in {name}{path}")
