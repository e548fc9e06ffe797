"""AIR (algebraic intermediate representation) interface.

Port of `ethrex_tpu/stark/air.py`.  Constraints are written once against an
abstract field-ops object and evaluated in two worlds:

  * on the device, over the whole LDE domain at once (`DeviceOps`: int32
    Montgomery tensors) — the prover's quotient construction;
  * on the host, at the out-of-domain point zeta (`HostExtOps`: canonical
    quartic-extension tuples) — the verifier's consistency check.
"""

from __future__ import annotations

import torch

from ..ops import babybear as bb
from ..ops import ext


class DeviceOps:
    """Base-field ops over int32 Montgomery tensors on one device."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self._consts: dict = {}

    def const(self, v: int):
        v = int(v) % bb.P
        t = self._consts.get(v)
        if t is None:
            t = bb.const(v, self.device)
            self._consts[v] = t
        return t

    add = staticmethod(bb.add)
    sub = staticmethod(bb.sub)
    mul = staticmethod(bb.mont_mul)


class HostExtOps:
    """Quartic-extension ops over canonical 4-tuples."""

    def const(self, v: int):
        return ext.h_from_base(v)

    add = staticmethod(ext.h_add)
    sub = staticmethod(ext.h_sub)
    mul = staticmethod(ext.h_mul)


class Air:
    """Subclass and define width / max_degree / constraints / boundaries."""

    width: int = 0
    max_degree: int = 2      # max multiplicative degree of any constraint
    num_pub_inputs: int = 0  # boundary STRUCTURE must not depend on values
    num_periodic: int = 0    # how many periodic columns periodic_columns gives

    def constraints(self, local, nxt, periodic, ops):
        """local/nxt: per-column field values (lists of length `width`);
        periodic: this AIR's periodic columns at the same point.  Returns
        constraint evaluations that vanish on every transition row."""
        raise NotImplementedError

    def periodic_columns(self, n: int):
        """Preprocessed columns: canonical numpy arrays whose length
        divides n (selectors, round-constant schedules)."""
        return []

    def boundaries(self, pub_inputs, n: int):
        """Return [(row, col, value)] assertions binding public inputs."""
        raise NotImplementedError

    def cache_key(self) -> tuple:
        """Structural identity for the prover's per-shape table cache."""
        return (type(self), self.width, self.max_degree, self.num_pub_inputs)

    @property
    def num_constraints(self) -> int:
        ops = HostExtOps()
        zero = [ext.ZERO_H] * self.width
        zero_p = [ext.ZERO_H] * self.num_periodic
        return len(self.constraints(zero, zero, zero_p, ops))
