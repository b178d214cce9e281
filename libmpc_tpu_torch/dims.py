"""Problem-dimension records.

The reference encodes dimensions either as C++ template parameters ("static"
mode) or runtime ints ("dynamic" mode) via the constexpr ``Size``/``MPCSize``
machinery (reference: include/mpc/Dim.hpp:10-132).  Here, as in the JAX
package (``libmpc_tpu/dims.py``), dimensions are plain Python ints.
"""

from __future__ import annotations

from typing import NamedTuple


class LDims(NamedTuple):
    """Dimensions of a linear MPC problem (LMPC<Tnx,Tnu,Tndu,Tny,Tph,Tch>)."""

    nx: int
    nu: int
    ndu: int
    ny: int
    ph: int
    ch: int

    # --- derived sizes of the sparse simultaneous QP --------------------
    # Decision vector z = [x_aug_0 .. x_aug_ph ; du_0 .. du_{ph-1}]
    # (reference: include/mpc/LMPC/ProblemBuilder.hpp:70-76)
    @property
    def nxu(self) -> int:
        return self.nx + self.nu

    @property
    def n_aug(self) -> int:
        """Number of stacked augmented-state variables."""
        return (self.ph + 1) * self.nxu

    @property
    def n_du(self) -> int:
        return self.ph * self.nu

    @property
    def nz(self) -> int:
        """QP decision-vector length."""
        return self.n_aug + self.n_du

    @property
    def n_eq(self) -> int:
        """Dynamics equality rows."""
        return (self.ph + 1) * self.nxu

    @property
    def n_box(self) -> int:
        """Box rows on the stacked augmented states."""
        return (self.ph + 1) * self.nxu

    @property
    def n_out(self) -> int:
        """Output constraint rows."""
        return (self.ph + 1) * self.ny

    @property
    def n_dub(self) -> int:
        """Delta-u box rows."""
        return self.ph * self.nu

    @property
    def n_sc(self) -> int:
        """Scalar-constraint rows."""
        return self.ph + 1

    @property
    def n_ineq(self) -> int:
        return self.n_box + self.n_out + self.n_dub + self.n_sc

    @property
    def m(self) -> int:
        """Total constraint rows of the QP."""
        return self.n_eq + self.n_ineq

    def validate(self) -> "LDims":
        if min(self.nx, self.nu, self.ny, self.ph, self.ch) <= 0:
            raise ValueError(f"dimensions must be positive, got {self}")
        if self.ndu < 0:
            raise ValueError(f"ndu must be >= 0, got {self.ndu}")
        if self.ch > self.ph:
            raise ValueError(f"control horizon {self.ch} > prediction horizon {self.ph}")
        return self


class NLDims(NamedTuple):
    """Dimensions of a nonlinear MPC problem (NLMPC<Tnx,Tnu,Tny,Tph,Tch,Tineq,Teq>)."""

    nx: int
    nu: int
    ny: int
    ph: int
    ch: int
    ineq: int
    eq: int

    @property
    def nz(self) -> int:
        """NLP decision-vector length: states + blocked moves + slack
        (reference: include/mpc/NLMPC/NLOptimizer.hpp:64)."""
        return self.ph * self.nx + self.nu * self.ch + 1

    @property
    def n_defect(self) -> int:
        """Dynamics defect equality rows."""
        return self.ph * self.nx

    def validate(self) -> "NLDims":
        if min(self.nx, self.nu, self.ny, self.ph, self.ch) <= 0:
            raise ValueError(f"dimensions must be positive, got {self}")
        if self.ineq < 0 or self.eq < 0:
            raise ValueError(f"constraint counts must be >= 0, got {self}")
        if self.ch > self.ph:
            raise ValueError(f"control horizon {self.ch} > prediction horizon {self.ph}")
        return self
