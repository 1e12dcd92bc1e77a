"""pysdm_tpu — super-droplet cloud-microphysics engine in JAX.

A from-scratch JAX/XLA/Pallas implementation of the Super-Droplet Method
(Shima et al. 2009) with the capability surface of PySDM: SDM Monte-Carlo
collisional coalescence/breakup, implicit condensation/activation,
displacement/sedimentation coupled to MPDATA Eulerian advection, freezing,
chemistry, isotopes, products and exporters — designed for SPMD execution on
accelerator meshes rather than ported from the reference's Numba/ThrustRTC
backends (see SURVEY.md §7 for the design deltas).

64-bit support is enabled at import time: super-droplet multiplicities are
int64 (reference parity; see reference ``PySDM/attributes/physics/multiplicity.py``)
and float64 is the default validation dtype. Hot-path arrays remain float32
when requested (the float32 backend class) — x64 mode only *allows* wide
types.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from .physics import Formulae, si  # noqa: E402
from .builder import Builder  # noqa: E402
from .particulator import Particulator  # noqa: E402

__version__ = "0.1.0"
