"""Backend configuration.

The engine has a single computational backend — JAX/XLA — which targets GPU
and CPU alike; the classes here only carry dtype policy + formulae (the
reference's CPU/GPU backend split, ``PySDM/backends/__init__.py``, does not
apply: XLA compiles the same traced program for every device). ``CPU`` / ``GPU``
names are provided as aliases so reference-style scripts work unchanged.
"""

import jax.numpy as jnp


class JaxBackend:
    default_croupier = "sort"  # sort-by-(cell, random-key) croupier

    def __init__(self, formulae=None, double_precision=True, mult_dtype=None):
        from ..physics import Formulae

        self.formulae = formulae or Formulae()
        self.dtype = jnp.float64 if double_precision else jnp.float32
        self.mult_dtype = mult_dtype or jnp.int64

    @property
    def Storage(self):  # pragma: no cover - reference-API stub
        raise NotImplementedError(
            "pysdm_tpu keeps state as jnp arrays; no Storage objects"
        )


class TPU(JaxBackend):
    """float32 compute by default; int64 multiplicities (the class name is
    historical: it is the float32 dtype policy, on any device)"""

    def __init__(self, formulae=None, double_precision=False, mult_dtype=None):
        super().__init__(formulae, double_precision, mult_dtype)


CPU = JaxBackend
GPU = JaxBackend
