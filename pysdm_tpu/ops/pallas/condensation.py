"""Pallas-Triton kernel: the per-droplet implicit condensation solve in one
pass over the drops.

The XLA formulation (``ops/condensation.py`` ``make_drop_solver``) runs the
16 bracket-expansion steps as a ``fori_loop`` and up to 64 bisection steps
as a ``while_loop`` over the whole drop array. Every ``minfun`` evaluation
then re-reads ~10 per-drop arrays from device memory, and every bisection
step ends in a device-wide predicate that the host waits for. This kernel
runs the same function on 1D blocks of drops: each drop's inputs are
loaded once, its bracket stays in registers through every iteration, and
each block leaves the bisection as soon as its own drops have converged —
one thread per droplet, as the reference GPU backend solves it
(``impl_thrust_rtc/bisection.py``).

The kernel is a float32 pipeline; f64 inputs are cast at the boundary.
"""

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..condensation import DROP_INPUTS

BLOCK = 256
NUM_WARPS = 4

_ACTIVE = DROP_INPUTS.index("active")


def masses_new_kernel(
    masses_new, *drop_args, block=BLOCK, num_warps=NUM_WARPS, interpret=False
):
    """``masses_new(*drop_args)`` (from ``make_drop_solver``) evaluated by a
    Triton kernel over blocks of ``block`` drops; returns
    (mass_new in the inputs' dtype, success as bool)"""
    assert len(drop_args) == len(DROP_INPUTS)
    in_dtype = drop_args[0].dtype
    n = drop_args[0].shape[0]
    n_pad = -(-n // block) * block

    def prep(i, x):
        x = jnp.asarray(x, jnp.float32)
        if n_pad == n:
            return x
        # edge-replicate the tail: zero padding would put thd = 0, vdry = 0
        # etc. into the padded drops and drive them through log(0) and
        # division by zero; the activity mask is zero-padded instead, so the
        # padded drops stay inert and are sliced off on return
        mode = "constant" if i == _ACTIVE else "edge"
        return jnp.pad(x, (0, n_pad - n), mode=mode)

    def kernel(*refs):
        in_refs, (mass_ref, ok_ref) = refs[:-2], refs[-2:]
        mass, ok = masses_new(*(ref[...] for ref in in_refs))
        mass_ref[...] = mass
        ok_ref[...] = ok.astype(jnp.int32)

    spec = pl.BlockSpec((block,), lambda i: (i,))
    mass, ok = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((n_pad,), jnp.float32),
            jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        ),
        grid=(n_pad // block,),
        in_specs=[spec] * len(drop_args),
        out_specs=(spec, spec),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="condensation_masses_new",
    )(*(prep(i, x) for i, x in enumerate(drop_args)))
    return mass[:n].astype(in_dtype), ok[:n] > 0
