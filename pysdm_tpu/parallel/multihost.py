"""Multi-host wiring: ``jax.distributed`` initialisation + host-replicated ->
global-array conversion for process-spanning meshes.

The reference is single-process (SURVEY.md §2.5 — no MPI/NCCL anywhere); this
layer is the addition that lets ``DistributedSimulation2D`` span
hosts: each process calls :func:`initialize` first, after which
``jax.devices()`` returns the devices of *all* processes and the x-slab mesh
becomes process-spanning. Simulation state is constructed host-replicated
(identical numpy on every process, same seed) and converted to global
``jax.Array``s with :func:`host_replicated_to_global` — each process donates
the contiguous block its addressable devices own.

Tested with 2 processes x 4 emulated CPU devices over localhost Gloo
(``tests/distributed/``); across hosts of GPUs the same calls ride the
hosts' interconnect.
"""

import numpy as np

import jax
from jax.sharding import NamedSharding


def initialize(
    *,
    coordinator_address,
    num_processes,
    process_id,
    local_device_count=None,
    platform=None,
):
    """wrap ``jax.distributed.initialize`` (idempotent per process).

    The coordinator address, process count and process id are always
    passed explicitly (nothing detects a cluster); for CPU-emulated
    multi-host tests set ``platform='cpu'`` and ``local_device_count`` to the
    per-process virtual device count. Must run before any backend use.
    """
    if platform is not None:
        jax.config.update("jax_platforms", platform)
    if local_device_count is not None:
        jax.config.update("jax_num_cpu_devices", local_device_count)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_replicated_to_global(tree, spec_tree, mesh):
    """convert a host-replicated pytree (identical numpy/local arrays on
    every process) into global ``jax.Array``s laid out per ``spec_tree``
    over ``mesh``. Single-process: a plain sharded ``device_put``;
    multi-process: each process donates the blocks its addressable devices
    own out of its full replicated copy (``make_array_from_callback``
    handles sharded, replicated and 0-d leaves uniformly)."""

    def leaf(x, spec):
        sharding = NamedSharding(mesh, spec)
        x = np.asarray(x)
        if jax.process_count() == 1:
            return jax.device_put(x, sharding)
        return jax.make_array_from_callback(
            x.shape, sharding, lambda idx: x[idx]
        )

    return jax.tree.map(leaf, tree, spec_tree)
