"""Checkpoint / resume of the full prognostic simulation state.

The reference has no checkpointing (SURVEY.md §5 — nearest equivalents are
the VTK/netCDF exporters, ``PySDM/exporters/``); with the fixed-size SoA
pytree design the complete prognostic state (particles + env fields +
counters + flags + RNG key) serialises losslessly. Two interchangeable
container formats:

- ``save_npz`` / ``load_npz``: single-file numpy archive (no extra deps,
  host-memory staging) — handy for tests and small runs;
- ``save_orbax`` / ``restore_orbax``: orbax-checkpoint directory tree —
  async-capable, multi-host-aware (each host writes its own shards); an
  optional dependency, imported only when called.

Restoring rebuilds the running particulator in place: the caller builds the
same configuration (same Builder wiring — dynamics, products, mesh), then
calls ``restore_*`` which swaps the prognostic arrays and step counter.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np

_META_KEY = "__pysdm_tpu_meta__"


def _path_elem(p):
    if hasattr(p, "key"):
        return str(p.key)  # DictKey
    if hasattr(p, "name"):
        return str(p.name)  # GetAttrKey (struct.dataclass fields)
    return str(p.idx)  # SequenceKey


def _flatten_sim_state(sim_state, n_steps):
    """sim_state pytree -> flat {path: ndarray} + json-able meta"""
    flat = {}
    leaves_with_paths = jax.tree_util.tree_flatten_with_path(sim_state)[0]
    paths = []
    for path, leaf in leaves_with_paths:
        key = "/".join(_path_elem(p) for p in path)
        flat[key] = np.asarray(leaf)
        paths.append(key)
    meta = {"n_steps": int(n_steps), "paths": paths}
    return flat, meta


def _unflatten_into(sim_state, flat):
    """rebuild a sim_state pytree of the same structure from flat arrays"""
    leaves_with_paths, treedef = jax.tree_util.tree_flatten_with_path(
        sim_state
    )
    new_leaves = []
    for path, leaf in leaves_with_paths:
        key = "/".join(_path_elem(p) for p in path)
        if key not in flat:
            if np.size(leaf) == 0:  # zero-size leaves are not stored
                new_leaves.append(leaf)
                continue
            raise KeyError(f"checkpoint is missing state leaf: {key}")
        saved = flat[key]
        if tuple(saved.shape) != tuple(np.shape(leaf)):
            raise ValueError(
                f"checkpoint shape mismatch for {key}: "
                f"{saved.shape} vs {np.shape(leaf)} — was the simulation "
                "built with the same configuration?"
            )
        new_leaves.append(jnp.asarray(saved, dtype=jnp.asarray(leaf).dtype))
    return jax.tree_util.tree_unflatten(treedef, new_leaves)


def save_npz(particulator, path):
    """write the complete prognostic state to a single .npz file"""
    flat, meta = _flatten_sim_state(
        particulator.sim_state, particulator.n_steps
    )
    np.savez_compressed(path, **flat, **{_META_KEY: json.dumps(meta)})


def restore_npz(particulator, path):
    """restore state saved by ``save_npz`` into an identically-built
    particulator (in place)"""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data[_META_KEY]))
        flat = {k: data[k] for k in data.files if k != _META_KEY}
    particulator.sim_state = _unflatten_into(particulator.sim_state, flat)
    particulator.n_steps = meta["n_steps"]
    return particulator


def save_orbax(particulator, directory):
    """write the state via orbax-checkpoint (multi-host runs)"""
    import orbax.checkpoint as ocp

    flat, meta = _flatten_sim_state(
        particulator.sim_state, particulator.n_steps
    )
    # orbax rejects zero-size arrays (e.g. the 0D mesh's (0, n_sd)
    # cell_origin rows) — they carry no data, so skip and rebuild on restore
    flat = {k: v for k, v in flat.items() if v.size > 0}
    with ocp.PyTreeCheckpointer() as checkpointer:
        checkpointer.save(
            directory, {"state": flat, "meta": meta}, force=True
        )


def restore_orbax(particulator, directory):
    """restore state saved by ``save_orbax`` (in place)"""
    import orbax.checkpoint as ocp

    with ocp.PyTreeCheckpointer() as checkpointer:
        payload = checkpointer.restore(directory)
    flat = {k: np.asarray(v) for k, v in payload["state"].items()}
    particulator.sim_state = _unflatten_into(particulator.sim_state, flat)
    particulator.n_steps = int(payload["meta"]["n_steps"])
    return particulator
