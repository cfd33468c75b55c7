"""Per-shard checkpointing for mesh-sharded statevectors.

A sharded n=32 state is 32 GiB and its deep-circuit forward takes hours
on constrained hosts — segmented runs (``DistributedSimulator.
run_segmented``) need to survive process death. Each device shard saves
independently as split real/imag float planes (the ``utils/xfer``
rule), so no device ever materializes, transfers, or gathers the full
vector. A manifest carries the identity of what was
checkpointed (circuit hash, segment cursor, mesh shape) so a resume can
never silently continue the wrong run.

The reference has no resumable execution at all — its engine runs a
circuit start-to-finish in one process call
(``/root/reference/quantum_sim/engine/simulator.py``); checkpoint/resume
is called out as an auxiliary subsystem in SURVEY.md §5.

Atomicity: each checkpoint writes into its own ``seg_<k>/`` directory,
then the ``LATEST`` pointer file is replaced atomically (``os.replace``)
and older segment directories are pruned. A crash mid-save leaves the
previous pointer — and its intact shard files — in place.
"""

from __future__ import annotations

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["save_sharded_state", "load_sharded_state",
           "write_latest", "read_latest"]

_MANIFEST = "manifest.json"
_LATEST = "LATEST"


def _shard_key(shard) -> int:
    """Order 1-D shards by their global start offset."""
    sl = shard.index[0]
    return 0 if sl.start is None else int(sl.start)


def save_sharded_state(array: jax.Array, directory: str,
                       meta: dict | None = None) -> None:
    """Save a 1-D mesh-sharded complex array, one split-plane file pair
    per shard. ``meta`` goes into the manifest verbatim."""
    os.makedirs(directory, exist_ok=True)
    # Elementwise real/imag preserve the sharding; per-shard transfers
    # are then plain float copies.
    re = jnp.real(array)
    im = jnp.imag(array)
    re_shards = sorted(re.addressable_shards, key=_shard_key)
    im_shards = sorted(im.addressable_shards, key=_shard_key)
    for k, (rs, ims) in enumerate(zip(re_shards, im_shards)):
        np.save(os.path.join(directory, f"shard_{k}_re.npy"),
                np.asarray(rs.data))
        np.save(os.path.join(directory, f"shard_{k}_im.npy"),
                np.asarray(ims.data))
    manifest = {
        "num_shards": len(re_shards),
        "global_shape": list(array.shape),
        "dtype": str(array.dtype),
        "meta": meta or {},
    }
    tmp = os.path.join(directory, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(tmp, os.path.join(directory, _MANIFEST))


def load_manifest(directory: str) -> dict:
    with open(os.path.join(directory, _MANIFEST)) as f:
        return json.load(f)


def load_sharded_state(directory: str, mesh: Mesh,
                       dtype=None) -> jax.Array:
    """Rebuild the global sharded array on ``mesh`` from a checkpoint.

    Each shard's planes go host->device with float DMA and combine into
    complex ON the owning device; the global array is assembled with
    ``jax.make_array_from_single_device_arrays`` — the full vector never
    exists on any single device or as one host buffer.
    """
    manifest = load_manifest(directory)
    axis = mesh.axis_names[0]
    n_devices = int(mesh.shape[axis])
    if n_devices != manifest["num_shards"]:
        raise ValueError(
            f"checkpoint has {manifest['num_shards']} shards but the mesh "
            f"has {n_devices} devices — reshard is not supported")
    dtype = jnp.dtype(dtype or manifest["dtype"])
    shape = tuple(manifest["global_shape"])
    sharding = NamedSharding(mesh, P(axis))

    combine = jax.jit(lambda r, i: (r + 1j * i).astype(dtype))
    pieces = []
    for k, dev in enumerate(mesh.devices.flat):
        re = np.load(os.path.join(directory, f"shard_{k}_re.npy"))
        im = np.load(os.path.join(directory, f"shard_{k}_im.npy"))
        pieces.append(combine(jax.device_put(re, dev),
                              jax.device_put(im, dev)))
    return jax.make_array_from_single_device_arrays(shape, sharding, pieces)


def write_latest(root: str, seg_dir: str, prune: bool = True) -> None:
    """Atomically point ``root/LATEST`` at ``seg_dir`` (a subdirectory
    name), then prune every other ``seg_*`` checkpoint under ``root``."""
    tmp = os.path.join(root, _LATEST + ".tmp")
    with open(tmp, "w") as f:
        f.write(seg_dir)
    os.replace(tmp, os.path.join(root, _LATEST))
    if prune:
        for name in os.listdir(root):
            if name.startswith("seg_") and name != seg_dir and \
                    os.path.isdir(os.path.join(root, name)):
                shutil.rmtree(os.path.join(root, name),
                              ignore_errors=True)


def read_latest(root: str) -> str | None:
    """Directory of the newest complete checkpoint under ``root``
    (absolute path), or None if there is none / it is incomplete."""
    path = os.path.join(root, _LATEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        seg_dir = f.read().strip()
    full = os.path.join(root, seg_dir)
    return full if os.path.exists(os.path.join(full, _MANIFEST)) else None
