"""Multi-host distributed seam: process-group init + host-spanning meshes.

On a multi-host GPU cluster each Python process owns the cards of its
host; ``jax.distributed.initialize`` (given ``coordinator_address``,
``num_processes`` and ``process_id``) forms the process group over the
network between hosts, and ``jax.devices()`` then reports EVERY card, so
the same ``shard_map`` programs in ``parallel/distributed.py`` run
unchanged — collectives ride NVLink between the cards of one host and
the network between hosts.

Only single-host meshes have run on cards, so the cross-host data path
here is covered by construction + unit tests of the mesh/topology logic
only (ROADMAP.md). The reference has no distributed
backend at all (SURVEY.md §5 "distributed communication backend" row).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class MultiHostSpec:
    """Resolved multi-host topology."""

    coordinator: str
    num_processes: int
    process_id: int

    @classmethod
    def from_env(cls, coordinator: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None) -> "MultiHostSpec":
        """Resolve from explicit args, falling back to the conventional
        environment variables (COORDINATOR_ADDRESS / NUM_PROCESSES /
        PROCESS_ID), defaulting to a single-process group."""
        coordinator = coordinator or os.environ.get(
            "COORDINATOR_ADDRESS", "localhost:8476")
        if num_processes is None:
            num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
        if process_id is None:
            process_id = int(os.environ.get("PROCESS_ID", "0"))
        if not 0 <= process_id < num_processes:
            raise ValueError(
                f"process_id {process_id} out of range for "
                f"{num_processes} processes")
        return cls(coordinator=coordinator, num_processes=num_processes,
                   process_id=process_id)


def initialize_multihost(spec: MultiHostSpec | None = None) -> MultiHostSpec:
    """Join the distributed process group (no-op for a 1-process spec)."""
    import jax

    spec = spec or MultiHostSpec.from_env()
    if spec.num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=spec.coordinator,
            num_processes=spec.num_processes,
            process_id=spec.process_id)
    return spec


def amp_axis_split(n_devices: int, n_hosts: int,
                   devices_per_host: int | None = None
                   ) -> tuple[int, int]:
    """Factor a 1-D amplitude mesh into (hosts, cards per host) axis
    sizes.

    The amplitude index's MOST significant device bits should map to the
    slowest links: put the host (network) factor first so qubit-swap
    collectives for low-index qubits (rare in well-ordered circuits)
    cross hosts while the frequent high-index swaps stay on NVLink
    within a host.
    """
    if n_devices % n_hosts:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"{n_hosts} hosts")
    per_host = devices_per_host or n_devices // n_hosts
    if n_hosts * per_host != n_devices:
        raise ValueError("hosts x devices_per_host != n_devices")
    for v in (n_hosts, per_host):
        if v & (v - 1):
            raise ValueError(f"mesh factors must be powers of 2, got {v}")
    return n_hosts, per_host


def make_multihost_mesh(axis_name: str = "amp",
                        n_devices: int | None = None):
    """1-D amplitude mesh over every device in the process group, ordered
    host-major so device-index bit k corresponds to cross-host links iff
    k < log2(num_hosts)."""
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices & (n_devices - 1):
        raise ValueError(f"n_devices must be a power of 2, got {n_devices}")
    # jax.devices() is already process-major (= host-major) ordered.
    arr = np.array(devices[:n_devices])
    return Mesh(arr, (axis_name,))
