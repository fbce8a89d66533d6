"""Multi-process scaling: jax.distributed initialization and the global
data-parallel mesh.

The reference is single-process Julia with no distributed backend at all
(SURVEY.md §2.10); its Monte-Carlo studies are serial for-loops
(``examples/hopper/monte_carlo.jl:78-91``). Here those sweeps run over
every GPU of one or more hosts:

* Every process runs THIS same program (SPMD). ``initialize()`` wires the
  processes together via the coordinator service; afterwards
  ``jax.devices()`` is the *global* device list.
* Monte-Carlo lanes only exchange scalar sweep statistics (one ``psum``
  per sweep), so one data-parallel ``dp`` axis covers every card: within
  a host the psum rides NVLink, across hosts the network, and either way
  it is a few scalars per sweep. ``make_global_mesh`` orders the axis by
  process so each process's lanes are contiguous.
* Per-process batch shards are assembled into one global array with
  ``jax.make_array_from_process_local_data`` — no host ever materializes
  the full sweep.

The multi-process path is checked by a 2-process × 4-virtual-CPU-device
test (``tests/test_multihost.py``), the same program shape as several
GPU hosts.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> bool:
    """Join the multi-process runtime; returns True if distributed.

    Pass the coordinator (``host:port``), process count and process id
    explicitly, or set ``CIMPC_COORDINATOR`` / ``CIMPC_NUM_PROCESSES`` /
    ``CIMPC_PROCESS_ID``. Without a coordinator the run stays a plain
    single process and this returns False — every downstream helper then
    degrades to the single-host behavior.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "CIMPC_COORDINATOR")
    if num_processes is None and "CIMPC_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["CIMPC_NUM_PROCESSES"])
    if process_id is None and "CIMPC_PROCESS_ID" in os.environ:
        process_id = int(os.environ["CIMPC_PROCESS_ID"])

    if coordinator_address is None:
        return False

    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    return True


def make_global_mesh() -> Mesh:
    """1-D ``("dp",)`` mesh over every device of every process, ordered by
    ``(process_index, id)`` so each process owns one contiguous block of
    the axis. Single-process: the same mesh as ``make_mesh()``."""
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devices), ("dp",))


def global_batch(mesh: Mesh, local_batch: np.ndarray):
    """Assemble per-process batch shards into one global sharded array.

    Each process passes its OWN ``local_batch`` (its slice of the
    Monte-Carlo sweep, e.g. seeds ``process_id * n_local + i``); the
    result behaves as the concatenated global batch laid out over the
    mesh without any host-side gather.
    """
    sharding = NamedSharding(mesh, P(mesh.axis_names))
    return jax.make_array_from_process_local_data(sharding, local_batch)


def process_local_slice(x) -> np.ndarray:
    """Gather THIS process's shards of a mesh-laid-out array to host
    memory (the inverse of ``global_batch`` for inspection/logging)."""
    shards = [s for s in x.addressable_shards]
    shards.sort(key=lambda s: s.index)
    return np.concatenate([np.asarray(s.data) for s in shards], axis=0)
