"""Mesh construction helpers."""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

from turdb_tpu.config import MESH_AXIS_DATA, MESH_AXIS_DB, MESH_AXIS_HOST


def make_mesh(
    n_db: int | None = None,
    n_data: int = 1,
    devices=None,
) -> Mesh:
    """Build a (data, db) mesh. `db` shards the vector store/graph; `data`
    shards query batches. Defaults to all visible devices on the db axis.

    Axis order puts `data` outermost. The cards of one node reach each
    other all to all (NVLink on GPUs), so the mesh follows the algorithm,
    not a physical topology.
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_db is None:
        n_db = len(devices) // n_data
    assert n_db * n_data <= len(devices), (
        f"need {n_db * n_data} devices, have {len(devices)}"
    )
    grid = np.array(devices[: n_db * n_data]).reshape(n_data, n_db)
    return Mesh(grid, (MESH_AXIS_DATA, MESH_AXIS_DB))


def make_multihost_mesh(
    n_host: int, n_db: int, n_data: int = 1, devices=None
) -> Mesh:
    """Build a (host, data, db) mesh for multi-host deployments.

    `host` is outermost: with standard device enumeration (all of host 0's
    cards before host 1's) the host axis crosses the inter-node network
    while `db` stays inside each node. The sharded indexes detect the axis
    and run a TWO-LEVEL top-k merge — all_gather over `db` (intra-node),
    reduce to [B, k], then all_gather over `host` so only k results per
    query cross nodes (SURVEY.md §2.9 two-level merge).
    """
    devices = list(devices if devices is not None else jax.devices())
    need = n_host * n_db * n_data
    assert need <= len(devices), f"need {need} devices, have {len(devices)}"
    grid = np.array(devices[:need]).reshape(n_host, n_data, n_db)
    return Mesh(grid, (MESH_AXIS_HOST, MESH_AXIS_DATA, MESH_AXIS_DB))
