"""HNSW index snapshot files (.hnsw).

Counterpart of reference src/hnsw/storage.rs (magic'd 128-byte header with
graph parameters + entry point + counts, :21-44,100-119) — but where the
reference persists slotted node pages, the device graph IS dense arrays, so
a snapshot is a straight dump of the adjacency/vector/level arrays plus
the rowid↔slot map. Checkpointing device state with the WAL boundary is
exactly the "durability of device state" hard part from SURVEY.md §7.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from turdb_tpu.config import FILE_HEADER_SIZE, FORMAT_VERSION, MAGIC_HNSW
from turdb_tpu.models.hnsw import Sq8Rows
from turdb_tpu.records.jsonb import jsonb_decode, jsonb_encode
from turdb_tpu.storage.files import CorruptFile, _read_buf, _write_buf


def save_hnsw(path: str, tindex) -> None:
    """Persist a database.indexes.HnswTableIndex."""
    tindex.flush_pending()
    idx = tindex.index
    s = idx.state
    os.makedirs(os.path.dirname(path), exist_ok=True)
    meta = {
        "name": tindex.name,
        "column": tindex.column,
        "metric": idx.cfg.metric.value,
        "dim": idx.cfg.dim,
        "m": idx.cfg.m,
        "m0": idx.cfg.m0,
        "max_levels": idx.cfg.max_levels,
        "ef_construction": idx.cfg.ef_construction,
        "ef_search": idx.cfg.ef_search,
        "size": idx.size,
        "capacity": idx.capacity,
        "entry": int(s.entry),
        "max_level": int(s.max_level),
        "sq8": isinstance(s.vectors, Sq8Rows),
        "qbits": (
            16 if isinstance(s.vectors, Sq8Rows)
            and s.vectors.codes.dtype == np.uint16 else 8
        ),
        "rowid_to_slot": [
            [int(r), int(sl)] for r, sl in tindex.rowid_to_slot.items()
        ],
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        hdr = bytearray(FILE_HEADER_SIZE)
        hdr[:16] = MAGIC_HNSW
        struct.pack_into("<I", hdr, 16, FORMAT_VERSION)
        fh.write(bytes(hdr))
        blob = jsonb_encode(meta)
        _write_buf(fh, blob)
        n = idx.size
        if isinstance(s.vectors, Sq8Rows):
            # SQ8 serving stores persist as codes (4x smaller file); the
            # exact norms are re-derivable only from f32, so they ride too
            _write_buf(fh, np.asarray(s.vectors.codes)[:n].tobytes())
            _write_buf(fh, np.asarray(s.vectors.mins)[:n].tobytes())
            _write_buf(fh, np.asarray(s.vectors.scales)[:n].tobytes())
            _write_buf(fh, np.asarray(s.norms)[:n].tobytes())
        else:
            _write_buf(fh, np.asarray(s.vectors)[:n].tobytes())
        _write_buf(fh, np.asarray(s.adj0)[:n].tobytes())
        for a in s.adj_hi:
            _write_buf(fh, np.asarray(a)[:n].tobytes())
        _write_buf(fh, np.asarray(s.levels)[:n].tobytes())
        _write_buf(fh, idx._alive[:n].tobytes())
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def load_hnsw(path: str):
    """Load into a fresh HnswTableIndex; returns it or None if absent."""
    if not os.path.exists(path):
        return None
    import jax.numpy as jnp

    from turdb_tpu.database.indexes import HnswTableIndex
    from turdb_tpu.models.hnsw import init_state
    from turdb_tpu.ops.distance import Metric, prep_norms

    with open(path, "rb") as fh:
        hdr = fh.read(FILE_HEADER_SIZE)
        if len(hdr) != FILE_HEADER_SIZE or hdr[:16] != MAGIC_HNSW:
            raise CorruptFile("bad hnsw magic")
        meta = jsonb_decode(_read_buf(fh))
        n = int(meta["size"])
        dim = int(meta["dim"])
        tindex = HnswTableIndex(
            meta["name"], meta["column"], dim=dim,
            metric=Metric(meta["metric"]), m=int(meta["m"]),
            ef_construction=int(meta["ef_construction"]),
            ef_search=int(meta["ef_search"]),
            sq8=bool(meta.get("sq8", False)),
            qbits=int(meta.get("qbits", 8)),
        )
        idx = tindex.index
        idx._ensure(max(n + 1, 1))
        cfg = idx.cfg
        sq8 = bool(meta.get("sq8", False))
        qbits = int(meta.get("qbits", 8))
        if sq8:
            cdt = np.uint16 if qbits == 16 else np.uint8
            codes = np.frombuffer(_read_buf(fh), cdt).reshape(n, dim)
            mins = np.frombuffer(_read_buf(fh), np.float32)[:n]
            scales = np.frombuffer(_read_buf(fh), np.float32)[:n]
            norms = np.frombuffer(_read_buf(fh), np.float32)[:n]
        else:
            vectors = np.frombuffer(_read_buf(fh), np.float32).reshape(n, dim)
        adj0 = np.frombuffer(_read_buf(fh), np.int32).reshape(n, cfg.m0)
        adj_hi = [
            np.frombuffer(_read_buf(fh), np.int32).reshape(n, cfg.m)
            for _ in range(cfg.max_levels - 1)
        ]
        levels = np.frombuffer(_read_buf(fh), np.int32)[:n]
        alive = np.frombuffer(_read_buf(fh), bool)[:n]

    s = idx.state
    sl = jnp.arange(n)
    if sq8:
        cap = idx.capacity
        cfull = np.zeros((cap, dim), np.uint16 if qbits == 16 else np.uint8)
        cfull[:n] = codes
        mfull = np.zeros(cap, np.float32)
        mfull[:n] = mins
        sfull = np.zeros(cap, np.float32)
        sfull[:n] = scales
        vec_store = Sq8Rows(
            jnp.asarray(cfull), jnp.asarray(mfull), jnp.asarray(sfull)
        )
        norms_full = s.norms.at[sl].set(jnp.asarray(norms))
    else:
        jv = jnp.asarray(vectors)
        vec_store = s.vectors.at[sl].set(jv)
        norms_full = s.norms.at[sl].set(prep_norms(jv))
    idx.state = s._replace(
        vectors=vec_store,
        norms=norms_full,
        adj0=s.adj0.at[sl].set(jnp.asarray(adj0)),
        adj_hi=tuple(
            a.at[sl].set(jnp.asarray(h)) for a, h in zip(s.adj_hi, adj_hi)
        ),
        levels=s.levels.at[sl].set(jnp.asarray(levels)),
        entry=jnp.asarray(meta["entry"], jnp.int32),
        max_level=jnp.asarray(meta["max_level"], jnp.int32),
    )
    idx.size = n
    idx._alive[:n] = alive
    for r, slot in meta["rowid_to_slot"]:
        tindex.rowid_to_slot[int(r)] = int(slot)
    tindex._rebuild_slot_arrays()
    return tindex
