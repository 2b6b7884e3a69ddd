"""End-to-end quickstart: SQL + vector search through the public API.

Usage:  python examples/quickstart.py   (uses the GPU when JAX finds one;
        JAX_PLATFORMS=cpu keeps it on the CPU)
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np

from turdb_tpu import connect


def main():
    db = connect(tempfile.mkdtemp() + "/quickstart")

    db.execute("""
        CREATE TABLE docs (
            id BIGINT PRIMARY KEY AUTO_INCREMENT,
            body TEXT NOT NULL,
            emb VECTOR(64)
        )
    """)

    rng = np.random.default_rng(0)
    ins = db.prepare("INSERT INTO docs (body, emb) VALUES ($1, $2)")
    for i in range(2000):
        vec = rng.standard_normal(64).astype(np.float32)
        ins.execute([f"document {i}", "[" + ",".join(f"{x:.4f}" for x in vec) + "]"])

    db.execute("CREATE INDEX docs_ann ON docs USING IVF (emb)")

    q = rng.standard_normal(64).astype(np.float32)
    qtxt = "[" + ",".join(f"{x:.4f}" for x in q) + "]"
    rows = db.query(
        f"SELECT id, body, emb <-> '{qtxt}' AS dist FROM docs "
        f"ORDER BY dist LIMIT 5"
    )
    print("nearest 5:")
    for r in rows:
        print(f"  id={r[0]:<6} {r[1]:<16} dist={r[2]:.3f}")

    print("\nEXPLAIN shows the ANN path:")
    for (line,) in db.execute(
        f"EXPLAIN SELECT id FROM docs ORDER BY emb <-> '{qtxt}' LIMIT 5"
    ).rows:
        print(" ", line)

    db.close()


if __name__ == "__main__":
    main()
