"""adacom — a vectorized query-execution engine on JAX with adaptive
succinct compression.

Built from scratch in JAX/XLA (fused XLA kernels, shard_map for
multi-device) with the capability envelope of the reference engine
(leonwind/duckdb-adaptive-compression, the "AdaCom" EDBT'24 fork of DuckDB):

- columnar storage in device-resident segments with zonemaps and validity masks
  (reference: src/storage/table/column_segment.cpp)
- a succinct frame-of-reference bit-packing codec whose decode is fused into
  scans (reference: src/storage/compression/succinct.cpp)
- a segment-access catalog with a background adaptive compaction policy
  (reference: src/catalog/catalog_entry/column_segment_catalog.cpp)
- a SQL surface: parser -> binder -> optimizer -> physical plan -> pipelined
  jitted execution (reference: src/parser, src/planner, src/optimizer,
  src/execution)
- filter / hash aggregate / hash join / sort / top-k operators as vectorized
  XLA kernels and native host code (reference: src/execution/operator/**)
- multi-device scale-out over a jax.sharding.Mesh with all-to-all shuffles
  (new layer; the reference is single-host).

Public API mirrors the reference's client layer (src/main/connection.cpp):

    import adacom as at
    db = at.Database()                # in-memory database
    con = db.connect()
    con.query("CREATE TABLE t(i UINTEGER)")
    app = con.appender("t")
    app.append_column("i", values)    # bulk columnar ingest
    app.close()
    res = con.query("SELECT i FROM t WHERE i = 42")
    res.fetchall()
"""

from adacom.config import DBConfig

__version__ = "0.1.0"

__all__ = ["Database", "Connection", "DBConfig", "__version__"]


def __getattr__(name):
    # Lazy imports keep `import adacom` light (no jax trace-time work)
    # and avoid import cycles during package bring-up.
    if name == "Database":
        from adacom.main.database import Database

        return Database
    if name == "Connection":
        from adacom.main.connection import Connection

        return Connection
    raise AttributeError(name)
