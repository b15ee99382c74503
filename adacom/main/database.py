"""Database instance (reference DuckDB/DatabaseInstance, src/main/database.cpp):
owns config, buffer manager, catalog, plan cache, profiler, WAL.

Durability (reference SingleFileStorageManager + WAL, SURVEY.md §5.4): a
durable database is a directory holding versioned checkpoint subdirectories
published through a ``CURRENT`` pointer file (so an aborted checkpoint can
never corrupt the previous one — the reference's double-buffered database
header, single_file_block_manager.cpp) plus ``wal.log`` replayed on open."""

from __future__ import annotations

import os
import shutil
import threading
from typing import Optional

from adacom.config import DBConfig
from adacom.catalog.catalog import Catalog
from adacom.storage.buffer import BufferManager


class CheckpointAbort(Exception):
    """Injected mid-checkpoint failure (reference PRAGMA
    debug_checkpoint_abort, test/sql/storage/checkpoint_abort*)."""


class Database:
    def __init__(self, path: Optional[str] = None, config: Optional[DBConfig] = None,
                 mesh=None):
        # path: checkpoint directory for persistence (None = in-memory,
        # like the reference's :memory: mode used by all succinct benchmarks)
        # mesh: a jax.sharding.Mesh — when set, eligible scan-aggregates
        # shard segment pools over the mesh's segment axis (shard_map +
        # psum/pmin/pmax) and large equi-joins shuffle over all_to_all;
        # the layer the reference lacks entirely (SURVEY.md §5.8)
        self.path = path
        self.mesh = mesh
        # counters of distributed-operator executions (observability +
        # the dryrun asserts the distributed path actually ran)
        self.dist_stats = {"scan_agg": 0, "join": 0, "topk": 0}
        self.config = config or DBConfig()
        self.buffer_manager = BufferManager(self.config)
        self.catalog = Catalog(self.config, self.buffer_manager)
        # plan cache: template key -> (statements, bound plan, meta)
        self.plan_cache: dict = {}
        self.plan_cache_lock = threading.Lock()
        # template -> structural slot set learned at first bind (binder-baked
        # literals widen the plan-cache key; remembering the widened set per
        # template lets later lookups build the FULL key up front instead of
        # rebinding every execution)
        self.template_slots: dict = {}
        # raw SQL text -> parse() output (hot repeated lookups skip parsing)
        self.parse_cache: dict = {}
        self._closed = False
        self.wal = None
        self._ckpt_seq = 0
        if path is not None:
            from adacom.storage import wal as walmod
            from adacom.storage.checkpoint import try_load_database

            os.makedirs(path, exist_ok=True)
            current = self._read_current()
            if current is not None:
                self._ckpt_seq = int(current.rsplit("-", 1)[-1])
                try_load_database(self, os.path.join(path, current))
            else:
                # legacy layout: manifest directly in the directory
                try_load_database(self, path)
            walmod.replay(self, os.path.join(path, "wal.log"))
            self.wal = walmod.WriteAheadLog(os.path.join(path, "wal.log"))
            self.catalog.attach_wal(self.wal)

    def _read_current(self) -> Optional[str]:
        cur = os.path.join(self.path, "CURRENT")
        if not os.path.exists(cur):
            return None
        with open(cur) as f:
            name = f.read().strip()
        return name or None

    def connect(self) -> "Connection":
        from adacom.main.connection import Connection

        return Connection(self)

    def cursor(self) -> "Connection":
        return self.connect()

    def checkpoint(self) -> None:
        """Write a full checkpoint, publish it atomically, truncate the WAL
        (reference SingleFileStorageManager::CreateCheckpoint,
        storage_manager.cpp:208)."""
        if self.path is None:
            return
        from adacom.storage.checkpoint import write_checkpoint

        old = self._read_current()
        self._ckpt_seq += 1
        name = f"ckpt-{self._ckpt_seq}"
        ckpt_dir = os.path.join(self.path, name)
        write_checkpoint(self, ckpt_dir)
        if getattr(self.config, "checkpoint_abort", "none") == "before_header":
            # data written but CURRENT not updated: a reopen must recover
            # from the previous checkpoint + the untouched WAL
            raise CheckpointAbort("injected abort before header update")
        tmp = os.path.join(self.path, "CURRENT.tmp")
        with open(tmp, "w") as f:
            f.write(name)
        os.replace(tmp, os.path.join(self.path, "CURRENT"))
        if self.wal is not None:
            self.wal.truncate()
        if old and old != name:
            shutil.rmtree(os.path.join(self.path, old), ignore_errors=True)

    def maybe_autocheckpoint(self) -> None:
        """Checkpoint when the WAL passes the size threshold (reference
        checkpoint-on-WAL-threshold, storage_manager.cpp)."""
        if self.wal is None or self.config.wal_autocheckpoint is None:
            return
        if self.wal.size() >= self.config.wal_autocheckpoint:
            self.checkpoint()

    def close(self) -> None:
        if self._closed:
            return
        if self.path is not None:
            try:
                self.checkpoint()
            except CheckpointAbort:
                pass
            if self.wal is not None:
                self.wal.close()
        self.catalog.shutdown()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
