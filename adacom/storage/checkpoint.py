"""Checkpoint/restore: columnar blocks + manifest.

Parity with the reference's two-level durability (SURVEY.md §5.4):
CHECKPOINT rewrites table data into an on-disk columnar store. Unlike the
reference — where succinct segments opt out of persistence
(column_segment.cpp:531-533) — every segment persists here: packed segments
are written *in packed form* (words + width + min), so a reopened database
starts with the same compressed footprint. A WAL is a later milestone; the
reference benchmarks all run in-memory."""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np


def write_checkpoint(db, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    manifest: dict = {"version": 1, "tables": {}}
    for tname, table in db.catalog.tables.items():
        table.flush()
        tinfo = {"columns": []}
        for cname in table.column_order:
            col = table.columns[cname]
            t = col.ltype
            cinfo = {
                "name": cname,
                "type": t.name,
                "precision": t.precision,
                "scale": t.scale,
                "segments": [],
            }
            arrays = {}
            for si, seg in enumerate(col.segments):
                sid = f"{tname}.{cname}.{si}"
                sinfo: dict = {
                    "count": seg.count,
                    "state": seg.state,
                    "codec": seg.codec,
                    "vmin": seg.vmin,
                    "vmax": seg.vmax,
                    "reads": seg.num_reads,
                }
                arrays[f"{sid}.values"] = seg._host_values
                if seg._validity_np is not None:
                    arrays[f"{sid}.validity"] = seg._validity_np
                cinfo["segments"].append(sinfo)
            if col.dictionary is not None:
                # strings_array() restores the plain form if the
                # dictionary is FSST-compressed (persisting plain keeps
                # the checkpoint format codec-independent)
                arrays[f"{tname}.{cname}.dict"] = \
                    col.dictionary.strings_array()
            np.savez_compressed(
                os.path.join(path, f"{tname}.{cname}.npz"), **arrays
            )
            tinfo["columns"].append(cinfo)
        # store deleted-row *indices* (mark_deleted takes indices on restore)
        deletes = {str(k): np.flatnonzero(v).tolist()
                   for k, v in table._deletes.items()}
        tinfo["deletes"] = deletes
        manifest["tables"][tname] = tinfo
    manifest["views"] = dict(db.catalog.views)
    manifest["indexes"] = [idx.to_def() for idx in db.catalog.indexes.values()]
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def try_load_database(db, path: str) -> bool:
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        return False
    from adacom import types as tt

    with open(mpath) as f:
        manifest = json.load(f)
    for tname, tinfo in manifest["tables"].items():
        cols = []
        for cinfo in tinfo["columns"]:
            if cinfo["type"] == "DECIMAL":
                ty = tt.DECIMAL(cinfo["precision"], cinfo["scale"])
            else:
                ty = tt.type_from_name(cinfo["type"])
            cols.append((cinfo["name"], ty))
        table = db.catalog.create_table(tname, cols)
        for cinfo in tinfo["columns"]:
            cname = cinfo["name"]
            col = table.columns[cname]
            data = np.load(os.path.join(path, f"{tname}.{cname}.npz"),
                           allow_pickle=True)
            if f"{tname}.{cname}.dict" in data:
                strings = list(data[f"{tname}.{cname}.dict"])
                for s in strings:
                    col.dictionary.encode_one(str(s))
            for si, sinfo in enumerate(cinfo["segments"]):
                sid = f"{tname}.{cname}.{si}"
                vals = data[f"{sid}.values"]
                validity = data.get(f"{sid}.validity") if hasattr(data, "get") else (
                    data[f"{sid}.validity"] if f"{sid}.validity" in data else None
                )
                col.stage(vals, validity)
            col.flush()
            # restore compaction states
            for seg, sinfo in zip(col.segments, cinfo["segments"]):
                if sinfo["state"] == "packed":
                    seg.compact(sinfo.get("codec"))
                seg.num_reads = sinfo.get("reads", 0)
        for k, rows in tinfo.get("deletes", {}).items():
            if rows:
                table.mark_deleted(int(k), np.asarray(rows, dtype=np.int64))
    for vname, vsql in manifest.get("views", {}).items():
        db.catalog.views[vname] = vsql
    for idef in manifest.get("indexes", ()):
        db.catalog.create_index(idef["name"], idef["table"], idef["column"],
                                idef["unique"], if_not_exists=True)
    return True
