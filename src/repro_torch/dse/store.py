"""Persistent campaign results: streaming append-only JSONL stores.

One line per finished campaign cell, keyed on the cell key (what was
searched) and stamped with the RAV hash (what was found). Appending after
every cell makes a killed campaign resumable from its last completed cell;
loading keys-last-wins makes re-runs and store concatenation safe. The
format is deliberately plain JSONL so stores diff, grep, and feed
``jq``/pandas without a reader.

Two on-disk layouts share one reader (:class:`CampaignStore`):

* **v1 — single file** (``<store>.jsonl``): the original PR-1 format.
  Unchanged on disk; old stores load, resume, and append byte-for-byte
  as before.
* **v2 — sharded directory** (``<store>.d/`` holding a ``manifest.json``
  plus ``shard-*.jsonl`` files): the million-cell layout. Each writer
  appends to ITS OWN shard (no lock contention between campaign hosts);
  readers merge all shards keys-last-wins in sorted shard order. Opt in
  with :func:`open_store`'s ``layout="sharded"`` or by pointing any
  store consumer at the directory — ``auto`` detection does the rest.

The reader is *streaming*: loading builds only a key -> (shard, byte
offset) index, so memory stays O(cells), not O(records);
:meth:`CampaignStore.iter_records` replays records one at a time in
first-appearance key order (exactly the order the old dict-materializing
loader produced) and :meth:`CampaignStore.get` seeks one line.

Maintenance CLI (also ``python -m repro.dse.store``)::

    python -m repro.dse.store info    results/dse.jsonl
    python -m repro.dse.store compact results/dse.jsonl     # last-wins rewrite
    python -m repro.dse.store migrate results/dse.jsonl results/dse.d

:class:`ResultStore` remains as a thin compatibility alias whose
``.records()`` (the list-materializing call) emits a
``DeprecationWarning`` — new code iterates ``iter_records()``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import warnings
from pathlib import Path
from typing import Iterator

from repro_torch.core.local_opt import RAV
from repro_torch.obs import NULL

#: Per-record schema version (the ``schema`` field on each record).
SCHEMA_VERSION = 1
#: Sharded-directory format version (the manifest's ``store_format``).
STORE_FORMAT_VERSION = 2
MANIFEST_NAME = "manifest.json"
_SHARD_RE = re.compile(r"^shard-[A-Za-z0-9_.-]+\.jsonl$")


def record_status(rec) -> str:
    """A record's lifecycle status: ``"ok"`` for normal result records
    (including every pre-resilience record — they carry no ``status``
    field), ``"failed"`` for quarantined cells
    (:func:`repro.dse.resilience.quarantine_record`), ``"missing"`` for
    ``None``. Every frontier/report/placement consumer gates on this so
    failed records never masquerade as results."""
    if rec is None:
        return "missing"
    return rec.get("status", "ok")


def is_ok(rec) -> bool:
    """True for a normal result record (see :func:`record_status`)."""
    return rec is not None and rec.get("status", "ok") == "ok"


def rav_hash(rav: RAV) -> str:
    """Stable short hash of an RAV (fractions rounded to the PSO's cache
    resolution, so re-discovered designs hash identically)."""
    t = rav.as_tuple()
    canon = (t[0], t[1], round(t[2], 2), round(t[3], 2), round(t[4], 2))
    return hashlib.sha256(repr(canon).encode()).hexdigest()[:12]


def shard_name(shard: int | str) -> str:
    """Normalize a shard id to its file name (``7`` -> ``shard-007.jsonl``,
    ``"worker-a"`` -> ``shard-worker-a.jsonl``)."""
    if isinstance(shard, int):
        return f"shard-{shard:03d}.jsonl"
    name = str(shard)
    if not name.startswith("shard-"):
        name = f"shard-{name}"
    if not name.endswith(".jsonl"):
        name += ".jsonl"
    if not _SHARD_RE.match(name):
        raise ValueError(f"bad shard name {name!r}")
    return name


def sharded_dir_for(path: str | os.PathLike) -> Path:
    """Where the sharded twin of ``path`` lives: the path itself when it
    already names a ``*.d`` directory, else ``<path>.d``."""
    p = Path(path)
    return p if p.suffix == ".d" else Path(str(p) + ".d")


def open_store(path: "str | os.PathLike | CampaignStore", *,
               layout: str = "auto", shard: int | str = 0,
               tracer=NULL) -> "CampaignStore":
    """Open (or create) a campaign store.

    ``layout="auto"`` (default) keeps byte compatibility: an existing
    ``*.d`` directory (or a ``<path>.d`` sibling of the given path)
    opens sharded, anything else opens as a v1 single file — including
    fresh paths, so old workflows create exactly the files they always
    did. ``layout="v1"`` / ``layout="sharded"`` force a layout; ``shard``
    names the shard THIS writer appends to (sharded layout only).
    """
    if isinstance(path, CampaignStore):
        return path
    return CampaignStore(path, tracer=tracer, layout=layout, shard=shard)


class CampaignStore:
    """Streaming dict-like view over one JSONL store (either layout).

    Loading is corruption-aware, per file: a torn FINAL line is the
    expected leftover of a killed run and is dropped silently, but an
    undecodable line anywhere else means real damage (truncation
    mid-file, a bad concatenation, disk trouble) and is surfaced —
    counted on :attr:`corrupt_lines`, warned about, and reported to
    ``tracer`` as the ``store.corrupt_lines`` obs counter.
    :attr:`skipped_lines` counts every dropped line including torn
    tails. Re-``put`` of a byte-identical record is skipped and counted
    on :attr:`noop_puts` (the ``store.noop_puts`` obs counter) so
    long-resumed stores stop accreting duplicate lines.
    """

    def __init__(self, path: str | os.PathLike, tracer=NULL, *,
                 layout: str = "auto", shard: int | str = 0):
        self.path = Path(path)
        self.tracer = tracer
        #: key -> (file index, byte offset, line length, backend name).
        self._index: dict[str, tuple[int, int, int, str]] = {}
        self._files: list[Path] = []
        #: Undecodable lines dropped on load (torn final lines included).
        self.skipped_lines = 0
        #: Undecodable NON-final lines — real corruption, never the
        #: benign torn tail of a killed run.
        self.corrupt_lines = 0
        #: Puts skipped because the stored record was already identical.
        self.noop_puts = 0
        self._resolve_layout(layout, shard)
        self._load()

    # -- layout -----------------------------------------------------------

    def _resolve_layout(self, layout: str, shard: int | str) -> None:
        p = self.path
        if layout == "auto":
            alt = sharded_dir_for(p)
            if p.is_dir() or p.suffix == ".d":
                layout = "sharded"
            elif alt != p and alt.is_dir():
                layout, p = "sharded", alt
            else:
                layout = "v1"
        if layout in ("v1", "file", "jsonl"):
            self.sharded = False
            self._files = [p]
            self._append_to = 0
            return
        if layout not in ("sharded", "v2"):
            raise ValueError(f"unknown store layout {layout!r}; "
                             f"use 'auto', 'v1', or 'sharded'")
        self.sharded = True
        self.dir = sharded_dir_for(p)
        self.dir.mkdir(parents=True, exist_ok=True)
        manifest = self.dir / MANIFEST_NAME
        if manifest.exists():
            meta = json.loads(manifest.read_text())
            fmt = meta.get("store_format")
            if fmt != STORE_FORMAT_VERSION:
                raise ValueError(
                    f"store {self.dir}: unsupported store_format {fmt!r} "
                    f"(this reader speaks {STORE_FORMAT_VERSION})")
        else:
            manifest.write_text(json.dumps(
                {"store_format": STORE_FORMAT_VERSION,
                 "schema": SCHEMA_VERSION}, sort_keys=True) + "\n")
        self._files = sorted(f for f in self.dir.glob("shard-*.jsonl")
                             if _SHARD_RE.match(f.name))
        own = self.dir / shard_name(shard)
        if own not in self._files:
            self._files.append(own)
        self._append_to = self._files.index(own)

    # -- loading ----------------------------------------------------------

    def _load(self) -> None:
        for fi, fpath in enumerate(self._files):
            if fpath.exists():
                self._scan_file(fi, fpath)
        if self.corrupt_lines:
            self.tracer.count("store.corrupt_lines", self.corrupt_lines,
                              store=str(self.path))
            warnings.warn(
                f"store {self.path}: skipped {self.corrupt_lines} corrupt "
                f"non-final line(s) — the file is damaged beyond a torn "
                f"final append; affected cells will re-run",
                RuntimeWarning, stacklevel=4)

    def _scan_file(self, fi: int, fpath: Path) -> None:
        """Index one JSONL file: byte offset + length per current record,
        one line in memory at a time."""
        bad: list[int] = []       # line numbers of undecodable lines
        last_nonblank = -1
        lineno = -1
        offset = 0
        with fpath.open("rb") as f:
            for raw in f:
                lineno += 1
                line = raw.strip()
                if line:
                    last_nonblank = lineno
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        bad.append(lineno)
                    else:
                        key = rec.get("cell_key")
                        if key:
                            self._index[key] = (
                                fi, offset, len(raw),
                                rec.get("backend", "fpga"))
                offset += len(raw)
        self.skipped_lines += len(bad)
        self.corrupt_lines += sum(1 for b in bad if b != last_nonblank)

    # -- the CampaignStore protocol ---------------------------------------

    def _read_line(self, loc: tuple[int, int, int, str]) -> bytes:
        fi, off, length, _ = loc
        with self._files[fi].open("rb") as f:
            f.seek(off)
            return f.read(length)

    def get(self, cell_key: str) -> dict | None:
        loc = self._index.get(cell_key)
        if loc is None:
            return None
        return json.loads(self._read_line(loc))

    def put(self, record: dict) -> None:
        """Append one record and flush, so a kill right after still leaves
        the cell on disk. A record byte-identical to the stored one under
        the same key is a counted no-op (resume-churn protection)."""
        key = record["cell_key"]
        data = (json.dumps(record, sort_keys=True) + "\n").encode()
        loc = self._index.get(key)
        if loc is not None and self._read_line(loc).rstrip(b"\n") == \
                data.rstrip(b"\n"):
            self.noop_puts += 1
            self.tracer.count("store.noop_puts", store=str(self.path))
            return
        fpath = self._files[self._append_to]
        fpath.parent.mkdir(parents=True, exist_ok=True)
        with fpath.open("ab") as f:
            f.seek(0, os.SEEK_END)
            if f.tell() and not self._ends_with_newline(fpath, f):
                # healing append after a torn final line: never glue the
                # new record onto the damaged tail
                f.write(b"\n")
            off = f.tell()
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        self._index[key] = (self._append_to, off, len(data),
                            record.get("backend", "fpga"))

    @staticmethod
    def _ends_with_newline(fpath: Path, f) -> bool:
        end = f.tell()
        with fpath.open("rb") as r:
            r.seek(end - 1)
            return r.read(1) == b"\n"

    def iter_records(self, backend: str | None = None) -> Iterator[dict]:
        """Stream current records (last version per key) in
        first-appearance key order, one line in memory at a time.
        ``backend`` filters to one backend's records; legacy (PR-1)
        records carry no ``backend`` field and count as ``"fpga"``."""
        handles: dict[int, object] = {}
        try:
            for fi, off, length, bk in self._index.values():
                if backend is not None and bk != backend:
                    continue
                fh = handles.get(fi)
                if fh is None:
                    fh = handles[fi] = self._files[fi].open("rb")
                fh.seek(off)
                yield json.loads(fh.read(length))
        finally:
            for fh in handles.values():
                fh.close()

    def keys(self) -> Iterator[str]:
        return iter(self._index)

    def __contains__(self, cell_key: str) -> bool:
        return cell_key in self._index

    def __len__(self) -> int:
        return len(self._index)

    def __iter__(self) -> Iterator[dict]:
        return self.iter_records()

    def backends(self) -> list[str]:
        """Backend names present in the store, sorted."""
        return sorted({bk for _, _, _, bk in self._index.values()})

    def frontier_index(self, backend: str | None = None):
        """One streaming pass -> the incremental Pareto frontier
        (:class:`repro.dse.frontier.FrontierIndex`) over the feasible
        records' canonical objective vectors, keyed by cell key with the
        full record as each front member's payload.

        Canonical vectors are backend-specific, so a mixed store must
        pick one ``backend`` (cross-family comparison goes through the
        normalized schema in :mod:`repro.dse.report` instead).
        """
        from .backends import get_backend
        from .frontier import FrontierIndex
        names = self.backends() if backend is None else [backend]
        if len(names) > 1:
            raise ValueError(
                f"store mixes backends {names}; pass backend=... (their "
                f"canonical objective vectors are not comparable)")
        fi = FrontierIndex()
        be = get_backend(names[0]) if names else None
        for rec in self.iter_records(backend):
            if is_ok(rec) and rec.get("objectives", {}).get("feasible"):
                fi.insert(rec["cell_key"], be.canonical(rec["objectives"]),
                          payload=rec)
        return fi

    # -- maintenance ------------------------------------------------------

    def compact(self) -> int:
        """Last-wins rewrite: drop superseded/undecodable lines, keeping
        current records in first-appearance key order (v1: rewrite the
        file; sharded: collapse every shard into this writer's shard).
        Atomic (write-temp-then-rename) and idempotent — compacting a
        compacted store is a byte no-op. Returns the record count."""
        target = self._files[self._append_to]
        tmp = target.with_suffix(target.suffix + ".tmp")
        n = 0
        with tmp.open("wb") as f:
            for loc in self._index.values():
                f.write(self._read_line(loc).rstrip(b"\n") + b"\n")
                n += 1
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
        for fi, fpath in enumerate(self._files):
            if fi != self._append_to and fpath.exists():
                fpath.unlink()
        # reopen against the rewritten layout
        self._files = [target]
        self._append_to = 0
        self._index.clear()
        self.skipped_lines = self.corrupt_lines = 0
        self._scan_file(0, target)
        return n


class ResultStore(CampaignStore):
    """PR-1 compatibility alias of :class:`CampaignStore`.

    The one behavioral difference is :meth:`records`, the historical
    materialize-everything call: it still works but emits a
    ``DeprecationWarning`` — stream :meth:`CampaignStore.iter_records`
    instead.
    """

    def records(self, backend: str | None = None) -> list[dict]:
        """All records as a list (deprecated — this materializes the
        whole store; iterate :meth:`iter_records` instead)."""
        warnings.warn(
            "ResultStore.records() materializes every record; iterate "
            "iter_records() instead (streaming, same order)",
            DeprecationWarning, stacklevel=2)
        return list(self.iter_records(backend))


# ---------------------------------------------------------------------------
# maintenance CLI
# ---------------------------------------------------------------------------


def _bulk_copy(src: CampaignStore, dst: CampaignStore) -> int:
    """Stream every current record of ``src`` into ``dst`` (no per-line
    fsync: one flush+fsync at the end of the append file)."""
    fpath = dst._files[dst._append_to]
    fpath.parent.mkdir(parents=True, exist_ok=True)
    n = 0
    with fpath.open("ab") as f:
        f.seek(0, os.SEEK_END)
        for key, loc in src._index.items():
            data = src._read_line(loc).rstrip(b"\n") + b"\n"
            off = f.tell()
            f.write(data)
            n += 1
            dst._index[key] = (dst._append_to, off, len(data), loc[3])
        f.flush()
        os.fsync(f.fileno())
    return n


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro.dse.store",
        description="Maintain campaign JSONL stores: inspect, last-wins "
                    "compact, migrate between the single-file (v1) and "
                    "sharded (v2) layouts.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_info = sub.add_parser("info", help="layout, shard, and record counts")
    p_info.add_argument("store")

    p_compact = sub.add_parser(
        "compact", help="last-wins rewrite (drops superseded and "
                        "undecodable lines; atomic and idempotent)")
    p_compact.add_argument("store")

    p_mig = sub.add_parser(
        "migrate", help="copy a store's current records into another "
                        "layout (dst ending in .d -> sharded, else v1)")
    p_mig.add_argument("src")
    p_mig.add_argument("dst")
    p_mig.add_argument("--shard", default="0",
                       help="destination shard id (sharded dst only)")
    args = ap.parse_args(argv)

    if args.cmd == "info":
        s = open_store(args.store)
        kind = (f"sharded ({len(s._files)} shard(s) in {s.dir})"
                if s.sharded else "v1 single file")
        per_be = {b: sum(1 for loc in s._index.values() if loc[3] == b)
                  for b in s.backends()}
        failed = sum(1 for rec in s.iter_records() if not is_ok(rec))
        print(f"{args.store}: {kind}")
        print(f"  records: {len(s)}  backends: "
              + (", ".join(f"{b}={n}" for b, n in per_be.items()) or "-"))
        print(f"  skipped lines: {s.skipped_lines} "
              f"(corrupt: {s.corrupt_lines})")
        if failed:
            print(f"  quarantined: {failed} failed record(s) — resume "
                  f"with --retry-failed to re-run them")
        if s.sharded:
            for f in s._files:
                size = f.stat().st_size if f.exists() else 0
                print(f"  {f.name}: {size} bytes")
        return 0

    if args.cmd == "compact":
        s = open_store(args.store)
        before = sum(f.stat().st_size for f in s._files if f.exists())
        n = s.compact()
        after = sum(f.stat().st_size for f in s._files if f.exists())
        print(f"compacted {args.store}: {n} records, "
              f"{before} -> {after} bytes")
        return 0

    if args.cmd == "migrate":
        src = open_store(args.src)
        dst_layout = ("sharded" if Path(args.dst).suffix == ".d"
                      or Path(args.dst).is_dir() else "v1")
        shard = (int(args.shard) if str(args.shard).isdigit()
                 else args.shard)
        dst = open_store(args.dst, layout=dst_layout, shard=shard)
        n = _bulk_copy(src, dst)
        print(f"migrated {args.src} -> {args.dst} "
              f"({dst_layout}): {n} records")
        return 0

    return 2  # pragma: no cover - argparse enforces the subcommand


if __name__ == "__main__":
    raise SystemExit(main())
