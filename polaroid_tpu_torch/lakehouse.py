"""Lakehouse: versioned ACID table store with time travel, auth, audit.

The port of the JAX package's `lakehouse.py`: parquet data files plus a
JSON commit log per table (a minimal Delta-style transaction log), with
stdlib scrypt password hashing and HMAC-signed tokens. Tables are read
onto the store's device (`LakeStore(root, device=...)`, CUDA unless the
caller asks for the CPU); a frame is written from wherever it lives
(`to_arrow` compacts it on its device first). pyarrow is imported where
Parquet is read or written.

Two rules the JAX package's store does not keep:
* a commit creates its log file exclusively (`os.link` of a temporary
  file with a name of its own), so two writers never take one version:
  an append or a blind write that finds its version taken retries at the
  next one, and a rewrite of the current snapshot (`delete_where`,
  `compact`) reads the snapshot again and redoes its work. Every commit
  that returned a version is read back.
* `vacuum` keeps every log entry from the last snapshot-replacing entry
  at or before the window it keeps, so the kept versions replay to the
  same files, and it removes only files that some log entry named.
And the audit log records one entry at a time, so that concurrent
appends through a `Lakehouse` keep one hash chain.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import secrets
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from .batch import resolve_device
from .errors import ComputeError, NoDataError

# the actions whose files replace the table's whole file set
_REPLACES = ("overwrite", "delete_where", "compact", "drop")

# ---------------------------------------------------------------------------
# versioned table store
# ---------------------------------------------------------------------------


class LakeStore:
    """Append-only versioned tables: every commit is a parquet file + a
    log entry `_log/<version>.json`; readers resolve the file set for a
    version by replaying the log (time travel = replay up to ts)."""

    def __init__(self, root: str, device=None):
        self.device = resolve_device(device)
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _tdir(self, table: str) -> Path:
        p = self.root / table
        (p / "_log").mkdir(parents=True, exist_ok=True)
        return p

    def _versions(self, table: str) -> List[int]:
        logdir = self._tdir(table) / "_log"
        return sorted(int(f.stem) for f in logdir.glob("*.json"))

    def _read_log(self, table: str, version: int) -> dict:
        with open(self._tdir(table) / "_log" / f"{version:012d}.json") as f:
            return json.load(f)

    def _try_commit(self, table: str, v: int, action: str, files: List[str],
                    meta: Optional[dict]) -> bool:
        """Write log entry `v`, unless another commit took `v` first."""
        entry = {"version": v, "timestamp": time.time(), "action": action,
                 "files": files, "meta": meta or {}}
        logdir = self._tdir(table) / "_log"
        tmp = logdir / f".{v:012d}.{secrets.token_hex(8)}.tmp"
        with open(tmp, "w") as f:
            json.dump(entry, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            # the ACID boundary: the version's file appears whole, once
            os.link(tmp, logdir / f"{v:012d}.json")
            return True
        except FileExistsError:
            return False
        finally:
            tmp.unlink()

    def _commit(self, table: str, action: str, files: List[str],
                meta: Optional[dict] = None) -> int:
        """Commit at the next free version (an append or a blind write:
        its entry does not depend on the versions before it)."""
        while True:
            versions = self._versions(table)
            v = (versions[-1] + 1) if versions else 0
            if self._try_commit(table, v, action, files, meta):
                return v

    def _new_file(self, table: str, df) -> str:
        name = f"part-{secrets.token_hex(8)}.parquet"
        df.write_parquet(self._tdir(table) / name)
        return name

    def _rewrite(self, table: str, action: str, fn) -> int:
        """Commit `fn(snapshot)` as the table's next version, with the
        snapshot it was made from: if another commit comes first, read
        again and redo."""
        while True:
            v = self.version(table)
            df, meta = fn(self.read_version(table, v))
            name = self._new_file(table, df)
            if self._try_commit(table, v + 1, action, [name], meta):
                return v + 1
            (self._tdir(table) / name).unlink()

    def _active_files(self, table: str,
                      upto_version: Optional[int] = None,
                      upto_ts: Optional[float] = None) -> List[str]:
        files: List[str] = []
        for v in self._versions(table):
            e = self._read_log(table, v)
            if upto_version is not None and e["version"] > upto_version:
                break
            if upto_ts is not None and e["timestamp"] > upto_ts:
                break
            if e["action"] in ("overwrite", "delete_where", "compact"):
                files = list(e["files"])
            elif e["action"] == "append":
                files.extend(e["files"])
            elif e["action"] == "drop":
                files = []
        return files

    # --- writes ---------------------------------------------------------
    def append(self, table: str, df) -> int:
        name = self._new_file(table, df)
        return self._commit(table, "append", [name], {"rows": df.height})

    def overwrite(self, table: str, df) -> int:
        name = self._new_file(table, df)
        return self._commit(table, "overwrite", [name], {"rows": df.height})

    def drop(self, table: str) -> int:
        return self._commit(table, "drop", [])

    def delete_where(self, table: str, predicate) -> int:
        """GDPR-style hard delete: rewrite current snapshot without the
        matching rows (the filter runs on the store's device)."""
        def without(df):
            kept = df.filter(~predicate)
            return kept, {"rows": kept.height}
        return self._rewrite(table, "delete_where", without)

    # --- reads ----------------------------------------------------------
    def _read_files(self, table: str, files: List[str]):
        from .api.functions import concat
        from .api.io import read_parquet
        if not files:
            raise NoDataError(f"table {table!r} is empty or missing")
        tdir = self._tdir(table)
        frames = [read_parquet(str(tdir / f), device=self.device)
                  for f in files]
        return frames[0] if len(frames) == 1 else concat(frames)

    def read(self, table: str):
        return self._read_files(table, self._active_files(table))

    def read_version(self, table: str, version: int):
        return self._read_files(table,
                                self._active_files(table,
                                                   upto_version=version))

    def read_timestamp(self, table: str, ts: float):
        return self._read_files(table, self._active_files(table, upto_ts=ts))

    def scan(self, table: str):
        from .api.io import scan_parquet
        files = self._active_files(table)
        if not files:
            raise NoDataError(f"table {table!r} is empty or missing")
        tdir = self._tdir(table)
        if len(files) == 1:
            return scan_parquet(str(tdir / files[0]), device=self.device)
        return scan_parquet([str(tdir / f) for f in files],
                            device=self.device)

    # --- introspection --------------------------------------------------
    def tables(self) -> List[str]:
        return sorted(p.name for p in self.root.iterdir()
                      if p.is_dir() and (p / "_log").exists())

    def history(self, table: str) -> List[dict]:
        return [self._read_log(table, v) for v in self._versions(table)]

    def version(self, table: str) -> int:
        vs = self._versions(table)
        if not vs:
            raise NoDataError(f"table {table!r} not found")
        return vs[-1]

    # --- maintenance ----------------------------------------------------
    def compact(self, table: str, sort_by: Optional[List[str]] = None) -> int:
        """Merge active files into one (optionally sorted — the Z-order
        analogue: clustering by sort keys improves scan pruning)."""
        def merged(df):
            if sort_by:
                df = df.sort(sort_by)
            return df, {"rows": df.height, "sorted_by": sort_by or []}
        return self._rewrite(table, "compact", merged)

    def vacuum(self, table: str, keep_versions: int = 1) -> int:
        """Delete data files unreferenced by the latest `keep_versions`
        commits; truncates time travel past them. The log keeps every
        entry from the last snapshot-replacing one at or before the first
        kept version (from version 0 where there is none), so the kept
        versions read every row they held; a file no log entry names (an
        append not yet committed) is left alone."""
        versions = self._versions(table)
        keep = versions[-keep_versions:] if keep_versions else versions
        entries = {v: self._read_log(table, v) for v in versions}
        first = keep[0] if keep else (versions[-1] + 1 if versions else 0)
        start = 0
        for v in versions:
            if v <= first and entries[v]["action"] in _REPLACES:
                start = v
        logged = set()
        for e in entries.values():
            logged.update(e["files"])
        needed = set()
        for v in keep:
            needed.update(self._active_files(table, upto_version=v))
        tdir = self._tdir(table)
        removed = 0
        for p in tdir.glob("part-*.parquet"):
            if p.name in logged and p.name not in needed:
                p.unlink()
                removed += 1
        for v in versions:
            if v < start:
                (tdir / "_log" / f"{v:012d}.json").unlink()
        return removed


# ---------------------------------------------------------------------------
# auth (scrypt password hashes, HMAC-signed tokens)
# ---------------------------------------------------------------------------


class AuthManager:
    def __init__(self, secret: Optional[bytes] = None,
                 token_ttl_s: float = 3600.0):
        self._users: Dict[str, dict] = {}
        self._secret = secret or secrets.token_bytes(32)
        self._ttl = token_ttl_s

    def create_user(self, username: str, password: str,
                    role: str = "reader") -> None:
        if username in self._users:
            raise ComputeError(f"user {username!r} exists")
        salt = secrets.token_bytes(16)
        h = hashlib.scrypt(password.encode(), salt=salt, n=2 ** 14, r=8, p=1)
        self._users[username] = {"salt": salt, "hash": h, "role": role}

    def authenticate(self, username: str, password: str) -> Optional[str]:
        u = self._users.get(username)
        if u is None:
            return None
        h = hashlib.scrypt(password.encode(), salt=u["salt"], n=2 ** 14,
                           r=8, p=1)
        if not hmac.compare_digest(h, u["hash"]):
            return None
        return self._issue(username, u["role"])

    def _issue(self, username: str, role: str) -> str:
        payload = json.dumps({"sub": username, "role": role,
                              "exp": time.time() + self._ttl})
        body = payload.encode().hex()
        sig = hmac.new(self._secret, body.encode(), hashlib.sha256).hexdigest()
        return f"{body}.{sig}"

    def verify(self, token: str) -> Optional[dict]:
        try:
            body, sig = token.split(".", 1)
        except ValueError:
            return None
        want = hmac.new(self._secret, body.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(sig, want):
            return None
        payload = json.loads(bytes.fromhex(body))
        if payload["exp"] < time.time():
            return None
        return payload

    def authorize(self, token: str, action: str) -> bool:
        p = self.verify(token)
        if p is None:
            return False
        role = p.get("role", "reader")
        if role == "admin":
            return True
        if role == "writer":
            return action in ("read", "write")
        return action == "read"


# ---------------------------------------------------------------------------
# audit (append-only, hash-chained)
# ---------------------------------------------------------------------------


class AuditLog:
    """Append-only, each entry chained to the one before by its hash;
    entries are recorded one at a time (concurrent writers of a
    `Lakehouse` keep one chain)."""

    def __init__(self, path: str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._last_hash = "0" * 64
        self._lock = threading.Lock()
        if self.path.exists():
            for e in self.entries():
                self._last_hash = e["hash"]

    def record(self, user: str, action: str, table: str,
               detail: Optional[dict] = None) -> dict:
        with self._lock:
            entry = {"ts": time.time(), "user": user, "action": action,
                     "table": table, "detail": detail or {},
                     "prev": self._last_hash}
            body = json.dumps(entry, sort_keys=True)
            entry["hash"] = hashlib.sha256(
                (self._last_hash + body).encode()).hexdigest()
            with open(self.path, "a") as f:
                f.write(json.dumps(entry) + "\n")
            self._last_hash = entry["hash"]
            return entry

    def entries(self) -> List[dict]:
        if not self.path.exists():
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def verify_chain(self) -> bool:
        prev = "0" * 64
        for e in self.entries():
            body = {k: v for k, v in e.items() if k != "hash"}
            want = hashlib.sha256(
                (prev + json.dumps(body, sort_keys=True)).encode()).hexdigest()
            if want != e["hash"] or e["prev"] != prev:
                return False
            prev = e["hash"]
        return True


class Lakehouse:
    """Store + auth + audit combined; tables are read onto `device`."""

    def __init__(self, root: str, device=None):
        self.store = LakeStore(os.path.join(root, "tables"), device=device)
        self.auth = AuthManager()
        self.audit = AuditLog(os.path.join(root, "audit.jsonl"))

    def append(self, token: str, table: str, df) -> int:
        p = self.auth.verify(token)
        if p is None or not self.auth.authorize(token, "write"):
            self.audit.record(p["sub"] if p else "?", "denied_append", table)
            raise ComputeError("not authorized")
        v = self.store.append(table, df)
        self.audit.record(p["sub"], "append", table,
                          {"version": v, "rows": df.height})
        return v

    def read(self, token: str, table: str):
        p = self.auth.verify(token)
        if p is None or not self.auth.authorize(token, "read"):
            self.audit.record(p["sub"] if p else "?", "denied_read", table)
            raise ComputeError("not authorized")
        df = self.store.read(table)
        self.audit.record(p["sub"], "read", table, {"rows": df.height})
        return df
