"""A local on-disk cache of remote objects.

The port of the JAX package's `io/file_cache.py` (the reference's
`polars-io/src/file_cache/`): remote reads go through a cache directory,
so repeated scans of one object read the local disk, with

- an atomic fill (a download to a temporary file and a rename), so that
  a reader never sees part of a file;
- safety across processes by `fcntl.flock` on a lock file per entry;
- a check against the remote object (size, mtime or etag): a changed
  object invalidates its entry;
- eviction of entries not read within a TTL (`PT_FILE_CACHE_TTL`
  seconds, one hour by default).

On when `PT_FILE_CACHE=1` (off by default: local files need no cache).
The tests drive it through fsspec's `memory://` filesystem, the route a
cloud store takes.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Optional

from ..errors import ComputeError

DEFAULT_TTL_S = 3600.0


def cache_dir() -> Path:
    d = os.environ.get("PT_FILE_CACHE_DIR")
    if d:
        return Path(d)
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(base) / "polaroid-tpu" / "file-cache"


def cache_enabled() -> bool:
    return os.environ.get("PT_FILE_CACHE", "0") not in ("0", "", "false")


def _ttl_s() -> float:
    return float(os.environ.get("PT_FILE_CACHE_TTL", DEFAULT_TTL_S))


def _entry_key(uri: str) -> str:
    return hashlib.sha256(str(uri).encode()).hexdigest()[:32]


class FileCacheEntry:
    """One cached remote object: `<key>.data` + `<key>.meta.json` +
    `<key>.lock` under the cache dir."""

    def __init__(self, uri: str, root: Optional[Path] = None):
        self.uri = str(uri)
        self.root = root or cache_dir()
        self.key = _entry_key(self.uri)
        self.data_path = self.root / f"{self.key}.data"
        self.meta_path = self.root / f"{self.key}.meta.json"
        self.lock_path = self.root / f"{self.key}.lock"

    # -- metadata ----------------------------------------------------------
    def _read_meta(self) -> Optional[dict]:
        try:
            with open(self.meta_path) as fh:
                return json.load(fh)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _write_meta(self, meta: dict) -> None:
        tmp = self.meta_path.with_suffix(".tmp")
        with open(tmp, "w") as fh:
            json.dump(meta, fh)
        os.replace(tmp, self.meta_path)

    def touch(self) -> None:
        """Record access time (drives LRU/TTL eviction)."""
        m = self._read_meta()
        if m is not None:
            m["last_access"] = time.time()
            self._write_meta(m)

    # -- fetch -------------------------------------------------------------
    def get_or_fetch(self, fs, inner_path: str) -> str:
        """Return a local path for the remote object, downloading it if
        absent or stale. fs is an fsspec-style or pyarrow filesystem."""
        self.root.mkdir(parents=True, exist_ok=True)
        remote = _remote_version(fs, inner_path)
        with open(self.lock_path, "a+") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                meta = self._read_meta()
                if (meta is not None and self.data_path.exists()
                        and meta.get("remote") == remote):
                    meta["last_access"] = time.time()
                    self._write_meta(meta)
                    return str(self.data_path)
                # (re)populate atomically
                fd, tmp = tempfile.mkstemp(dir=self.root,
                                           prefix=f".{self.key}.")
                try:
                    with os.fdopen(fd, "wb") as out:
                        _copy_remote(fs, inner_path, out)
                    os.replace(tmp, self.data_path)
                except BaseException:
                    try:
                        os.unlink(tmp)
                    except FileNotFoundError:
                        pass
                    raise
                self._write_meta({"uri": self.uri, "remote": remote,
                                  "last_access": time.time()})
                return str(self.data_path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def remove(self) -> None:
        for p in (self.data_path, self.meta_path, self.lock_path):
            try:
                os.unlink(p)
            except FileNotFoundError:
                pass


def _remote_version(fs, inner_path: str) -> dict:
    """Size + mtime/etag fingerprint of the remote object (reference:
    entry.rs remote_version consistency check)."""
    try:
        info = fs.info(inner_path)  # fsspec
        return {"size": info.get("size"),
                "version": str(info.get("ETag") or info.get("etag")
                               or info.get("mtime") or info.get("LastModified")
                               or "")}
    except AttributeError:
        pass
    try:  # pyarrow filesystem
        fi = fs.get_file_info(inner_path)
        mtime = fi.mtime.timestamp() if fi.mtime is not None else ""
        return {"size": fi.size, "version": str(mtime)}
    except Exception as exc:
        raise ComputeError(
            f"cannot stat remote object {inner_path!r}: {exc}") from exc


def _copy_remote(fs, inner_path: str, out) -> None:
    opener = getattr(fs, "open", None)
    if opener is None:  # pyarrow filesystem
        opener = fs.open_input_file
        src = opener(inner_path)
    else:
        src = opener(inner_path, "rb")
    with src:
        while True:
            chunk = src.read(16 << 20)
            if not chunk:
                return
            out.write(chunk)


def prune(root: Optional[Path] = None, ttl_s: Optional[float] = None) -> int:
    """Evict entries not accessed within TTL. Returns count evicted.
    Safe under concurrency: eviction takes each entry's lock."""
    root = root or cache_dir()
    ttl = _ttl_s() if ttl_s is None else ttl_s
    if not root.is_dir():
        return 0
    now = time.time()
    evicted = 0
    for meta_path in root.glob("*.meta.json"):
        key = meta_path.name.split(".", 1)[0]
        lock_path = root / f"{key}.lock"
        try:
            with open(lock_path, "a+") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                try:
                    with open(meta_path) as fh:
                        meta = json.load(fh)
                    if now - float(meta.get("last_access", 0)) > ttl:
                        for suffix in (".data", ".meta.json", ".lock"):
                            try:
                                os.unlink(root / f"{key}{suffix}")
                            except FileNotFoundError:
                                pass
                        evicted += 1
                finally:
                    fcntl.flock(lock, fcntl.LOCK_UN)
        except (BlockingIOError, FileNotFoundError, json.JSONDecodeError):
            continue  # entry busy or raced away — skip
    return evicted


def cached_local_path(uri: str, fs, inner_path: str) -> str:
    """Main entry point: map a remote URI to a local cached file path,
    opportunistically pruning stale entries."""
    entry = FileCacheEntry(uri)
    out = entry.get_or_fetch(fs, inner_path)
    prune()
    return out
