"""Remote and cloud object-store paths.

The port of the JAX package's `io/remote.py` (the reference's
`polars-io/src/cloud/`): a URI resolves to a filesystem handle that
pyarrow's readers take, so `scan_parquet("s3://bucket/key.parquet")`
reads wherever the environment holds credentials. Resolution order:

1. `pyarrow.fs.FileSystem.from_uri` (S3, GCS, Azure, HDFS, local);
2. `fsspec.filesystem(scheme)` (http, memory, sftp, ...).

Both are imported when a path is resolved. The tests drive this code
through fsspec's `memory://` and pyarrow's `file://` filesystems, which
take the same route a cloud store does.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..errors import ComputeError

__all__ = ["is_remote", "resolve_filesystem", "remote_glob",
           "localize"]


def is_remote(path: str) -> bool:
    return "://" in str(path)


def resolve_filesystem(path: str,
                       storage_options: Optional[dict] = None
                       ) -> Tuple[object, str]:
    """URI -> (filesystem, path-within-filesystem). The filesystem object
    is acceptable to pyarrow readers' `filesystem=` argument.

    Credentials: explicit `storage_options` win; otherwise registered
    credential providers / env-sourced defaults supply them
    (`io/credentials.py`; reference: `cloud/credential_provider.rs`)."""
    s = str(path)
    from .credentials import storage_options_for
    opts = storage_options_for(s, storage_options)
    scheme = s.split("://", 1)[0]
    if not opts:
        try:
            import pyarrow.fs as pafs
            fs, p = pafs.FileSystem.from_uri(s)
            return fs, p
        except Exception:
            pass
    try:
        import fsspec
        fs = fsspec.filesystem(scheme, **(opts or {}))
        return fs, s.split("://", 1)[1]
    except Exception as exc:
        raise ComputeError(
            f"cannot resolve remote path {s!r}: {exc}") from exc


def localize(path: str, storage_options: Optional[dict] = None) -> str:
    """Map a URI to a local path through the remote-file cache when
    `PT_FILE_CACHE=1` (reference: `polars-io/src/file_cache/`); local
    paths and cache-off pass through unchanged."""
    s = str(path)
    if "://" not in s or s.startswith("file://"):
        return s.split("://", 1)[-1] if s.startswith("file://") else s
    from .file_cache import cache_enabled, cached_local_path
    if not cache_enabled():
        return s
    fs, inner = resolve_filesystem(s, storage_options)
    return cached_local_path(s, fs, inner)


def remote_glob(pattern: str) -> list:
    """Glob on a remote filesystem (fsspec-backed; pyarrow filesystems
    have no glob, so fall back to the single path)."""
    s = str(pattern)
    scheme = s.split("://", 1)[0]
    try:
        import fsspec
        fs = fsspec.filesystem(scheme)
        hits = fs.glob(s)
        if hits:
            return [f"{scheme}://{h}" if "://" not in str(h) else str(h)
                    for h in hits]
    except Exception:
        pass
    return [s]
