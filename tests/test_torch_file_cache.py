"""The port's remote-file cache and credential providers: the cases of
tests/test_file_cache.py run against `polaroid_tpu_torch.io` (fsspec's
memory:// stands in for a cloud store, the same code path), and the
cached Parquet scan is held to the JAX package's read of the same
object."""

import json
import os
import time

import pytest

import polaroid_tpu as ref
import polaroid_tpu_torch as pl
from polaroid_tpu_torch.io import file_cache as fc
from polaroid_tpu_torch.io.credentials import (
    CredentialProviderFunction, clear_credential_providers,
    register_credential_provider, storage_options_for)


@pytest.fixture(autouse=True, scope="module")
def _fresh_reference_cache():
    """The JAX package's process-wide caches can hand a plan another
    frame's results (`tests/test_torch_reference_caches.py`)."""
    from test_torch_reference_caches import fresh_reference_caches
    with fresh_reference_caches():
        yield


@pytest.fixture
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PT_FILE_CACHE", "1")
    monkeypatch.setenv("PT_FILE_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setenv("PT_FILE_CACHE_TTL", "3600")
    yield tmp_path / "cache"


def _write_remote(name, payload: bytes):
    import fsspec
    fs = fsspec.filesystem("memory")
    with fs.open(name, "wb") as fh:
        fh.write(payload)
    return fs


def test_cache_populate_hit_and_invalidate(cache_env):
    fs = _write_remote("/ptcache/a.bin", b"hello world")
    e = fc.FileCacheEntry("memory://ptcache/a.bin")
    p1 = e.get_or_fetch(fs, "/ptcache/a.bin")
    assert open(p1, "rb").read() == b"hello world"
    meta1 = json.load(open(e.meta_path))
    # second call is a hit: data file untouched
    ino = os.stat(p1).st_ino
    p2 = e.get_or_fetch(fs, "/ptcache/a.bin")
    assert p2 == p1 and os.stat(p2).st_ino == ino
    # remote change (size) invalidates and re-downloads
    _write_remote("/ptcache/a.bin", b"changed payload!")
    p3 = e.get_or_fetch(fs, "/ptcache/a.bin")
    assert open(p3, "rb").read() == b"changed payload!"
    assert json.load(open(e.meta_path))["remote"] != meta1["remote"]


def test_cache_ttl_eviction(cache_env):
    fs = _write_remote("/ptcache/b.bin", b"x" * 100)
    e = fc.FileCacheEntry("memory://ptcache/b.bin")
    e.get_or_fetch(fs, "/ptcache/b.bin")
    assert fc.prune(ttl_s=3600) == 0  # fresh: kept
    # age the entry past TTL
    m = json.load(open(e.meta_path))
    m["last_access"] = time.time() - 7200
    json.dump(m, open(e.meta_path, "w"))
    assert fc.prune(ttl_s=3600) == 1
    assert not e.data_path.exists()


def test_cached_parquet_scan_through_public_api(cache_env):
    df = pl.DataFrame({"a": [1, 2, 3], "s": ["p", "q", "r"]}, device="cpu")
    df.write_parquet("memory://ptcache/t.parquet")
    back = pl.read_parquet("memory://ptcache/t.parquet", device="cpu")
    assert back.to_dict() == df.to_dict()
    # the object landed in the cache dir and a re-read hits it
    data_files = list(cache_env.glob("*.data"))
    assert len(data_files) == 1
    again = pl.read_parquet("memory://ptcache/t.parquet", device="cpu")
    assert again.to_dict() == df.to_dict()
    assert len(list(cache_env.glob("*.data"))) == 1
    assert ref.read_parquet("memory://ptcache/t.parquet").to_dict() == \
        df.to_dict()
    assert len(list(cache_env.glob("*.data"))) == 1


def test_credential_provider_function_caching():
    calls = []

    def fn():
        calls.append(1)
        return {"key": f"k{len(calls)}"}, time.time() + 3600

    p = CredentialProviderFunction(fn)
    assert p() == {"key": "k1"}
    assert p() == {"key": "k1"} and len(calls) == 1  # cached
    p._expiry = time.time() + 10  # inside refresh margin -> re-fetch
    assert p() == {"key": "k2"} and len(calls) == 2


def test_credential_registry_and_env_aws(monkeypatch):
    clear_credential_providers()
    register_credential_provider(
        "myscheme", lambda: ({"token": "t0"}, None))
    assert storage_options_for("myscheme://b/k") == {"token": "t0"}
    assert storage_options_for("myscheme://b/k",
                               {"token": "explicit"}) == {"token": "explicit"}
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AK")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "SK")
    monkeypatch.setenv("AWS_SESSION_TOKEN", "ST")
    so = storage_options_for("s3://b/k")
    assert so == {"key": "AK", "secret": "SK", "token": "ST"}
    clear_credential_providers()


def test_credential_aws_profile_file(tmp_path, monkeypatch):
    clear_credential_providers()
    monkeypatch.delenv("AWS_ACCESS_KEY_ID", raising=False)
    monkeypatch.delenv("AWS_SECRET_ACCESS_KEY", raising=False)
    cred = tmp_path / "credentials"
    cred.write_text("[prof]\naws_access_key_id=PK\n"
                    "aws_secret_access_key=PS\n")
    monkeypatch.setenv("AWS_SHARED_CREDENTIALS_FILE", str(cred))
    monkeypatch.setenv("AWS_PROFILE", "prof")
    so = storage_options_for("s3://b/k")
    assert so == {"key": "PK", "secret": "PS"}
