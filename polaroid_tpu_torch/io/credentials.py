"""Cloud credential providers, cached until shortly before they expire.

The port of the JAX package's `io/credentials.py` (the reference's
`polars-io/src/cloud/credential_provider.rs`): a user function that
returns `(credentials_dict, expiry_unix_ts)` is cached until shortly
before its expiry and called again on demand; built-in providers read
AWS, GCP and Azure credentials from the standard environment (variables,
`~/.aws/credentials` profiles, service-account key files) with no SDK.
Resolved credentials reach the filesystems as `storage_options`.
"""

from __future__ import annotations

import configparser
import json
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from ..errors import ComputeError

# refresh this many seconds before expiry (reference caches with the
# same early-refresh margin idea)
_REFRESH_MARGIN_S = 60.0


class CredentialProviderFunction:
    """Wrap a zero-arg callable returning (creds: dict, expiry: float|None).
    The result is cached until `expiry - margin`; expiry None = cache
    forever (static credentials)."""

    def __init__(self, fn: Callable[[], Tuple[Dict[str, str],
                                              Optional[float]]]):
        self._fn = fn
        self._lock = threading.Lock()
        self._cached: Optional[Dict[str, str]] = None
        self._expiry: Optional[float] = None

    def __call__(self) -> Dict[str, str]:
        with self._lock:
            now = time.time()
            if self._cached is not None and (
                    self._expiry is None
                    or now < self._expiry - _REFRESH_MARGIN_S):
                return self._cached
            creds, expiry = self._fn()
            if not isinstance(creds, dict):
                raise ComputeError(
                    "credential provider must return (dict, expiry)")
            self._cached, self._expiry = dict(creds), expiry
            return self._cached

    def clear(self) -> None:
        with self._lock:
            self._cached, self._expiry = None, None


# -- built-in providers (env/config surface only; no network, no SDK) -------

def _aws_from_env() -> Tuple[Dict[str, str], Optional[float]]:
    out = {}
    key = os.environ.get("AWS_ACCESS_KEY_ID")
    sec = os.environ.get("AWS_SECRET_ACCESS_KEY")
    if key and sec:
        out = {"key": key, "secret": sec}
        tok = os.environ.get("AWS_SESSION_TOKEN")
        if tok:
            out["token"] = tok
        return out, None
    # fall back to ~/.aws/credentials [profile]
    path = os.environ.get("AWS_SHARED_CREDENTIALS_FILE",
                          os.path.expanduser("~/.aws/credentials"))
    profile = os.environ.get("AWS_PROFILE", "default")
    cp = configparser.ConfigParser()
    if cp.read(path) and cp.has_section(profile):
        s = cp[profile]
        out = {"key": s.get("aws_access_key_id", ""),
               "secret": s.get("aws_secret_access_key", "")}
        if s.get("aws_session_token"):
            out["token"] = s["aws_session_token"]
        return out, None
    raise ComputeError("no AWS credentials in environment or profile")


def _gcp_from_env() -> Tuple[Dict[str, str], Optional[float]]:
    path = os.environ.get("GOOGLE_APPLICATION_CREDENTIALS")
    if path and os.path.exists(path):
        with open(path) as fh:
            json.load(fh)  # validate it parses
        return {"token": path}, None  # gcsfs accepts a key-file path
    raise ComputeError("GOOGLE_APPLICATION_CREDENTIALS not set")


def _azure_from_env() -> Tuple[Dict[str, str], Optional[float]]:
    acct = os.environ.get("AZURE_STORAGE_ACCOUNT_NAME")
    key = os.environ.get("AZURE_STORAGE_ACCOUNT_KEY")
    sas = os.environ.get("AZURE_STORAGE_SAS_TOKEN")
    conn = os.environ.get("AZURE_STORAGE_CONNECTION_STRING")
    if conn:
        return {"connection_string": conn}, None
    if acct and (key or sas):
        out = {"account_name": acct}
        if key:
            out["account_key"] = key
        else:
            out["sas_token"] = sas
        return out, None
    raise ComputeError("no Azure storage credentials in environment")


CredentialProviderAWS = lambda: CredentialProviderFunction(_aws_from_env)  # noqa: E731
CredentialProviderGCP = lambda: CredentialProviderFunction(_gcp_from_env)  # noqa: E731
CredentialProviderAzure = lambda: CredentialProviderFunction(_azure_from_env)  # noqa: E731

# -- registry: URI scheme -> provider ---------------------------------------

_REGISTRY: Dict[str, CredentialProviderFunction] = {}
_SCHEME_DEFAULTS = {"s3": _aws_from_env, "s3a": _aws_from_env,
                    "gs": _gcp_from_env, "gcs": _gcp_from_env,
                    "az": _azure_from_env, "abfs": _azure_from_env,
                    "abfss": _azure_from_env, "adl": _azure_from_env}


def register_credential_provider(scheme: str, provider) -> None:
    """Install a provider for a URI scheme. `provider` may be a
    CredentialProviderFunction or a plain callable returning
    (creds, expiry)."""
    if not isinstance(provider, CredentialProviderFunction):
        provider = CredentialProviderFunction(provider)
    _REGISTRY[scheme] = provider


def clear_credential_providers() -> None:
    _REGISTRY.clear()


def storage_options_for(path: str,
                        explicit: Optional[dict] = None) -> Optional[dict]:
    """Resolve storage options for a URI: explicit options win; else a
    registered provider; else a built-in env-sourced provider for known
    cloud schemes (best-effort — returns None when nothing applies so
    anonymous/ambient auth still works)."""
    if explicit:
        return dict(explicit)
    scheme = str(path).split("://", 1)[0]
    prov = _REGISTRY.get(scheme)
    if prov is not None:
        return prov()
    fn = _SCHEME_DEFAULTS.get(scheme)
    if fn is not None:
        try:
            return CredentialProviderFunction(fn)()
        except ComputeError:
            return None
    return None
