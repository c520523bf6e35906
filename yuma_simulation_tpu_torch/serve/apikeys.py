"""Signed-API-key tenant identity for the serving tier.

The tenant field was payload-claimed from day one — fine for a
single-operator deployment, but the moment negotiated quotas and
priority ceilings exist (``ServeConfig.tenant_overrides`` /
``tenant_priority``), an unauthenticated client can claim any tenant it
likes and ride someone else's quota. This module closes that hole with
stdlib-only HMAC keys:

- the keyfile (``ServeConfig.api_keys_path``) is JSON mapping
  ``tenant -> secret`` (hex or any string; operators mint and rotate it
  out of band);
- a client presents ``X-Api-Key: <tenant>.<signature>`` where the
  signature is ``HMAC_SHA256(secret, tenant)`` hex — :func:`mint_api_key`
  builds it, so a key is a stable signed credential, not the secret
  itself on the wire in raw form;
- the service verifies with :func:`hmac.compare_digest` (constant-time)
  and resolves the TENANT from the key — when keys are configured, the
  payload's ``tenant`` claim is overwritten before admission, so the
  negotiated-priority/quota tables key on a verified identity;
- a missing/garbled/forged key is a typed 401 (``Unauthenticated``),
  never a silent fall-through to the anonymous tenant.

Deliberately boring: no expiry, no scopes, no key ids — that belongs to
a real IAM integration. What this buys is the invariant the scale-out
tier needs: payload-claimed tenant/priority is NEVER trusted when keys
are configured.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import logging
import pathlib
from typing import Optional, Union

logger = logging.getLogger(__name__)


def mint_api_key(tenant: str, secret: str) -> str:
    """The credential a client sends as ``X-Api-Key``:
    ``<tenant>.<HMAC_SHA256(secret, tenant) hex>``."""
    sig = hmac.new(
        secret.encode(), tenant.encode(), hashlib.sha256
    ).hexdigest()
    return f"{tenant}.{sig}"


class ApiKeyring:
    """The server half: a loaded keyfile + constant-time verification.

    Immutable after load (rotation = reload + swap); empty keyrings
    refuse construction so "configured but empty" fails loudly at
    startup instead of 401-ing every tenant at runtime."""

    def __init__(self, keys: dict):
        clean = {}
        for tenant, secret in (keys or {}).items():
            if not isinstance(tenant, str) or not tenant:
                raise ValueError("api keyfile: tenant must be a non-empty string")
            if not isinstance(secret, str) or not secret:
                raise ValueError(
                    f"api keyfile: tenant {tenant!r} has an empty secret"
                )
            clean[tenant] = secret
        if not clean:
            raise ValueError("api keyfile holds no keys")
        self._keys = clean

    @classmethod
    def load(cls, path: Union[str, pathlib.Path]) -> "ApiKeyring":
        data = json.loads(pathlib.Path(path).read_text())
        if not isinstance(data, dict):
            raise ValueError(f"api keyfile {path}: expected a JSON object")
        return cls(data)

    def __len__(self) -> int:
        return len(self._keys)

    def resolve(self, api_key: Optional[str]) -> Optional[str]:
        """The verified tenant id for ``api_key``, or None when the key
        is absent, malformed, names an unknown tenant, or fails its
        signature check (one code path for all four — a prober learns
        nothing from WHICH check failed)."""
        if not api_key or not isinstance(api_key, str):
            return None
        tenant, sep, sig = api_key.rpartition(".")
        if not sep or not tenant:
            return None
        secret = self._keys.get(tenant)
        if secret is None:
            return None
        expected = hmac.new(
            secret.encode(), tenant.encode(), hashlib.sha256
        ).hexdigest()
        if not hmac.compare_digest(expected, sig):
            return None
        return tenant
