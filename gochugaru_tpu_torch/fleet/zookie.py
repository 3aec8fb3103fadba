"""Zookies: client-held freshness tokens (Zanzibar §2.4).

A zookie is minted by the front router on every write and handed back to
the client; presenting it on a later Check/Lookup guarantees
read-your-writes — the router routes to any replica whose resident head
has reached the zookie's revision, or blocks (bounded) until one
catches up.  The token is opaque to clients and *authenticated*: an
HMAC over the revision keeps a client from forging "fresher" tokens to
force head reads (the DoS vector Zanzibar's encrypted zookies close).

Format: ``zk1.<revision>.<hex-mac-20>`` — HMAC-SHA256 over the version
tag + revision, truncated to 80 bits.  Tampered, truncated, or garbage
tokens raise ``InvalidZookieError`` (permanent, never retriable: a bad
token cannot become valid by retrying).
"""

from __future__ import annotations

import hashlib
import hmac

from .. import consistency
from ..store.store import RevisionToken, parse_revision
from ..utils.errors import AuthzError
from . import wire as _wire

_PREFIX = "zk1"
_MAC_HEX = 20

#: Dev/test default.  A real deployment passes its own key through
#: ``FleetConfig.zookie_key`` — router and any token-validating front
#: must share it.
DEFAULT_KEY = b"gochugaru-fleet-dev-key"


@_wire.register_error
class InvalidZookieError(AuthzError):
    """A zookie that fails parsing or MAC verification.  Permanent."""


def _mac(revision: int, key: bytes) -> str:
    body = f"{_PREFIX}.{revision}".encode("utf-8")
    return hmac.new(key, body, hashlib.sha256).hexdigest()[:_MAC_HEX]


def mint(revision, key: bytes = DEFAULT_KEY) -> str:
    """Token for a revision (int or ``gtz1.N`` token string)."""
    rev = revision if isinstance(revision, int) else parse_revision(revision)
    return f"{_PREFIX}.{rev}.{_mac(rev, key)}"


def parse(token: str, key: bytes = DEFAULT_KEY) -> int:
    """Verify and return the revision; raises InvalidZookieError on any
    malformed or tampered token."""
    if not isinstance(token, str):
        raise InvalidZookieError(f"zookie must be a string, got {type(token).__name__}")
    parts = token.split(".")
    if len(parts) != 3 or parts[0] != _PREFIX:
        raise InvalidZookieError(f"malformed zookie: {token!r}")
    try:
        rev = int(parts[1])
    except ValueError:
        raise InvalidZookieError(f"malformed zookie revision: {token!r}") from None
    if rev < 0:
        raise InvalidZookieError(f"malformed zookie revision: {token!r}")
    if not hmac.compare_digest(parts[2], _mac(rev, key)):
        raise InvalidZookieError("zookie failed verification (tampered or wrong key)")
    return rev


def revision_token(token: str, key: bytes = DEFAULT_KEY) -> str:
    """The store revision token (``gtz1.N``) a zookie names."""
    return RevisionToken(parse(token, key))


def strategy(token: str, key: bytes = DEFAULT_KEY) -> consistency.Strategy:
    """The consistency strategy a bare zookie implies: at-least-as-fresh
    as the write that minted it — read-your-writes for single-store
    clients (the router composes zookies with the caller's strategy
    itself; this is the convenience for direct ``Client`` use)."""
    return consistency.at_least(revision_token(token, key))
