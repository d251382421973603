"""Authentication (reference: src/brpc/authenticator.h and the giano,
couchbase, esp and redis authenticators).

An Authenticator generates a credential on the client (``Channel`` puts
it in every call's ``auth_token``: tpu_std's request meta, h2's
``authorization`` header) and verifies it on the server; a failed
verification fails the RPC with ERPCAUTH (gRPC UNAUTHENTICATED, h2 REST
401) before user code runs.
"""
from __future__ import annotations

import hashlib
import hmac
import time


class Authenticator:
    def generate_credential(self, cntl) -> str:
        raise NotImplementedError

    def verify(self, token: str, socket) -> bool:
        """Called by the server protocol; returning False → ERPCAUTH."""
        raise NotImplementedError


class TokenAuthenticator(Authenticator):
    """Shared-secret bearer token, compared in constant time."""

    def __init__(self, token: str):
        self._token = token

    def generate_credential(self, cntl) -> str:
        return self._token

    def verify(self, token: str, socket) -> bool:
        return hmac.compare_digest(token, self._token)


class HmacAuthenticator(Authenticator):
    """Time-windowed HMAC(secret, window) credential — replay-bounded
    (the giano-style signed-credential shape, reimplemented simply)."""

    def __init__(self, key: str, window_s: int = 60):
        self._key = key.encode()
        self._window_s = window_s

    def _sig(self, window: int) -> str:
        return hmac.new(self._key, str(window).encode(),
                        hashlib.sha256).hexdigest()

    def generate_credential(self, cntl) -> str:
        window = int(time.time()) // self._window_s
        return f"{window}:{self._sig(window)}"

    def verify(self, token: str, socket) -> bool:
        try:
            window_str, sig = token.split(":", 1)
            window = int(window_str)
        except ValueError:
            return False
        now_window = int(time.time()) // self._window_s
        if abs(window - now_window) > 1:
            return False                  # expired credential
        return hmac.compare_digest(sig, self._sig(window))


class RedisAuthenticator(Authenticator):
    """Redis AUTH (policy/redis_authenticator.{h,cpp}): the credential is
    the password, or ``user\\x00password`` for a Redis 6 ACL user (NUL so
    a password with spaces survives the argument split); the redis
    protocol sends AUTH before a connection's first command."""

    def __init__(self, password: str, user: str = ""):
        self._cred = f"{user}\x00{password}" if user else password

    def generate_credential(self, cntl) -> str:
        return self._cred

    def verify(self, token: str, socket) -> bool:
        return hmac.compare_digest(token, self._cred)


class CouchbaseAuthenticator(Authenticator):
    """SASL PLAIN over the memcache binary protocol
    (policy/couchbase_authenticator.{h,cpp}): the credential is
    ``user:password``; the memcache protocol sends OP_SASL_AUTH before a
    connection's first operation."""

    def __init__(self, user: str, password: str):
        self._cred = f"{user}:{password}"

    def generate_credential(self, cntl) -> str:
        return self._cred

    def verify(self, token: str, socket) -> bool:
        return hmac.compare_digest(token, self._cred)


class EspAuthenticator(Authenticator):
    """ESP magic-number credential (policy/esp_authenticator.cpp: a 6-byte
    magic and a 2-byte local port); a server accepts anything, as the
    reference's VerifyCredential does."""

    _MAGIC = b"\x00ESP\x01\x02"

    def generate_credential(self, cntl) -> str:
        return (self._MAGIC + b"\x00\x00").decode("latin-1")

    def verify(self, token: str, socket) -> bool:
        return True
