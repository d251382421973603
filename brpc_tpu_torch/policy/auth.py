"""Authentication (reference: src/brpc/authenticator.h and the giano
authenticator's signed credential).

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
