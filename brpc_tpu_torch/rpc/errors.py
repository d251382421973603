"""RPC error space (reference: src/brpc/errno.proto + errno.cpp).

Negative codes are framework errors (same spelling as the reference so
operators can map runbooks); positive codes are OS errno passthrough.
"""
from __future__ import annotations

# framework errors (reference errno.proto values)
ENOSERVICE = 1001       # service not found
ENOMETHOD = 1002        # method not found
EREQUEST = 1003         # bad request
ERPCAUTH = 1004         # authentication failed
ETOOMANYFAILS = 1005    # too many sub-channel failures (ParallelChannel)
EPCHANFINISH = 1006     # ParallelChannel finished
EBACKUPREQUEST = 1007   # backup request triggered (internal)
ERPCTIMEDOUT = 1008     # RPC deadline exceeded
EFAILEDSOCKET = 1009    # the connection was broken during the RPC
EHTTP = 1010            # HTTP-level error
EOVERCROWDED = 1011     # too many buffering bytes on the socket
ERTMPPUBLISHABLE = 1012
ERTMPCREATESTREAM = 1013
EEOF = 1014             # stream reached EOF
EUNUSED = 1015
ESSL = 1016
EITP = 1017

# server errors
EINTERNAL = 2001        # uncaught server-side exception
ERESPONSE = 2002        # bad response
ELOGOFF = 2003          # server is stopping
ELIMIT = 2004           # concurrency limiter rejected the request
ECLOSE = 2005
EITIMEOUT = 2006

# os-ish
EINVAL = 22
EAGAIN = 11
ENODATA = 61
ECANCELED = 125
ENOMEM = 12
ECONNREFUSED = 111
ECONNRESET = 104
ENOENT = 2
EPERM = 1
ETIMEDOUT = 110

_DESCRIPTIONS = {
    ENOSERVICE: "Service not found",
    ENOMETHOD: "Method not found",
    EREQUEST: "Bad request",
    ERPCAUTH: "Unauthorized",
    ETOOMANYFAILS: "Too many failed sub-calls",
    EPCHANFINISH: "ParallelChannel finished",
    EBACKUPREQUEST: "Backup request triggered",
    ERPCTIMEDOUT: "RPC deadline exceeded",
    EFAILEDSOCKET: "Broken socket",
    EHTTP: "HTTP error",
    EOVERCROWDED: "Socket write buffer overcrowded",
    EEOF: "End of stream",
    EINTERNAL: "Internal server error",
    ERESPONSE: "Bad response",
    ELOGOFF: "Server is stopping",
    ELIMIT: "Rejected by concurrency limiter",
    EINVAL: "Invalid argument",
    ETIMEDOUT: "Timed out",
    ECONNREFUSED: "Connection refused",
    ECONNRESET: "Connection reset",
}


def berror(code: int) -> str:
    import os
    d = _DESCRIPTIONS.get(code)
    if d:
        return d
    try:
        return os.strerror(code)
    except Exception:
        return f"error {code}"


class RpcError(Exception):
    def __init__(self, code: int, text: str = ""):
        self.code = code
        self.text = text or berror(code)
        super().__init__(f"[E{code}] {self.text}")
