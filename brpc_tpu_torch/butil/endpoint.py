"""EndPoint: addressable peers across the fabric's three transports.

The reference EndPoint is an ip:port value type (src/butil/endpoint.h).  The
TPU fabric addresses three kinds of peers, so EndPoint generalizes to a
(scheme, host, port, device) value type parsed from URI-ish strings:

  * ``tcp://10.0.0.1:8000`` or plain ``10.0.0.1:8000``  — DCN / host network
  * ``ici://3`` or ``ici://(0,1)``                      — device coordinate on
    the local mesh (logical device id or mesh coords)
  * ``mem://name``                                       — in-process loopback
    transport used by tests/CI (the localhost fixture of SURVEY.md §4)

Hashable, comparable, and cheap — EndPoint is used as a map key by SocketMap
and by every naming service.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Tuple

SCHEME_TCP = "tcp"
SCHEME_ICI = "ici"
SCHEME_MEM = "mem"

_COORD_RE = re.compile(r"^\((\s*\d+\s*(?:,\s*\d+\s*)*)\)$")


@dataclass(frozen=True, order=True)
class EndPoint:
    scheme: str = SCHEME_TCP
    host: str = ""
    port: int = 0
    coords: Tuple[int, ...] = ()

    def __str__(self) -> str:
        if self.scheme == SCHEME_ICI:
            if len(self.coords) == 1:
                return f"ici://{self.coords[0]}"
            return "ici://(" + ",".join(map(str, self.coords)) + ")"
        if self.scheme == SCHEME_MEM:
            return f"mem://{self.host}"
        return f"{self.host}:{self.port}"

    @property
    def device_id(self) -> int:
        """Logical device id for single-axis ici endpoints."""
        if self.scheme != SCHEME_ICI:
            raise ValueError(f"{self} is not an ici endpoint")
        if len(self.coords) != 1:
            raise ValueError(f"{self} has mesh coords, not a flat device id")
        return self.coords[0]


def parse_endpoint(s: str) -> EndPoint:
    s = s.strip()
    if s.startswith("ici://"):
        body = s[len("ici://"):]
        m = _COORD_RE.match(body)
        if m:
            coords = tuple(int(x) for x in m.group(1).split(","))
        else:
            coords = (int(body),)
        return EndPoint(scheme=SCHEME_ICI, coords=coords)
    if s.startswith("mem://"):
        return EndPoint(scheme=SCHEME_MEM, host=s[len("mem://"):])
    if s.startswith("tcp://"):
        s = s[len("tcp://"):]
        if ":" not in s:
            raise ValueError(f"bad endpoint {s!r}: missing port")
    elif ":" not in s:
        # Bare token without a port: an in-process mem:// registry name.
        # Naming services (list://, file://) carry mem/ici backends this way
        # (reference list_naming_service.cpp only ever names ip:port; our
        # fabric has three transports, so scheme-less entries default to the
        # loopback registry rather than failing).  Heuristic guard: dotted
        # names/IPs, "localhost", and all-digit tokens still error — those
        # are almost certainly tcp targets with the port forgotten, and
        # routing them to a nonexistent registry would hide the typo.
        # (A dotless bare hostname like "node2" is indistinguishable from
        # a registry slug and resolves as mem:// — use tcp://node2:port
        # for network targets.)
        if not s:
            raise ValueError("empty endpoint")
        if "." in s or s == "localhost" or s.isdigit():
            raise ValueError(f"bad endpoint {s!r}: missing port "
                             f"(host-like names need host:port; "
                             f"mem:// registry names don't contain dots "
                             f"and aren't all digits)")
        return EndPoint(scheme=SCHEME_MEM, host=s)
    host, _, port = s.rpartition(":")
    return EndPoint(scheme=SCHEME_TCP, host=host, port=int(port))
