"""Service/method declaration layer.

The reference services are protobuf-generated classes whose CallMethod is
invoked by protocols (baidu_rpc_protocol.cpp:448).  Here a service is a
Python class with protobuf request/response types declared per method:

    class EchoService(Service):
        @method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            done()

``done`` must be called exactly once (it sends the response); returning from
the handler without calling it keeps the RPC open (async server-side), same
contract as the reference's google::protobuf::Closure.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional, Type

from . import request_context as _reqctx


def method(request_cls: Type, response_cls: Type):
    def deco(fn: Callable) -> Callable:
        fn._rpc_method = (request_cls, response_cls)
        return fn
    return deco


class MethodDescriptor:
    __slots__ = ("name", "full_name", "request_cls", "response_cls", "fn",
                 "service")

    def __init__(self, service: "Service", name: str, request_cls, response_cls,
                 fn: Callable):
        self.service = service
        self.name = name
        self.full_name = f"{service.service_name()}.{name}"
        self.request_cls = request_cls
        self.response_cls = response_cls
        self.fn = fn

    def invoke(self, cntl, request, response, done) -> None:
        """Run the handler.  ``done`` sends the response and recycles the
        pooled server Controller: after it returns the controller may be
        reset and reused by another request, so handlers must not touch
        it past their ``done()`` call (the reference's Closure contract).

        The handler's synchronous body runs under the inbound request's
        context (:mod:`.request_context`): outbound calls it makes inherit
        priority, tenant and the decremented deadline budget."""
        with _reqctx.scope(cntl):
            self.fn(cntl, request, response, done)


class Service:
    SERVICE_NAME: Optional[str] = None

    @classmethod
    def service_name(cls) -> str:
        return cls.SERVICE_NAME or cls.__name__

    def methods(self) -> Dict[str, MethodDescriptor]:
        out = {}
        for name, member in inspect.getmembers(self, predicate=callable):
            sig = getattr(member, "_rpc_method", None)
            if sig is not None:
                out[name] = MethodDescriptor(self, name, sig[0], sig[1], member)
        return out
