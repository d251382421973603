"""Native-datapath Server/Channel facades over the port's own C++ core.

The RPC hot path over TCP (TRPC framing, the epoll loops, method dispatch,
response correlation) runs in ``csrc/rpc_native.cpp``; Python supplies
service registration and, where a method is not native, the handler.  Two
handler tiers:

* **native echo methods** (``register_native_echo``): served entirely in
  C++, no Python per request;
* **Python services** (``add_service`` with regular ``rpc.Service``
  classes): the native server upcalls into Python once per request with
  the cut payload; protobuf parse, user code and the respond happen under
  the GIL, everything else stays native.

The wire is byte-identical to ``policy/tpu_std.py``'s frames, so a native
server serves a ``tcp://`` ``rpc.Channel`` and a native channel calls an
``rpc.Server``; and it is the reference core's wire, so each package's
native channel calls the other's native server.

The port of ``brpc_tpu/rpc/native_fabric.py``: the same classes and
methods, on the port's ``Controller``, ``Service``, ``errors`` and
scheduler.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Any, Callable, Dict, Optional, Type

from ..butil import logging as log
from ..butil import native
from ..butil.native import _ASYNC_CB, _NREQ_FN
from . import errors
from .controller import Controller
from .service import MethodDescriptor, Service


class NativeServer:
    """Server whose datapath (accept/read/frame/dispatch/write) is native.

    Python handlers run via a single upcall per request; ``done()`` sends
    the response from whichever thread calls it (the native side serializes
    per-connection writes).
    """

    def __init__(self, usercode_inline: bool = True):
        self._lib = native.load()
        if self._lib is None:
            raise RuntimeError("native core unavailable")
        self._handle = 0
        self._methods: Dict[str, MethodDescriptor] = {}
        self._native_echo: set = set()
        # keep the callback object alive for the server's lifetime
        self._cb = _NREQ_FN(self._on_request)
        self._lock = threading.Lock()
        # True (default): handlers run on the upcalling epoll-loop thread
        # (minimal latency; handlers must be fast).  False: handlers park
        # on bthread tasklets — a blocking handler then stalls only its
        # tasklet, not the connection loop (the tail-isolation doctrine;
        # the Python Server's default).
        self.usercode_inline = usercode_inline

    # ---- control plane ------------------------------------------------

    def add_service(self, service: Service) -> None:
        for md in service.methods().values():
            if md.full_name in self._methods:
                raise ValueError(f"duplicate method {md.full_name}")
            self._methods[md.full_name] = md

    def register_native_echo(self, full_method: str) -> None:
        """Serve `full_method` natively: response body = request body (the
        reference's C++ echo handler tier; no Python per request)."""
        self._native_echo.add(full_method)

    def start(self, port: int = 0) -> int:
        h = self._lib.brpc_tpu_nserver_start(port)
        if h == 0:
            raise RuntimeError(f"cannot bind port {port}")
        self._handle = h
        for m in self._native_echo:
            self._lib.brpc_tpu_nserver_register_echo(h, m.encode())
        if self._methods:
            self._lib.brpc_tpu_nserver_set_handler(h, self._cb)
        self.port = self._lib.brpc_tpu_nserver_port(h)
        log.info("NativeServer started on port %d (%d py methods, %d native)",
                 self.port, len(self._methods), len(self._native_echo))
        return self.port

    def stop(self) -> None:
        with self._lock:
            if self._handle:
                self._lib.brpc_tpu_nserver_stop(self._handle)
                self._handle = 0

    def requests(self) -> int:
        return self._lib.brpc_tpu_nserver_requests(self._handle)

    # ---- data plane upcall --------------------------------------------

    def _respond(self, token: int, err: int, err_text: str,
                 payload: bytes, att: bytes) -> None:
        p = (ctypes.c_uint8 * len(payload)).from_buffer_copy(payload) \
            if payload else None
        a = (ctypes.c_uint8 * len(att)).from_buffer_copy(att) if att else None
        self._lib.brpc_tpu_nserver_respond(
            token, err, err_text.encode() if err_text else b"", p,
            len(payload), a, len(att))

    def _on_request(self, token, method, payload_p, payload_len,
                    att_p, att_len, log_id):
        try:
            full = method.decode()
            # copies happen HERE, inside the upcall — the native buffers
            # are only valid until we return
            payload = ctypes.string_at(payload_p, payload_len) \
                if payload_len else b""
            att = ctypes.string_at(att_p, att_len) if att_len else b""
            if not self.usercode_inline:
                from ..bthread import scheduler
                scheduler.start_background(
                    self._handle_request, token, full, payload, att,
                    log_id, name=f"nreq:{full}")
                return
            self._handle_request(token, full, payload, att, log_id)
        except Exception as e:          # never let an exception cross ctypes
            self._last_resort_error(token, e)

    def _last_resort_error(self, token, e) -> None:
        """Catch-all for request processing: the token must be answered
        (or at least attempted) no matter what blew up — on the upcall
        thread this also keeps the exception from crossing ctypes."""
        log.error("native-server request failed: %s", e, exc_info=True)
        try:
            self._respond(token, errors.EINTERNAL, str(e), b"", b"")
        except Exception:
            pass

    def _handle_request(self, token, full, payload, att, log_id):
        try:
            md = self._methods.get(full)
            if md is None:
                self._respond(token, errors.ENOMETHOD,
                              f"no method {full}", b"", b"")
                return
            cntl = Controller()
            cntl.log_id = log_id
            if att:
                cntl.request_attachment.append(att)
            try:
                request = md.request_cls()
                request.ParseFromString(payload)
            except Exception as e:
                self._respond(token, errors.EREQUEST,
                              f"fail to parse request: {e}", b"", b"")
                return
            response = md.response_cls()
            done_called = [False]

            def done() -> None:
                if done_called[0]:
                    return
                done_called[0] = True
                if cntl.failed():
                    self._respond(token, cntl.error_code_, cntl.error_text_,
                                  b"", b"")
                    return
                self._respond(token, 0, "", response.SerializeToString(),
                              cntl.response_attachment.to_bytes())

            cntl.set_server_done(done)
            try:
                md.invoke(cntl, request, response, done)
            except Exception as e:
                log.error("native-server method %s raised: %s", full, e,
                          exc_info=True)
                if not done_called[0]:
                    cntl.set_failed(errors.EINTERNAL,
                                    f"{type(e).__name__}: {e}")
                    done()
        except Exception as e:
            self._last_resort_error(token, e)


def _marshal_sync_call(lib, call_fn, handle, full_name: str,
                       cntl: Controller, request: Any,
                       response_cls: Optional[Type]):
    """Shared ctypes marshalling for the sync native call ABIs (channel
    and pool take identical argument/output shapes)."""
    if hasattr(request, "SerializeToString"):
        req = request.SerializeToString()
    else:
        req = bytes(request) if request is not None else b""
    att = cntl.request_attachment.to_bytes() \
        if len(cntl.request_attachment) else b""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    reqb = ctypes.cast(req, u8p) if req else None
    attb = ctypes.cast(att, u8p) if att else None
    resp_p, resp_len = u8p(), ctypes.c_uint64()
    ratt_p, ratt_len = u8p(), ctypes.c_uint64()
    err_text = ctypes.c_char_p()
    timeout_us = int((cntl.timeout_ms or 5000) * 1000)
    rc = call_fn(
        handle, full_name.encode(), reqb, len(req), attb, len(att),
        timeout_us, ctypes.byref(resp_p), ctypes.byref(resp_len),
        ctypes.byref(ratt_p), ctypes.byref(ratt_len),
        ctypes.byref(err_text))
    try:
        if rc != 0:
            text = err_text.value.decode() if err_text.value else \
                errors.berror(int(rc))
            cntl.set_failed(int(rc), text)
            return None
        payload = ctypes.string_at(resp_p, resp_len.value) \
            if resp_len.value else b""
        if ratt_len.value:
            cntl.response_attachment.append(
                ctypes.string_at(ratt_p, ratt_len.value))
        if response_cls is None:
            return payload
        response = response_cls()
        response.ParseFromString(payload)
        return response
    finally:
        if resp_p:
            lib.brpc_tpu_buf_free(resp_p)
        if ratt_p:
            lib.brpc_tpu_buf_free(ratt_p)
        if err_text:
            lib.brpc_tpu_buf_free(err_text)


class NativeChannel:
    """Client whose datapath is native: serialize in Python once, then the
    frame/write/read/correlate cycle runs in C++ with the GIL released."""

    def __init__(self):
        self._lib = native.load()
        if self._lib is None:
            raise RuntimeError("native core unavailable")
        self._handle = 0

    def init(self, address: str) -> None:
        """address: "host:port" or "ntcp://host:port"."""
        addr = address.split("://", 1)[-1]
        host, _, port = addr.rpartition(":")
        h = self._lib.brpc_tpu_nchannel_connect(host.encode() or b"127.0.0.1",
                                                int(port))
        if h == 0:
            raise ConnectionError(f"cannot connect {address}")
        self._handle = h

    def close(self) -> None:
        if self._handle:
            self._lib.brpc_tpu_nchannel_close(self._handle)
            self._handle = 0

    def call_method(self, full_name: str, cntl: Controller, request: Any,
                    response_cls: Optional[Type] = None):
        """Synchronous call over the native datapath.  Fills cntl error
        state and response_attachment; returns the parsed response."""
        return _marshal_sync_call(self._lib, self._lib.brpc_tpu_nchannel_call,
                                  self._handle, full_name, cntl, request,
                                  response_cls)

    # ---- async completion API (reference: CallMethod with done) -------

    def call_method_async(self, full_name: str, cntl: Controller,
                          request: Any,
                          response_cls: Optional[Type] = None,
                          done: Optional[Callable] = None
                          ) -> "NativeCallFuture":
        """Fire the call and return a future; `done(cntl)` (if given)
        runs on the channel's native reader thread when the response,
        timeout, or failure arrives.  The reference's async CallMethod
        with a done closure."""
        if hasattr(request, "SerializeToString"):
            req = request.SerializeToString()
        else:
            req = bytes(request) if request is not None else b""
        att = cntl.request_attachment.to_bytes() \
            if len(cntl.request_attachment) else b""
        fut = NativeCallFuture(cntl, response_cls, done)
        _inflight_futures[id(fut)] = fut   # pinned until completion: the
        # native side holds only the raw trampoline pointer
        u8p = ctypes.POINTER(ctypes.c_uint8)
        reqb = ctypes.cast(req, u8p) if req else None
        attb = ctypes.cast(att, u8p) if att else None
        timeout_us = int((cntl.timeout_ms or 5000) * 1000)
        # the trampoline AND the request bytes must outlive the call:
        # pinned on the future until completion
        fut._pin = (req, att)
        rc = self._lib.brpc_tpu_nchannel_call_async(
            self._handle, full_name.encode(), reqb, len(req), attb,
            len(att), timeout_us, fut._cb, None)
        # rc != 0 means the failure completed synchronously — the
        # callback already fired and the future is done; callers can
        # check fut.done() to distinguish written-vs-failed-before-write
        return fut


_inflight_futures: Dict[int, "NativeCallFuture"] = {}


class NativeCallFuture:
    """Completion handle for call_method_async: wait() blocks; or poll
    done(); the optional user callback runs on the reader thread."""

    def __init__(self, cntl: Controller, response_cls: Optional[Type],
                 user_done: Optional[Callable]):
        self.cntl = cntl
        self.response = None
        self._response_cls = response_cls
        self._user_done = user_done
        self._event = threading.Event()
        self._cb = _ASYNC_CB(self._on_complete)   # pinned for lifetime
        self._pin = None
        self._once = threading.Lock()
        self._completed = False

    def _on_complete(self, _user, err, err_text, resp_p, resp_len,
                     att_p, att_len):
        # one-shot: belt-and-braces against any native double-fire — the
        # user's done must never run twice
        with self._once:
            if self._completed:
                return
            self._completed = True
        try:
            if err != 0:
                text = err_text.decode() if err_text else \
                    errors.berror(int(err))
                self.cntl.set_failed(int(err), text)
            else:
                payload = ctypes.string_at(resp_p, resp_len) \
                    if resp_len else b""
                if att_len:
                    self.cntl.response_attachment.append(
                        ctypes.string_at(att_p, att_len))
                if self._response_cls is not None:
                    try:
                        resp = self._response_cls()
                        resp.ParseFromString(payload)
                        self.response = self.cntl.response = resp
                    except Exception as e:
                        self.cntl.set_failed(
                            errors.ERESPONSE, f"bad response: {e}")
                else:
                    self.response = self.cntl.response = payload
        finally:
            self._pin = None
            _inflight_futures.pop(id(self), None)
            self._event.set()
            if self._user_done is not None:
                try:
                    self._user_done(self.cntl)
                except Exception as e:     # never raise across ctypes
                    log.error("async done callback raised: %s", e,
                              exc_info=True)

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)


class NativePooledChannel:
    """N native connections round-robined per call (reference pooled
    sockets, socket.h:256-262): concurrent large requests overlap in the
    kernel instead of serializing on one stream."""

    def __init__(self):
        self._lib = native.load()
        if self._lib is None:
            raise RuntimeError("native core unavailable")
        self._handle = 0

    def init(self, address: str, nconns: int = 4) -> None:
        addr = address.split("://", 1)[-1]
        host, _, port = addr.rpartition(":")
        h = self._lib.brpc_tpu_npool_connect(
            host.encode() or b"127.0.0.1", int(port), nconns)
        if h == 0:
            raise ConnectionError(f"cannot connect {address}")
        self._handle = h

    def close(self) -> None:
        if self._handle:
            self._lib.brpc_tpu_npool_close(self._handle)
            self._handle = 0

    def call_method(self, full_name: str, cntl: Controller, request: Any,
                    response_cls: Optional[Type] = None):
        return _marshal_sync_call(self._lib, self._lib.brpc_tpu_npool_call,
                                  self._handle, full_name, cntl, request,
                                  response_cls)
