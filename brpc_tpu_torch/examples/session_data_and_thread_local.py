"""Session-local and thread-local server data
(example/session_data_and_thread_local): a handler borrows a pooled
object per request (``ServerOptions.session_local_data_factory``, read
with ``Controller.session_local_data()``) and keeps one per worker thread
(``thread_local_data_factory``, read with ``Server.thread_local_data()``).

    python -m brpc_tpu_torch.examples.session_data_and_thread_local
    python -m brpc_tpu_torch.examples.session_data_and_thread_local \\
        --device cpu
"""
from __future__ import annotations

import itertools
import sys
import threading

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            parse_device, setup_mesh)

_session_seq = itertools.count()
_thread_seq = itertools.count()


class SessionData:
    def __init__(self):
        self.id = next(_session_seq)
        self.uses = 0


class ThreadData:
    def __init__(self):
        self.id = next(_thread_seq)
        self.thread = threading.current_thread().name


class StatefulEcho(rpc.Service):
    def __init__(self):
        self.seen = []

    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        sd = cntl.session_local_data()        # pooled, lent per request
        sd.uses += 1
        td = cntl.server.thread_local_data()  # one per worker thread
        self.seen.append((sd.id, sd.uses, td.id))
        response.message = f"session={sd.id} use#{sd.uses} thread={td.id}"
        done()


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    opts = rpc.ServerOptions(session_local_data_factory=SessionData,
                             thread_local_data_factory=ThreadData)
    server = rpc.Server(opts)
    svc = StatefulEcho()
    server.add_service(svc)
    assert server.start("ici://1") == 0
    ch = rpc.Channel()
    try:
        ch.init("ici://1", options=rpc.ChannelOptions(timeout_ms=1000))
        for i in range(5):
            cntl = rpc.Controller()
            resp = ch.call_method("StatefulEcho.Echo", cntl,
                                  EchoRequest(message=str(i)),
                                  EchoResponse)
            if cntl.failed():
                print(f"call failed: {cntl.error_text}")
                return 1
            print("->", resp.message)
        # sequential calls reuse the pooled session object: its uses climb
        # while the factory ran once
        sessions = {sid for sid, _, _ in svc.seen}
        return 0 if len(sessions) == 1 and svc.seen[-1][1] == 5 else 1
    finally:
        ch.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
