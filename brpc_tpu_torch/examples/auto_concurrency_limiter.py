"""The auto concurrency limiter under overload
(example/auto_concurrency_limiter): eight threads call a 2 ms echo whose
method's max concurrency is "auto"; the limiter rejects what exceeds the
concurrency it measured.

    python -m brpc_tpu_torch.examples.auto_concurrency_limiter        # card
    python -m brpc_tpu_torch.examples.auto_concurrency_limiter --device cpu
"""
from __future__ import annotations

import sys
import threading

from brpc_tpu_torch import rpc
from brpc_tpu_torch.examples.common import (EchoRequest, EchoResponse,
                                            EchoService, parse_device,
                                            setup_mesh)


def main(argv=None) -> int:
    setup_mesh(parse_device(argv, __doc__))
    opts = rpc.ServerOptions()
    opts.method_max_concurrency = {"EchoService.Echo": "auto"}
    server = rpc.Server(opts)
    server.add_service(EchoService())
    ch = rpc.Channel()
    oks = [0]
    limited = [0]
    lock = threading.Lock()

    def worker():
        for _ in range(30):
            cntl = rpc.Controller()
            ch.call_method("EchoService.Echo", cntl,
                           EchoRequest(message="x", sleep_us=2000),
                           EchoResponse)
            with lock:
                if cntl.failed():
                    limited[0] += 1
                else:
                    oks[0] += 1

    try:
        if server.start("mem://example-autolimit") != 0:
            return 1
        ch.init("mem://example-autolimit",
                options=rpc.ChannelOptions(timeout_ms=3000))
        ts = [threading.Thread(target=worker) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        st = server.method_status("EchoService.Echo")
        print(f"ok={oks[0]} rejected={limited[0]} "
              f"adaptive max_concurrency={st.limiter.max_concurrency()}")
        return 0 if oks[0] > 0 and oks[0] + limited[0] == 240 else 1
    finally:
        ch.close()
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
