"""The live legs of ``tests/test_foreign_interop.py`` on both packages,
over ``brpc_tpu`` and over ``brpc_tpu_torch`` (``tests/torch_mirror.py``,
no swap): grpcio's client against the server twice on one connection,
UNIMPLEMENTED for an unknown method, the gRPC channel against a
``grpc.server()``, and curl's h2c and chunked HTTP/1.1 echoes.  They skip
as the JAX file does: without grpcio (``pytest.importorskip("grpc")``) or
without ``curl`` on the path.  The transcript fixture's decode is in
``tests/test_torch_grpc.py``.
"""
from __future__ import annotations

import brpc_tpu.policy  # noqa: F401  (registers protocols)
import brpc_tpu_torch.policy  # noqa: F401
from tests import torch_mirror
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

torch_mirror.mirror("tests/test_foreign_interop.py", globals(),
                    names=["TestGrpcioInterop", "TestCurlH2Interop"])
