"""Shared scaffolding of the port's examples: the mesh they run on, an
in-process echo server, and a merger that joins echoed messages.  Each
example runs on the card unless ``--device cpu`` is given; on a CPU mesh
the device plane is engaged with ``ici_device_plane_host_mesh``, so a
DEVICE attachment still crosses on ``p2p_copy``'s plain version."""
from __future__ import annotations

import argparse
import time

import brpc_tpu_torch.policy  # noqa: F401  (registers tpu_std)
from brpc_tpu_torch import channels, rpc
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse

__all__ = ["EchoRequest", "EchoResponse", "EchoService", "ConcatMerger",
           "parse_device", "setup_mesh", "start_echo_server"]


class EchoService(rpc.Service):
    """Echoes the message behind its tag and returns the attachment."""

    SERVICE_NAME = "EchoService"

    def __init__(self, tag: str = ""):
        self.tag = tag
        self.calls = 0

    @rpc.method(EchoRequest, EchoResponse)
    def Echo(self, cntl, request, response, done):
        self.calls += 1
        if request.sleep_us:
            time.sleep(request.sleep_us / 1e6)
        response.message = (self.tag + ":" if self.tag else "") \
            + request.message
        if len(cntl.request_attachment):
            cntl.response_attachment.append(cntl.request_attachment)
        done()


class ConcatMerger(channels.ResponseMerger):
    def merge(self, response, sub_response):
        response.message = (response.message + "|" + sub_response.message
                            if response.message else sub_response.message)
        return self.MERGED


def start_echo_server(addr: str, tag: str = "") -> rpc.Server:
    server = rpc.Server()
    server.add_service(EchoService(tag))
    rc = server.start(addr)
    assert rc == 0, f"server start failed: {rc}"
    return server


def parse_device(argv, doc: str) -> str:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the mesh and its tensors live")
    return ap.parse_args(argv).device


def setup_mesh(device: str):
    """IciMesh(ranks=8) on ``device``, made the default, with every
    attachment of 4 KiB or more riding the device plane."""
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.ici.mesh import IciMesh
    mesh = IciMesh(ranks=8, device=device)
    IciMesh.set_default(mesh)
    flags.set_flag("ici_device_plane_host_mesh", device == "cpu")
    flags.set_flag("ici_device_plane_threshold", 4096)
    return mesh
