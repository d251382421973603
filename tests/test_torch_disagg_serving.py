"""The slice as a whole: disaggregated prefill/decode serving on the port,
held against the JAX package on the CPU.

The in-process stack on ``IciMesh(ranks=8, device="cpu")`` with the
device plane engaged (``ici_device_plane_host_mesh``, 64 KiB threshold):
prefill on ``ici://1``, decode on ``ici://2`` and ``ici://3``, the router
on ``mem://``.  Generate tokens must equal the JAX package's
``reference_generate`` exactly, the port's prefill bytes must equal JAX's
``toy_kv_blocks``, every LoadKv must ride the plane, ``mode=sync`` must
equal the batched result, and a JAX-prefilled KV carried across by
``convert.kv_from_numpy`` must decode to JAX's ``toy_decode`` tokens.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import rpc
from brpc_tpu_torch.butil import flags as fl
from brpc_tpu_torch.convert import kv_from_numpy
from brpc_tpu_torch.examples.disagg_serving import model as tmodel
from brpc_tpu_torch.examples.disagg_serving.workers import (
    close_services, start_decode_worker, start_prefill_worker, start_router)
from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc.controller import server_controller_pool
from examples.disagg_serving import model as jmodel

_FLAGS = ("ici_device_plane", "ici_device_plane_host_mesh",
          "ici_device_plane_threshold")
ROUTER = "mem://port-disagg"


def _port_idle():
    return (not rpc.list_sockets() and server_controller_pool.live() == 0
            and dp.plane().active_transfers() == 0)


@pytest.fixture(scope="module")
def stack():
    """The serving stack, torn down with every pool drained and every
    scheduler stopped; the port's own pools must then be empty."""
    mesh = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(mesh)
    saved = {n: fl.get_flag(n) for n in _FLAGS}
    fl.set_flag("ici_device_plane", True)
    fl.set_flag("ici_device_plane_host_mesh", True)
    fl.set_flag("ici_device_plane_threshold", 64 * 1024)
    prefill = start_prefill_worker("ici://1")
    decodes = [start_decode_worker("ici://2"), start_decode_worker("ici://3")]
    router = start_router(ROUTER, "ici://1", ["ici://2", "ici://3"])
    ch = rpc.Channel()
    ch.init(ROUTER, options=rpc.ChannelOptions(timeout_ms=60000, max_retry=0))
    yield {"mesh": mesh, "prefill": prefill, "decodes": decodes,
           "router": router, "ch": ch}
    ch.close()
    close_services(router, prefill, *decodes)
    for n, v in saved.items():
        fl.set_flag(n, v)
    IciMesh.set_default(None)
    deadline = time.monotonic() + 2.0
    while not _port_idle() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert _port_idle(), (rpc.list_sockets(), server_controller_pool.live(),
                          dp.plane().active_transfers())


def _svc(server):
    return next(iter(server.services().values()))


def _loads(stack):
    return sum(_svc(d).loads for d in stack["decodes"])


def _generate(ch, tokens, steps, **extra):
    cntl = rpc.Controller()
    resp = ch.call_method("Router.Generate", cntl, EchoRequest(
        message=json.dumps({"tokens": tokens, "steps": steps, **extra})),
        EchoResponse)
    assert not cntl.failed(), cntl.error_text
    return json.loads(resp.message)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, jmodel.VOCAB, n).tolist()


@pytest.mark.parametrize("n", [64, 128, 512])
def test_prefill_bytes_equal_jax(n):
    tokens = _prompt(n, n)
    assert np.array_equal(tmodel.toy_kv_blocks(tokens, "cpu").numpy(),
                          np.asarray(jmodel.toy_kv_blocks(tokens)))


def test_generate_equals_jax_reference_over_the_plane(stack):
    plane = dp.plane()
    before, loads0 = plane.stats()["transfers"], _loads(stack)
    for i, n in enumerate((64, 96, 200, 512)):
        tokens = _prompt(100 + i, n)
        out = _generate(stack["ch"], tokens, 12)
        assert out["tokens"] == jmodel.reference_generate(tokens, 12)
        assert out["kv_bytes"] == jmodel.kv_nbytes(n)
    loads = _loads(stack) - loads0
    assert loads == 4
    # every KV (>= 64 KiB) rode the plane; nothing else did
    assert plane.stats()["transfers"] - before == loads
    # decode released every session after its Decode
    assert all(_svc(d).live_sessions() == 0 for d in stack["decodes"])
    assert _svc(stack["prefill"]).handoff_bytes >= sum(
        jmodel.kv_nbytes(n) for n in (64, 96, 200, 512))


def test_concurrent_generates_share_the_batched_step(stack):
    prompts = [_prompt(200 + i, 64 + 16 * i) for i in range(8)]
    outs = [None] * len(prompts)

    def run(i):
        outs[i] = _generate(stack["ch"], prompts[i], 9)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    for tokens, out in zip(prompts, outs):
        assert out["tokens"] == jmodel.reference_generate(tokens, 9)
    picks = _svc(stack["router"]).describe_serving()["router"]["picks"]
    assert set(picks) <= {"ici://2", "ici://3"}


def test_sync_mode_equals_batched(stack):
    tokens = _prompt(7, 80)
    batched = _generate(stack["ch"], tokens, 10)
    sync = _generate(stack["ch"], tokens, 10, mode="sync")
    assert sync["tokens"] == batched["tokens"] == \
        jmodel.reference_generate(tokens, 10)


def test_jax_prefill_carried_by_kv_from_numpy_decodes_like_jax(stack):
    """State carried across: JAX's prefill bytes, owned by rank 1 of the
    port's mesh, go through the port's LoadKv (over the plane) and decode
    to JAX's toy_decode tokens, batched and sync."""
    mesh = stack["mesh"]
    tokens = _prompt(9, 96)
    jkv = np.asarray(jmodel.toy_kv_blocks(tokens))
    want = jmodel.toy_decode(jkv, len(tokens), tokens[-1], 16)
    before = dp.plane().stats()["transfers"]
    ch = rpc.Channel()
    ch.init("ici://2", options=rpc.ChannelOptions(
        timeout_ms=30000, max_retry=0))
    try:
        for session, mode in (("carried", None), ("carried-sync", "sync")):
            kv = kv_from_numpy(jkv, mesh, 1)
            assert mesh.rank_of(kv) == 1
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(kv)
            ch.call_method("Decode.LoadKv", cntl, EchoRequest(
                message=json.dumps({"session": session,
                                    "seq_len": len(tokens),
                                    "last_token": tokens[-1]})),
                EchoResponse)
            assert not cntl.failed(), cntl.error_text
            cntl = rpc.Controller()
            resp = ch.call_method("Decode.Decode", cntl, EchoRequest(
                message=json.dumps({"session": session, "steps": 16,
                                    **({"mode": mode} if mode else {})})),
                EchoResponse)
            assert not cntl.failed(), cntl.error_text
            assert json.loads(resp.message)["tokens"] == want
    finally:
        ch.close()
    assert dp.plane().stats()["transfers"] - before == 2


@pytest.mark.parametrize("n", [512, 2048])
def test_loadkv_over_the_plane_lands_the_bytes_sent(stack, n):
    """The KV handoff's bytes, byte for byte: a LoadKv of the port's
    prefill (512 KiB and 2 MiB, the serving path's two handoff sizes)
    rides the plane, and the session's rows in the pool equal the
    token-major permute of JAX's prefill of the same prompt."""
    mesh = stack["mesh"]
    tokens = _prompt(300 + n, n)
    want = np.asarray(jmodel.toy_kv_blocks(tokens)).reshape(
        jmodel.KV_LAYERS, n, jmodel.KV_DMODEL).transpose(1, 0, 2).reshape(
        n, -1)
    session = f"bytes{n}"
    before = dp.plane().stats()["transfers"]
    ch = rpc.Channel()
    ch.init("ici://3", options=rpc.ChannelOptions(
        timeout_ms=30000, max_retry=0))
    pool = _svc(stack["decodes"][1]).pool
    try:
        kv = mesh.own(tmodel.toy_kv_blocks(tokens, mesh.device(1)), 1)
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(kv)
        ch.call_method("Decode.LoadKv", cntl, EchoRequest(
            message=json.dumps({"session": session, "seq_len": n,
                                "last_token": tokens[-1]})), EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert dp.plane().stats()["transfers"] - before == 1
        assert np.array_equal(pool.materialize(session).numpy(), want)
    finally:
        pool.release(session)
        ch.close()


def test_loadkv_refuses_a_size_mismatch_and_decode_an_unknown_session(
        stack):
    ch = rpc.Channel()
    ch.init("ici://3", options=rpc.ChannelOptions(
        timeout_ms=30000, max_retry=0))
    try:
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(
            stack["mesh"].device_put(torch.zeros(4096, dtype=torch.uint8), 1))
        ch.call_method("Decode.LoadKv", cntl, EchoRequest(
            message=json.dumps({"session": "bad", "seq_len": 3,
                                "last_token": 0})), EchoResponse)
        assert cntl.error_code == rpc.errors.EREQUEST
        cntl = rpc.Controller()
        ch.call_method("Decode.Decode", cntl, EchoRequest(
            message=json.dumps({"session": "ghost", "steps": 2})),
            EchoResponse)
        assert cntl.error_code == rpc.errors.EREQUEST
        assert "unknown session" in cntl.error_text
    finally:
        ch.close()


def test_decode_pools_live_on_their_ranks_devices(stack):
    for d in stack["decodes"]:
        svc = _svc(d)
        assert svc.pool.device == stack["mesh"].device(svc.rank)
        assert svc.describe_serving()["pool"]["device"] == "cpu"


def test_saturated_pool_sheds_with_a_retry_hint(stack):
    """A KV larger than the decode pool: LoadKv sheds with ELIMIT and the
    20 ms retry hint, which crosses the wire to the caller."""
    from brpc_tpu_torch.serving import KvPoolOptions
    small = start_decode_worker("ici://5", pool_options=KvPoolOptions(
        bytes_per_token=tmodel.KV_LAYERS * tmodel.KV_DMODEL, num_blocks=4,
        block_tokens=16))
    ch = rpc.Channel()
    ch.init("ici://5", options=rpc.ChannelOptions(
        timeout_ms=30000, max_retry=0))
    try:
        tokens = _prompt(5, 80)                 # 5 blocks > 4
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(stack["mesh"].own(
            tmodel.toy_kv_blocks(tokens, "cpu"), 1))
        ch.call_method("Decode.LoadKv", cntl, EchoRequest(
            message=json.dumps({"session": "big", "seq_len": len(tokens),
                                "last_token": tokens[-1]})), EchoResponse)
        assert cntl.error_code == rpc.errors.ELIMIT
        assert cntl.retry_after_ms == 20
        assert "saturated" in cntl.error_text
        assert _svc(small).pool.describe()["blocks_free"] == 4
    finally:
        ch.close()
        close_services(small)
