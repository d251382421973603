"""Card-only tests of the port: the p2p_copy and ring kernels, the
device plane and the sharded layout on a CUDA mesh, and the serving pool,
KV fill and batched step on the card against the same on the CPU.  A CUDA kernel has no
CPU mode, so every test here carries the ``cuda`` marker and skips without
a card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed.  On the card, without the repository's conftest
(which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import sys
import threading

import numpy as np
import pytest
import torch

from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.ici import pallas_ring
from brpc_tpu_torch.ici.collective import Collectives
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.ici.p2p_copy import P2PCopy, p2p_copy, p2p_copy_plain
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.examples.disagg_serving import model
from brpc_tpu_torch import serving


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _seeded(nbytes: int) -> np.ndarray:
    return np.random.default_rng(nbytes).integers(0, 256, nbytes,
                                                  dtype=np.uint8)


@pytest.mark.cuda
def test_kernel_launch_matches_plain_version(cuda_device):
    kern = P2PCopy()
    for offset, n in ((0, 4096), (3, 65537), (0, 4 << 20)):
        data = torch.from_numpy(_seeded(offset + n)).to(cuda_device)
        src = data[offset:]
        out = kern(src, torch.empty(n, dtype=torch.uint8, device=cuda_device))
        torch.cuda.synchronize()
        assert torch.equal(out, p2p_copy_plain(src, torch.empty_like(out)))
    assert kern.launches == 3


def _copy_matches_plain(kern, dev, n, src_offset=0, dst_offset=0):
    """Copy n seeded bytes from ``src_offset`` into a slice ``dst_offset``
    bytes into a guarded buffer; the slice must equal the plain version's
    copy and the guard bytes around it must be untouched."""
    data = torch.from_numpy(_seeded(src_offset + n)).to(dev)
    src = data[src_offset:]
    guard = torch.full((dst_offset + n + 32,), 0xA5, dtype=torch.uint8,
                       device=dev)
    dst = guard[dst_offset:dst_offset + n]
    kern(src, dst)
    ref = p2p_copy_plain(src, torch.empty(n, dtype=torch.uint8, device=dev))
    torch.cuda.synchronize()
    where = f"n={n} src+{src_offset} dst+{dst_offset}"
    assert torch.equal(dst, ref), where
    assert bool((guard[:dst_offset] == 0xA5).all()), where
    assert bool((guard[dst_offset + n:] == 0xA5).all()), where


# The byte counts at which the kernel's launch changes shape: the first
# whole 16-byte chunk, and the second and third 256-thread block (a block
# copies one 4 KiB unit).
_SHAPE_EDGES = (16, 4096, 8192)


@pytest.mark.cuda
def test_launch_shape_edges_are_bit_exact(cuda_device):
    """Each byte count where the launch changes shape, and one byte either
    side, aligned and with a source off dst's 16-byte phase."""
    kern = P2PCopy()
    for edge in _SHAPE_EDGES:
        for n in (edge - 1, edge, edge + 1):
            for src_offset in (0, 3):
                _copy_matches_plain(kern, cuda_device, n, src_offset)
    assert kern.launches == 6 * len(_SHAPE_EDGES)


@pytest.mark.cuda
@pytest.mark.parametrize("dst_offset", [0, 7])
@pytest.mark.parametrize("src_offset", range(16))
def test_every_source_phase_is_bit_exact(cuda_device, src_offset,
                                         dst_offset):
    """Every source phase 0-15 against destinations at offsets 0 and 7,
    at a size of one block and a size of many blocks."""
    kern = P2PCopy()
    for n in (4099, (1 << 20) + 4099):
        _copy_matches_plain(kern, cuda_device, n, src_offset, dst_offset)
    assert kern.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("n", [
    15,                           # edge bytes only, no whole chunk
    3 * 4096 + 48,                # a partial last block
    7 * 4096 + 15,                # whole blocks and a tail
    (40 << 20) + 16 * 3 + 5,      # a partial last block and a tail
], ids=["edges-only", "partial-block", "tail", "40MiB"])
def test_partial_last_block_is_bit_exact(cuda_device, n):
    kern = P2PCopy()
    _copy_matches_plain(kern, cuda_device, n, 0, 0)
    _copy_matches_plain(kern, cuda_device, n, 5, 5)
    assert kern.launches == 2


@pytest.mark.cuda
def test_launches_stay_exact_when_two_threads_launch_at_once(cuda_device):
    """The caller thread and the plane's poller may launch at once: the
    counter must count every launch."""
    kern = P2PCopy()
    calls = 400
    src = torch.from_numpy(_seeded(4096)).to(cuda_device)
    start = threading.Barrier(2)
    errors = []

    def worker():
        try:
            stream = torch.cuda.Stream(cuda_device)
            dst = torch.empty_like(src)
            with torch.cuda.stream(stream):
                start.wait(30)
                for _ in range(calls):
                    kern(src, dst)
            stream.synchronize()
            assert torch.equal(dst, src)
        except Exception as e:        # noqa: BLE001 - reported below
            errors.append(e)

    kern.record(cuda_device.index)          # build before the race
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert kern.launches == 2 * calls


@pytest.mark.cuda
def test_plane_moves_exact_bytes_between_ranks_of_one_card(cuda_device):
    """One rendezvous on a CUDA mesh: one kernel launch, the output owned
    by the dst rank, the source pin released once at completion."""
    mesh = IciMesh(ranks=8, device="cuda")
    plane = dp.plane()
    data = _seeded(65537)
    src = mesh.device_put(torch.from_numpy(data).to(cuda_device), 1)
    released = []
    launches0, transfers0 = p2p_copy.launches, plane.stats()["transfers"]
    t = plane.post_send(src, 1, 0, mesh=mesh)
    t.add_source_release(lambda: released.append(1))
    plane.post_recv(t.uuid)
    assert t.wait(30) == 0
    assert t.state == dp.COMPLETE
    assert released == [1]
    assert mesh.rank_of(t.out) == 0
    np.testing.assert_array_equal(t.out.cpu().numpy(), data)
    assert p2p_copy.launches - launches0 == 1
    assert plane.stats()["transfers"] - transfers0 == 1
    assert plane.active_transfers() == 0


def _ring_rows(dev, n, chunk, dtype, offset=0):
    """n seeded rows of mixed magnitude; ``offset`` elements into a larger
    buffer, so offset 1 gives rows that are not 16-byte aligned."""
    rng = np.random.default_rng(n * 1000 + chunk)
    x = (rng.standard_normal((n, chunk))
         * 10.0 ** rng.integers(-4, 5, (n, chunk)))
    rows = []
    for r in range(n):
        buf = torch.empty(chunk + offset, dtype=dtype, device=dev)
        buf[offset:] = torch.from_numpy(x[r].astype(np.float32)).to(dev)
        rows.append(buf[offset:])
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("n,chunk,dtype,offset", [
    (8, 4096, torch.float32, 0),
    (8, 1003, torch.float32, 0),         # ragged tail
    (8, 4096, torch.bfloat16, 0),
    (8, 1000, torch.float16, 0),
    (8, 4096, torch.float32, 1),         # rows not 16-byte aligned
    (2, 513, torch.float32, 0),
    (3, 4096, torch.bfloat16, 0),
    (20, 4096, torch.float32, 0),        # past the register path
], ids=["f32", "ragged", "bf16", "f16", "misaligned", "n2", "n3", "n20"])
def test_ring_kernels_match_their_plain_versions(cuda_device, n, chunk, dtype,
                                                 offset):
    rows = _ring_rows(cuda_device, n, chunk, dtype, offset)
    red, gat = pallas_ring.RingAllReduce(), pallas_ring.RingAllGather()
    out = red(rows, [torch.empty(chunk, dtype=dtype, device=cuda_device)
                     for _ in range(n)])
    ref = pallas_ring.ring_all_reduce_plain(
        rows, [torch.empty(chunk, dtype=dtype, device=cuda_device)
               for _ in range(n)])
    gout = gat(rows, [torch.empty(n, chunk, dtype=dtype, device=cuda_device)
                      for _ in range(n)])
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    for g in gout:
        assert torch.equal(g, torch.stack(rows))
    assert red.launches == gat.launches == 1


@pytest.mark.cuda
def test_ring_kernel_int32_wraps_like_the_plain_version(cuda_device):
    rows = [torch.full((100,), 2**31 - 1 - r, dtype=torch.int32,
                       device=cuda_device) for r in range(8)]
    out = pallas_ring.ring_all_reduce_kernel(
        rows, [torch.empty_like(t) for t in rows])
    ref = pallas_ring.ring_all_reduce_plain(
        rows, [torch.empty_like(t) for t in rows])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.cuda
def test_sharded_rows_are_owned_by_their_ranks_on_the_card(cuda_device):
    mesh = IciMesh(ranks=8, device="cuda")
    coll = Collectives(mesh)
    xs = coll.shard(torch.arange(8 * 5, dtype=torch.float32).reshape(8, 5))
    assert xs.device.type == "cuda"
    assert [mesh.rank_of(xs.row(r)) for r in range(8)] == list(range(8))
    launches = pallas_ring.ring_all_reduce_kernel.launches
    out = pallas_ring.ring_all_reduce(xs)
    assert pallas_ring.ring_all_reduce_kernel.launches == launches + 1
    assert [mesh.rank_of(t) for t in out] == list(range(8))
    assert torch.equal(out.row(3), coll.all_reduce(xs))  # integers: exact


def _serving_pair(dev):
    """The same pool and scheduler on the card and on the CPU."""
    sides = []
    for d in (dev, torch.device("cpu")):
        pool = serving.PagedKvPool(serving.KvPoolOptions(
            bytes_per_token=model.KV_LAYERS * model.KV_DMODEL,
            num_blocks=96, block_tokens=16, use_timers=False), device=d)
        sched = serving.ContinuousBatchScheduler(
            pool, serving.BatchSchedulerOptions(
                vocab=model.VOCAB, max_batch=8, auto_start=False))
        sides.append((pool, sched))
    return sides


@pytest.mark.cuda
def test_serving_pool_and_step_on_the_card_equal_the_cpu(cuda_device):
    """One set of KV bytes (made on the CPU) loaded through a DEVICE
    attachment into a pool on the card and one on the CPU: blocks, bytes,
    accumulators and the batched step's tokens must agree exactly, and
    the step's tensors must be on the card."""
    sides = _serving_pair(cuda_device)
    prompts = {f"s{i}": [(31 * i + 7 * j) % 997 for j in range(40 + 53 * i)]
               for i in range(6)}
    prompts["shared"] = prompts["s5"][:64] + [1, 2, 3]   # prefix hits
    sinks = [{}, {}]
    try:
        for (pool, sched), sink in zip(sides, sinks):
            for s, tokens in prompts.items():
                wire = model.toy_kv_blocks(tokens, "cpu").to(pool.device)
                att = IOBuf()
                att.append_device_array(wire)
                serving.load_wire_attachment(
                    pool, att, s, len(tokens), model.KV_LAYERS,
                    model.KV_DMODEL, last_token=tokens[-1])
                sink[s] = []
                sched.submit(serving.StepRequest(
                    s, 20 + len(tokens) % 7, sink[s].extend,
                    lambda *a: None))
        (cpool, csched), (hpool, hsched) = sides
        for s in prompts:
            a, b = cpool.get(s), hpool.get(s)
            assert list(a.blocks) == list(b.blocks) and a.acc == b.acc
            assert torch.equal(cpool.materialize(s).cpu(),
                               hpool.materialize(s))
        assert cpool.describe()["prefix"]["prefix_hits"] == \
            hpool.describe()["prefix"]["prefix_hits"] > 0
        assert cpool._store.is_cuda and cpool.pos_sums_flat.is_cuda
        assert torch.equal(cpool.pos_sums_flat.cpu(), hpool.pos_sums_flat)
        for _ in range(40):
            assert csched.step_once() == hsched.step_once()
            if csched.active():
                assert all(t.is_cuda for t in csched.roster_tensors())
        for s, tokens in prompts.items():
            assert sinks[0][s] == sinks[1][s] != []
            wire = model.toy_kv_blocks(tokens, "cpu")
            assert sinks[0][s] == model.toy_decode(
                wire, len(tokens), tokens[-1], len(sinks[0][s]))
    finally:
        for pool, sched in sides:
            sched.stop()
            pool.close()


@pytest.mark.cuda
def test_toy_decode_on_the_card_equals_the_cpu_on_the_same_bytes(
        cuda_device):
    tokens = [(5 * j + 3) % 997 for j in range(512)]
    kv = model.toy_kv_blocks(tokens, cuda_device)
    assert kv.is_cuda and kv.dtype == torch.uint8
    assert model.toy_decode(kv, 512, tokens[-1], 32) == \
        model.toy_decode(kv.cpu(), 512, tokens[-1], 32)


@pytest.mark.cuda
def test_spill_and_restore_between_the_card_and_pinned_memory(cuda_device):
    """The host tier on the card: the host arena is pinned, pressure
    demotes through a device-to-host copy, a touch restores through a
    host-to-device copy, and every session's bytes and accumulator come
    back exactly as the same operations leave them on the CPU."""
    bpt = model.KV_LAYERS * model.KV_DMODEL
    pools = [serving.PagedKvPool(serving.KvPoolOptions(
        bytes_per_token=bpt, num_blocks=16, block_tokens=16, host_blocks=64,
        use_timers=False), device=d)
        for d in (cuda_device, torch.device("cpu"))]
    try:
        assert pools[0]._host_store.is_pinned()
        prompts = {f"s{i}": [(13 * i + 5 * j) % 997 for j in range(60 + 9 * i)]
                   for i in range(8)}
        for pool in pools:
            for s, tokens in prompts.items():
                rows = model.toy_kv_blocks(tokens, "cpu").view(
                    model.KV_LAYERS, len(tokens), model.KV_DMODEL).permute(
                    1, 0, 2).reshape(len(tokens), bpt)
                pool.load(s, rows.to(pool.device), last_token=tokens[-1])
        card, host = pools
        assert card.spilled_sessions() == host.spilled_sessions() != []
        for s, tokens in prompts.items():
            a, b = card.get(s), host.get(s)
            assert a.acc == b.acc and list(a.blocks) == list(b.blocks)
            rows = model.toy_kv_blocks(tokens, "cpu").view(
                model.KV_LAYERS, len(tokens), model.KV_DMODEL).permute(
                1, 0, 2).reshape(len(tokens), bpt)
            assert torch.equal(card.materialize(s).cpu(), rows)
        dc, dh = (p.describe()["tiers"] for p in pools)
        for k in ("demotions", "restores", "spilled_sessions",
                  "host_blocks_free", "restore_corrupt"):
            assert dc[k] == dh[k], k
        assert dc["restores"] > 0 and dc["demote_bytes"] > 0
        assert torch.equal(card.pos_sums_flat.cpu(), host.pos_sums_flat)
    finally:
        for pool in pools:
            pool.close()


@pytest.mark.cuda
def test_migration_between_two_ranks_launches_once_per_migrate_in(
        cuda_device):
    """A live migration between two decode ranks of one card: the payload
    rides the device plane, p2p_copy launches once per MigrateIn call
    received, the destination holds the bytes and the source lets go."""
    import json
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.examples.disagg_serving.workers import (
        close_services, start_decode_worker)
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    mesh = IciMesh(ranks=8, device="cuda")
    IciMesh.set_default(mesh)
    bpt = model.KV_LAYERS * model.KV_DMODEL
    a = start_decode_worker("ici://2", mesh=mesh)
    b = start_decode_worker("ici://3", mesh=mesh)
    src, dst = (next(iter(w.services().values())) for w in (a, b))
    ch = rpc.Channel()
    ch.init("ici://2", options=rpc.ChannelOptions(
        timeout_ms=60000, max_retry=0))
    try:
        tokens = [(7 * j + 1) % 997 for j in range(512)]
        rows = model.toy_kv_blocks(tokens, cuda_device).view(
            model.KV_LAYERS, 512, model.KV_DMODEL).permute(1, 0, 2).reshape(
            512, bpt)
        src.pool.load("mv", rows, last_token=tokens[-1])
        p2p_copy.record(cuda_device.index)
        torch.cuda.synchronize()
        launches0, received0 = p2p_copy.launches, dst.migrate_in_received
        transfers0 = dp.plane().stats()["transfers"]
        cntl = rpc.Controller()
        resp = ch.call_method("Decode.MigrateOut", cntl, EchoRequest(
            message=json.dumps({"session": "mv", "dest": "ici://3"})),
            EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert json.loads(resp.message)["migrated"]
        torch.cuda.synchronize()
        received = dst.migrate_in_received - received0
        assert received == 1
        assert p2p_copy.launches - launches0 == received == \
            dp.plane().stats()["transfers"] - transfers0
        assert src.pool.get("mv") is None
        assert torch.equal(dst.pool.materialize("mv"), rows)
        assert dst.pool._store.is_cuda
    finally:
        ch.close()
        close_services(a, b)
        IciMesh.set_default(None)


def _echo_server(addr, options=None, block=None):
    """A port server whose Echo returns the attachment; ``block`` (an
    Event) parks requests whose message is "block"."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse

    class Echo(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            if block is not None and request.message == "block":
                block.wait(30)
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    server = rpc.Server(options)
    server.add_service(Echo())
    assert server.start(addr) == 0
    return server


@pytest.mark.cuda
def test_drain_gate_waits_for_the_copy_on_the_card(cuda_device):
    """A lame-duck stop waits until the completion poller has seen a
    launched p2p_copy's event, not just until post_recv returned: the
    copy is held back on the device behind a spin, and stop() returns
    with the transfer COMPLETE and its bytes exact."""
    import time
    from brpc_tpu_torch.tools.timing import spin_cycles_per_us
    mesh = IciMesh(ranks=8, device="cuda")
    plane = dp.plane()
    data = _seeded(4 << 20)
    src = mesh.device_put(torch.from_numpy(data).to(cuda_device), 1)
    server = _echo_server("mem://card-drain")
    try:
        cycles = spin_cycles_per_us()
        torch.cuda.synchronize()
        # the plane stream starts after the event posted behind the spin
        torch.cuda._sleep(int(300_000 * cycles))
        t = plane.post_send(src, 1, 0, mesh=mesh)
        plane.post_recv(t.uuid)
        assert t.state == dp.MATCHED and plane.active_transfers() >= 1
        t0 = time.monotonic()
        server.stop(5.0)
        dt = time.monotonic() - t0
        assert t.state == dp.COMPLETE, t.state
        assert plane.active_transfers() == 0
        assert 0.1 <= dt < 5.0, dt
        np.testing.assert_array_equal(t.out.cpu().numpy(), data)
    finally:
        server.stop()


@pytest.mark.cuda
def test_fail_pending_releases_the_source_pin_on_the_card(cuda_device):
    """A grace expiry fails a send that never met its recv: the transfer
    fails, its release fires, and the source's device memory is freed
    (memory back to its level)."""
    import gc
    mesh = IciMesh(ranks=8, device="cuda")
    plane = dp.plane()
    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated(cuda_device)
    src = mesh.own(torch.full((64 << 20,), 7, dtype=torch.uint8,
                              device=cuda_device), 1)
    released = []
    t = plane.post_send(src, 1, 0, mesh=mesh)
    t.add_source_release(lambda: released.append(1))
    del src
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda_device) >= base + (64 << 20)
    server = _echo_server("mem://card-straggle")
    server.stop(0.2)
    assert t.state == dp.FAILED and released == [1]
    assert plane.pending_sends() == 0 and plane.active_transfers() == 0
    t = None
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda_device) - base < (1 << 20)


@pytest.mark.cuda
def test_a_shed_request_frees_its_received_attachment(cuda_device):
    """An overloaded ici:// server sheds a request whose 64 MiB DEVICE
    attachment already rode the plane: the shed carries its hint, the
    received tensor is freed with the response, and memory returns to
    its level once the client drops its own."""
    import gc
    import threading as _th
    import time
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.butil import flags
    mesh = IciMesh(ranks=8, device="cuda")
    IciMesh.set_default(mesh)
    # a window past the payload: a 64 MiB frame cut across writes would
    # ride as several transfers
    window = flags.get_flag("ici_socket_window_bytes")
    flags.set_flag("ici_socket_window_bytes", 256 << 20)
    block = _th.Event()
    server = _echo_server("ici://5", rpc.ServerOptions(
        max_concurrency=1, admission=rpc.AdmissionOptions(max_queue_ms=10)),
        block=block)
    ch = rpc.Channel()
    ch.init("ici://5", options=rpc.ChannelOptions(
        timeout_ms=30000, max_retry=0))
    plane = dp.plane()
    try:
        blocker = rpc.Controller()
        ch.call_method("Echo.Echo", blocker, EchoRequest(message="block"),
                       EchoResponse, done=lambda c: None)
        deadline = time.monotonic() + 10
        while server.inflight_requests() == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        torch.cuda.synchronize()
        gc.collect()
        base = torch.cuda.memory_allocated(cuda_device)
        launches0, transfers0 = p2p_copy.launches, plane.stats()["transfers"]
        cntl = rpc.Controller()
        cntl.priority = 3
        cntl.request_attachment.append_device_array(mesh.own(
            torch.full((64 << 20,), 9, dtype=torch.uint8,
                       device=cuda_device), 6))
        ch.call_method("Echo.Echo", cntl, EchoRequest(message="x"),
                       EchoResponse)
        assert cntl.error_code_ == rpc.errors.ELIMIT
        assert cntl.retry_after_ms > 0
        assert p2p_copy.launches - launches0 == 1
        assert plane.stats()["transfers"] - transfers0 == 1
        cntl = None
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            gc.collect()
            torch.cuda.synchronize()
            if torch.cuda.memory_allocated(cuda_device) - base < (1 << 20):
                break
            time.sleep(0.01)
        assert torch.cuda.memory_allocated(cuda_device) - base < (1 << 20)
        assert plane.active_transfers() == 0
    finally:
        block.set()
        ch.close()
        server.stop()
        flags.set_flag("ici_socket_window_bytes", window)
        IciMesh.set_default(None)


@pytest.mark.cuda
def test_a_consumed_device_stream_chunk_is_freed(cuda_device):
    """A stream of 8 DEVICE chunks of 16 MiB from rank 4 to a server on
    ici://3: every chunk lands byte-equal, one p2p_copy launch a chunk,
    and once the handler dropped them and the stream closed, device
    memory is back to its level: neither the delivery queue, its worker,
    the socket nor the poller holds a received chunk."""
    import gc
    import time
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    chunk = 16 << 20
    mesh = IciMesh(ranks=8, device="cuda")
    IciMesh.set_default(mesh)
    window = flags.get_flag("ici_socket_window_bytes")
    flags.set_flag("ici_socket_window_bytes", 256 << 20)
    src = torch.from_numpy(_seeded(chunk)).to(cuda_device)
    same, closed = [], threading.Event()

    class Check(rpc.StreamInputHandler):
        def on_received_messages(self, sid, msgs):
            for m in msgs:
                ref = m.backing_block(0)
                same.append(m.backing_block_num() == 1 and torch.equal(
                    ref.block.data[ref.offset:ref.offset + ref.length], src))

        def on_closed(self, sid):
            closed.set()

    class Sink(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Open(self, cntl, request, response, done):
            rpc.stream_accept(cntl, rpc.StreamOptions(
                handler=Check(), max_buf_size=64 << 20))
            done()

    server = rpc.Server()
    server.add_service(Sink())
    assert server.start("ici://3") == 0
    ch = rpc.Channel()
    ch.init("ici://3", options=rpc.ChannelOptions(timeout_ms=30000))
    try:
        cntl = rpc.Controller()
        st = rpc.stream_create(cntl, rpc.StreamOptions(max_buf_size=64 << 20))
        ch.call_method("Sink.Open", cntl, EchoRequest(message="o"),
                       EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert st.wait_connected(10)
        torch.cuda.synchronize()
        gc.collect()
        base = torch.cuda.memory_allocated(cuda_device)
        launches0 = p2p_copy.launches
        for _ in range(8):
            buf = IOBuf()
            buf.append_device_array(mesh.own(src.clone(), 4))
            assert st.write(buf, timeout=30) == 0
            del buf
        st.close()
        assert closed.wait(30)
        assert same == [True] * 8
        assert p2p_copy.launches - launches0 == 8
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            gc.collect()
            torch.cuda.synchronize()
            if torch.cuda.memory_allocated(cuda_device) - base < (1 << 20):
                break
            time.sleep(0.01)
        assert torch.cuda.memory_allocated(cuda_device) - base < (1 << 20)
    finally:
        ch.close()
        server.stop()
        flags.set_flag("ici_socket_window_bytes", window)
        IciMesh.set_default(None)


@pytest.mark.cuda
def test_a_parallel_fanout_of_device_shards_merges_to_the_plain_result(
        cuda_device):
    """A (4, 2 Mi) float32 tensor on rank 0, one row per sub-call to the
    servers on ici://1-4, each returning its row times its rank; the
    merged rows equal the plain product on the card, with two p2p_copy
    launches per sub-call (out and back)."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import channels, rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    mesh = IciMesh(ranks=8, device="cuda")
    IciMesh.set_default(mesh)
    window = flags.get_flag("ici_socket_window_bytes")
    flags.set_flag("ici_socket_window_bytes", 256 << 20)
    ranks = [1, 2, 3, 4]

    class Scale(rpc.Service):
        SERVICE_NAME = "Shard"

        def __init__(self, rank):
            self.rank = rank

        @rpc.method(EchoRequest, EchoResponse)
        def Scale(self, cntl, request, response, done):
            ref = cntl.request_attachment.backing_block(0)
            x = ref.block.data[ref.offset:ref.offset + ref.length]
            y = (x.view(torch.float32) * self.rank).view(torch.uint8)
            cntl.response_attachment.append_device_array(
                mesh.own(y, self.rank))
            done()

    class Rows(channels.CallMapper):
        def map(self, i, method, request):
            att = IOBuf()
            att.append_device_array(rows[i])
            return channels.SubCall(request, attachment=att)

    class ByIndex(channels.ResponseMerger):
        parts = {}

        def merge_sub(self, parent_cntl, index, sub_cntl, response):
            ref = sub_cntl.response_attachment.backing_block(0)
            self.parts[index] = ref.block.data[
                ref.offset:ref.offset + ref.length].view(torch.float32)
            return self.MERGED

    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 2 << 20)).astype(np.float32)).to(cuda_device)
    rows = [mesh.own(x[i].clone().view(torch.uint8), 0) for i in range(4)]
    servers, subs = [], []
    try:
        pc = channels.ParallelChannel()
        merger = ByIndex()
        for r in ranks:
            s = rpc.Server()
            s.add_service(Scale(r))
            assert s.start(f"ici://{r}") == 0
            servers.append(s)
            ch = rpc.Channel()
            ch.init(f"ici://{r}", options=rpc.ChannelOptions(timeout_ms=30000))
            subs.append(ch)
            pc.add_channel(ch, mapper=Rows(), merger=merger)
        launches0 = p2p_copy.launches
        cntl = rpc.Controller()
        pc.call_method("Shard.Scale", cntl, EchoRequest(message="x"),
                       EchoResponse())
        assert not cntl.failed(), cntl.error_text
        got = torch.stack([merger.parts[i] for i in range(4)])
        want = x * torch.tensor(ranks, dtype=torch.float32,
                                device=cuda_device)[:, None]
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert p2p_copy.launches - launches0 == 2 * len(ranks)
    finally:
        for ch in subs:
            ch.close()
        for s in servers:
            s.stop()
        flags.set_flag("ici_socket_window_bytes", window)
        IciMesh.set_default(None)


@pytest.mark.cuda
def test_a_compiled_fanout_on_the_card_equals_its_degrade_leg(cuda_device):
    """Four servers on ici://2-5 registering a device body: the compiled
    fan-out of a (4, 1 Mi) float32 operand sharded over them launches no
    p2p_copy and equals the per-member loop, whose answers cross back on
    p2p_copy (one launch per member, equal to the plane's transfers)."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import channels, rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.channels import collective_fanout as cf
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    mesh = IciMesh(ranks=8, device="cuda")
    IciMesh.set_default(mesh)
    window = flags.get_flag("ici_socket_window_bytes")
    flags.set_flag("ici_socket_window_bytes", 256 << 20)
    ranks = [2, 3, 4, 5]

    class Scale(rpc.Service):
        SERVICE_NAME = "CudaFan"

        def __init__(self, rank):
            self.rank = rank

        @rpc.method(EchoRequest, EchoResponse)
        def Scale(self, cntl, request, response, done):
            ref = cntl.request_attachment.backing_block(0)
            x = ref.block.data[ref.offset:ref.offset + ref.length]
            y = (x.view(torch.float32) * 3.0).view(torch.uint8)
            cntl.response_attachment.append_device_array(
                mesh.own(y, self.rank))
            done()

    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (4, 1 << 20)).astype(np.float32)).to(cuda_device)
    servers, subs = [], []
    plane = dp.plane()
    try:
        pc = channels.ParallelChannel()
        merger = channels.CollectiveMerger("gather", "float32", (1 << 20,))
        for r in ranks:
            s = rpc.Server()
            s.add_service(Scale(r))
            s.register_collective("CudaFan.Scale", lambda t: t * 3.0)
            assert s.start(f"ici://{r}") == 0
            servers.append(s)
            ch = rpc.Channel()
            ch.init(f"ici://{r}", options=rpc.ChannelOptions(timeout_ms=30000))
            subs.append(ch)
            pc.add_channel(ch, mapper=channels.ShardingCallMapper(),
                           merger=merger)
        op = cf.shard_operand(ranks, x, mesh=mesh)
        results = {}
        for on in (True, False):
            flags.set_flag("ici_fanout_collective", on)
            launches0 = p2p_copy.launches
            t0 = plane.stats()["transfers"]
            cntl = rpc.Controller()
            cntl.fanout_operand = op
            pc.call_method("CudaFan.Scale", cntl, EchoRequest(message="x"),
                           EchoResponse())
            torch.cuda.synchronize()
            assert not cntl.failed(), cntl.error_text
            assert cntl.fanout_route == ("collective" if on else "rpc")
            assert cntl.fanout_result.is_cuda
            results[on] = (cntl.fanout_result,
                           p2p_copy.launches - launches0,
                           plane.stats()["transfers"] - t0)
        (c_res, c_l, c_t), (d_res, d_l, d_t) = results[True], results[False]
        assert torch.equal(c_res, x * 3.0)
        assert torch.equal(c_res, d_res)
        assert c_l == c_t == 0
        assert d_l == d_t == len(ranks)
    finally:
        flags.set_flag("ici_fanout_collective", True)
        for ch in subs:
            ch.close()
        for s in servers:
            s.stop()
        flags.set_flag("ici_socket_window_bytes", window)
        IciMesh.set_default(None)


@pytest.mark.cuda
def test_a_transfer_span_appears_on_the_card(cuda_device):
    """rpcz on: a 64 KiB attachment owned by rank 1 crossing to ici://0
    on p2p_copy opens a transfer span under the client span, closed by
    the completion poller with the pin's hold time."""
    import time
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc import span
    mesh = IciMesh(ranks=8, device="cuda")
    IciMesh.set_default(mesh)

    class Sink(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Push(self, cntl, request, response, done):
            response.message = str(len(cntl.request_attachment))
            done()

    # the Python plane: its write publishes the client span that the
    # transfer span hangs under (the native door does not, as the
    # reference's does not)
    server = rpc.Server(rpc.ServerOptions(native_ici=False))
    server.add_service(Sink())
    assert server.start("ici://0") == 0
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=30000))
    flags.set_flag("rpcz_enabled", True)
    try:
        payload = mesh.device_put(
            torch.from_numpy(_seeded(64 << 10)).to(cuda_device), 1)
        launches0 = p2p_copy.launches
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(payload)
        resp = ch.call_method("Sink.Push", cntl, EchoRequest(message="p"),
                              EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert resp.message == str(64 << 10)
        assert p2p_copy.launches - launches0 == 1
        deadline = time.monotonic() + 10
        xfer = []
        while not xfer and time.monotonic() < deadline:
            xfer = [s for s in span.find_trace(cntl.trace_id)
                    if s.kind == "transfer" and s.end_us]
            time.sleep(0.01)
        client = [s for s in span.find_trace(cntl.trace_id)
                  if s.kind == "client"]
        assert xfer and client
        assert xfer[0].parent_span_id == client[0].span_id
        ann = " | ".join(a for _, a in xfer[0].annotations)
        for word in ("posted", "recv enqueued", "matched", "complete",
                     "pin_held_us="):
            assert word in ann, (word, ann)
    finally:
        flags.set_flag("rpcz_enabled", False)
        ch.close()
        server.stop()
        IciMesh.set_default(None)


def _stalling_echo_server(addr, stall):
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse

    class Echo(rpc.Service):
        SERVICE_NAME = "EchoService"

        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            stall()
            response.message = request.message
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    server = rpc.Server(rpc.ServerOptions(usercode_in_pthread=True,
                                          usercode_backup_threads=4))
    server.add_service(Echo())
    assert server.start(addr) == 0
    return server


@pytest.mark.cuda
def test_a_backup_request_carries_its_attachment_on_the_card(cuda_device):
    """A 4 MiB DEVICE attachment owned by rank 1, the first try stalled at
    the server: the backup try answers, both tries and both answers cross
    on p2p_copy (launches = plane transfers = 4), the bytes come back
    exact, and the memory comes back to its level."""
    import time
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    mesh = IciMesh(ranks=8, device="cuda")
    IciMesh.set_default(mesh)
    window = flags.get_flag("ici_socket_window_bytes")
    flags.set_flag("ici_socket_window_bytes", 64 << 20)
    tries = []

    def stall():
        tries.append(1)
        if len(tries) == 1:
            time.sleep(0.3)

    server = _stalling_echo_server("ici://0", stall)
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(
        timeout_ms=10000, max_retry=1, backup_request_ms=30))
    plane = dp.plane()
    try:
        payload = mesh.device_put(
            torch.from_numpy(_seeded(4 << 20)).to(cuda_device), 1)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(cuda_device)
        launches0 = p2p_copy.launches
        transfers0 = plane.stats()["transfers"]
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(payload)
        ch.call_method("EchoService.Echo", cntl, EchoRequest(message="b"),
                       EchoResponse)
        assert not cntl.failed(), cntl.error_text
        assert cntl.retried_count == 1
        back = cntl.response_attachment.device_refs()[0].block.data
        assert torch.equal(back, payload)
        del back, cntl
        time.sleep(0.5)                  # the stalled try answers late
        torch.cuda.synchronize()
        assert len(tries) == 2
        assert p2p_copy.launches - launches0 == \
            plane.stats()["transfers"] - transfers0 == 4
        assert plane.active_transfers() == 0
        assert torch.cuda.memory_allocated(cuda_device) - mem0 <= 16 << 20
    finally:
        flags.set_flag("ici_socket_window_bytes", window)
        ch.close()
        server.stop()
        IciMesh.set_default(None)


@pytest.mark.cuda
def test_a_cancelled_call_drops_its_late_answer_on_the_card(cuda_device):
    """A 4 MiB DEVICE attachment crosses to a slow handler, the call is
    cancelled (ECANCELED), and the handler's late answer crosses back on
    p2p_copy and is dropped: launches = plane transfers = 2, nothing stays
    active and the memory comes back to its level."""
    import time
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc import errors
    mesh = IciMesh(ranks=8, device="cuda")
    IciMesh.set_default(mesh)
    window = flags.get_flag("ici_socket_window_bytes")
    flags.set_flag("ici_socket_window_bytes", 64 << 20)
    entered = threading.Event()

    def stall():
        entered.set()
        time.sleep(0.3)

    server = _stalling_echo_server("ici://0", stall)
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=10000,
                                                  max_retry=0))
    plane = dp.plane()
    try:
        payload = mesh.device_put(
            torch.from_numpy(_seeded(4 << 20)).to(cuda_device), 1)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(cuda_device)
        launches0 = p2p_copy.launches
        transfers0 = plane.stats()["transfers"]
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(payload)
        ended = threading.Event()
        ch.call_method("EchoService.Echo", cntl, EchoRequest(message="c"),
                       EchoResponse, lambda c: ended.set())
        assert entered.wait(10)
        cntl.cancel()
        assert ended.wait(10)
        assert cntl.error_code == errors.ECANCELED
        time.sleep(0.5)
        torch.cuda.synchronize()
        assert cntl._peek_response_attachment() is None
        assert p2p_copy.launches - launches0 == \
            plane.stats()["transfers"] - transfers0 == 2
        assert plane.active_transfers() == 0
        del cntl
        assert torch.cuda.memory_allocated(cuda_device) - mem0 <= 16 << 20
    finally:
        flags.set_flag("ici_socket_window_bytes", window)
        ch.close()
        server.stop()
        IciMesh.set_default(None)


@pytest.mark.cuda
def test_a_native_echo_crosses_ranks_on_p2p_copy(cuda_device):
    """Through the native door, a 4 KiB DEVICE attachment owned by rank 1
    crosses to ici://0 and back on p2p_copy (launches = plane transfers =
    relocations = 2 a call).  The handler compares the bytes on the device
    with no host sync ahead of its read: the relocation ordered the
    default stream after the copy."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.ici import native_plane
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    mesh = IciMesh(ranks=8, device="cuda")
    IciMesh.set_default(mesh)
    threshold = flags.get_flag("ici_device_plane_threshold")
    flags.set_flag("ici_device_plane_threshold", 1)
    want = torch.from_numpy(_seeded(4096)).to(cuda_device)
    checks = []
    syncs = []
    real_sync = torch.cuda.synchronize

    class Echo(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            got = cntl.request_attachment.device_refs()[0].block.data
            checks.append((mesh.rank_of(got), torch.eq(got, want).all()))
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    server = rpc.Server()
    server.add_service(Echo())
    assert server.start("ici://0") == 0
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=30000))
    plane = dp.plane()
    try:
        binding = server._native_ici
        assert binding is not None
        payload = mesh.device_put(want.clone(), 1)
        p2p_copy.record(cuda_device.index)
        real_sync()
        launches0 = p2p_copy.launches
        transfers0 = plane.stats()["transfers"]
        reloc0 = native_plane.relocation_stats()["plane"]
        requests0 = binding.requests()
        torch.cuda.synchronize = lambda *a: syncs.append(1)
        try:
            for _ in range(8):
                cntl = rpc.Controller()
                cntl.request_attachment.append_device_array(payload)
                ch.call_method("Echo.Echo", cntl, EchoRequest(message="n"),
                               EchoResponse)
                assert not cntl.failed(), cntl.error_text
                back = cntl.response_attachment.device_refs()[0].block.data
                checks.append((mesh.rank_of(back),
                               torch.eq(back, want).all()))
        finally:
            torch.cuda.synchronize = real_sync
        assert syncs == []
        real_sync()
        assert [r for r, _ in checks] == [0, 1] * 8
        assert all(bool(ok) for _, ok in checks)
        assert binding.requests() - requests0 == 8
        assert p2p_copy.launches - launches0 == \
            plane.stats()["transfers"] - transfers0 == \
            native_plane.relocation_stats()["plane"] - reloc0 == 16
        assert plane.active_transfers() == 0
    finally:
        torch.cuda.synchronize = real_sync
        flags.set_flag("ici_device_plane_threshold", threshold)
        ch.close()
        server.stop()
        IciMesh.set_default(None)


@pytest.mark.cuda
def test_a_stop_with_native_calls_in_flight_leaves_no_transfer(
        cuda_device):
    """Eight native calls parked in their handler, each with a 64 KiB
    attachment that crossed on p2p_copy; the server stops under them.
    Every call fails cleanly, no device ref stays in native custody and
    no plane transfer stays active."""
    import time
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.ici import native_plane
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    mesh = IciMesh(ranks=8, device="cuda")
    IciMesh.set_default(mesh)
    gate = threading.Event()
    entered = []

    class Park(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Park(self, cntl, request, response, done):
            entered.append(1)
            gate.wait(10)
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    server = rpc.Server(rpc.ServerOptions(usercode_in_pthread=True,
                                          usercode_backup_threads=8))
    server.add_service(Park())
    assert server.start("ici://0") == 0
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=30000,
                                                  max_retry=0))
    plane = dp.plane()
    codes = []
    try:
        live0 = native_plane.registry().live()
        transfers0 = plane.stats()["transfers"]
        ch._native_ici_binding(rpc.Controller())
        nch = ch._native_ici

        def one(i):
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(mesh.device_put(
                torch.from_numpy(_seeded(65536 + i)[:65536]).to(
                    cuda_device), 1))
            nch.call("Park.Park", cntl, EchoRequest(message=str(i)),
                     EchoResponse)
            codes.append(cntl.error_code)

        ts = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        deadline = time.monotonic() + 10
        while len(entered) < 8 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(entered) == 8
        assert plane.stats()["transfers"] - transfers0 == 8
        server.stop()
        for t in ts:
            t.join(10)
        gate.set()
        server.join(10)
        torch.cuda.synchronize()
        assert codes == [rpc.errors.EFAILEDSOCKET] * 8, codes
        deadline = time.monotonic() + 5
        while (native_plane.registry().live() != live0
               or plane.active_transfers()) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert native_plane.registry().live() == live0
        assert plane.active_transfers() == 0
    finally:
        gate.set()
        ch.close()
        server.stop()
        IciMesh.set_default(None)
