"""The port's host combo channels, naming and balancers, held against the
JAX package on the CPU.

Mirrors ``tests/test_channels.py``'s ParallelChannel, PartitionChannel and
SelectiveChannel classes: each scenario runs on both packages' stacks over
``mem://`` and must see the same outcome.  Besides:

  * balancer parity: over one server list and one seed, each balancer of
    ``create_load_balancer`` picks the same sequence in both packages, and
    consistent hashing maps the same keys to the same servers (murmur3 and
    md5 bit for bit);
  * naming parity for ``list://`` and ``file://``, and the remote schemes
    build the same sources; ``mesh://`` drops a draining rank;
  * ``Channel.init`` takes the reference's signature: the same positional
    call means the same in both packages;
  * DEVICE shards fanned out over ``ici://`` on a CPU mesh with the plane
    engaged (a ParallelChannel and a PartitionChannel): the merged result
    equals the plain computation and every crossing sub-call is one plane
    transfer each way; a SelectiveChannel over a stopped member succeeds
    on every call by retrying on another.
"""
from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest
import torch

import brpc_tpu.policy  # noqa: F401
from brpc_tpu import channels as jchannels
from brpc_tpu import rpc as jrpc
from brpc_tpu.butil import misc as jmisc
from brpc_tpu.butil.endpoint import parse_endpoint as jparse
from brpc_tpu.policy import load_balancers as jlb
from brpc_tpu.policy import naming as jnaming
from brpc_tpu.rpc import errors as jerrors
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu_torch import channels, rpc
from brpc_tpu_torch.butil import flags as tflags
from brpc_tpu_torch.butil import misc as tmisc
from brpc_tpu_torch.butil.endpoint import parse_endpoint
from brpc_tpu_torch.butil.iobuf import IOBuf
from brpc_tpu_torch.ici import device_plane as dp
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.policy import load_balancers as tlb
from brpc_tpu_torch.policy import naming as tnaming
from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
from brpc_tpu_torch.rpc import errors, health_check, lameduck
from brpc_tpu_torch.rpc.circuit_breaker import BreakerRegistry
from brpc_tpu_torch.rpc.controller import server_controller_pool
from tests.echo_pb2 import EchoRequest as JEchoRequest
from tests.echo_pb2 import EchoResponse as JEchoResponse

WAIT_S = 10.0
_FLAGS = ("ici_device_plane", "ici_device_plane_host_mesh",
          "ici_device_plane_threshold")

JAX = types.SimpleNamespace(name="jax", rpc=jrpc, channels=jchannels,
                            errors=jerrors, Req=JEchoRequest,
                            Resp=JEchoResponse)
PORT = types.SimpleNamespace(name="torch", rpc=rpc, channels=channels,
                             errors=errors, Req=EchoRequest,
                             Resp=EchoResponse)
BOTH = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "torch"])


@pytest.fixture(scope="module", autouse=True)
def port_idle_after():
    """Every server and channel here is closed by its test; at teardown
    the port's sockets, pooled server Controllers and plane pins are all
    returned."""
    yield
    deadline = time.monotonic() + 2.0
    plane = dp.DevicePlane._instance
    while (rpc.list_sockets() or server_controller_pool.live()
           or (plane is not None and plane.active_transfers())) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not rpc.list_sockets()
    assert server_controller_pool.live() == 0
    assert plane is None or plane.active_transfers() == 0


@pytest.fixture(autouse=True)
def leaves_no_endpoint_state():
    """A test that stops a server or trips a breaker leaves process-wide
    state behind: a peer's drain mark, a health check probing it, an
    isolated breaker.  Each is undone here, so a later test on the same
    endpoint (another module's, in the same worker) starts clean."""
    yield
    for ep in list(health_check._tasks):
        health_check._tasks[ep].cancel()
    for ep in lameduck.peer_draining():
        lameduck.clear_peer_draining(ep)
    reg = BreakerRegistry.instance()
    with reg._lock:
        breakers = list(reg._map.values())
    for b in breakers:
        if b.is_isolated():
            b.mark_recovered()


@pytest.fixture
def mesh():
    saved = {n: tflags.get_flag(n) for n in _FLAGS}
    m = IciMesh(ranks=8, device="cpu")
    IciMesh.set_default(m)
    tflags.set_flag("ici_device_plane", True)
    tflags.set_flag("ici_device_plane_host_mesh", True)
    tflags.set_flag("ici_device_plane_threshold", 4096)
    yield m
    for n, v in saved.items():
        tflags.set_flag(n, v)
    IciMesh.set_default(None)


_seq = iter(range(100_000))


def _tagged_echo(pkg, tag):
    class TaggedEcho(pkg.rpc.Service):
        SERVICE_NAME = "EchoService"

        def __init__(self):
            self.calls = 0

        @pkg.rpc.method(pkg.Req, pkg.Resp)
        def Echo(self, cntl, request, response, done):
            self.calls += 1
            response.message = f"{tag}:{request.message}"
            done()

    return TaggedEcho()


def _start(pkg, tag):
    s = pkg.rpc.Server()
    svc = _tagged_echo(pkg, tag)
    s.add_service(svc)
    name = f"tch-{pkg.name}-{tag}-{next(_seq)}"
    assert s.start(f"mem://{name}") == 0
    return s, svc, f"mem://{name}"


def _merger(pkg):
    class ConcatMerger(pkg.channels.ResponseMerger):
        def merge(self, response, sub_response):
            response.message = (response.message + "|" + sub_response.message
                                if response.message else sub_response.message)
            return self.MERGED

    return ConcatMerger()


def _chan(pkg, target, timeout_ms=None, max_retry=None):
    ch = pkg.rpc.Channel()
    ch.init(target)
    if timeout_ms is not None:
        ch.options.timeout_ms = timeout_ms
    if max_retry is not None:
        ch.options.max_retry = max_retry
    return ch


def _close(*chans):
    for ch in chans:
        close = getattr(ch, "close", None)
        if close is not None:
            close()


# ---- ParallelChannel -----------------------------------------------------

@BOTH
def test_parallel_fanout_and_merge(pkg):
    servers = [_start(pkg, f"s{i}") for i in range(3)]
    subs = []
    try:
        pc = pkg.channels.ParallelChannel()
        for _, _, target in servers:
            subs.append(_chan(pkg, target))
            pc.add_channel(subs[-1], merger=_merger(pkg))
        cntl = pkg.rpc.Controller()
        resp = pkg.Resp()
        pc.call_method("EchoService.Echo", cntl, pkg.Req(message="x"), resp)
        assert not cntl.failed(), cntl.error_text
        assert sorted(resp.message.split("|")) == ["s0:x", "s1:x", "s2:x"]
        assert all(svc.calls == 1 for _, svc, _ in servers)
    finally:
        _close(*subs)
        for s, _, _ in servers:
            s.stop()


@BOTH
def test_parallel_call_mapper_shards_requests(pkg):
    servers = [_start(pkg, f"p{i}") for i in range(3)]
    subs = []
    try:
        class ShardMapper(pkg.channels.CallMapper):
            def map(self, i, method, request):
                return pkg.channels.SubCall(
                    pkg.Req(message=f"{request.message}-part{i}"))

        pc = pkg.channels.ParallelChannel()
        for _, _, target in servers:
            subs.append(_chan(pkg, target))
            pc.add_channel(subs[-1], mapper=ShardMapper(),
                           merger=_merger(pkg))
        cntl = pkg.rpc.Controller()
        resp = pkg.Resp()
        pc.call_method("EchoService.Echo", cntl, pkg.Req(message="q"), resp)
        assert sorted(resp.message.split("|")) == [
            "p0:q-part0", "p1:q-part1", "p2:q-part2"]
    finally:
        _close(*subs)
        for s, _, _ in servers:
            s.stop()


@BOTH
def test_parallel_skip_subcall(pkg):
    servers = [_start(pkg, f"k{i}") for i in range(2)]
    subs = []
    try:
        class SkipFirst(pkg.channels.CallMapper):
            def map(self, i, method, request):
                if i == 0:
                    return pkg.channels.SubCall.skip_call()
                return pkg.channels.SubCall(request)

        pc = pkg.channels.ParallelChannel()
        for _, _, target in servers:
            subs.append(_chan(pkg, target))
            pc.add_channel(subs[-1], mapper=SkipFirst(), merger=_merger(pkg))
        cntl = pkg.rpc.Controller()
        resp = pkg.Resp()
        pc.call_method("EchoService.Echo", cntl, pkg.Req(message="m"), resp)
        assert not cntl.failed()
        assert resp.message.endswith(":m") and "|" not in resp.message
        assert servers[0][1].calls == 0
    finally:
        _close(*subs)
        for s, _, _ in servers:
            s.stop()


@BOTH
def test_parallel_fail_limit(pkg):
    s0, _, t0 = _start(pkg, "ok")
    ch_ok = _chan(pkg, t0)
    ch_bad = _chan(pkg, f"mem://nobody-{next(_seq)}", timeout_ms=200,
                   max_retry=0)
    try:
        pc = pkg.channels.ParallelChannel(fail_limit=1)
        pc.add_channel(ch_ok, merger=_merger(pkg))
        pc.add_channel(ch_bad, merger=_merger(pkg))
        cntl = pkg.rpc.Controller()
        pc.call_method("EchoService.Echo", cntl, pkg.Req(message="f"),
                       pkg.Resp())
        assert cntl.failed()
        assert cntl.error_code == pkg.errors.ETOOMANYFAILS
    finally:
        _close(ch_ok, ch_bad)
        s0.stop()


@BOTH
def test_parallel_async_fanout(pkg):
    servers = [_start(pkg, f"a{i}") for i in range(2)]
    subs = []
    try:
        pc = pkg.channels.ParallelChannel()
        for _, _, target in servers:
            subs.append(_chan(pkg, target))
            pc.add_channel(subs[-1], merger=_merger(pkg))
        done = threading.Event()
        out = {}

        def cb(cntl):
            out["resp"] = cntl.response
            done.set()

        pc.call_method("EchoService.Echo", pkg.rpc.Controller(),
                       pkg.Req(message="y"), pkg.Resp(), done=cb)
        assert done.wait(WAIT_S)
        assert sorted(out["resp"].message.split("|")) == ["a0:y", "a1:y"]
    finally:
        _close(*subs)
        for s, _, _ in servers:
            s.stop()


# ---- PartitionChannel ----------------------------------------------------

@BOTH
def test_partition_fanout(pkg, tmp_path):
    servers = [_start(pkg, f"part{i}") for i in range(2)]
    listing = tmp_path / "cluster"
    listing.write_text(f"{servers[0][2]} 100 0/2\n{servers[1][2]} 100 1/2\n")
    pc = pkg.channels.PartitionChannel()
    try:
        assert pc.init(2, f"file://{listing}", merger=_merger(pkg)) == 0
        assert pc.partitions_ready()
        cntl = pkg.rpc.Controller()
        resp = pkg.Resp()
        pc.call_method("EchoService.Echo", cntl, pkg.Req(message="pt"), resp)
        assert not cntl.failed(), cntl.error_text
        assert sorted(resp.message.split("|")) == ["part0:pt", "part1:pt"]
    finally:
        _close(pc)
        for s, _, _ in servers:
            s.stop()


@BOTH
def test_partition_parser(pkg):
    p = pkg.channels.PartitionParser()
    assert p.parse_from_tag("0/4") == (0, 4)
    assert p.parse_from_tag("3/4") == (3, 4)
    assert p.parse_from_tag("4/4") is None
    assert p.parse_from_tag("x") is None


@BOTH
def test_dynamic_partition_prefers_bigger_scheme(pkg, tmp_path):
    servers = [_start(pkg, f"dp{i}") for i in range(3)]
    listing = tmp_path / "cluster"
    listing.write_text(f"{servers[0][2]} 100 0/1\n"
                       f"{servers[1][2]} 100 0/2\n{servers[2][2]} 100 1/2\n")
    dpc = pkg.channels.DynamicPartitionChannel()
    try:
        assert dpc.init([1, 2], f"file://{listing}",
                        merger=_merger(pkg)) == 0
        oks = 0
        for _ in range(20):
            cntl = pkg.rpc.Controller()
            dpc.call_method("EchoService.Echo", cntl, pkg.Req(message="d"),
                            pkg.Resp())
            oks += not cntl.failed()
        assert oks == 20
        assert (servers[1][1].calls + servers[2][1].calls
                ) >= servers[0][1].calls
    finally:
        _close(dpc)
        for s, _, _ in servers:
            s.stop()


# ---- SelectiveChannel ----------------------------------------------------

@BOTH
def test_selective_retries_on_another_channel(pkg):
    s_ok, _, t_ok = _start(pkg, "live")
    ch_dead = _chan(pkg, f"mem://dead-{next(_seq)}", timeout_ms=200,
                    max_retry=0)
    ch_ok = _chan(pkg, t_ok)
    try:
        sc = pkg.channels.SelectiveChannel()
        sc.add_channel(ch_dead)
        sc.add_channel(ch_ok)
        oks, retried = 0, 0
        for _ in range(6):
            cntl = pkg.rpc.Controller()
            resp = sc.call_method("EchoService.Echo", cntl,
                                  pkg.Req(message="s"), pkg.Resp)
            if not cntl.failed():
                oks += 1
                assert resp.message == "live:s"
            retried += cntl.retried_count
        assert oks == 6
        assert retried >= 1
    finally:
        _close(ch_dead, ch_ok)
        s_ok.stop()


@BOTH
def test_selective_all_dead_fails(pkg):
    sc = pkg.channels.SelectiveChannel()
    chans = [_chan(pkg, f"mem://void-{next(_seq)}", timeout_ms=100,
                   max_retry=0) for _ in range(2)]
    for ch in chans:
        sc.add_channel(ch)
    cntl = pkg.rpc.Controller()
    sc.call_method("EchoService.Echo", cntl, pkg.Req(), pkg.Resp)
    assert cntl.failed()
    _close(*chans)


# ---- balancers and naming: parity ----------------------------------------

_MEMBERS = [("ici://1", 100), ("ici://2", 300), ("mem://m-a", 50),
            ("ici://5", 100), ("mem://m-b", 200)]


def _picks(lbmod, parse, name, seed, n=200, codes=False):
    lb = lbmod.create_load_balancer(name)
    lb.reset_servers([lbmod.ServerEntry(parse(ep), w, "")
                      for ep, w in _MEMBERS])
    out = []
    for i in range(n):
        cntl = types.SimpleNamespace(request_code=i * 7919) if codes \
            else None
        out.append(str(lb.select_server(cntl)))
    return out


@pytest.mark.parametrize("name", ["rr", "wrr", "random", "wr",
                                  "c_murmurhash", "c_md5", "c_ketama",
                                  "dynpart"])
def test_balancer_picks_match(name):
    """Same members, same seed: the same picks.  The JAX package's
    generator is thread-local; its state is seeded directly."""
    seed = 0x5EED0000 + len(name)
    jmisc._tls.s = [seed]
    ref = _picks(jlb, jparse, name, seed)
    tmisc.seed_fast_rand(seed)
    assert _picks(tlb, parse_endpoint, name, seed) == ref
    assert len(set(ref)) > 1 or name.startswith("c_")
    if name.startswith("c_"):
        assert _picks(tlb, parse_endpoint, name, seed, codes=True) == \
            _picks(jlb, jparse, name, seed, codes=True)


def test_balancer_seeded_generator_matches_thread_state():
    rng = tmisc.FastRand(1234)
    lb = tlb.RandomizedLB(rng=rng)
    lb.reset_servers([tlb.ServerEntry(parse_endpoint(ep), w)
                      for ep, w in _MEMBERS])
    jmisc._tls.s = [1234]
    ref = _picks(jlb, jparse, "random", 1234)
    assert [str(lb.select_server()) for _ in range(200)] == ref


def test_hashes_match_bit_for_bit():
    rng = np.random.default_rng(3)
    for n in list(range(0, 17)) + [63, 64, 65, 1000]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tlb._murmur32(data) == jlb._murmur32(data)
        assert tlb._murmur32(data, 0x9747B28C) == \
            jlb._murmur32(data, 0x9747B28C)
        assert tlb._md5_32(data) == jlb._md5_32(data)
    assert tlb.list_load_balancers() == jlb.list_load_balancers()


def _entries(es):
    return [(str(e.endpoint), e.weight, e.tag) for e in es]


def test_naming_list_and_file_match(tmp_path):
    url = ("list://ici://(0,1),ici://3 200 1/4,mem://a-b 7 x,"
           "mem://c:tag=2/4")
    got = _entries(tnaming.create_naming_service(url).get_servers())
    assert got == _entries(jnaming.create_naming_service(url).get_servers())
    assert got[1] == ("ici://3", 200, "1/4")
    listing = tmp_path / "cluster"
    listing.write_text("# members\nici://1 100 0/2\n\nmem://f-x 50 1/2 "
                       "# trailing\nici://(1,2)\n")
    url = f"file://{listing}"
    got = _entries(tnaming.create_naming_service(url).get_servers())
    assert got == _entries(jnaming.create_naming_service(url).get_servers())
    assert len(got) == 3
    # the remote schemes resolve (tests/test_torch_naming_remote.py holds
    # their entries against the JAX package's); an unknown one is refused
    for url in ("consul://x:1/s", "nacos://x:1/s", "discovery://x:1/a",
                "remotefile://x:1/f"):
        t, j = (tnaming.create_naming_service(url),
                jnaming.create_naming_service(url))
        assert (type(t).__name__, t.url) == (type(j).__name__, j.url)
    with pytest.raises(ValueError):
        tnaming.create_naming_service("zk://x:1/s")


def test_naming_mesh_drops_a_draining_rank(mesh):
    ns = tnaming.create_naming_service("mesh://")
    assert [str(e.endpoint) for e in ns.get_servers()] == [
        f"ici://{i}" for i in range(8)]
    ep = parse_endpoint("ici://4")
    lameduck.mark_local_draining(ep)
    try:
        assert "ici://4" not in [str(e.endpoint) for e in ns.get_servers()]
    finally:
        lameduck.clear_local_draining(ep)


@BOTH
def test_channel_init_positional_call_means_the_same(pkg):
    """``init(target, lb_name, options)``: the second positional argument
    is the balancer's name in both packages, and a naming url's members
    are picked by it."""
    servers = [_start(pkg, f"n{i}") for i in range(2)]
    url = "list://" + ",".join(t for _, _, t in servers)
    ch = pkg.rpc.Channel()
    try:
        assert ch.init(url, "rr",
                       pkg.rpc.ChannelOptions(timeout_ms=4321)) == 0
        assert ch.options.timeout_ms == 4321
        seen = []
        for _ in range(4):
            cntl = pkg.rpc.Controller()
            r = ch.call_method("EchoService.Echo", cntl,
                               pkg.Req(message="n"), pkg.Resp)
            assert not cntl.failed(), cntl.error_text
            seen.append(r.message.split(":")[0])
        assert sorted(seen) == ["n0", "n0", "n1", "n1"]
        one = pkg.rpc.Channel()
        assert one.init(servers[0][2], "",
                        pkg.rpc.ChannelOptions(max_retry=5)) == 0
        assert one.options.max_retry == 5
        _close(one)
    finally:
        _close(ch)
        for s, _, _ in servers:
            s.stop()


# ---- DEVICE shards over ici:// ------------------------------------------

class _Scale(rpc.Service):
    """Returns its request attachment, a float32 shard, times its rank."""

    SERVICE_NAME = "Shard"

    def __init__(self, rank):
        self.rank = rank

    @rpc.method(EchoRequest, EchoResponse)
    def Scale(self, cntl, request, response, done):
        ref = cntl.request_attachment.backing_block(0)
        x = ref.block.data[ref.offset:ref.offset + ref.length]
        y = (x.view(torch.float32) * self.rank).view(torch.uint8)
        cntl.response_attachment.append_device_array(
            IciMesh.default().own(y, self.rank))
        response.message = str(self.rank)
        done()


class _RowMapper(channels.CallMapper):
    def __init__(self, rows):
        self.rows = rows

    def map(self, i, method, request):
        att = IOBuf()
        att.append_device_array(self.rows[i])
        return channels.SubCall(request, attachment=att)


class _ByIndex(channels.ResponseMerger):
    def __init__(self):
        self.parts = {}

    def merge_sub(self, parent_cntl, index, sub_cntl, response):
        ref = sub_cntl.response_attachment.backing_block(0)
        self.parts[index] = ref.block.data[ref.offset:ref.offset
                                           + ref.length].view(torch.float32)
        return self.MERGED


def _shards(mesh, n, width, owner, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, width)).astype(np.float32))
    rows = [mesh.own(x[i].clone().view(torch.uint8), owner)
            for i in range(n)]
    return x, rows


def test_parallel_fanout_of_device_shards(mesh):
    ranks = [1, 2, 3, 4]
    servers = []
    subs = []
    for r in ranks:
        s = rpc.Server()
        s.add_service(_Scale(r))
        assert s.start(f"ici://{r}") == 0
        servers.append(s)
    try:
        x, rows = _shards(mesh, len(ranks), 4096, owner=0, seed=12)
        pc = channels.ParallelChannel()
        merger = _ByIndex()
        for r in ranks:
            ch = rpc.Channel()
            ch.init(f"ici://{r}", options=rpc.ChannelOptions(
                timeout_ms=int(WAIT_S * 1000)))
            subs.append(ch)
            pc.add_channel(ch, mapper=_RowMapper(rows), merger=merger)
        plane = dp.plane()
        t0 = plane.stats()["transfers"]
        cntl = rpc.Controller()
        pc.call_method("Shard.Scale", cntl, EchoRequest(message="x"),
                       EchoResponse())
        assert not cntl.failed(), cntl.error_text
        got = torch.stack([merger.parts[i] for i in range(len(ranks))])
        want = x * torch.tensor(ranks, dtype=torch.float32)[:, None]
        assert torch.equal(got, want)
        # every sub-call crossed: its shard out, its answer back
        assert plane.stats()["transfers"] - t0 == 2 * len(ranks)
    finally:
        _close(*subs)
        for s in servers:
            s.stop()


def test_partition_channel_of_device_shards(mesh):
    ranks = [2, 3, 5, 6]
    servers = []
    for r in ranks:
        s = rpc.Server()
        s.add_service(_Scale(r))
        assert s.start(f"ici://{r}") == 0
        servers.append(s)
    url = "list://" + ",".join(f"ici://{r} 100 {i}/4"
                               for i, r in enumerate(ranks))
    merger = _ByIndex()
    x, rows = _shards(mesh, 4, 2048, owner=7, seed=13)
    pc = channels.PartitionChannel()
    try:
        assert pc.init(4, url, mapper=_RowMapper(rows), merger=merger) == 0
        assert pc.partitions_ready()
        plane = dp.plane()
        t0 = plane.stats()["transfers"]
        cntl = rpc.Controller()
        cntl.timeout_ms = int(WAIT_S * 1000)
        pc.call_method("Shard.Scale", cntl, EchoRequest(message="p"),
                       EchoResponse())
        assert not cntl.failed(), cntl.error_text
        got = torch.stack([merger.parts[i] for i in range(4)])
        want = x * torch.tensor(ranks, dtype=torch.float32)[:, None]
        assert torch.equal(got, want)
        assert plane.stats()["transfers"] - t0 == 8
    finally:
        _close(pc)
        for s in servers:
            s.stop()


def test_selective_channel_over_a_stopped_member(mesh):
    ranks = [1, 2, 3]
    servers, subs = [], []
    for r in ranks:
        s = rpc.Server()
        s.add_service(_tagged_echo(PORT, f"r{r}"))
        assert s.start(f"ici://{r}") == 0
        servers.append(s)
    servers[1].stop()
    try:
        sc = channels.SelectiveChannel()
        for r in ranks:
            ch = rpc.Channel()
            ch.init(f"ici://{r}", options=rpc.ChannelOptions(
                timeout_ms=2000, max_retry=0))
            subs.append(ch)
            sc.add_channel(ch)
        retried = 0
        for i in range(12):
            cntl = rpc.Controller()
            r = sc.call_method("EchoService.Echo", cntl,
                               EchoRequest(message=str(i)), EchoResponse)
            assert not cntl.failed(), cntl.error_text
            assert r.message in (f"r1:{i}", f"r3:{i}")
            retried += cntl.retried_count
        assert retried >= 1
    finally:
        _close(*subs)
        for s in servers:
            s.stop()
