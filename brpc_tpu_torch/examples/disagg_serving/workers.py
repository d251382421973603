"""Disaggregated prefill/decode workers on :mod:`brpc_tpu_torch.serving`.

Counterpart of ``examples/disagg_serving/workers.py``.  Three roles, each
an ordinary server; JSON bodies ride ``EchoRequest.message`` and the KV
rides an attachment:

  * **PrefillService** (``Prefill``): prompt → quantized KV on its rank,
    registered as owned by that rank, HANDED OFF to the router-chosen
    decode worker as a DEVICE attachment (``DecodeService.LoadKv``).  The
    transport relocates it to the decode rank through the device plane
    (one ``p2p_copy`` launch per handoff, at or above the plane's
    threshold), and LoadKv scatters the delivered tensor straight into
    the paged pool's reserved blocks.
  * **DecodeService** (``LoadKv`` / ``Decode`` / ``MigrateIn`` /
    ``MigrateOut``): KV pages into a
    :class:`~brpc_tpu_torch.serving.PagedKvPool` on the decode rank's
    device (with a pinned host tier when the pool options give
    ``host_blocks``) and tokens stream out of a
    :class:`~brpc_tpu_torch.serving.ContinuousBatchScheduler`: one batched
    step per tick over every active session.  ``Decode`` is ASYNC — the
    RPC completes from the step loop — so concurrent sessions share each
    step.  ``{"mode": "sync"}`` keeps the one-RPC-one-shot path.
    ``MigrateOut`` moves a live session to another decode worker's
    ``MigrateIn`` (:func:`~brpc_tpu_torch.serving.migrate_out`): the
    payload is a DEVICE attachment, so over ``ici://`` it rides the device
    plane, one ``p2p_copy`` launch per migration.  The cutover records
    the destination before the source copy is released, so a Decode that
    reaches the source afterwards gets a shed naming the destination
    (:func:`migrated_dest`) instead of an unknown session.
  * **RouterService** (``Generate``): the front door — prefill, then
    decode on the worker the LALB balancer picked; every decode outcome
    feeds the balancer, and failures retry against another worker
    (re-prefill).

Outbound calls inherit the inbound request's priority, tenant and
remaining deadline budget (``rpc/request_context.py``), so a Generate's
client budget reaches Prefill, LoadKv and Decode.  Handlers block on
nested sync calls (a Generate on Prefill, a Prefill on LoadKv), so none
may run ``usercode_inline``: a nested sync call on the delivering thread
would wait on itself.
"""
from __future__ import annotations

import json
import random
import threading
import time
from typing import Dict, List, Optional, Union

import torch

from ... import rpc
from ...ici.mesh import IciMesh
from ...proto.echo_pb2 import EchoRequest, EchoResponse
from ...serving import (BatchSchedulerOptions, ContinuousBatchScheduler,
                        KvPoolOptions, LoadAwareRouter, PagedKvPool,
                        PoolSaturated, SessionBusy, StepRequest,
                        kv_load_stats, load_token_major_attachment,
                        load_wire_attachment, migrate_out)
from ...serving import migration as _migration
from .model import (KV_DMODEL, KV_LAYERS, VOCAB, kv_nbytes, toy_decode,
                    toy_kv_blocks)

BYTES_PER_TOKEN = KV_LAYERS * KV_DMODEL

#: timeout of the workers' peer channels (a Prefill's LoadKv handoff, a
#: MigrateOut's MigrateIn)
PEER_TIMEOUT_MS = 60000

#: sessions a decode worker remembers having migrated away
MAX_MOVED_SESSIONS = 256

_MIGRATED = "kv migrated to "


def migrated_dest(cntl: rpc.Controller) -> Optional[str]:
    """The decode worker a failed Decode's session migrated to (retry the
    Decode there, after rebinding the session to it), else None."""
    if not cntl.failed() or cntl.error_code_ != rpc.errors.ELIMIT:
        return None
    text = cntl.error_text
    i = text.find(_MIGRATED)
    if i < 0:
        return None
    return text[i + len(_MIGRATED):].split(" ", 1)[0]


def _reply(response, done, **kw) -> None:
    response.message = json.dumps(kw)
    done()


class PrefillService(rpc.Service):
    SERVICE_NAME = "Prefill"

    def __init__(self, rank: int, mesh: Optional[IciMesh] = None,
                 channel_options: Optional[rpc.ChannelOptions] = None):
        self.mesh = mesh or IciMesh.default()
        self.rank = rank
        self.channel_options = channel_options or rpc.ChannelOptions(
            timeout_ms=PEER_TIMEOUT_MS)
        self._channels: Dict[str, rpc.Channel] = {}
        self._lock = threading.Lock()
        self.handoff_bytes = 0
        self.handoff_ns = 0      # cumulative LoadKv round-trip time

    def _channel_to(self, target: str) -> rpc.Channel:
        with self._lock:
            ch = self._channels.get(target)
            if ch is None:
                ch = rpc.Channel()
                ch.init(target, options=self.channel_options)
                self._channels[target] = ch
            return ch

    def close(self) -> None:
        with self._lock:
            chans, self._channels = list(self._channels.values()), {}
        for ch in chans:
            ch.close()

    @rpc.method(EchoRequest, EchoResponse)
    def Prefill(self, cntl, request, response, done):
        req = json.loads(request.message)
        session = req["session"]
        tokens = req["tokens"]
        decode_target = req["decode"]
        t0 = time.perf_counter_ns()
        kv = self.mesh.own(toy_kv_blocks(tokens, self.mesh.device(self.rank)),
                           self.rank)
        if kv.is_cuda:
            # the prefill's own time, apart from the handoff's (the
            # reference's block_until_ready): wait for this stream's work
            # up to here, not for the whole device
            done_ev = torch.cuda.Event()
            done_ev.record()
            done_ev.synchronize()
        t1 = time.perf_counter_ns()
        # the KV-cache handoff: device payload to the decode worker (the
        # call inherits the inbound priority, tenant and budget)
        ch = self._channel_to(decode_target)
        hand = rpc.Controller()
        hand.request_attachment.append_device_array(kv)
        load = EchoRequest(message=json.dumps(
            {"session": session, "seq_len": len(tokens),
             "last_token": tokens[-1]}))
        ch.call_method("Decode.LoadKv", hand, load, EchoResponse)
        t2 = time.perf_counter_ns()
        if hand.failed():
            cntl.retry_after_ms = hand.retry_after_ms
            cntl.set_failed(hand.error_code_,
                            f"kv handoff failed: {hand.error_text}")
            done()
            return
        with self._lock:
            self.handoff_bytes += kv_nbytes(len(tokens))
            self.handoff_ns += t2 - t1
        _reply(response, done, session=session,
               kv_bytes=kv_nbytes(len(tokens)),
               prefill_us=(t1 - t0) // 1000,
               handoff_us=(t2 - t1) // 1000)


class DecodeService(rpc.Service):
    SERVICE_NAME = "Decode"

    def __init__(self, rank: int, mesh: Optional[IciMesh] = None,
                 pool_options: Optional[KvPoolOptions] = None,
                 sched_options: Optional[BatchSchedulerOptions] = None):
        self.mesh = mesh or IciMesh.default()
        self.rank = rank
        self.pool = PagedKvPool(pool_options or KvPoolOptions(
            bytes_per_token=BYTES_PER_TOKEN, num_blocks=1024,
            block_tokens=16), device=self.mesh.device(rank))
        self.scheduler = ContinuousBatchScheduler(
            self.pool, sched_options or BatchSchedulerOptions(
                vocab=VOCAB, max_batch=64))
        self._lock = threading.Lock()
        self._channels: Dict[str, rpc.Channel] = {}   # migration peers
        # session -> the worker it migrated to, recorded at the cutover
        self._moved: Dict[str, str] = {}
        #: chaos hook: an UNSET Event here black-holes MigrateIn — the
        #: handler parks until it is set, so the source's transfer
        #: deadline is what fires
        self.migrate_in_gate: Optional[threading.Event] = None
        self.loads = 0              # LoadKv calls that committed
        # calls as the handlers receive them, sheds and retries included:
        # each one's attachment crossed the transport once
        self.loadkv_received = 0
        self.migrate_in_received = 0

    def live_sessions(self) -> int:
        return self.pool.sessions()

    def load(self) -> float:
        """The step's pressure: (roster + queue) / max_batch — the
        autoscaler's load signal for this worker."""
        d = self.scheduler.describe()
        return (d["active"] + sum(d["pending_by_band"])) \
            / max(d["max_batch"], 1)

    def close(self) -> None:
        self.scheduler.stop()
        self.pool.close()
        with self._lock:
            chans, self._channels = list(self._channels.values()), {}
        for ch in chans:
            ch.close()

    def _channel_to(self, target: str) -> rpc.Channel:
        with self._lock:
            ch = self._channels.get(target)
            if ch is None:
                ch = rpc.Channel()
                ch.init(target, options=rpc.ChannelOptions(
                    timeout_ms=PEER_TIMEOUT_MS))
                self._channels[target] = ch
            return ch

    def _note_moved(self, session: str, dest: str) -> None:
        with self._lock:
            self._moved.pop(session, None)
            self._moved[session] = dest
            while len(self._moved) > MAX_MOVED_SESSIONS:
                self._moved.pop(next(iter(self._moved)))

    def _moved_to(self, session: str) -> Optional[str]:
        with self._lock:
            return self._moved.get(session)

    def describe_serving(self) -> dict:
        """The /status serving block: step rate, batch occupancy, pool
        pages, evictions, KV-load routes (``kv_load`` is process-wide)."""
        return {"scheduler": self.scheduler.describe(),
                "pool": self.pool.describe(),
                "kv_load": {**kv_load_stats(), "scope": "process"}}

    @rpc.method(EchoRequest, EchoResponse)
    def LoadKv(self, cntl, request, response, done):
        with self._lock:
            self.loadkv_received += 1
        req = json.loads(request.message)
        session = req["session"]
        seq_len = req["seq_len"]
        if seq_len <= 0:
            cntl.set_failed(rpc.errors.EREQUEST,
                            f"seq_len must be >= 1, got {seq_len}")
            done()
            return
        want = kv_nbytes(seq_len)
        att = cntl.request_attachment
        if len(att) != want:
            cntl.set_failed(rpc.errors.EREQUEST,
                            f"kv size {len(att)} != {want}")
            done()
            return
        try:
            # the wire bytes scatter DIRECTLY into the reserved pool
            # blocks; the layer-major → token-major transpose happens
            # inside that one strided copy
            load_wire_attachment(
                self.pool, att, session, seq_len, KV_LAYERS, KV_DMODEL,
                last_token=req["last_token"],
                tenant=cntl.tenant or req.get("tenant", ""),
                priority=cntl.priority)
            att.clear()
        except PoolSaturated:
            # memory pressure with nothing evictable in an equal-or-
            # less-protected band: a shed, not a failure
            cntl.retry_after_ms = 20
            cntl.set_failed(rpc.errors.ELIMIT,
                            "kv pool saturated (shed): retry later")
            done()
            return
        except SessionBusy as e:
            # re-prefill raced the running decode: retry once it
            # completes
            cntl.retry_after_ms = 10
            cntl.set_failed(rpc.errors.ELIMIT, str(e))
            done()
            return
        with self._lock:
            self.loads += 1
            self._moved.pop(session, None)    # it lives here again
        _reply(response, done, session=session, loaded=want)

    @rpc.method(EchoRequest, EchoResponse)
    def MigrateIn(self, cntl, request, response, done):
        """Destination half of a live migration: a peer pool's TOKEN-MAJOR
        payload lands through the ordinary reserve / fill-outside-the-lock
        / commit path.  Refusals are LoadKv's retryable sheds: a saturated
        or busy destination aborts the migration cleanly, the source copy
        stays authoritative, no plane event."""
        with self._lock:
            self.migrate_in_received += 1
        gate = self.migrate_in_gate
        if gate is not None:
            gate.wait()          # chaos: black-hole until released
        req = json.loads(request.message)
        session = req["session"]
        seq_len = req["seq_len"]
        want = seq_len * self.pool.options.bytes_per_token
        att = cntl.request_attachment
        if seq_len <= 0 or len(att) != want:
            cntl.set_failed(rpc.errors.EREQUEST,
                            f"migrate payload {len(att)} != {want}")
            done()
            return
        try:
            load_token_major_attachment(
                self.pool, att, session, seq_len,
                last_token=req["last_token"],
                tenant=req.get("tenant", ""),
                priority=req.get("priority"))
            att.clear()
        except PoolSaturated:
            cntl.retry_after_ms = 20
            cntl.set_failed(rpc.errors.ELIMIT,
                            "kv pool saturated (shed): migration refused, "
                            "source stays authoritative")
            done()
            return
        except SessionBusy as e:
            cntl.retry_after_ms = 10
            cntl.set_failed(rpc.errors.ELIMIT, str(e))
            done()
            return
        with self._lock:
            self._moved.pop(session, None)
        _migration.stats.migrations_in << 1
        _reply(response, done, session=session, loaded=want)

    @rpc.method(EchoRequest, EchoResponse)
    def MigrateOut(self, cntl, request, response, done):
        """Source half: ship one session to the ``dest`` decode worker
        (``Decode.MigrateIn`` there) under the transfer-deadline latch.
        The source copy serves until the destination commits.  The
        cutover then records ``dest`` for the session, and only after it
        is the source copy released: a Decode that finds the session gone
        is shed towards ``dest``.  Every abort reads as a retryable
        shed."""
        req = json.loads(request.message)
        session = req["session"]
        dest = req["dest"]
        ch = self._channel_to(dest)

        def send(meta, payload):
            mc = rpc.Controller()
            # the gathered rows, owned by this rank: over ici:// the
            # transport moves them on the device plane
            mc.request_attachment.append_device_array(
                self.mesh.own(payload.reshape(-1), self.rank))
            ch.call_method("Decode.MigrateIn", mc,
                           EchoRequest(message=json.dumps(meta)),
                           EchoResponse)
            if mc.failed():
                # ELIMIT from the destination is a clean shed, not a dead
                # peer
                return (False, mc.error_text,
                        mc.error_code_ == rpc.errors.ELIMIT)
            return True, "", False

        ok, err = migrate_out(
            self.pool, session, send, scheduler=self.scheduler,
            on_cutover=lambda: self._note_moved(session, dest),
            deadline_ms=req.get("deadline_ms"))
        if not ok:
            cntl.retry_after_ms = 10
            cntl.set_failed(rpc.errors.ELIMIT,
                            f"migration failed (shed): {err}")
            done()
            return
        _reply(response, done, session=session, migrated=True, dest=dest)

    @rpc.method(EchoRequest, EchoResponse)
    def Decode(self, cntl, request, response, done):
        req = json.loads(request.message)
        session = req["session"]
        steps = req["steps"]
        release = req.get("release", True)
        if steps <= 0:
            _reply(response, done, session=session, tokens=[])
            return
        if req.get("mode") == "sync":
            self._decode_sync(cntl, session, steps, release, response,
                              done)
            return
        self.pool.touch(session)
        deadline_us = None
        if cntl.deadline_left_ms:
            deadline_us = (time.monotonic_ns() // 1000
                           + cntl.deadline_left_ms * 1000)

        def emit(tokens):
            if release:
                self.pool.release(session)
            _reply(response, done, session=session, tokens=tokens)

        def fail(code, text, retry_after_ms):
            dest = (self._moved_to(session)
                    if code == rpc.errors.EREQUEST else None)
            if dest is not None:
                # the session migrated away after this request was sent
                code, text, retry_after_ms = self._migrated_shed(dest)
            if retry_after_ms:
                cntl.retry_after_ms = retry_after_ms
            cntl.set_failed(code, text)
            done()

        # ASYNC: the RPC completes from the step loop when this session's
        # tokens are done — the handler's thread is free
        self.scheduler.submit(StepRequest(
            session, steps, emit, fail, priority=cntl.priority,
            tenant=cntl.tenant, deadline_us=deadline_us))

    @staticmethod
    def _migrated_shed(dest: str):
        """(code, text, hint) of the shed for a session that migrated to
        ``dest``: no hint, since a retry here cannot succeed."""
        return (rpc.errors.ELIMIT,
                f"{_MIGRATED}{dest} (shed): rebind the session and retry "
                "there", 0)

    def _decode_sync(self, cntl, session, steps, release, response,
                     done) -> None:
        """The one-RPC-one-shot path: read the session out of the pool (a
        pinned view when its blocks are one extent) and decode inline."""
        snap = self.pool.snapshot(session, view=True)
        if snap is None:
            dest = self._moved_to(session)
            reason = self.pool.evicted_reason(session)
            if dest is not None:
                code, text, _ = self._migrated_shed(dest)
                cntl.set_failed(code, text)
            elif reason is not None:
                cntl.retry_after_ms = 1
                cntl.set_failed(rpc.errors.ELIMIT,
                                f"kv {reason}-evicted: re-prefill")
            else:
                cntl.set_failed(rpc.errors.EREQUEST,
                                f"unknown session {session!r}")
            done()
            return
        rows, seq_len, last_token, is_view = snap
        try:
            # token-major rows → the model's layer-major flat layout
            flat = rows.reshape(seq_len, KV_LAYERS, KV_DMODEL).permute(
                1, 0, 2).reshape(-1)
            toks = toy_decode(flat, seq_len, last_token, steps)
        finally:
            if is_view:
                self.pool.unpin(session)
        if release:
            self.pool.release(session)
        else:
            self.pool.touch(session)
        _reply(response, done, session=session, tokens=toks)


class RouterService(rpc.Service):
    SERVICE_NAME = "Router"

    #: decode attempts per Generate: a failed worker's sessions
    #: re-prefill elsewhere
    MAX_DECODE_ATTEMPTS = 3

    def __init__(self, prefill_target: str,
                 decode_targets: Union[List[str], str],
                 channel_options: Optional[rpc.ChannelOptions] = None,
                 rng: Optional[random.Random] = None):
        """``prefill_target``: the prefill worker's url, or a naming url
        balanced round-robin.  ``decode_targets``: the decode workers'
        urls, or a naming url (``pod://name``) whose membership the router
        follows; either way the LALB balancer picks one per Generate and
        every outcome feeds back."""
        from ...policy.naming import is_naming_url
        opts = channel_options or rpc.ChannelOptions(timeout_ms=60000,
                                                     max_retry=2)
        self._prefill = rpc.Channel()
        self._prefill.init(prefill_target,
                           "rr" if is_naming_url(prefill_target) else "",
                           options=opts)
        self._router = LoadAwareRouter(decode_targets,
                                       channel_options=opts, rng=rng)
        self._lock = threading.Lock()
        self._next_session = 0
        self.retries = 0
        self.generate_failures = 0

    def close(self) -> None:
        self._prefill.close()
        self._router.close()

    # elastic membership (the autoscaler's registration surface)
    def add_decode_target(self, url: str) -> bool:
        return self._router.add_target(url)

    def remove_decode_target(self, url: str) -> bool:
        return self._router.remove_target(url)

    def describe_serving(self) -> dict:
        with self._lock:
            extra = {"retries": self.retries,
                     "generate_failures": self.generate_failures}
        return {"router": {**self._router.describe(), **extra}}

    @rpc.method(EchoRequest, EchoResponse)
    def Generate(self, cntl, request, response, done):
        req = json.loads(request.message)
        tokens = req["tokens"]
        steps = req.get("steps", 8)
        with self._lock:
            self._next_session += 1
            base_session = self._next_session
        tried: set = set()
        last_err = (rpc.errors.EINTERNAL, "no decode worker available")
        for attempt in range(self.MAX_DECODE_ATTEMPTS):
            decode_url = self._router.pick(exclude=tried)
            if decode_url is None:
                break
            # one session id per attempt: a retry re-prefills, never
            # half-reuses a failed worker's parked KV
            session = f"s{base_session}" if attempt == 0 \
                else f"s{base_session}r{attempt}"
            pc = rpc.Controller()
            t_pre = time.perf_counter_ns()
            pre_resp = self._prefill.call_method(
                "Prefill.Prefill", pc,
                EchoRequest(message=json.dumps(
                    {"session": session, "tokens": tokens,
                     "decode": decode_url})), EchoResponse)
            pre_us = (time.perf_counter_ns() - t_pre) // 1000
            if pc.failed():
                if pc.error_code_ == rpc.errors.ELIMIT \
                        and "kv handoff failed" not in pc.error_text:
                    # the PREFILL side shed this request: not the decode
                    # worker's fault — pass the shed and its hint through
                    if pc.retry_after_ms:
                        cntl.retry_after_ms = pc.retry_after_ms
                    cntl.set_failed(pc.error_code_,
                                    f"prefill shed: {pc.error_text}")
                    done()
                    return
                # the handoff INSIDE prefill failed against this decode
                # worker: punish its weight (with the real elapsed time —
                # LALB scales the punishment by it) and retry another
                self._router.feedback(decode_url, pc.error_code_,
                                      max(pre_us, 1))
                tried.add(decode_url)
                last_err = (pc.error_code_,
                            f"prefill failed: {pc.error_text}")
                with self._lock:
                    self.retries += 1
                continue
            pre = json.loads(pre_resp.message)
            dc = rpc.Controller()
            t0 = time.perf_counter_ns()
            dec_resp = self._router.channel(decode_url).call_method(
                "Decode.Decode", dc,
                EchoRequest(message=json.dumps(
                    {"session": session, "steps": steps,
                     "release": req.get("release", True),
                     **({"mode": req["mode"]} if "mode" in req
                        else {})})),
                EchoResponse)
            lat_us = (time.perf_counter_ns() - t0) // 1000
            self._router.feedback(decode_url, dc.error_code_
                                  if dc.failed() else 0, lat_us)
            if dc.failed():
                # ELIMIT is a SHED (an evicted session needs a
                # re-prefill, possibly on the same worker); anything else
                # excludes the worker from this call's retries
                if dc.error_code_ != rpc.errors.ELIMIT:
                    tried.add(decode_url)
                last_err = (dc.error_code_,
                            f"decode failed: {dc.error_text}")
                if dc.retry_after_ms:
                    cntl.retry_after_ms = dc.retry_after_ms
                with self._lock:
                    self.retries += 1
                continue
            toks = json.loads(dec_resp.message)["tokens"]
            _reply(response, done, session=session, tokens=toks,
                   decode_worker=decode_url,
                   kv_bytes=pre.get("kv_bytes", 0))
            return
        with self._lock:
            self.generate_failures += 1
        cntl.set_failed(last_err[0], last_err[1])
        done()


def _rank_of(addr: str, rank: Optional[int]) -> int:
    if rank is not None:
        return rank
    from ...butil.endpoint import parse_endpoint
    return parse_endpoint(addr).device_id


def start_prefill_worker(addr: str, rank: Optional[int] = None,
                         mesh: Optional[IciMesh] = None,
                         options: Optional[rpc.ServerOptions] = None
                         ) -> rpc.Server:
    """A prefill server on ``addr`` computing on mesh ``rank`` (default:
    the rank ``addr`` names)."""
    server = rpc.Server(options)
    server.add_service(PrefillService(_rank_of(addr, rank), mesh))
    rc = server.start(addr)
    if rc != 0:
        raise RuntimeError(f"prefill worker start failed: {rc}")
    return server


def start_decode_worker(addr: str, rank: Optional[int] = None,
                        mesh: Optional[IciMesh] = None,
                        options: Optional[rpc.ServerOptions] = None,
                        pool_options: Optional[KvPoolOptions] = None,
                        sched_options: Optional[
                            BatchSchedulerOptions] = None
                        ) -> rpc.Server:
    """A decode server on ``addr`` whose pool and step live on mesh
    ``rank``'s device (default: the rank ``addr`` names)."""
    server = rpc.Server(options)
    server.add_service(DecodeService(_rank_of(addr, rank), mesh,
                                     pool_options=pool_options,
                                     sched_options=sched_options))
    rc = server.start(addr)
    if rc != 0:
        raise RuntimeError(f"decode worker start failed: {rc}")
    return server


def start_router(addr: str, prefill_target: str,
                 decode_targets: Union[List[str], str],
                 rng: Optional[random.Random] = None) -> rpc.Server:
    """A router server on ``addr``; ``decode_targets`` is a list of urls
    or a naming url such as ``pod://name`` (see :class:`RouterService`)."""
    server = rpc.Server()
    server.add_service(RouterService(prefill_target, decode_targets,
                                     rng=rng))
    rc = server.start(addr)
    if rc != 0:
        raise RuntimeError(f"router start failed: {rc}")
    return server


def close_services(*servers: rpc.Server) -> None:
    """Close every service that holds resources (channels, a step loop, a
    pool), then stop the servers."""
    for server in servers:
        for svc in server.services().values():
            if hasattr(svc, "close"):
                svc.close()
    for server in servers:
        server.stop()
