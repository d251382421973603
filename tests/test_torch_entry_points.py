"""The port's entry points against the JAX package's, same inputs through
both, outcomes compared:

- ``Server.start``'s address forms: ``start(0)`` (a TCP port on
  ``0.0.0.0``), ``start("name")`` (``mem://name``), ``start()``
  (``mem://server``) and ``start(addr, options=...)``, each answering an
  echo and naming its address in ``listen_endpoint``;
- a decode worker whose server, pool and scheduler take six priority
  bands from ``AdmissionOptions(bands=6)`` serves sessions at priorities
  0-5 with the reference tokens;
- ``BatchSchedulerOptions(preempt=..., interactive_priority_max=...)``:
  an interactive arrival behind a full roster of batch-band sessions is
  let in by preemption only when ``preempt`` is on, and every session's
  tokens equal the reference decode either way;
- LALB's per-call exclusion read from an object whose exclusion set is
  not in its instance dict, and a port controller's unread exclusion
  field left unmaterialized by a pick.
"""
from __future__ import annotations

import json
import threading

import numpy as np
import pytest

import brpc_tpu.policy  # noqa: F401  (registers protocols)
import brpc_tpu_torch.policy  # noqa: F401
from brpc_tpu import rpc as jrpc
from brpc_tpu import serving as jserving
from brpc_tpu.butil.endpoint import parse_endpoint as jparse
from brpc_tpu.policy import load_balancers as jlbs
from brpc_tpu.rpc import admission as jadmission
from brpc_tpu_torch import rpc as trpc
from brpc_tpu_torch import serving as tserving
from brpc_tpu_torch.butil.endpoint import parse_endpoint as tparse
from brpc_tpu_torch.ici.mesh import IciMesh
from brpc_tpu_torch.policy import load_balancers as tlbs
from brpc_tpu_torch.rpc import admission as tadmission
from examples.disagg_serving import model as jmodel
from examples.disagg_serving import workers as jworkers
from brpc_tpu_torch.examples.disagg_serving import model as tmodel
from brpc_tpu_torch.examples.disagg_serving import workers as tworkers
from tests import echo_pb2 as jpb
from brpc_tpu_torch.proto import echo_pb2 as tpb
from tests.torch_mirror import drain_sockets  # noqa: F401  (fixture)

PKGS = ["jax", "port"]


@pytest.fixture(autouse=True)
def cpu_mesh():
    """The port's default mesh is 8 CPU ranks (the JAX package's CPU
    platform has 8 devices), put back after the test."""
    before = IciMesh._default
    IciMesh.set_default(IciMesh(8, device="cpu"))
    yield
    IciMesh.set_default(before)


def _pkg(name):
    if name == "jax":
        return jrpc, jpb
    return trpc, tpb


def _echo_service(rpc, pb):
    class Echo(rpc.Service):
        SERVICE_NAME = "EchoService"

        @rpc.method(pb.EchoRequest, pb.EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            cntl.response_attachment.append(cntl.request_attachment)
            done()
    return Echo()


def _start_and_echo(name, start_args, target_of, options=None):
    """Start a server with ``start(*start_args, options=options)``, echo
    4 KiB to it through a Channel at ``target_of(server)``; returns what
    a user sees."""
    rpc, pb = _pkg(name)
    server = rpc.Server()
    server.add_service(_echo_service(rpc, pb))
    kw = {} if options is None else {"options": options(rpc)}
    assert server.start(*start_args, **kw) == 0
    ep = server.listen_endpoint
    ch = rpc.Channel()
    try:
        assert ch.init(target_of(server),
                       options=rpc.ChannelOptions(timeout_ms=10000)) == 0
        cntl = rpc.Controller()
        cntl.request_attachment.append(b"\x5a" * 4096)
        resp = ch.call_method("EchoService.Echo", cntl,
                              pb.EchoRequest(message="hi"),
                              pb.EchoResponse)
        assert not cntl.failed(), cntl.error_text
        return {"scheme": ep.scheme, "host": ep.host,
                "bound_port": ep.port > 0, "message": resp.message,
                "attachment": cntl.response_attachment.to_bytes(),
                "idle_timeout_s": server.options.idle_timeout_s,
                "again": server.start(*start_args)}
    finally:
        ch.close()
        server.stop()


_FORMS = {
    "int_port": ((0,), lambda s: f"127.0.0.1:{s.listen_endpoint.port}"),
    "bare_name": (("entry-bare",), lambda s: "mem://entry-bare"),
    "none": ((), lambda s: "mem://server"),
}


@pytest.mark.parametrize("form", sorted(_FORMS))
@pytest.mark.parametrize("name", PKGS)
def test_server_start_address_forms_like_jax(name, form):
    args, target = _FORMS[form]
    got = _start_and_echo(name, args, target)
    assert got == _start_and_echo("jax", args, target)
    assert got["message"] == "hi" and len(got["attachment"]) == 4096
    assert got["scheme"] == ("tcp" if form == "int_port" else "mem")
    assert got["again"] != 0          # a running server refuses a start


@pytest.mark.parametrize("name", PKGS)
def test_server_start_options_replace_the_servers(name):
    def options(rpc):
        return rpc.ServerOptions(idle_timeout_s=7)
    got = _start_and_echo(name, ("mem://entry-opts",),
                          lambda s: "mem://entry-opts", options)
    assert got["idle_timeout_s"] == 7
    assert got == _start_and_echo("jax", ("mem://entry-opts",),
                                  lambda s: "mem://entry-opts", options)


# ---- six bands, from the admission options -----------------------------

def _six_band_serving(name):
    """A decode worker on mem:// whose server, pool and scheduler take
    ``AdmissionOptions(bands=6)``; one session at each priority 0-5
    loaded and decoded.  Returns each session's tokens, the reference's
    and the worker's band counts."""
    rpc, pb = _pkg(name)
    serving, workers, model = ((jserving, jworkers, jmodel) if name == "jax"
                               else (tserving, tworkers, tmodel))
    ref_kw = {} if name == "jax" else {"device": "cpu"}
    adm = (jadmission if name == "jax" else tadmission).AdmissionOptions(
        bands=6)
    addr = f"mem://entry-six-{name}"
    server = workers.start_decode_worker(
        addr, options=rpc.ServerOptions(admission=adm),
        pool_options=serving.KvPoolOptions.from_admission(
            adm, bytes_per_token=model.KV_LAYERS * model.KV_DMODEL,
            num_blocks=64, block_tokens=8),
        sched_options=serving.BatchSchedulerOptions(
            vocab=model.VOCAB, max_batch=4, bands=adm.bands,
            default_priority=adm.default_priority))
    ch = rpc.Channel()
    ch.init(addr, options=rpc.ChannelOptions(timeout_ms=30000))
    want, results = {}, {}
    try:
        specs = {pri: [(7 * pri + j) % 499 for j in range(12 + 4 * pri)]
                 for pri in range(6)}
        for pri, tokens in specs.items():
            kv = np.asarray(model.toy_kv_blocks(tokens, **ref_kw)).tobytes()
            cntl = rpc.Controller()
            cntl.priority = pri
            cntl.request_attachment.append(kv)
            ch.call_method("Decode.LoadKv", cntl, pb.EchoRequest(
                message=json.dumps({"session": f"s{pri}",
                                    "seq_len": len(tokens),
                                    "last_token": tokens[-1]})),
                pb.EchoResponse)
            assert not cntl.failed(), (pri, cntl.error_text)
            want[pri] = model.reference_generate(tokens, 5, **ref_kw)

        def decode(pri):
            cntl = rpc.Controller()
            cntl.priority = pri
            resp = ch.call_method("Decode.Decode", cntl, pb.EchoRequest(
                message=json.dumps({"session": f"s{pri}", "steps": 5})),
                pb.EchoResponse)
            results[pri] = (cntl.error_text if cntl.failed()
                            else json.loads(resp.message)["tokens"])
        threads = [threading.Thread(target=decode, args=(p,))
                   for p in specs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        bands = server.admission.options.bands
        return dict(results), want, bands, \
            server.services()["Decode"].pool.options.bands
    finally:
        ch.close()
        for svc in server.services().values():
            if hasattr(svc, "close"):
                svc.close()
        server.stop()


@pytest.mark.parametrize("name", PKGS)
def test_six_band_admission_serves_like_jax(name):
    got, want, adm_bands, pool_bands = _six_band_serving(name)
    assert got == want and sorted(got) == list(range(6))
    assert adm_bands == pool_bands == 6
    assert got == _six_band_serving("jax")[0]


# ---- the scheduler's preemption options --------------------------------

def _rows(model, tokens, **kw):
    kv = np.asarray(model.toy_kv_blocks(tokens, **kw))
    seq = len(tokens)
    return kv.reshape(model.KV_LAYERS, seq, model.KV_DMODEL).transpose(
        1, 0, 2).reshape(seq, model.KV_LAYERS * model.KV_DMODEL)


def _preempt_run(name, preempt):
    """Roster of 2 filled by two batch-band sessions (priority 3), then an
    interactive arrival (priority 0) behind them; driven step by step.
    Returns (preempted, tokens by session, reference by session, the
    step at which the interactive session finished)."""
    serving, model = ((jserving, jmodel) if name == "jax"
                      else (tserving, tmodel))
    kw = {} if name == "jax" else {"device": "cpu"}
    pool = serving.PagedKvPool(serving.KvPoolOptions(
        bytes_per_token=model.KV_LAYERS * model.KV_DMODEL, num_blocks=32,
        block_tokens=8, use_timers=False), **kw)
    sched = serving.ContinuousBatchScheduler(
        pool, serving.BatchSchedulerOptions(
            vocab=model.VOCAB, max_batch=2, auto_start=False,
            interactive_priority_max=1, preempt=preempt))
    specs = {"b0": ([(3 * j + 1) % 499 for j in range(16)], 8, 3),
             "b1": ([(5 * j + 2) % 499 for j in range(20)], 8, 3),
             "i0": ([(7 * j + 3) % 499 for j in range(12)], 4, 0)}
    out, done_at = {}, {}
    try:
        for s, (tokens, _, _) in specs.items():
            pool.load(s, _rows(model, tokens, **kw), last_token=tokens[-1])

        def submit(s):
            tokens, steps, pri = specs[s]
            sched.submit(serving.StepRequest(
                s, steps, lambda t, s=s: out.__setitem__(s, list(t)),
                lambda code, text, hint, s=s: out.__setitem__(
                    s, ("failed", code, text)), priority=pri))
        submit("b0")
        submit("b1")
        sched.step_once()
        sched.step_once()
        submit("i0")
        for step in range(40):
            sched.step_once()
            if "i0" in out and "i0" not in done_at:
                done_at["i0"] = step
            if len(out) == 3:
                break
        want = {s: model.reference_generate(tokens, steps, **kw)
                for s, (tokens, steps, _) in specs.items()}
        return (sched.preempted.get_value(), out, want, done_at.get("i0"))
    finally:
        sched.stop()
        pool.close()


@pytest.mark.parametrize("preempt", [False, True])
@pytest.mark.parametrize("name", PKGS)
def test_scheduler_preempt_option_like_jax(name, preempt):
    preempted, out, want, i0_at = _preempt_run(name, preempt)
    assert out == want
    if preempt:
        assert preempted >= 1
    else:
        assert preempted == 0
    jax_preempted, jax_out, _, jax_i0_at = _preempt_run("jax", preempt)
    assert (preempted, out, i0_at) == (jax_preempted, jax_out, jax_i0_at)


# ---- LALB's per-call exclusion -------------------------------------------

@pytest.mark.parametrize("name", PKGS)
def test_lalb_per_call_exclusion_off_the_instance_dict(name):
    lbs, parse = (jlbs, jparse) if name == "jax" else (tlbs, tparse)
    eps = [parse(f"ici://{i}") for i in range(3)]
    lb = lbs.LocalityAwareLB()
    for ep in eps:
        lb.add_server(ep)

    class OnTheClass:
        _excluded_servers = {eps[0], eps[1]}

    picks = {lb.select_server(OnTheClass()) for _ in range(20)}
    assert picks == {eps[2]}
    assert isinstance(lb, lbs.LoadBalancer)
    d = lb.describe()
    assert sorted(d) == sorted(str(ep) for ep in eps)
    assert d[str(eps[2])]["inflight"] == 20


def test_port_pick_leaves_an_unread_exclusion_field_unmaterialized():
    lb = tlbs.LocalityAwareLB()
    for i in range(3):
        lb.add_server(tparse(f"ici://{i}"))
    cntl = trpc.Controller()
    assert lb.select_server(cntl) is not None
    assert "_excluded_servers" not in cntl.__dict__
    cntl._excluded_servers.add(tparse("ici://0"))
    cntl._excluded_servers.add(tparse("ici://1"))
    assert {lb.select_server(cntl) for _ in range(10)} == {
        tparse("ici://2")}
