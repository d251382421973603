"""chip_smoke.py — build the port's kernels and drive its main path on one
NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device; exits non-zero (and prints no result) without one.
Phases, each fatal on failure:

  1. build      compile csrc/p2p_copy.cu, csrc/ring_all_reduce.cu,
                csrc/ring_all_gather.cu and an empty kernel with nvcc
                (sm_90a), one nvcc each, all started together, and load
                them; beside them g++ builds the native ici:// core
                (csrc/ici_native.cpp, butil/native.py) and it is loaded:
                a build or load failure is fatal here, so the run never
                falls back to the Python plane quietly
  2. kernel     p2p_copy against its plain version at 4 KiB, 65,537 B
                (misaligned source), 512 KiB and 2 MiB (phase 8's KV
                handoffs), 4 MiB, 4 MiB (source and destination
                misaligned), 32 MiB and 256 MiB: bit-exact, timed beside
                the HBM bound 2·n / 3.35 TB/s by two harnesses, kernel,
                plain version and Tensor.copy_ alike, in turns, twice (the
                second round in reverse order), each keeping the better
                median:
                - single launch: CUDA events around one launch, median of
                  25, the 50 MB L2 flushed before each, a spin ahead;
                - back to back: up to 256 launches between one pair of
                  events, divided by the count, over a rotation of source
                  and destination slices from two 128 MiB pools (so each
                  launch finds its source cold), a spin ahead long enough
                  for the host to enqueue them all; the same loop around
                  an empty kernel (built in phase 1 beside the others)
                  gives the method's floor.
                And host µs per launch of p2p_copy and copy_.  The
                harnesses live in brpc_tpu_torch/tools/timing.py.  The
                kernel's candidate shapes (a TMA bulk-copy pipeline,
                register spans, a 4-chunk stream, cache flavours) were
                timed against it and copy_ in turns, one line each, in one
                call, by sweeps/sweep_p2p_copy.py; the kernel keeps only
                the winner, and the losers' code stays in
                sweeps/p2p_copy_candidates.cu
  3. plane      the device-plane echo of the JAX package's
                bench_device_plane: IciMesh(ranks=8) on the card, server on
                ici://0 answering inline, payload owned by rank 1,
                threshold 1 so every attachment rides the plane; 300 calls
                at 4 KiB (p50/p99 µs), 16 at 4 MiB (GB/s).  Phases 3 and 4
                run on both front doors in turns (native, Python, Python,
                native): native_ici=True, the default and bench.py's, and
                native_ici=False, the Python plane.  On the native door
                the 4 KiB calls are its requests, one each
                (ServerBinding.requests()); a 4 MiB frame is over the
                native window (4 MiB with 64 KiB of headroom) and rides
                the Python plane, so the native count does not move
  4. echo       the default 64 KiB threshold with an Echo service that
                returns the attachment: 64 KiB and 4 MiB ride the plane,
                4 KiB takes mesh.device_put; returned bytes must match
  5. ring       ring_all_reduce and ring_all_gather against their plain
                versions, bit-exact (max abs err 0): n = 8 in float32 at
                64 MiB in all (bench.py's allreduce size) and 1 GiB, timed
                like phase 2 beside their HBM bounds and a library
                yardstick; then bfloat16, float16, int32, a ragged chunk of
                1,003 elements, a row that is not 16-byte aligned, and
                n = 2, 3 and 20
  6. collectives  the collectives path at full width on IciMesh(ranks=8):
                64 MiB and 1 GiB of float32 gradients through
                Collectives.all_reduce (psum), ring.ring_all_reduce and
                pallas_ring.ring_all_reduce (GB/s = input bytes over host
                time per call, as bench.py's bench_allreduce_gbps; the ring
                equals the kernel bit for bit, psum within 1e-6·n·max Σ|x|),
                ring_all_gather at both sizes, a CollectiveChannel
                tensor-parallel matvec (weight (8, 4096, 4096), MAP_SHARD +
                MERGE_SUM, rtol 1e-5 against the dense product in float64)
                and a MERGE_GATHER method with takes_index, a RingStream of
                6 chunks with window 2, and ring_attention (causal and not)
                and ulysses_attention at bench_ring_attention's shape (seq
                4096 over 8 ranks, 8 heads, dim 128, float32, TF32 off)
                against reference_attention within rtol = atol = 1e-4
  7. card tests  python -m pytest --noconftest -m cuda
                tests/test_torch_cuda.py in a process of its own
  8. serving    disaggregated prefill/decode on IciMesh(ranks=8): the
                router on mem://, prefill on rank 1, decode on ranks 2 and
                3, each decode pool 65,536 blocks of 16 tokens x 1,024 B
                (a 1 GiB KV arena and an 8 MiB reduction arena) on the
                card, plane threshold 64 KiB.  (a) 2 warm-ups, then 20
                Router.Generate of 512 tokens x 64 steps from 2 client
                threads (bench.py's serving leg) and 4 of 2,048 tokens,
                every result equal to reference_generate on the card;
                (b) 64 sessions of 512 tokens and 2 of 2,048 loaded with
                Decode.LoadKv, then 64 Decode calls of 64 steps issued
                asynchronously, so the batched step runs at max_batch =
                64; every loaded session's pool rows (materialize) equal,
                byte for byte, the token-major permute of the KV sent; the
                step's wall and device µs at roster 64; (c) the card's prefill
                bytes against the CPU's on the same prompts (printed).
                The router's mem:// calls take the loopback plane (the
                reference's default): the calls it served are printed
  9. tiers      phase 8's layout, each decode pool also holding 65,536
                host blocks (a 1 GiB pinned arena), after 2 Generates:
                (a) 576 sessions of 2,048 tokens loaded on rank 2 with
                Decode.LoadKv, 1.125x the device arena, so at least 64
                demote under pressure; 32 demoted sessions decoded 64
                steps (each restored at the roster add), tokens equal to
                reference_generate and rows equal, byte for byte, to the
                KV sent; spill and restore GB/s (the pool's copy bytes
                over copy time), restore p50 µs, describe()["tiers"], and
                a pinned copy_ of one session's 2 MiB each way as the host
                link's yardstick; (b) 64 sessions of 512 tokens moved rank
                2 -> rank 3 with Decode.MigrateOut (one p2p_copy each on
                the plane), each cutover LoadAwareRouter.rebind, the
                follow-up Decodes routed by session equal to
                reference_generate, rank 2 holding none of them; migration
                p50 ms and payload GB/s; (c) rank 3's MigrateIn
                black-holed: one migration trips the 500 ms transfer
                deadline (migrate_down 1), the next refuses fast, the
                source serves throughout, and after
                serving_migrate_reprobe_s the plane revives on its timer
                and the migration lands
 10. admission, drain, elastic  (a) bench.py's overload leg
                (_overload_one_plane) on ici://5: max_concurrency 2, the
                usercode pool with 4 threads, AdmissionOptions(max_queue_ms
                10, queue_capacity 64), a 20 ms Echo (100 rps); 1.2 s at 50
                rps of priority 0 from t0, then 3 s at 1,000 rps from 4
                tenants (per tenant a priority-0 stream at 62.5 rps and two
                priority-3 streams at 93.75), one paced thread and Channel
                (max_retry 0) per stream; every request carries a 4 MiB
                DEVICE attachment owned by rank 6 or 7 that rides the
                plane, the handler holds it equal to what was sent and
                returns it, the client holds the answer equal too.  Every
                shed is ELIMIT with a retry_after_ms hint, no tenant's
                served priority-0 count is under half the mean, launches =
                transfers = requests received + attachments returned, no
                transfer is active after the stop and device memory is
                back within 64 MiB; the p99 ratio is printed, not gated.
                (b) ici://5 with graceful_shutdown_s 5 and a 50 ms
                handler: 8 calls with 4 MiB attachments in flight through
                stop(); they complete OK, calls after the flip get
                ELOGOFF, the client saw the GOODBYE, nothing is active or
                pending when stop() returns, launches = transfers; a
                restart serves again.  (c) phase 8's layout: 64 sessions
                of 512 tokens on rank 3; 20 Generates from 2 clients; a
                LoadThresholdAutoscaler (samples_to_scale 2, sizes 1-2)
                over the decode workers' (roster + queue) / (size x
                max_batch), ticked at fixed points: after the 5th Generate
                two idle ticks drain rank 3 (MigrateOut of every live
                session to rank 2) and scale it down
                (remove_decode_target, stop(grace 5 s)); after the 15th,
                the 64 migrated sessions decode 1,024 steps on rank 2 at
                once, load 1.0, and two ticks scale rank 3 back up
                (restart, add_decode_target); 4 more Generates, one at
                least on rank 3.  Every Generate and migrated session
                equals reference_generate, generate_failures is 0,
                scale_downs and scale_ups are 1, rank 3's stop returned
                with nothing in flight, launches = transfers = LoadKv +
                MigrateIn received

 11. streaming  on IciMesh(ranks=8), the socket window raised to 256 MiB:
                (a) bench_streaming_mbps's leg (bench.py:697-768) at its
                own shape, 64 KiB host chunks for 1.5 s through an 8 MiB
                stream window to ici://6, MB/s received against sent;
                (b) 256 DEVICE chunks of 4 MiB (1 GiB of seeded bytes on
                rank 4) to a server on ici://3 through a 64 MiB window:
                the server holds every chunk equal, byte for byte on the
                card, to its slice of the source; launches = plane
                transfers = DATA frames with a device block = 256; device
                memory is back to its level after the close; MB/s and the
                p50 of a chunk's one-way time (write call to handler);
                (c) a stop(grace 0.5 s) of ici://2 with a 4 MiB-chunk
                stream open, 8 chunks written before the flip and 8 inside
                the window: past the window the server closes the stream
                with an orderly CLOSE, the client's stream ends by it, and
                every byte written was received, equal
 12. fan-out    8 echo servers on ici://0-7 (usercode_inline), one Channel
                each: (a) bench_parallel_fanout_us's shape, a
                ParallelChannel over the 8, 60 calls after 10 warm-ups,
                echo p50 µs; (b) 64 MiB of float32 on rank 0, a CallMapper
                giving each member one 8 MiB DEVICE shard, each member
                returning its shard times its rank and a merger
                concatenating them by index: the result equals the plain
                product on the card; the member on rank 0 takes its shard
                by reference, so launches = transfers = 7 shards out + 8
                answers back; (c) a PartitionChannel of 4 partitions from
                a list:// url with i/4 tags (ici://4-7), 16 MiB shards the
                same way, equal, launches = transfers = 8; (d) a
                SelectiveChannel over ici://5-7 with ici://6 stopped: 30
                calls all succeed, retries counted
 13. collective fan-out  8 servers on ici://0-7, each registering device
                bodies (Server.register_collective) beside their wire
                methods: (a) bench_collective_fanout's shape (bench.py:
                823-954): 512 B uint8 shards, 10 warm-ups and 80 timed
                calls each of the compiled gather on a pre-sharded operand
                (shard_operand), the compiled MERGE_NONE and the per-member
                loop (ici_fanout_collective off, a numpy operand); beside
                them bench_collective_single's denominator (bench.py:
                956-1016), 200 single 512 B echoes to ici://0 after 20
                warm-ups; every call's route is checked (collective or
                rpc as meant).  (b) 64 MiB of float32 in 8 shards of 8 MiB,
                a shard-and-gather method (x2) and a replicate-and-sum
                method on a 64 MiB operand, each compiled and degraded, 1 +
                10 calls each: compiled and degraded results equal (bit-
                exact gather; sum within rtol = atol = 1e-6), the compiled
                leg launches neither p2p_copy nor a ring kernel, the
                degraded leg's p2p_copy launches equal its plane transfers
                and are > 0.  (c) FabricFaultPlan(collective_kill_device=4):
                the calls degrade in-call with no failure, the route stays
                down after the plan is cleared, and comes back when ici://4's
                server restarts; degraded_member_killed and
                revived_member_killed each +1, the sequencer's assigned ==
                executed
 14. rpcz       phase 3's echo (Sink.Push on ici://0, 4 KiB owned by rank
                1, threshold 1): 150 calls after 10 warm-ups in each of
                three modes, rpcz off, rpcz on, rpcz on with
                tpu_std_stage_metrics=on, in turns there and back; the five
                tpu_std_server_<stage> p50s; then, in a fresh sampling
                second, 20 calls each with one client and one server span
                in one trace (the server's parented under the client's)
                and a transfer span under the client span carrying posted,
                recv enqueued, matched and complete; the profiler
                (rpc/profiler.py) over 200 calls with rpcz off and 200 with
                it on, on the caller's thread: host µs per call and the ten
                functions rpcz adds the most to; its device trace
                (torch.profiler) around 4 calls, which must show the copy
                kernel; Builtin.Call over ici:// for vars, status and ici
                (rpcz off), whose device-plane counters equal plane.stats(),
                whose route events show phase 13's selected fan-outs, which
                keeps the last 64 transfers' timelines, and whose device
                byte total equals the transport's
 15. call features  4 MiB DEVICE attachments owned by rank 1, echoed by
                servers on ici://3 and ici://4 (handlers on the backup
                pool), the socket window raised to 256 MiB: (a) 16 plain
                calls, 8 whose every try stalls 40 ms without a backup,
                and 32 with backup_request_ms=10 whose first try stalls
                40 ms: both tries of each cross on p2p_copy, the answers
                are bit-exact, the late ones dropped; hedged p50 against
                unhedged, the backup tries' share; (b) 8 calls into a
                200 ms handler, each cancelled once its attachment crossed:
                ECANCELED, cancel-to-callback µs, the late answers cross
                back and are dropped; (c) FaultInjector(drop_ratio=0.3,
                seed=15) on every write with retry_on_timeout, 10 tries of
                a 1 s deadline: 16 calls all answer, drops > 0, and the
                plane's transfers equal the writes that passed (a dropped
                frame posts nothing); (d) 8 pooled calls hold one
                connection (SocketMap.stats() and the server's), 8 short
                ones close theirs; (e) rpc_dump on for 16 calls, then
                rpc_replay of the files against a fresh server on ici://5:
                the replayed frames equal the dumped ones but for their
                correlation ids, and the answers equal the calls'.  Every
                path: launches = plane transfers > 0, device memory back
                within 64 MiB, no transfer left active
 16. native     the native front door at full width, threshold 1: (a)
                phase 3's Sink echo on ici://0 from rank 1, 300 calls at 4
                KiB after 20 warm-ups: native requests = calls, p2p_copy
                launches = relocations that crossed ranks = plane
                transfers, and after the last completion no transfer is
                active and no device ref is left in native custody; (b) an
                Echo returning the attachment, 64 calls at 4 KiB: the bytes
                come back equal on the card, owned by rank 1, 2 launches a
                call; (c) a stop of ici://2 with 8 native calls parked in
                their handler, each with a 64 KiB attachment that crossed:
                each fails with the dead-peer code, no key and no transfer
                outlives it; (d) the C++ echo loop's p50
                (brpc_tpu_ici_echo_p50_ns), host frame and a resident
                device ref; (e) phase 10's overload leg with the server on
                the native door, its attachments cut to 4 MiB - 128 KiB so
                a frame fits the native window; every request is a native
                request, launches = transfers = requests received +
                attachments returned; the priority-0 p99 ratio is printed

Launch counts are zeroed just before each path and read just after it:
during phases 3-4 and during phase 8 p2p_copy's launches must equal the
plane's transfers (in phase 8 also the LoadKv calls the servers
received); during phase 9 they must equal the transfers and the LoadKv
plus MigrateIn calls the servers received; during phase 10 they must
equal the transfers and, in (a) and (b), the requests the server received
plus the attachments it returned, in (c) the LoadKv and MigrateIn calls
the servers received (bounced ones included); during phases 11 and 12
they must equal the transfers (in 11 (b) also the DATA frames with a
device block, in 12 (b)-(c) the sub-calls' legs that crossed); during
phases 13, 14 and 15 they must equal the transfers (in 13 the degraded
leg's; the compiled leg launches none; in 15 on each of its paths), and
no ring kernel may launch there; during phase 16 they must equal the
transfers and the relocations that crossed ranks on the device plane (in
(e) also the requests received plus the attachments returned); during
phase 6 each ring kernel's launches must equal the calls of its entry
point.  The line before the last is the ``kernels`` JSON; the last line
is the device JSON.
"""
from __future__ import annotations

import gc
import json
import random
import statistics
import subprocess
import threading
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from brpc_tpu_torch.tools.timing import (HBM_BYTES_PER_S, SPIN_CYCLES,
                                         TIMED_RUNS, Rotation, b2b_in_turns,
                                         empty_kernel, host_us,
                                         nvidia_smi_line, spin_cycles_per_us,
                                         time_in_turns)

ROOT = Path(__file__).resolve().parent
# phase 2: the copies (label, bytes, src offset, dst offset)
# (512 KiB and 2 MiB are the KV handoffs of phase 8's 512- and 2,048-token
# prompts)
KERNEL_CASES = (("4 KiB", 4096, 0, 0), ("65,537 B src+3", 65537, 3, 0),
                ("512 KiB", 512 << 10, 0, 0), ("2 MiB", 2 << 20, 0, 0),
                ("4 MiB", 4 << 20, 0, 0), ("4 MiB src+1 dst+7", 4 << 20, 1, 7),
                ("32 MiB", 32 << 20, 0, 0), ("256 MiB", 256 << 20, 0, 0))
# phases 5-6: total float32 bytes over the 8 ranks (bench.py's allreduce
# size and the north star's 1 GiB), the matvec width, and
# bench_ring_attention's (seq, heads, dim)
RING_SIZES = (("64 MiB", 64 << 20), ("1 GiB", 1 << 30))
MATVEC_D = 4096
ATTENTION = (4096, 8, 128)
# phase 8: bench.py's serving leg (prompt length, decode steps, prompts,
# warm-ups, client threads), the long prompts, the full roster and a
# decode worker's pool on one card (1 M tokens of the toy model)
SERVE_PROMPT, SERVE_STEPS, SERVE_PROMPTS, SERVE_WARM, SERVE_THREADS = \
    512, 64, 20, 2, 2
SERVE_LONG, SERVE_LONG_PROMPTS = 2048, 4
SERVE_ROSTER = 64
SERVE_POOL_BLOCKS, SERVE_BLOCK_TOKENS = 65536, 16
# phase 9: phase 8's layout with a 1 GiB pinned host arena per decode pool;
# 2,048-token sessions to 1.125x the device arena (64 demote), 32 of the
# demoted decoded back, 64 migrations of 512-token sessions, and the
# black-holed migration's deadline
TIER_HOST_BLOCKS = SERVE_POOL_BLOCKS
TIER_SESSIONS, TIER_DECODED = 576, 32
MIGRATE_SESSIONS = 64
LATCH_DEADLINE_MS = 500
# phase 10 (a): bench.py's overload leg (_overload_one_plane: capacity 2 /
# 20 ms = 100 rps, 10x offered over 4 tenants, 1.2 s unloaded then 3 s)
# with 4 MiB DEVICE attachments from ranks 6 and 7, a bank of patterns per
# rank, and the device memory the run may leave behind; (b) the drain's
# calls, handler and grace; (c) the elastic fleet's held sessions, the
# Generate counts at which the autoscaler acts, the steps of the Decodes
# that load rank 2, and the bound on the restarted worker's revival
ADM_PAYLOAD, ADM_PATTERNS = 4 << 20, 4
ADM_SERVICE_MS, ADM_MAX_CONC, ADM_FACTOR = 20.0, 2, 10
ADM_TENANTS = ("t0", "t1", "t2", "t3")
ADM_UNLOADED_S, ADM_OVERLOAD_S = 1.2, 3.0
ADM_MEMORY_SLACK = 64 << 20
ADM_WINDOW_BYTES = 256 << 20
DRAIN_CALLS, DRAIN_LATE_CALLS, DRAIN_SERVICE_MS, DRAIN_GRACE_S = \
    8, 4, 50.0, 5.0
ELASTIC_HELD, ELASTIC_DOWN_AT, ELASTIC_UP_AT, ELASTIC_AFTER = 64, 5, 15, 4
ELASTIC_LOAD_STEPS, ELASTIC_GRACE_S, ELASTIC_REVIVE_S = 1024, 5.0, 15.0
# phase 11: bench_streaming_mbps's leg (64 KiB host chunks for 1.5 s), the
# stream of tensors (256 chunks of 4 MiB, 1 GiB in all, through a 64 MiB
# stream window) and the stop with a stream open (16 chunks, half of them
# written inside the grace window)
STREAM_HOST_CHUNK, STREAM_HOST_S = 64 * 1024, 1.5
STREAM_CHUNKS, STREAM_CHUNK, STREAM_WINDOW = 256, 4 << 20, 64 << 20
STOP_CHUNKS, STOP_GRACE_S = 16, 0.5
# phase 12: bench_parallel_fanout_us's iterations, the sharded tensor and
# the selective channel's calls
FANOUT_ITERS, FANOUT_BYTES, SELECTIVE_CALLS = 60, 64 << 20, 30
# phase 13: bench_collective_fanout's shard and timed calls,
# bench_collective_single's calls, and the calls a 64 MiB leg is timed over
FANOUT_SHARD, FANOUT_COLL_ITERS, FANOUT_SINGLE_ITERS = 512, 80, 200
FANOUT_BIG_ITERS = 10
# phase 14: echo calls per mode and turn, the calls whose spans are
# checked one by one, and the echo calls profiled in each rpcz mode
RPCZ_CALLS, RPCZ_TRACED = 150, 20
RPCZ_PROFILED = 200
# phase 15: the attachment, the hedged calls and the first try's stall,
# the backup delay, the cancelled calls and their handler's sleep, the
# calls through seeded drops (drop ratio, seed, tries a call and the
# deadline they split), the calls per connection type, the dumped calls,
# and the device memory a path may leave behind
CF_PAYLOAD, CF_HEDGED, CF_STALL_MS, CF_BACKUP_MS = 4 << 20, 32, 40, 10
CF_CANCELS, CF_CANCEL_SLEEP_MS = 8, 200
CF_DROP_CALLS, CF_DROP_RATIO, CF_DROP_SEED = 16, 0.3, 15
CF_DROP_TRIES, CF_DROP_TIMEOUT_MS = 10, 1000
CF_CONN_CALLS, CF_DUMP_CALLS = 8, 16
CF_MEMORY_SLACK = 64 << 20
# phase 16: the native front door
NATIVE_CALLS, NATIVE_ECHO_CALLS, NATIVE_STOP_CALLS = 300, 64, 8
NATIVE_LOOP_ITERS = 3000
# phase 10's overload leg on the native door: the attachment is cut so a
# frame fits the native window (4 MiB, with 64 KiB of headroom)
NATIVE_ADM_PAYLOAD = (4 << 20) - (128 << 10)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase_kernel(p2p_copy, p2p_copy_plain, empty, dev) -> list:
    empty_rec = empty.record(dev.index)

    def empty_call(src, dst):
        empty.launch(empty_rec)

    cycles_per_us = spin_cycles_per_us()
    rows = []
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for label, n, so, do in KERNEL_CASES:
        src_buf = torch.randint(0, 256, (n + so,), dtype=torch.uint8,
                                device=dev, generator=gen)
        src = src_buf[so:]
        dst = torch.empty(n + do, dtype=torch.uint8, device=dev)[do:]
        ref = torch.empty(n, dtype=torch.uint8, device=dev)
        lib = torch.empty(n, dtype=torch.uint8, device=dev)
        p2p_copy(src, dst)
        p2p_copy_plain(src, ref)
        torch.cuda.synchronize()
        err = int((dst.int() - ref.int()).abs().max().item())
        check(err == 0, f"p2p_copy differs from its plain version at "
                        f"{label}: max abs err {err}")
        check(torch.equal(ref, src), f"plain version wrong at {label}")
        best = time_in_turns({"ms": lambda: p2p_copy(src, dst),
                              "plain_ms": lambda: p2p_copy_plain(src, ref),
                              "library_ms": lambda: lib.copy_(src)}, flush)
        ms, plain_ms, library_ms = (best["ms"], best["plain_ms"],
                                    best["library_ms"])
        check(torch.equal(dst, src), f"p2p_copy wrong after timing, {label}")
        bound_ms = 2 * n / HBM_BYTES_PER_S * 1e3
        rot = Rotation(n, so, do, dev, gen)
        b2b = b2b_in_turns({"ms": p2p_copy, "plain_ms": p2p_copy_plain,
                            "library_ms": lambda s, d: d.copy_(s),
                            "empty_ms": empty_call}, rot, cycles_per_us)
        for s_, d_ in rot.pairs[:4]:
            check(torch.equal(s_, d_), f"p2p_copy wrong in the rotation, "
                                       f"{label}")
        row = {"label": label, "bytes": n, "src_offset": so,
               "dst_offset": do,
               "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
               "b2b": {**b2b, "launches_per_window": rot.window,
                       "pairs": len(rot.pairs),
                       "share_of_bound": bound_ms / b2b["ms"],
                       "library_share_of_bound": bound_ms / b2b["library_ms"]},
               "host_us": host_us(lambda: p2p_copy(src, dst)),
               "library_host_us": host_us(lambda: lib.copy_(src))}
        rows.append(row)
        print(f"kernel {label:>18}: single launch: p2p_copy "
              f"{ms * 1e3:8.2f} us  plain {plain_ms * 1e3:8.2f}  copy_ "
              f"{library_ms * 1e3:8.2f}  bound {bound_ms * 1e3:8.2f} us  "
              f"share {bound_ms / ms:6.1%} (copy_ {bound_ms / library_ms:6.1%})"
              f"  err {err}", flush=True)
        print(f"kernel {label:>18}: back to back ({rot.window} launches, "
              f"{len(rot.pairs)} pairs): p2p_copy {b2b['ms'] * 1e3:8.2f} us  "
              f"plain {b2b['plain_ms'] * 1e3:8.2f}  copy_ "
              f"{b2b['library_ms'] * 1e3:8.2f}  empty kernel "
              f"{b2b['empty_ms'] * 1e3:6.2f}  share "
              f"{bound_ms / b2b['ms']:6.1%} (copy_ "
              f"{bound_ms / b2b['library_ms']:6.1%});  host "
              f"{row['host_us']:6.2f} vs {row['library_host_us']:6.2f} us",
              flush=True)
        del src_buf, src, dst, ref, lib, rot
        torch.cuda.empty_cache()
    del flush
    return rows


def make_payload(mesh, nbytes: int, rank: int, seed: int):
    data = np.random.default_rng(seed).integers(0, 256, nbytes,
                                                dtype=np.uint8)
    return data, mesh.device_put(torch.from_numpy(data), rank)


def phase_plane_echo(rpc, mesh, plane, p2p_copy, EchoRequest, EchoResponse,
                     native=True):
    from brpc_tpu_torch.butil import flags

    class Sink(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Push(self, cntl, request, response, done):
            # consume, don't bounce: one plane transfer per frame piece,
            # so the transfer counter proves the datapath
            response.message = str(len(cntl.request_attachment))
            done()

    flags.set_flag("ici_device_plane_threshold", 1)
    server = rpc.Server(rpc.ServerOptions(usercode_inline=True,
                                          native_ici=native))
    server.add_service(Sink())
    check(server.start("ici://0") == 0, "server start on ici://0")
    binding = server._native_ici
    check((binding is not None) == native,
          f"native door {'closed' if native else 'open'} on ici://0")

    def native_requests():
        return binding.requests() if binding is not None else 0

    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(
        timeout_ms=30000, max_retry=0))

    def drive(payload, n, warm):
        lat = []
        for i in range(n + warm):
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(payload)
            t0 = time.perf_counter_ns()
            resp = ch.call_method("Sink.Push", cntl, EchoRequest(message="d"),
                                  EchoResponse)
            t1 = time.perf_counter_ns()
            check(not cntl.failed(), f"Sink.Push failed: {cntl.error_text}")
            check(resp.message == str(payload.shape[0]),
                  f"server saw {resp.message} bytes, sent {payload.shape[0]}")
            if i >= warm:
                lat.append((t1 - t0) / 1000.0)
        return sorted(lat)

    try:
        out = {}
        calls = 0
        before = plane.stats()
        launches0 = p2p_copy.launches
        _, small = make_payload(mesh, 4096, 1, seed=1)
        n0 = native_requests()
        lat = drive(small, 300, warm=20)
        calls += 320
        out["native_requests_4k"] = native_requests() - n0
        check(out["native_requests_4k"] == (320 if native else 0),
              f"{out['native_requests_4k']} native requests for 320 calls "
              f"at 4 KiB ({'native' if native else 'Python'} door)")
        out["p50_us_4k"] = lat[len(lat) // 2]
        out["p99_us_4k"] = lat[int(len(lat) * 0.99)]
        big = 4 << 20
        _, payload = make_payload(mesh, big, 1, seed=2)
        n0 = native_requests()
        lat = drive(payload, 16, warm=4)
        calls += 20
        out["native_requests_4m"] = native_requests() - n0
        check(out["native_requests_4m"] == 0,
              f"{out['native_requests_4m']} native requests at 4 MiB: a "
              f"frame over the native window must ride the Python plane")
        out["gbps_4m"] = 16 * big / (sum(lat) / 1e6) / 1e9
        out["p50_us_4m"] = lat[len(lat) // 2]
        torch.cuda.synchronize()
        after = plane.stats()
        out["calls"] = calls
        out["plane_transfers"] = after["transfers"] - before["transfers"]
        out["launches"] = p2p_copy.launches - launches0
        check(out["plane_transfers"] >= calls,
              f"{out['plane_transfers']} plane transfers for {calls} calls")
        check(out["launches"] == out["plane_transfers"],
              f"p2p_copy launched {out['launches']} times for "
              f"{out['plane_transfers']} plane transfers")
    finally:
        ch.close()
        server.stop()
        flags.set_flag("ici_device_plane_threshold", 64 * 1024)
    return out


def phase_default_echo(rpc, mesh, plane, p2p_copy, EchoRequest,
                       EchoResponse, native=True):
    class Echo(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    server = rpc.Server(rpc.ServerOptions(usercode_inline=True,
                                          native_ici=native))
    server.add_service(Echo())
    check(server.start("ici://0") == 0, "server start on ici://0")
    binding = server._native_ici
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(
        timeout_ms=30000, max_retry=0))
    out = {}
    launches0 = p2p_copy.launches
    try:
        for nbytes, on_plane in ((4096, False), (64 << 10, True),
                                 (4 << 20, True)):
            data, payload = make_payload(mesh, nbytes, 1, seed=nbytes)
            t0 = plane.stats()["transfers"]
            n0 = binding.requests() if binding is not None else 0
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(payload)
            resp = ch.call_method("Echo.Echo", cntl,
                                  EchoRequest(message=f"m{nbytes}"),
                                  EchoResponse)
            took = (binding.requests() - n0) if binding is not None else 0
            # a frame over the native window rides the Python plane
            want = int(native and nbytes + 65536 <= 4 << 20)
            check(took == want, f"Echo {nbytes} B: {took} native requests, "
                                f"expected {want}")
            check(not cntl.failed(), f"Echo {nbytes} B: {cntl.error_text}")
            check(resp.message == f"m{nbytes}", "echoed message differs")
            got = cntl.response_attachment.to_bytes()
            check(got == data.tobytes(),
                  f"Echo {nbytes} B: returned bytes differ from sent")
            ranks = {mesh.rank_of(r.block.data)
                     for r in cntl.response_attachment.device_refs()}
            check(ranks == {1}, f"echoed bytes owned by ranks {ranks}")
            moved = plane.stats()["transfers"] - t0
            check((moved > 0) == on_plane,
                  f"Echo {nbytes} B: {moved} plane transfers, expected "
                  f"{'some' if on_plane else 'none'}")
            out[f"transfers_{nbytes}"] = moved
        torch.cuda.synchronize()
        out["launches"] = p2p_copy.launches - launches0
        check(out["launches"] == sum(v for k, v in out.items()
                                     if k.startswith("transfers_")),
              f"echo phase: launches {out['launches']} != transfers")
    finally:
        ch.close()
        server.stop()
    return out


def build_all(kernels) -> dict:
    """Build every kernel, one nvcc each, all started together."""
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(kernels)) as pool:
        secs = list(pool.map(lambda k: k.build(), kernels))
    out = {k.name: s for k, s in zip(kernels, secs)}
    out["wall"] = time.monotonic() - t0
    return out


def _mixed(gen, shape, dev, dtype=torch.float32, top: int = 4
           ) -> torch.Tensor:
    """Seeded values of magnitudes 1e-4..1e``top``: the ring's per-rank
    fold orders then give other last bits."""
    x = torch.randn(shape, generator=gen, device=dev)
    x *= torch.pow(10.0, torch.randint(-4, top + 1, shape, generator=gen,
                                       device=dev).float())
    return x.to(dtype)


def _bitwise_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """0 when the bits agree, else the max abs difference (inf if NaN)."""
    if torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
        return 0.0
    d = (a.double() - b.double()).abs().max().item()
    return d if d > 0 else float("inf")




def phase_ring_kernels(pr, dev) -> dict:
    n = 8
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    out = {"ring_all_reduce": [], "ring_all_gather": [], "small": []}
    for label, total in RING_SIZES:
        chunk = total // 4 // n
        rows = [_mixed(gen, (chunk,), dev) for _ in range(n)]
        x = torch.stack(rows)
        # all-reduce: kernel, plain version, torch.sum(x, 0) as yardstick
        outs = [torch.empty_like(t) for t in rows]
        pouts = [torch.empty_like(t) for t in rows]
        lib = torch.empty(chunk, device=dev)
        pr.ring_all_reduce_kernel(rows, outs)
        pr.ring_all_reduce_plain(rows, pouts)
        torch.cuda.synchronize()
        err = max(_bitwise_err(a, b) for a, b in zip(outs, pouts))
        check(err == 0, f"ring_all_reduce differs from its plain version at "
                        f"{label}: max abs err {err}")
        differs = sum(not torch.equal(outs[0], t) for t in outs[1:])
        best = time_in_turns({
            "ms": lambda: pr.ring_all_reduce_kernel(rows, outs),
            "plain_ms": lambda: pr.ring_all_reduce_plain(rows, pouts),
            "nearest_library_ms": lambda: torch.sum(x, 0, out=lib)}, flush)
        check(all(torch.equal(a, b) for a, b in zip(outs, pouts)),
              f"ring_all_reduce wrong after timing, {label}")
        bound_ms = 2 * total / HBM_BYTES_PER_S * 1e3
        row = {"label": label, "ranks": n, "bytes_in": total,
               "dtype": "float32", "max_abs_err": err,
               "rows_differing_from_rank_0": differs, **best,
               "nearest_library": "torch.sum(x, 0): one sum for all ranks, "
                                  "not the per-rank ring fold",
               "bound_ms": bound_ms, "share_of_bound": bound_ms / best["ms"]}
        out["ring_all_reduce"].append(row)
        print(f"ring {label:>7} all_reduce: kernel {best['ms'] * 1e3:9.2f} us"
              f"  plain {best['plain_ms'] * 1e3:9.2f} us  torch.sum "
              f"{best['nearest_library_ms'] * 1e3:9.2f} us  bound "
              f"{bound_ms * 1e3:9.2f} us  share {bound_ms / best['ms']:6.1%}"
              f"  err {err}  rows differing from rank 0: {differs}",
              flush=True)
        del outs, pouts, lib
        # all-gather: kernel, plain version, one expand-copy as yardstick
        gouts = [torch.empty((n, chunk), device=dev) for _ in range(n)]
        gpouts = [torch.empty((n, chunk), device=dev) for _ in range(n)]
        glib = torch.empty((n, n, chunk), device=dev)
        pr.ring_all_gather_kernel(rows, gouts)
        pr.ring_all_gather_plain(rows, gpouts)
        torch.cuda.synchronize()
        err = max(_bitwise_err(a, b) for a, b in zip(gouts, gpouts))
        check(err == 0, f"ring_all_gather differs from its plain version at "
                        f"{label}: max abs err {err}")
        runs = TIMED_RUNS if total <= 64 << 20 else 9
        best = time_in_turns({
            "ms": lambda: pr.ring_all_gather_kernel(rows, gouts),
            "plain_ms": lambda: pr.ring_all_gather_plain(rows, gpouts),
            "library_ms": lambda: glib.copy_(
                x.unsqueeze(0).expand(n, n, chunk))}, flush, runs=runs)
        check(all(torch.equal(g, x) for g in gouts),
              f"ring_all_gather wrong after timing, {label}")
        bound_ms = (n + 1) * total / HBM_BYTES_PER_S * 1e3
        row = {"label": label, "ranks": n, "bytes_in": total,
               "bytes_out": n * total, "dtype": "float32", "max_abs_err": err,
               **best, "timed_runs": runs,
               "library": "out.copy_(x.unsqueeze(0).expand(n, n, chunk))",
               "bound_ms": bound_ms, "share_of_bound": bound_ms / best["ms"]}
        out["ring_all_gather"].append(row)
        print(f"ring {label:>7} all_gather: kernel {best['ms'] * 1e3:9.2f} us"
              f"  plain {best['plain_ms'] * 1e3:9.2f} us  expand-copy "
              f"{best['library_ms'] * 1e3:9.2f} us  bound "
              f"{bound_ms * 1e3:9.2f} us  share {bound_ms / best['ms']:6.1%}"
              f"  err {err}", flush=True)
        del rows, x, gouts, gpouts, glib
        torch.cuda.empty_cache()
    # small checks: dtypes, ragged, misaligned, mesh sizes (no timing)
    cases = [(8, 1 << 20, torch.bfloat16, 0), (8, 1 << 20, torch.float16, 0),
             (8, 1 << 20, torch.int32, 0), (8, 1003, torch.float32, 0),
             (8, 1003, torch.bfloat16, 0), (8, 1 << 16, torch.float32, 1),
             (8, 1 << 16, torch.bfloat16, 3), (2, 1 << 16, torch.float32, 0),
             (3, 1 << 16, torch.float32, 0), (20, 1 << 16, torch.float32, 0),
             (20, 1003, torch.bfloat16, 0)]
    for n_, chunk, dtype, offset in cases:
        rows = []
        for _ in range(n_):
            buf = torch.empty(chunk + offset, dtype=dtype, device=dev)
            if dtype == torch.int32:
                buf[offset:] = torch.randint(-2**31, 2**31 - 1, (chunk,),
                                             generator=gen, device=dev,
                                             dtype=torch.int32)
            else:               # float16 sums stay finite below 1e2
                buf[offset:] = _mixed(gen, (chunk,), dev, dtype,
                                      top=1 if dtype == torch.float16 else 4)
            rows.append(buf[offset:])
        outs = pr.ring_all_reduce_kernel(
            rows, [torch.empty_like(t) for t in rows])
        ref = pr.ring_all_reduce_plain(
            rows, [torch.empty_like(t) for t in rows])
        gouts = pr.ring_all_gather_kernel(
            rows, [torch.empty((n_, chunk), dtype=dtype, device=dev)
                   for _ in rows])
        torch.cuda.synchronize()
        stacked = torch.stack(rows)
        err_r = max(_bitwise_err(a, b) for a, b in zip(outs, ref))
        err_g = max(_bitwise_err(g, stacked) for g in gouts)
        label = (f"n={n_} chunk={chunk} {str(dtype).split('.')[-1]} "
                 f"offset={offset}")
        check(err_r == 0 and err_g == 0,
              f"ring kernels differ from their plain versions at {label}: "
              f"all_reduce {err_r}, all_gather {err_g}")
        out["small"].append({"case": label, "all_reduce_err": err_r,
                             "all_gather_err": err_g})
    print(f"ring small checks: {len(cases)} cases bit-exact "
          f"({'; '.join(c['case'] for c in out['small'])})", flush=True)
    del flush
    return out


def _gbps(fn, nbytes: int, reps: int = 5):
    """bench.py's bench_allreduce_gbps: input bytes over the host time per
    call of ``reps`` calls ending in a synchronize.  Two warm calls: a call
    allocates its output while the previous one is still alive, so the
    caching allocator holds two sets before the timed calls reuse them."""
    for _ in range(2):
        out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    return out, nbytes / dt / 1e9, dt * 1e3


def phase_collectives(mesh, dev) -> dict:
    from brpc_tpu_torch import channels
    from brpc_tpu_torch.ici import pallas_ring as pr
    from brpc_tpu_torch.ici import ring
    from brpc_tpu_torch.ici import ring_attention as ra
    from brpc_tpu_torch.ici.collective import Collectives

    n = mesh.size
    coll = Collectives(mesh)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    calls = {"ring_all_reduce": 0, "ring_all_gather": 0}
    out = {"allreduce": [], "allgather": []}

    def kernel_reduce(x):
        calls["ring_all_reduce"] += 1
        return pr.ring_all_reduce(x)

    def kernel_gather(x):
        calls["ring_all_gather"] += 1
        return pr.ring_all_gather(x)

    # the allreduce example (examples/allreduce_performance.py): the
    # three routes side by side on the same gradients
    for label, total in RING_SIZES:
        t_phase = time.monotonic()
        grads = coll.shard(_mixed(gen, (n, total // 4 // n), dev))
        check([mesh.rank_of(t) for t in grads] == list(range(n)),
              "shard: rows not owned by their ranks")
        kern, kern_gbps, kern_ms = _gbps(lambda: kernel_reduce(grads), total)
        rng, ring_gbps, ring_ms = _gbps(
            lambda: ring.ring_all_reduce(grads), total)
        psum, psum_gbps, psum_ms = _gbps(lambda: coll.all_reduce(grads),
                                         total)
        check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(rng, kern)),
              f"{label}: ring.ring_all_reduce differs from the kernel")
        atol = 1e-6 * n * grads.stack().abs().sum(0).max().item()
        psum_err = max((psum - t).abs().max().item() for t in kern)
        check(psum_err <= atol, f"{label}: psum off the ring by {psum_err} "
                                f"> {atol}")
        row = {"label": label, "bytes": total, "psum_gbps": psum_gbps,
               "ring_gbps": ring_gbps, "kernel_gbps": kern_gbps,
               "psum_ms": psum_ms, "ring_ms": ring_ms, "kernel_ms": kern_ms,
               "psum_max_abs_diff": psum_err, "psum_atol": atol}
        del kern, rng, psum
        gathered, g_gbps, g_ms = _gbps(lambda: kernel_gather(grads), total)
        full = grads.stack()
        check(all(torch.equal(t, full) for t in gathered),
              f"{label}: ring_all_gather rows differ from the input")
        check([mesh.rank_of(t) for t in gathered] == list(range(n)),
              "ring_all_gather: rows not owned by their ranks")
        del gathered, full, grads
        torch.cuda.empty_cache()
        row.update({"allgather_gbps": g_gbps, "allgather_ms": g_ms,
                    "wall_s": time.monotonic() - t_phase})
        out["allreduce"].append(row)
        print(f"collectives {label:>7}: psum {psum_gbps:8.2f} GB/s  "
              f"ring {ring_gbps:8.2f} GB/s  kernel {kern_gbps:8.2f} GB/s  "
              f"all_gather {g_gbps:8.2f} GB/s  (psum off the ring by "
              f"{psum_err:.3g}, atol {atol:.3g})", flush=True)

    # CollectiveChannel: tensor-parallel matvec and an indexed gather
    t_phase = time.monotonic()
    ch = channels.CollectiveChannel(mesh)
    ch.register("Shard.PartialMatVec", lambda w_shard, x_full: w_shard @ x_full,
                merge=channels.MERGE_SUM, mapping=channels.MAP_SHARD)
    ch.register("Shard.Scale", lambda idx, row: row * (idx + 1),
                merge=channels.MERGE_GATHER, mapping=channels.MAP_SHARD,
                takes_index=True)
    d = MATVEC_D
    # uniform [0, 1): no cancellation, so rtol 1e-5 holds element-wise
    w = torch.rand((n, d, d), generator=gen, device=dev)
    xv = torch.rand((d,), generator=gen, device=dev)
    ws, xr = ch.shard(w), ch.replicate(xv)
    y, _, mv_ms = _gbps(lambda: ch.call("Shard.PartialMatVec", ws, xr), 0)
    dense = torch.einsum("rij,j->i", w.double(), xv.double())
    mv_err = ((y.double() - dense).abs() / dense.abs()).max().item()
    check(y.shape == (d,) and mv_err <= 1e-5,
          f"CollectiveChannel matvec off the dense product: rel {mv_err}")
    del w, ws, dense
    ones = ch.shard(torch.ones((n, d), device=dev))
    g = ch.call("Shard.Scale", ones)
    check(torch.equal(g, torch.arange(1, n + 1, dtype=torch.float32,
                                      device=dev)[:, None].expand(n, d)),
          "CollectiveChannel MERGE_GATHER with takes_index")
    out["channel"] = {"matvec_ms": mv_ms, "matvec_max_rel_err": mv_err,
                      "wall_s": time.monotonic() - t_phase}
    print(f"collective channel: matvec ({n}, {d}, {d}) {mv_ms:.3f} ms per "
          f"call, max rel err {mv_err:.3g}; indexed gather ok", flush=True)

    # RingStream: 6 chunks, window 2, delivered in order one hop on
    t_phase = time.monotonic()
    got = []
    stream = ring.RingStream(hops=1, window=2, mesh=mesh,
                             on_chunk=got.append)
    chunks = [_mixed(gen, (n, 1 << 20), dev) for _ in range(6)]
    for c in chunks:
        check(stream.write(coll.shard(c), timeout=30), "RingStream write")
    check(stream.flush(60), "RingStream flush")
    check(len(got) == 6 and stream.in_flight == 0, "RingStream lost chunks")
    for c, g in zip(chunks, got):
        check(torch.equal(g.stack(), c.roll(1, 0)),
              "RingStream delivered out of order or changed a chunk")
    out["ring_stream"] = {"chunks": 6, "window": 2,
                          "wall_s": time.monotonic() - t_phase}
    print("ring stream: 6 chunks of (8, 1M) float32, window 2, in order",
          flush=True)

    # sequence parallelism at bench_ring_attention's shape
    t_phase = time.monotonic()
    seq, heads, dim = ATTENTION
    block = seq // n
    q, k, v = (torch.randn((seq, heads, dim), generator=gen, device=dev)
               for _ in range(3))
    qs, ks, vs = (coll.shard(t.reshape(n, block, heads, dim))
                  for t in (q, k, v))
    attn = {}
    for name, fn, causal in (
            ("ring", lambda: ra.ring_attention(qs, ks, vs), False),
            ("ring_causal",
             lambda: ra.ring_attention(qs, ks, vs, causal=True), True),
            ("ulysses", lambda: ra.ulysses_attention(qs, ks, vs), False)):
        got_o, _, ms = _gbps(fn, 0, reps=3)
        ref = ra.reference_attention(q, k, v, causal=causal)
        diff = (got_o.stack().reshape(q.shape) - ref).abs()
        bad = (diff > 1e-4 + 1e-4 * ref.abs()).sum().item()
        check(bad == 0, f"{name} attention off the reference at {bad} "
                        f"places (max abs diff {diff.max().item():.3g})")
        _, _, ref_ms = _gbps(
            lambda: ra.reference_attention(q, k, v, causal=causal), 0, reps=3)
        attn[name] = {"ms": ms, "tokens_per_s": seq / ms * 1e3,
                      "reference_ms": ref_ms,
                      "max_abs_diff": diff.max().item()}
        print(f"attention {name:>11}: {ms:8.3f} ms ({seq / ms * 1e3:,.0f} "
              f"tokens/s), dense reference {ref_ms:8.3f} ms, max abs diff "
              f"{diff.max().item():.3g}", flush=True)
    out["attention"] = attn
    out["attention_wall_s"] = time.monotonic() - t_phase
    out["calls"] = calls
    return out


def phase_card_tests() -> str:
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else proc.stderr.strip()[-200:]
    print(f"card tests: {summary} ({time.monotonic() - t0:.1f} s)",
          flush=True)
    check(proc.returncode == 0, f"card tests failed (rc {proc.returncode}):"
                                f"\n{proc.stdout[-6000:]}{proc.stderr[-2000:]}")
    return summary


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(int(len(xs) * q), len(xs) - 1)]


def phase_serving(mesh, plane, p2p_copy) -> dict:
    """The disaggregated serving path through its entry points (see the
    module docstring, phase 8)."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.examples.disagg_serving import model
    from brpc_tpu_torch.examples.disagg_serving.workers import (
        BYTES_PER_TOKEN, close_services, start_decode_worker,
        start_prefill_worker, start_router)
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.serving import (BatchSchedulerOptions,
                                        ContinuousBatchScheduler,
                                        KvPoolOptions, StepRequest)
    from brpc_tpu_torch.tools.profile_echo import device_busy_share

    from brpc_tpu_torch.rpc import loopback

    t_phase = time.monotonic()
    loopback0 = loopback.calls
    dev = mesh.device(0)
    flags.set_flag("ici_device_plane_threshold", 64 * 1024)
    rng = np.random.default_rng(8)

    def prompt(n):
        return rng.integers(0, model.VOCAB, n).tolist()

    def pool_options():
        return KvPoolOptions(bytes_per_token=BYTES_PER_TOKEN,
                             num_blocks=SERVE_POOL_BLOCKS,
                             block_tokens=SERVE_BLOCK_TOKENS)

    prefill = start_prefill_worker("ici://1", mesh=mesh)
    decodes = [start_decode_worker(f"ici://{r}", mesh=mesh,
                                   pool_options=pool_options())
               for r in (2, 3)]
    router = start_router("mem://chip-smoke-router", "ici://1",
                          ["ici://2", "ici://3"], rng=random.Random(8))
    pre_svc = next(iter(prefill.services().values()))
    dec_svcs = [next(iter(d.services().values())) for d in decodes]
    channels = []

    def channel(target):
        ch = rpc.Channel()
        ch.init(target, options=rpc.ChannelOptions(
            timeout_ms=120000, max_retry=0))
        channels.append(ch)
        return ch

    out = {}
    try:
        for svc in dec_svcs:
            check(svc.pool._store.is_cuda and svc.pool.pos_sums_flat.is_cuda,
                  f"decode pool of rank {svc.rank} is not on the card")
        transfers0 = plane.stats()["transfers"]
        # LoadKv calls as the servers receive them: a retried shed
        # relocates its attachment again
        loads0 = sum(svc.loadkv_received for svc in dec_svcs)
        front = channel("mem://chip-smoke-router")

        def generate(tokens):
            cntl = rpc.Controller()
            t0 = time.perf_counter_ns()
            resp = front.call_method("Router.Generate", cntl, EchoRequest(
                message=json.dumps({"tokens": tokens,
                                    "steps": SERVE_STEPS})), EchoResponse)
            ms = (time.perf_counter_ns() - t0) / 1e6
            check(not cntl.failed(), f"Generate failed: {cntl.error_text}")
            return json.loads(resp.message)["tokens"], ms

        # (a) Generates: warm-ups, then 20 from 2 threads, then 4 long
        prompts = [prompt(SERVE_PROMPT) for _ in range(SERVE_PROMPTS)]
        longs = [prompt(SERVE_LONG) for _ in range(SERVE_LONG_PROMPTS)]
        for _ in range(SERVE_WARM):
            generate(prompt(SERVE_PROMPT))
        got = [None] * len(prompts)
        h0 = (pre_svc.handoff_bytes, pre_svc.handoff_ns)

        def client(k):
            for i in range(k, len(prompts), SERVE_THREADS):
                got[i] = generate(prompts[i])

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads) and all(got),
              "Generate clients did not finish")
        h_bytes = pre_svc.handoff_bytes - h0[0]
        h_ns = pre_svc.handoff_ns - h0[1]
        lat = [ms for _, ms in got]
        long_got = [generate(tokens) for tokens in longs]
        bad = [i for i, (tokens, (toks, _)) in enumerate(
            zip(prompts + longs, got + long_got))
            if toks != model.reference_generate(tokens, SERVE_STEPS, dev)]
        check(not bad, f"Generate tokens differ from reference_generate on "
                       f"the card for prompts {bad}")
        out["generate"] = {
            "prompts": len(prompts), "prompt_tokens": SERVE_PROMPT,
            "steps": SERVE_STEPS, "threads": SERVE_THREADS,
            "p50_ms": _pct(lat, 0.5), "p99_ms": _pct(lat, 0.99),
            "tokens_per_s": len(prompts) * SERVE_STEPS / wall,
            "wall_s": wall, "handoff_gbps": h_bytes / h_ns,
            "long_prompt_tokens": SERVE_LONG,
            "long_p50_ms": _pct([ms for _, ms in long_got], 0.5),
            "verified": len(prompts) + len(longs)}
        print(f"serving generate: {len(prompts)} x {SERVE_PROMPT} tokens x "
              f"{SERVE_STEPS} steps from {SERVE_THREADS} threads: p50 "
              f"{out['generate']['p50_ms']:.3f} ms, p99 "
              f"{out['generate']['p99_ms']:.3f} ms, "
              f"{out['generate']['tokens_per_s']:.1f} tokens/s; KV handoff "
              f"{out['generate']['handoff_gbps']:.3f} GB/s; "
              f"{SERVE_LONG_PROMPTS} x {SERVE_LONG} tokens p50 "
              f"{out['generate']['long_p50_ms']:.3f} ms; all "
              f"{out['generate']['verified']} equal reference_generate",
              flush=True)

        # (b) the full roster: 64 LoadKv (and 2 long ones, not decoded),
        # then 64 async Decodes
        dec = channel("ici://2")
        roster = [prompt(SERVE_PROMPT) for _ in range(SERVE_ROSTER)]
        load_us = []
        sent = {}                       # session -> token-major rows sent

        def load_kv(session, tokens):
            kv = mesh.own(model.toy_kv_blocks(tokens, mesh.device(1)), 1)
            sent[session] = kv.view(model.KV_LAYERS, len(tokens),
                                    model.KV_DMODEL).permute(1, 0, 2).reshape(
                len(tokens), BYTES_PER_TOKEN)
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(kv)
            t0 = time.perf_counter_ns()
            dec.call_method("Decode.LoadKv", cntl, EchoRequest(
                message=json.dumps({"session": session,
                                    "seq_len": len(tokens),
                                    "last_token": tokens[-1]})),
                EchoResponse)
            check(not cntl.failed(), f"LoadKv failed: {cntl.error_text}")
            return (time.perf_counter_ns() - t0) / 1e3

        for i, tokens in enumerate(roster):
            load_us.append(load_kv(f"r{i}", tokens))
        for i, tokens in enumerate(longs[:2]):
            load_kv(f"long{i}", tokens)
        results = [None] * SERVE_ROSTER
        left = [SERVE_ROSTER]
        all_done = threading.Event()
        lock = threading.Lock()

        def on_done(i, cntl):
            results[i] = (None if cntl.failed() else
                          json.loads(cntl.response.message)["tokens"],
                          cntl.error_text)
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    all_done.set()

        steps0 = dec_svcs[0].scheduler.steps.get_value()
        t0 = time.perf_counter()
        for i in range(SERVE_ROSTER):
            cntl = rpc.Controller()
            dec.call_method("Decode.Decode", cntl, EchoRequest(
                message=json.dumps({"session": f"r{i}", "steps": SERVE_STEPS,
                                    "release": False})), EchoResponse,
                done=lambda c, i=i: on_done(i, c))
        check(all_done.wait(600), "full-roster Decodes did not complete")
        roster_wall = time.perf_counter() - t0
        steps = dec_svcs[0].scheduler.steps.get_value() - steps0
        bad = [i for i, (tokens, (toks, err)) in enumerate(zip(roster,
                                                               results))
               if toks != model.reference_generate(tokens, SERVE_STEPS, dev)]
        check(not bad, f"full-roster sessions {bad} differ from "
                       f"reference_generate (first error: "
                       f"{results[bad[0]][1] if bad else ''})")
        check(all(t.is_cuda for t in dec_svcs[0].scheduler.roster_tensors()
                  if t is not None), "step tensors are not on the card")
        # the bytes delivered: every loaded session's rows in the pool
        # against the KV sent, before any release
        pool = dec_svcs[0].pool
        bad = [s for s, rows in sent.items()
               if not torch.equal(pool.materialize(s), rows)]
        check(not bad, f"pool rows differ from the KV sent for sessions "
                       f"{bad}")
        for s in sent:
            if s.startswith("long"):
                pool.release(s)
        # the step at roster 64, on the same pool and sessions: wall per
        # step (host clock, with the step's one sync) and device time
        sched = ContinuousBatchScheduler(pool, BatchSchedulerOptions(
            vocab=model.VOCAB, max_batch=SERVE_ROSTER, auto_start=False))
        for i in range(SERVE_ROSTER):
            sched.submit(StepRequest(f"r{i}", 10 ** 6, lambda t: None,
                                     lambda *a: None))
        check(sched.step_once() == SERVE_ROSTER, "manual roster not full")
        walls = []
        for _ in range(32):
            t1 = time.perf_counter_ns()
            sched.step_once()
            walls.append((time.perf_counter_ns() - t1) / 1e3)
        prof = device_busy_share(lambda: [sched.step_once()
                                          for _ in range(32)])
        check(all(t.is_cuda for t in sched.roster_tensors()),
              "step tensors are not on the card")
        sched.stop()
        for i in range(SERVE_ROSTER):
            pool.release(f"r{i}")
        out["roster"] = {
            "sessions": SERVE_ROSTER, "bytes_checked_sessions": len(sent),
            "loadkv_p50_us": _pct(load_us, 0.5),
            "loadkv_p99_us": _pct(load_us, 0.99),
            "decode_wall_s": roster_wall, "service_steps": steps,
            "tokens_per_s": SERVE_ROSTER * SERVE_STEPS / roster_wall,
            "step_wall_us_p50": _pct(walls, 0.5),
            "step_device_us": prof["device_busy_us"] / 32,
            "step_profiled_wall_us": prof["wall_us"] / 32,
            "step_device_idle_share": prof["device_idle_share"]}
        print(f"serving roster: {SERVE_ROSTER} LoadKv p50 "
              f"{out['roster']['loadkv_p50_us']:.1f} us; {len(sent)} "
              f"sessions' pool rows equal the KV sent; {SERVE_ROSTER} "
              f"async Decodes of {SERVE_STEPS} steps in "
              f"{roster_wall * 1e3:.1f} ms over {steps} steps "
              f"({out['roster']['tokens_per_s']:.1f} tokens/s); step at "
              f"roster {SERVE_ROSTER}: wall p50 "
              f"{out['roster']['step_wall_us_p50']:.1f} us, device "
              f"{out['roster']['step_device_us']:.2f} us", flush=True)

        # the counts: one plane transfer and one p2p_copy launch per LoadKv
        torch.cuda.synchronize()
        out["loadkv_calls"] = (sum(svc.loadkv_received for svc in dec_svcs)
                               - loads0)
        out["plane_transfers"] = plane.stats()["transfers"] - transfers0
        out["launches"] = p2p_copy.launches
        check(out["plane_transfers"] >= out["loadkv_calls"],
              f"{out['loadkv_calls']} LoadKv calls but "
              f"{out['plane_transfers']} plane transfers: a KV did not "
              f"ride the plane")
        check(out["launches"] == out["plane_transfers"]
              == out["loadkv_calls"],
              f"serving: p2p_copy launches {out['launches']}, plane "
              f"transfers {out['plane_transfers']}, LoadKv calls "
              f"{out['loadkv_calls']}")
        # the router's mem:// calls: the loopback plane served them
        out["loopback_calls"] = loopback.calls - loopback0
        check(out["loopback_calls"] > 0,
              "no Generate took the mem:// loopback plane")
        print(f"serving: the loopback plane served "
              f"{out['loopback_calls']} calls to the router", flush=True)

        # (c) the card's prefill bytes against the CPU's
        diff_bytes, max_diff = 0, 0
        for tokens in prompts + longs:
            card = model.toy_kv_blocks(tokens, dev).cpu().int()
            host = model.toy_kv_blocks(tokens, "cpu").int()
            d = (card - host).abs()
            diff_bytes += int((d > 0).sum())
            max_diff = max(max_diff, int(d.max()))
        out["kv_bytes_vs_cpu"] = {
            "prompts": len(prompts) + len(longs),
            "bytes": sum(model.kv_nbytes(len(t)) for t in prompts + longs),
            "differing_bytes": diff_bytes, "max_abs_diff": max_diff}
        print(f"serving prefill bytes, card vs CPU: {diff_bytes} of "
              f"{out['kv_bytes_vs_cpu']['bytes']} differ, max abs diff "
              f"{max_diff}", flush=True)
        out["pools"] = {str(svc.rank): {
            k: v for k, v in svc.pool.describe().items()
            if k in ("blocks_total", "blocks_used", "sessions", "loads",
                     "bytes_in", "evictions", "device", "prefix")}
            for svc in dec_svcs}
        out["schedulers"] = {str(svc.rank): svc.scheduler.describe()
                             for svc in dec_svcs}
    finally:
        for ch in channels:
            ch.close()
        close_services(router, prefill, *decodes)
    out["wall_s"] = time.monotonic() - t_phase
    print(f"serving: p2p_copy launches {out['launches']} = plane transfers "
          f"{out['plane_transfers']} = LoadKv calls {out['loadkv_calls']}; "
          f"pools {json.dumps(out['pools'])}; phase {out['wall_s']:.1f} s",
          flush=True)
    return out


def _copy_ms(fn, runs: int = 20) -> float:
    """Median CUDA-event ms of one stream-ordered copy (a spin ahead, so
    the host's enqueue stays out)."""
    ts = []
    for _ in range(runs):
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def phase_tiers_migration(mesh, plane, p2p_copy) -> dict:
    """The KV pool's host tier and live migration through the serving
    entry points (see the module docstring, phase 9)."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.examples.disagg_serving import model
    from brpc_tpu_torch.examples.disagg_serving.workers import (
        BYTES_PER_TOKEN, close_services, migrated_dest, start_decode_worker,
        start_prefill_worker, start_router)
    from brpc_tpu_torch.ici.route import plane_stats
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.serving import KvPoolOptions, migration_stats

    t_phase = time.monotonic()
    dev = mesh.device(0)
    flags.set_flag("ici_device_plane_threshold", 64 * 1024)
    rng = np.random.default_rng(9)

    def prompt(n):
        return rng.integers(0, model.VOCAB, n).tolist()

    def pool_options():
        return KvPoolOptions(bytes_per_token=BYTES_PER_TOKEN,
                             num_blocks=SERVE_POOL_BLOCKS,
                             block_tokens=SERVE_BLOCK_TOKENS,
                             host_blocks=TIER_HOST_BLOCKS)

    prefill = start_prefill_worker("ici://1", mesh=mesh)
    decodes = [start_decode_worker(f"ici://{r}", mesh=mesh,
                                   pool_options=pool_options())
               for r in (2, 3)]
    router = start_router("mem://chip-smoke-tiers", "ici://1",
                          ["ici://2", "ici://3"], rng=random.Random(9))
    dec2, dec3 = [next(iter(d.services().values())) for d in decodes]
    affinity = next(iter(router.services().values()))._router
    channels = []

    def channel(target):
        ch = rpc.Channel()
        ch.init(target, options=rpc.ChannelOptions(
            timeout_ms=120000, max_retry=0))
        channels.append(ch)
        return ch

    def call(ch, method, body):
        cntl = rpc.Controller()
        resp = ch.call_method(method, cntl,
                              EchoRequest(message=json.dumps(body)),
                              EchoResponse)
        return cntl, resp

    def rows_of(tokens):
        n = len(tokens)
        return model.toy_kv_blocks(tokens, dev).view(
            model.KV_LAYERS, n, model.KV_DMODEL).permute(1, 0, 2).reshape(
            n, BYTES_PER_TOKEN)

    def received():
        return sum(s.loadkv_received + s.migrate_in_received
                   for s in (dec2, dec3))

    def decode_all(ch_of, sessions, release):
        """Async Decodes of SERVE_STEPS, all in flight at once, so the
        batched step runs them together; returns {session: tokens}."""
        results, left, done_ev = {}, [len(sessions)], threading.Event()
        lock = threading.Lock()

        def on_done(s, c):
            results[s] = (None if c.failed() else
                          json.loads(c.response.message)["tokens"],
                          c.error_text)
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    done_ev.set()

        for s in sessions:
            cntl = rpc.Controller()
            ch_of(s).call_method("Decode.Decode", cntl, EchoRequest(
                message=json.dumps({"session": s, "steps": SERVE_STEPS,
                                    "release": release})), EchoResponse,
                done=lambda c, s=s: on_done(s, c))
        check(done_ev.wait(600), "phase 9 Decodes did not complete")
        return results

    out = {}
    try:
        for svc in (dec2, dec3):
            check(svc.pool._store.is_cuda
                  and svc.pool._host_store.is_pinned(),
                  f"rank {svc.rank}: device arena not on the card or host "
                  f"arena not pinned")
        transfers0 = plane.stats()["transfers"]
        received0 = received()
        migrate_in0 = dec3.migrate_in_received
        front = channel("mem://chip-smoke-tiers")
        ch2 = channel("ici://2")
        for tokens in (prompt(SERVE_PROMPT), prompt(SERVE_PROMPT)):
            cntl, resp = call(front, "Router.Generate",
                              {"tokens": tokens, "steps": SERVE_STEPS})
            check(not cntl.failed(), f"Generate failed: {cntl.error_text}")
            check(json.loads(resp.message)["tokens"]
                  == model.reference_generate(tokens, SERVE_STEPS, dev),
                  "Generate through the tiered pools differs from "
                  "reference_generate")

        def load_kv(session, tokens):
            kv = mesh.own(model.toy_kv_blocks(tokens, mesh.device(1)), 1)
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(kv)
            ch2.call_method("Decode.LoadKv", cntl, EchoRequest(
                message=json.dumps({"session": session,
                                    "seq_len": len(tokens),
                                    "last_token": tokens[-1]})),
                EchoResponse)
            check(not cntl.failed(), f"LoadKv {session} failed: "
                                     f"{cntl.error_text}")

        # (a) tiers: 1.125x the device arena in 2,048-token sessions
        pool = dec2.pool
        tier = [prompt(SERVE_LONG) for _ in range(TIER_SESSIONS)]
        t0 = time.perf_counter()
        for i, tokens in enumerate(tier):
            load_kv(f"t{i}", tokens)
        load_s = time.perf_counter() - t0
        spilled = sorted(pool.spilled_sessions(), key=lambda s: int(s[1:]))
        need = TIER_SESSIONS - SERVE_POOL_BLOCKS * SERVE_BLOCK_TOKENS \
            // SERVE_LONG
        check(len(spilled) >= need, f"only {len(spilled)} sessions demoted "
                                    f"under pressure, {need} expected")
        loaded = pool.describe()["tiers"]
        pick = spilled[:TIER_DECODED]
        t0 = time.perf_counter()
        results = decode_all(lambda s: ch2, pick, release=False)
        decode_s = time.perf_counter() - t0
        bad = [s for s in pick if results[s][0] != model.reference_generate(
            tier[int(s[1:])], SERVE_STEPS, dev)]
        first = results[bad[0]][1] if bad else ""
        check(not bad, f"restored sessions {bad} decode differently from "
                       f"reference_generate ({first})")
        bad = [s for s in pick if not torch.equal(
            pool.materialize(s), rows_of(tier[int(s[1:])]))]
        check(not bad, f"restored sessions {bad}: rows differ from the KV "
                       f"sent")
        tiers = pool.describe()["tiers"]
        check(tiers["restores"] - loaded["restores"] >= TIER_DECODED
              and tiers["restore_corrupt"] == 0,
              f"tiers: {json.dumps(tiers)}")
        nbytes = SERVE_LONG * BYTES_PER_TOKEN
        on_card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        d2h_ms = _copy_ms(lambda: pinned.copy_(on_card, non_blocking=True))
        h2d_ms = _copy_ms(lambda: on_card.copy_(pinned, non_blocking=True))
        out["tiers"] = {
            "sessions": TIER_SESSIONS, "prompt_tokens": SERVE_LONG,
            "device_blocks": SERVE_POOL_BLOCKS,
            "host_blocks": TIER_HOST_BLOCKS,
            "demoted_by_loads": loaded["demotions"],
            "decoded_restored": len(pick), "load_s": load_s,
            "decode_s": decode_s,
            "spill_gbps": tiers["demote_bytes"]
            / max(tiers["demote_copy_us"], 1) / 1e3,
            "restore_gbps": tiers["restore_bytes"]
            / max(tiers["restore_copy_us"], 1) / 1e3,
            "restore_p50_us": tiers["restore_p50_us"],
            "pinned_copy_d2h_gbps": nbytes / (d2h_ms * 1e6),
            "pinned_copy_h2d_gbps": nbytes / (h2d_ms * 1e6),
            "pinned_copy_bytes": nbytes,
            "describe": {k: v for k, v in tiers.items()
                         if k != "migration"}}
        print(f"tiers: {TIER_SESSIONS} x {SERVE_LONG}-token LoadKv in "
              f"{load_s:.2f} s, {loaded['demotions']} demoted; "
              f"{len(pick)} demoted sessions decoded {SERVE_STEPS} steps "
              f"after restore, tokens and rows exact; spill "
              f"{out['tiers']['spill_gbps']:.3f} GB/s, restore "
              f"{out['tiers']['restore_gbps']:.3f} GB/s, restore p50 "
              f"{tiers['restore_p50_us']} us; pinned copy_ of "
              f"{nbytes} B: D2H {out['tiers']['pinned_copy_d2h_gbps']:.3f}"
              f" GB/s, H2D {out['tiers']['pinned_copy_h2d_gbps']:.3f} GB/s; "
              f"tiers {json.dumps(out['tiers']['describe'])}", flush=True)
        for i in range(TIER_SESSIONS):
            pool.release(f"t{i}")

        # (b) migration: rank 2 -> rank 3, each cutover a rebind
        mig = [prompt(SERVE_PROMPT) for _ in range(MIGRATE_SESSIONS)]
        for i, tokens in enumerate(mig):
            load_kv(f"m{i}", tokens)
            affinity.bind_session(f"m{i}", "ici://2")
        mig_ms = []
        for i in range(MIGRATE_SESSIONS):
            t0 = time.perf_counter_ns()
            cntl, resp = call(ch2, "Decode.MigrateOut",
                              {"session": f"m{i}", "dest": "ici://3"})
            mig_ms.append((time.perf_counter_ns() - t0) / 1e6)
            check(not cntl.failed(), f"MigrateOut m{i}: {cntl.error_text}")
            if i == 0:
                # released, not yet rebound: the source sheds towards rank 3
                cntl, _ = call(ch2, "Decode.Decode",
                               {"session": "m0", "steps": 1,
                                "release": False})
                check(migrated_dest(cntl) == "ici://3",
                      f"late Decode on the source: {cntl.error_text!r}")
            check(affinity.rebind(f"m{i}", "ici://3") == "ici://2",
                  "rebind did not find the source binding")
        left = [f"m{i}" for i in range(MIGRATE_SESSIONS)
                if pool.get(f"m{i}") is not None
                or f"m{i}" in pool.spilled_sessions()]
        check(not left, f"rank 2 still holds {left} after cutover")
        results = decode_all(
            lambda s: affinity.channel(affinity.session_url(s)),
            [f"m{i}" for i in range(MIGRATE_SESSIONS)], release=True)
        bad = [i for i, tokens in enumerate(mig)
               if results[f"m{i}"][0]
               != model.reference_generate(tokens, SERVE_STEPS, dev)]
        check(not bad, f"migrated sessions {bad} decode differently on "
                       f"rank 3")
        payload = SERVE_PROMPT * BYTES_PER_TOKEN
        out["migration"] = {
            "sessions": MIGRATE_SESSIONS, "prompt_tokens": SERVE_PROMPT,
            "p50_ms": _pct(mig_ms, 0.5), "p99_ms": _pct(mig_ms, 0.99),
            "payload_bytes": payload,
            "payload_gbps": payload * len(mig_ms) / (sum(mig_ms) * 1e6),
            "rebinds": affinity.describe()["rebinds"]}
        print(f"migration: {MIGRATE_SESSIONS} x {SERVE_PROMPT}-token "
              f"sessions rank 2 -> rank 3, p50 "
              f"{out['migration']['p50_ms']:.3f} ms, p99 "
              f"{out['migration']['p99_ms']:.3f} ms, payload "
              f"{out['migration']['payload_gbps']:.3f} GB/s; follow-up "
              f"Decodes routed by session equal reference_generate",
              flush=True)

        # (c) the transfer-deadline latch, then the timer's revival
        before = plane_stats()
        latch = prompt(SERVE_PROMPT)
        load_kv("latch", latch)
        want = model.reference_generate(latch, SERVE_STEPS, dev)
        gate = threading.Event()
        dec3.migrate_in_gate = gate
        cntl, _ = call(ch2, "Decode.MigrateOut",
                       {"session": "latch", "dest": "ici://3",
                        "deadline_ms": LATCH_DEADLINE_MS})
        check(cntl.failed() and "deadline" in cntl.error_text,
              f"black-holed migration did not trip the deadline: "
              f"{cntl.error_text}")
        plane_row = migration_stats()["plane"]
        check(plane_row["state"] == "down"
              and plane_row["reason"] == "transfer_deadline",
              f"migrate plane {plane_row}")
        t0 = time.perf_counter()
        cntl, _ = call(ch2, "Decode.MigrateOut",
                       {"session": "latch", "dest": "ici://3"})
        refused_ms = (time.perf_counter() - t0) * 1e3
        check(cntl.failed() and "latched" in cntl.error_text,
              f"latched plane did not refuse: {cntl.error_text}")
        cntl, resp = call(ch2, "Decode.Decode", {
            "session": "latch", "steps": SERVE_STEPS, "release": False,
            "mode": "sync"})
        check(not cntl.failed()
              and json.loads(resp.message)["tokens"] == want,
              "the source stopped serving during the latch")
        gate.set()
        dec3.migrate_in_gate = None
        deadline = time.monotonic() + 30
        while dec3.pool.get("latch") is None and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(float(flags.get_flag("serving_migrate_reprobe_s")) + 0.1)
        cntl, _ = call(ch2, "Decode.MigrateOut",
                       {"session": "latch", "dest": "ici://3",
                        "deadline_ms": 30000})
        check(not cntl.failed(), f"migration after the latch lapsed: "
                                 f"{cntl.error_text}")
        affinity.rebind("latch", "ici://3")
        cntl, resp = call(affinity.channel(affinity.session_url("latch")),
                          "Decode.Decode", {"session": "latch",
                                            "steps": SERVE_STEPS})
        check(not cntl.failed()
              and json.loads(resp.message)["tokens"] == want,
              "the migrated latch session decodes differently on rank 3")
        after = plane_stats()
        deltas = {e: after.get(f"migrate_{e}", 0)
                  - before.get(f"migrate_{e}", 0)
                  for e in ("down", "reprobe", "revived", "ramp")}
        check(deltas["down"] == 1 and deltas["revived"] >= 1,
              f"migrate plane deltas {deltas}")
        out["latch"] = {"plane_stats_delta": deltas,
                        "refused_ms": refused_ms,
                        "deadline_ms": LATCH_DEADLINE_MS}
        print(f"latch: plane_stats deltas {json.dumps(deltas)}; the "
              f"latched plane refused in {refused_ms:.3f} ms; the source "
              f"served throughout", flush=True)

        # the counts: one plane transfer and one p2p_copy launch per
        # LoadKv and per MigrateIn the servers received
        torch.cuda.synchronize()
        out["calls_received"] = received() - received0
        out["migrate_in_calls"] = dec3.migrate_in_received - migrate_in0
        out["plane_transfers"] = plane.stats()["transfers"] - transfers0
        out["launches"] = p2p_copy.launches
        check(out["launches"] == out["plane_transfers"]
              == out["calls_received"],
              f"phase 9: p2p_copy launches {out['launches']}, plane "
              f"transfers {out['plane_transfers']}, LoadKv + MigrateIn "
              f"calls received {out['calls_received']}")
    finally:
        for ch in channels:
            ch.close()
        close_services(router, prefill, *decodes)
    out["wall_s"] = time.monotonic() - t_phase
    print(f"tiers and migration: p2p_copy launches {out['launches']} = "
          f"plane transfers {out['plane_transfers']} = LoadKv + MigrateIn "
          f"calls received {out['calls_received']} (MigrateIn "
          f"{out['migrate_in_calls']}); phase {out['wall_s']:.1f} s",
          flush=True)
    return out


def _tensor_of(att) -> torch.Tensor:
    """The bytes of a received attachment as one flat uint8 tensor on its
    rank (a view when it arrived as one DEVICE block)."""
    from brpc_tpu_torch.butil.iobuf import DEVICE
    segs = []
    for i in range(att.backing_block_num()):
        r = att.backing_block(i)
        check(r.block.kind == DEVICE, "an attachment arrived in host memory")
        segs.append(r.block.data[r.offset:r.offset + r.length])
    return segs[0] if len(segs) == 1 else torch.cat(segs)


def phase_admission(mesh, plane, p2p_copy, payload=ADM_PAYLOAD,
                    door="python") -> dict:
    """(a) bench.py's overload leg (_overload_one_plane) on ici:// with
    4 MiB DEVICE attachments (see the module docstring, phase 10), or
    (``door="native"``) on the native door with ``payload`` bytes that
    fit its window (phase 16 (e))."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse

    t_phase = time.monotonic()
    dev = mesh.device(0)
    # one attachment bank per client rank: request i of a stream carries
    # pattern i % ADM_PATTERNS, seeded bytes, owned by the stream's rank
    bank = {rank: [mesh.own(torch.from_numpy(np.random.default_rng(
        100 * rank + k).integers(0, 256, payload, dtype=np.uint8)).to(
        dev), rank) for k in range(ADM_PATTERNS)] for rank in (6, 7)}
    # earlier phases' garbage is collected before the baseline (as phases
    # 11 and 15 do): a collection inside this phase would move the level
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    lock = threading.Lock()
    served = {"returned": 0, "bad": 0}

    class Echo(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            time.sleep(ADM_SERVICE_MS / 1000.0)
            rank, k = map(int, request.message.split(":"))
            got = _tensor_of(cntl.request_attachment)
            ok = (got.device == bank[rank][k].device
                  and torch.equal(got, bank[rank][k]))
            cntl.response_attachment.append(cntl.request_attachment)
            with lock:
                served["returned"] += 1
                served["bad"] += not ok
            done()

    server = rpc.Server(rpc.ServerOptions(
        max_concurrency=ADM_MAX_CONC, usercode_in_pthread=True,
        usercode_backup_threads=ADM_MAX_CONC + 2,
        admission=rpc.AdmissionOptions(max_queue_ms=ADM_SERVICE_MS / 2.0,
                                       queue_capacity=64)))
    server.add_service(Echo())
    check(server.start("ici://5") == 0, "admission server start on ici://5")
    capacity = ADM_MAX_CONC / (ADM_SERVICE_MS / 1000.0)

    def run_phase(spec, duration):
        """One paced thread per (priority, tenant, rps, rank), each on its
        own Channel with max_retry 0.  The channels share the process's
        one connection to the server, so they close after every thread
        is done (a close fails the shared connection)."""
        stats = {}
        stop = time.monotonic() + duration
        chans = []

        def worker(pri, tenant, rate, rank, wid):
            ch = rpc.Channel()
            ch.init("ici://5", options=rpc.ChannelOptions(timeout_ms=2000,
                                                  max_retry=0))
            chans.append(ch)
            interval = 1.0 / rate
            next_fire = time.monotonic() + (wid % 7) * 0.003
            i = 0
            while time.monotonic() < stop:
                now = time.monotonic()
                if now < next_fire:
                    time.sleep(min(next_fire - now, 0.02))
                    continue
                next_fire += interval
                k = i % ADM_PATTERNS
                i += 1
                cntl = rpc.Controller()
                cntl.priority = pri
                cntl.tenant = tenant
                cntl.request_attachment.append_device_array(bank[rank][k])
                t0 = time.perf_counter_ns()
                ch.call_method("Echo.Echo", cntl,
                               EchoRequest(message=f"{rank}:{k}"),
                               EchoResponse)
                lat_us = (time.perf_counter_ns() - t0) / 1000.0
                back = None
                if not cntl.failed():
                    back = torch.equal(_tensor_of(cntl.response_attachment),
                                       bank[rank][k])
                with lock:
                    c = stats.setdefault((pri, tenant), {
                        "ok": 0, "shed": 0, "shed_with_hint": 0, "err": 0,
                        "issued": 0, "bad": 0, "lats": [], "codes": [],
                        "in_call_s": 0.0, "max_call_ms": 0.0})
                    c["issued"] += 1
                    c["in_call_s"] += lat_us / 1e6
                    c["max_call_ms"] = max(c["max_call_ms"], lat_us / 1e3)
                    if back is not None:
                        c["ok"] += 1
                        c["bad"] += not back
                        c["lats"].append(lat_us)
                    elif cntl.error_code_ == rpc.errors.ELIMIT:
                        c["shed"] += 1
                        c["shed_with_hint"] += cntl.retry_after_ms > 0
                    else:
                        c["err"] += 1
                        c["codes"].append(cntl.error_code_)

        threads = [threading.Thread(target=worker, args=(*s, i),
                                    daemon=True)
                   for i, s in enumerate(spec)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(duration + 30)
        check(not any(t.is_alive() for t in threads),
              "admission clients did not finish")
        for ch in chans:
            ch.close()
        return stats

    out = {"capacity_rps": capacity}
    try:
        transfers0 = plane.stats()["transfers"]
        base = run_phase([(0, "t0", capacity / 2.0, 6)], ADM_UNLOADED_S)
        spec = []
        per_tenant = ADM_FACTOR * capacity / len(ADM_TENANTS)
        for j, t in enumerate(ADM_TENANTS):
            rank = 6 + j % 2
            spec.append((0, t, per_tenant * 0.25, rank))
            spec.append((3, t, per_tenant * 0.375, rank))
            spec.append((3, t, per_tenant * 0.375, rank))
        over = run_phase(spec, ADM_OVERLOAD_S)
        received = server.method_status("Echo.Echo").received.get_value()
        binding = server._native_ici
        native_requests = binding.requests() if binding is not None else 0
        describe = server.admission.describe()
        # on the native door the stop waits for the relocation copies
        # its calls launched (their completions trail the calls)
        t_stop = time.monotonic()
        server.stop()
        out["stop_ms"] = (time.monotonic() - t_stop) * 1e3
        torch.cuda.synchronize()
        out["active_after_stop"] = plane.active_transfers()
        out["transfers"] = plane.stats()["transfers"] - transfers0
        out["launches"] = p2p_copy.launches
        out["requests_received"] = received
        out["attachments_returned"] = served["returned"]
        out["native_requests"] = native_requests
    finally:
        server.stop()
    hi, hi_by_tenant = [], {}
    shed = hinted = low_ok = issued = errs = bad = 0
    codes = []
    streams = {}
    for (pri, tenant), c in over.items():
        streams[f"{tenant}/p{pri}"] = {
            k: round(c[k], 3) if isinstance(c[k], float) else c[k]
            for k in ("issued", "ok", "shed", "in_call_s", "max_call_ms")}
        if pri == 0:
            hi.extend(c["lats"])
            hi_by_tenant[tenant] = c["ok"]
        else:
            low_ok += c["ok"]
        shed += c["shed"]
        hinted += c["shed_with_hint"]
        issued += c["issued"]
        errs += c["err"]
        bad += c["bad"]
        codes += c["codes"]
    base_lats = base[(0, "t0")]["lats"]
    bad += base[(0, "t0")]["bad"]
    mean_share = sum(hi_by_tenant.values()) / len(ADM_TENANTS)
    out.update({
        "offered_rps": ADM_FACTOR * capacity,
        "offered_rps_measured": issued / ADM_OVERLOAD_S,
        "hi_p99_unloaded_us": _pct(base_lats, 0.99),
        "hi_p99_overload_us": _pct(hi, 0.99) if hi else -1.0,
        "hi_goodput_by_tenant": hi_by_tenant, "low_goodput": low_ok,
        "shed": shed, "shed_with_retry_after": hinted, "errors": errs,
        "tenant_min_share_ratio": (min(hi_by_tenant.values()) / mean_share
                                   if mean_share else -1.0),
        "payload_bytes": payload, "door": door, "describe": describe,
        "streams": streams,
        "wall_s": time.monotonic() - t_phase})
    out["hi_p99_ratio"] = (out["hi_p99_overload_us"]
                           / out["hi_p99_unloaded_us"])
    gc.collect()
    torch.cuda.synchronize()
    out["memory_delta_bytes"] = torch.cuda.memory_allocated(dev) - mem0
    print(f"admission ({door} door): capacity {capacity:.0f} rps, offered "
          f"{out['offered_rps_measured']:.1f} rps measured "
          f"({out['offered_rps']:.0f} paced); priority-0 p99 "
          f"{out['hi_p99_unloaded_us']:.1f} us unloaded, "
          f"{out['hi_p99_overload_us']:.1f} us at overload (ratio "
          f"{out['hi_p99_ratio']:.3f}; bench.py bounds it at 2; not gated "
          f"here: at this shape the JAX package misses alike on one host, "
          f"sweeps/overload_ab.py); served p0 by tenant {json.dumps(hi_by_tenant)}, low "
          f"{low_ok}; shed {shed} ({hinted} with a hint); errors {errs} "
          f"{sorted(set(codes))}; per stream class {json.dumps(streams)}; "
          f"describe {json.dumps(describe)}", flush=True)
    check(served["bad"] == 0 and bad == 0,
          f"payloads differ: {served['bad']} at the server, {bad} back")
    check(shed > 0 and hinted == shed,
          f"{shed - hinted} of {shed} sheds carried no retry_after_ms")
    check(errs == 0, f"{errs} calls failed other than by a shed: "
                     f"{sorted(set(codes))}")
    check(len(hi_by_tenant) == len(ADM_TENANTS)
          and min(hi_by_tenant.values()) >= 0.5 * mean_share > 0,
          f"a tenant starved: {hi_by_tenant}")
    check(out["launches"] == out["transfers"]
          == out["requests_received"] + out["attachments_returned"],
          f"admission: p2p_copy launches {out['launches']}, plane transfers "
          f"{out['transfers']}, requests received "
          f"{out['requests_received']} + attachments returned "
          f"{out['attachments_returned']}")
    check(out["active_after_stop"] == 0,
          f"{out['active_after_stop']} transfers active after the stop")
    if door == "native":
        check(out["native_requests"] == out["requests_received"] > 0,
              f"native door: {out['native_requests']} native requests of "
              f"{out['requests_received']} received")
    else:
        check(out["native_requests"] == 0,
              f"{out['native_requests']} requests took the native door "
              f"with {payload} B attachments")
    check(abs(out["memory_delta_bytes"]) <= ADM_MEMORY_SLACK,
          f"device memory {out['memory_delta_bytes']} B off its level "
          f"after the overload")
    print(f"admission: p2p_copy launches {out['launches']} = plane transfers "
          f"{out['transfers']} = requests received "
          f"{out['requests_received']} + attachments returned "
          f"{out['attachments_returned']}; the stop took "
          f"{out['stop_ms']:.1f} ms, none active after it; memory delta "
          f"{out['memory_delta_bytes']} B; phase {out['wall_s']:.1f} s",
          flush=True)
    return out


def phase_drain(mesh, plane, p2p_copy) -> dict:
    """(b) a lame-duck stop under traffic on ici:// (see the module
    docstring, phase 10)."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil.endpoint import parse_endpoint
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc import health_check, lameduck

    t_phase = time.monotonic()
    dev = mesh.device(0)
    ep = parse_endpoint("ici://5")
    payload = mesh.own(torch.from_numpy(np.random.default_rng(55).integers(
        0, 256, ADM_PAYLOAD, dtype=np.uint8)).to(dev), 6)

    entered = []

    class Echo(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            entered.append(1)
            time.sleep(DRAIN_SERVICE_MS / 1000.0)
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    server = rpc.Server(rpc.ServerOptions(
        graceful_shutdown_s=DRAIN_GRACE_S, usercode_in_pthread=True,
        usercode_backup_threads=DRAIN_CALLS + 4))
    server.add_service(Echo())
    check(server.start("ici://5") == 0, "drain server start on ici://5")
    ch = rpc.Channel()
    ch.init("ici://5", options=rpc.ChannelOptions(
        timeout_ms=30000, max_retry=0))
    out = {}
    try:
        transfers0 = plane.stats()["transfers"]
        results, all_done = {}, threading.Event()
        lock = threading.Lock()

        def on_done(i, c):
            with lock:
                results[i] = (c.error_code_, None if c.failed() else
                              torch.equal(_tensor_of(c.response_attachment),
                                          payload))
                if len(results) == DRAIN_CALLS:
                    all_done.set()

        for i in range(DRAIN_CALLS):
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(payload)
            ch.call_method("Echo.Echo", cntl, EchoRequest(message=str(i)),
                           EchoResponse, done=lambda c, i=i: on_done(i, c))
        deadline = time.monotonic() + 10
        while len(entered) < DRAIN_CALLS and time.monotonic() < deadline:
            time.sleep(0.001)
        check(len(entered) == DRAIN_CALLS,
              "the drain's calls never all reached the handler")
        stop_s = {}

        def stopper():
            t0 = time.monotonic()
            server.stop()
            stop_s["s"] = time.monotonic() - t0

        stop_thread = threading.Thread(target=stopper)
        stop_thread.start()
        deadline = time.monotonic() + 5
        while not server.is_draining() and time.monotonic() < deadline:
            time.sleep(0.0005)
        check(server.is_draining(), "the server never flipped to draining")
        late = []
        for i in range(DRAIN_LATE_CALLS):
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(payload)
            ch.call_method("Echo.Echo", cntl,
                           EchoRequest(message=f"late{i}"), EchoResponse)
            late.append(cntl.error_code_)
        goodbye = ep in lameduck.peer_draining()
        stop_thread.join(DRAIN_GRACE_S + 10)
        check(not stop_thread.is_alive(), "stop() did not return")
        out["active_at_stop_return"] = plane.active_transfers()
        out["pending_at_stop_return"] = plane.pending_sends()
        out["inflight_at_stop_return"] = server.inflight_requests()
        check(all_done.wait(10), "in-flight calls never completed")
        torch.cuda.synchronize()
        out["transfers"] = plane.stats()["transfers"] - transfers0
        out["launches"] = p2p_copy.launches
        out["received"] = server.method_status("Echo.Echo").received \
            .get_value()
        out.update({"calls": DRAIN_CALLS, "ok": sum(
            1 for code, same in results.values() if code == 0 and same),
            "late_codes": late, "goodbye_seen": goodbye,
            "stop_s": stop_s["s"], "last_drain": server.last_drain})
        check(out["ok"] == DRAIN_CALLS,
              f"in-flight calls through the drain: {results}")
        check(all(code == rpc.errors.ELOGOFF for code in late),
              f"calls after the flip got {late}, not ELOGOFF")
        check(goodbye, "the client's socket never saw the GOODBYE")
        check(out["active_at_stop_return"] == 0
              and out["pending_at_stop_return"] == 0
              and out["inflight_at_stop_return"] == 0,
              f"stop() returned with active {out['active_at_stop_return']}, "
              f"pending {out['pending_at_stop_return']}, in flight "
              f"{out['inflight_at_stop_return']}")
        check(out["launches"] == out["transfers"]
              == out["received"] + DRAIN_CALLS,
              f"drain: p2p_copy launches {out['launches']}, plane transfers "
              f"{out['transfers']}, requests received {out['received']} + "
              f"{DRAIN_CALLS} returned")
        # the restart lifts the local mark; the checker's probe the peer's
        check(server.start("ici://5") == 0, "restart on ici://5")
        check(health_check.start_health_check(ep).probe_now(),
              "the restarted endpoint did not revive")
        check(not lameduck.is_draining(ep), "the drain mark survived")
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(payload)
        ch.call_method("Echo.Echo", cntl, EchoRequest(message="again"),
                       EchoResponse)
        check(not cntl.failed() and torch.equal(
            _tensor_of(cntl.response_attachment), payload),
            f"the restarted server did not serve: {cntl.error_text}")
        out["path_launches"] = p2p_copy.launches
    finally:
        ch.close()
        server.stop()
    out["wall_s"] = time.monotonic() - t_phase
    print(f"drain: {DRAIN_CALLS} in-flight calls of {ADM_PAYLOAD} B "
          f"completed OK through stop(grace {DRAIN_GRACE_S} s) in "
          f"{out['stop_s'] * 1e3:.1f} ms ({json.dumps(out['last_drain'])}); "
          f"{DRAIN_LATE_CALLS} calls after the flip got {sorted(set(late))}; "
          f"GOODBYE seen; launches {out['launches']} = transfers "
          f"{out['transfers']} = received {out['received']} + returned "
          f"{DRAIN_CALLS}; restart served; phase {out['wall_s']:.1f} s",
          flush=True)
    return out


def phase_elastic(mesh, plane, p2p_copy) -> dict:
    """(c) an elastic decode fleet: the autoscaler's scale-down (drain by
    migration, then a lame-duck stop) and scale-up under Generate
    traffic (see the module docstring, phase 10)."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.butil.endpoint import parse_endpoint
    from brpc_tpu_torch.examples.disagg_serving import model
    from brpc_tpu_torch.examples.disagg_serving.workers import (
        BYTES_PER_TOKEN, close_services, start_decode_worker,
        start_prefill_worker, start_router)
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc import lameduck
    from brpc_tpu_torch.serving import (AutoscalerOptions, KvPoolOptions,
                                        LoadThresholdAutoscaler)

    t_phase = time.monotonic()
    dev = mesh.device(0)
    flags.set_flag("ici_device_plane_threshold", 64 * 1024)
    rng = np.random.default_rng(10)
    ep3 = parse_endpoint("ici://3")

    def prompt(n):
        return rng.integers(0, model.VOCAB, n).tolist()

    def pool_options():
        return KvPoolOptions(bytes_per_token=BYTES_PER_TOKEN,
                             num_blocks=SERVE_POOL_BLOCKS,
                             block_tokens=SERVE_BLOCK_TOKENS)

    prefill = start_prefill_worker("ici://1", mesh=mesh)
    decodes = {url: start_decode_worker(url, mesh=mesh,
                                        pool_options=pool_options())
               for url in ("ici://2", "ici://3")}
    router = start_router("mem://chip-smoke-elastic", "ici://1",
                          list(decodes), rng=random.Random(10))
    rsvc = next(iter(router.services().values()))
    svcs = {url: next(iter(s.services().values()))
            for url, s in decodes.items()}
    live = dict(decodes)
    wlock = threading.Lock()
    channels = []

    def channel(target):
        ch = rpc.Channel()
        ch.init(target, options=rpc.ChannelOptions(
            timeout_ms=120000, max_retry=0))
        channels.append(ch)
        return ch

    def call(ch, method, body, cntl=None):
        cntl = cntl or rpc.Controller()
        resp = ch.call_method(method, cntl,
                              EchoRequest(message=json.dumps(body)),
                              EchoResponse)
        return cntl, (None if resp is None else json.loads(resp.message))

    def received():
        return sum(s.method_status(m).received.get_value()
                   for s in decodes.values()
                   for m in ("Decode.LoadKv", "Decode.MigrateIn"))

    def load_fn():
        with wlock:
            members = [svcs[url] for url in live]
        return sum(s.load() for s in members) / len(members)

    def size_fn():
        with wlock:
            return len(live)

    timing = {}
    to3 = channel("ici://3")

    def drain():
        t0 = time.monotonic()
        moved, refused = [], []
        for session in svcs["ici://3"].pool.session_ids():
            cntl, _ = call(to3, "Decode.MigrateOut",
                           {"session": session, "dest": "ici://2"})
            if cntl.failed():
                refused.append((session, cntl.error_text))
            else:
                moved.append(session)
        timing["drain_s"] = time.monotonic() - t0
        timing["moved"], timing["refused"] = moved, refused

    def scale_down():
        with wlock:
            server = live.pop("ici://3")
        rsvc.remove_decode_target("ici://3")
        t0 = time.monotonic()
        server.stop(grace_s=ELASTIC_GRACE_S)
        timing["stop_s"] = time.monotonic() - t0
        timing["inflight_at_stop"] = server.inflight_requests()
        timing["active_at_stop"] = plane.active_transfers()
        timing["last_drain"] = server.last_drain
        return True

    def scale_up():
        server = decodes["ici://3"]
        if server.start("ici://3") != 0:
            return False
        with wlock:
            live["ici://3"] = server
        rsvc.add_decode_target("ici://3")
        return True

    scaler = LoadThresholdAutoscaler(
        load_fn, size_fn, scale_up, scale_down, drain=drain,
        options=AutoscalerOptions(samples_to_scale=2, min_size=1,
                                  max_size=2))
    out = {}
    try:
        transfers0 = plane.stats()["transfers"]
        received0 = received()
        # 1. 64 live sessions on rank 3
        held = {f"e{i}": prompt(SERVE_PROMPT) for i in range(ELASTIC_HELD)}
        for session, tokens in held.items():
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(
                mesh.own(model.toy_kv_blocks(tokens, mesh.device(1)), 1))
            cntl, _ = call(to3, "Decode.LoadKv",
                           {"session": session, "seq_len": len(tokens),
                            "last_token": tokens[-1]}, cntl)
            check(not cntl.failed(), f"LoadKv {session}: {cntl.error_text}")
        # 2. Generates from two clients; the autoscaler acts at fixed
        # points of the count
        front = channel("mem://chip-smoke-elastic")
        prompts = [prompt(SERVE_PROMPT) for _ in range(SERVE_PROMPTS)]
        got = [None] * len(prompts)
        count = [0]
        cv = threading.Condition()

        def client(k):
            for i in range(k, len(prompts), SERVE_THREADS):
                t0 = time.perf_counter_ns()
                cntl, resp = call(front, "Router.Generate",
                                  {"tokens": prompts[i],
                                   "steps": SERVE_STEPS})
                ms = (time.perf_counter_ns() - t0) / 1e6
                got[i] = (cntl.error_code_, cntl.error_text,
                          resp["tokens"] if resp else None,
                          resp["decode_worker"] if resp else None, ms)
                with cv:
                    count[0] += 1
                    cv.notify_all()
                    # hold at the scale-up point until it has fired
                    while count[0] >= ELASTIC_UP_AT and "up" not in timing:
                        cv.wait(60)

        def wait_count(n):
            with cv:
                check(cv.wait_for(lambda: count[0] >= n, 600),
                      f"Generates stalled before {n} completed")

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(SERVE_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        # 4. scale-down after the 5th Generate: two low samples
        wait_count(ELASTIC_DOWN_AT)
        ticks = [scaler.tick(now=0.0), scaler.tick(now=1.0)]
        check(ticks == [None, "down"], f"scale-down ticks {ticks}")
        check(all(s in timing["moved"] for s in held),
              f"the drain did not move every held session: "
              f"{timing['refused']}")
        left = [s for s in held
                if svcs["ici://3"].pool.get(s) is not None]
        check(not left, f"rank 3 still holds {left}")
        check(timing["inflight_at_stop"] == 0
              and timing["last_drain"]["drained"],
              f"rank 3 stopped with {timing['inflight_at_stop']} in flight, "
              f"drain {timing['last_drain']}")
        # 5. scale-up after the 15th: the 64 migrated sessions decode on
        # rank 2, async, all at once
        wait_count(ELASTIC_UP_AT)
        results, all_done = {}, threading.Event()
        rlock = threading.Lock()

        def on_done(s, c):
            with rlock:
                results[s] = (c.error_code_, None if c.failed() else
                              json.loads(c.response.message)["tokens"])
                if len(results) == len(held):
                    all_done.set()

        to2 = channel("ici://2")
        for session in held:
            cntl = rpc.Controller()
            to2.call_method("Decode.Decode", cntl, EchoRequest(
                message=json.dumps({"session": session,
                                    "steps": ELASTIC_LOAD_STEPS})),
                EchoResponse,
                done=lambda c, s=session: on_done(s, c))
        deadline = time.monotonic() + 60
        while load_fn() < 1.0 and time.monotonic() < deadline:
            time.sleep(0.0005)
        out["load_at_scale_up"] = load_fn()
        ticks = [scaler.tick(now=10.0), scaler.tick(now=11.0)]
        with cv:
            timing["up"] = ticks
            cv.notify_all()
        check(ticks == [None, "up"],
              f"scale-up ticks {ticks} at load {out['load_at_scale_up']}")
        check(all_done.wait(600), "the migrated sessions' Decodes stalled")
        bad = [s for s, tokens in held.items()
               if results[s] != (0, model.reference_generate(
                   tokens, ELASTIC_LOAD_STEPS, dev))]
        check(not bad, f"migrated sessions {bad} decode differently on "
                       f"rank 2")
        # the restarted worker: its peer mark (where a GOODBYE reached a
        # connection) lifts at the health checker's next probe
        t_rev = time.monotonic()
        while lameduck.is_draining(ep3) \
                and time.monotonic() - t_rev < ELASTIC_REVIVE_S:
            time.sleep(0.01)
        check(not lameduck.is_draining(ep3),
              "the restarted rank 3 was never revived")
        timing["revive_wait_s"] = time.monotonic() - t_rev
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads) and all(got),
              "Generate clients did not finish")
        # 6. four more Generates: at least one routed to rank 3
        after = []
        for _ in range(ELASTIC_AFTER):
            tokens = prompt(SERVE_PROMPT)
            cntl, resp = call(front, "Router.Generate",
                              {"tokens": tokens, "steps": SERVE_STEPS})
            after.append((cntl.error_code_, cntl.error_text,
                          resp["tokens"] if resp else None,
                          resp["decode_worker"] if resp else None, 0.0))
            prompts.append(tokens)
        got += after
        bad = [i for i, (tokens, g) in enumerate(zip(prompts, got))
               if g[0] != 0 or g[2] != model.reference_generate(
                   tokens, SERVE_STEPS, dev)]
        check(not bad, f"Generates {bad} failed or differ from "
                       f"reference_generate: {[got[i][:2] for i in bad]}")
        router_d = rsvc.describe_serving()["router"]
        check(router_d["generate_failures"] == 0,
              f"generate_failures {router_d['generate_failures']}")
        check(any(g[3] == "ici://3" for g in after),
              f"no Generate after the scale-up reached rank 3: "
              f"{[g[3] for g in after]}")
        d = scaler.describe()
        check((d["scale_downs"], d["scale_ups"]) == (1, 1),
              f"autoscaler {d}")
        torch.cuda.synchronize()
        out["transfers"] = plane.stats()["transfers"] - transfers0
        out["launches"] = p2p_copy.launches
        out["calls_received"] = received() - received0
        out["active_at_end"] = plane.active_transfers()
        check(out["active_at_end"] == 0,
              f"{out['active_at_end']} transfers active at the end")
        check(out["launches"] == out["transfers"] == out["calls_received"],
              f"elastic: p2p_copy launches {out['launches']}, plane "
              f"transfers {out['transfers']}, LoadKv + MigrateIn received "
              f"{out['calls_received']}")
        lat = [g[4] for g in got[:SERVE_PROMPTS]]
        out.update({
            "generates": len(got), "generate_p50_ms": _pct(lat, 0.5),
            "generate_p99_ms": _pct(lat, 0.99), "wall_s_generates": wall,
            "workers_after": [g[3] for g in after],
            "router_retries": router_d["retries"],
            "drain_s": timing["drain_s"], "stop_s": timing["stop_s"],
            "migrated": len(timing["moved"]),
            "drain_refused": timing["refused"],
            "last_drain": timing["last_drain"],
            "active_at_stop_return": timing["active_at_stop"],
            "revive_wait_s": timing["revive_wait_s"],
            "autoscaler": d, "router": router_d})
        # requests the decode servers parsed but never ran: with no
        # admission layer here, the lame-duck bounces
        statuses = [s.method_status(f"Decode.{m}") for s in decodes.values()
                    for m in ("LoadKv", "Decode", "MigrateOut", "MigrateIn")]
        out["elogoff_bounces"] = sum(
            st.received.get_value() - st.latency_rec.count()
            - st.error_count.get_value() - st.shed_count.get_value()
            for st in statuses)
    finally:
        scaler.stop()
        for ch in channels:
            ch.close()
        close_services(router, prefill, *decodes.values())
    out["wall_s"] = time.monotonic() - t_phase
    print(f"elastic: {len(out['workers_after'])} Generates after the "
          f"scale-up went to {out['workers_after']}; {out['generates']} "
          f"Generates p50 {out['generate_p50_ms']:.3f} ms, p99 "
          f"{out['generate_p99_ms']:.3f} ms, all equal reference_generate; "
          f"scale-down: drain {out['drain_s'] * 1e3:.1f} ms "
          f"({out['migrated']} migrated, refused {out['drain_refused']}), "
          f"stop {out['stop_s'] * 1e3:.1f} ms ({json.dumps(out['last_drain'])},"
          f" active at its return {out['active_at_stop_return']}); router "
          f"retries {out['router_retries']}, ELOGOFF bounces "
          f"{out['elogoff_bounces']}; revived after "
          f"{out['revive_wait_s']:.2f} s; launches {out['launches']} = "
          f"transfers {out['transfers']} = LoadKv + MigrateIn received "
          f"{out['calls_received']}; phase {out['wall_s']:.1f} s", flush=True)
    return out


def phase_streaming(mesh, plane, p2p_copy) -> dict:
    """Streaming RPC on ici:// (see the module docstring, phase 11)."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil.iobuf import DEVICE, IOBuf
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse

    t_phase = time.monotonic()
    dev = mesh.device(0)
    out = {"transfers0": plane.stats()["transfers"]}

    class Sink(rpc.Service):
        """Accepts a stream whose handler the test sets."""

        def __init__(self):
            self.handler = None
            self.max_buf = 0
            self.streams = []

        @rpc.method(EchoRequest, EchoResponse)
        def Open(self, cntl, request, response, done):
            self.streams.append(rpc.stream_accept(cntl, rpc.StreamOptions(
                handler=self.handler, max_buf_size=self.max_buf)))
            response.message = "ok"
            done()

    def open_stream(svc, target, handler, max_buf, opts=None):
        server = rpc.Server(opts)
        server.add_service(svc)
        check(server.start(target) == 0, f"stream server on {target}")
        svc.handler, svc.max_buf = handler, max_buf
        ch = rpc.Channel()
        ch.init(target, options=rpc.ChannelOptions(timeout_ms=30000))
        cntl = rpc.Controller()
        st = rpc.stream_create(cntl, rpc.StreamOptions(max_buf_size=max_buf))
        ch.call_method("Sink.Open", cntl, EchoRequest(message="s"),
                       EchoResponse)
        check(not cntl.failed() and st.wait_connected(10),
              f"stream handshake to {target}: {cntl.error_text}")
        return server, ch, st

    # (a) bench_streaming_mbps's leg: 64 KiB host chunks for 1.5 s
    class Count(rpc.StreamInputHandler):
        def __init__(self):
            self.bytes = 0
            self.closed = threading.Event()

        def on_received_messages(self, sid, msgs):
            self.bytes += sum(len(m) for m in msgs)

        def on_closed(self, sid):
            self.closed.set()

    count = Count()
    server, ch, st = open_stream(Sink(), "ici://6", count, 8 << 20)
    try:
        data = IOBuf(b"x" * STREAM_HOST_CHUNK)
        sent, t0 = 0, time.monotonic()
        stop = t0 + STREAM_HOST_S
        while time.monotonic() < stop:
            check(st.write(data, timeout=5) == 0, "host stream write")
            sent += STREAM_HOST_CHUNK
        deadline = time.monotonic() + 10
        while count.bytes < sent and time.monotonic() < deadline:
            time.sleep(0.002)
        dt = time.monotonic() - t0
        check(count.bytes == sent,
              f"host stream delivered {count.bytes} of {sent} B")
        out["host"] = {"chunk": STREAM_HOST_CHUNK, "sent": sent,
                       "received": count.bytes, "mbps": sent / dt / 1e6}
        st.close()
    finally:
        ch.close()
        server.stop()

    # (b) 256 DEVICE chunks of 4 MiB, rank 4 -> ici://3
    n, size = STREAM_CHUNKS, STREAM_CHUNK
    gen = torch.Generator(device=dev).manual_seed(1111)
    src = mesh.own(torch.randint(0, 256, (n * size,), dtype=torch.uint8,
                                 device=dev, generator=gen), 4)
    sent_at = [0.0] * n

    class Verify(rpc.StreamInputHandler):
        def __init__(self):
            self.seen = 0
            self.equal = 0
            self.device_frames = 0
            self.one_way = []
            self.last_at = 0.0
            self.closed = threading.Event()

        def on_received_messages(self, sid, msgs):
            for m in msgs:
                i = self.seen
                self.seen += 1
                ref = m.backing_block(0)
                dev_block = (m.backing_block_num() == 1
                             and ref.block.kind == DEVICE)
                self.device_frames += dev_block
                if dev_block and torch.equal(
                        ref.block.data[ref.offset:ref.offset + ref.length],
                        src[i * size:(i + 1) * size]):
                    self.equal += 1
                self.last_at = time.perf_counter()
                self.one_way.append((self.last_at - sent_at[i]) * 1e6)

        def on_closed(self, sid):
            self.closed.set()

    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated(dev)
    verify = Verify()
    svc = Sink()
    launches0 = p2p_copy.launches
    transfers0 = plane.stats()["transfers"]
    server, ch, st = open_stream(svc, "ici://3", verify, STREAM_WINDOW)
    try:
        t0 = time.perf_counter()
        for i in range(n):
            buf = IOBuf()
            buf.append_device_array(src[i * size:(i + 1) * size])
            sent_at[i] = time.perf_counter()
            check(st.write(buf, timeout=30) == 0, f"device chunk {i}")
        del buf
        st.close()
        check(verify.closed.wait(60), "the device stream never closed")
        wall = verify.last_at - t0
        torch.cuda.synchronize()
        out["device"] = {
            "chunks": n, "chunk": size, "received": verify.seen,
            "equal": verify.equal, "device_frames": verify.device_frames,
            "launches": p2p_copy.launches - launches0,
            "transfers": plane.stats()["transfers"] - transfers0,
            "mbps": n * size / wall / 1e6, "wall_s": wall,
            "one_way_p50_us": _pct(verify.one_way, 0.5),
            "one_way_p99_us": _pct(verify.one_way, 0.99),
            "server_close_reason": svc.streams[0].close_reason}
    finally:
        ch.close()
        server.stop()
    d = out["device"]
    check(d["received"] == d["equal"] == n,
          f"device stream: {d['equal']} of {n} chunks equal, "
          f"{d['received']} received")
    check(d["launches"] == d["transfers"] == d["device_frames"] == n,
          f"device stream: launches {d['launches']}, transfers "
          f"{d['transfers']}, DATA frames with a device block "
          f"{d['device_frames']}, chunks {n}")
    verify = None
    deadline = time.monotonic() + 10
    while True:
        gc.collect()
        torch.cuda.synchronize()
        left = torch.cuda.memory_allocated(dev) - base
        if left < (1 << 20) or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    d["memory_left"] = left
    check(left < (1 << 20), f"device stream left {left} B allocated")
    del src

    # (c) a lame-duck stop with a 4 MiB-chunk stream open
    stop_src = mesh.own(torch.randint(
        0, 256, (STOP_CHUNKS * size,), dtype=torch.uint8, device=dev,
        generator=gen), 4)
    kept = []

    class Keep(rpc.StreamInputHandler):
        def __init__(self):
            self.closed = threading.Event()
            self.bytes = 0
            self.equal = 0

        def on_received_messages(self, sid, msgs):
            for m in msgs:
                i = len(kept)
                kept.append(len(m))
                self.bytes += len(m)
                ref = m.backing_block(0)
                self.equal += torch.equal(
                    ref.block.data[ref.offset:ref.offset + ref.length],
                    stop_src[i * size:(i + 1) * size])

        def on_closed(self, sid):
            self.closed.set()

    keep = Keep()
    svc = Sink()
    server, ch, st = open_stream(svc, "ici://2", keep, STREAM_WINDOW)
    try:
        written = 0

        def write(i):
            buf = IOBuf()
            buf.append_device_array(stop_src[i * size:(i + 1) * size])
            check(st.write(buf, timeout=30) == 0, f"stop stream chunk {i}")
            return size

        for i in range(STOP_CHUNKS // 2):
            written += write(i)
        stop_s = {}

        def stopper():
            t0 = time.monotonic()
            server.stop(STOP_GRACE_S)
            stop_s["s"] = time.monotonic() - t0

        stop_thread = threading.Thread(target=stopper)
        stop_thread.start()
        deadline = time.monotonic() + 5
        while not server.is_draining() and time.monotonic() < deadline:
            time.sleep(0.0005)
        check(server.is_draining(), "the stream server never drained")
        for i in range(STOP_CHUNKS // 2, STOP_CHUNKS):
            written += write(i)         # the stream stays open in the drain
        stop_thread.join(STOP_GRACE_S + 10)
        check(not stop_thread.is_alive(), "stop() did not return")
        check(keep.closed.wait(10), "the server's stream never closed")
        deadline = time.monotonic() + 5
        while not st.closed and time.monotonic() < deadline:
            time.sleep(0.001)
        out["stop"] = {
            "chunks": STOP_CHUNKS, "written": written,
            "received": keep.bytes, "equal": keep.equal,
            "client_close_reason": st.close_reason,
            "drained": server.last_drain["drained"],
            "stop_s": stop_s["s"],
            "write_after_close": st.append_if_not_full(IOBuf(b"x"))}
    finally:
        ch.close()
        server.stop()
    s = out["stop"]
    check(s["received"] == s["written"] and s["equal"] == STOP_CHUNKS,
          f"stop: {s['received']} of {s['written']} B received, "
          f"{s['equal']} chunks equal")
    check(s["client_close_reason"] == "close" and not s["drained"]
          and s["write_after_close"] == rpc.errors.EINVAL,
          f"stop: the client's stream ended by {s['client_close_reason']!r}"
          f" (drained {s['drained']})")
    del stop_src
    out["launches"] = p2p_copy.launches
    out["transfers"] = plane.stats()["transfers"] - out.pop("transfers0")
    out["wall_s"] = time.monotonic() - t_phase
    print(f"streaming: (a) {out['host']['mbps']:.1f} MB/s of "
          f"{STREAM_HOST_CHUNK} B host chunks, {out['host']['received']} of "
          f"{out['host']['sent']} B received; (b) {n} x {size} B DEVICE "
          f"chunks {d['mbps']:.1f} MB/s, one-way p50 "
          f"{d['one_way_p50_us']:.1f} us, all equal, launches = transfers "
          f"= DATA frames with a device block = {d['launches']}, memory "
          f"left {d['memory_left']} B; (c) stop with the stream open: "
          f"{s['received']} of {s['written']} B received, client saw "
          f"{s['client_close_reason']!r}, stop {s['stop_s']:.2f} s; phase "
          f"{out['wall_s']:.1f} s", flush=True)
    return out


def phase_fanout(mesh, plane, p2p_copy) -> dict:
    """The host combo channels on ici:// (see the module docstring,
    phase 12)."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import channels, rpc
    from brpc_tpu_torch.butil.iobuf import IOBuf
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse

    t_phase = time.monotonic()
    dev = mesh.device(0)
    transfers0 = plane.stats()["transfers"]

    class Echo(rpc.Service):
        """Echoes the message; a request attachment, a float32 shard,
        comes back times the server's rank, owned by it."""

        SERVICE_NAME = "EchoService"

        def __init__(self, rank):
            self.rank = rank

        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            if len(cntl.request_attachment):
                x = _tensor_of(cntl.request_attachment).view(torch.float32)
                cntl.response_attachment.append_device_array(mesh.own(
                    (x * self.rank).view(torch.uint8), self.rank))
            done()

    class Shards(channels.CallMapper):
        def __init__(self, rows):
            self.rows = rows

        def map(self, i, method, request):
            att = IOBuf()
            att.append_device_array(self.rows[i])
            return channels.SubCall(request, attachment=att)

    class Concat(channels.ResponseMerger):
        """Keeps each answer by its sub-call's index; the whole fan-out
        ends in one concatenation."""

        def __init__(self, n):
            self.n = n
            self.parts = {}
            self.result = None

        def merge_sub(self, parent_cntl, index, sub_cntl, response):
            self.parts[index] = _tensor_of(
                sub_cntl.response_attachment).view(torch.float32)
            return self.MERGED

        def finalize_fanout(self, parent_cntl):
            self.result = torch.cat([self.parts[i] for i in range(self.n)])

    ranks = list(range(mesh.size))
    servers, subs = {}, {}
    out = {}
    try:
        for r in ranks:
            s = rpc.Server(rpc.ServerOptions(usercode_inline=True))
            s.add_service(Echo(r))
            check(s.start(f"ici://{r}") == 0, f"fan-out server ici://{r}")
            servers[r] = s
            ch = rpc.Channel()
            ch.init(f"ici://{r}", options=rpc.ChannelOptions(
                timeout_ms=30000, max_retry=0))
            subs[r] = ch

        # (a) bench_parallel_fanout_us's shape: 8 members, echo p50
        pc = channels.ParallelChannel()
        for r in ranks:
            pc.add_channel(subs[r])
        lat = []
        for i in range(FANOUT_ITERS + 10):
            cntl = rpc.Controller()
            t0 = time.perf_counter_ns()
            pc.call_method("EchoService.Echo", cntl,
                           EchoRequest(message="p"), EchoResponse())
            t1 = time.perf_counter_ns()
            check(not cntl.failed(), f"fan-out echo: {cntl.error_text}")
            if i >= 10:
                lat.append((t1 - t0) / 1000.0)
        out["echo"] = {"subs": len(ranks), "iters": FANOUT_ITERS,
                       "p50_us": _pct(lat, 0.5), "p99_us": _pct(lat, 0.99),
                       "transfers": plane.stats()["transfers"] - transfers0}

        # (b) 64 MiB of float32 on rank 0, one 8 MiB shard per member
        gen = torch.Generator(device=dev).manual_seed(1212)
        x = torch.randn(FANOUT_BYTES // 4, device=dev, generator=gen)
        rows = [mesh.own(r_.contiguous().view(torch.uint8), 0)
                for r_ in x.view(len(ranks), -1)]
        merger = Concat(len(ranks))
        pc = channels.ParallelChannel()
        for r in ranks:
            pc.add_channel(subs[r], mapper=Shards(rows), merger=merger)
        scale = torch.tensor(ranks, dtype=torch.float32, device=dev)
        want = (x.view(len(ranks), -1) * scale[:, None]).view(-1)
        launches0, t0 = p2p_copy.launches, plane.stats()["transfers"]
        cntl = rpc.Controller()
        w0 = time.perf_counter()
        pc.call_method("EchoService.Echo", cntl, EchoRequest(message="x"),
                       EchoResponse())
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        check(not cntl.failed(), f"sharded fan-out: {cntl.error_text}")
        # a member on the shards' own rank takes its shard by reference;
        # every answer crosses back to its channel's rank
        out_legs = sum(1 for r in ranks if r != 0)
        back_legs = len(ranks)
        out["sharded"] = {
            "bytes": FANOUT_BYTES, "shard": FANOUT_BYTES // len(ranks),
            "equal": bool(torch.equal(merger.result, want)),
            "launches": p2p_copy.launches - launches0,
            "transfers": plane.stats()["transfers"] - t0,
            "out_legs": out_legs, "back_legs": back_legs,
            "ms": wall * 1e3}
        sh = out["sharded"]
        check(sh["equal"], "the merged fan-out differs from the plain "
                           "product")
        check(sh["launches"] == sh["transfers"] == out_legs + back_legs,
              f"sharded fan-out: launches {sh['launches']}, transfers "
              f"{sh['transfers']}, legs {out_legs} out + {back_legs} back")

        # (c) a PartitionChannel of 4 from a list:// url with i/4 tags
        part_ranks = ranks[4:]
        url = "list://" + ",".join(f"ici://{r} 100 {i}/4"
                                   for i, r in enumerate(part_ranks))
        prow = [mesh.own(r_.contiguous().view(torch.uint8), 0)
                for r_ in x.view(4, -1)]
        pmerger = Concat(4)
        pch = channels.PartitionChannel()
        check(pch.init(4, url, mapper=Shards(prow), merger=pmerger,
                       options=rpc.ChannelOptions(timeout_ms=30000,
                                                  max_retry=0)) == 0
              and pch.partitions_ready(), "partition channel init")
        pscale = torch.tensor(part_ranks, dtype=torch.float32, device=dev)
        pwant = (x.view(4, -1) * pscale[:, None]).view(-1)
        launches0, t0 = p2p_copy.launches, plane.stats()["transfers"]
        cntl = rpc.Controller()
        pch.call_method("EchoService.Echo", cntl, EchoRequest(message="p"),
                        EchoResponse())
        torch.cuda.synchronize()
        check(not cntl.failed(), f"partition fan-out: {cntl.error_text}")
        out["partition"] = {
            "partitions": 4, "url": url,
            "equal": bool(torch.equal(pmerger.result, pwant)),
            "launches": p2p_copy.launches - launches0,
            "transfers": plane.stats()["transfers"] - t0}
        pa = out["partition"]
        check(pa["equal"], "the partitioned result differs from the plain "
                           "product")
        check(pa["launches"] == pa["transfers"] == 2 * 4,
              f"partition: launches {pa['launches']}, transfers "
              f"{pa['transfers']}, 4 sub-calls out and back")

        # (d) a SelectiveChannel over 3 members, one of them stopped
        sel = channels.SelectiveChannel()
        for r in (5, 6, 7):
            sel.add_channel(subs[r])
        servers[6].stop()
        oks, retried = 0, 0
        for i in range(SELECTIVE_CALLS):
            cntl = rpc.Controller()
            resp = sel.call_method("EchoService.Echo", cntl,
                                   EchoRequest(message=f"s{i}"),
                                   EchoResponse)
            oks += not cntl.failed() and resp.message == f"s{i}"
            retried += cntl.retried_count
        out["selective"] = {"calls": SELECTIVE_CALLS, "ok": oks,
                            "retries": retried}
        check(oks == SELECTIVE_CALLS,
              f"selective: {oks} of {SELECTIVE_CALLS} calls succeeded")
        check(retried > 0, "selective: no call retried on another member")
    finally:
        for ch in subs.values():
            ch.close()
        for s in servers.values():
            s.stop()
    out["launches"] = p2p_copy.launches
    out["transfers"] = plane.stats()["transfers"] - transfers0
    out["wall_s"] = time.monotonic() - t_phase
    print(f"fan-out: (a) {len(ranks)} members echo p50 "
          f"{out['echo']['p50_us']:.1f} us; (b) {FANOUT_BYTES} B in "
          f"{len(ranks)} shards {sh['ms']:.2f} ms, equal, launches = "
          f"transfers = {sh['launches']} ({out_legs} out, the member on the "
          f"shards' rank by reference, + {back_legs} back); (c) 4 "
          f"partitions equal, launches {pa['launches']}; (d) "
          f"{oks}/{SELECTIVE_CALLS} OK with {retried} retries; phase "
          f"{out['wall_s']:.1f} s", flush=True)
    return out


def phase_collective_fanout(mesh, plane, p2p_copy, ring_kernels) -> dict:
    """The compiled collective fan-out on ici://0-7 (see the module
    docstring, phase 13)."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import channels, rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.channels import collective_fanout as cf
    from brpc_tpu_torch.ici import route
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc import fault_injection as fi

    t_phase = time.monotonic()
    dev = mesh.device(0)
    ranks = list(range(mesh.size))
    out = {}

    class Fan(rpc.Service):
        """The wire bodies, the per-member loop's half of each method:
        the same function as the registered device body."""

        SERVICE_NAME = "Fan"

        def __init__(self, rank):
            self.rank = rank

        def _reply(self, cntl, fn):
            att = cntl.request_attachment
            if att.device_refs():
                x = _tensor_of(att)
                cntl.response_attachment.append_device_array(mesh.own(
                    fn(x.view(torch.float32)).view(torch.uint8)
                    if fn is not None else x, self.rank))
            else:
                cntl.response_attachment.append(att.to_bytes())

        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            self._reply(cntl, None)
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def EchoSharded(self, cntl, request, response, done):
            self._reply(cntl, None)
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def Scale(self, cntl, request, response, done):
            self._reply(cntl, lambda x: x * 2.0)
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def Sum(self, cntl, request, response, done):
            self._reply(cntl, lambda x: x * 0.5)
            done()

    def start(r):
        s = rpc.Server(rpc.ServerOptions(usercode_inline=True))
        s.add_service(Fan(r))
        s.register_collective("Fan.Echo", lambda x: x, merge="gather",
                              mapping="shard")
        s.register_collective("Fan.EchoSharded", lambda x: x, merge="none",
                              mapping="shard")
        s.register_collective("Fan.Scale", lambda x: x * 2.0,
                              merge="gather", mapping="shard")
        s.register_collective("Fan.Sum", lambda x: x * 0.5, merge="sum",
                              mapping="replicate")
        check(s.start(f"ici://{r}") == 0, f"fan-out server ici://{r}")
        return s

    def mk_pc(merge, dtype, shard_shape, mapper=None):
        pc = channels.ParallelChannel()
        mapper = mapper or channels.ShardingCallMapper()
        merger = channels.CollectiveMerger(merge=merge, dtype=dtype,
                                           shard_shape=shard_shape)
        for r in ranks:
            ch = rpc.Channel()
            ch.init(f"ici://{r}", options=rpc.ChannelOptions(
                timeout_ms=30000, max_retry=0))
            pc.add_channel(ch, mapper=mapper, merger=merger)
            chans.append(ch)
        return pc

    def call(pc, op, method, want_route):
        cntl = rpc.Controller()
        cntl.fanout_operand = op
        t0 = time.perf_counter_ns()
        pc.call_method(method, cntl, EchoRequest(message="f"),
                       EchoResponse())
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        check(not cntl.failed(), f"{method}: {cntl.error_text}")
        check(cntl.fanout_route == want_route,
              f"{method}: route {cntl.fanout_route!r}, meant to take "
              f"{want_route!r}")
        return cntl.fanout_result, (t1 - t0) / 1000.0

    def measure(pc, op, method, want_route, n, warm):
        lat = []
        for i in range(n + warm):
            _, us = call(pc, op, method, want_route)
            if i >= warm:
                lat.append(us)
        return {"p50_us": _pct(lat, 0.5), "p99_us": _pct(lat, 0.99),
                "calls": n, "routes": {want_route: n + warm}}

    def launches():
        return (p2p_copy.launches, plane.stats()["transfers"],
                sum(k.launches for k in ring_kernels))

    servers = {r: start(r) for r in ranks}
    # phase 12 stopped ici://6 and phase 11 ici://2: their breakers may
    # still isolate them until the health check's next probe; probe now,
    # so the per-member loop reaches the restarted servers
    from brpc_tpu_torch.rpc import health_check
    from brpc_tpu_torch.rpc.circuit_breaker import BreakerRegistry
    for r in ranks:
        ep = mesh.endpoint(r)
        if BreakerRegistry.instance().breaker(ep).is_isolated():
            check(health_check.start_health_check(ep).probe_now(),
                  f"ici://{r} did not revive on a probe")
    chans = []
    selected0 = route.collective_stats().get("collective_selected", 0)
    try:
        # (a) bench_collective_fanout's shape and its single-call
        # denominator
        pc_gather = mk_pc("gather", "uint8", (FANOUT_SHARD,))
        pc_none = mk_pc("none", "uint8", (FANOUT_SHARD,))
        op_host = np.arange(len(ranks) * FANOUT_SHARD,
                            dtype=np.uint8).reshape(len(ranks),
                                                    FANOUT_SHARD)
        op_dev = cf.shard_operand(ranks, torch.from_numpy(op_host), mesh=mesh)
        res, _ = call(pc_gather, op_dev, "Fan.Echo", "collective")
        check(torch.equal(res.cpu(), torch.from_numpy(op_host)),
              "the compiled gather differs from the operand")
        a = {"members": len(ranks), "shard_bytes": FANOUT_SHARD}
        a["collective"] = measure(pc_gather, op_dev, "Fan.Echo",
                                  "collective", FANOUT_COLL_ITERS, 10)
        a["collective_sharded"] = measure(pc_none, op_dev,
                                          "Fan.EchoSharded", "collective",
                                          FANOUT_COLL_ITERS, 10)
        flags.set_flag("ici_fanout_collective", False)
        try:
            res, _ = call(pc_gather, op_host, "Fan.Echo", "rpc")
            check(torch.equal(res.cpu(), torch.from_numpy(op_host)),
                  "the per-member loop's gather differs from the operand")
            a["fallback"] = measure(pc_gather, op_host, "Fan.Echo", "rpc",
                                    FANOUT_COLL_ITERS, 10)
        finally:
            flags.set_flag("ici_fanout_collective", True)
        ch = rpc.Channel()
        ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=30000,
                                                      max_retry=0))
        chans.append(ch)
        row = op_host[0].tobytes()
        lat = []
        for i in range(FANOUT_SINGLE_ITERS + 20):
            cntl = rpc.Controller()
            cntl.request_attachment.append(row)
            t0 = time.perf_counter_ns()
            ch.call_method("Fan.Echo", cntl, EchoRequest(message="s"),
                           EchoResponse)
            t1 = time.perf_counter_ns()
            check(not cntl.failed(), f"single echo: {cntl.error_text}")
            check(cntl.response_attachment.to_bytes() == row,
                  "single echo returned other bytes")
            if i >= 20:
                lat.append((t1 - t0) / 1000.0)
        a["single"] = {"p50_us": _pct(lat, 0.5), "p99_us": _pct(lat, 0.99),
                       "calls": FANOUT_SINGLE_ITERS}
        out["a"] = a

        # (b) 64 MiB of float32 in 8 shards of 8 MiB, compiled and
        # degraded; and a replicate-and-sum of a 64 MiB operand
        gen = torch.Generator(device=dev).manual_seed(1313)
        x = torch.randn(len(ranks), FANOUT_BYTES // 4 // len(ranks),
                        device=dev, generator=gen)
        x_rows = cf.shard_operand(ranks, x, mesh=mesh)
        rep = torch.randn(FANOUT_BYTES // 4, device=dev, generator=gen)
        b = {"bytes": FANOUT_BYTES, "shard": FANOUT_BYTES // len(ranks)}
        pc_scale = mk_pc("gather", "float32", (x.shape[1],))
        pc_sum = mk_pc("sum", "float32", None,
                       mapper=channels.ReplicateFanoutMapper())
        for name, pc, op, method in (("gather", pc_scale, x_rows,
                                      "Fan.Scale"),
                                     ("sum", pc_sum, rep, "Fan.Sum")):
            legs = {}
            for leg, route_name in (("compiled", "collective"),
                                    ("degraded", "rpc")):
                flags.set_flag("ici_fanout_collective", leg == "compiled")
                try:
                    l0, t0, r0 = launches()
                    first, _ = call(pc, op, method, route_name)
                    first = first.clone()
                    stats = measure(pc, op, method, route_name,
                                    FANOUT_BIG_ITERS, 0)
                    l1, t1, r1 = launches()
                finally:
                    flags.set_flag("ici_fanout_collective", True)
                stats["ms_p50"] = stats.pop("p50_us") / 1e3
                stats["ms_p99"] = stats.pop("p99_us") / 1e3
                stats["launches"] = l1 - l0
                stats["transfers"] = t1 - t0
                stats["ring_launches"] = r1 - r0
                legs[leg] = (first, stats)
            (c_res, c_st), (d_res, d_st) = legs["compiled"], legs["degraded"]
            if name == "gather":
                want = x * 2.0
                check(torch.equal(c_res, want), "compiled gather differs "
                                                "from the plain product")
                check(torch.equal(c_res, d_res), "compiled and degraded "
                                                 "gathers differ")
                err = 0.0
            else:
                want = rep * 0.5 * len(ranks)
                err = float((c_res - d_res).abs().max())
                check(torch.allclose(c_res, d_res, rtol=1e-6, atol=1e-6),
                      f"compiled and degraded sums differ by {err}")
                check(torch.allclose(c_res, want, rtol=1e-6, atol=1e-6),
                      "the compiled sum differs from the plain sum")
            check(c_st["launches"] == c_st["transfers"] == 0
                  and c_st["ring_launches"] == 0,
                  f"{name}: the compiled leg launched {c_st['launches']} "
                  f"p2p_copy and {c_st['ring_launches']} ring kernels")
            check(d_st["launches"] == d_st["transfers"] > 0
                  and d_st["ring_launches"] == 0,
                  f"{name}: the degraded leg launched {d_st['launches']} "
                  f"p2p_copy for {d_st['transfers']} plane transfers")
            b[name] = {"compiled": c_st, "degraded": d_st,
                       "max_abs_diff": err}
        out["b"] = b
        del x, x_rows, rep

        # (c) a member killed mid-fan-out, then its server restarted
        base = route.collective_stats()
        victim = 4
        plan = fi.FabricFaultPlan(collective_kill_device=victim)
        routes = []
        with fi.inject_fabric(plan):
            for _ in range(2):
                res, _ = call(pc_gather, op_dev, "Fan.Echo", "rpc")
                check(torch.equal(res.cpu(), torch.from_numpy(op_host)),
                      "a degraded call's result differs")
                routes.append("rpc")
        check(plan.injected["collective"] == 1,
              f"the kill fired {plan.injected['collective']} times")
        call(pc_gather, op_dev, "Fan.Echo", "rpc")   # still down
        routes.append("rpc")
        servers[victim].stop()
        servers[victim] = start(victim)
        res, _ = call(pc_gather, op_dev, "Fan.Echo", "collective")
        routes.append("collective")
        delta = {k: v - base.get(k, 0)
                 for k, v in route.collective_stats().items()
                 if v != base.get(k, 0)}
        seq = cf.CollectiveFanoutPlane.instance().sequencer.describe()
        check(delta.get("collective_degraded_member_killed") == 1
              and delta.get("collective_revived_member_killed") == 1,
              f"chaos counter deltas {delta}")
        check(seq["assigned"] == seq["executed"],
              f"sequencer {seq}: a slot did not retire")
        out["c"] = {"routes": routes, "delta": delta, "sequencer": seq,
                    "failed_calls": 0}
    finally:
        for ch in chans:
            ch.close()
        for s in servers.values():
            s.stop()
    torch.cuda.synchronize()
    out["selected"] = (route.collective_stats().get("collective_selected", 0)
                       - selected0)
    out["launches"] = sum(out["b"][k]["degraded"]["launches"]
                          for k in ("gather", "sum"))
    out["transfers"] = sum(out["b"][k]["degraded"]["transfers"]
                           for k in ("gather", "sum"))
    out["wall_s"] = time.monotonic() - t_phase
    a, b = out["a"], out["b"]
    print(f"collective fan-out: (a) {len(ranks)} members x {FANOUT_SHARD} B"
          f" compiled p50 {a['collective']['p50_us']:.1f} us, sharded "
          f"{a['collective_sharded']['p50_us']:.1f}, fallback "
          f"{a['fallback']['p50_us']:.1f}, single echo "
          f"{a['single']['p50_us']:.1f}; (b) 64 MiB gather "
          f"{b['gather']['compiled']['ms_p50']:.2f} ms compiled / "
          f"{b['gather']['degraded']['ms_p50']:.2f} degraded, sum "
          f"{b['sum']['compiled']['ms_p50']:.2f} / "
          f"{b['sum']['degraded']['ms_p50']:.2f}, degraded launches = "
          f"transfers = {out['launches']}; (c) routes {out['c']['routes']};"
          f" phase {out['wall_s']:.1f} s", flush=True)
    return out


def phase_rpcz(mesh, plane, p2p_copy) -> dict:
    """rpcz, the tpu_std stages and the builtin pages (see the module
    docstring, phase 14)."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.ici import route
    from brpc_tpu_torch.policy import tpu_std
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.ici.transport import ici_transport_stats
    from brpc_tpu_torch.rpc import profiler, span
    from brpc_tpu_torch.rpc.builtin.rpc_service import JsonMsg

    t_phase = time.monotonic()

    class Sink(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Push(self, cntl, request, response, done):
            response.message = str(len(cntl.request_attachment))
            done()

    threshold = flags.get_flag("ici_device_plane_threshold")
    flags.set_flag("ici_device_plane_threshold", 1)
    # the Python plane: the server span, the five stages and the transfer
    # span under the client span are its measurements (the native door
    # carries none of them, as the reference's does not)
    server = rpc.Server(rpc.ServerOptions(usercode_inline=True,
                                          native_ici=False))
    server.add_service(Sink())
    check(server.start("ici://0") == 0, "server start on ici://0")
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=30000,
                                                  max_retry=0))
    _, payload = make_payload(mesh, 4096, 1, seed=14)
    modes = {"off": (False, "sampled"), "rpcz": (True, "sampled"),
             "rpcz_stages": (True, "on")}

    def push():
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(payload)
        t0 = time.perf_counter_ns()
        resp = ch.call_method("Sink.Push", cntl, EchoRequest(message="d"),
                              EchoResponse)
        t1 = time.perf_counter_ns()
        check(not cntl.failed(), f"Sink.Push failed: {cntl.error_text}")
        check(resp.message == "4096", "server saw another attachment")
        return cntl, (t1 - t0) / 1000.0

    def set_mode(name):
        on, stages = modes[name]
        flags.set_flag("rpcz_enabled", on)
        flags.set_flag("tpu_std_stage_metrics", stages)

    out = {}
    l0, t0 = p2p_copy.launches, plane.stats()["transfers"]
    try:
        # the echo p50 three ways, in turns: off, on, on+stages, and back
        lat = {m: [] for m in modes}
        for name in list(modes) + list(reversed(modes)):
            set_mode(name)
            for i in range(RPCZ_CALLS + 10):
                _, us = push()
                if i >= 10:
                    lat[name].append(us)
        out["echo"] = {m: {"p50_us": _pct(v, 0.5), "p99_us": _pct(v, 0.99),
                           "calls": len(v)} for m, v in lat.items()}
        base = out["echo"]["off"]["p50_us"]
        out["echo"]["rpcz_cost"] = out["echo"]["rpcz"]["p50_us"] / base - 1
        out["echo"]["rpcz_stages_cost"] = \
            out["echo"]["rpcz_stages"]["p50_us"] / base - 1
        out["stage_p50s_us"] = tpu_std.stage_p50s_us()
        out["stage_counts"] = {s_: r.count() for s_, r in
                               tpu_std._stage_recorders.items()}
        check(all(n >= 2 * RPCZ_CALLS for n in out["stage_counts"].values()),
              f"stage recorders {out['stage_counts']}: the 'on' mode did "
              f"not record every request")

        # linked spans, on calls inside one sampling second
        set_mode("rpcz")
        time.sleep(1.05)
        checked = 0
        for _ in range(RPCZ_TRACED):
            cntl, _ = push()
            deadline = time.monotonic() + 5
            while True:
                spans = span.find_trace(cntl.trace_id)
                kinds = {s.kind for s in spans if s.end_us}
                if {"client", "server", "transfer"} <= kinds \
                        or time.monotonic() > deadline:
                    break
                time.sleep(0.002)
            client = [s for s in spans if s.kind == "client"]
            srv = [s for s in spans if s.kind == "server"]
            xfer = [s for s in spans if s.kind == "transfer"]
            check(cntl.trace_id and len(client) == 1 and len(srv) == 1,
                  f"trace {cntl.trace_id:x}: {sorted(kinds)}")
            check(srv[0].parent_span_id == client[0].span_id,
                  "the server span is not parented under the client span")
            check(xfer and all(x.parent_span_id == client[0].span_id
                               for x in xfer),
                  "no transfer span under the client span")
            ann = " | ".join(a for x in xfer for _, a in x.annotations)
            for word in ("posted", "recv enqueued", "matched", "complete"):
                check(word in ann, f"transfer annotations lack {word!r}")
            checked += 1
        out["traced_calls"] = checked
        out["example_trace"] = [s.describe() for s in spans]

        # the profiler on the same echo, rpcz off and on: the host time a
        # call's thread spends per function, and what rpcz adds to each
        prof = {}
        for name in ("off", "rpcz"):
            set_mode(name)
            time.sleep(1.05)              # a fresh sampling second
            _, prof[name] = profiler.profile_stats(
                lambda: [push() for _ in range(RPCZ_PROFILED)])
        added = []
        for key in set(prof["off"].stats) | set(prof["rpcz"].stats):
            tt = [prof[m].stats[key][2] if key in prof[m].stats else 0.0
                  for m in ("off", "rpcz")]
            added.append(((tt[1] - tt[0]) / RPCZ_PROFILED * 1e6,
                          f"{Path(key[0]).name}:{key[1]} {key[2]}"))
        added.sort(reverse=True)
        out["profile"] = {
            "calls": RPCZ_PROFILED,
            "total_us_per_call": {m: prof[m].total_tt / RPCZ_PROFILED * 1e6
                                  for m in prof},
            "rpcz_added_us_per_call": [(f, round(us, 2))
                                       for us, f in added[:10]]}
        # the card's trace around a few calls: torch.profiler sees the
        # copy kernel
        trace_dir = ROOT / "brpc_tpu_torch" / "_build" / "device_trace"
        set_mode("off")
        check(profiler.start_device_trace(str(trace_dir)),
              "torch.profiler did not start")
        for _ in range(4):
            push()
        torch.cuda.synchronize()
        check(profiler.stop_device_trace(), "the device trace was not kept")
        traces = sorted(trace_dir.glob("trace.*.json"))
        check(traces, "no device trace written")
        with open(traces[-1]) as f:
            kernels = [e for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"]
        out["profile"]["trace_kernels"] = sorted({e["name"] for e in kernels})
        check(any("copy_kernel" in e["name"] for e in kernels),
              f"the device trace shows no copy kernel: "
              f"{out['profile']['trace_kernels']}")
        for t in traces:
            t.unlink()

        # the builtin pages over ici://
        set_mode("off")
        pages = {}
        for page in ("vars", "status", "ici"):
            cntl = rpc.Controller()
            r = ch.call_method("brpc_tpu.Builtin.Call", cntl,
                               JsonMsg(page=page), JsonMsg)
            check(not cntl.failed() and r["status"] == 200,
                  f"Builtin.Call {page}: {cntl.error_text}")
            pages[page] = r["body"]
        stats = plane.stats()
        ici = json.loads(pages["ici"])
        status = json.loads(pages["status"])
        check({"server", "state", "methods", "services"} <= set(status),
              f"status keys {sorted(status)}")
        check("tpu_std_server_handler_count" in pages["vars"]
              and "process_pid" in pages["vars"], "vars lacks its keys")
        check(ici["device_plane"]["transfers"] == stats["transfers"],
              f"ici page transfers {ici['device_plane']['transfers']} != "
              f"plane {stats['transfers']}")
        # with rpcz off the page still keeps the last transfers' timelines,
        # and its byte totals count every device byte the plane moved
        recent = ici["device_plane_recent"]
        check(len(recent) == 64 and recent[-1]["state"] == "complete",
              f"the ici page kept {len(recent)} timelines with rpcz off")
        check(ici["transport"]["device_bytes_moved"]
              == ici_transport_stats()[1] >= stats["bytes_sent"],
              f"ici page device bytes {ici['transport']} against the "
              f"plane's {stats['bytes_sent']}")
        sel = ici["collective_route_events"]["collective_selected"]
        check(sel == route.collective_stats()["collective_selected"],
              "ici page's selected count differs from the route counters")
        out["pages"] = {"vars_lines": len(pages["vars"].splitlines()),
                        "status_keys": sorted(status),
                        "ici_keys": sorted(ici),
                        "ici_device_plane": ici["device_plane"],
                        "ici_selected": sel,
                        "ici_collective_fanout": ici["collective_fanout"]}
    finally:
        flags.set_flag("rpcz_enabled", False)
        flags.set_flag("tpu_std_stage_metrics", "sampled")
        flags.set_flag("ici_device_plane_threshold", threshold)
        ch.close()
        server.stop()
    torch.cuda.synchronize()
    out["launches"] = p2p_copy.launches - l0
    out["transfers"] = plane.stats()["transfers"] - t0
    out["wall_s"] = time.monotonic() - t_phase
    e = out["echo"]
    print(f"rpcz: profiler, host us per call on the caller's thread "
          f"{json.dumps(out['profile']['total_us_per_call'])}; rpcz adds "
          f"most to {json.dumps(out['profile']['rpcz_added_us_per_call'])}; "
          f"device trace kernels {out['profile']['trace_kernels']}",
          flush=True)
    print(f"rpcz: echo p50 off {e['off']['p50_us']:.1f} us, rpcz on "
          f"{e['rpcz']['p50_us']:.1f} ({e['rpcz_cost'] * 100:+.1f} %), "
          f"with stages {e['rpcz_stages']['p50_us']:.1f} "
          f"({e['rpcz_stages_cost'] * 100:+.1f} %); stage p50s "
          f"{json.dumps(out['stage_p50s_us'])}; {out['traced_calls']} "
          f"traced calls linked; pages vars/status/ici OK; phase "
          f"{out['wall_s']:.1f} s", flush=True)
    return out


def phase_call_features(mesh, plane, p2p_copy) -> dict:
    """The client's call features with 4 MiB DEVICE attachments owned by
    rank 1 (see the module docstring, phase 15).  Every path gates
    p2p_copy's launches against the plane's transfers, the device memory
    against its level, and an empty active set."""
    import shutil
    import tempfile
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.butil.endpoint import parse_endpoint
    from brpc_tpu_torch.proto import rpc_meta_pb2 as meta_pb
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc import errors
    from brpc_tpu_torch.rpc import fault_injection as fi
    from brpc_tpu_torch.rpc import rpc_dump
    from brpc_tpu_torch.rpc.socket_map import SocketMap
    from brpc_tpu_torch.tools import rpc_replay

    t_phase = time.monotonic()
    dev = mesh.device(0)
    payload = mesh.own(torch.from_numpy(np.random.default_rng(15).integers(
        0, 256, CF_PAYLOAD, dtype=np.uint8)).to(dev), 1)
    payload_bytes = payload.cpu().numpy().tobytes()
    lock = threading.Lock()
    events = {}

    class Echo(rpc.Service):
        """Echoes message and attachment; "hedge:k" stalls the first try
        of call k, "stall:k" every try, "slow:k" sleeps longer after
        saying it entered."""
        SERVICE_NAME = "EchoService"

        def __init__(self):
            self.seen = set()
            self.counts = {}

        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            kind, _, key = request.message.partition(":")
            with lock:
                first = request.message not in self.seen
                self.seen.add(request.message)
                self.counts[kind] = self.counts.get(kind, 0) + 1
            if (kind == "hedge" and first) or kind == "stall":
                time.sleep(CF_STALL_MS / 1000.0)
            elif kind == "slow":
                events[key].set()
                time.sleep(CF_CANCEL_SLEEP_MS / 1000.0)
            response.message = request.message
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    def start(addr):
        svc = Echo()
        server = rpc.Server(rpc.ServerOptions(
            usercode_in_pthread=True, usercode_backup_threads=CF_CANCELS + 4))
        server.add_service(svc)
        check(server.start(addr) == 0, f"call-features server on {addr}")
        return server, svc

    def channel(addr, **kw):
        ch = rpc.Channel()
        ch.init(addr, options=rpc.ChannelOptions(**kw))
        return ch

    def echo(ch, msg, cntl=None):
        cntl = cntl or rpc.Controller()
        cntl.request_attachment.append_device_array(payload)
        t0 = time.perf_counter_ns()
        resp = ch.call_method("EchoService.Echo", cntl,
                              EchoRequest(message=msg), EchoResponse)
        us = (time.perf_counter_ns() - t0) / 1000.0
        check(not cntl.failed(), f"{msg}: {cntl.error_text}")
        check(resp.message == msg, f"{msg}: answered {resp.message!r}")
        check(torch.equal(_tensor_of(cntl.response_attachment), payload),
              f"{msg}: the attachment came back changed")
        return cntl, us

    def settle():
        deadline = time.monotonic() + 10
        while plane.active_transfers() and time.monotonic() < deadline:
            time.sleep(0.002)
        torch.cuda.synchronize()
        gc.collect()

    out = {}

    def path(name, fn):
        settle()
        mem0 = torch.cuda.memory_allocated(dev)
        l0, t0 = p2p_copy.launches, plane.stats()["transfers"]
        res = fn()
        settle()
        res["launches"] = p2p_copy.launches - l0
        res["transfers"] = plane.stats()["transfers"] - t0
        res["memory_delta_bytes"] = torch.cuda.memory_allocated(dev) - mem0
        check(res["launches"] == res["transfers"] > 0,
              f"{name}: p2p_copy launched {res['launches']} times for "
              f"{res['transfers']} plane transfers")
        check(abs(res["memory_delta_bytes"]) <= CF_MEMORY_SLACK,
              f"{name}: device memory {res['memory_delta_bytes']} B off "
              f"its level")
        check(not plane._active and not plane._pending,
              f"{name}: {len(plane._active)} transfers still active")
        out[name] = res

    server, svc = start("ici://3")
    server4, _ = start("ici://4")
    plain = channel("ici://3", timeout_ms=10000, max_retry=0)
    build = ROOT / "brpc_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="rpc_dump.", dir=str(build))
    try:
        def hedging():
            hedged = channel("ici://3", timeout_ms=10000, max_retry=1,
                             backup_request_ms=CF_BACKUP_MS)
            lat = {"plain": [], "unhedged": [], "hedged": []}
            backups = 0
            for i in range(CF_HEDGED // 2):
                lat["plain"].append(echo(plain, f"plain:{i}")[1])
            for i in range(CF_HEDGED // 4):
                lat["unhedged"].append(echo(plain, f"stall:{i}")[1])
            for i in range(CF_HEDGED):
                cntl, us = echo(hedged, f"hedge:{i}")
                lat["hedged"].append(us)
                backups += cntl.retried_count
            # the stalled first tries answer late, and are dropped
            time.sleep(2 * CF_STALL_MS / 1000.0)
            hedged.close()
            check(svc.counts.get("hedge") == 2 * CF_HEDGED,
                  f"{svc.counts.get('hedge')} hedged tries reached the "
                  f"server for {CF_HEDGED} calls")
            return {"p50_us": {k: _pct(v, 0.5) for k, v in lat.items()},
                    "calls": {k: len(v) for k, v in lat.items()},
                    "backup_share": backups / CF_HEDGED,
                    "stall_ms": CF_STALL_MS, "backup_ms": CF_BACKUP_MS}

        def cancelling():
            ch = channel("ici://3", timeout_ms=10000, max_retry=0)
            cntls, ended, cancel_at, cb_at = [], [], [], [0.0] * CF_CANCELS
            for i in range(CF_CANCELS):
                events[str(i)] = threading.Event()
                ev = threading.Event()

                def cb(c, i=i, ev=ev):
                    cb_at[i] = time.perf_counter()
                    ev.set()
                cntl = rpc.Controller()
                cntl.request_attachment.append_device_array(payload)
                ch.call_method("EchoService.Echo", cntl,
                               EchoRequest(message=f"slow:{i}"),
                               EchoResponse, cb)
                cntls.append(cntl)
                ended.append(ev)
            for i in range(CF_CANCELS):
                # the attachment crossed: the handler runs
                check(events[str(i)].wait(10), f"slow:{i} never entered")
            for cntl in cntls:
                cancel_at.append(time.perf_counter())
                cntl.cancel()
            for ev in ended:
                check(ev.wait(10), "a cancelled call never ended")
            codes = sorted({c.error_code for c in cntls})
            check(codes == [errors.ECANCELED],
                  f"cancelled calls ended with {codes}")
            time.sleep(1.5 * CF_CANCEL_SLEEP_MS / 1000.0)
            check(all(c.response is None
                      and c._peek_response_attachment() is None
                      for c in cntls), "a late answer reached a cancelled "
                                       "call")
            ch.close()
            us = [(b - a) * 1e6 for a, b in zip(cancel_at, cb_at)]
            return {"calls": CF_CANCELS, "cancel_to_callback_us": {
                "p50": _pct(us, 0.5), "max": max(us)}}

        def dropping():
            passed = [0]

            class Counting(fi.FaultInjector):
                def decide(self, socket):
                    d = super().decide(socket)
                    if d == fi.PASS:
                        with lock:
                            passed[0] += 1
                    return d

            ch = channel("ici://3", timeout_ms=CF_DROP_TIMEOUT_MS,
                         max_retry=CF_DROP_TRIES - 1, retry_on_timeout=True)
            tries = 0
            with fi.inject(Counting(drop_ratio=CF_DROP_RATIO,
                                    seed=CF_DROP_SEED)) as inj:
                for i in range(CF_DROP_CALLS):
                    cntl, _ = echo(ch, f"drop:{i}")
                    tries += cntl.retried_count + 1
                settle()
            ch.close()
            check(inj.injected["drop"] > 0, "no write was dropped")
            return {"calls": CF_DROP_CALLS, "tries": tries,
                    "dropped_writes": inj.injected["drop"],
                    "passed_writes": passed[0]}

        def connections():
            ep = parse_endpoint("ici://4")
            smap = SocketMap.instance()
            pooled = channel("ici://4", timeout_ms=10000,
                             connection_type="pooled")
            for i in range(CF_CONN_CALLS):
                echo(pooled, f"pooled:{i}")
            after_pooled = (smap.stats().get(ep, 0),
                            len(server4.connections()))
            short = channel("ici://4", timeout_ms=10000,
                            connection_type="short")
            for i in range(CF_CONN_CALLS):
                echo(short, f"short:{i}")
            deadline = time.monotonic() + 2
            while len(server4.connections()) > 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.005)
            after_short = (smap.stats().get(ep, 0),
                           len(server4.connections()))
            pooled.close()
            short.close()
            check(after_pooled == (1, 1),
                  f"pooled calls hold {after_pooled} (map, server) "
                  f"connections, not one reused")
            check(after_short == (1, 1),
                  f"short calls left {after_short} connections open")
            return {"calls": CF_CONN_CALLS, "pooled_held": after_pooled,
                    "after_short": after_short}

        def dumping():
            first, again = f"{tmp}/first", f"{tmp}/replayed"
            flags.set_flag("rpc_dump_dir", first)
            flags.set_flag("rpc_dump", True)
            answers = []
            for i in range(CF_DUMP_CALLS):
                cntl, _ = echo(plain, f"dump:{i}")
                answers.append((0, EchoResponse(
                    message=f"dump:{i}").SerializeToString(),
                    payload_bytes))
            flags.set_flag("rpc_dump", False)
            files = rpc_dump.list_dump_files(first)
            dumped = [f for p in files for f in rpc_dump.load_dumped_frames(p)]
            check(len(dumped) == CF_DUMP_CALLS,
                  f"{len(dumped)} frames dumped for {CF_DUMP_CALLS} calls")
            fresh, _ = start("ici://5")
            try:
                flags.set_flag("rpc_dump_dir", again)
                flags.set_flag("rpc_dump", True)
                result = rpc_replay.run_replay("ici://5", first, out=sys.stderr,
                                               collect=True)
                flags.set_flag("rpc_dump", False)
            finally:
                flags.set_flag("rpc_dump", False)
                fresh.stop()
            check(result["sent"] == result["ok"] == CF_DUMP_CALLS,
                  f"replay: {result['ok']} of {result['sent']} answered")
            check(result["responses"] == answers,
                  "the replay's answers differ from the calls'")
            replayed = [f for p in rpc_dump.list_dump_files(again)
                        for f in rpc_dump.load_dumped_frames(p)]

            def strip(fr):
                size = int.from_bytes(fr[4:8], "big")
                meta = meta_pb.RpcMeta()
                meta.ParseFromString(fr[12:12 + size])
                meta.correlation_id = 0
                meta.request.ClearField("timeout_ms")
                meta.request.ClearField("deadline_left_ms")
                return meta.SerializeToString(), fr[12 + size:]

            check(sorted(map(strip, replayed)) == sorted(map(strip, dumped)),
                  "the replayed frames differ from the dumped ones")
            return {"calls": CF_DUMP_CALLS, "files": len(files),
                    "dump_bytes": sum(len(f) for f in dumped),
                    "replayed_frames": len(replayed)}

        for name, fn in (("hedging", hedging), ("cancel", cancelling),
                         ("drops", dropping), ("connections", connections),
                         ("dump", dumping)):
            path(name, fn)
        # each write that passed carried one attachment: a dropped one
        # posted nothing
        drops = out["drops"]
        check(drops["transfers"] == drops["passed_writes"],
              f"drops: {drops['transfers']} plane transfers for "
              f"{drops['passed_writes']} writes that passed (a dropped "
              f"frame posted a transfer)")
    finally:
        flags.set_flag("rpc_dump", False)
        plain.close()
        server.stop()
        server4.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = sum(r["launches"] for r in out.values()
                          if isinstance(r, dict))
    out["transfers"] = sum(r["transfers"] for r in out.values()
                           if isinstance(r, dict) and "transfers" in r)
    out["wall_s"] = time.monotonic() - t_phase
    h, c, d = out["hedging"], out["cancel"], out["drops"]
    print(f"call features: hedged p50 {h['p50_us']['hedged']:.1f} us "
          f"against unhedged {h['p50_us']['unhedged']:.1f} us with the "
          f"first try stalled {CF_STALL_MS} ms (plain echo "
          f"{h['p50_us']['plain']:.1f} us); backup tries' share "
          f"{h['backup_share']:.3f}; cancel to callback p50 "
          f"{c['cancel_to_callback_us']['p50']:.1f} us (max "
          f"{c['cancel_to_callback_us']['max']:.1f}); drops: "
          f"{d['calls']} calls in {d['tries']} tries, "
          f"{d['dropped_writes']} writes dropped, all answered; pooled "
          f"held {out['connections']['pooled_held']}, after short "
          f"{out['connections']['after_short']}; dump "
          f"{out['dump']['dump_bytes']} B in {out['dump']['files']} "
          f"file(s), replayed equal; launches = transfers "
          f"{ {k: out[k]['launches'] for k in ('hedging', 'cancel', 'drops', 'connections', 'dump')} }; "
          f"phase {out['wall_s']:.1f} s", flush=True)
    return out


def phase_native(mesh, plane, p2p_copy) -> dict:
    """The native front door (see the module docstring, phase 16 (a)-(d))."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.ici import native_plane
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse

    t_phase = time.monotonic()
    reg = native_plane.registry()
    threshold = flags.get_flag("ici_device_plane_threshold")
    flags.set_flag("ici_device_plane_threshold", 1)

    class Sink(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Push(self, cntl, request, response, done):
            response.message = str(len(cntl.request_attachment))
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    def counts():
        return (p2p_copy.launches, plane.stats()["transfers"],
                native_plane.relocation_stats()["plane"])

    def settle(live0):
        deadline = time.monotonic() + 10
        while (plane.active_transfers() or reg.live() != live0) \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        return plane.active_transfers(), reg.live() - live0

    out = {}
    l_start, t_start, _ = counts()
    live0 = reg.live()
    server = rpc.Server(rpc.ServerOptions(usercode_inline=True))
    server.add_service(Sink())
    check(server.start("ici://0") == 0, "native server start on ici://0")
    binding = server._native_ici
    check(binding is not None, "the native door did not open on ici://0")
    ch = rpc.Channel()
    ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=30000,
                                                  max_retry=0))
    try:
        # (a) the Sink echo: one crossing a call, the request's
        _, small = make_payload(mesh, 4096, 1, seed=16)
        c0, n0 = counts(), binding.requests()
        lat = []
        for i in range(NATIVE_CALLS + 20):
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(small)
            t0 = time.perf_counter_ns()
            resp = ch.call_method("Sink.Push", cntl, EchoRequest(message="d"),
                                  EchoResponse)
            t1 = time.perf_counter_ns()
            check(not cntl.failed(), f"native Sink.Push: {cntl.error_text}")
            check(resp.message == "4096", "the server saw other bytes")
            if i >= 20:
                lat.append((t1 - t0) / 1000.0)
        torch.cuda.synchronize()
        active, leaked = settle(live0)
        c1 = counts()
        sink = {"calls": NATIVE_CALLS + 20,
                "native_requests": binding.requests() - n0,
                "launches": c1[0] - c0[0], "transfers": c1[1] - c0[1],
                "relocations": c1[2] - c0[2],
                "p50_us": _pct(lat, 0.5), "p99_us": _pct(lat, 0.99),
                "active_after": active, "keys_left": leaked}
        out["sink"] = sink
        check(sink["native_requests"] == sink["calls"],
              f"native door: {sink['native_requests']} requests for "
              f"{sink['calls']} calls at 4 KiB")
        check(sink["launches"] == sink["transfers"] == sink["relocations"]
              == sink["calls"],
              f"native Sink: launches {sink['launches']}, transfers "
              f"{sink['transfers']}, relocations {sink['relocations']}, "
              f"calls {sink['calls']}")
        check(active == 0 and leaked == 0,
              f"after the Sink echo: {active} transfers active, {leaked} "
              f"device refs left in native custody")

        # (b) an Echo returning the attachment: two crossings a call
        c0, n0 = counts(), binding.requests()
        bad = 0
        for i in range(NATIVE_ECHO_CALLS):
            _, payload = make_payload(mesh, 4096, 1, seed=1600 + i)
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(payload)
            resp = ch.call_method("Sink.Echo", cntl,
                                  EchoRequest(message=f"e{i}"), EchoResponse)
            check(not cntl.failed(), f"native Sink.Echo: {cntl.error_text}")
            back = _tensor_of(cntl.response_attachment)
            bad += not (resp.message == f"e{i}"
                        and mesh.rank_of(back) == 1
                        and torch.equal(back, payload))
        torch.cuda.synchronize()
        active, leaked = settle(live0)
        c1 = counts()
        echo = {"calls": NATIVE_ECHO_CALLS,
                "native_requests": binding.requests() - n0,
                "launches": c1[0] - c0[0], "transfers": c1[1] - c0[1],
                "relocations": c1[2] - c0[2], "bad": bad}
        out["echo"] = echo
        check(bad == 0, f"{bad} native echoes came back unequal or off "
                        f"rank 1")
        check(echo["native_requests"] == NATIVE_ECHO_CALLS,
              f"native door: {echo['native_requests']} requests for "
              f"{NATIVE_ECHO_CALLS} echoes")
        check(echo["launches"] == echo["transfers"] == echo["relocations"]
              == 2 * NATIVE_ECHO_CALLS,
              f"native echo: launches {echo['launches']}, transfers "
              f"{echo['transfers']}, relocations {echo['relocations']} for "
              f"{NATIVE_ECHO_CALLS} calls")
        check(active == 0 and leaked == 0,
              f"after the native echo: {active} transfers active, {leaked} "
              f"device refs left")
    finally:
        ch.close()
        server.stop()

    # (c) a stop with native calls parked in their handler
    gate = threading.Event()
    entered = []

    class Park(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Park(self, cntl, request, response, done):
            entered.append(1)
            gate.wait(30)
            cntl.response_attachment.append(cntl.request_attachment)
            done()

    server = rpc.Server(rpc.ServerOptions(
        usercode_in_pthread=True, usercode_backup_threads=NATIVE_STOP_CALLS))
    server.add_service(Park())
    check(server.start("ici://2") == 0, "native server start on ici://2")
    ch = rpc.Channel()
    ch.init("ici://2", options=rpc.ChannelOptions(timeout_ms=30000,
                                                  max_retry=0))
    codes = []
    lock = threading.Lock()
    try:
        c0 = counts()
        ch._native_ici_binding(rpc.Controller())
        nch = ch._native_ici
        check(nch is not None, "no native binding to ici://2")
        parked = [make_payload(mesh, 64 << 10, 1, seed=1700 + i)[1]
                  for i in range(NATIVE_STOP_CALLS)]

        def one(i):
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(parked[i])
            # the binding directly: the stop is final (the channel would
            # re-route a dead connection's call once)
            nch.call("Park.Park", cntl, EchoRequest(message=str(i)),
                     EchoResponse)
            with lock:
                codes.append(cntl.error_code_)

        ts = [threading.Thread(target=one, args=(i,))
              for i in range(NATIVE_STOP_CALLS)]
        for t in ts:
            t.start()
        deadline = time.monotonic() + 10
        while len(entered) < NATIVE_STOP_CALLS \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        check(len(entered) == NATIVE_STOP_CALLS,
              f"{len(entered)} of {NATIVE_STOP_CALLS} calls parked")
        t_stop = time.perf_counter()
        server.stop()
        stop_ms = (time.perf_counter() - t_stop) * 1e3
        for t in ts:
            t.join(10)
        gate.set()
        server.join(10)
        torch.cuda.synchronize()
        active, leaked = settle(live0)
        c1 = counts()
        out["stop"] = {"calls": NATIVE_STOP_CALLS, "codes": sorted(codes),
                       "stop_ms": stop_ms, "launches": c1[0] - c0[0],
                       "transfers": c1[1] - c0[1],
                       "relocations": c1[2] - c0[2], "active_after": active,
                       "keys_left": leaked}
        check(codes == [rpc.errors.EFAILEDSOCKET] * NATIVE_STOP_CALLS,
              f"calls in flight through the stop ended {sorted(codes)}")
        check(active == 0 and leaked == 0,
              f"after the stop: {active} transfers active, {leaked} device "
              f"refs left in native custody")
        check(out["stop"]["launches"] == out["stop"]["transfers"]
              == out["stop"]["relocations"] >= NATIVE_STOP_CALLS,
              f"native stop: {json.dumps(out['stop'])}")
    finally:
        gate.set()
        ch.close()
        server.stop()
        flags.set_flag("ici_device_plane_threshold", threshold)

    # (d) the C++ echo loop: the whole native datapath with no Python
    host = native_plane.native_ici_echo_p50_us(NATIVE_LOOP_ITERS, 128)
    _, resident = make_payload(mesh, 4096, 3, seed=18)
    dev_ref = native_plane.native_ici_echo_p50_us(NATIVE_LOOP_ITERS, 128,
                                                  device_array=resident)
    check(host > 0 and dev_ref > 0,
          f"the C++ echo loop failed: {host} us, {dev_ref} us")
    out["cpp_loop_p50_us"] = {"host_128B": host,
                              "device_ref_4KiB_resident": dev_ref}
    out["launches"] = p2p_copy.launches - l_start
    out["transfers"] = plane.stats()["transfers"] - t_start
    out["keys_left"] = reg.live() - live0
    check(out["keys_left"] == 0, f"{out['keys_left']} device refs left")
    out["wall_s"] = time.monotonic() - t_phase
    print(f"native: Sink 4 KiB p50 {sink['p50_us']:.1f} us p99 "
          f"{sink['p99_us']:.1f} us over {sink['calls']} calls = "
          f"{sink['native_requests']} native requests, launches "
          f"{sink['launches']} = transfers = relocations; echo "
          f"{NATIVE_ECHO_CALLS} calls, {echo['launches']} launches; stop "
          f"with {NATIVE_STOP_CALLS} in flight: {out['stop']['stop_ms']:.1f}"
          f" ms, codes {sorted(set(codes))}; C++ loop p50 {host:.2f} us "
          f"(host frame), {dev_ref:.2f} us (resident device ref); phase "
          f"{out['wall_s']:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    import brpc_tpu_torch.policy  # noqa: F401  (registers tpu_std)
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.ici import device_plane
    from brpc_tpu_torch.ici import pallas_ring as pr
    from brpc_tpu_torch.ici.mesh import IciMesh
    from brpc_tpu_torch.ici.p2p_copy import p2p_copy, p2p_copy_plain
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {count}", flush=True)

    # full float32 for every matmul of the run (attention checks)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels_all = [p2p_copy, pr.ring_all_reduce_kernel,
                   pr.ring_all_gather_kernel]

    def zero_counts():
        for k in kernels_all:
            k.launches = 0

    # 1. build (the empty kernel is phase 2's floor), the native ici core
    # with g++ beside the nvcc builds
    from brpc_tpu_torch.butil import native as native_core
    core = {}

    def build_core():
        t0 = time.monotonic()
        try:
            core["path"] = str(native_core.build())
        except Exception as e:
            core["error"] = f"{type(e).__name__}: {e}"
        core["s"] = time.monotonic() - t0

    core_thread = threading.Thread(target=build_core)
    core_thread.start()
    empty = empty_kernel()
    builds = build_all(kernels_all + [empty])
    core_thread.join()
    check("error" not in core, f"native ici core build failed: "
                               f"{core.get('error')}")
    check(native_core.load() is not None,
          f"native ici core did not load: {native_core.load_error()}")
    builds["ici_native (g++)"] = core["s"]
    print("build: " + ", ".join(f"{k} {v:.2f} s" for k, v in builds.items()),
          flush=True)

    # 2. kernel vs plain version
    dev = torch.device("cuda", 0)
    rows = phase_kernel(p2p_copy, p2p_copy_plain, empty, dev)

    # 3-4. the main path: ici:// echo through the device plane
    mesh = IciMesh(ranks=8)
    check(mesh.device_type == "cuda", "default mesh is not on the card")
    IciMesh.set_default(mesh)
    plane = device_plane.plane()
    zero_counts()
    # both front doors in turns: the native door (the default) and the
    # Python plane
    doors = {"native": [], "python": []}
    echo_launches = 0
    for native in (True, False, False, True):
        door = "native" if native else "python"
        bench = phase_plane_echo(rpc, mesh, plane, p2p_copy, EchoRequest,
                                 EchoResponse, native=native)
        echo = phase_default_echo(rpc, mesh, plane, p2p_copy, EchoRequest,
                                  EchoResponse, native=native)
        doors[door].append({"plane_echo": bench, "default_echo": echo})
        echo_launches += bench["launches"] + echo["launches"]
        print(f"plane echo ({door} door): " + json.dumps(bench), flush=True)
        print(f"default-threshold echo ({door} door): " + json.dumps(echo),
              flush=True)
    for door, runs in doors.items():
        echoes = [r["plane_echo"] for r in runs]
        print(f"echo by door: {door}: 4 KiB p50 "
              f"{[round(e['p50_us_4k'], 1) for e in echoes]} us, p99 "
              f"{[round(e['p99_us_4k'], 1) for e in echoes]} us; 4 MiB "
              f"{[round(e['gbps_4m'], 3) for e in echoes]} GB/s (the "
              f"Python plane on both doors: over the native window)",
              flush=True)
    main_launches = p2p_copy.launches
    check(main_launches == echo_launches,
          "launch count moved outside the main path")
    check(main_launches > 0, "the main path never launched p2p_copy")
    print("plane stats: " + json.dumps(plane.stats()), flush=True)

    # 5. ring kernels vs their plain versions (not counted)
    t0 = time.monotonic()
    ring_rows = phase_ring_kernels(pr, dev)
    print(f"ring kernel phase: {time.monotonic() - t0:.1f} s", flush=True)

    # 6. the collectives path, with the counts zeroed just before it
    t0 = time.monotonic()
    zero_counts()
    coll = phase_collectives(mesh, dev)
    coll_launches = {k.name: k.launches for k in kernels_all}
    print(f"collectives phase: {time.monotonic() - t0:.1f} s; calls "
          f"{json.dumps(coll['calls'])}, launches "
          f"{json.dumps(coll_launches)}", flush=True)
    for name in ("ring_all_reduce", "ring_all_gather"):
        check(coll_launches[name] == coll["calls"][name] > 0,
              f"{name}: {coll_launches[name]} launches for "
              f"{coll['calls'][name]} calls on the collectives path")
    print("collectives: " + json.dumps(coll), flush=True)

    # 7. the card-only tests, in a process of their own
    phase_card_tests()

    # 8. the serving path, with the counts zeroed just before it
    zero_counts()
    serve = phase_serving(mesh, plane, p2p_copy)
    serve_launches = {k.name: k.launches for k in kernels_all}
    check(serve_launches["p2p_copy"] == serve["launches"] > 0,
          "the serving path never launched p2p_copy")
    print("serving: " + json.dumps(serve), flush=True)

    # 9. the host tier and live migration, with the counts zeroed just
    # before them
    zero_counts()
    tiers = phase_tiers_migration(mesh, plane, p2p_copy)
    tier_launches = {k.name: k.launches for k in kernels_all}
    check(tier_launches["p2p_copy"] == tiers["launches"] > 0,
          "the tiers and migration path never launched p2p_copy")
    check(tier_launches["ring_all_reduce"] == 0
          and tier_launches["ring_all_gather"] == 0,
          "a ring kernel launched on the tiers and migration path")
    print("tiers and migration: " + json.dumps(tiers), flush=True)

    # 10. admission, the lame-duck drain and the elastic fleet, each with
    # the counts zeroed just before it.  (a) and (b) move 4 MiB
    # attachments: the socket window is raised so a frame is never cut
    # across writes (a cut device block would ride as two transfers)
    from brpc_tpu_torch.butil import flags
    window = flags.get_flag("ici_socket_window_bytes")
    flags.set_flag("ici_socket_window_bytes", ADM_WINDOW_BYTES)
    flags.set_flag("ici_device_plane_threshold", 64 * 1024)
    paths = {}
    for name, phase in (("admission", phase_admission),
                        ("drain", phase_drain)):
        zero_counts()
        res = phase(mesh, plane, p2p_copy)
        paths[name] = ({k.name: k.launches for k in kernels_all}, res)
    flags.set_flag("ici_socket_window_bytes", window)
    zero_counts()
    res = phase_elastic(mesh, plane, p2p_copy)
    paths["elastic"] = ({k.name: k.launches for k in kernels_all}, res)
    for name, (launches, res) in paths.items():
        want = res["path_launches"] if name == "drain" else res["launches"]
        check(launches["p2p_copy"] == want > 0,
              f"the {name} path launched p2p_copy {launches['p2p_copy']} "
              f"times, its own count {want}")
        check(launches["ring_all_reduce"] == 0
              and launches["ring_all_gather"] == 0,
              f"a ring kernel launched on the {name} path")
    phase10 = {name: launches["p2p_copy"]
               for name, (launches, _) in paths.items()}
    print("admission, drain, elastic: " + json.dumps(
        {name: res for name, (_, res) in paths.items()}), flush=True)

    # 11-12. streaming and the host combo channels, each with the counts
    # zeroed just before it; the socket window is raised so a 4 MiB chunk
    # or an 8 MiB shard is one write (a cut device block would ride as two
    # transfers)
    flags.set_flag("ici_socket_window_bytes", ADM_WINDOW_BYTES)
    slice6 = {}
    for name, phase in (("stream", phase_streaming),
                        ("fanout", phase_fanout)):
        zero_counts()
        res = phase(mesh, plane, p2p_copy)
        launches = {k.name: k.launches for k in kernels_all}
        check(launches["p2p_copy"] == res["launches"] == res["transfers"]
              > 0, f"the {name} path launched p2p_copy "
                   f"{launches['p2p_copy']} times for {res['transfers']} "
                   f"plane transfers")
        check(launches["ring_all_reduce"] == 0
              and launches["ring_all_gather"] == 0,
              f"a ring kernel launched on the {name} path")
        slice6[name] = res
    print("streaming, fan-out: " + json.dumps(slice6), flush=True)

    # 13. the compiled collective fan-out (its 64 MiB degrade leg moves 8
    # MiB shards: the socket window stays raised), then 14. rpcz, the
    # stages and the builtin pages; each with the counts zeroed just
    # before it
    rings = [pr.ring_all_reduce_kernel, pr.ring_all_gather_kernel]
    slice7 = {}
    for name, phase in (("fanout_collective", lambda: phase_collective_fanout(
            mesh, plane, p2p_copy, rings)),
                        ("rpcz", lambda: phase_rpcz(mesh, plane, p2p_copy))):
        zero_counts()
        res = phase()
        launches = {k.name: k.launches for k in kernels_all}
        check(launches["p2p_copy"] == res["launches"] == res["transfers"]
              > 0, f"the {name} path launched p2p_copy "
                   f"{launches['p2p_copy']} times for {res['transfers']} "
                   f"plane transfers")
        check(launches["ring_all_reduce"] == 0
              and launches["ring_all_gather"] == 0,
              f"a ring kernel launched on the {name} path")
        slice7[name] = res

    # 15. the call features (backup requests, cancel, drops, connection
    # types, rpc_dump and rpc_replay), with the counts zeroed just before
    # them; 4 MiB attachments, the socket window still raised
    zero_counts()
    calls = phase_call_features(mesh, plane, p2p_copy)
    launches = {k.name: k.launches for k in kernels_all}
    check(launches["p2p_copy"] == calls["launches"] == calls["transfers"]
          > 0, f"the call-features path launched p2p_copy "
               f"{launches['p2p_copy']} times for {calls['transfers']} "
               f"plane transfers")
    check(launches["ring_all_reduce"] == 0
          and launches["ring_all_gather"] == 0,
          "a ring kernel launched on the call-features path")
    flags.set_flag("ici_socket_window_bytes", window)
    print("call features: " + json.dumps(calls), flush=True)

    # 16. the native front door, then phase 10's overload leg on it; each
    # with the counts zeroed just before it
    zero_counts()
    native = phase_native(mesh, plane, p2p_copy)
    launches = {k.name: k.launches for k in kernels_all}
    check(launches["p2p_copy"] == native["launches"] == native["transfers"]
          > 0, f"the native path launched p2p_copy {launches['p2p_copy']} "
               f"times for {native['transfers']} plane transfers")
    check(launches["ring_all_reduce"] == 0
          and launches["ring_all_gather"] == 0,
          "a ring kernel launched on the native path")
    flags.set_flag("ici_device_plane_threshold", 64 * 1024)
    zero_counts()
    native_adm = phase_admission(mesh, plane, p2p_copy,
                                 payload=NATIVE_ADM_PAYLOAD, door="native")
    launches = {k.name: k.launches for k in kernels_all}
    check(launches["p2p_copy"] == native_adm["launches"] > 0,
          f"the native overload path launched p2p_copy "
          f"{launches['p2p_copy']} times, its own count "
          f"{native_adm['launches']}")
    check(launches["ring_all_reduce"] == 0
          and launches["ring_all_gather"] == 0,
          "a ring kernel launched on the native overload path")
    native["overload"] = {k: native_adm[k] for k in (
        "hi_p99_unloaded_us", "hi_p99_overload_us", "hi_p99_ratio",
        "native_requests", "requests_received", "attachments_returned",
        "launches", "transfers", "shed", "offered_rps_measured",
        "payload_bytes", "stop_ms")}
    native["overload"]["python_door_ratio"] = \
        paths["admission"][1]["hi_p99_ratio"]
    print(f"native overload: priority-0 p99 ratio "
          f"{native_adm['hi_p99_ratio']:.3f} on the native door "
          f"({NATIVE_ADM_PAYLOAD} B attachments) against "
          f"{paths['admission'][1]['hi_p99_ratio']:.3f} on the Python plane "
          f"(phase 10, 4 MiB); bench.py bounds it at 2; printed, not "
          f"gated (PERF.md section 7)", flush=True)
    print("native: " + json.dumps(native), flush=True)
    check(slice7["rpcz"]["pages"]["ici_selected"]
          >= slice7["fanout_collective"]["selected"] > 0,
          "the ici page does not show phase 13's selected fan-outs")
    print("collective fan-out, rpcz: " + json.dumps(slice7), flush=True)

    head = next(r for r in rows if r["label"] == "4 MiB")
    red = ring_rows["ring_all_reduce"]
    gat = ring_rows["ring_all_gather"]
    small_err = max(max(c["all_reduce_err"], c["all_gather_err"])
                    for c in ring_rows["small"])
    kernels = {"kernels": [{
        "name": "p2p_copy",
        "route": "cuda",
        "source": "brpc_tpu_torch/csrc/p2p_copy.cu",
        "replaces": "brpc_tpu/ici/device_plane.py:428",
        "tpu_counterpart": "DevicePlane._pallas_body.kern "
                           "(brpc_tpu/ici/device_plane.py:395-444)",
        "launches": (main_launches + serve["launches"] + tiers["launches"]
                     + sum(phase10.values())
                     + sum(r["launches"] for r in slice6.values())
                     + sum(r["launches"] for r in slice7.values())
                     + calls["launches"] + native["launches"]
                     + native_adm["launches"]),
        "launches_by_path": {"echo": main_launches,
                             "serving": serve["launches"],
                             "migration": tiers["launches"], **phase10,
                             **{k: r["launches"]
                                for k, r in slice6.items()},
                             **{k: r["launches"]
                                for k, r in slice7.items()},
                             "call_features": calls["launches"],
                             "native": native["launches"],
                             "native_overload": native_adm["launches"]},
        "migration_path_split": {
            "migrate_in": tiers["migrate_in_calls"],
            "loadkv": tiers["calls_received"] - tiers["migrate_in_calls"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_abs_diff": max(r["max_abs_err"] for r in rows),
        "shape": f"{head['bytes']} B",
        "ms": head["ms"],
        "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": "bytes",
        "library_ms": head["library_ms"],
        "b2b_ms": head["b2b"]["ms"],
        "by_size": rows,
    }, {
        "name": "ring_all_reduce",
        "route": "cuda",
        "source": "brpc_tpu_torch/csrc/ring_all_reduce.cu",
        "replaces": "brpc_tpu/ici/pallas_ring.py:135",
        "tpu_counterpart": "_build_all_reduce.kernel "
                           "(brpc_tpu/ici/pallas_ring.py:107-132)",
        "launches": coll_launches["ring_all_reduce"],
        "max_abs_err": max([r["max_abs_err"] for r in red] + [small_err]),
        "shape": "8 x 2,097,152 float32 (64 MiB in all)",
        "ms": red[0]["ms"],
        "plain_ms": red[0]["plain_ms"],
        "bound_ms": red[0]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes the per-rank ring "
                        "fold; nearest_library_ms is torch.sum(x, 0), a "
                        "different function",
        "nearest_library_ms": red[0]["nearest_library_ms"],
        "by_size": red,
    }, {
        "name": "ring_all_gather",
        "route": "cuda",
        "source": "brpc_tpu_torch/csrc/ring_all_gather.cu",
        "replaces": "brpc_tpu/ici/pallas_ring.py:76",
        "tpu_counterpart": "_build_all_gather.kernel "
                           "(brpc_tpu/ici/pallas_ring.py:50-73)",
        "launches": coll_launches["ring_all_gather"],
        "max_abs_err": max([r["max_abs_err"] for r in gat] + [small_err]),
        "shape": "8 x 2,097,152 float32 in, 8 x (8, 2,097,152) out",
        "ms": gat[0]["ms"],
        "plain_ms": gat[0]["plain_ms"],
        "bound_ms": gat[0]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": gat[0]["library_ms"],
        "library_note": "out.copy_(x.unsqueeze(0).expand(n, n, chunk))",
        "by_size": gat,
        "small_checks": ring_rows["small"],
    }]}
    print(smi, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
