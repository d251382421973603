"""chip_smoke.py — build the port's kernels and drive its main path on one
NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device; exits non-zero (and prints no result) without one.
Phases, each fatal on failure:

  1. build      compile csrc/p2p_copy.cu, csrc/ring_all_reduce.cu,
                csrc/ring_all_gather.cu, csrc/cuda_ipc.cu (phase 17's IPC
                calls, no kernel) and an empty kernel with nvcc (sm_90a),
                one nvcc each, all started together, and load them; beside
                them g++ builds the native ici:// core (csrc/ici_native.cpp)
                with the TCP datapath (csrc/rpc_native.cpp, the same
                library) and the bulk conn and shm ring
                (csrc/fabric_native.cpp, both by butil/native.py) and
                they are loaded:
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
                10, queue_capacity 64), a 20 ms Echo (100 rps); 16 untimed
                warm-up calls on the connection both windows use
                (brpc_tpu_torch.tools.overload_clients), 1.2 s at 50
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
                MigrateIn received + dropped (relocations whose request
                no handler saw: a failed socket's unread frames and the
                lame duck's bounces, printed)

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
 17. fabric     two processes on the card: a peer started as a fresh
                interpreter (brpc_tpu_torch.tools.fabric_peer) owns ranks
                0-3 and serves ici://0 and a TCP port; this process hosts
                the fabric's store and owns ranks 4-7; threshold 4 KiB,
                window 64 MiB.  (a) 300 Sink.Push echoes at 4 KiB and 64 at
                4 MiB over ici://0 from rank 4, each payload written by a
                kernel just before its call and compared on the card with
                what came back; p50/p99; in each process p2p_copy launches
                = cross-process transfers received = attachments received
                (the peer reports its counts over RPC), and IPC opens
                against mapping-cache hits; (b) 300 TCP echoes of 4 KiB
                (a DEVICE attachment as host bytes), bench_streaming_mbps's
                tcp leg for 1 s, the peer's idle reap (idle_timeout_s=1)
                and its internal port refusing tpu_std; (e) phase 10's
                overload leg (brpc_tpu_torch.tools.overload_clients) with
                its 12 paced clients (and the unloaded one) in the peer,
                after 16 untimed warm-up calls on the connection both
                windows use, and phase 10's server on ici://5 here: the
                priority-0 p99 ratio against bench.py's bound of 2
                (pass_p99_bound) and the offered rps are printed, not
                gated (the ratio missed 2 against the warm baseline);
                (c) the peer
                is killed with 8 calls in flight: each
                fails with the JAX package's code, nothing stays active,
                mapped or in /dev/shm (this run's processes' segments),
                and a restarted peer serves again once the health check
                revives it; (d) the peer stops with 8 calls in flight:
                GOODBYE reaches this side, the calls drain, nothing is
                active or mapped on either side; (f) a third peer whose
                open of the CUDA IPC mapping refuses (a fake): a 4 MiB
                DEVICE payload's call fails EINTERNAL with the reason, the
                next fails at once on the latched plane, the peer saw no
                attachment and launched no copy, fewer than 4 MiB rode
                inline, nothing is active or mapped.  Over the
                phase, p2p_copy launches = cross-process transfers received
 18. pod        member processes started together as fresh interpreters
                (brpc_tpu_torch.tools.pod_peer), each on the same 8-rank
                mesh owning ranks 2p and 2p+1 and serving ici://2p on the
                Python plane, all joined to one pod.  (a) the JAX
                package's bench_pod_prefill_decode shape over 3 processes:
                the router (p0, the store's host) on ici://0, the prefill
                (p1) on ici://2, the decode (p2) on ici://4; 2 warm-ups,
                then 20 Router.Generate of 512 tokens x 64 steps from 2
                client threads, each equal to reference_generate; the
                handoff bytes equal 22 x kv_nbytes(512) (512 KiB, over the
                64 KiB threshold); in the decode process p2p_copy launches
                = kind-4 transfers received = LoadKv attachments, IPC opens
                against hits printed; tokens/s and the handoff GB/s over
                the timed prompts' LoadKv round trips.  (b) rpcz turned on
                in the three processes over brpc_tpu.Builtin.Call (the
                flags page), one Generate, and one /rpcz?trace_id= on p0:
                one tree holding the eight client and server spans of the
                three processes, the transfer pair under the LoadKv client
                span, one client root, every child within the summed clock
                bounds of its parent (tests/test_observability.py:520-590's
                checks); each peer's clock_bound_us printed;
                /vars?scope=pod and /brpc_metrics?scope=pod list processes
                0-2.  (c) the decode drains (stop, grace 1 s) and
                restarts: pod://pd drops ici://4 and lists it again, one
                more Generate answers on its one try (no retry), every
                member reads epoch 9.  Then
                tests/test_pod.py's membership contract over 4 processes,
                each serving an Echo that returns a 64 KiB DEVICE
                attachment (it crosses on p2p_copy both ways): every
                process calls through an rr channel on pod://chaos; p2's
                endpoint is killed (listener gone, its server-side
                connections cut, no drain, no withdraw) and revived, p3
                drains (stop, grace 5 s) and restarts; no call fails, the
                pre-kill socket id stops resolving, every process reads
                epoch 12; the ms from p3's drain mark until no process's
                pod:// lists ici://6 is printed.  Every member ends with
                nothing active, mapped or in /dev/shm
 19. fanout_xproc  the compiled fan-out's cross-process leg over the pod:
                four member processes (tools/pod_peer.py fanout), process p
                owning and serving ici://2p and 2p+1 with a Fan service
                whose wire bodies are its registered device bodies, process
                0 the client.  (a) bench.py's shape, 8 x 512 float32,
                MAP_SHARD/MERGE_GATHER over ranks 0-7: 80 calls on the
                cross-process leg in turns with 80 on the per-member loop
                (ici_fanout_collective off) on the same members, every
                route as meant, every result equal byte for byte to the
                first (= op x 2), no degrade counter moving; p50/p99 of
                both beside phase 13's in-process compiled p50; (b) 64 MiB
                in 8 shards gathered, and a 64 MiB operand replicated and
                summed, 10 calls each on the leg and 10 degraded, bit-exact;
                (c) chaos: FabricFaultPlan(collective_kill_device=4) in the
                client (every call degrades, member_killed, none fails; the
                route stays down with the plan cleared and returns once
                process 2 restarts ici://4-5 and the epoch moves); one
                announce black-holed with ici_fanout_xproc_timeout_s = 2
                (the call degrades announce_refused within it, none fails,
                the two members that accepted count member_entry_expired);
                process 1 SIGKILLed by its own body after accepting and
                before its result (the call returns within the timeout plus
                its sub-calls' 3 s deadline, the survivors go on, and after
                Pod.evict the next fan-out over ranks 0-7 screens
                member_down while one over the survivors' ranks takes the
                leg); (d) every survivor ends with nothing active, mapped,
                parked, held or in /dev/shm, and no module of JAX loaded.
                The launch count: on the leg a member pulls its two ranks'
                scatter rows per call (the replicated operand once per
                rank), and the client pulls one result per remote rank, 6
                per gather or sum call; so after (a)-(b) a member's
                rows pulled = 2 x the leg's calls and the client's = 6 x
                them, and in every process p2p_copy launches = the rows it
                pulled on the leg + the copies of the per-member loop
                (kind-4 pulls and in-process transfers).  Its IPC opens
                against cache hits are printed
 20. tiers      the fabric's same-host tiers (the bulk conn and the shm
                ring, csrc/fabric_native.cpp) between two processes on the
                card: a member process (a fresh interpreter, process 0,
                ranks 4-7) starts a fabric_peer (process 1, ranks 0-3,
                ici://0) and drives, with the device-plane threshold at
                64 KiB:
                (a) bench_fabric_gbps's leg (bench.py:1424-1488): 8 MiB
                host attachments, 12 calls a pass at async depth 8 to a
                one-way sink, best of 3, three ways: auto (one 160 MiB
                ring), uds (ici_fabric_shm off: the bulk conn) and
                shm_striped (4 stripes of 48 MiB); GB/s, and the route by
                the counters (every byte on the ring or every byte on the
                bulk conn, and on 4 stripes for the striped leg);
                (b) bench_fabric_streaming_mbps's leg (:1490-1532): 160
                chunks of 256 KiB a pass, best of 3, every chunk checked by
                the peer, auto and uds; MB/s and the route;
                (c) 8 frames each carrying a 4 MiB DEVICE attachment
                (kind 4, pulled on p2p_copy), a 4 MiB host attachment
                (kind 6) and a 4 KiB DEVICE one below the threshold (kind
                5), echoed: every byte equal; in each process p2p_copy
                launches = kind-4 transfers received = the 8 DEVICE
                attachments at or above the threshold; the ring carried
                exactly the host and sub-threshold bytes, the bulk conn
                none;
                (d) faults, every call answered: the ring killed
                mid-transfer (chaos_plane KILL) and killed at its attach
                (shm_kill_now): frames fall to the bulk conn in the same
                frame and the prober revives the ring (seconds printed);
                the peer refusing the ring (refuse_shm_handshakes=1): the
                bulk conn carries everything; a bulk sever mid-stream
                (bulk_sever_after_bytes): that stream fails, the socket
                lives and a new stream runs on the revived conn;
                plane_slow_ms={"shm": 20}: nothing degrades;
                (e) no segment this run made is left in /dev/shm, and
                nothing is mapped or active in either process
 21. native TCP, kind 1, KV routes
                (a) the native TCP datapath (csrc/rpc_native.cpp, host
                only) with bench.py's arguments (bench.py:3112-3137): the
                full-stack echo p50 (5,000 calls of 4 KiB), the raw epoll
                echo p50, QPS (16 threads, 1.5 s, 128 B), the best GB/s
                of 1 MiB calls on 1, 1 and 2 threads, pooled (2
                connections, 2 threads) and async (depth 4, 256 KiB);
                then a tcp:// rpc.Channel to a NativeServer's Python
                service and a NativeChannel to an rpc.Server (64 calls
                each, counted by the server), 32 call_method_async
                futures each of whose done runs once, and a
                NativeServer.stop() with 8 calls in flight (codes
                printed, none 0);
                (b) kind 1, the unsequenced transfer pull, between a
                member process (process 0, ranks 4-7) and a fabric_peer
                (process 1, ranks 0-3, ici://0), with the shm ring, the
                bulk conn and the device plane off for the pair: 200
                echoes at 4 KiB (below the 64 KiB threshold) and at 64
                KiB, 16 at 4 MiB (at and above it), each compared on the
                card, p50/p99 printed beside phase 17's kind-4 p50; in
                each process p2p_copy launches = kind-1 rows pulled =
                DEVICE attachments received, no kind-4 transfer, nothing
                left in _staged; xfer_refuse_stages=2 with a re-probe
                window between calls: 0 failed calls, exactly 2 stages
                refused and their payloads inline;
                (c) the KV loader's routes: on the native ici:// door in
                this process a LoadKv whose parked handle is taken
                through take_segments (scattered) and one with
                serving_kv_adopt off (materialized, three passes), the
                device-ref registry and the attachment table 0 after;
                then tests/test_serving.py's two-process shape: 4 LoadKv
                sessions of 512 tokens as host bytes on the shm ring,
                adopted into the decode process's pool on the card, and
                one DEVICE session (kind 4, scattered): materialized 0,
                copy bytes = (adopted + scattered) x payload, every
                decode equal to reference_generate
 22. remote naming, the plane-frame trace, the relocation
                a registry on 127.0.0.1 in this process
                (tools/fake_registry.py) answers the five remote APIs:
                (a) remotefile:// naming ici://4-7, four servers on the
                default door, an rr Channel: 200 calls, each with a 64
                KiB DEVICE attachment owned by rank 1 (one relocation on
                p2p_copy a call): launches = transfers = calls received
                over the four, 50 +- 10 on each, p50/p99 printed; then
                the registry withdraws ici://7 while calls go on: the ms
                until the balancer drops it printed (under 10 polling
                periods), no call reaches it after, 0 failed calls;
                (b) consul:// in Consul's health form over four TCP
                servers: 4 KiB DEVICE echoes (one D2H copy each, no
                launch), then an index bump for a withdrawal and one for
                the re-add under traffic: the ms from each bump to the
                watcher's reset printed (under one polling period), 0
                failed calls; the naming thread's stop ms printed;
                (c) nacos:// (unhealthy and disabled hosts dropped,
                weight x 100, clusterName as tag), discovery:// (status
                1 only, zone as tag) and dns://localhost:<port> each
                resolve to the expected list and serve 16 echoes;
                (d) in a member process (ranks 4-7) and a fabric_peer
                --threshold 65536 (ranks 0-3), rpc_dump on in both: a
                256 KiB host echo, then the bulk conn severed and the
                ring killed on that socket (chaos_plane KILL, each
                landed on this end before the next echo): in each
                process's fabric_planes.trace DOWN (empty) and
                REESTABLISH ({"bulk_key"} / {"shm_seg"}) from the member,
                one empty OK from the peer, 8 < 9 < 10 and 17 < 18 < 19,
                nothing for the healthy echo, 0 failed calls;
                (e) DEVICE payloads above the device-plane threshold on
                a one-stripe 32 MiB ring (kind 5, delivered
                host-resident: rank_of -1) at two sizes: 4 MiB - 128 KiB
                (the largest the native door's window takes) and 8 MiB
                (over it); the first of each forwarded into a call on
                the peer's native door (relocated by the door, device_put
                +1 and no plane relocation; the 8 MiB one by the Python
                plane's transport, the door's counts unmoved), then
                enough later ones to go round the ring, one landing over
                the first's bytes; the callee's copy equals the first
                payload's SHA-256
  23. dryrun, HTTP and gRPC
                (a) python -m brpc_tpu_torch.graft_entry in a fresh
                interpreter, as the reference's dryrun runs: entry()'s
                fabric step on the card (8 ranks of (4096,) float32)
                against its float64 formula (rtol 1e-5), then
                dryrun_multichip(8) on cuda:0,
                each leg's wall time and launches printed: the step, the
                rpc stack (its 64 KiB device-plane echo launches p2p_copy
                once per plane transfer), the 4-member compiled fan-out
                against the per-member loop, the native door against the
                Python plane, the decode workers (batched, prefix-shared,
                migrated), the two-process fabric (stress, a verified
                stream, one shm ring and four stripes; a child process and
                a fabric_peer) and the N=4 pod (pod_peer members);
                (b) one TCP server on 127.0.0.1:0 with an internal port:
                200 HTTP JSON-RPC echoes through the port's HTTP client
                (p50/p99 us); /health, /vars and /status 200 on the
                internal port and 403 on the public one; 200 gRPC unary
                echoes of 4 KiB and 16 of 1 MiB (across the 64 KiB
                flow-control window; p50/p99 us); a call with a 1 ms
                budget fails ERPCTIMEDOUT (DEADLINE_EXCEEDED) and a raw
                h2 request with grpc-timeout 1m gets grpc-status 4; gzip
                bodies with an HMAC credential on tpu_std and gRPC (the
                wrong key fails ERPCAUTH); a stop with 8 gRPC calls in
                flight: the client reads the GOAWAY, every call ends
                within 5 s with a retryable code; /health 503 on the
                internal port during a stop(2 s) that a held call keeps
                draining;
                (c) tests/fixtures/h2_curl_c2s.bin (curl's request bytes)
                replayed into the port's TCP server: stream 1, POST
                /Echo/Echo with a JSON body {"message": "from-curl"},
                answered 200 with h2_curl_s2c.bin's body
 24. the KV flags, the storage and Baidu-legacy protocols
                (a) the KV pool's three A/B flags on card arenas, at
                bench_serving_kv_prefix's shapes: two 192-token system
                prompts with unique 16-token tails in 16-token blocks, 64
                blocks, loaded pinned to saturation with
                serving_kv_prefix_share on and then off, every resident
                session byte-checked, the capacity ratio printed (at
                least 5x); a fill parked for 0.3 s inside the pool while
                a second loader loads, serving_kv_concurrent_fill on and
                then off, the time to the first completion printed; a
                spill pressure run at phase 9's block size (12 sessions
                of 2,048 tokens into 8 sessions' worth of card arena with
                a pinned host arena), serving_kv_spill on and then off,
                spilled against evicted printed and every live session
                byte-checked; 8 concurrent identical-prompt LoadKv calls
                over ici://6 through the plane, the attachments owned by
                rank 1, prefix sharing on and then off, every session
                byte-exact;
                (b) one TCP server port holding tpu_std, HTTP, gRPC,
                redis, thrift, mongo, the nshead family (raw, nova,
                public_pbrpc, ubrpc mcpack2 and compack behind one
                owner), hulu, sofa and esp
                (brpc_tpu_torch/tools/multi_protocol.py), and a
                memcached (tools/mini_memcached.py): 200 calls of a 4 KiB
                echo on each protocol, redis and memcache at
                memtier_benchmark's defaults (32-byte values, set:get
                1:10) at pipeline depths 1 and 16, 2,000 operations each,
                p50 and p99 µs per call printed, every reply checked; the
                golden RESP and memcache fixture bytes on a raw socket,
                their answers compared
 25. TLS, auth, RTMP and trackme, all TCP in this process
                (a) a self-signed certificate made with openssl; a tpu_std
                server with ServerOptions.ssl_context and a plain one: 200
                4 KiB echoes over TLS and 200 over TCP, in turns (p50/p99
                us each); 16 calls over TLS and 16 over TCP in turns, each
                with a 4 MiB DEVICE attachment (a seeded uint8 tensor on
                cuda:0) that the server compares with the seed's bytes
                (p50/p99 and MB/s each); a plaintext client
                against the TLS server fails (its code printed) and the
                TLS calls after it succeed;
                (b) 200 4 KiB echoes with a TokenAuthenticator and 200
                without, in turns (p50 each); a wrong token fails
                ERPCAUTH; two redis channels with different
                RedisAuthenticators make two connections and two AUTHs;
                MiniMemcached with SASL PLAIN serves a right
                CouchbaseAuthenticator and fails a wrong one ERPCAUTH;
                (c) an RTMP relay hub on one port, 4 players, one
                publisher (out chunk size 4,096) sending a seeded 10 s
                1080p30 stream as fast as it can: a 150 KiB keyframe
                every 2 s, 59 frames of 20 KiB between, AAC frames of 384
                B at 43 a second, one onMetaData (300 video and 430 audio
                messages); every player gets every message in order,
                byte-equal; messages/s and MB/s per player and the one-way
                p50/p99 ms from a monotonic stamp in each payload's first
                8 bytes; once with rtmp_client_digest off and once on; a
                player's stream written to FLV reads back equal, and muxed
                to TS is a whole number of 188-byte packets whose
                continuity counters step;
                (d) a TrackMeService hub on 127.0.0.1 and an app server
                started with trackme_server set and trackme_interval 1:
                at least 2 pings within 3 s and the bulletin seen, none
                after stop_trackme

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
phase 17 they must equal the cross-process transfers this process
received (and, in (a), the attachments received, in both processes);
during phase 18 the members count their own launches from just before
their traffic: in the decode process they equal the kind-4 transfers it
received and the LoadKv attachments, in each membership-contract process
the transfers whose copy ran there (in process or pulled from a peer), and
the driving process launches none; during phase 19 the same holds
of the driving process, and in each member the launches equal the rows it
pulled on the cross-process leg plus its per-member loop's copies; during
phase 20 the driving process launches none, and in the member process and
its peer the launches equal the kind-4 transfers each received, one per
frame of (c); during phase 21 the driving process launches none in (a)
and (b) and one per LoadKv relocation in (c); in (b)'s member and its
peer the launches equal the kind-1 rows each pulled, and in (c)'s decode
process the kind-4 transfer it received; during phase 22 (a)-(c) they
equal the transfers and the calls the four ici:// servers received (the
TCP legs launch none), and in (d)-(e) the driving process, the member
and its peer launch none; during phase 23 the driving process launches
none: the dryrun runs in a process of its own, which counts its launches
per leg (in its rpc stack they equal the plane transfers of its
device-plane echo; its children count their own), and (b) and (c) are
host bytes only; during phase 24 (a) they equal the LoadKv relocations
the ici:// servers received (the pool legs copy with copy_, no launch),
and in (b) the driving process launches none; during phase 25 the
driving process launches none (TCP carries host bytes); during phase 6
each ring
kernel's launches must equal
the calls of its entry point.  The line before the last is the
``kernels`` JSON; the last line is the device JSON.
"""
from __future__ import annotations

import gc
import json
import os
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

import brpc_tpu_torch.tools.overload_clients as oc
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
# phase 17: the two-process fabric (the peer's threshold, 4 KiB, so both
# echo sizes ride the device plane; its window holds a 4 MiB frame whole)
FABRIC_SMALL, FABRIC_BIG = 4 << 10, 4 << 20
FABRIC_SMALL_CALLS, FABRIC_BIG_CALLS, FABRIC_TCP_CALLS = 300, 64, 300
FABRIC_STREAM_S, FABRIC_STREAM_CHUNK = 1.0, 64 << 10
FABRIC_INFLIGHT = 8
FABRIC_PEER_START_S = 120.0
# what calls in flight get when their peer process dies: the EOF code, as
# in the JAX package (tests/test_torch_fabric.py holds the two equal)
FABRIC_KILL_CODE = 1014
# phase 18: the pod (bench_pod_prefill_decode's shape: 512-token prompts x
# 64 steps, 2 warm-ups then 20 prompts from 2 client threads; the chaos
# contract of tests/test_pod.py with 4 processes and a 64 KiB attachment)
POD_SEQ, POD_STEPS, POD_PROMPTS, POD_WARMUP = 512, 64, 20, 2
POD_CHAOS_PROCS, POD_ATTACH = 4, 64 << 10
POD_TIMEOUT_S = 300.0
# phase 19: bench.py:823's shape, 64 MiB as phase 13's, the chaos timeout
XPROC_SHARD, XPROC_CALLS, XPROC_BIG, XPROC_BIG_CALLS = 512, 80, 64 << 20, 10
XPROC_TIMEOUT_S = 2.0
# phase 20: the same-host tiers.  (a) bench_fabric_gbps's leg: host
# attachments of 8 MiB, 12 calls a pass (96 MB) at async depth 8, best of
# 3, the ring 160 MiB for a pass (one ring) or 4 stripes of 48 MiB; (b)
# bench_fabric_streaming_mbps's: 160 chunks of 256 KiB a pass, best of 3;
# (c) frames with a 4 MiB DEVICE attachment, a 4 MiB host one and a 4 KiB
# DEVICE one below the 64 KiB device-plane threshold; (d) the fault legs'
# calls of 4 MiB host attachments, and the slow ring's delay
TIER_GB_CHUNK, TIER_GB_CALLS, TIER_GB_DEPTH, TIER_GB_PASSES = \
    8 << 20, 12, 8, 3
TIER_GB_RING, TIER_GB_STRIPE_RING = 160 << 20, 48 << 20
TIER_ST_CHUNK, TIER_ST_N, TIER_ST_PASSES = 256 << 10, 160, 3
TIER_MIX_CALLS, TIER_MIX_BIG, TIER_MIX_SMALL = 8, 4 << 20, 4 << 10
TIER_THRESHOLD = 64 << 10
TIER_FAULT_CALLS, TIER_FAULT_PAYLOAD, TIER_SLOW_MS = 16, 4 << 20, 20
# phase 21: (a) the native TCP datapath with bench.py's arguments
# (bench.py:3112-3137), then its crossings' calls and the calls in flight
# through a stop; (b) kind 1 between two processes with the shm ring, the
# bulk conn and the device plane off for the pair: echoes at 4 KiB (below
# the 64 KiB device-plane threshold), 64 KiB and 4 MiB (at and above it),
# and the refusal budget; (c) tests/test_serving.py's two-process KV shape
NTCP_ECHO_ITERS, NTCP_CALLS, NTCP_ASYNC, NTCP_STOP_CALLS = 5000, 64, 32, 8
XFER_THRESHOLD = 64 << 10
XFER_SIZES = ((4 << 10, 200), (64 << 10, 200), (4 << 20, 16))
XFER_REFUSE = 2
KV21_SEQ, KV21_STEPS, KV21_HOST_SESSIONS = 512, 7, 4
# phase 22: (a) remotefile:// over ici://4-7: calls of a 64 KiB DEVICE
# attachment, then calls while the registry withdraws ici://7; (b)
# consul:// over four TCP servers: 4 KiB DEVICE echoes; (c) each of
# nacos://, discovery:// and dns:// once; (d) the plane-frame trace's host
# payloads; (e) DEVICE payloads on a one-stripe ring of 32 MiB, the first
# of each size forwarded, enough later ones to go round the ring: the
# largest the native door takes (its window less 128 KiB, as phase 16 (e))
# and 8 MiB, over that window
NAMING_CALLS, NAMING_PAYLOAD = 200, 64 << 10
NAMING_TCP_CALLS, NAMING_TCP_PAYLOAD, NAMING_ECHOES = 64, 4 << 10, 16
TRACE_PAYLOAD = 256 << 10
RELOC_NATIVE, RELOC_PAYLOAD = (4 << 20) - (128 << 10), 8 << 20
RELOC_RING = 32 << 20
# phase 23: the dryrun's mesh, and the HTTP/gRPC legs' counts and sizes
DRYRUN_RANKS = 8
DRYRUN_TIMEOUT_S = 400
HTTP_CALLS = 200
GRPC_SMALL, GRPC_SMALL_CALLS = 4 << 10, 200
GRPC_BIG, GRPC_BIG_CALLS = 1 << 20, 16
GOAWAY_CALLS = 8
DRAIN_GRACE_S = 2.0
AUTH_KEY = "chip-smoke-key"
# phase 24 (a): bench_serving_kv_prefix's capacity shapes (prompt, tail,
# block tokens, arena blocks), its parked-fill stall, big fill and probe,
# the spill run (sessions, their tokens, card and host arena blocks at
# phase 9's block size) and the concurrent identical-prompt LoadKvs;
# (b) the calls per protocol, the echo payload, the memtier operations
KVF_PROMPT, KVF_TAIL, KVF_BLOCK, KVF_CAP_BLOCKS = 192, 16, 16, 64
KVF_STALL_S, KVF_BIG, KVF_PROBE = 0.3, 2048, 64
KVF_SPILL_SESSIONS, KVF_SPILL_SEQ, KVF_SPILL_BLOCKS = 12, 2048, 1024
KVF_LOADS, KVF_LOAD_SEQ = 8, 256
PROTO_CALLS, PROTO_PAYLOAD, PROTO_KV_OPS = 200, 4096, 2000


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
    rank; fails the run when a part of it arrived in host memory."""
    try:
        return oc.attachment_tensor(att)
    except ValueError as e:
        fail(str(e))


def _adm_server(rpc, bank, **options):
    """bench.py's overload server on ici://5: Echo.Echo sleeps
    ADM_SERVICE_MS, checks the request's attachment against its pattern of
    ``bank`` and returns it; max_concurrency ADM_MAX_CONC with the
    admission queue.  Returns the started server and its counts
    (``returned``, ``bad``)."""
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
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
                                       queue_capacity=64), **options))
    server.add_service(Echo())
    check(server.start("ici://5") == 0, "overload server start on ici://5")
    return server, served


def phase_admission(mesh, plane, p2p_copy, payload=ADM_PAYLOAD,
                    door="python") -> dict:
    """(a) bench.py's overload leg (_overload_one_plane) on ici:// with
    4 MiB DEVICE attachments (see the module docstring, phase 10), or
    (``door="native"``) on the native door with ``payload`` bytes that
    fit its window (phase 16 (e))."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc

    t_phase = time.monotonic()
    dev = mesh.device(0)
    # one attachment bank per client rank: request i of a stream carries
    # pattern i % ADM_PATTERNS, seeded bytes, owned by the stream's rank
    bank = oc.attachment_bank(mesh, (6, 7), payload, ADM_PATTERNS, dev)
    # earlier phases' garbage is collected before the baseline (as phases
    # 11 and 15 do): a collection inside this phase would move the level
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    server, served = _adm_server(rpc, bank)
    capacity = ADM_MAX_CONC / (ADM_SERVICE_MS / 1000.0)
    base, over = oc.overload_streams(capacity, ADM_FACTOR, ADM_TENANTS, (6, 7))
    out = {"capacity_rps": capacity}
    try:
        transfers0 = plane.stats()["transfers"]
        res = oc.run_overload(rpc, "ici://5", base, over, ADM_UNLOADED_S,
                              ADM_OVERLOAD_S, bank, _tensor_of)
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
    summary = oc.summarize(res, ADM_OVERLOAD_S, ADM_TENANTS)
    hi_by_tenant = summary["hi_goodput_by_tenant"]
    shed, hinted = summary["shed"], summary["shed_with_retry_after"]
    errs, bad, codes = summary["errors"], summary["bad"], summary["codes"]
    low_ok, streams = summary["low_goodput"], summary["streams"]
    mean_share = summary["mean_share"]
    out.update({
        "offered_rps": ADM_FACTOR * capacity,
        **{k: summary[k] for k in (
            "offered_rps_measured", "hi_p99_unloaded_us",
            "hi_p99_overload_us", "hi_p99_ratio", "hi_goodput_by_tenant",
            "low_goodput", "shed", "shed_with_retry_after", "errors",
            "tenant_min_share_ratio", "streams")},
        "payload_bytes": payload, "door": door, "describe": describe,
        "wall_s": time.monotonic() - t_phase})
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
          f"{codes}; per stream class {json.dumps(streams)}; "
          f"describe {json.dumps(describe)}", flush=True)
    check(served["bad"] == 0 and bad == 0,
          f"payloads differ: {served['bad']} at the server, {bad} back")
    check(shed > 0 and hinted == shed,
          f"{shed - hinted} of {shed} sheds carried no retry_after_ms")
    check(errs == 0, f"{errs} calls failed other than by a shed: {codes}")
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
    from brpc_tpu_torch.ici import native_plane, transport
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

    def dropped():
        # relocations whose request no handler saw: frames a failed
        # socket dropped and requests the lame duck bounced
        return (transport.dropped_transfers()
                + native_plane.relocation_stats()["dropped"])

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
        dropped0 = dropped()
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
        out["dropped"] = dropped() - dropped0
        out["active_at_end"] = plane.active_transfers()
        check(out["active_at_end"] == 0,
              f"{out['active_at_end']} transfers active at the end")
        by_method = {f"{u} {m}": s.method_status(m).received.get_value()
                     for u, s in decodes.items()
                     for m in ("Decode.LoadKv", "Decode.MigrateIn")}
        check(out["launches"] == out["transfers"]
              == out["calls_received"] + out["dropped"],
              f"elastic: p2p_copy launches {out['launches']}, plane "
              f"transfers {out['transfers']}, LoadKv + MigrateIn received "
              f"{out['calls_received']} + dropped {out['dropped']} "
              f"(received by rank and method "
              f"{by_method}, router retries {router_d['retries']}, "
              f"migrated {len(timing.get('moved', []))}, refused "
              f"{timing.get('refused')})")
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
          f"{out['calls_received']} + dropped {out['dropped']}; phase "
          f"{out['wall_s']:.1f} s", flush=True)
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


def _free_port() -> int:
    from brpc_tpu_torch.tools.pod_peer import free_port
    return free_port()


# phase 17 (f): a fabric peer whose open of the device leg refuses (a
# fake: the CUDA IPC mapping on the card, the shared-memory segment on the
# CPU), so the pull of every DEVICE payload sent to it fails
_REFUSING_PEER = """
import sys
from brpc_tpu_torch.ici import ipc_pull
def refuse(*args):
    raise ipc_pull.IpcPullError("IPC open failed (forced)")
ipc_pull.open_mapping = refuse
ipc_pull.open_segment = refuse
from brpc_tpu_torch.tools import fabric_peer
sys.exit(fabric_peer.main(sys.argv[1:]))
"""


class _Peer:
    """A ``brpc_tpu_torch.tools.fabric_peer`` process: a fresh interpreter
    (never a fork of this CUDA process), its output in a temporary file.
    ``refuse_open`` starts it with the device leg's open refused."""

    def __init__(self, coord: str, token: str, kv, device: str,
                 refuse_open: bool = False, extra=(), log_path=None):
        import tempfile
        self.log = (open(log_path, "w+") if log_path
                    else tempfile.TemporaryFile(mode="w+"))
        start = (["-c", _REFUSING_PEER] if refuse_open
                 else ["-m", "brpc_tpu_torch.tools.fabric_peer"])
        self.proc = subprocess.Popen(
            [sys.executable, *start, coord, token, "--device", device,
             *map(str, extra)],
            cwd=str(ROOT), stdout=self.log, stderr=subprocess.STDOUT)
        key = f"fabric_peer/{token}"
        deadline = time.monotonic() + FABRIC_PEER_START_S
        while not kv.check([key]):
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.kill()
                fail(f"fabric peer {token} did not come up "
                     f"(rc {self.proc.returncode}):\n{self.output()[-4000:]}")
            time.sleep(0.05)
        self.info = json.loads(kv.get(key))

    def output(self) -> str:
        self.log.seek(0)
        return self.log.read()

    def final(self) -> dict:
        """The peer's last JSON line (its counts as it stopped)."""
        for line in reversed(self.output().splitlines()):
            if line.startswith("{"):
                return json.loads(line)
        return {}

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def phase_fabric(mesh, plane, p2p_copy, device: str = "cuda",
                 launches=None, overload: bool = True) -> dict:
    """The two-process fabric (see the module docstring, phase 17).
    ``launches`` reads this process's copy launches (default the kernel's
    counter; a CPU rehearsal passes its plain-version count); a rehearsal
    on a shared CPU host may leave out (e), the overload leg, whose p99s
    read the card's host."""
    import brpc_tpu_torch.policy  # noqa: F401
    from datetime import timedelta
    from torch.distributed import TCPStore
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.ici import fabric, ipc_pull, route
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc.socket import list_sockets
    from brpc_tpu_torch.rpc.tcp_transport import TcpSocket
    from brpc_tpu_torch.tools.fabric_peer import (DEVICE_THRESHOLD,
                                                  SOCKET_WINDOW)

    count = launches or (lambda: p2p_copy.launches)
    t_phase = time.monotonic()
    dev = mesh.device(4)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    saved = {k: flags.get_flag(k) for k in (
        "ici_device_plane_threshold", "ici_socket_window_bytes")}
    flags.set_flag("ici_device_plane_threshold", DEVICE_THRESHOLD)
    flags.set_flag("ici_socket_window_bytes", SOCKET_WINDOW)
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    node = fabric.FabricNode.initialize(coord, 2, 0, ranks=range(4, 8),
                                        mesh=mesh)
    kv = TCPStore("127.0.0.1", port, is_master=False,
                  timeout=timedelta(seconds=60))
    peers = []
    chans = []
    out = {"device": device, "pids": []}

    def start_peer(token, refuse_open=False):
        p = _Peer(coord, token, kv, device, refuse_open)
        peers.append(p)
        out["pids"].append(p.info["os_pid"])
        return p

    def segments():
        # this run's processes' segments only: another run of the port on
        # the host may hold its own
        return [n for pid in [os.getpid(), *out["pids"]]
                for n in ipc_pull.segments_on_disk(pid)]

    def channel(target, **kw):
        ch = rpc.Channel()
        ch.init(target, options=rpc.ChannelOptions(max_retry=0, **kw))
        chans.append(ch)
        return ch

    def call(ch, method, msg="", att=None):
        cntl = rpc.Controller()
        if att is not None:
            cntl.request_attachment.append_device_array(att)
        resp = ch.call_method(method, cntl, EchoRequest(message=msg),
                              EchoResponse)
        return cntl, resp

    def peer_stats(ch, reset=False):
        cntl, resp = call(ch, "Sink.Stats", "reset" if reset else "")
        check(not cntl.failed(), f"Sink.Stats: {cntl.error_text}")
        return json.loads(resp.message)

    def fabric_socks():
        return [s for s in list_sockets()
                if isinstance(s, fabric.FabricSocket) and not s.failed]

    def wait_for(cond, secs, what):
        deadline = time.monotonic() + secs
        while not cond():
            if time.monotonic() > deadline:
                fail(f"fabric: {what} within {secs} s")
            time.sleep(0.01)

    gen = torch.Generator(device=dev).manual_seed(17)

    def fresh(nbytes):
        # written by a kernel on this stream just before its send: the
        # receiver's copy must wait for it (the interprocess event)
        return mesh.own(torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                                      device=dev, generator=gen), 4)

    l_all = count()
    r_all = plane.remote_received
    try:
        peer = start_peer("a")
        ch = channel("ici://0", timeout_ms=30000)
        # (a) the echo over ici://0 from rank 4
        peer_stats(ch, reset=True)
        l0 = count()
        r0 = plane.remote_received
        returned = 0
        lat = {}
        for size, calls in ((FABRIC_SMALL, FABRIC_SMALL_CALLS),
                            (FABRIC_BIG, FABRIC_BIG_CALLS)):
            lats = lat[size] = []
            for i in range(calls):
                src = fresh(size)
                t0 = time.perf_counter_ns()
                cntl, resp = call(ch, "Sink.Push", f"{size}:{i}", src)
                lats.append((time.perf_counter_ns() - t0) / 1000.0)
                check(not cntl.failed(), f"fabric echo {size} B #{i}: "
                                         f"{cntl.error_code_} "
                                         f"{cntl.error_text}")
                back = _tensor_of(cntl.response_attachment)
                check(mesh.rank_of(back) == 4,
                      f"echo came back owned by rank {mesh.rank_of(back)}")
                check(torch.equal(back, src),
                      f"fabric echo {size} B #{i}: bytes differ")
                returned += len(cntl.response_attachment.device_refs())
        sync()
        mine = {"launches": count() - l0,
                "received": plane.remote_received - r0,
                "attachments": returned}
        theirs = peer_stats(ch)
        sock = fabric_socks()
        ipc_here = {k: sum(s.ipc_stats()[k] for s in sock)
                    for k in ("opens", "hits", "mapped")}
        out["echo"] = {
            "calls": {str(k): len(v) for k, v in lat.items()},
            "p50_us_4k": _pct(lat[FABRIC_SMALL], 0.5),
            "p99_us_4k": _pct(lat[FABRIC_SMALL], 0.99),
            "p50_us_4m": _pct(lat[FABRIC_BIG], 0.5),
            "p99_us_4m": _pct(lat[FABRIC_BIG], 0.99),
            "gbps_4m": FABRIC_BIG * 2 / (statistics.median(lat[FABRIC_BIG])
                                         * 1e-6) / 1e9,
            "this_process": mine, "peer": theirs, "ipc_here": ipc_here}
        want = FABRIC_SMALL_CALLS + FABRIC_BIG_CALLS
        for who, c in (("this process", mine), ("the peer", theirs)):
            check(c["launches"] == c["received"] == c["attachments"] == want,
                  f"fabric echo, {who}: p2p_copy launches {c['launches']}, "
                  f"cross-process transfers received {c['received']}, "
                  f"attachments received {c['attachments']}, calls {want}")
        print(f"fabric echo: 4 KiB p50 {out['echo']['p50_us_4k']:.1f} us "
              f"p99 {out['echo']['p99_us_4k']:.1f} us; 4 MiB p50 "
              f"{out['echo']['p50_us_4m']:.1f} us p99 "
              f"{out['echo']['p99_us_4m']:.1f} us; launches = received = "
              f"attachments: here {mine}, peer "
              f"{ {k: theirs[k] for k in ('launches', 'received', 'attachments')} }; "
              f"IPC opens/hits here {ipc_here['opens']}/{ipc_here['hits']}, "
              f"peer {theirs['ipc_opens']}/{theirs['ipc_hits']}", flush=True)

        # (b) TCP: echoes, the stream, the idle reap, the internal port
        tcp_target = f"127.0.0.1:{peer.info['tcp_port']}"
        tch = channel(tcp_target, timeout_ms=10000)
        small = fresh(FABRIC_SMALL)
        want_bytes = bytes(small.cpu().numpy())
        tlat = []
        for i in range(FABRIC_TCP_CALLS):
            t0 = time.perf_counter_ns()
            cntl, resp = call(tch, "Sink.Push", str(i), small)
            tlat.append((time.perf_counter_ns() - t0) / 1000.0)
            check(not cntl.failed(), f"tcp echo #{i}: {cntl.error_text}")
            check(cntl.response_attachment.to_bytes() == want_bytes,
                  f"tcp echo #{i}: bytes differ")
        cntl = rpc.Controller()
        stream = rpc.stream_create(cntl, rpc.StreamOptions(
            max_buf_size=8 << 20))
        tch.call_method("Stream.Start", cntl, EchoRequest(message="s"),
                        EchoResponse)
        check(not cntl.failed() and stream.wait_connected(5),
              f"tcp stream: {cntl.error_text}")
        from brpc_tpu_torch.butil.iobuf import IOBuf
        chunk = IOBuf(b"x" * FABRIC_STREAM_CHUNK)
        sent = 0
        t0 = time.monotonic()
        while time.monotonic() < t0 + FABRIC_STREAM_S:
            if stream.write(chunk, timeout=5) == 0:
                sent += FABRIC_STREAM_CHUNK
        wait_for(lambda: peer_stats(ch)["stream_bytes"] >= sent, 20,
                 "the streamed bytes did not all arrive")
        stream_s = time.monotonic() - t0
        stream.close()
        tcp_sock = [s for s in list_sockets() if isinstance(s, TcpSocket)
                    and s.remote_side.port == peer.info["tcp_port"]]
        t_idle = time.monotonic()
        wait_for(lambda: all(s.failed for s in tcp_sock), 10,
                 "the idle TCP connection was not reaped")
        reap_s = time.monotonic() - t_idle
        cntl, resp = call(tch, "Sink.Push", "after-reap")
        check(not cntl.failed(), f"tcp call after the reap: "
                                 f"{cntl.error_text}")
        ich = channel(f"127.0.0.1:{peer.info['internal_port']}",
                      timeout_ms=3000)
        cntl, _ = call(ich, "Sink.Push", "x")
        check(cntl.failed(), "tpu_std was served on the internal port")
        out["tcp"] = {"calls": FABRIC_TCP_CALLS,
                      "p50_us_4k": _pct(tlat, 0.5),
                      "p99_us_4k": _pct(tlat, 0.99),
                      "stream_mbps": sent / stream_s / 1e6,
                      "stream_bytes": sent, "reap_s": reap_s,
                      "internal_port_code": cntl.error_code_}
        print(f"tcp: 4 KiB p50 {out['tcp']['p50_us_4k']:.1f} us p99 "
              f"{out['tcp']['p99_us_4k']:.1f} us; stream "
              f"{out['tcp']['stream_mbps']:.1f} MB/s; idle reap after "
              f"{reap_s:.2f} s of watching; internal port refused tpu_std "
              f"with {cntl.error_code_}", flush=True)

        # (e) phase 10's overload leg, its 12 paced clients in the peer
        if overload:
            out["overload"] = _fabric_overload(rpc, mesh, plane, ch, count,
                                               peer_stats, sync)

        # (c) the peer is killed with calls in flight
        before = fabric_socks()
        peer_stats(ch, reset=True)
        done_codes = []
        done_evt = threading.Event()

        def on_done(c):
            done_codes.append(c.error_code_)
            if len(done_codes) == FABRIC_INFLIGHT:
                done_evt.set()

        cntls = []
        for i in range(FABRIC_INFLIGHT):
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(fresh(FABRIC_SMALL))
            ch.call_method("Sink.Push", cntl, EchoRequest(message="sleep:60"),
                           EchoResponse, done=on_done)
            cntls.append(cntl)
        wait_for(lambda: peer_stats(ch)["attachments"] >= FABRIC_INFLIGHT,
                 20, "the in-flight calls did not reach the peer")
        t_kill = time.monotonic()
        peer.kill()
        check(done_evt.wait(20), f"{FABRIC_INFLIGHT - len(done_codes)} "
                                 "calls still pending after the kill")
        fail_ms = (time.monotonic() - t_kill) * 1e3
        wait_for(lambda: plane.active_transfers() == 0, 10,
                 "transfers stayed active after the kill")
        mapped = sum(s.ipc_stats()["mapped"] for s in before)
        segs = segments()
        check(mapped == 0, f"{mapped} IPC mappings left after the kill")
        check(not segs, f"shared-memory segments left: {segs}")
        check(len(set(done_codes)) == 1 and done_codes[0] == FABRIC_KILL_CODE,
              f"in-flight calls failed with {done_codes} after the kill, "
              f"expected {FABRIC_KILL_CODE}")
        peer = start_peer("b")
        t_rev = time.monotonic()
        tries = 0
        while True:
            tries += 1
            cntl, _ = call(ch, "Sink.Push", "revived", fresh(FABRIC_SMALL))
            if not cntl.failed():
                break
            check(time.monotonic() - t_rev < 30,
                  f"the restarted peer did not serve: {cntl.error_text}")
            time.sleep(0.1)
        out["kill"] = {"inflight": FABRIC_INFLIGHT,
                       "codes": list(done_codes),
                       "fail_ms": fail_ms, "revive_s":
                       time.monotonic() - t_rev, "revive_tries": tries}
        print(f"kill: {FABRIC_INFLIGHT} in-flight calls failed with "
              f"{sorted(set(done_codes))} {fail_ms:.1f} ms after the kill; "
              f"none active, mapped or left in /dev/shm; the restarted peer "
              f"served after {out['kill']['revive_s']:.2f} s "
              f"({tries} tries)", flush=True)

        # (d) a stop with calls in flight: GOODBYE, then the drain
        before = fabric_socks()
        peer_stats(ch, reset=True)
        done_codes.clear()
        done_evt.clear()
        for i in range(FABRIC_INFLIGHT):
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(fresh(FABRIC_SMALL))
            ch.call_method("Sink.Push", cntl,
                           EchoRequest(message="sleep:0.5"), EchoResponse,
                           done=on_done)
        wait_for(lambda: peer_stats(ch)["attachments"] >= FABRIC_INFLIGHT,
                 20, "the in-flight calls did not reach the peer")
        cntl, _ = call(ch, "Sink.Stop", json.dumps({"grace_s": 5.0}))
        check(not cntl.failed(), f"Sink.Stop: {cntl.error_text}")
        check(done_evt.wait(20), "calls still pending after the stop")
        check(peer.proc.wait(30) == 0, f"the peer's stop failed:\n"
                                       f"{peer.output()[-4000:]}")
        wait_for(lambda: plane.active_transfers() == 0, 10,
                 "transfers stayed active after the stop")
        final = peer.final()
        mapped = sum(s.ipc_stats()["mapped"] for s in before)
        check(all(c == 0 for c in done_codes),
              f"calls in flight at the stop failed: {done_codes}")
        check(any(s.logoff for s in before), "no GOODBYE reached this side")
        check(mapped == 0 and final.get("mapped") == 0
              and final.get("active") == 0,
              f"after the stop: mapped here {mapped}, peer {final}")
        check(not segments(), "segments left after stop")
        out["stop"] = {"inflight": FABRIC_INFLIGHT,
                       "codes": list(done_codes),
                       "goodbye": True, "peer_final": final}
        print(f"stop: {FABRIC_INFLIGHT} in-flight calls drained, GOODBYE "
              f"seen, nothing active or mapped on either side", flush=True)

        # (f) a forced IPC failure: a peer whose open of the device leg
        # refuses.  The call fails EINTERNAL with the reason, the next
        # DEVICE payload fails at once on the latched plane, and neither
        # crosses another way
        peer = start_peer("f", refuse_open=True)
        t_rev = time.monotonic()
        while True:
            cntl, _ = call(ch, "Sink.Stats")
            if not cntl.failed():
                break
            check(time.monotonic() - t_rev < 30,
                  f"the refusing peer did not serve: {cntl.error_text}")
            time.sleep(0.1)
        inline0 = route.route_stats().get("inline_bytes", 0)
        l0 = count()
        r0 = plane.remote_received
        first, _ = call(ch, "Sink.Push", "forced", fresh(FABRIC_BIG))
        latched, _ = call(ch, "Sink.Push", "latched", fresh(FABRIC_BIG))
        theirs = peer_stats(ch)
        inline = route.route_stats().get("inline_bytes", 0) - inline0
        wait_for(lambda: plane.active_transfers() == 0, 10,
                 "transfers stayed active after the refusal")
        sync()
        mapped = sum(s.ipc_stats()["mapped"] for s in fabric_socks())
        out["forced"] = {
            "first": [first.error_code_, first.error_text],
            "latched": [latched.error_code_, latched.error_text],
            "peer": {k: theirs[k] for k in ("attachments", "launches",
                                            "received", "mapped")},
            "launches_here": count() - l0,
            "received_here": plane.remote_received - r0,
            "inline_bytes": inline, "mapped_here": mapped,
            "segments": segments()}
        check(first.error_code_ == rpc.errors.EINTERNAL
              and "forced" in first.error_text,
              f"the refused pull failed its call with {out['forced']}")
        check(latched.error_code_ == rpc.errors.EINTERNAL
              and "down" in latched.error_text,
              f"the payload after the refusal: {out['forced']}")
        check(theirs["attachments"] == theirs["launches"]
              == theirs["received"] == 0
              and out["forced"]["launches_here"]
              == out["forced"]["received_here"] == 0,
              f"a refused payload crossed: {out['forced']}")
        check(inline < FABRIC_BIG, f"{inline} B rode inline after the "
                                   f"refusal: the payload went another way")
        check(mapped == 0 and theirs["mapped"] == 0
              and not out["forced"]["segments"],
              f"left mapped after the refusal: {out['forced']}")
        print(f"forced IPC failure: the call failed {first.error_code_} "
              f"({first.error_text!r}), the next {latched.error_code_} "
              f"({latched.error_text!r}); the peer saw "
              f"{theirs['attachments']} attachments and launched "
              f"{theirs['launches']} copies; {inline} B inline; nothing "
              f"active or mapped", flush=True)
    except BaseException:
        for p in peers:
            p.kill()
            print(f"fabric peer output:\n{p.output()[-6000:]}",
                  file=sys.stderr, flush=True)
        raise
    finally:
        for c in chans:
            c.close()
        for p in peers:
            p.kill()
        node.quiesce()
        for k, v in saved.items():
            flags.set_flag(k, v)
    sync()
    out["launches"] = count() - l_all
    out["received"] = plane.remote_received - r_all
    check(out["launches"] == out["received"] > 0,
          f"fabric phase: p2p_copy launches {out['launches']} != "
          f"cross-process transfers received {out['received']}")
    out["wall_s"] = time.monotonic() - t_phase
    print(f"fabric phase: {out['launches']} launches = transfers received "
          f"in this process; {out['wall_s']:.1f} s", flush=True)
    return out


def phase_pod(device: str = "cuda", scenarios=("generate", "chaos"),
              chaos_procs: int = 0) -> dict:
    """The pod (see the module docstring, phase 18): the disaggregated
    Generate over three member processes, then the membership contract over
    four (``chaos_procs`` when given), each member a fresh interpreter
    (``tools/pod_peer.py``) started with the others at once.  The members
    count their own copy launches from just before their traffic and
    report them.  ``scenarios`` picks the legs to run."""
    from brpc_tpu_torch.examples.disagg_serving.model import kv_nbytes
    from brpc_tpu_torch.ici import ipc_pull
    from brpc_tpu_torch.tools import pod_peer
    t_phase = time.monotonic()
    out = {"device": device}

    def members(scenario, nproc, extra):
        t0 = time.monotonic()
        res = pod_peer.run_members(scenario, nproc, device, extra,
                                   timeout=POD_TIMEOUT_S, cwd=str(ROOT))
        wall = time.monotonic() - t0
        for pid, (rc, r, text) in enumerate(res):
            if rc != 0 or r is None:
                for q, (_, _, t) in enumerate(res):
                    print(f"pod member {q} ({scenario}) output:\n"
                          f"{t[-6000:]}", file=sys.stderr, flush=True)
                fail(f"pod {scenario}: member {pid} ended rc {rc}")
        rs = [r for _, r, _ in res]
        for r in rs:
            check(r["foreign"] == [],
                  f"pod member {r['pid']} loaded {r['foreign']}")
            check(r["leaks"] == {"active": 0, "mapped": 0, "segments": 0},
                  f"pod member {r['pid']} left {r['leaks']}")
            left = ipc_pull.segments_on_disk(r["os_pid"])
            check(not left, f"pod member {r['pid']}'s segments left: {left}")
        return rs, wall

    gen, chaos = [], []
    if "generate" in scenarios:
        # (a)-(c): router (p0), prefill (p1, ici://2), decode (p2, ici://4)
        gen, wall = members("generate", 3, [
            "--seq", POD_SEQ, "--steps", POD_STEPS, "--prompts", POD_PROMPTS,
            "--warmup", POD_WARMUP])
        a, b, c = gen[0]["a"], gen[0]["b"], gen[0]["c"]
        n_gen = POD_WARMUP + POD_PROMPTS
        check(not gen[0]["errors"] and not a["errors"],
              f"pod Generate errors: {gen[0]['errors'] or a['errors']}")
        check(a["generates"] == n_gen, f"pod Generates: {a['generates']}")
        check(a["handoff_bytes"] == a["handoff_expected"]
              == n_gen * kv_nbytes(POD_SEQ),
              f"handoff bytes {a['handoff_bytes']}, expected "
              f"{n_gen * kv_nbytes(POD_SEQ)}")
        dec = a["decode"]
        check(dec["launches"] == dec["received"] == dec["attachments"] == n_gen,
              f"decode process: p2p_copy launches {dec['launches']}, kind-4 "
              f"transfers received {dec['received']}, attachments "
              f"{dec['attachments']}, Generates {n_gen}")
        check(a["router"]["launches"] == a["prefill"]["launches"] == 0,
              f"a copy launched outside the decode: {a['router']}, "
              f"{a['prefill']}")
        check(gen[0]["pod_list"] == ["ici://0", "ici://2", "ici://4"],
              f"pod://pd listed {gen[0]['pod_list']}")
        check(not b["problems"], f"stitched trace: {b['problems']}")
        check(b["vars_processes"] == [0, 1, 2] and not b["vars_unreachable"],
              f"/vars?scope=pod listed {b['vars_processes']}")
        check(b["metrics_processes"] == [0, 1, 2] and b["metrics_typed"],
              f"/brpc_metrics?scope=pod listed {b['metrics_processes']}")
        check(c["dropped_s"] is not None and c["relisted_s"] is not None,
              f"pod://pd through the decode's drain: {c}")
        check(c["generate_after_restart_ok"],
              f"the Generate after the decode's restart failed: "
              f"{gen[0]['errors']}")
        epochs = [r["epoch"] for r in gen]
        check(len(set(epochs)) == 1 and epochs[0] == 9,
              f"pod pd epochs {epochs}, expected 9 in every member")
        out["generate"] = {"wall_s": wall, "a": a, "b": b, "c": c,
                           "epochs": epochs}
        print(f"pod generate: {n_gen} Generates equal to reference_generate, "
              f"{a['tokens_per_s']:.1f} tokens/s from 2 clients, handoff "
              f"{a['handoff_bytes']} B = {n_gen} x {kv_nbytes(POD_SEQ)}, "
              f"{a['handoff_gbps']:.3f} GB/s over the timed prompts' LoadKv "
              f"round trips; "
              f"decode process: launches = "
              f"kind-4 received = attachments = {dec['launches']}, IPC opens "
              f"{dec['ipc']['opens']} against hits {dec['ipc']['hits']}; "
              f"stitched trace of {b['span_count']} spans, clock bounds "
              f"{b['clock_bound_us']} us; drain: pod://pd dropped ici://4 "
              f"after {c['dropped_s'] * 1e3:.1f} ms, relisted after "
              f"{c['relisted_s'] * 1e3:.1f} ms, the next Generate passed on "
              f"its one try; epochs {epochs}; "
              f"{wall:.1f} s", flush=True)

    if "chaos" in scenarios:
        # the membership contract: a kill and a drain under traffic
        nproc = chaos_procs or POD_CHAOS_PROCS
        chaos, wall = members("chaos", nproc, ["--attach", POD_ATTACH])
        want_epoch = 2 * nproc + 4
        for r in chaos:
            check(r["failed"] == 0, f"pod chaos member {r['pid']}: "
                                    f"{r['failed']} calls failed: "
                                    f"{r['failures']}")
            check(r["epoch"] == want_epoch,
                  f"pod chaos member {r['pid']} read epoch {r['epoch']}, "
                  f"expected {want_epoch}")
            d = r["counts"]
            check(d["launches"] == d["copies"] and d["remote_received"] > 0,
                  f"pod chaos member {r['pid']}: p2p_copy launches "
                  f"{d['launches']}, transfers received {d['copies']} "
                  f"({d['remote_received']} from other processes)")
        check(chaos[0].get("old_socket_revoked") is True,
              "the pre-kill socket id was not revoked")
        mark = chaos[0]["drain_mark"]
        unlisted = [r["unlisted_at"] for r in chaos]
        check(all(u is not None for u in unlisted),
              f"ici://6 never left some member's pod://: {unlisted}")
        drain_ms = (max(unlisted) - mark) * 1e3
        out["chaos"] = {
            "wall_s": wall, "epochs": [r["epoch"] for r in chaos],
            "calls": [r["calls"] for r in chaos],
            "counts": [r["counts"] for r in chaos],
            "ipc": [r["ipc"] for r in chaos],
            "drain_s": chaos[3].get("drain_s"),
            "drain_to_unlisted_ms": drain_ms}
        print(f"pod chaos: {nproc} members, calls "
              f"{out['chaos']['calls']}, none failed through p2's kill and "
              f"p3's drain; epochs {out['chaos']['epochs']} = {want_epoch}; "
              f"ici://6 left every member's pod:// {drain_ms:.1f} ms after the "
              f"drain mark; launches = transfers received "
              f"{[d['launches'] for d in out['chaos']['counts']]} "
              f"({[d['remote_received'] for d in out['chaos']['counts']]} "
              f"from other processes); the pre-kill socket id revoked; "
              f"{wall:.1f} s", flush=True)
    gen_launches = sum(r["a"]["launches"] for r in gen[1:]) \
        + (gen[0]["a"]["router"]["launches"] if gen else 0)
    chaos_launches = sum(r["counts"]["launches"] for r in chaos)
    out["launches"] = gen_launches + chaos_launches
    out["launches_by_scenario"] = {"generate": gen_launches,
                                   "chaos": chaos_launches}
    out["wall_s"] = time.monotonic() - t_phase
    out["members"] = {"generate": gen, "chaos": chaos}
    return out


def phase_fanout_xproc(device: str = "cuda",
                       local_p50_us: float = -1.0) -> dict:
    """The compiled fan-out's cross-process leg (see the module docstring,
    phase 19): four member processes of ``tools/pod_peer.py fanout``
    started at once; process 1 dies by SIGKILL in (c).  The members count
    their own launches from just before their traffic and report them,
    after (a)-(b) and at the end."""
    from brpc_tpu_torch.ici import ipc_pull
    from brpc_tpu_torch.tools import pod_peer
    t0 = time.monotonic()
    res = pod_peer.run_members(
        "fanout", 4, device,
        ["--shard", XPROC_SHARD, "--calls", XPROC_CALLS, "--big", XPROC_BIG,
         "--big-calls", XPROC_BIG_CALLS, "--xproc-timeout", XPROC_TIMEOUT_S],
        timeout=POD_TIMEOUT_S, cwd=str(ROOT))
    wall = time.monotonic() - t0
    victim = pod_peer.FANOUT_VICTIM
    for pid, (rc, r, text) in enumerate(res):
        ok = (rc == -9 and r is None) if pid == victim \
            else (rc == 0 and r is not None)
        if not ok:
            for q, (_, _, t) in enumerate(res):
                print(f"fanout member {q} output:\n{t[-6000:]}",
                      file=sys.stderr, flush=True)
            fail(f"fanout_xproc: member {pid} ended rc {rc}")
    survivors = [r for _, r, _ in res if r is not None]
    cl = res[0][1]
    empty = {"parked": 0, "held": 0, "queued": 0, "waiters": 0, "calls": 0,
             "orphans": 0}
    for r in survivors:
        check(r["foreign"] == [],
              f"fanout member {r['pid']} loaded {r['foreign']}")
        check(r["leaks"] == {"active": 0, "mapped": 0, "segments": 0},
              f"fanout member {r['pid']} left {r['leaks']}")
        tables = {k: r["xproc"][k] for k in empty}
        check(tables == empty, f"fanout member {r['pid']} left {tables}")
        left = ipc_pull.segments_on_disk(r["os_pid"])
        check(not left, f"fanout member {r['pid']}'s segments left: {left}")
        d = r["counts"]
        check(d["launches"] == d["rows_pulled"] + d["copies"],
              f"fanout member {r['pid']}: p2p_copy launches {d['launches']}"
              f", rows pulled on the leg {d['rows_pulled']}, loop copies "
              f"{d['copies']}")
    left = ipc_pull.segments_on_disk(cl["victim_os_pid"])
    check(not left, f"the killed member's segments left: {left}")
    # (a)-(b): every healthy call on the leg, the count the design predicts
    calls = cl["compiled_calls_ab"]
    check(cl["degrades_ab"] == {},
          f"a degrade counter moved in (a)-(b): {cl['degrades_ab']}")
    ab = {int(k): v for k, v in cl["ab_counts"].items()}
    for q, d in sorted(ab.items()):
        want = 6 * calls if q == 0 else 2 * calls
        check(d["rows_pulled"] == want,
              f"fanout process {q}: {d['rows_pulled']} rows pulled in "
              f"(a)-(b), the design says {want} ({calls} calls)")
        check(d["launches"] == d["rows_pulled"] + d["copies"],
              f"fanout process {q} in (a)-(b): launches {d['launches']}, "
              f"rows pulled {d['rows_pulled']}, loop copies {d['copies']}")
    c = cl["c"]
    check(c["kill"]["routes"] == ["rpc", "rpc", "rpc", "collective"],
          f"kill leg routes {c['kill']['routes']}")
    check(c["drop"]["call_s"] < XPROC_TIMEOUT_S + 1.0,
          f"the black-holed call took {c['drop']['call_s']} s")
    for r in survivors[1:]:
        check(r["route"].get("collective_member_entry_expired") == 1,
              f"fanout member {r['pid']}: expired entries "
              f"{r['route'].get('collective_member_entry_expired')}")
    check(c["sigkill"]["route"] == "rpc"
          and c["sigkill"]["call_s"] < XPROC_TIMEOUT_S + 5.0,
          f"the SIGKILL leg: {c['sigkill']}")
    check(c["after_evict"]["member_down"] == 1
          and c["survivors"]["route"] == "collective",
          f"after the eviction: {c['after_evict']}, {c['survivors']}")
    a, b = cl["a"], cl["b"]
    ipc = {r["pid"]: r["ipc"] for r in survivors}
    launches = sum(r["counts"]["launches"] for r in survivors) \
        + ab[victim]["launches"]
    print(f"fanout_xproc: (a) 8 x {XPROC_SHARD} float32 over 4 processes: "
          f"cross-process leg p50 {a['collective_p50_us']:.1f} us p99 "
          f"{a['collective_p99_us']:.1f}, per-member loop p50 "
          f"{a['loop_p50_us']:.1f} p99 {a['loop_p99_us']:.1f}, phase 13's "
          f"in-process compiled p50 {local_p50_us:.1f}; (b) 64 MiB gather "
          f"{b['gather']['compiled_ms_p50']:.2f} ms on the leg / "
          f"{b['gather']['degraded_ms_p50']:.2f} degraded, sum "
          f"{b['sum']['compiled_ms_p50']:.2f} / "
          f"{b['sum']['degraded_ms_p50']:.2f}; rows pulled in (a)-(b) "
          f"{[ab[q]['rows_pulled'] for q in sorted(ab)]} for {calls} calls"
          f" (6 and 2 a call); launches = rows pulled + loop copies in "
          f"every process; IPC opens/hits "
          f"{ {p: (v['opens'], v['hits']) for p, v in ipc.items()} }; "
          f"(c) kill {c['kill']['routes']}, drop "
          f"{c['drop']['call_s']:.2f} s, SIGKILL call "
          f"{c['sigkill']['call_s']:.2f} s then member_down; "
          f"{wall:.1f} s", flush=True)
    return {"wall_s": wall, "a": a, "b": b, "c": c, "ab_counts": ab,
            "compiled_calls_ab": calls, "ipc": ipc,
            "final_counts": {r["pid"]: r["counts"] for r in survivors},
            "payload_routes": {r["pid"]: r["payload_routes"]
                               for r in survivors},
            "launches": launches}


def _run_member(expr: str, tag: str, device: str, sizes: dict,
                args=()) -> list:
    """Run ``expr`` (a call of this module, as ``cs``) in fresh
    interpreters, one per entry of ``args`` (its extra argv), all at
    once; returns each one's ``tag`` JSON line.  ``sizes`` overrides
    module constants in them."""
    import tempfile
    procs = []
    with tempfile.TemporaryDirectory() as logs:
        for k, extra in enumerate(args or [()]):
            log = open(os.path.join(logs, f"member{k}.log"), "w+")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", "import sys, json, chip_smoke as cs; "
                 "vars(cs).update(json.loads(sys.argv[2])); "
                 f"sys.stdout.write({tag!r} + ' ' + json.dumps({expr}) + "
                 "'\\n'); sys.stdout.flush()",
                 device, json.dumps(sizes), logs, *map(str, extra)],
                cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT), log))
        outs = []
        for proc, log in procs:
            try:
                rc = proc.wait(POD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            log.seek(0)
            text = log.read()
            log.close()
            lines = [ln for ln in text.splitlines()
                     if ln.startswith(tag + " ")]
            outs.append((rc, lines, text))
        bad = [k for k, (rc, lines, _t) in enumerate(outs)
               if rc != 0 or not lines]
        if bad:
            peer = os.path.join(logs, "peer.log")
            peer = open(peer).read() if os.path.exists(peer) else ""
            for k, (rc, _l, text) in enumerate(outs):
                print(f"{tag} member {k} rc {rc}:\n{text[-10000:]}",
                      file=sys.stderr, flush=True)
            if peer:
                print(f"{tag} peer:\n{peer[-6000:]}", file=sys.stderr,
                      flush=True)
            fail(f"{tag}: member processes {bad} failed")
    return [json.loads(lines[-1][len(tag) + 1:]) for _rc, lines, _t in outs]


def _tiers_member(device: str, log_dir: str = "") -> dict:
    """Phase 20's traffic, run in a fresh interpreter of its own (process
    0 of a two-process fabric, the store's host, owning ranks 4-7) against
    a ``fabric_peer`` it starts (process 1, ranks 0-3, ``ici://0``).  It
    counts its own copy launches from just before its traffic and returns
    what the driving process checks (see the module docstring, phase
    20)."""
    import importlib
    import brpc_tpu_torch.policy  # noqa: F401
    from datetime import timedelta
    from torch.distributed import TCPStore
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.butil.iobuf import IOBuf
    from brpc_tpu_torch.ici import device_plane, fabric, ipc_pull, route
    from brpc_tpu_torch.ici.mesh import IciMesh
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc import fault_injection as fi
    from brpc_tpu_torch.rpc.socket import list_sockets
    from brpc_tpu_torch.tools.fabric_peer import SOCKET_WINDOW

    import faulthandler
    # a hang shows where it is before the driving process ends this one
    faulthandler.dump_traceback_later(POD_TIMEOUT_S - 30, exit=False)
    copy_mod = importlib.import_module("brpc_tpu_torch.ici.p2p_copy")
    plain = [0]
    if device == "cpu":
        inner = copy_mod.p2p_copy_plain

        def counted(src, dst):
            plain[0] += 1
            return inner(src, dst)

        copy_mod.p2p_copy_plain = counted
        flags.set_flag("ici_device_plane_host_mesh", True)

    def count() -> int:
        return plain[0] if device == "cpu" else copy_mod.p2p_copy.launches

    def step(what):
        print(f"tiers member: {what}", file=sys.stderr, flush=True)

    mesh = IciMesh(8, device=device)
    IciMesh.set_default(mesh)
    plane = device_plane.plane()
    dev = mesh.device(4)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    flags.set_flag("ici_device_plane_threshold", TIER_THRESHOLD)
    flags.set_flag("ici_socket_window_bytes", SOCKET_WINDOW)
    flags.set_flag("ici_bulk_claim_timeout_s", 5.0)
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    node = fabric.FabricNode.initialize(coord, 2, 0, ranks=range(4, 8),
                                        mesh=mesh)
    made = []                           # every ring segment this side made
    create = node.create_shm_segment

    def recording_create():
        h, name, lib = create()
        if name:
            made.append(name)
        return h, name, lib

    node.create_shm_segment = recording_create
    kv = TCPStore("127.0.0.1", port, is_master=False,
                  timeout=timedelta(seconds=60))
    out = {"device": device}
    chans = []
    peer = None

    def channel():
        while chans:                    # one connection at a time
            chans.pop().close()
        ch = rpc.Channel()
        ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=60000,
                                                      max_retry=0))
        chans.append(ch)
        return ch

    def sock():
        return [s for s in list_sockets() if isinstance(s, fabric.FabricSocket)
                and not s.failed and not s.is_server_side][-1]

    def call(ch, method, msg="", att=None, host=None, done=None):
        cntl = rpc.Controller()
        if att is not None:
            cntl.request_attachment.append_device_array(att)
        if host is not None:
            cntl.request_attachment.append_user_data(host)
        resp = ch.call_method(method, cntl, EchoRequest(message=msg),
                              EchoResponse, done=done)
        return cntl, resp

    def stats(ch, reset=False):
        cntl, resp = call(ch, "Sink.Stats", "reset" if reset else "")
        check(not cntl.failed(), f"Sink.Stats: {cntl.error_text}")
        return json.loads(resp.message)

    def peer_plan(ch, kw):
        cntl, resp = call(ch, "Sink.Plan", json.dumps(kw) if kw else "")
        check(not cntl.failed(), f"Sink.Plan: {cntl.error_text}")
        return json.loads(resp.message)

    def tally():
        s = sock()
        rs = route.route_stats()
        return {"shm": s.shm_bytes_sent, "bulk": s.bulk_bytes_sent,
                "stripes": {k: v for k, v in rs.items()
                            if k.startswith("shm_stripe_")
                            and k.endswith("_bytes")},
                "uds": rs.get("uds_bytes", 0), "tcp": rs.get("tcp_bytes", 0),
                "device": rs.get("device_bytes", 0),
                "inline": rs.get("inline_bytes", 0)}

    def moved(t0, t1):
        return {"shm": t1["shm"] - t0["shm"], "bulk": t1["bulk"] - t0["bulk"],
                "uds": t1["uds"] - t0["uds"], "tcp": t1["tcp"] - t0["tcp"],
                "device": t1["device"] - t0["device"],
                "stripes": {k: v - t0["stripes"].get(k, 0)
                            for k, v in t1["stripes"].items()
                            if v != t0["stripes"].get(k, 0)}}

    def wait_for(cond, secs, what):
        deadline = time.monotonic() + secs
        while not cond():
            if time.monotonic() > deadline:
                fail(f"tiers: {what} within {secs} s")
            time.sleep(0.005)

    def pump(ch, method, host, calls, depth, on_done=None):
        """``calls`` async calls with ``host`` attached, ``depth`` in
        flight; returns the failures."""
        errs = []
        sem = threading.Semaphore(depth)

        def done(c):
            if c.failed():
                errs.append((c.error_code_, c.error_text))
            sem.release()
            if on_done is not None:
                on_done()
        for _ in range(calls):
            sem.acquire()
            call(ch, method, "p", host=host, done=done)
        for _ in range(depth):
            sem.acquire()
        for _ in range(depth):
            sem.release()
        return errs

    gen = torch.Generator(device=dev).manual_seed(20)

    def fresh(nbytes):
        return mesh.own(torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                                      device=dev, generator=gen), 4)

    layouts = {"auto": {"ici_fabric_shm": True, "ici_shm_stripes": 1,
                        "ici_shm_ring_bytes": TIER_GB_RING},
               "uds": {"ici_fabric_shm": False},
               "shm_striped": {"ici_fabric_shm": True, "ici_shm_stripes": 4,
                               "ici_shm_ring_bytes": TIER_GB_STRIPE_RING}}
    defaults = {k: flags.get_flag(k) for k in ("ici_fabric_shm",
                                               "ici_shm_stripes",
                                               "ici_shm_ring_bytes")}

    def layout(name):
        for k, v in {**defaults, **layouts.get(name, {})}.items():
            flags.set_flag(k, v)

    l0 = r0 = 0
    try:
        peer = _Peer(coord, "tiers", kv, device,
                     extra=("--threshold", TIER_THRESHOLD),
                     log_path=os.path.join(log_dir, "peer.log")
                     if log_dir else None)
        step("peer up")
        out["pids"] = [os.getpid(), peer.info["os_pid"]]
        l0, r0 = count(), plane.remote_received
        # (a) bench_fabric_gbps's leg three ways
        host = memoryview(bytes(i % 251 for i in range(256)) *
                          (TIER_GB_CHUNK // 256))
        out["gbps"] = {}
        for name in ("auto", "uds", "shm_striped"):
            step(f"(a) {name}")
            layout(name)
            ch = channel()
            t_dial = time.perf_counter()
            stats(ch, reset=True)            # dials: handshake, conn, ring
            dial_ms = (time.perf_counter() - t_dial) * 1e3
            cntl, _ = call(ch, "Sink.Absorb", "warm", host=host)
            check(not cntl.failed(), f"gbps {name} warm-up: "
                                     f"{cntl.error_text}")
            t0 = tally()
            best, errs = 0.0, []
            for _ in range(TIER_GB_PASSES):
                t = time.perf_counter()
                errs += pump(ch, "Sink.Absorb", host, TIER_GB_CALLS,
                             TIER_GB_DEPTH)
                best = max(best, TIER_GB_CALLS * TIER_GB_CHUNK
                           / (time.perf_counter() - t) / 1e9)
            m = moved(t0, tally())
            theirs = stats(ch)
            d = sock().describe_shm() or {}
            out["gbps"][name] = {"gbps": best, "errors": errs[:3],
                                 "moved": m, "stripes": d.get("stripes", 0),
                                 "absorbed": theirs["absorbed"],
                                 "first_call_ms": dial_ms}
        # (b) bench_fabric_streaming_mbps's leg, each chunk verified
        out["stream"] = {}
        for name in ("auto", "uds"):
            step(f"(b) {name}")
            layout(name)
            ch = channel()
            stats(ch, reset=True)
            cntl = rpc.Controller()
            st = rpc.stream_create(cntl, rpc.StreamOptions(
                max_buf_size=8 << 20))
            ch.call_method("Stream.Start", cntl, EchoRequest(
                message="verify"), EchoResponse)
            check(not cntl.failed() and st.wait_connected(10),
                  f"stream {name}: {cntl.error_text}")
            t0 = tally()
            best, rcs = 0.0, []
            for p in range(TIER_ST_PASSES):
                t = time.perf_counter()
                for seq in range(TIER_ST_N):
                    body = b"%08d" % seq + bytes([seq % 251]) * (
                        TIER_ST_CHUNK - 8)
                    rcs.append(st.write(IOBuf(body), timeout=30))
                want = (p + 1) * TIER_ST_N * TIER_ST_CHUNK
                wait_for(lambda: stats(ch)["stream_bytes"] >= want, 60,
                         f"stream {name} pass {p} did not arrive")
                best = max(best, TIER_ST_N * TIER_ST_CHUNK
                           / (time.perf_counter() - t) / 1e6)
            st.close()
            theirs = stats(ch)
            out["stream"][name] = {
                "mbps": best, "rcs_bad": sum(1 for r in rcs if r),
                "chunks": theirs["stream_chunks"],
                "bad": theirs["stream_bad"], "moved": moved(t0, tally())}
        # (c) one frame, three attachments: kind 4, kind 6 and kind 5
        step("(c)")
        layout("default")
        ch = channel()
        stats(ch, reset=True)
        lc, rc = count(), plane.remote_received
        t0 = tally()
        bad = []
        for i in range(TIER_MIX_CALLS):
            big, small = fresh(TIER_MIX_BIG), fresh(TIER_MIX_SMALL)
            blob = bytes(torch.randint(0, 256, (TIER_MIX_BIG,),
                                       dtype=torch.uint8).numpy())
            cntl = rpc.Controller()
            cntl.request_attachment.append_device_array(big)
            cntl.request_attachment.append(blob)
            cntl.request_attachment.append_device_array(small)
            ch.call_method("Sink.Push", cntl, EchoRequest(message=str(i)),
                           EchoResponse)
            if cntl.failed():
                bad.append((i, cntl.error_code_, cntl.error_text))
                continue
            refs = [cntl.response_attachment.backing_block(j) for j in
                    range(cntl.response_attachment.backing_block_num())]
            dev_refs = [r for r in refs if r.block.kind == 2]
            back_big = dev_refs[0].block.data[
                dev_refs[0].offset:dev_refs[0].offset + dev_refs[0].length]
            back_small = dev_refs[-1].block.data[
                dev_refs[-1].offset:dev_refs[-1].offset + dev_refs[-1].length]
            host_back = b"".join(bytes(r.block.host_view(r.offset, r.length))
                                 for r in refs if r.block.kind != 2)
            if not (len(dev_refs) == 2 and torch.equal(back_big, big)
                    and mesh.rank_of(back_big) == 4
                    and back_small.device.type == "cpu"
                    and torch.equal(back_small, small.cpu())
                    and host_back == blob):
                bad.append((i, "bytes differ"))
        sync()
        m = moved(t0, tally())
        theirs = stats(ch)
        out["mixed"] = {"bad": bad[:3], "moved": m,
                        "launches": count() - lc,
                        "received": plane.remote_received - rc,
                        "peer": {k: theirs[k] for k in (
                            "launches", "received", "attachments",
                            "shm_claimed", "bulk_claimed")}}
        # (d) faults, every call answered
        step("(d)")
        fault = {}
        payload = memoryview(bytes(TIER_FAULT_PAYLOAD))
        # the ring killed mid-transfer: frames fall to the bulk conn in
        # the same frame, the prober revives the ring
        ch = channel()
        stats(ch)
        s = sock()
        t0 = tally()
        kill_at = {}
        done_n = [0]

        def kill_mid():
            done_n[0] += 1
            if done_n[0] == TIER_FAULT_CALLS // 4 and not kill_at:
                kill_at["t"] = time.monotonic()
                kill_at["armed"] = fi.chaos_plane(s, "shm", fi.KILL)
        errs = pump(ch, "Sink.Absorb", payload, TIER_FAULT_CALLS, 4,
                    on_done=kill_mid)
        wait_for(lambda: s.shm_epoch() >= 2, 30, "the killed ring revived")
        revive_s = time.monotonic() - kill_at["t"]
        m1 = moved(t0, tally())
        t1 = tally()
        errs += pump(ch, "Sink.Absorb", payload, 4, 2)
        fault["kill"] = {"errors": errs[:3], "armed": kill_at["armed"],
                         "revive_s": revive_s, "moved": m1,
                         "after": moved(t1, tally()), "failed": s.failed,
                         "epoch": s.shm_epoch()}
        # shm_kill_now: the ring of a fresh connection dies at its attach
        step("(d) kill_now")
        plan = fi.FabricFaultPlan(shm_kill_now=True)
        fi.install_fabric(plan)
        ch = channel()
        stats(ch)
        s = sock()
        t0 = tally()
        t_kill = time.monotonic()
        errs = pump(ch, "Sink.Absorb", payload, 4, 2)
        fi.install_fabric(None)
        wait_for(lambda: s.shm_epoch() >= 2, 30, "the ring killed at its "
                                                  "attach revived")
        revive_s = time.monotonic() - t_kill
        m1 = moved(t0, tally())
        t1 = tally()
        errs += pump(ch, "Sink.Absorb", payload, 4, 2)
        fault["kill_now"] = {"errors": errs[:3],
                             "injected": plan.injected["shm_chaos"],
                             "revive_s": revive_s, "moved": m1,
                             "after": moved(t1, tally()), "failed": s.failed}
        # the peer refuses the ring at the handshake: the bulk conn
        step("(d) refused")
        ch = channel()
        peer_plan(ch, {"refuse_shm_handshakes": 1})
        ch = channel()
        stats(ch)
        s = sock()
        t0 = tally()
        errs = pump(ch, "Sink.Absorb", payload, 4, 2)
        injected = peer_plan(ch, None)
        fault["refused"] = {"errors": errs[:3], "bound": s.shm_bound(),
                            "moved": moved(t0, tally()),
                            "injected": injected.get("refuse_shm", 0)}
        # a bulk sever mid-stream: that stream fails, the socket lives
        step("(d) sever")
        flags.set_flag("ici_fabric_shm", False)
        plan = fi.FabricFaultPlan(bulk_sever_after_bytes=TIER_ST_CHUNK
                                  + TIER_ST_CHUNK // 2)
        fi.install_fabric(plan)
        ch = channel()
        stats(ch)
        s = sock()
        fi.install_fabric(None)
        cntl = rpc.Controller()
        st = rpc.stream_create(cntl, rpc.StreamOptions(max_buf_size=8 << 20))
        ch.call_method("Stream.Start", cntl, EchoRequest(message="verify"),
                       EchoResponse)
        check(not cntl.failed() and st.wait_connected(10),
              f"sever stream: {cntl.error_text}")
        rcs, raised = [], False
        try:
            for seq in range(6):
                body = b"%08d" % seq + bytes([seq % 251]) * (
                    TIER_ST_CHUNK - 8)
                rcs.append(st.write(IOBuf(body), timeout=10))
        except (ConnectionError, OSError):
            raised = True
        wait_for(lambda: s.bulk_epoch() >= 2, 30, "the severed bulk conn "
                                                  "revived")
        cntl, _ = call(ch, "Sink.Absorb", "after", host=payload)
        st2 = rpc.stream_create(cntl2 := rpc.Controller(),
                                rpc.StreamOptions(max_buf_size=8 << 20))
        ch.call_method("Stream.Start", cntl2, EchoRequest(message="verify"),
                       EchoResponse)
        rcs2 = [st2.write(IOBuf(b"%08d" % q + bytes([q % 251]) * (
            TIER_ST_CHUNK - 8)), timeout=10)
            for q in range(4)] if st2.wait_connected(10) else ["no stream"]
        st2.close()
        fault["sever"] = {"injected": plan.injected["bulk_chaos"],
                          "first_rc": rcs[0] if rcs else None,
                          "stream_failed": raised or st.closed,
                          "call_after": [cntl.error_code_, cntl.error_text]
                          if cntl.failed() else None,
                          "rcs2": rcs2, "failed": s.failed,
                          "epoch": s.bulk_epoch()}
        flags.set_flag("ici_fabric_shm", True)
        # a slow ring is not a dead one
        step("(d) slow")
        ch = channel()
        stats(ch)
        s = sock()
        base = route.plane_stats()
        plan = fi.FabricFaultPlan(plane_slow_ms={"shm": TIER_SLOW_MS})
        t0 = tally()
        tt = time.monotonic()
        with fi.inject_fabric(plan):
            errs = pump(ch, "Sink.Absorb", payload, 4, 1)
        now = route.plane_stats()
        fault["slow"] = {"errors": errs[:3], "s": time.monotonic() - tt,
                         "injected": plan.injected["plane_slow"],
                         "downs": now.get("shm_down", 0)
                         - base.get("shm_down", 0),
                         "moved": moved(t0, tally()),
                         "state": s.describe_planes()["shm"]["state"]}
        out["faults"] = fault
        sync()
        theirs = stats(ch)
        out["launches"] = count() - l0
        out["received"] = plane.remote_received - r0
        out["peer_end"] = {k: theirs[k] for k in ("mapped", "active",
                                                  "segments")}
        out["here_end"] = {"mapped": sum(x.ipc_stats()["mapped"] for x in
                                         list_sockets() if isinstance(
                                             x, fabric.FabricSocket)),
                           "active": plane.active_transfers()}
    except BaseException:
        if peer is not None:
            peer.kill()
            print(f"tiers peer output:\n{peer.output()[-6000:]}",
                  file=sys.stderr, flush=True)
        raise
    finally:
        while chans:
            chans.pop().close()
        if peer is not None:
            peer.kill()
        node.quiesce()
        faulthandler.cancel_dump_traceback_later()
    out["segments_left"] = [n for n in made
                            if os.path.exists(f"/dev/shm/{n}")] + [
        n for pid in out.get("pids", []) for n in
        ipc_pull.segments_on_disk(pid)]
    out["segments_made"] = len(made)
    out["foreign"] = sorted(m for m in sys.modules if m in ("jax", "brpc_tpu")
                            or m.startswith(("jax.", "jaxlib", "brpc_tpu.")))
    return out


def phase_tiers(device: str = "cuda", **sizes) -> dict:
    """The fabric's same-host tiers (see the module docstring, phase 20):
    its traffic runs in a fresh interpreter (:func:`_tiers_member`), which
    starts the peer; this process checks the result and launches nothing.
    ``sizes`` overrides ``TIER_*`` constants in both processes (a CPU
    rehearsal runs it smaller)."""
    g = globals()
    saved = {k: g[k] for k in sizes}
    g.update(sizes)
    try:
        return _phase_tiers(device, sizes)
    finally:
        g.update(saved)


def _phase_tiers(device: str, sizes: dict) -> dict:
    t_phase = time.monotonic()
    (r,) = _run_member("cs._tiers_member(sys.argv[1], sys.argv[3])",
                       "TIERS", device, sizes)
    check(r["foreign"] == [], f"tiers: loaded {r['foreign']}")
    gb, st, mix, fa = r["gbps"], r["stream"], r["mixed"], r["faults"]
    volume = TIER_GB_PASSES * TIER_GB_CALLS * TIER_GB_CHUNK
    # a call's frame header and meta join its attachment in one host blob
    framing = TIER_GB_PASSES * TIER_GB_CALLS * 512

    def carried(nbytes):
        return volume <= nbytes <= volume + framing

    for name, g in gb.items():
        m = g["moved"]
        check(not g["errors"], f"gbps {name}: calls failed {g['errors']}")
        check(g["absorbed"] == volume + TIER_GB_CHUNK,
              f"gbps {name}: the peer absorbed {g['absorbed']} B")
        if name == "uds":
            check(m["shm"] == 0 and m["bulk"] == m["uds"]
                  and carried(m["bulk"]),
                  f"gbps uds: the route was not the bulk conn: {m}")
        else:
            check(m["bulk"] == 0 and carried(m["shm"]),
                  f"gbps {name}: the route was not the ring: {m}")
        if name == "shm_striped":
            check(g["stripes"] == 4 and len(m["stripes"]) == 4
                  and carried(sum(m["stripes"].values())),
                  f"gbps shm_striped: stripes {g['stripes']}, {m['stripes']}")
        if name == "auto":
            check(g["stripes"] == 1 and not m["stripes"],
                  f"gbps auto: one ring was asked for: {g['stripes']}, "
                  f"{m['stripes']}")
    svol = TIER_ST_PASSES * TIER_ST_N * TIER_ST_CHUNK
    for name, x in st.items():
        m = x["moved"]
        check(x["rcs_bad"] == 0 and x["bad"] == 0
              and x["chunks"] == TIER_ST_PASSES * TIER_ST_N,
              f"stream {name}: {x}")
        if name == "uds":
            check(m["shm"] == 0 and m["bulk"] == svol,
                  f"stream uds: the route was not the bulk conn: {m}")
        else:
            check(m["bulk"] == 0 and m["shm"] == svol,
                  f"stream auto: the route was not the ring: {m}")
    m = mix["moved"]
    n = TIER_MIX_CALLS
    check(not mix["bad"], f"mixed frame: {mix['bad']}")
    check(mix["launches"] == mix["received"] == n
          and mix["peer"]["launches"] == mix["peer"]["received"] == n,
          f"mixed frame: launches = kind-4 received = {n} DEVICE "
          f"attachments at or above the threshold, in each process: "
          f"here {mix['launches']}/{mix['received']}, peer {mix['peer']}")
    check(m["shm"] == n * (TIER_MIX_BIG + TIER_MIX_SMALL) and m["bulk"] == 0
          and m["device"] == n * TIER_MIX_BIG,
          f"mixed frame: shm bytes must be the host and sub-threshold "
          f"bytes, device bytes the 4 MiB ones, nothing on bulk: {m}")
    check(mix["peer"]["shm_claimed"] == n * (TIER_MIX_BIG + TIER_MIX_SMALL)
          and mix["peer"]["bulk_claimed"] == 0,
          f"mixed frame, the peer's claims: {mix['peer']}")
    k = fa["kill"]
    check(not k["errors"] and k["armed"] and not k["failed"]
          and k["moved"]["bulk"] >= TIER_FAULT_PAYLOAD
          and k["after"]["shm"] > 0 and k["after"]["bulk"] == 0,
          f"the ring killed mid-transfer: {k}")
    k = fa["kill_now"]
    check(not k["errors"] and k["injected"] >= 1 and not k["failed"]
          and k["moved"]["bulk"] >= TIER_FAULT_PAYLOAD
          and k["after"]["shm"] > 0, f"shm_kill_now: {k}")
    k = fa["refused"]
    check(not k["errors"] and not k["bound"] and k["injected"] == 1
          and k["moved"]["shm"] == 0
          and 4 * TIER_FAULT_PAYLOAD <= k["moved"]["bulk"]
          <= 4 * (TIER_FAULT_PAYLOAD + 512),
          f"the refused ring: {k}")
    k = fa["sever"]
    check(k["injected"] >= 1 and k["first_rc"] == 0 and k["stream_failed"]
          and k["call_after"] is None and k["rcs2"] == [0] * 4
          and not k["failed"] and k["epoch"] >= 2,
          f"the bulk sever mid-stream: {k}")
    k = fa["slow"]
    check(not k["errors"] and k["injected"] >= 4 and k["downs"] == 0
          and k["state"] == "up" and k["moved"]["bulk"] == 0,
          f"the slow ring: {k}")
    check(r["launches"] == r["received"] == n,
          f"tiers: launches {r['launches']}, kind-4 received "
          f"{r['received']}, DEVICE attachments at or above the threshold "
          f"{n}")
    check(not r["segments_left"] and r["segments_made"] > 0,
          f"tiers: segments left in /dev/shm: {r['segments_left']}")
    check(r["peer_end"] == {"mapped": 0, "active": 0, "segments": 0}
          and r["here_end"] == {"mapped": 0, "active": 0},
          f"tiers: held at the end: {r['peer_end']}, {r['here_end']}")
    r["wall_s"] = time.monotonic() - t_phase
    print(f"tiers: (a) GB/s auto {gb['auto']['gbps']:.3f} (one ring), uds "
          f"{gb['uds']['gbps']:.3f}, shm_striped "
          f"{gb['shm_striped']['gbps']:.3f} (4 stripes "
          f"{sorted(gb['shm_striped']['moved']['stripes'].values())}); "
          f"a new connection's first call "
          f"{ {k: round(v['first_call_ms'], 1) for k, v in gb.items()} } "
          f"ms; "
          f"(b) stream MB/s auto {st['auto']['mbps']:.1f}, uds "
          f"{st['uds']['mbps']:.1f}; (c) {n} frames: launches = kind-4 "
          f"received = {n} in each process, shm {m['shm']} B, device "
          f"{m['device']} B, bulk {m['bulk']} B; (d) ring killed "
          f"mid-transfer revived in {fa['kill']['revive_s']:.3f} s, "
          f"killed at attach revived in {fa['kill_now']['revive_s']:.3f} s,"
          f" refused ring rode bulk, bulk sever failed one stream, slow "
          f"ring {fa['slow']['s']:.3f} s for 4 calls and no degrade; "
          f"0 failed calls; (e) {r['segments_made']} segments made, none "
          f"left; {r['wall_s']:.1f} s", flush=True)
    return r


def phase_native_tcp() -> dict:
    """(a) the native TCP datapath (see the module docstring, phase 21):
    bench.py's entries, then the crossings with their request counts."""
    import collections
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import native
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc.native_fabric import NativeChannel, NativeServer

    t_phase = time.monotonic()
    out = {
        "rpc_echo_p50_us": native.native_rpc_echo_p50_us(
            iters=NTCP_ECHO_ITERS, payload=4096),
        "raw_echo_p50_us": native.native_echo_p50_us(),
        "qps": native.native_rpc_qps(threads=16, duration_ms=1500,
                                     payload=128),
        "gbps": max(native.native_rpc_throughput_gbps(
            threads=t, duration_ms=1200, payload=1 << 20)
            for t in (1, 1, 2)),
        "pooled_gbps": native.native_pooled_throughput_gbps(
            nconns=2, threads=2, duration_ms=1200, payload=1 << 20),
        "async_gbps": native.native_async_throughput_gbps(
            depth=4, duration_ms=1200, payload=256 << 10)}
    bad_bench = {k: v for k, v in out.items() if not v > 0}
    check(not bad_bench, f"native tcp: a bench entry failed: {bad_bench}")
    gate = threading.Event()

    class Echo(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            if len(cntl.request_attachment):
                cntl.response_attachment.append(cntl.request_attachment)
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def Park(self, cntl, request, response, done):
            threading.Thread(target=lambda: (gate.wait(10), done()),
                             daemon=True).start()

    payload = bytes(i % 251 for i in range(4096))

    def run(ch, n, tag):
        bad = []
        for i in range(n):
            cntl = rpc.Controller()
            cntl.timeout_ms = 5000
            cntl.request_attachment.append(payload)
            resp = ch.call_method("Echo.Echo", cntl,
                                  EchoRequest(message=f"{tag}{i}"),
                                  EchoResponse)
            if cntl.failed() or resp.message != f"{tag}{i}" \
                    or cntl.response_attachment.to_bytes() != payload:
                bad.append((i, cntl.error_code_, cntl.error_text))
        return bad

    nsrv = NativeServer()
    nsrv.add_service(Echo())
    port = nsrv.start(0)
    psrv = rpc.Server()
    psrv.add_service(Echo())
    check(psrv.start("127.0.0.1:0") == 0, "native tcp: rpc.Server start")
    nch = None
    try:
        # a tcp:// rpc.Channel to the NativeServer's Python service
        ch = rpc.Channel()
        ch.init(f"tcp://127.0.0.1:{port}",
                options=rpc.ChannelOptions(timeout_ms=5000, max_retry=0))
        bad = run(ch, NTCP_CALLS, "p")
        ch.close()
        check(not bad and nsrv.requests() == NTCP_CALLS,
              f"native tcp: rpc.Channel to NativeServer: {bad[:3]}, "
              f"served {nsrv.requests()}")
        # a NativeChannel to an rpc.Server
        pch = NativeChannel()
        pch.init(f"127.0.0.1:{psrv.listen_port}")
        bad = run(pch, NTCP_CALLS, "n")
        pch.close()
        got = psrv.method_status("Echo.Echo").received.get_value()
        check(not bad and got == NTCP_CALLS,
              f"native tcp: NativeChannel to rpc.Server: {bad[:3]}, "
              f"received {got}")
        # call_method_async: each future's done runs once
        nch = NativeChannel()
        nch.init(f"127.0.0.1:{port}")
        runs = collections.Counter()
        rlock = threading.Lock()

        def done(c, i):
            with rlock:
                runs[i] += 1
        futs = []
        for i in range(NTCP_ASYNC):
            c = rpc.Controller()
            c.timeout_ms = 5000
            futs.append(nch.call_method_async(
                "Echo.Echo", c, EchoRequest(message=f"a{i}"), EchoResponse,
                done=lambda c, i=i: done(c, i)))
        check(all(f.wait(10) for f in futs), "native tcp: async calls hung")
        bad = [i for i, f in enumerate(futs)
               if f.cntl.failed() or f.response.message != f"a{i}"]
        time.sleep(0.05)
        check(not bad and dict(runs) == {i: 1 for i in range(NTCP_ASYNC)},
              f"native tcp: async futures {bad[:3]}, done runs {dict(runs)}")
        # a stop with calls in flight
        before = nsrv.requests()
        parked = []
        for i in range(NTCP_STOP_CALLS):
            c = rpc.Controller()
            c.timeout_ms = 10000
            parked.append(nch.call_method_async(
                "Echo.Park", c, EchoRequest(message=f"s{i}"), EchoResponse))
        deadline = time.monotonic() + 10
        while nsrv.requests() < before + NTCP_STOP_CALLS \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        t0 = time.monotonic()
        nsrv.stop()
        check(all(f.wait(10) for f in parked),
              "native tcp: a call in flight through the stop never ended")
        codes = sorted(f.cntl.error_code_ for f in parked)
        check(all(codes), f"native tcp: calls through the stop answered "
                          f"OK: {codes}")
        out.update({"python_to_native": NTCP_CALLS,
                    "native_to_python": NTCP_CALLS,
                    "async": NTCP_ASYNC, "stop_codes": codes,
                    "stop_s": time.monotonic() - t0})
    finally:
        gate.set()
        if nch is not None:
            nch.close()
        nsrv.stop()
        psrv.stop()
    out["wall_s"] = time.monotonic() - t_phase
    print(f"native tcp: rpc echo p50 {out['rpc_echo_p50_us']:.2f} us, raw "
          f"epoll echo p50 {out['raw_echo_p50_us']:.2f} us, qps(16) "
          f"{out['qps']:.0f}, 1 MiB {out['gbps']:.3f} GB/s (pooled "
          f"{out['pooled_gbps']:.3f}, async depth 4 at 256 KiB "
          f"{out['async_gbps']:.3f}); {NTCP_CALLS} calls each way, "
          f"{NTCP_ASYNC} futures each done once, a stop under "
          f"{NTCP_STOP_CALLS} calls: codes {codes}; {out['wall_s']:.1f} s",
          flush=True)
    return out


def _xfer_member(device: str, log_dir: str = "") -> dict:
    """Phase 21 (b) in a fresh interpreter of its own (process 0, the
    store's host, ranks 4-7) against a ``fabric_peer`` it starts (process
    1, ranks 0-3, ``ici://0``), with the shm ring, the bulk conn and the
    device plane off for the pair: every DEVICE payload crosses as kind
    1.  It counts its own copy launches from just before its traffic."""
    import importlib
    import brpc_tpu_torch.policy  # noqa: F401
    from datetime import timedelta
    from torch.distributed import TCPStore
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.ici import fabric, route
    from brpc_tpu_torch.ici.mesh import IciMesh
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc import fault_injection as fi
    from brpc_tpu_torch.rpc.socket import list_sockets
    from brpc_tpu_torch.tools.fabric_peer import SOCKET_WINDOW

    import faulthandler
    faulthandler.dump_traceback_later(POD_TIMEOUT_S - 30, exit=False)
    copy_mod = importlib.import_module("brpc_tpu_torch.ici.p2p_copy")
    plain = [0]
    if device == "cpu":
        inner = copy_mod.p2p_copy_plain

        def counted(src, dst):
            plain[0] += 1
            return inner(src, dst)

        copy_mod.p2p_copy_plain = counted
        flags.set_flag("ici_device_plane_host_mesh", True)

    def count() -> int:
        return plain[0] if device == "cpu" else copy_mod.p2p_copy.launches

    # off for the pair: no dplane3 advert from here (so the peer's
    # payloads skip kind 4) and no device plane here; no ring, no bulk
    # conn dialed
    for name in ("ici_device_plane", "ici_fabric_shm", "ici_fabric_bulk"):
        flags.set_flag(name, False)
    mesh = IciMesh(8, device=device)
    IciMesh.set_default(mesh)
    dev = mesh.device(4)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    flags.set_flag("ici_device_plane_threshold", XFER_THRESHOLD)
    flags.set_flag("ici_socket_window_bytes", SOCKET_WINDOW)
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    node = fabric.FabricNode.initialize(coord, 2, 0, ranks=range(4, 8),
                                        mesh=mesh)
    kv = TCPStore("127.0.0.1", port, is_master=False,
                  timeout=timedelta(seconds=60))
    out = {"device": device}
    peer = None
    ch = None
    gen = torch.Generator(device=dev).manual_seed(21)

    def call(msg, att=None):
        cntl = rpc.Controller()
        if att is not None:
            cntl.request_attachment.append_device_array(att)
        resp = ch.call_method("Sink.Push", cntl, EchoRequest(message=msg),
                              EchoResponse)
        return cntl, resp

    def stats(reset=False):
        c = rpc.Controller()
        r = ch.call_method("Sink.Stats", c, EchoRequest(
            message="reset" if reset else ""), EchoResponse)
        check(not c.failed(), f"Sink.Stats: {c.error_text}")
        return json.loads(r.message)

    def sock():
        return [s for s in list_sockets() if isinstance(s, fabric.FabricSocket)
                and not s.failed and not s.is_server_side][-1]

    dev_back = [0]

    def echo(nbytes, i):
        data = mesh.own(torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                                      device=dev, generator=gen), 4)
        t0 = time.perf_counter()
        cntl, resp = call(str(i), data)
        us = (time.perf_counter() - t0) * 1e6
        if cntl.failed():
            return us, (i, cntl.error_code_, cntl.error_text)
        att = cntl.response_attachment
        dev_back[0] += len(att.device_refs())
        back = _tensor_of(att) if att.device_refs() else torch.frombuffer(
            bytearray(att.to_bytes()), dtype=torch.uint8).to(dev)
        if resp.message != str(i) or not torch.equal(back, data):
            return us, (i, "bytes differ")
        return us, None

    try:
        peer = _Peer(coord, "xfer", kv, device,
                     extra=("--threshold", XFER_THRESHOLD),
                     log_path=os.path.join(log_dir, "peer.log")
                     if log_dir else None)
        out["pids"] = [os.getpid(), peer.info["os_pid"]]
        ch = rpc.Channel()
        ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=60000,
                                                      max_retry=0))
        stats(reset=True)
        for i in range(4):                  # warm: the IPC library, maps
            echo(XFER_SIZES[0][0], -1 - i)
        s = sock()
        out["adverts"] = {"xfer_usable": s._xfer_usable,
                          "dplane_eligible": s.dplane_eligible(4 << 20),
                          "shm": s.shm_bound(), "bulk": bool(s._bulk)}
        check(out["adverts"] == {"xfer_usable": True,
                                 "dplane_eligible": False, "shm": False,
                                 "bulk": False},
              f"xfer: the pair's planes {out['adverts']}")
        stats(reset=True)
        sync()
        l0, x0, d0 = count(), fabric.xfer_stats(), dev_back[0]
        r0 = route.route_stats()
        lat, errs = {}, []
        for nbytes, calls in XFER_SIZES:
            ts = []
            for i in range(calls):
                us, err = echo(nbytes, i)
                ts.append(us)
                if err:
                    errs.append(err)
            lat[nbytes] = ts
        check(not errs, f"xfer: echoes failed or differ: {errs[:3]}")
        r1 = route.route_stats()
        out["echo"] = {f"{n >> 10}k": {"calls": len(v),
                                        "p50_us": _pct(v, 0.5),
                                        "p99_us": _pct(v, 0.99)}
                       for n, v in lat.items()}
        total = sum(c for _n, c in XFER_SIZES)
        out["route"] = {"xfer_frames": r1.get("xfer_frames", 0)
                        - r0.get("xfer_frames", 0),
                        "xfer_bytes": r1.get("xfer_bytes", 0)
                        - r0.get("xfer_bytes", 0)}
        check(out["route"] == {"xfer_frames": total,
                               "xfer_bytes": sum(n * c for n, c
                                                 in XFER_SIZES)},
              f"xfer: the payloads' route {out['route']}")
        # the refusal budget: the first refused stage latches the plane
        # down; the next stage asked is after the re-probe window
        plan = fi.FabricFaultPlan(xfer_refuse_stages=XFER_REFUSE)
        q0 = route.route_stats()
        refused = []
        with fi.inject_fabric(plan):
            for k in range(XFER_REFUSE + 1):
                refused.append(echo(XFER_SIZES[1][0], 1000 + k)[1])
                time.sleep(fabric.DEVICE_RETRY_S + 0.2)
        q1 = route.route_stats()
        out["refusal"] = {
            "failed": [e for e in refused if e],
            "injected": plan.injected["xfer"],
            "xfer_frames": q1.get("xfer_frames", 0)
            - q0.get("xfer_frames", 0),
            "inline_bytes": q1.get("inline_bytes", 0)
            - q0.get("inline_bytes", 0),
            "events": {k: v for k, v in route.plane_stats().items()
                       if k.startswith("xfer_")}}
        sync()
        theirs = stats()
        out["launches"] = count() - l0
        x1 = fabric.xfer_stats()
        out["pulled"] = x1["pulled"] - x0["pulled"]
        out["attachments"] = dev_back[0] - d0
        out["refused"] = x1["refused"] - x0["refused"]
        out["peer"] = {k: theirs[k] for k in ("launches", "xfer_pulled",
                                              "attachments", "received",
                                              "staged", "mapped",
                                              "segments", "foreign")}
        deadline = time.monotonic() + 5
        while (sum(len(x._staged) for x in list_sockets()
                   if isinstance(x, fabric.FabricSocket))
               and time.monotonic() < deadline):
            time.sleep(0.01)
        out["staged"] = sum(len(x._staged) for x in list_sockets()
                            if isinstance(x, fabric.FabricSocket))
        out["peer"]["staged"] = stats()["staged"]
        out["ipc"] = s.ipc_stats()
    except BaseException:
        if peer is not None:
            peer.kill()
            print(f"xfer peer output:\n{peer.output()[-6000:]}",
                  file=sys.stderr, flush=True)
        raise
    finally:
        if ch is not None:
            ch.close()
        if peer is not None:
            peer.kill()
        node.quiesce()
        faulthandler.cancel_dump_traceback_later()
    out["foreign"] = sorted(m for m in sys.modules if m in ("jax", "brpc_tpu")
                            or m.startswith(("jax.", "jaxlib", "brpc_tpu.")))
    return out


def phase_xfer(device: str = "cuda", **sizes) -> dict:
    """(b) kind 1 (see the module docstring, phase 21): its traffic runs
    in a member process (:func:`_xfer_member`), which starts the peer;
    this process checks the result and launches nothing."""
    g = globals()
    saved = {k: g[k] for k in sizes}
    g.update(sizes)
    try:
        return _phase_xfer(device, sizes)
    finally:
        g.update(saved)


def _phase_xfer(device: str, sizes: dict) -> dict:
    t_phase = time.monotonic()
    (r,) = _run_member("cs._xfer_member(sys.argv[1], sys.argv[3])",
                       "XFER", device, sizes)
    p = r["peer"]
    check(r["foreign"] == [] and p["foreign"] == [],
          f"xfer: loaded {r['foreign']} {p['foreign']}")
    total = sum(c for _n, c in XFER_SIZES)
    # every echo's request crossed once each way on kind 1, and the last
    # call of the refusal leg too
    check(r["launches"] == r["pulled"] == r["attachments"] == total + 1,
          f"xfer: here p2p_copy launches {r['launches']}, kind-1 pulled "
          f"{r['pulled']}, DEVICE attachments back {r['attachments']}, "
          f"expected {total + 1}")
    check(p["launches"] == p["xfer_pulled"] == p["attachments"] == total + 1
          and p["received"] == 0,
          f"xfer: the peer's launches {p['launches']}, kind-1 pulled "
          f"{p['xfer_pulled']}, attachments {p['attachments']}, kind-4 "
          f"received {p['received']}, expected {total + 1}")
    check(r["staged"] == 0 and p["staged"] == 0,
          f"xfer: rows still staged: here {r['staged']}, peer {p['staged']}")
    f = r["refusal"]
    check(not f["failed"] and f["injected"] == XFER_REFUSE
          and r["refused"] == XFER_REFUSE and f["xfer_frames"] == 1
          and XFER_REFUSE * XFER_SIZES[1][0] <= f["inline_bytes"]
          < (XFER_REFUSE + 1) * XFER_SIZES[1][0],
          f"xfer: the refusal leg {f}, refused {r['refused']}")
    r["wall_s"] = time.monotonic() - t_phase
    e = r["echo"]
    sizes_txt = ", ".join(f"{k}iB {v['p50_us']:.1f}/{v['p99_us']:.1f} us"
                          for k, v in e.items())
    print(f"xfer: kind-1 echo p50/p99 {sizes_txt}; launches = kind-1 "
          f"pulled = "
          f"attachments = {r['launches']} here and {p['launches']} in the "
          f"peer; staged 0/0; {XFER_REFUSE} stages refused, "
          f"{f['inline_bytes']} B inline, 0 failed calls; IPC opens "
          f"{r['ipc']['opens']} hits {r['ipc']['hits']}; "
          f"{r['wall_s']:.1f} s", flush=True)
    return r


def _kv_member(device: str, pid: int) -> dict:
    """Phase 21 (c) in one of two fresh interpreters: process 0 (the
    store's host, ranks 4-7) serves a DecodeService on ici://4 with its
    pool on its rank; process 1 (ranks 0-3) sends the LoadKv sessions and
    decodes.  Each counts its own copy launches."""
    import importlib
    import brpc_tpu_torch.policy  # noqa: F401
    from datetime import timedelta
    from torch.distributed import TCPStore
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.examples.disagg_serving import model
    from brpc_tpu_torch.ici import device_plane, fabric, route
    from brpc_tpu_torch.ici.mesh import IciMesh
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc.socket import list_sockets

    copy_mod = importlib.import_module("brpc_tpu_torch.ici.p2p_copy")
    plain = [0]
    if device == "cpu":
        inner = copy_mod.p2p_copy_plain

        def counted(src, dst):
            plain[0] += 1
            return inner(src, dst)

        copy_mod.p2p_copy_plain = counted
        flags.set_flag("ici_device_plane_host_mesh", True)

    def count() -> int:
        return plain[0] if device == "cpu" else copy_mod.p2p_copy.launches

    mesh = IciMesh(8, device=device)
    IciMesh.set_default(mesh)
    plane = device_plane.plane()
    payload = model.kv_nbytes(KV21_SEQ)
    out = {"pid": pid}

    def socks():
        return [s for s in list_sockets() if isinstance(s, fabric.FabricSocket)]

    # process 0 hosts the store at the port the driving process chose
    port = int(os.environ["KV21_PORT"])
    node = fabric.FabricNode.initialize(
        f"127.0.0.1:{port}", 2, pid,
        ranks=range(4, 8) if pid == 0 else range(4), mesh=mesh)
    kv = TCPStore("127.0.0.1", port, is_master=False,
                  timeout=timedelta(seconds=120))
    try:
        if pid == 0:
            from brpc_tpu_torch.examples.disagg_serving.workers import \
                DecodeService
            from brpc_tpu_torch.serving import KvPoolOptions, kv_load_stats
            server = rpc.Server()
            svc = DecodeService(4, mesh=mesh, pool_options=KvPoolOptions(
                bytes_per_token=model.KV_LAYERS * model.KV_DMODEL,
                num_blocks=256, block_tokens=16, use_timers=False))
            server.add_service(svc)
            check(server.start("ici://4") == 0, "kv: DecodeService start")
            l0, r0 = count(), plane.remote_received
            kv.set("kv21/up", "1")
            kv.wait(["kv21/done"], timedelta(seconds=120))
            s = socks()
            out.update({"stats": kv_load_stats(),
                        "served": svc.describe_serving()["kv_load"],
                        "shm_bound": bool(s) and s[0].shm_bound(),
                        "claimed": sum(x.shm_bytes_claimed for x in s),
                        "launches": count() - l0,
                        "received": plane.remote_received - r0,
                        "loads": svc.loads})
            kv.set("kv21/read", "1")
            svc.close()
            server.stop()
        else:
            kv.wait(["kv21/up"], timedelta(seconds=120))
            ch = rpc.Channel()
            ch.init("ici://4", options=rpc.ChannelOptions(
                timeout_ms=120000, max_retry=0))
            dev = mesh.device(0)
            decodes, errs = [], []
            r0 = route.route_stats()
            for i in range(KV21_HOST_SESSIONS + 1):
                tokens = [(11 * i + j) % 997 for j in range(KV21_SEQ)]
                blob = model.toy_kv_blocks(tokens, dev)
                cntl = rpc.Controller()
                if i < KV21_HOST_SESSIONS:
                    # the KV as host bytes: the ring carries them
                    cntl.request_attachment.append(blob.cpu().numpy()
                                                   .tobytes())
                else:
                    cntl.request_attachment.append_device_array(
                        mesh.own(blob, 0))
                ch.call_method("Decode.LoadKv", cntl, EchoRequest(
                    message=json.dumps({"session": f"s{i}",
                                        "seq_len": KV21_SEQ,
                                        "last_token": tokens[-1]})),
                    EchoResponse)
                if cntl.failed():
                    errs.append((i, cntl.error_code_, cntl.error_text))
                    continue
                dc = rpc.Controller()
                resp = ch.call_method("Decode.Decode", dc, EchoRequest(
                    message=json.dumps({"session": f"s{i}",
                                        "steps": KV21_STEPS,
                                        "mode": "sync"})), EchoResponse)
                if dc.failed():
                    errs.append((i, dc.error_code_, dc.error_text))
                    continue
                decodes.append([tokens, json.loads(resp.message)["tokens"]])
            r1 = route.route_stats()
            s = socks()
            out.update({"errors": errs, "decodes": decodes,
                        "shm_bound": bool(s) and s[0].shm_bound(),
                        "shm_sent": sum(x.shm_bytes_sent for x in s),
                        "shm_route_bytes": r1.get("shm_bytes", 0)
                        - r0.get("shm_bytes", 0),
                        "device_route_bytes": r1.get("device_bytes", 0)
                        - r0.get("device_bytes", 0)})
            kv.set("kv21/done", "1")
            kv.wait(["kv21/read"], timedelta(seconds=120))
            ch.close()
    finally:
        node.quiesce()
    out["payload"] = payload
    out["foreign"] = sorted(m for m in sys.modules if m in ("jax", "brpc_tpu")
                            or m.startswith(("jax.", "jaxlib", "brpc_tpu.")))
    return out


def phase_kv_routes(mesh, plane, p2p_copy, device: str = "cuda",
                    launches=None, **sizes) -> dict:
    """(c) the KV loader's routes (see the module docstring, phase 21):
    the in-process leg on the native ici:// door here, then the two-process
    shape in two member processes."""
    import gc
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.examples.disagg_serving import model
    from brpc_tpu_torch.examples.disagg_serving.workers import DecodeService
    from brpc_tpu_torch.ici import native_plane as npl
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.serving import KvPoolOptions, kv_load_stats

    launches = launches or (lambda: p2p_copy.launches)
    t_phase = time.monotonic()
    flags.set_flag("ici_device_plane_threshold", 64 * 1024)
    out = {}
    taken = []
    real_take = npl.NativeAttachment.take_segments

    def take(self):
        taken.append(len(self))
        return real_take(self)

    tokens = [(17 * j) % 499 for j in range(KV21_SEQ)]
    want = model.reference_generate(tokens, KV21_STEPS, mesh.device(0))
    server = rpc.Server()
    svc = DecodeService(6, mesh=mesh, pool_options=KvPoolOptions(
        bytes_per_token=model.KV_LAYERS * model.KV_DMODEL, num_blocks=256,
        block_tokens=16, use_timers=False))
    server.add_service(svc)
    check(server.start("ici://6") == 0, "kv: ici://6 start")
    check(server._native_ici is not None, "kv: ici://6 has no native door")
    ch = rpc.Channel()
    ch.init("ici://6", options=rpc.ChannelOptions(timeout_ms=60000,
                                                  max_retry=0))

    def load_decode(session):
        cntl = rpc.Controller()
        cntl.request_attachment.append_device_array(
            mesh.own(model.toy_kv_blocks(tokens, mesh.device(1)), 1))
        ch.call_method("Decode.LoadKv", cntl, EchoRequest(
            message=json.dumps({"session": session, "seq_len": KV21_SEQ,
                                "last_token": tokens[-1]})), EchoResponse)
        check(not cntl.failed(), f"kv {session}: LoadKv {cntl.error_text}")
        dc = rpc.Controller()
        resp = ch.call_method("Decode.Decode", dc, EchoRequest(
            message=json.dumps({"session": session, "steps": KV21_STEPS,
                                "mode": "sync"})), EchoResponse)
        check(not dc.failed(), f"kv {session}: Decode {dc.error_text}")
        return json.loads(resp.message)["tokens"]

    npl.NativeAttachment.take_segments = take
    try:
        l0, t0 = launches(), plane.stats()["transfers"]
        s0 = kv_load_stats()
        got = load_decode("n1")
        s1 = kv_load_stats()
        flags.set_flag("serving_kv_adopt", False)
        try:
            got_off = load_decode("n2")
        finally:
            flags.set_flag("serving_kv_adopt", True)
        s2 = kv_load_stats()
        torch.cuda.synchronize() if mesh.device(0).type == "cuda" else None
        out["launches"] = launches() - l0
        out["transfers"] = plane.stats()["transfers"] - t0
    finally:
        npl.NativeAttachment.take_segments = real_take
        ch.close()
        svc.close()
        server.stop()
        server.join()
    gc.collect()
    payload = model.kv_nbytes(KV21_SEQ)
    out["native"] = {
        "taken": taken, "scattered": s1["scattered"] - s0["scattered"],
        "materialized": s2["materialized"] - s1["materialized"],
        "copy_bytes": [s1["copy_bytes"] - s0["copy_bytes"],
                       s2["copy_bytes"] - s1["copy_bytes"]],
        "registry": npl.registry().live(), "att_table": npl.att_table_live()}
    check(got == want and got_off == want,
          f"kv: the native door's decodes differ from reference_generate")
    check(out["native"] == {"taken": [payload], "scattered": 1,
                            "materialized": 1,
                            "copy_bytes": [payload, 3 * payload],
                            "registry": 0, "att_table": 0},
          f"kv: the native door's leg {out['native']}")
    check(out["launches"] == out["transfers"] == 2,
          f"kv: p2p_copy launches {out['launches']}, plane transfers "
          f"{out['transfers']}, LoadKv relocations 2")
    # the two-process shape
    g = globals()
    saved = {k: g[k] for k in sizes}
    g.update(sizes)
    os.environ["KV21_PORT"] = str(_free_port())
    try:
        srv, cli = _run_member("cs._kv_member(sys.argv[1], "
                               "int(sys.argv[4]))", "KV21", device, sizes,
                               args=[(0,), (1,)])
    finally:
        os.environ.pop("KV21_PORT", None)
        g.update(saved)
    check(srv["foreign"] == cli["foreign"] == [],
          f"kv: loaded {srv['foreign']} {cli['foreign']}")
    check(not cli["errors"], f"kv: calls failed {cli['errors'][:3]}")
    bad = [i for i, (tk, got) in enumerate(cli["decodes"])
           if got != model.reference_generate(tk, KV21_STEPS,
                                              mesh.device(0))]
    check(len(cli["decodes"]) == KV21_HOST_SESSIONS + 1 and not bad,
          f"kv: sessions {bad} decode differently")
    st = srv["stats"]
    n = KV21_HOST_SESSIONS
    check((st["adopted"], st["scattered"], st["materialized"]) == (n, 1, 0)
          and st["copy_bytes"] == (st["adopted"] + st["scattered"])
          * payload,
          f"kv: the decode process's routes {st}")
    check(srv["shm_bound"] and cli["shm_bound"]
          and srv["claimed"] >= n * payload
          and cli["shm_route_bytes"] >= n * payload,
          f"kv: the ring did not carry the host sessions: {srv['claimed']},"
          f" {cli['shm_route_bytes']}")
    check(srv["launches"] == srv["received"] == 1
          and cli["device_route_bytes"] == payload,
          f"kv: the DEVICE session's pull: launches {srv['launches']}, "
          f"kind-4 received {srv['received']}, device bytes "
          f"{cli['device_route_bytes']}")
    out["two_process"] = {"stats": st, "claimed": srv["claimed"],
                          "launches": srv["launches"],
                          "decodes": len(cli["decodes"])}
    out["wall_s"] = time.monotonic() - t_phase
    print(f"kv routes: native door: parked handle taken "
          f"({out['native']['taken'][0]} B), scattered, the flag-off leg "
          f"materialized, registry and attachment table 0; two processes: "
          f"adopted {st['adopted']}, scattered {st['scattered']}, "
          f"materialized {st['materialized']}, copy bytes "
          f"{st['copy_bytes']} = {st['adopted'] + st['scattered']} x "
          f"{payload}; every decode equals reference_generate; "
          f"{out['wall_s']:.1f} s", flush=True)
    return out


def _fabric_overload(rpc, mesh, plane, ch, count, peer_stats, sync) -> dict:
    """Phase 10's overload leg across processes: the server on ici://5
    here (phase 10's, on the Python plane), the paced clients (ranks 2
    and 3) in the peer, warmed up before the unloaded window."""
    bank = oc.attachment_bank(mesh, (2, 3), ADM_PAYLOAD, ADM_PATTERNS,
                              mesh.device(5))
    server, served = _adm_server(rpc, bank, native_ici=False)
    capacity = ADM_MAX_CONC / (ADM_SERVICE_MS / 1000.0)
    base, over = oc.overload_streams(capacity, ADM_FACTOR, ADM_TENANTS, (2, 3))
    spec = {"target": "ici://5", "ranks": [2, 3], "payload": ADM_PAYLOAD,
            "patterns": ADM_PATTERNS, "unloaded_s": ADM_UNLOADED_S,
            "overload_s": ADM_OVERLOAD_S, "base": base, "over": over}
    peer_stats(ch, reset=True)
    l0 = count()
    r0 = plane.remote_received
    try:
        from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
        cntl = rpc.Controller()
        cntl.timeout_ms = 120000
        resp = ch.call_method("Sink.Overload", cntl,
                              EchoRequest(message=json.dumps(spec)),
                              EchoResponse)
        check(not cntl.failed(), f"Sink.Overload: {cntl.error_text}")
        res = json.loads(resp.message)
        received = server.method_status("Echo.Echo").received.get_value()
    finally:
        server.stop()
    sync()
    mine = {"launches": count() - l0,
            "received": plane.remote_received - r0,
            "requests": received}
    theirs = peer_stats(ch)
    summary = oc.summarize(res, ADM_OVERLOAD_S, ADM_TENANTS)
    out = {k: summary[k] for k in (
        "hi_p99_unloaded_us", "hi_p99_overload_us", "hi_p99_ratio",
        "offered_rps_measured", "shed", "errors", "attachments_back")}
    out.update({"offered_rps": ADM_FACTOR * capacity,
                "warm_calls": sum(c["issued"] for c in res["warm"].values()),
                "launches": mine["launches"], "this_process": mine,
                "peer": {k: theirs[k] for k in ("launches", "received")}})
    out["pass_p99_bound"] = out["hi_p99_ratio"] <= 2.0
    bad = served["bad"] + summary["bad"]
    check(bad == 0, f"overload: {bad} payloads differ")
    check(summary["errors"] == 0, f"overload: {summary['errors']} calls "
                                  f"failed other than by a shed: "
                                  f"{summary['codes']}")
    check(mine["launches"] == mine["received"] == mine["requests"] > 0,
          f"overload, this process: launches {mine['launches']}, received "
          f"{mine['received']}, requests {mine['requests']}")
    check(theirs["launches"] == theirs["received"]
          == summary["attachments_back"],
          f"overload, the peer: launches {theirs['launches']}, received "
          f"{theirs['received']}, attachments back "
          f"{summary['attachments_back']}")
    print(f"fabric overload: clients in the peer process, "
          f"{out['warm_calls']} warm-up calls first; priority-0 p99 "
          f"{out['hi_p99_unloaded_us']:.1f} us unloaded, "
          f"{out['hi_p99_overload_us']:.1f} us at overload (ratio "
          f"{out['hi_p99_ratio']:.3f}; bench.py bounds it at 2; printed, "
          f"not gated: against a warm baseline it did not hold in every "
          f"run, PERF.md section 7); offered "
          f"{out['offered_rps_measured']:.1f} rps measured; shed "
          f"{out['shed']}", flush=True)
    return out


# ---- phase 22: remote naming, the plane-frame trace, the relocation -----

def _naming_servers(rpc, EchoRequest, EchoResponse, targets):
    """One server per ``(tag, target)``, each answering ``Tag.Echo`` with
    its tag (and, for the message ``echo``, its request's attachment) and
    counting the calls it received."""
    received = {tag: 0 for tag, _t in targets}
    lock = threading.Lock()
    servers = []
    for tag, target in targets:
        class Tag(rpc.Service):
            @rpc.method(EchoRequest, EchoResponse)
            def Echo(self, cntl, request, response, done, tag=tag):
                with lock:
                    received[tag] += 1
                response.message = tag
                if request.message == "echo":
                    cntl.response_attachment.append(
                        cntl.request_attachment)
                done()
        srv = rpc.Server()
        srv.add_service(Tag())
        check(srv.start(target) == 0, f"phase 22: server on {target}")
        servers.append(srv)
    return servers, received


def _echo_device(rpc, ch, payload, EchoRequest, EchoResponse, want=None):
    """One ``Tag.Echo`` with ``payload`` as a DEVICE attachment, echoed
    back when ``want`` (its bytes) is given; returns (the tag of the
    member that answered, an error or None)."""
    cntl = rpc.Controller()
    cntl.request_attachment.append_device_array(payload)
    resp = ch.call_method("Tag.Echo", cntl, EchoRequest(
        message="push" if want is None else "echo"), EchoResponse)
    if cntl.failed():
        return None, (cntl.error_code_, cntl.error_text)
    if want is not None and cntl.response_attachment.to_bytes() != want:
        return resp.message, "the echo came back with other bytes"
    return resp.message, None


def phase_remote_naming(mesh, plane, p2p_copy, launches=None) -> dict:
    """Remote naming against a registry on localhost (see the module
    docstring, phase 22 (a)-(c)).  ``launches`` reads this process's copy
    launches (default the kernel's counter; a CPU rehearsal passes its
    plain-version count)."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.policy import naming
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.tools.fake_registry import FakeRegistry

    t_phase = time.monotonic()
    count = launches or (lambda: p2p_copy.launches)
    sync = torch.cuda.synchronize if mesh.device_type == "cuda" \
        else (lambda: None)
    reg = FakeRegistry()
    out = {}
    period = flags.get_flag("ns_poll_interval_s")
    threshold = flags.get_flag("ici_device_plane_threshold")
    try:
        # (a) remotefile:// naming ici://4-7 on the default door
        flags.set_flag("ici_device_plane_threshold", 1)
        ranks = [f"ici://{r}" for r in range(4, 8)]
        servers, received = _naming_servers(rpc, EchoRequest, EchoResponse,
                                            [(r, r) for r in ranks])
        reg.set_file("/fleet", ranks)
        url = f"remotefile://{reg.hostport}/fleet"
        ch = rpc.Channel()
        check(ch.init(url, "rr", options=rpc.ChannelOptions(
            timeout_ms=30000, max_retry=0)) == 0, "phase 22 (a): init")
        _, payload = make_payload(mesh, NAMING_PAYLOAD, 1, seed=22)
        l0, x0 = count(), plane.stats()["transfers"]
        lat, errs = [], []
        for _ in range(NAMING_CALLS):
            t0 = time.perf_counter_ns()
            _who, err = _echo_device(rpc, ch, payload, EchoRequest,
                                     EchoResponse)
            lat.append((time.perf_counter_ns() - t0) / 1000.0)
            if err:
                errs.append(err)
        sync()
        per = dict(received)
        # the registry withdraws ici://7 while calls go on
        stop = threading.Event()
        during = []

        def traffic():
            while not stop.is_set():
                who, err = _echo_device(rpc, ch, payload, EchoRequest,
                                        EchoResponse)
                during.append((time.monotonic(), who))
                if err:
                    errs.append(err)

        th = threading.Thread(target=traffic)
        th.start()
        time.sleep(0.2)
        t_w = time.monotonic()
        reg.set_file("/fleet", ranks[:3])
        deadline = t_w + 10 * period
        while ranks[3] in [str(e.endpoint) for e in ch._lb.servers()] \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        drop_ms = (time.monotonic() - t_w) * 1e3
        time.sleep(0.3)
        t_after = time.monotonic()
        time.sleep(0.3)
        stop.set()
        th.join(60)
        sync()
        deadline = time.monotonic() + 10
        while plane.active_transfers() and time.monotonic() < deadline:
            time.sleep(0.005)
        calls = NAMING_CALLS + len(during)
        a = {"calls": calls, "errors": errs[:3], "per_member": per,
             "received": sum(received.values()),
             "launches": count() - l0,
             "transfers": plane.stats()["transfers"] - x0,
             "p50_us": _pct(lat, 0.5), "p99_us": _pct(lat, 0.99),
             "drop_ms": drop_ms,
             "to_7_after_drop": sum(1 for t, who in during
                                    if t >= t_after and who == ranks[3])}
        ch.close()
        naming.stop_naming_service_thread(url)
        for srv in servers:
            srv.stop()
        flags.set_flag("ici_device_plane_threshold", threshold)
        out["a"] = a
        check(not errs, f"phase 22 (a): calls failed: {errs[:3]}")
        check(a["launches"] == a["transfers"] == a["received"] == calls,
              f"phase 22 (a): launches {a['launches']}, transfers "
              f"{a['transfers']}, calls received {a['received']}, calls "
              f"{calls}")
        check(all(abs(v - NAMING_CALLS // 4) <= NAMING_CALLS // 20
                  for v in per.values()),
              f"phase 22 (a): rr spread {per}")
        check(drop_ms < 10 * period * 1e3 and a["to_7_after_drop"] == 0,
              f"phase 22 (a): ici://7 left the balancer after {drop_ms} ms,"
              f" {a['to_7_after_drop']} calls reached it after")

        # (b) consul:// in Consul's health form, four TCP servers
        servers, received = _naming_servers(
            rpc, EchoRequest, EchoResponse,
            [(f"tcp{i}", "tcp://127.0.0.1:0") for i in range(4)])
        ports = [srv.listen_port for srv in servers]
        items = [reg.consul_item("127.0.0.1", p, tags=("tcp",))
                 for p in ports]
        reg.set_consul("fleet", items)
        url = f"consul://{reg.hostport}/fleet"
        ch = rpc.Channel()
        check(ch.init(url, "rr", options=rpc.ChannelOptions(
            timeout_ms=30000, max_retry=0)) == 0, "phase 22 (b): init")
        resets = []

        class Watch:
            def reset_servers(self, entries):
                resets.append((time.monotonic(), len(entries)))

        nst = naming.get_naming_service_thread(url)
        nst.add_watcher(Watch())
        data, small = make_payload(mesh, NAMING_TCP_PAYLOAD, 1, seed=221)
        want = data.tobytes()
        l0 = count()
        errs, who = [], {}
        for _ in range(NAMING_TCP_CALLS):
            w, err = _echo_device(rpc, ch, small, EchoRequest, EchoResponse,
                                  want)
            who[w] = who.get(w, 0) + 1
            if err:
                errs.append(err)
        stop.clear()
        during = []

        def traffic_b():
            while not stop.is_set():
                w, err = _echo_device(rpc, ch, small, EchoRequest,
                                      EchoResponse, want)
                during.append(w)
                if err:
                    errs.append(err)

        th = threading.Thread(target=traffic_b)
        th.start()
        watch_ms = []
        for n, listing in ((3, items[:3]), (4, items)):
            time.sleep(0.2)
            k = len(resets)
            t_b = time.monotonic()
            reg.set_consul("fleet", listing)
            deadline = t_b + 10
            while not any(c == n for _t, c in resets[k:]) \
                    and time.monotonic() < deadline:
                time.sleep(0.0005)
            hit = [t for t, c in resets[k:] if c == n]
            watch_ms.append((hit[0] - t_b) * 1e3 if hit else None)
        time.sleep(0.2)
        stop.set()
        th.join(60)
        sync()
        b = {"calls": NAMING_TCP_CALLS + len(during), "errors": errs[:3],
             "members": len([w for w in who if w]),
             "launches": count() - l0, "watch_ms": watch_ms}
        ch.close()
        t0 = time.monotonic()
        naming.stop_naming_service_thread(url)
        b["stop_ms"] = (time.monotonic() - t0) * 1e3
        out["b"] = b
        check(not errs, f"phase 22 (b): calls failed: {errs[:3]}")
        check(b["members"] == 4, f"phase 22 (b): answered by {who}")
        check(b["launches"] == 0, f"phase 22 (b): {b['launches']} copy "
                                  f"launches on the TCP leg")
        check(all(m is not None and m < period * 1e3 for m in watch_ms),
              f"phase 22 (b): the watch published after {watch_ms} ms "
              f"(period {period} s)")

        # (c) nacos://, discovery:// and dns://, each once
        p = ports
        reg.set_nacos("svc", [
            {"ip": "127.0.0.1", "port": p[0], "weight": 1.0,
             "healthy": True, "enabled": True, "clusterName": "c1"},
            {"ip": "127.0.0.1", "port": p[1], "weight": 2.5,
             "healthy": True, "enabled": True, "clusterName": "c1"},
            {"ip": "127.0.0.1", "port": p[2], "weight": 1.0,
             "healthy": False, "enabled": True, "clusterName": "c1"},
            {"ip": "127.0.0.1", "port": p[3], "weight": 1.0,
             "healthy": True, "enabled": False, "clusterName": "c2"}])
        reg.set_discovery("app", [
            {"addrs": [f"grpc://127.0.0.1:{p[0]}",
                       f"http://127.0.0.1:{p[2]}"], "status": 1,
             "zone": "z1"},
            {"addrs": [f"grpc://127.0.0.1:{p[3]}"], "status": 3,
             "zone": "z2"}])
        cases = {
            "nacos": (f"nacos://{reg.hostport}/svc",
                      [(f"127.0.0.1:{p[0]}", 100, "c1"),
                       (f"127.0.0.1:{p[1]}", 250, "c1")]),
            "discovery": (f"discovery://{reg.hostport}/app",
                          [(f"127.0.0.1:{p[0]}", 100, "z1"),
                           (f"127.0.0.1:{p[2]}", 100, "z1")]),
            "dns": (f"dns://localhost:{p[1]}",
                    [(f"127.0.0.1:{p[1]}", 100, "")])}
        l0 = count()
        c = {}
        for name, (url, expect) in cases.items():
            got = [(str(e.endpoint), e.weight, e.tag) for e in
                   naming.create_naming_service(url).get_servers()]
            ch = rpc.Channel()
            check(ch.init(url, "rr", options=rpc.ChannelOptions(
                timeout_ms=30000, max_retry=0)) == 0,
                f"phase 22 (c) {name}: init")
            errs = [e for _w, e in (
                _echo_device(rpc, ch, small, EchoRequest, EchoResponse, want)
                for _ in range(NAMING_ECHOES)) if e]
            ch.close()
            naming.stop_naming_service_thread(url)
            c[name] = {"entries": got, "errors": errs[:3]}
            check(got == expect, f"phase 22 (c) {name}: resolved {got}, "
                                 f"expected {expect}")
            check(not errs, f"phase 22 (c) {name}: echoes failed {errs}")
        c["launches"] = count() - l0
        out["c"] = c
        check(c["launches"] == 0, f"phase 22 (c): {c['launches']} copy "
                                  f"launches on TCP")
        for srv in servers:
            srv.stop()
    finally:
        flags.set_flag("ici_device_plane_threshold", threshold)
        reg.close()
    out["launches"] = out["a"]["launches"]
    out["transfers"] = out["a"]["transfers"]
    out["wall_s"] = time.monotonic() - t_phase
    a, b = out["a"], out["b"]
    print(f"remote naming: (a) remotefile:// over ici://4-7, {a['calls']} "
          f"calls of {NAMING_PAYLOAD} B DEVICE: launches = transfers = "
          f"received = {a['launches']}, rr {a['per_member']}, p50 "
          f"{a['p50_us']:.1f} us, p99 {a['p99_us']:.1f} us; ici://7 left "
          f"the balancer {a['drop_ms']:.1f} ms after the registry withdrew "
          f"it; (b) consul:// over 4 TCP servers, {b['calls']} echoes of "
          f"{NAMING_TCP_PAYLOAD} B DEVICE, 0 launches, the watch published "
          f"a withdrawal and a re-add {[round(m, 2) for m in b['watch_ms']]}"
          f" ms after the index moved, stop {b['stop_ms']:.1f} ms; (c) "
          f"nacos, discovery, dns resolved as expected, {NAMING_ECHOES} "
          f"echoes each; 0 failed calls; {out['wall_s']:.1f} s", flush=True)
    return out


def _trace_member(device: str, log_dir: str = "") -> dict:
    """Phase 22 (d)-(e) in a fresh interpreter of its own (process 0 of a
    two-process fabric, ranks 4-7) against a ``fabric_peer`` it starts
    (process 1, ``--threshold 65536``), ``rpc_dump`` on in both."""
    import hashlib
    import importlib
    import tempfile
    import brpc_tpu_torch.policy  # noqa: F401
    from datetime import timedelta
    from torch.distributed import TCPStore
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.ici import fabric
    from brpc_tpu_torch.ici.mesh import IciMesh
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc import fault_injection as fi
    from brpc_tpu_torch.rpc import rpc_dump
    from brpc_tpu_torch.rpc.socket import list_sockets
    from brpc_tpu_torch.tools.fabric_peer import SOCKET_WINDOW

    copy_mod = importlib.import_module("brpc_tpu_torch.ici.p2p_copy")
    plain = [0]
    if device == "cpu":
        inner = copy_mod.p2p_copy_plain

        def counted(src, dst):
            plain[0] += 1
            return inner(src, dst)

        copy_mod.p2p_copy_plain = counted
        flags.set_flag("ici_device_plane_host_mesh", True)

    def count() -> int:
        return plain[0] if device == "cpu" else copy_mod.p2p_copy.launches

    mesh = IciMesh(8, device=device)
    IciMesh.set_default(mesh)
    dev = mesh.device(4)
    flags.set_flag("ici_device_plane_threshold", TIER_THRESHOLD)
    flags.set_flag("ici_socket_window_bytes", SOCKET_WINDOW)
    dumps = tempfile.mkdtemp(prefix="plane_trace_")
    mine, theirs = os.path.join(dumps, "member"), os.path.join(dumps, "peer")
    flags.set_flag("rpc_dump_dir", mine)
    flags.set_flag("rpc_dump_max_files", 1)
    flags.set_flag("rpc_dump_max_requests_in_one_file", 16)
    flags.set_flag("rpc_dump", True)
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    node = fabric.FabricNode.initialize(coord, 2, 0, ranks=range(4, 8),
                                        mesh=mesh)
    kv = TCPStore("127.0.0.1", port, is_master=False,
                  timeout=timedelta(seconds=60))
    out = {"device": device}
    chans, peer = [], None

    def channel():
        while chans:                    # one connection at a time
            chans.pop().close()
        ch = rpc.Channel()
        ch.init("ici://0", options=rpc.ChannelOptions(timeout_ms=60000,
                                                      max_retry=0))
        chans.append(ch)
        return ch

    def sock():
        return [s for s in list_sockets() if isinstance(s, fabric.FabricSocket)
                and not s.failed and not s.is_server_side][-1]

    def call(ch, method, msg="", host=None, att=None):
        cntl = rpc.Controller()
        if host is not None:
            cntl.request_attachment.append(host)
        if att is not None:
            cntl.request_attachment.append_device_array(att)
        resp = ch.call_method(method, cntl, EchoRequest(message=msg),
                              EchoResponse)
        return cntl, resp

    def stats(ch, reset=False):
        cntl, resp = call(ch, "Sink.Stats", "reset" if reset else "")
        check(not cntl.failed(), f"Sink.Stats: {cntl.error_text}")
        return json.loads(resp.message)

    def wait_for(cond, secs):
        deadline = time.monotonic() + secs
        while not cond() and time.monotonic() < deadline:
            time.sleep(0.005)
        return cond()

    def kill(s, plane):
        """chaos_plane KILL, then wait until this end's reader saw it: the
        next frame's route probe here finds the plane dead, so this side
        sends DOWN (tests/test_chaos_fabric.py:1789's goldens)."""
        with s._bulk_lock:
            h = s._bulk if plane == "bulk" else s._shm
            lib = s._blib if plane == "bulk" else s._shmlib
        alive = (lib.brpc_tpu_torch_fab_alive if plane == "bulk"
                 else lib.brpc_tpu_torch_shm_alive)
        armed = fi.chaos_plane(s, plane, fi.KILL)
        return armed and wait_for(lambda: not alive(h), 30)

    try:
        peer = _Peer(coord, "trace", kv, device,
                     extra=("--threshold", TIER_THRESHOLD,
                            "--rpc-dump", theirs),
                     log_path=os.path.join(log_dir, "peer.log")
                     if log_dir else None)
        out["pids"] = [os.getpid(), peer.info["os_pid"]]
        l0 = count()
        # (d) a bulk sever, then a ring kill, on one socket
        ch = channel()
        stats(ch, reset=True)
        payload = bytes(bytearray((i * 5 + 1) & 0xFF
                                  for i in range(TRACE_PAYLOAD)))
        errs = []

        def echo(tag):
            cntl, _ = call(ch, "Sink.Push", tag, host=payload)
            if cntl.failed():
                errs.append((tag, cntl.error_code_, cntl.error_text))
            elif cntl.response_attachment.to_bytes() != payload:
                errs.append((tag, "corrupt"))

        echo("healthy")
        s = sock()
        d = {"healthy_records": len(rpc_dump.load_fabric_trace(mine))
             + len(rpc_dump.load_fabric_trace(theirs)),
             "bound": [bool(s.shm_bound()), bool(s._bulk)],
             "armed": [kill(s, "bulk")]}
        t0 = time.monotonic()
        echo("bulk-severed")
        d["bulk_revived"] = wait_for(lambda: s.bulk_epoch() >= 2, 30)
        d["bulk_revive_s"] = time.monotonic() - t0
        d["armed"].append(kill(s, "shm"))
        t0 = time.monotonic()
        echo("ring-killed")
        d["shm_revived"] = wait_for(lambda: s.shm_epoch() >= 2, 30)
        d["shm_revive_s"] = time.monotonic() - t0
        echo("both-revived")
        d.update(errors=errs, sock=s.id, failed=s.failed,
                 member_trace=rpc_dump.load_fabric_trace(mine),
                 peer_trace=rpc_dump.load_fabric_trace(theirs),
                 launches=count() - l0, peer=stats(ch)["launches"])
        flags.set_flag("rpc_dump", False)
        out["d"] = d
        # (e) DEVICE payloads the device plane does not carry: kind 5 on
        # a one-stripe ring, delivered host-resident.  The first of each
        # size is forwarded into a call on the peer's native door; the
        # later ones recycle its slot.  One size fits the native window
        # (the door relocates it), the other does not (the Python plane's
        # transport does)
        flags.set_flag("ici_device_plane_threshold", 1 << 30)
        flags.set_flag("ici_shm_stripes", 1)
        flags.set_flag("ici_shm_ring_bytes", RELOC_RING)
        ch = channel()
        gen = torch.Generator(device=dev).manual_seed(222)
        out["e"] = {}
        for door, size in (("native", RELOC_NATIVE),
                           ("python", RELOC_PAYLOAD)):
            before = stats(ch, reset=True)["shm_claimed"]
            call(ch, "Sink.Kept", "reset")
            l0 = count()
            seen, errs, first_sha = [], [], None
            # enough later payloads to go round the ring at least once
            later = RELOC_RING // size + 2
            for i in range(1 + later):
                t = mesh.own(torch.randint(0, 256, (size,), dtype=torch.uint8,
                                           device=dev, generator=gen), 4)
                if i == 0:
                    first_sha = hashlib.sha256(
                        t.cpu().numpy().tobytes()).hexdigest()
                cntl, resp = call(ch, "Sink.Forward",
                                  "forward" if i == 0 else "plain", att=t)
                if cntl.failed():
                    errs.append((i, cntl.error_code_, cntl.error_text))
                else:
                    seen.append(json.loads(resp.message))
            _, resp = call(ch, "Sink.Kept")
            theirs_now = stats(ch)
            out["e"][door] = {
                "bytes": size, "calls": 1 + later, "errors": errs,
                "seen": seen, "kept": json.loads(resp.message),
                "first_sha256": first_sha,
                # a later payload landed over the first one's bytes
                "recycled": bool(seen) and any(
                    abs(x["ptr"] - seen[0]["ptr"]) < size
                    for x in seen[1:]),
                "shm_claimed": theirs_now["shm_claimed"] - before,
                "launches": count() - l0, "peer": theirs_now["launches"]}
    except BaseException:
        if peer is not None:
            peer.kill()
            print(f"trace peer output:\n{peer.output()[-6000:]}",
                  file=sys.stderr, flush=True)
        raise
    finally:
        while chans:
            chans.pop().close()
        if peer is not None:
            peer.kill()
        node.quiesce()
    out["foreign"] = sorted(m for m in sys.modules if m in ("jax", "brpc_tpu")
                            or m.startswith(("jax.", "jaxlib", "brpc_tpu.")))
    return out


def _trace_families(trace, sends, name):
    """The checks of tests/test_chaos_fabric.py:1789 on one side's trace
    (``sends``: this side sent DOWN and REESTABLISH)."""
    mine, theirs = ("out", "in") if sends else ("in", "out")
    for lo, key in ((8, "bulk_key"), (17, "shm_seg")):
        req = [r for r in trace if r["dir"] == mine
               and lo <= r["ftype"] <= lo + 3]
        ok_ = [r for r in trace if r["dir"] == theirs
               and lo <= r["ftype"] <= lo + 3]
        body = json.loads(bytes.fromhex(req[1]["body"])) \
            if len(req) == 2 else {}
        check([r["ftype"] for r in req] == [lo, lo + 1]
              and req[0]["body"] == "" and set(body) == {key}
              and [r["ftype"] for r in ok_] == [lo + 2]
              and ok_[0]["body"] == "",
              f"phase 22 (d) {name}: frames {lo}-{lo + 3}: {trace}")
    order = [r["ftype"] for r in trace]
    check(order.index(8) < order.index(9) < order.index(10)
          and order.index(17) < order.index(18) < order.index(19),
          f"phase 22 (d) {name}: order {order}")


def phase_plane_trace(device: str = "cuda", **sizes) -> dict:
    """The plane-frame trace and the host-delivered relocation (see the
    module docstring, phase 22 (d)-(e)): the traffic runs in a member
    process (:func:`_trace_member`), which starts the peer; this process
    checks the result and launches nothing."""
    g = globals()
    saved = {k: g[k] for k in sizes}
    g.update(sizes)
    try:
        return _phase_plane_trace(device, sizes)
    finally:
        g.update(saved)


def _phase_plane_trace(device: str, sizes: dict) -> dict:
    t_phase = time.monotonic()
    (r,) = _run_member("cs._trace_member(sys.argv[1], sys.argv[3])",
                       "TRACE", device, sizes)
    check(r["foreign"] == [], f"phase 22 (d): loaded {r['foreign']}")
    d, e = r["d"], r["e"]
    check(not d["errors"] and not d["failed"] and d["bound"] == [True, True]
          and d["armed"] == [True, True] and d["bulk_revived"]
          and d["shm_revived"],
          f"phase 22 (d): {({k: d[k] for k in d if 'trace' not in k})}")
    check(d["healthy_records"] == 0,
          f"phase 22 (d): a healthy call wrote {d['healthy_records']} "
          f"plane frames")
    check(all(x["sock"] == d["sock"] for x in d["member_trace"]),
          "phase 22 (d): the member's trace names another socket")
    _trace_families(d["member_trace"], True, "member")
    _trace_families(d["peer_trace"], False, "peer")
    for door, x in e.items():
        first = x["seen"][0] if x["seen"] else {}
        moved = first.get("relocated", {})
        check(not x["errors"] and len(x["seen"]) == x["calls"],
              f"phase 22 (e) {door}: calls failed {x['errors']}")
        check(all(y["device"] == "cpu" and y["rank_of"] == -1
                  for y in x["seen"])
              and first.get("error") is None and first.get("native")
              and first.get("callee_rank") == "1",
              f"phase 22 (e) {door}: the forward: {first}")
        want = ({"plane": 0, "device_put": 1, "failed": 0, "dropped": 0}
                if door == "native" else
                {"plane": 0, "device_put": 0, "failed": 0, "dropped": 0})
        check(moved == want, f"phase 22 (e) {door}: native relocations "
                             f"moved {moved}, expected {want}")
        check(x["recycled"], f"phase 22 (e) {door}: no later payload "
                             f"landed over the first's bytes: "
                             f"{[y['ptr'] for y in x['seen']]}")
        check(x["kept"]["n"] == 1 and x["kept"]["rank"] == 1
              and x["kept"]["sha256"] == x["first_sha256"],
              f"phase 22 (e) {door}: the callee holds {x['kept']}, the "
              f"first payload was {x['first_sha256']}")
        check(x["shm_claimed"] >= x["calls"] * x["bytes"],
              f"phase 22 (e) {door}: the ring carried {x['shm_claimed']} "
              f"B")
    r["launches"] = d["launches"] + d["peer"] + sum(
        x["launches"] + x["peer"] for x in e.values())
    check(r["launches"] == 0, f"phase 22 (d)-(e): {r['launches']} copy "
                              f"launches on host payloads")
    r["wall_s"] = time.monotonic() - t_phase
    print(f"plane trace: (d) bulk severed and ring killed on one socket, "
          f"revived in {d['bulk_revive_s']:.3f} s and "
          f"{d['shm_revive_s']:.3f} s; each process's rpc_dump trace holds "
          f"8 < 9 < 10 and 17 < 18 < 19, one handshake a kill, none for "
          f"the healthy call; (e) {RELOC_NATIVE} B and {RELOC_PAYLOAD} B "
          f"DEVICE payloads on the ring delivered host-resident (rank_of "
          f"-1), each forwarded into a call on the peer's native door "
          f"(the first relocated there by device_put, +1; the second, over "
          f"the native window, by the Python plane's transport), their "
          f"slots recycled by later payloads, the callee's bytes equal to "
          f"the first's; 0 failed calls; {r['wall_s']:.1f} s", flush=True)
    return r


def phase_graft_entry(device: str = "cuda") -> dict:
    """Phase 23 (a): the port's dryrun entry (see the module docstring),
    in a fresh interpreter as the reference's dryrun runs (the fabric node
    phase 17 left here would make ranks 0-3 remote).  The child counts
    its own launches, per leg; returns its RESULT."""
    t0 = time.monotonic()
    cmd = [sys.executable, "-m", "brpc_tpu_torch.graft_entry",
           "--n", str(DRYRUN_RANKS)]
    if device != "cuda":
        cmd += ["--device", device]
    proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True,
                          text=True, timeout=DRYRUN_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        print(proc.stdout[-6000:], proc.stderr[-6000:], file=sys.stderr,
              flush=True)
        fail(f"the dryrun ended rc {proc.returncode}")
    out = json.loads(lines[-1][7:])
    for ln in proc.stdout.splitlines():
        if "SKIP" in ln:
            print(ln, flush=True)        # the reference's SKIP lines
    e = out["entry"]
    check(e["device"].startswith(device),
          f"entry() ran on {e['device']}, meant to run on {device}")
    legs = out["legs"]
    rs = legs["rpc_stack"]
    check(rs.get("plane_launches") == rs.get("plane_transfers", -1) > 0,
          f"dryrun rpc stack: p2p_copy launched {rs.get('plane_launches')}"
          f" times for {rs.get('plane_transfers')} plane transfers")
    check(legs["collective_fanout"].get("routes") == ["collective", "rpc"],
          f"dryrun fan-out routes {legs['collective_fanout']}")
    out["launches"] = sum(leg["launches"] for leg in legs.values())
    out["wall_s"] = time.monotonic() - t0
    return out


def _raw_http(port: int, request: bytes) -> bytes:
    import socket as pysocket
    with pysocket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(request)
        data = b""
        while True:
            head, sep, rest = data.partition(b"\r\n\r\n")
            if sep:
                n = [int(line.split(b":")[1]) for line in head.split(b"\r\n")
                     if line.lower().startswith(b"content-length:")]
                if n and len(rest) >= n[0]:
                    return data
            chunk = s.recv(65536)
            if not chunk:
                return data
            data += chunk


def _h2_frames(data: bytes, off: int = 0) -> list:
    out = []
    while off + 9 <= len(data):
        n = int.from_bytes(data[off:off + 3], "big")
        if off + 9 + n > len(data):
            break
        out.append((data[off + 3], data[off + 4],
                    int.from_bytes(data[off + 5:off + 9], "big") & 0x7FFFFFFF,
                    data[off + 9:off + 9 + n]))
        off += 9 + n
    return out


def _h2_exchange(port: int, wire: bytes, stream_id: int,
                 timeout: float = 10.0) -> list:
    """Send ``wire`` on a fresh connection and read frames until
    ``stream_id`` ends (END_STREAM on a DATA or HEADERS frame)."""
    import socket as pysocket
    with pysocket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(wire)
        data = b""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            frames = _h2_frames(data)
            if any(sid == stream_id and flags & 0x1 and ftype in (0, 1)
                   for ftype, flags, sid, _ in frames):
                return frames
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    fail(f"h2 stream {stream_id} did not end within {timeout} s")


def phase_http_grpc() -> dict:
    """Phase 23 (b) and (c): HTTP/1.1, HPACK and gRPC on the port's TCP
    server (see the module docstring).  Host bytes only: no kernel
    launches."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.bthread import scheduler
    from brpc_tpu_torch.policy import grpc as g2
    from brpc_tpu_torch.policy import hpack
    from brpc_tpu_torch.policy.auth import HmacAuthenticator
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc import compress
    from brpc_tpu_torch.rpc.socket import list_sockets
    t_phase = time.monotonic()
    out = {}
    gate = threading.Event()
    entered = []

    class EchoService(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def Slow(self, cntl, request, response, done):
            entered.append(request.message)
            scheduler.note_worker_blocked()
            try:
                gate.wait(float(request.sleep_us or 30e6) / 1e6)
            finally:
                scheduler.note_worker_unblocked()
            response.message = "late"
            done()

    def server(**opts):
        s = rpc.Server(rpc.ServerOptions(**opts))
        s.add_service(EchoService())
        check(s.start("127.0.0.1:0") == 0, "TCP server did not start")
        return s

    chans = []

    def channel(port, **opts):
        ch = rpc.Channel()
        opts.setdefault("timeout_ms", 30000)
        ch.init(f"127.0.0.1:{port}", options=rpc.ChannelOptions(**opts))
        chans.append(ch)
        return ch

    def echo(ch, msg, cntl=None, method="EchoService.Echo"):
        cntl = cntl or rpc.Controller()
        t = time.perf_counter_ns()
        resp = ch.call_method(method, cntl, EchoRequest(message=msg),
                              EchoResponse)
        return cntl, resp, (time.perf_counter_ns() - t) / 1e3

    def timed(ch, msg, n, warm, what):
        lat = []
        for i in range(n + warm):
            cntl, resp, us = echo(ch, msg)
            check(not cntl.failed() and resp.message == msg,
                  f"{what} {i}: {cntl.error_text}")
            if i >= warm:
                lat.append(us)
        return {"calls": n, "p50_us": _pct(lat, 0.5),
                "p99_us": _pct(lat, 0.99)}

    srv = server(internal_port=0)
    public, internal = srv.listen_port, srv.internal_port
    try:
        # HTTP/1.1 JSON-RPC through the port's HTTP client
        out["http_echo"] = timed(channel(public, protocol="http"),
                                 "h" * 64, HTTP_CALLS, 10, "http echo")
        # the pages: on the internal port, refused on the public one
        pages = {}
        for page in ("health", "vars", "status"):
            req = b"GET /%s HTTP/1.1\r\nHost: x\r\n\r\n" % page.encode()
            a, b = _raw_http(internal, req), _raw_http(public, req)
            check(a.startswith(b"HTTP/1.1 200"),
                  f"/{page} on the internal port: {a[:60]!r}")
            check(b.startswith(b"HTTP/1.1 403"),
                  f"/{page} on the public port: {b[:60]!r}")
            pages[page] = {"internal": 200, "public": 403,
                           "bytes": len(a)}
        out["pages"] = pages
        # gRPC unary echoes, 4 KiB and 1 MiB (16 x the 64 KiB window)
        gch = channel(public, protocol="grpc")
        out["grpc_4k"] = timed(gch, "g" * GRPC_SMALL, GRPC_SMALL_CALLS, 10,
                               "grpc 4 KiB echo")
        out["grpc_1m"] = timed(gch, "G" * GRPC_BIG, GRPC_BIG_CALLS, 2,
                               "grpc 1 MiB echo")
        # a 1 ms budget: the client's deadline, and the server's answer to
        # a spent grpc-timeout
        cntl = rpc.Controller()
        cntl.timeout_ms = 1
        cntl.max_retry = 0
        req = EchoRequest(message="d", sleep_us=50_000)
        gch.call_method("EchoService.Slow", cntl, req, EchoResponse)
        check(cntl.error_code == rpc.errors.ERPCTIMEDOUT,
              f"1 ms call: code {cntl.error_code} {cntl.error_text}")
        block = hpack.Encoder(index=False).encode(
            [(b":method", b"POST"), (b":scheme", b"http"),
             (b":path", b"/EchoService/Slow"), (b":authority", b"x"),
             (b"content-type", b"application/grpc"), (b"te", b"trailers"),
             (b"grpc-timeout", b"1m")])
        wire = (g2.PREFACE + g2.frame(g2.FRAME_SETTINGS, 0, 0, b"")
                + g2.frame(g2.FRAME_HEADERS, g2.FLAG_END_HEADERS, 1, block)
                + g2.frame(g2.FRAME_DATA, g2.FLAG_END_STREAM, 1,
                           g2.grpc_message(req.SerializeToString())))
        dec = hpack.Decoder()
        hdrs = {}
        for ftype, _f, sid, payload in _h2_exchange(public, wire, 1):
            if ftype == g2.FRAME_HEADERS and sid == 1:
                hdrs.update(dec.decode(payload))
        check(hdrs.get(b"grpc-status") == b"4",
              f"grpc-timeout 1m: trailers {hdrs}")
        out["deadline"] = {"client_code": cntl.error_code,
                           "server_grpc_status": 4}
        # gzip bodies with an HMAC credential, tpu_std and gRPC
        asrv = server(auth=HmacAuthenticator(AUTH_KEY))
        try:
            comp = {}
            for proto in ("tpu_std", "grpc"):
                for key, ok in ((AUTH_KEY, True), ("wrong", False)):
                    ch = channel(asrv.listen_port, protocol=proto,
                                 auth=HmacAuthenticator(key), max_retry=0)
                    cntl = rpc.Controller()
                    cntl.compress_type = compress.COMPRESS_TYPE_GZIP
                    msg = "compressible " * 4096
                    cntl, resp, _ = echo(ch, msg, cntl)
                    if ok:
                        check(not cntl.failed() and resp.message == msg,
                              f"{proto} gzip + auth: {cntl.error_text}")
                    else:
                        check(cntl.error_code == rpc.errors.ERPCAUTH,
                              f"{proto} wrong key: {cntl.error_code}")
                comp[proto] = {"gzip_ok": True, "wrong_key": "ERPCAUTH"}
            out["gzip_auth"] = comp
        finally:
            asrv.stop()
        # a stop with 8 gRPC calls in flight on its own server
        ssrv = server()
        sch = channel(ssrv.listen_port, protocol="grpc", max_retry=0)
        done, cntls = [], []
        entered.clear()
        for i in range(GOAWAY_CALLS):
            cntl = rpc.Controller()
            cntls.append(cntl)
            sch.call_method("EchoService.Slow", cntl,
                            EchoRequest(message=str(i)), EchoResponse,
                            done=lambda c: done.append(time.monotonic()))
        deadline = time.monotonic() + 10
        while len(entered) < GOAWAY_CALLS and time.monotonic() < deadline:
            time.sleep(0.005)
        socks = [s for s in list_sockets()
                 if getattr(s, "_h2_conn", None) is not None
                 and not s.is_server_side]
        t0 = time.monotonic()
        ssrv.stop()
        while len(done) < GOAWAY_CALLS and time.monotonic() < t0 + 10:
            time.sleep(0.005)
        hung = GOAWAY_CALLS - len(done)
        gate.set()
        goaway = [s._h2_conn.goaway_last_sid for s in socks]
        codes = sorted(c.error_code for c in cntls)
        check(hung == 0, f"stop with gRPC calls in flight: {hung} hung")
        check(any(g is not None for g in goaway),
              f"the client never read a GOAWAY: {goaway}")
        check(all(rpc.Controller._retryable(c) for c in codes),
              f"stop with gRPC calls in flight: codes {codes}")
        out["goaway"] = {"calls": GOAWAY_CALLS, "entered": len(entered),
                         "hung": hung, "last_stream_id": goaway,
                         "codes": codes,
                         "ended_ms": (max(done) - t0) * 1e3}
        gate.clear()
        # /health 503 on the internal port during a drain a held call
        # keeps open
        held = rpc.Controller()
        channel(public).call_method(
            "EchoService.Slow", held, EchoRequest(message="held"),
            EchoResponse, done=lambda c: None)
        deadline = time.monotonic() + 10
        while "held" not in entered and time.monotonic() < deadline:
            time.sleep(0.005)
        get = b"GET /health HTTP/1.1\r\nHost: x\r\n\r\n"
        check(_raw_http(internal, get).startswith(b"HTTP/1.1 200"),
              "/health before the drain")
        stopper = threading.Thread(target=srv.stop, args=(DRAIN_GRACE_S,))
        stopper.start()
        deadline = time.monotonic() + 5
        while not srv.is_draining() and time.monotonic() < deadline:
            time.sleep(0.002)
        during = _raw_http(internal, get)
        gate.set()
        stopper.join(30)
        check(during.startswith(b"HTTP/1.1 503"),
              f"/health during the drain: {during[:60]!r}")
        out["drain_health"] = 503
    finally:
        gate.set()
        for ch in chans:
            ch.close()
        srv.stop()
    # (c) curl's request bytes replayed into the port's server
    fix = ROOT / "tests" / "fixtures"
    c2s = (fix / "h2_curl_c2s.bin").read_bytes()
    s2c = (fix / "h2_curl_s2c.bin").read_bytes()

    class CurlEcho(rpc.Service):
        SERVICE_NAME = "Echo"

        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = "srv:" + request.message
            done()

    csrv = rpc.Server()
    csrv.add_service(CurlEcho())
    check(csrv.start("127.0.0.1:0") == 0, "curl replay server")
    try:
        sent = _h2_frames(c2s, len(g2.PREFACE))
        want = _h2_frames(s2c)
        sent_hdrs = dict(hpack.Decoder().decode(sent[2][3]))
        got = _h2_exchange(csrv.listen_port, c2s, 1)
        dec = hpack.Decoder()
        got_hdrs, body = {}, b""
        for ftype, _f, sid, payload in got:
            if ftype == g2.FRAME_HEADERS and sid == 1:
                got_hdrs.update(dec.decode(payload))
            elif ftype == g2.FRAME_DATA and sid == 1:
                body += payload
        want_hdrs = dict(hpack.Decoder().decode(want[4][3]))
        check(sent[2][2] == sent[3][2] == want[5][2] == 1
              and sent_hdrs[b":path"] == b"/Echo/Echo"
              and json.loads(sent[3][3]) == {"message": "from-curl"},
              "the c2s transcript does not decode to stream 1's request")
        check(got_hdrs.get(b":status") == want_hdrs[b":status"] == b"200"
              and json.loads(body) == json.loads(want[5][3]),
              f"curl replay: {got_hdrs} {body[:80]!r}")
        out["curl_replay"] = {"stream_id": 1,
                              "path": sent_hdrs[b":path"].decode(),
                              "status": got_hdrs[b":status"].decode(),
                              "body": json.loads(body)}
    finally:
        csrv.stop()
    out["wall_s"] = time.monotonic() - t_phase
    return out


def _kv_rows(model, tokens, dev) -> torch.Tensor:
    """A prompt's token-major pool rows (the LoadKv transpose)."""
    n = len(tokens)
    kv = model.toy_kv_blocks(tokens, dev)
    return kv.view(model.KV_LAYERS, n, model.KV_DMODEL).transpose(
        0, 1).reshape(n, model.KV_LAYERS * model.KV_DMODEL).contiguous()


def phase_kv_flags(mesh, plane, p2p_copy, device: str = "cuda",
                   launches=None) -> dict:
    """Phase 24 (a): the KV pool's three A/B flags on card arenas (see the
    module docstring).  Only the LoadKv leg launches p2p_copy, one per
    relocation the ici:// server receives."""
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.examples.disagg_serving import model
    from brpc_tpu_torch.examples.disagg_serving.workers import DecodeService
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.serving import (KvPoolOptions, PagedKvPool,
                                        PoolSaturated)

    launches = launches or (lambda: p2p_copy.launches)
    t_phase = time.monotonic()
    dev = mesh.device(0)
    bpt = model.KV_LAYERS * model.KV_DMODEL
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))
    out = {}

    def pool(blocks, **kw):
        return PagedKvPool(KvPoolOptions(
            bytes_per_token=bpt, num_blocks=blocks, block_tokens=KVF_BLOCK,
            use_timers=False, **kw), device=dev)

    # capacity: prefix sharing on, then off
    pre = [[(7 * j) % 997 for j in range(KVF_PROMPT)],
           [(11 * j + 3) % 997 for j in range(KVF_PROMPT)]]
    rows = {}

    def session(i):
        if i not in rows:
            toks = pre[i % 2] + [(13 * i + j + 1) % 997
                                 for j in range(KVF_TAIL)]
            rows[i] = (toks, _kv_rows(model, toks, dev))
        return rows[i]

    cap = {}
    for share in (True, False):
        flags.set_flag("serving_kv_prefix_share", share)
        p = pool(KVF_CAP_BLOCKS)
        loaded = []
        try:
            while len(loaded) < 4 * KVF_CAP_BLOCKS:
                i = len(loaded)
                toks, r = session(i)
                try:
                    p.load(f"cap{i}", r, last_token=toks[-1])
                except PoolSaturated:
                    break
                check(p.pin(f"cap{i}"), f"kv flags: pin cap{i}")
                loaded.append(i)
            bad = [i for i in loaded
                   if not torch.equal(p.materialize(f"cap{i}"),
                                      session(i)[1])]
            check(not bad, f"kv flags: capacity sessions {bad[:4]} differ "
                           f"(prefix share {share})")
            d = p.describe()["prefix"]
            check((d["shared_blocks"] > 0 and d["prefix_hits"] > 0)
                  if share else
                  (d["shared_blocks"] == 0 and d["prefix_hits"] == 0
                   and d["crc_d2h_passes"] == 0),
                  f"kv flags: prefix block {d} (share {share})")
            cap["on" if share else "off"] = {
                "sessions": len(loaded), "checked": len(loaded),
                "shared_blocks": d["shared_blocks"],
                "sharing_ratio": d["sharing_ratio"],
                "crc_d2h_passes": d["crc_d2h_passes"]}
        finally:
            for i in loaded:
                p.unpin(f"cap{i}")
            p.close()
    flags.set_flag("serving_kv_prefix_share", True)
    cap["ratio"] = cap["on"]["sessions"] / cap["off"]["sessions"]
    check(cap["ratio"] >= 5, f"kv flags: capacity ratio {cap['ratio']}")
    out["capacity"] = cap
    # a parked fill and a second loader: concurrent fill on, then off
    big_toks = [(13 * j) % 997 for j in range(KVF_BIG)]
    big = _kv_rows(model, big_toks, dev)
    probe_toks = [(5 * j + 2) % 997 for j in range(KVF_PROBE)]
    probe = _kv_rows(model, probe_toks, dev)
    fill_out = {}
    for conc in (True, False):
        flags.set_flag("serving_kv_concurrent_fill", conc)
        p = pool(4 * (KVF_BIG // KVF_BLOCK + 1))
        in_fill, unblock = threading.Event(), threading.Event()

        def parked(views):
            off = 0
            for v in views:
                v.copy_(big[off:off + v.shape[0]])
                off += v.shape[0]
            sync()
            in_fill.set()
            unblock.wait(10)

        try:
            ta = threading.Thread(target=lambda: p.load_into(
                "parked", KVF_BIG, parked, last_token=big_toks[-1]))
            ta.start()
            check(in_fill.wait(10), "kv flags: the parked fill never ran")
            timer = threading.Timer(KVF_STALL_S, unblock.set)
            timer.start()
            t0 = time.perf_counter_ns()
            p.load("probe", probe, last_token=probe_toks[-1])
            first_ms = (time.perf_counter_ns() - t0) / 1e6
            unblock.set()
            timer.cancel()
            ta.join(10)
            d = p.describe()["prefix"]
            route = "unlocked_fills" if conc else "locked_fills"
            check(d[route] == 2, f"kv flags: fill routes {d} (conc {conc})")
            check(torch.equal(p.materialize("parked"), big)
                  and torch.equal(p.materialize("probe"), probe),
                  f"kv flags: parked/probe bytes (conc {conc})")
            fill_out["on" if conc else "off"] = {
                "first_completion_ms": first_ms,
                "locked_fills": d["locked_fills"],
                "unlocked_fills": d["unlocked_fills"]}
        finally:
            unblock.set()
            p.close()
    flags.set_flag("serving_kv_concurrent_fill", True)
    check(fill_out["on"]["first_completion_ms"] < 500 * KVF_STALL_S
          <= fill_out["off"]["first_completion_ms"],
          f"kv flags: first completion {fill_out} against a "
          f"{KVF_STALL_S} s stall")
    fill_out["stall_ms"] = KVF_STALL_S * 1e3
    out["concurrent_fill"] = fill_out
    # spill pressure: spill on, then off
    spill_out = {}
    sessions = {}
    for i in range(KVF_SPILL_SESSIONS):
        toks = [(3 * i + 17 * j + 1) % 997 for j in range(KVF_SPILL_SEQ)]
        sessions[f"s{i}"] = toks
    for spill in (True, False):
        flags.set_flag("serving_kv_spill", spill)
        p = pool(KVF_SPILL_BLOCKS, host_blocks=KVF_SPILL_BLOCKS)
        try:
            t0 = time.monotonic()
            for name, toks in sessions.items():
                p.load(name, _kv_rows(model, toks, dev), last_token=toks[-1])
            load_s = time.monotonic() - t0
            spilled = len(p.spilled_sessions())
            tiers = p.describe()["tiers"]
            evicted = p.evictions.get_value()
            live, bad = 0, []
            for name, toks in sessions.items():
                got = p.materialize(name)
                if got is None:
                    continue
                live += 1
                if not torch.equal(got, _kv_rows(model, toks, dev)):
                    bad.append(name)
            check(not bad, f"kv flags: spill sessions {bad} differ")
            spill_out["on" if spill else "off"] = {
                "spilled": spilled, "evicted": evicted,
                "demotions": tiers["demotions"], "live": live,
                "load_s": load_s}
        finally:
            p.close()
    flags.set_flag("serving_kv_spill", True)
    per = KVF_SPILL_BLOCKS // (KVF_SPILL_SEQ // KVF_BLOCK)
    over = KVF_SPILL_SESSIONS - per
    check(spill_out["on"]["spilled"] == over
          and spill_out["on"]["evicted"] == 0
          and spill_out["on"]["live"] == KVF_SPILL_SESSIONS
          and spill_out["off"]["spilled"] == 0
          and spill_out["off"]["evicted"] == over
          and spill_out["off"]["live"] == per,
          f"kv flags: spill A/B {spill_out}")
    out["spill"] = spill_out
    # concurrent identical-prompt LoadKv over ici://6 through the plane
    toks = [(19 * j) % 997 for j in range(KVF_LOAD_SEQ)]
    want = _kv_rows(model, toks, mesh.device(6))
    loads = {"launches": 0, "received": 0}
    for share in (True, False):
        flags.set_flag("serving_kv_prefix_share", share)
        server = rpc.Server()
        svc = DecodeService(6, mesh=mesh, pool_options=KvPoolOptions(
            bytes_per_token=bpt, num_blocks=256, block_tokens=KVF_BLOCK,
            use_timers=False))
        server.add_service(svc)
        check(server.start("ici://6") == 0, "kv flags: ici://6 start")
        ch = rpc.Channel()
        ch.init("ici://6", options=rpc.ChannelOptions(timeout_ms=60000,
                                                      max_retry=0))
        errs = []
        try:
            l0 = launches()

            def load(i):
                cntl = rpc.Controller()
                cntl.request_attachment.append_device_array(
                    mesh.own(model.toy_kv_blocks(toks, mesh.device(1)), 1))
                ch.call_method("Decode.LoadKv", cntl, EchoRequest(
                    message=json.dumps({"session": f"r{i}",
                                        "seq_len": KVF_LOAD_SEQ,
                                        "last_token": toks[-1]})),
                    EchoResponse)
                if cntl.failed():
                    errs.append(cntl.error_text)

            ts = [threading.Thread(target=load, args=(i,))
                  for i in range(KVF_LOADS)]
            t0 = time.monotonic()
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
            wall = time.monotonic() - t0
            sync()
            n = launches() - l0
            check(not errs, f"kv flags: LoadKv failed {errs[:3]}")
            d = svc.pool.describe()["prefix"]
            bad = [i for i in range(KVF_LOADS)
                   if not torch.equal(svc.pool.materialize(f"r{i}"), want)]
            check(not bad, f"kv flags: LoadKv sessions {bad} differ")
            check(n == svc.loadkv_received == KVF_LOADS,
                  f"kv flags: p2p_copy launches {n}, LoadKv relocations "
                  f"received {svc.loadkv_received}")
            check((d["shared_blocks"] == KVF_LOAD_SEQ // KVF_BLOCK)
                  if share else d["shared_blocks"] == 0,
                  f"kv flags: LoadKv prefix block {d} (share {share})")
            loads["launches"] += n
            loads["received"] += svc.loadkv_received
            loads["on" if share else "off"] = {
                "calls": KVF_LOADS, "launches": n, "wall_ms": wall * 1e3,
                "shared_blocks": d["shared_blocks"],
                "physical_blocks": d["physical_blocks"],
                "logical_blocks": d["logical_blocks"]}
        finally:
            ch.close()
            svc.close()
            server.stop()
            server.join()
    flags.set_flag("serving_kv_prefix_share", True)
    out["loadkv"] = loads
    out["launches"] = loads["launches"]
    out["wall_s"] = time.monotonic() - t_phase
    return out


def phase_protocols(calls: int = None, kv_ops: int = None) -> dict:
    """Phase 24 (b): every protocol on one TCP server port, and the golden
    fixture bytes on a raw socket (see the module docstring).  Host bytes
    only: no kernel launches."""
    import socket as pysocket
    from brpc_tpu_torch.tools import multi_protocol as mp
    from brpc_tpu_torch.tools.mini_memcached import MiniMemcached
    from brpc_tpu_torch.rpc.socket import list_sockets

    t_phase = time.monotonic()
    m = mp.port_modules()
    server = mp.start_server(m)
    mc = MiniMemcached().start()

    def raw(port, data, want):
        with pysocket.create_connection(("127.0.0.1", port),
                                        timeout=10) as sk:
            sk.sendall(data)
            got = b""
            while len(got) < want:
                chunk = sk.recv(65536)
                if not chunk:
                    break
                got += chunk
            return got

    try:
        out = mp.drive(m, server.listen_port, mc.port,
                       calls=calls or PROTO_CALLS,
                       payload_bytes=PROTO_PAYLOAD,
                       kv_ops=kv_ops or PROTO_KV_OPS)
        resp_req = (b"*3\r\n$3\r\nSET\r\n$1\r\nk\r\n$1\r\nv\r\n"
                    b"*2\r\n$3\r\nGET\r\n$1\r\nk\r\n"
                    b"*1\r\n$4\r\nPING\r\n")
        resp_want = b"+OK\r\n$1\r\nv\r\n+PONG\r\n"
        got = raw(server.listen_port, resp_req, len(resp_want))
        check(got == resp_want, f"protocols: golden RESP answered {got!r}")
        get = bytes.fromhex("80000003000000000000000300000000"
                            "0000000000000000") + b"foo"
        req = m.memcache.MemcacheRequest()
        req.set("foo", "bar")
        raw(mc.port, req.serialize(), 24)
        hit = bytes.fromhex("81000000040000000000000700000000"
                            "0000000000000000") + b"\x00" * 4 + b"bar"
        got = raw(mc.port, get, len(hit))
        check(got == hit, f"protocols: golden memcache GET answered "
                          f"{got.hex()}")
        out["golden"] = {"resp_bytes": len(resp_want),
                         "memcache_bytes": len(hit)}
    finally:
        mc.stop()
        server.stop()
    deadline = time.monotonic() + 5
    while list_sockets() and time.monotonic() < deadline:
        time.sleep(0.02)
    out["sockets_left"] = len(list_sockets())
    out["wall_s"] = time.monotonic() - t_phase
    return out


# phase 25: TLS, the authenticators, an RTMP relay and trackme (see the
# module docstring).  (a) the echoes in turns, the DEVICE attachments over
# TLS and their size; (b) the auth echoes; (c) the relay's players, the
# stream's seconds, frame rate, keyframe and frame sizes, the AAC frame
# size and rate, the publisher's out chunk size; (d) trackme's interval
# and the time the pings get
TLS_ECHOES, TLS_PAYLOAD = 200, 4096
TLS_DEVICE_CALLS, TLS_DEVICE_BYTES = 16, 4 << 20
AUTH_ECHOES = 200
RTMP_PLAYERS, RTMP_SECONDS, RTMP_FPS = 4, 10, 30
RTMP_KEYFRAME, RTMP_FRAME = 150 << 10, 20 << 10
RTMP_AAC, RTMP_AAC_RATE, RTMP_CHUNK = 384, 43, 4096
TRACKME_WAIT_S = 3.0


def _p50_p99(lat_s) -> dict:
    us = sorted(x * 1e6 for x in lat_s)
    return {"p50_us": _pct(us, 0.50), "p99_us": _pct(us, 0.99),
            "calls": len(us)}


def _tls_contexts(workdir: str):
    import ssl
    key, crt = os.path.join(workdir, "key.pem"), os.path.join(workdir,
                                                              "cert.pem")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-keyout", key, "-out", crt, "-days", "1", "-nodes",
                    "-subj", "/CN=localhost", "-addext",
                    "subjectAltName=DNS:localhost,IP:127.0.0.1"],
                   check=True, capture_output=True, timeout=60)
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(crt, key)
    client_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    client_ctx.load_verify_locations(crt)
    return server_ctx, client_ctx


def _seeded_bytes(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _tls_auth_servers(rpc, EchoRequest, EchoResponse, expected=None,
                      **options):
    """A tpu_std server on 127.0.0.1:0 with Echo.Echo and Echo.Check, which
    compares a request's attachment with ``expected[seed]`` (the bytes made
    from the seed the request names, made before the timed calls)."""
    class Echo(rpc.Service):
        @rpc.method(EchoRequest, EchoResponse)
        def Echo(self, cntl, request, response, done):
            response.message = request.message
            done()

        @rpc.method(EchoRequest, EchoResponse)
        def Check(self, cntl, request, response, done):
            want = expected[int(request.message)]
            got = cntl.request_attachment.to_bytes()
            response.message = "equal" if got == want else \
                f"differ ({len(got)} bytes)"
            done()

    server = rpc.Server(rpc.ServerOptions(**options))
    server.add_service(Echo())
    check(server.start("127.0.0.1:0") == 0, "phase 25: a server did not "
                                            "start")
    return server


def _echo_once(rpc, ch, EchoRequest, EchoResponse, msg, timeout_ms=10000):
    cntl = rpc.Controller()
    cntl.timeout_ms = timeout_ms
    t0 = time.perf_counter()
    resp = ch.call_method("Echo.Echo", cntl, EchoRequest(message=msg),
                          EchoResponse)
    return cntl, resp, time.perf_counter() - t0


def _phase25_tls(rpc, EchoRequest, EchoResponse, device, workdir) -> dict:
    """(a) TLS against plain TCP in turns, DEVICE attachments over TLS, a
    plaintext client refused."""
    server_ctx, client_ctx = _tls_contexts(workdir)
    seeds = [2500 + i for i in range(TLS_DEVICE_CALLS)]
    host = {s: _seeded_bytes(s, TLS_DEVICE_BYTES) for s in seeds}
    expected = {s: a.tobytes() for s, a in host.items()}
    tls_srv = _tls_auth_servers(rpc, EchoRequest, EchoResponse, expected,
                                ssl_context=server_ctx)
    plain_srv = _tls_auth_servers(rpc, EchoRequest, EchoResponse, expected)
    chans = []

    def channel(port, **options):
        ch = rpc.Channel()
        ch.init(f"127.0.0.1:{port}",
                options=rpc.ChannelOptions(timeout_ms=10000, **options))
        chans.append(ch)
        return ch

    out = {}
    try:
        tls_ch = channel(tls_srv.listen_port, ssl_context=client_ctx)
        plain_ch = channel(plain_srv.listen_port)
        msg = "t" * TLS_PAYLOAD
        lat = {"tls": [], "tcp": []}
        for i in range(TLS_ECHOES + 4):           # 2 warm-ups each
            for name, ch in (("tls", tls_ch), ("tcp", plain_ch)):
                cntl, resp, dt = _echo_once(rpc, ch, EchoRequest,
                                            EchoResponse, msg)
                check(not cntl.failed() and resp.message == msg,
                      f"phase 25 (a): {name} echo {i} failed: "
                      f"{cntl.error_text}")
                if i >= 4:
                    lat[name].append(dt)
        out["echo_4k"] = {k: _p50_p99(v) for k, v in lat.items()}
        dev = torch.device(device, 0) if device == "cuda" else \
            torch.device("cpu")
        # the same attachments over TLS and over plain TCP, in turns
        dlat = {"tls": [], "tcp": []}
        for i, seed in enumerate(seeds):
            for name, ch in (("tls", tls_ch), ("tcp", plain_ch)):
                t = torch.from_numpy(host[seed]).to(dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                cntl = rpc.Controller()
                cntl.timeout_ms = 30000
                cntl.request_attachment.append_device_array(t)
                t0 = time.perf_counter()
                resp = ch.call_method("Echo.Check", cntl,
                                      EchoRequest(message=str(seed)),
                                      EchoResponse)
                dlat[name].append(time.perf_counter() - t0)
                check(not cntl.failed() and resp.message == "equal",
                      f"phase 25 (a): DEVICE attachment {i} over {name}: "
                      f"{cntl.error_text or resp.message}")
        out["device_4m"] = {
            name: dict(_p50_p99(v), device=str(dev),
                       mb_per_s=TLS_DEVICE_BYTES * len(v) / sum(v) / 1e6)
            for name, v in dlat.items()}
        bad = channel(tls_srv.listen_port, max_retry=0)
        cntl, _resp, dt = _echo_once(rpc, bad, EchoRequest, EchoResponse,
                                     "plain", timeout_ms=3000)
        check(cntl.failed(), "phase 25 (a): a plaintext client was served "
                             "by the TLS server")
        out["plaintext_refused"] = {"code": cntl.error_code,
                                    "text": cntl.error_text,
                                    "ms": dt * 1e3}
        for i in range(2):
            cntl, resp, _dt = _echo_once(rpc, tls_ch, EchoRequest,
                                         EchoResponse, "after")
            check(not cntl.failed() and resp.message == "after",
                  f"phase 25 (a): a TLS call after the plaintext client "
                  f"failed: {cntl.error_text}")
        out["tls_after_refusal"] = 2
    finally:
        for ch in chans:
            ch.close()
        tls_srv.stop()
        plain_srv.stop()
    return out


def _phase25_auth(rpc, EchoRequest, EchoResponse) -> dict:
    """(b) a token echo against an open one, a wrong token, two redis
    credentials on two connections, memcache SASL right and wrong."""
    from brpc_tpu_torch.policy import auth, memcache, redis
    from brpc_tpu_torch.tools.mini_memcached import MiniMemcached
    from brpc_tpu_torch.rpc import errors
    out = {}
    tok_srv = _tls_auth_servers(rpc, EchoRequest, EchoResponse,
                                auth=auth.TokenAuthenticator("chip-token"))
    open_srv = _tls_auth_servers(rpc, EchoRequest, EchoResponse)
    chans = []

    def channel(port, **options):
        ch = rpc.Channel()
        ch.init(f"127.0.0.1:{port}",
                options=rpc.ChannelOptions(timeout_ms=10000, **options))
        chans.append(ch)
        return ch

    try:
        tok_ch = channel(tok_srv.listen_port,
                         auth=auth.TokenAuthenticator("chip-token"))
        open_ch = channel(open_srv.listen_port)
        lat = {"token": [], "none": []}
        for i in range(AUTH_ECHOES + 4):
            for name, ch in (("token", tok_ch), ("none", open_ch)):
                cntl, resp, dt = _echo_once(rpc, ch, EchoRequest,
                                            EchoResponse, "a" * 4096)
                check(not cntl.failed(), f"phase 25 (b): {name} echo "
                                         f"failed: {cntl.error_text}")
                if i >= 4:
                    lat[name].append(dt)
        out["echo_4k"] = {k: _p50_p99(v) for k, v in lat.items()}
        wrong = channel(tok_srv.listen_port, max_retry=0,
                        auth=auth.TokenAuthenticator("not-it"))
        cntl, _resp, _dt = _echo_once(rpc, wrong, EchoRequest,
                                      EchoResponse, "w")
        check(cntl.error_code == errors.ERPCAUTH,
              f"phase 25 (b): a wrong token gave {cntl.error_code}, not "
              f"ERPCAUTH")
        out["wrong_token_code"] = cntl.error_code
    finally:
        for ch in chans:
            ch.close()
        tok_srv.stop()
        open_srv.stop()

    class Recorder(redis.RedisService):
        def __init__(self):
            super().__init__()
            self.auth_attempts = []
            self.add_handler("AUTH", self._auth)
            self.add_handler("PING", lambda args: redis.RedisReply(
                redis.REPLY_STATUS, "PONG"))

        def _auth(self, args):
            self.auth_attempts.append(bytes(args[0]))
            return redis.RedisReply(redis.REPLY_STATUS, "OK")

    rec = Recorder()
    rsrv = rpc.Server()
    rsrv.add_service(rec)
    check(rsrv.start("127.0.0.1:0") == 0, "phase 25 (b): redis server")
    rchans = []
    try:
        for password in ("a", "b"):
            ch = rpc.Channel()
            ch.init(f"127.0.0.1:{rsrv.listen_port}",
                    options=rpc.ChannelOptions(
                        protocol="redis", timeout_ms=10000,
                        auth=auth.RedisAuthenticator(password)))
            rchans.append(ch)
        for _ in range(2):
            for ch in rchans:
                cntl = rpc.Controller()
                resp = ch.call_method("redis", cntl, ("PING",), None)
                check(not cntl.failed() and resp.reply(0).value == "PONG",
                      f"phase 25 (b): redis PING failed: {cntl.error_text}")
        conns = rpc.SocketMap.instance().stats()[rchans[0]._endpoint]
        check(rec.auth_attempts == [b"a", b"b"] and conns == 2,
              f"phase 25 (b): two redis credentials gave AUTHs "
              f"{rec.auth_attempts} on {conns} connections")
        out["redis"] = {"auths": [a.decode() for a in rec.auth_attempts],
                        "connections": conns}
    finally:
        for ch in rchans:
            ch.close()
        rsrv.stop()

    mc = MiniMemcached(sasl=b"\0user\0pw").start()
    try:
        res = {}
        for name, password in (("right", "pw"), ("wrong", "nope")):
            ch = rpc.Channel()
            ch.init(f"127.0.0.1:{mc.port}", options=rpc.ChannelOptions(
                protocol="memcache", timeout_ms=10000, max_retry=0,
                auth=auth.CouchbaseAuthenticator("user", password)))
            req = memcache.MemcacheRequest()
            req.set("k", b"v")
            req.get("k")
            cntl = rpc.Controller()
            resp = ch.call_method("memcache", cntl, req, None)
            res[name] = cntl.error_code
            if name == "right":
                check(not cntl.failed() and resp.op(1).value == b"v",
                      f"phase 25 (b): memcache with the right SASL "
                      f"credential: {cntl.error_text}")
            ch.close()
        check(res["wrong"] == errors.ERPCAUTH,
              f"phase 25 (b): a wrong SASL credential gave {res['wrong']}")
        out["memcache_sasl"] = res
    finally:
        mc.stop()
    return out


def _rtmp_schedule(seed: int) -> list:
    """The seeded stream: (type, timestamp ms, payload) in send order."""
    from brpc_tpu_torch.policy import rtmp
    rng = np.random.default_rng(seed)
    msgs = []
    for i in range(RTMP_SECONDS * RTMP_FPS):
        size = RTMP_KEYFRAME if i % (2 * RTMP_FPS) == 0 else RTMP_FRAME
        msgs.append((rtmp.MSG_VIDEO, i * 1000 // RTMP_FPS,
                     rng.integers(0, 256, size, dtype=np.uint8).tobytes()))
    for j in range(RTMP_SECONDS * RTMP_AAC_RATE):
        msgs.append((rtmp.MSG_AUDIO, j * 1000 // RTMP_AAC_RATE,
                     rng.integers(0, 256, RTMP_AAC,
                                  dtype=np.uint8).tobytes()))
    msgs.sort(key=lambda m: (m[1], m[0] == rtmp.MSG_AUDIO))
    return msgs


def _rtmp_relay_run(digest: bool, seed: int) -> dict:
    """One publisher and RTMP_PLAYERS players through a relay hub."""
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.policy import rtmp

    class Hub(rtmp.RtmpService):
        def __init__(self):
            self.players = []
            self.lock = threading.Lock()

        def new_stream(self, remote_side, connect_info):
            hub = self

            class Relay(rtmp.RtmpServerStream):
                def on_play(self, name):
                    with hub.lock:
                        hub.players.append(self)
                    return 0

                def on_meta_data(self, meta, name="onMetaData"):
                    for p in list(hub.players):
                        p.send_meta_data(meta, name)

                def on_audio_message(self, timestamp, data):
                    for p in list(hub.players):
                        p.send_audio_message(data, timestamp)

                def on_video_message(self, timestamp, data):
                    for p in list(hub.players):
                        p.send_video_message(data, timestamp)
            return Relay()

    class Player(rtmp.RtmpClientStream):
        def __init__(self, want):
            super().__init__()
            self.got = []
            self.meta = []
            self.want = want
            self.done = threading.Event()

        def _add(self, mtype, ts, data):
            self.got.append((mtype, ts, data, time.monotonic_ns()))
            if len(self.got) >= self.want:
                self.done.set()

        def on_meta_data(self, meta, name="onMetaData"):
            self.meta.append(dict(meta))

        def on_audio_message(self, timestamp, data):
            self._add(rtmp.MSG_AUDIO, timestamp, data)

        def on_video_message(self, timestamp, data):
            self._add(rtmp.MSG_VIDEO, timestamp, data)

    flags.set_flag("rtmp_client_digest", digest)
    hub = Hub()
    server = rpc.Server()
    check(server.add_service(hub) == 0, "phase 25 (c): RtmpService")
    check(server.start("127.0.0.1:0") == 0, "phase 25 (c): relay start")
    addr = f"127.0.0.1:{server.listen_port}"
    msgs = _rtmp_schedule(seed)
    clients = []
    try:
        players = []
        for _ in range(RTMP_PLAYERS):
            c = rtmp.RtmpClient(addr)
            clients.append(c)
            p = Player(len(msgs))
            c.create_stream(p)
            check(p.play("live") == 0, "phase 25 (c): play refused")
            players.append(p)
        pub_client = rtmp.RtmpClient(addr)
        clients.append(pub_client)
        pub = pub_client.create_stream()
        check(pub.publish("live") == 0, "phase 25 (c): publish refused")
        pub_client._conn.set_out_chunk_size(RTMP_CHUNK)
        meta = {"width": 1920.0, "height": 1080.0,
                "framerate": float(RTMP_FPS), "videocodecid": 7.0,
                "audiocodecid": 10.0, "audiosamplerate": 44100.0}
        pub.send_meta_data(meta)
        sent = []
        t0 = time.monotonic_ns()
        for mtype, ts, body in msgs:
            body = time.monotonic_ns().to_bytes(8, "big") + body[8:]
            sent.append((mtype, ts, body))
            rc = (pub.send_video_message(body, ts)
                  if mtype == rtmp.MSG_VIDEO
                  else pub.send_audio_message(body, ts))
            check(rc == 0, f"phase 25 (c): publisher send failed: {rc}")
        t_sent = time.monotonic_ns()
        for i, p in enumerate(players):
            check(p.done.wait(60), f"phase 25 (c): player {i} got "
                                   f"{len(p.got)} of {len(sent)} messages")
        per_player, lat = [], []
        total_bytes = sum(len(b) for _, _, b in sent)
        for i, p in enumerate(players):
            check([g[:3] for g in p.got] == sent,
                  f"phase 25 (c): player {i}'s stream differs from the "
                  f"publisher's (order or bytes)")
            check(p.meta and p.meta[0] == meta,
                  f"phase 25 (c): player {i}'s onMetaData {p.meta}")
            span_s = (p.got[-1][3] - t0) / 1e9
            per_player.append({"msgs_per_s": len(p.got) / span_s,
                               "mb_per_s": total_bytes / span_s / 1e6})
            lat += [(g[3] - int.from_bytes(g[2][:8], "big")) / 1e6
                    for g in p.got]
        lat.sort()
        out = {"digest": digest, "messages": len(sent) + 1,
               "video": sum(1 for m in sent if m[0] == rtmp.MSG_VIDEO),
               "audio": sum(1 for m in sent if m[0] == rtmp.MSG_AUDIO),
               "bytes": total_bytes, "publish_s": (t_sent - t0) / 1e9,
               "players": per_player,
               "one_way_ms": {"p50": _pct(lat, 0.50),
                              "p99": _pct(lat, 0.99)}}
        return out, players[0], meta
    finally:
        for c in clients:
            c.stop()
        server.stop()
        flags.set_flag("rtmp_client_digest", False)


def _phase25_media(player, meta) -> dict:
    """(c)'s received stream to FLV and back, and muxed to TS."""
    from brpc_tpu_torch.policy import flv, rtmp, ts
    w = flv.FlvWriter()
    w.write_meta_data(meta)
    for mtype, t, data, _ in player.got:
        (w.write_video if mtype == rtmp.MSG_VIDEO else w.write_audio)(t,
                                                                      data)
    raw = w.buf.to_bytes()
    r = flv.FlvReader(raw)
    tags = list(r)
    name, meta_back = r.read_meta_data(tags[0][2])
    check(name == "onMetaData" and meta_back == meta
          and [(ty, t, d) for ty, t, d in tags[1:]]
          == [(g[0], g[1], g[2]) for g in player.got],
          "phase 25 (c): the FLV file did not read back equal")
    mux = ts.TsMuxer()
    for mtype, t, data, _ in player.got:
        if mtype == rtmp.MSG_VIDEO:
            mux.write_video(t * 90, b"\x00\x00\x00\x01\x65" + data)
        else:
            mux.write_audio(t * 90, b"\xff\xf1" + data)
    out_ts = mux.buf.to_bytes()
    check(len(out_ts) % ts.TS_PACKET_SIZE == 0,
          f"phase 25 (c): TS length {len(out_ts)} is no multiple of 188")
    last, steps = {}, 0
    for off in range(0, len(out_ts), ts.TS_PACKET_SIZE):
        p = out_ts[off:off + ts.TS_PACKET_SIZE]
        check(p[0] == 0x47, "phase 25 (c): a TS packet lacks its sync byte")
        pid, cc = ((p[1] & 0x1F) << 8) | p[2], p[3] & 0xF
        if pid in last:
            check(cc == (last[pid] + 1) & 0xF,
                  f"phase 25 (c): PID {pid}'s continuity counter went "
                  f"{last[pid]} -> {cc}")
            steps += 1
        last[pid] = cc
    return {"flv_bytes": len(raw), "flv_tags": len(tags),
            "ts_bytes": len(out_ts),
            "ts_packets": len(out_ts) // ts.TS_PACKET_SIZE,
            "ts_cc_steps": steps}


def _phase25_trackme() -> dict:
    """(d) an app server pings a TrackMeService hub every second."""
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.proto.trackme_pb2 import TRACKME_WARNING
    from brpc_tpu_torch.rpc import trackme
    from brpc_tpu_torch.tools.trackme_server import TrackMeService
    svc = TrackMeService()
    svc.add_bulletin(0, 10 ** 9, TRACKME_WARNING, "chip smoke bulletin")
    hub = rpc.Server()
    hub.add_service(svc)
    check(hub.start("127.0.0.1:0") == 0, "phase 25 (d): hub start")
    flags.set_flag("trackme_server", f"127.0.0.1:{hub.listen_port}")
    flags.set_flag("trackme_interval", 1)
    app = rpc.Server()
    try:
        t0 = time.monotonic()
        check(app.start("127.0.0.1:0") == 0, "phase 25 (d): app start")
        while (sum(svc.version_counts().values()) < 2
               and time.monotonic() - t0 < TRACKME_WAIT_S):
            time.sleep(0.02)
        pings = sum(svc.version_counts().values())
        within = time.monotonic() - t0
        check(pings >= 2, f"phase 25 (d): {pings} pings in "
                          f"{TRACKME_WAIT_S} s")
        check(trackme.last_bulletin() == (TRACKME_WARNING,
                                          "chip smoke bulletin"),
              f"phase 25 (d): bulletin seen {trackme.last_bulletin()}")
        trackme.stop_trackme()
        time.sleep(0.2)
        frozen = sum(svc.version_counts().values())
        time.sleep(1.5)
        after = sum(svc.version_counts().values())
        check(after == frozen, f"phase 25 (d): pings went on after "
                               f"stop_trackme ({frozen} -> {after})")
        return {"pings": pings, "first_two_s": within,
                "versions": {str(k): v for k, v in
                             svc.version_counts().items()},
                "after_stop": after - frozen}
    finally:
        trackme.stop_trackme()
        flags.set_flag("trackme_server", "")
        flags.set_flag("trackme_interval", 30)
        app.stop()
        hub.stop()


def phase_tls_auth_media(device: str = "cuda") -> dict:
    """Phase 25: TLS, the authenticators, the RTMP relay with FLV and TS,
    and trackme, all on TCP in this process (see the module docstring).
    Host bytes only: no kernel launches."""
    import tempfile
    import brpc_tpu_torch.policy  # noqa: F401
    from brpc_tpu_torch import rpc
    from brpc_tpu_torch.proto.echo_pb2 import EchoRequest, EchoResponse
    from brpc_tpu_torch.rpc.socket import list_sockets
    t_phase = time.monotonic()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tls_") as workdir:
        t0 = time.monotonic()
        out["a"] = _phase25_tls(rpc, EchoRequest, EchoResponse, device,
                                workdir)
        out["a"]["wall_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    out["b"] = _phase25_auth(rpc, EchoRequest, EchoResponse)
    out["b"]["wall_s"] = time.monotonic() - t0
    out["c"] = {}
    for digest in (False, True):
        t0 = time.monotonic()
        run, player, meta = _rtmp_relay_run(digest, seed=25)
        run["wall_s"] = time.monotonic() - t0
        out["c"]["digest" if digest else "simple"] = run
    out["c"]["media"] = _phase25_media(player, meta)
    t0 = time.monotonic()
    out["d"] = _phase25_trackme()
    out["d"]["wall_s"] = time.monotonic() - t0
    deadline = time.monotonic() + 5
    while list_sockets() and time.monotonic() < deadline:
        time.sleep(0.02)
    out["sockets_left"] = len(list_sockets())
    out["wall_s"] = time.monotonic() - t_phase
    return out


def phase25_summary(p25: dict) -> str:
    """Phase 25's one-line summary."""
    a, b, c, d = p25["a"], p25["b"], p25["c"], p25["d"]
    echo, dev = a["echo_4k"], a["device_4m"]
    rtmp = "; ".join(
        f"{k}: {r['messages']} messages, per player "
        f"{[round(x['msgs_per_s'], 1) for x in r['players']]} msg/s "
        f"{[round(x['mb_per_s'], 2) for x in r['players']]} MB/s, one-way "
        f"p50/p99 {r['one_way_ms']['p50']:.3f}/{r['one_way_ms']['p99']:.3f}"
        f" ms" for k, r in c.items() if k != "media")
    return (f"tls/auth/rtmp/trackme: 4 KiB echo p50/p99 TLS "
            f"{echo['tls']['p50_us']:.1f}/{echo['tls']['p99_us']:.1f} us, "
            f"TCP {echo['tcp']['p50_us']:.1f}/{echo['tcp']['p99_us']:.1f} "
            f"us; 4 MiB DEVICE p50 TLS {dev['tls']['p50_us'] / 1e3:.2f} ms "
            f"({dev['tls']['mb_per_s']:.1f} MB/s), TCP "
            f"{dev['tcp']['p50_us'] / 1e3:.2f} ms "
            f"({dev['tcp']['mb_per_s']:.1f} MB/s); plaintext client "
            f"refused with {a['plaintext_refused']['code']}; token echo "
            f"p50 {b['echo_4k']['token']['p50_us']:.1f} us, none "
            f"{b['echo_4k']['none']['p50_us']:.1f} us; wrong token "
            f"{b['wrong_token_code']}; redis AUTHs {b['redis']['auths']} on "
            f"{b['redis']['connections']} connections; memcache SASL "
            f"{b['memcache_sasl']}; rtmp {rtmp}; FLV {c['media']['flv_tags']}"
            f" tags, TS {c['media']['ts_packets']} packets; trackme "
            f"{d['pings']} pings in {d['first_two_s']:.2f} s; "
            f"{p25['wall_s']:.1f} s")


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
            # phase 20's bulk conn and shm ring, the same way
            core["fabric"] = str(native_core.build(
                "fabric_native", native_core.FABRIC_SOURCES))
        except Exception as e:
            core["error"] = f"{type(e).__name__}: {e}"
        core["s"] = time.monotonic() - t0

    core_thread = threading.Thread(target=build_core)
    core_thread.start()
    empty = empty_kernel()
    from brpc_tpu_torch.ici import ipc_pull
    builds = build_all(kernels_all + [empty, ipc_pull.ipc_lib])
    core_thread.join()
    check("error" not in core, f"native ici core build failed: "
                               f"{core.get('error')}")
    check(native_core.load() is not None,
          f"native ici core did not load: {native_core.load_error()}")
    check(native_core.load_fabric() is not None,
          f"the bulk-and-shm library did not load: "
          f"{native_core.fabric_load_error()}")
    builds["ici_native + fabric_native (g++)"] = core["s"]
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

    # 17. the two-process fabric and TCP, with the counts zeroed just
    # before them
    zero_counts()
    fab = phase_fabric(mesh, plane, p2p_copy)
    launches = {k.name: k.launches for k in kernels_all}
    check(launches["p2p_copy"] == fab["launches"] > 0,
          f"the fabric path launched p2p_copy {launches['p2p_copy']} times, "
          f"its own count {fab['launches']}")
    check(launches["ring_all_reduce"] == 0
          and launches["ring_all_gather"] == 0,
          "a ring kernel launched on the fabric path")
    print("fabric: " + json.dumps(fab), flush=True)

    # 18. the pod: its members count their own launches from just before
    # their traffic; this process launches nothing
    zero_counts()
    pod = phase_pod()
    launches = {k.name: k.launches for k in kernels_all}
    check(all(v == 0 for v in launches.values()),
          f"a kernel launched in the driving process during the pod "
          f"phase: {launches}")
    check(pod["launches"] > 0, "the pod path never launched p2p_copy")
    print("pod: " + json.dumps({k: v for k, v in pod.items()
                                if k != "members"}), flush=True)

    # 19. the compiled fan-out's cross-process leg: the members count
    # their own launches; this process launches nothing
    zero_counts()
    xproc = phase_fanout_xproc(
        local_p50_us=slice7["fanout_collective"]["a"]["collective"]["p50_us"])
    launches = {k.name: k.launches for k in kernels_all}
    check(all(v == 0 for v in launches.values()),
          f"a kernel launched in the driving process during phase 19: "
          f"{launches}")
    check(xproc["launches"] > 0, "the fan-out leg never launched p2p_copy")
    print("fanout_xproc: " + json.dumps(xproc), flush=True)

    # 20. the same-host tiers: the member process counts its own launches
    # (and its peer's); this process launches nothing
    zero_counts()
    tiers20 = phase_tiers()
    launches = {k.name: k.launches for k in kernels_all}
    check(all(v == 0 for v in launches.values()),
          f"a kernel launched in the driving process during phase 20: "
          f"{launches}")
    print("tiers: " + json.dumps(tiers20), flush=True)

    # 21. the native TCP datapath (host only: no kernel), kind 1 (its
    # member process and the member's peer count their own launches), and
    # the KV loader's routes (the in-process leg's two relocations launch
    # here, the two-process leg's DEVICE session in the decode process)
    zero_counts()
    ntcp = phase_native_tcp()
    xfer = phase_xfer()
    launches = {k.name: k.launches for k in kernels_all}
    check(all(v == 0 for v in launches.values()),
          f"a kernel launched in the driving process during phase 21 "
          f"(a)-(b): {launches}")
    kvr = phase_kv_routes(mesh, plane, p2p_copy)
    launches = {k.name: k.launches for k in kernels_all}
    check(launches["p2p_copy"] == kvr["launches"]
          and launches["ring_all_reduce"] == 0
          and launches["ring_all_gather"] == 0,
          f"phase 21 (c): launches {launches}, the leg's own count "
          f"{kvr['launches']}")
    e = xfer["echo"]
    print(f"kind 1 against kind 4 at 4 KiB: p50 {e['4k']['p50_us']:.1f} us "
          f"(p99 {e['4k']['p99_us']:.1f}), 64 KiB p50 "
          f"{e['64k']['p50_us']:.1f} us (p99 {e['64k']['p99_us']:.1f}); "
          f"phase 17's kind-4 p50 at 4 KiB {fab['echo']['p50_us_4k']:.1f} "
          f"us", flush=True)
    print("native_tcp: " + json.dumps(ntcp), flush=True)
    print("xfer: " + json.dumps(xfer), flush=True)
    print("kv_routes: " + json.dumps(kvr), flush=True)
    phase21 = {"xfer": xfer["launches"] + xfer["peer"]["launches"],
               "kv_routes": kvr["launches"],
               "kv_routes_2proc": kvr["two_process"]["launches"]}

    # 22. remote naming (in this process, the counts zeroed just before
    # it), then the plane-frame trace and the host-delivered relocation
    # (a member process and its peer count their own launches)
    zero_counts()
    rnaming = phase_remote_naming(mesh, plane, p2p_copy)
    launches = {k.name: k.launches for k in kernels_all}
    check(launches["p2p_copy"] == rnaming["launches"]
          == rnaming["transfers"] > 0
          and launches["ring_all_reduce"] == 0
          and launches["ring_all_gather"] == 0,
          f"phase 22 (a)-(c): launches {launches}, the legs' own count "
          f"{rnaming['launches']}, transfers {rnaming['transfers']}")
    zero_counts()
    trace = phase_plane_trace()
    launches = {k.name: k.launches for k in kernels_all}
    check(all(v == 0 for v in launches.values()),
          f"a kernel launched in the driving process during phase 22 "
          f"(d)-(e): {launches}")
    print("remote_naming: " + json.dumps(rnaming), flush=True)
    print("plane_trace: " + json.dumps(
        {k: v for k, v in trace.items() if k != "d"}
        | {"d": {k: v for k, v in trace["d"].items() if "trace" not in k},
           "trace_records": [len(trace["d"]["member_trace"]),
                             len(trace["d"]["peer_trace"])]}), flush=True)
    phase22 = {"naming_remotefile": rnaming["a"]["launches"],
               "naming_consul_tcp": rnaming["b"]["launches"],
               "naming_nacos_discovery_dns": rnaming["c"]["launches"],
               "plane_trace": trace["d"]["launches"] + trace["d"]["peer"],
               "host_relocation": sum(x["launches"] + x["peer"]
                                      for x in trace["e"].values())}

    # 23. the dryrun entry in a process of its own, which counts its own
    # launches (its children count theirs), then HTTP/1.1, HPACK and
    # gRPC: host bytes only; this process launches nothing
    zero_counts()
    dry = phase_graft_entry()
    web = phase_http_grpc()
    launches = {k.name: k.launches for k in kernels_all}
    check(all(v == 0 for v in launches.values()),
          f"a kernel launched in the driving process during phase 23: "
          f"{launches}")
    check(dry["launches"] > 0, "the dryrun never launched p2p_copy")
    for name, leg in dry["legs"].items():
        print(f"dryrun {name}: {leg['wall_s']:.3f} s, {leg['launches']} "
              f"p2p_copy launches in the dryrun's process"
              + (f", {leg['child_launches']} in its child"
                 if "child_launches" in leg else "")
              + (f", {leg['member_launches']} in its members"
                 if "member_launches" in leg else ""), flush=True)
    print(f"http/grpc: HTTP echo p50 {web['http_echo']['p50_us']:.1f} us "
          f"(p99 {web['http_echo']['p99_us']:.1f}); gRPC 4 KiB p50 "
          f"{web['grpc_4k']['p50_us']:.1f} us (p99 "
          f"{web['grpc_4k']['p99_us']:.1f}), 1 MiB p50 "
          f"{web['grpc_1m']['p50_us']:.1f} us (p99 "
          f"{web['grpc_1m']['p99_us']:.1f}); stop with "
          f"{web['goaway']['calls']} calls in flight: "
          f"{web['goaway']['hung']} hung, codes {web['goaway']['codes']}",
          flush=True)
    print("graft_entry: " + json.dumps(dry), flush=True)
    print("http_grpc: " + json.dumps(web), flush=True)

    # 24. (a) the KV flags on the card, with the counts zeroed just before
    # them: the LoadKv relocations launch p2p_copy here; (b) the protocols
    # on one TCP port: host bytes only, this process launches nothing
    zero_counts()
    kvf = phase_kv_flags(mesh, plane, p2p_copy)
    launches = {k.name: k.launches for k in kernels_all}
    check(launches["p2p_copy"] == kvf["launches"]
          == kvf["loadkv"]["received"] > 0
          and launches["ring_all_reduce"] == 0
          and launches["ring_all_gather"] == 0,
          f"phase 24 (a): launches {launches}, LoadKv relocations "
          f"received {kvf['loadkv']['received']}")
    zero_counts()
    protos = phase_protocols()
    launches = {k.name: k.launches for k in kernels_all}
    check(all(v == 0 for v in launches.values()),
          f"a kernel launched in the driving process during phase 24 (b): "
          f"{launches}")
    c, f, sp = kvf["capacity"], kvf["concurrent_fill"], kvf["spill"]
    print(f"kv flags: capacity {c['on']['sessions']} sessions with prefix "
          f"sharing on, {c['off']['sessions']} off (ratio "
          f"{c['ratio']:.2f}); first completion behind a parked fill "
          f"{f['on']['first_completion_ms']:.3f} ms concurrent, "
          f"{f['off']['first_completion_ms']:.3f} ms locked; spill on: "
          f"{sp['on']['spilled']} spilled, {sp['on']['evicted']} evicted; "
          f"spill off: {sp['off']['spilled']} spilled, "
          f"{sp['off']['evicted']} evicted; LoadKv relocations "
          f"{kvf['loadkv']['received']} = p2p_copy launches "
          f"{kvf['launches']}; {kvf['wall_s']:.1f} s", flush=True)
    print("protocols p50/p99 us: " + ", ".join(
        f"{k} {v['p50_us']:.1f}/{v['p99_us']:.1f}"
        for k, v in protos.items() if isinstance(v, dict)
        and "p50_us" in v) + f"; {protos['wall_s']:.1f} s", flush=True)
    print("kv_flags: " + json.dumps(kvf), flush=True)
    print("protocols: " + json.dumps(protos), flush=True)

    # 25. TLS, the authenticators, the RTMP relay with FLV and TS, and
    # trackme: TCP host bytes only (a DEVICE attachment crosses TLS as
    # host bytes), so this process launches nothing
    zero_counts()
    p25 = phase_tls_auth_media()
    launches = {k.name: k.launches for k in kernels_all}
    check(all(v == 0 for v in launches.values()),
          f"a kernel launched in the driving process during phase 25: "
          f"{launches}")
    check(p25["sockets_left"] == 0,
          f"phase 25 left {p25['sockets_left']} sockets open")
    print(phase25_summary(p25), flush=True)
    print("phase 25: " + json.dumps(p25), flush=True)

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
                     + native_adm["launches"] + fab["launches"]
                     + pod["launches"] + xproc["launches"]
                     + tiers20["launches"] + sum(phase21.values())
                     + sum(phase22.values()) + dry["launches"]
                     + kvf["launches"]),
        "launches_by_path": {"echo": main_launches,
                             "serving": serve["launches"],
                             "migration": tiers["launches"], **phase10,
                             **{k: r["launches"]
                                for k, r in slice6.items()},
                             **{k: r["launches"]
                                for k, r in slice7.items()},
                             "call_features": calls["launches"],
                             "native": native["launches"],
                             "native_overload": native_adm["launches"],
                             "fabric": fab["launches"],
                             **{f"pod_{k}": v for k, v in
                                pod["launches_by_scenario"].items()},
                             "fanout_xproc": xproc["launches"],
                             "tiers": tiers20["launches"], **phase21,
                             **phase22, "dryrun": dry["launches"],
                             "kv_flags_loadkv": kvf["launches"]},
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
