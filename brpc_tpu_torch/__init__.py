"""brpc_tpu_torch — the ici:// RPC fabric on PyTorch and CUDA.

The port of :mod:`brpc_tpu` (the JAX package, which stays the reference)
to an NVIDIA Hopper card.  It imports nothing of JAX and nothing of
``brpc_tpu``.  Layer map of slices 1-7:

  L6  serving      brpc_tpu_torch.serving: PagedKvPool (KV arenas on the
                   card), ContinuousBatchScheduler (the batched decode
                   step on the card), the KV handoff's fill, the
                   load-aware router; examples.disagg_serving (prefill,
                   decode and router services, the toy model, the
                   demo); the pool's host tier, live migration, the
                   autoscaler
  L5  API          brpc_tpu_torch.rpc.Server (admission, limits, the
                   usercode pool, the lame-duck stop) / Channel (one
                   endpoint or a naming url and a balancer, the
                   circuit-breaker gate) / Controller; streams and the
                   progressive reader (rpc.stream, rpc.progressive);
                   brpc_tpu_torch.channels: ParallelChannel,
                   PartitionChannel, DynamicPartitionChannel,
                   SelectiveChannel, the compiled collective fan-out
                   they try first (Server.register_collective), and
                   CollectiveChannel (combo channels lowered to mesh
                   collectives); the builtin admin pages as RPC
                   services (rpc.builtin) and rpcz spans (rpc.span)
  L4  policies     brpc_tpu_torch.policy.tpu_std (the framed protocol,
                   request context, the stream handshake and trace ids
                   on the wire, the server's gates and its five stage
                   recorders), load_balancers (every strategy
                   of create_load_balancer), naming (list://, file://,
                   mesh://), limiters
  L3  core runtime brpc_tpu_torch.rpc.* Socket, InputMessenger, SocketMap,
                   the mem:// loopback transport;
                   brpc_tpu_torch.ici.* mesh of logical ranks, ici://
                   transport, device plane, the p2p_copy kernel;
                   sharded layout, Collectives, ring pipelines, ring and
                   Ulysses attention, the ring_all_reduce and
                   ring_all_gather kernels
  L2  scheduling   brpc_tpu_torch.bthread.* tasklets, butex, correlation
                   ids, timer thread, CUDA-event completion waits,
                   ExecutionQueue
  L1  base         brpc_tpu_torch.butil.* IOBuf (device-block capable),
                   ResourcePool, EndPoint, flags, logging, fast_rand;
                   brpc_tpu_torch.bvar (the expose registry, reducers,
                   windows, latency recorders, families, the collector,
                   the default variables)
"""
__version__ = "0.1.0"
