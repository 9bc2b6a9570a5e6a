#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``minisched_tpu_torch``).

Run from the root of the repository on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing catches it):

1. Build the hand-written kernels from ``minisched_tpu_torch/csrc`` and
   print the build time and the card's name and power limit.
2. Hold each kernel against its plain PyTorch twin on the card, bit for
   bit (tolerance 0: the outputs are integers), on random and tie-heavy
   scores, a row with no feasible node, seeds near 2**32, P=1, a ragged
   N=300 and the main-path shape P=8,192 x N=10,112; for ``select_hosts``
   also the edge rows of ``kernel_cases.select_case`` at every N of
   ``SELECT_NS`` with P odd and planes at a 1-element offset; for the
   fused kernel every toleration form of ``kernel_cases`` with garbage
   past ``num_tols``, invalid rows, one and several node tiles, and
   match scores of 0 and below.
3. Schedule the headline cluster (10,000 nodes, 20% cordoned, seed 1234;
   100,000 pods in waves of 8,192) through ``schedule_waves`` on the
   fused route and compare all 100,000 choices with ``headline_oracle``.
4. The same through the generic route: equal choices, and final node
   tables equal column for column.
5. Time each kernel per wave at the main-path shape beside its plain
   twin and its bound: the kernel as a CUDA graph of 20 calls (device
   time, no host launch cost), also launched one by one for comparison;
   the twin eagerly, two calls between events; medians over batches.  The fused kernel is timed as its whole entry
   point, one launch that evaluates ``tolerates_unschedulable`` itself.
   ``select_hosts`` is also timed at the repair route's shape (16,384 x
   10,112, round 1 of config 5's wave 0).
6. Config 5 at full size (10,000 nodes, 20% cordoned, seed 55; 100,000
   pods of 500m and 256 Mi, 2% with a node selector no node matches) in
   repair waves of 16,384 through ``fullchain.schedule_repair_waves`` with
   the node-local roster, then an audit in numpy on the host: the final
   table equals the initial one plus a recount from the choices, no node
   is over its allocatable, no pod sits on a cordoned node, no
   ``special*`` pod is placed, every unplaced plain pod fits no node; and
   98,000 pods placed, no wave at the 16-round cap.
7. A reduced config 5 (``C5_REDUCED``: 2,000 nodes, 10,000 pods, waves
   of 4,096) on the card and on the CPU twins: equal choices, rounds per wave,
   unschedulable masks and final tables.
8. Config 5 at full size again, with the full default roster (15
   filters, 7 scores; each wave's constraint tables built on the host
   from the placements so far): phase 6's audit, and choices, rounds and
   final node table equal to phase 6's node-local run.  Printed beside
   phase 6: the schedule wall, the host constraint build, device ms per
   round (one profiled pass of each roster, ``profile_repair``) and
   ``select_hosts`` launches.  Then config 5 once more with kubelet's
   labels, every node its own ``kubernetes.io/hostname`` (10,000 node
   label sets instead of 16): the audit, and choices, rounds and final
   resource columns equal to phase 6's; printed: the schedule wall and
   the peak device memory beside phase 8's.
9. Config 4 at its own size (``fullchain.mk_c4_cluster``: 2,048 nodes,
   512 assigned pods, 2,048 pods with required zone pod affinity and a
   ScheduleAnyway zone spread) through ``FusedEvaluator([NodeUnschedulable,
   InterPodAffinity, PodTopologySpread], [], [InterPodAffinity,
   PodTopologySpread])`` at the default weights, as ``bench.py``: card and
   CPU twins give equal choices; printed: pods placed, the wave's ms (best
   of 3) and the host table builds.
10. ``fullchain.mk_mixed_cluster`` (2,048 nodes, each its own hostname,
   4,800 assigned pods, ``MIXED_PODS`` (6,144; 8,192 until phase 35)
   pods with every feature of the full roster,
   a zone domain sum above 4,096) in full-roster repair waves of 4,096,
   on the card and on
   the CPU twins: equal choices, rounds, unschedulable masks, final node
   tables and carried volume planes (``vol_any``, ``vol_rw``,
   ``node_vols_fam``) of every wave.

11. Config 3 (``fullchain.mk_c3_cluster``: 4,096 nodes of 4 or 8 CPU,
   4,096 pods of 500m, 1 or 2 CPU, ``random.Random(3)``) through
   ``SequentialScheduler([NodeUnschedulable, NodeResourcesFit], [],
   [NodeResourcesLeastAllocated])``, the exact scan as CUDA-graph
   replays: every placement equal to ``FullRosterScanOracle`` (Fit +
   LeastAllocated), and the card equal to the CPU twins on the first 256
   pods (pod i depends only on the pods before it).
12. Config 5 with the full default roster through the exact scan
   (``fullchain.schedule_scan``, chunks of 1,024, ``scan_planes`` tables):
   10,000 nodes, the first 2,096 plain pods of config 5 and all 2,000
   ``special*`` pods after them (``C5_SCAN_PLAIN``: 4 chunks; with all
   100,000 pods the whole script took 1,131 s of its 1,200 on an H100
   80GB HBM3 at 700 W, and with 30,768 plain pods and phase 29 1,100-
   1,296 s); every placement equal to
   ``fullchain_scan_oracle``, every ``special*`` pod unplaced, the card
   equal to the CPU twins on the first 64 pods.
13. Config 5 with 5,000 spread pods (``mk_c5_cluster(n_crosspod=5_000)``):
   the plain and special pods in full-roster repair waves, then the
   spread pods through the blocked lane (``fullchain.schedule_crosspod``);
   phase 6's audit over every pod, ``bench.py``'s spread audit (per app,
   pods per eligible zone within max skew 4); then the same at 1,520
   nodes, 20,000 pods and 1,000 spread pods on the card and on the CPU
   twins: equal choices, every call's accepted mask, attempts, exact-lane
   leftovers and final tables.  At 1,520 nodes the plain pods leave about
   one free slot a node, so the spread pods race for them and the lane
   retries (at least 2 attempts, checked).
   For 11-13 it prints the scan wall and pods/s, the steps (blocks)
   replayed, device ms a step (CUDA events around the replays), device
   operations a step (one replay under the profiler), ``select_hosts``
   launches recorded a step, the capture time and the peak device
   memory; for 13 also the blocks, attempts and leftovers.  Phases 8,
   10, 12 and 13 print the host constraint build, which each feed makes
   from one ``ConstraintIndex``.
14. Config 5 with gangs (``fullchain.mk_c5_gang_cluster``: config 5's
   nodes on 625 slices of 16 hosts, even slices with ring dimensions;
   4,096 gangs of 8, a quarter of them with 4 members already bound;
   100,000 pending pods, each gang's pending members together) in repair
   waves of 16,384 with ``gang_roster_config``: phase 6's audit over
   every pod; each wave's gang view and gang columns equal those built
   from ``engine.gang.gang_view_from_infos`` on a snapshot of the
   placements so far; config 5 without gang specs under the gang roster
   equal to phase 8 (choices, rounds, final table); a reduced copy
   (1,024 nodes, 10,000 pods, waves of 4,096) equal card against CPU
   twins, and the exact scan of its first ``GANG_SCAN_PODS`` (1,280: two
   chunks) pods likewise.  Printed:
   the schedule wall, rounds, device ms a round (one profiled pass), the
   gang-view and constraint-build seconds, peak memory, and the share of
   gangs whose members all sit on one slice beside the same share under
   the default full roster (reported, not gated; the port places gang
   members without all-or-nothing admission).
15. ``controlplane.evaluate.evaluate_cluster`` (the body of gRPC
   ``Evaluate``) on config 4's objects in both modes and on the mixed
   cluster's first 4,096 pods with its claims and volumes in ``"repair"``
   mode: the card equal to ``device="cpu"`` in placements and rounds;
   the wall of a call split into decode, build and evaluate.  Then
   ``FusedEvaluator(with_diagnostics=True)`` with the full roster on
   config 4: filter masks, score matrices and raw score matrices equal
   card against CPU.
16. The live engine (``engine/device_scheduler.DeviceScheduler`` behind
   ``service.SchedulerService``, the port's own store, client and
   informers) on the README scenario: ``default_scheduler_config``
   (``time_scale=0.01``), waves of 64; nine cordoned nodes leave ``pod1``
   parked in the unschedulableQ, then ``node10`` appears and ``pod1``
   binds there; no exception in the engine loop.
17. Config 5 live at full width on the serial engine
   (``live.run_config5_live(pipeline=False)``, the flow of
   ``bench.py``'s ``_bench_config5_fullchain_once``): 10,000 nodes and
   ``LIVE_C5_PODS`` pods (25,000; 100,000 until phases 33-34 and
   50,000 until phase 35 needed the time) created in the store, the full
   default roster in waves of 16,384; the first drain binds the plain
   pods and parks the 2%
   ``special*`` pods; labelling 2,000 schedulable nodes
   ``special=true`` (``random.Random(55)``) requeues them until all
   are bound.  Checks from the store's final state: no node over
   its allocatable CPU, memory or pod count, nothing on a cordoned node,
   every ``special*`` pod on a labelled node; the assume cache drained;
   no exception in the loop; ``select_hosts`` launched on the card and no
   plain-twin call.  The first drain's waves are fixed: the service
   starts the loop only after the informers synced, which queues every
   pending pod in store order, ``pop_batch`` takes them FIFO in waves of
   16,384, and no event of the first drain requeues a parked pod (the
   special pods fail NodeAffinity, which waits for a Node label event).
   So every first-drain bind is held against
   ``fullchain.schedule_repair_waves`` on the store's pods in that order,
   node for node.  Printed: first drain, requeue tail (label loop, bound
   wait), total and pods/s, the engine's ``CycleMetrics`` split, device
   ms a round (``profile_repair`` on one wave), peak device memory and
   the time-to-bind buckets.
18. Gangs live (``live.run_gang_live``): phase 14's reduced gang cluster
   (``GANG_REDUCED_NODES`` nodes, ``GANG_REDUCED_GANGS`` gangs of 8) with
   ``gang_roster_config`` in waves of 4,096, Coscheduling admitting each
   gang all or nothing: every gang fully bound and none partly, the
   Coscheduling ledger and the assume cache empty, no node over its
   allocatable, no exception in the loop.  Printed: the share of gangs on
   one slice beside phase 14's wave-driver share at the same size.
19. Config 5 live at full width on the pipelined engine (the JAX
   default), at phase 17's ``LIVE_C5_PODS`` pods (25,000; 100,000 until
   phases 33-34 and 50,000 until phase 35 needed the time): phase 17's
   run with the build worker
   packing wave N+1 on the host while wave N is on the card and every
   winner re-arbitrated at commit; node tables from
   ``CachedNodeTableBuilder``.  Checks: every pod bound, phase 17's
   audit, the assume cache and Coscheduling's ledger empty, no
   loop error.  Placements are not held to phase 17's (the full roster
   depends on binds, and a pipelined wave is built before the previous
   one commits).  Printed beside phase 17: first drain, tail, total,
   pods/s and the split, with the pipeline stall, the re-arbitrated
   winners and the builder's reused builds and dirty rows.
20. Config 5 with 5,000 spread pods live, pipelined
   (``run_config5_live(n_crosspod=5_000)``, ``bench.py`` with
   ``BENCH_C5_CROSSPOD=5000``), on config 5's 10,000 nodes with
   ``LIVE_C5X_PODS`` (50,000) pods (100,000 until phase 29 took the
   script to 1,081-1,296 s on an H100): the spread pods deferred into the
   backlog
   and placed by the blocked lane (and the exact scan for whatever the
   blocked rounds leave), the 2,000 ``special*`` pods through park and
   requeue.  Checks: every pod bound, phase 17's audit, ``bench.py``'s
   spread audit (max skew 4 per app over the eligible zones), no loop
   error.  Printed: each lane's pods, calls, blocks and rounds, the pods
   left to the exact scan, the scan phases of the split, the step-graph
   capture seconds and ``select_hosts`` launches at P = 32 and P = 1.
21. The same reduced copy as phase 13 (1,520 nodes, here
   ``LIVE_REDUCED_PODS`` pods, 9,000 (18,000 until phases 33-34), with
   1,000 spread pods, waves of 4,096) through the serial live engine
   to the end of its first drain, then one more spread pod alone
   (``live.run_crosspod_drain``: the burst takes the blocked lane, the
   lone pod the exact scan), on the card and on the CPU twins: every
   binding equal, pod for pod.  A mismatch whose runs differ in waves or
   lane calls is a timing race and is retried, up to 3 attempts, each
   attempt's cause printed; any other mismatch fails.  Then the pipelined
   engine on the card over the same cluster, held to the audits.
22. Preemption bursts on config 5, chained onto phase 19's run
   (``run_config5_live(preempt_burst=8)``): once all its 25,000 pods are
   bound, every schedulable node with 4 CPU free is topped up with
   ``fill*`` pods of config 5's shape at priority 0 (config 5's waves leave
   nodes unevenly full) and the store is checked to hold no node with 4 CPU
   free; then 8 ``high*`` pods of 4 CPU and 1 Gi at priority 100 arrive at
   once (the JAX scale test's preemptors), each of which must evict through
   the wave-loser pass and ``DefaultPreemption``.  Checks: all 8 bound; the
   pods gone from the store are exactly the victims ``last_victims``
   reported, each of priority 0; phase 17's audit on the final store; the
   assume cache drained; no loop error; ``select_hosts`` launched on the
   card during the burst and no plain-twin call.  Printed: the burst's wall
   from the first create to the last bind, the fillers, the PostFilter
   passes and victims, ``losers_handle`` and ``wave_preempt_eligible``,
   seconds per pass and the launches.  Then a reduced copy (1,024 nodes,
   5,000 pods in config 5's proportions (10,000 until phases 33-34), 8
   preemptors (16 until phase 35)) on the serial engine, once on the card
   and once on the CPU
   twins: every binding, every nomination and every victim set equal; a
   mismatch whose runs differ in waves or passes is a timing race and is
   retried, up to 3 attempts, as in phase 21.
23. A scalar ground truth for the exact scan lane: the first 64 pods of
   ``fullchain.mk_mixed_cluster`` (every feature of the full roster)
   through ``schedule_scan`` on the card, every placement equal to the
   port's own ``schedule_pods_sequentially`` (the scalar halves, the
   volume filters reading the claims and PVs from a store).  Then the
   README scenario on the scalar engine
   (``start_scheduler(device_mode=False)``), which is host only: no
   kernel launch and no plain-twin call.
24. ``record_results`` on the card against the CPU
   (``live.run_mixed_recorded``): the mixed cluster at 512 nodes x 512 pods,
   with its claims and PVs in the store, through
   the serial engine with the full roster in waves of 128, once on the card
   and once on the CPU twins, explicit uids on both.  Checks: every binding
   equal, every pod's parsed ``scheduler-simulator/*`` annotations equal;
   every bound pod carries a record exactly when a wave or an exact-scan
   chunk recorded it, and one without was placed by the blocked lane
   (``live.audit_records``); no record error and no loop error; the same
   run without ``record_results`` places alike.  A mismatch whose runs
   differ in waves, records or lane calls is a timing race and is retried,
   up to 3 attempts, as in phase 21.  Printed: the wall with and without
   the record, the record's evaluation and host-ingest seconds, the entries
   and annotation bytes.
25. The standalone process.  (a) ``__main__.start`` in this process (the
   device engine, pipelined, its default waves of 1,024) fed config 5's
   10,000 nodes with ``EARLY_C5_PODS`` (12,500; 25,000 until phase 31)
   pods (``mk_c5_cluster``: 12,250 plain, 250 ``special*``) over HTTP in
   batch creates of
   10,000, watched over an HTTP pod watch
   opened first (``live.run_config5_http``): every plain pod seen bound,
   one HTTP list audited by ``audit_store``'s rules, ``/metrics`` parsed
   with the port's parser counting every bind in
   ``sched_time_to_bind_seconds`` (the registries reset first), no loop
   error, and ``stop()`` leaving no non-daemon thread.  Printed: the
   create wall, first create to last bind and pods/s beside phase 19's.
   (b) ``python3 -m minisched_tpu_torch`` as a child with ``PORT`` and
   ``FRONTEND_URL``: its "API on" line, the README scenario over
   ``HTTPClient``, ``python3 -m minisched_tpu_torch metrics <url>`` exit
   0, and exit 0 within 30 s of SIGTERM.  The process's client is
   throttled at the reference's 5,000 requests a second (burst 5,000);
   the façade serves the store beneath the limiter.
26. The gRPC servicer (``controlplane/grpcserver.py``; grpcio is imported
   at the top of the phase, which fails without it).  (a) Config 4 (2,048
   nodes, 512 assigned, 2,048 pods; a request of about 3.56 MB, under
   grpc's default 4 MiB) through ``EvaluatorClient.evaluate`` into
   ``start_grpc_server()`` in both modes: the answer equals phase 15's
   in-process ``evaluate_cluster`` on the card and on the CPU twins, with
   ``select_hosts`` launched at least once a round; printed: the call's
   wall split into the client's encode, the server's handler, the
   client's decode and the rest (wire and grpc), beside phase 15's
   in-process call.  Phase 15's mixed request (over 4 MiB) is refused
   ``RESOURCE_EXHAUSTED``.  (b) Phase 17's routine (config 5 live,
   serial, full roster) in waves of 2,048 with one gRPC ``Watch`` on Pods
   served from its store, opened after the creates and read by a watcher
   in its own process (``live.count_grpc_binds``, up to
   ``GRPC_WATCH_BATCH`` events a message), at ``GRPC_WATCH_PODS`` pods
   (12,500; 25,000 until phase 35 and 100,000 until phases 33-34 needed
   the time): phase 17's
   audit; every bind seen over the stream, none evicted
   (``grpc.watch.evicted`` 0),
   every event in resource_version order, every bind on the node the
   store holds.  A wave's binds reach the servicer's hub as one batch, and
   a batch over the stream's 8,192-event bound is evicted on arrival, so
   phase 17's waves of 16,384 cannot be watched; hence waves of 2,048.
   Printed: the binds, events and messages seen, the stream's events a
   second and the engine's binds a second.
27. The trace ring, on phase 25(a)'s process: once config 5 is bound, 256
   more pods are created over HTTP; when the watch has seen them bound,
   ``GET /debug/trace`` answers at most ``MINISCHED_TRACE_CAP`` spans, and
   each of the 256 pods has enqueue, pop, bind and bind_ack in that order,
   its bind's wave id named by a ``wave_build`` span (and a
   ``wave_evaluate`` span when the wave was pipelined).
28. The ``churn``, ``gang`` and ``wire`` bench roles
   (``minisched_tpu_torch.bench``) on the card with ``bench.py``'s
   defaults and gates: churn's p99 time to bind within 45 s and agreeing
   with ``sched.time_to_bind_s``, no namespace-quota violation and no
   held pod at drain, every gang whole, the idle-wave gate, the shared
   watch encode, no double bind or overcommit; gang's no stranded partial
   gang, empty assume and Permit ledgers and the deadlock probe resolved;
   wire's 1,000 nodes and 10,000 pods all bound by the device engine
   behind ``RemoteClient`` and the REST façade (every informer event and
   bind over the wire).  Each record printed.
29. The durable store (``controlplane/durable.py``), config 5 surviving
   a SIGKILL (``live.run_config5_durable``).  (a) ``python3 -m
   minisched_tpu_torch`` as a child with
   ``MINISCHED_TPU_STORE_URL=file://<tmp>/c5.wal`` and its defaults
   otherwise (the device engine on the card, pipelined, waves of 1,024;
   fsync off), an HTTP watch on the pods opened first, config 5 (10,000
   nodes and ``EARLY_C5_PODS``: 12,250 plain and 250 ``special*`` pods;
   100,000 pods until phase 30 took the script past 1,100 s on an H100,
   25,000 until phase 31 did)
   created over HTTP in
   batch creates of 10,000; SIGKILLed once every create was answered and
   the watch has seen ``DURABLE_KILL_BINDS`` (2,000) binds.  The
   creates' answers gate the kill, which lands mid-run (the watch trails
   the engine: on an H100 it had seen 30,008 binds when 81,905 were in
   the WAL); the phase fails if the watch saw every plain pod bound by
   then, or if the recovered store holds fewer than a tenth of them
   unbound (``live.MIN_LEFT_AT_BOOT``).  (b) ``__main__.start`` in this
   process
   over the same URL, on the card: every bind the watch saw is on the
   same node after the replay and after the recovered engine bound the
   rest; every created object exists; every plain pod bound and no
   ``special*`` pod; phase 17's audit; no loop error; the assume and
   Permit ledgers empty; ``select_hosts`` launched at least once a wave
   of (b) and no plain twin called.  Then the scheduler stops, the live
   store compacts, and after ``stop()`` a ``readonly=True`` reopen holds
   the same objects and resource_version; ``python3 -m
   minisched_tpu_torch fsck <wal>`` exits 0.  Printed: the WAL's bytes
   and records at the kill, (b)'s replay, boot and first-bind-to-last
   seconds with pods/s beside phase 25(a)'s, the group-commit counters,
   the compaction seconds and checkpoint bytes, the read-only reopen,
   fsck's records and objects, and peak memory.
30. The remote control plane (``controlplane/remote.py``), config 5
   scheduled over the wire through a restart of the API server
   (``live.run_config5_remote``).  The port's ``start_api_server`` runs in
   a ``faults.proc.ServerSupervisor`` child over ``<tmp>/remote.wal`` on
   a free port, its defaults otherwise (the stream loop on, fsync off);
   config 5's 10,000 nodes and ``EARLY_C5_PODS`` (12,500;
   50,000 until phase 31 needed the time) pods are created with
   ``RemoteClient(base)`` in batch creates of
   10,000; then ``SchedulerService(RemoteClient(base, retries=10))``
   starts the full roster with ``device_mode=True`` at its defaults
   (pipelined, waves of 1,024) on the card, every informer event and bind
   crossing the child's façade.  Once a ``PodWatch`` over the wire has
   seen ``REMOTE_KILL_BINDS`` (2,500) binds the child is SIGKILLed and
   started again on the same port over the same WAL; the scheduler rides
   through on its own (retries, resume or 410 and relist, the assume
   ledger revalidated, a retried bind that had landed answered as ours).
   Checks: at least a tenth of the plain pods unbound when the server
   came back; every plain pod (and 64 created after the restart, with new
   uids) bound, no ``special*`` pod; every bind the first watch saw on
   the same node at the end; phase 17's audit; both the Pod and the Node
   informer reconnected; no loop error, the assume and Permit ledgers
   empty; ``select_hosts`` launched at least once a wave and no plain
   twin called; ``fsck.wal_double_binds`` empty and ``python3 -m
   minisched_tpu_torch fsck <wal>`` exit 0.  Printed: the creates' wall,
   pods/s before the kill and after the restart beside phases 25(a) and
   17, the restart's replay and boot seconds, the time from the restart
   to the next bind, the reconnect, resume and relist counters and
   ``assume.revalidate_on_reconnect``, the pool's reuse and stale
   reopens, the Pod streams' decode seconds, evictions, and peak device
   memory.
31. The replicated control plane (``controlplane/repl.py``,
   ``replproc.py``), config 5 scheduled through a SIGKILL of the store
   leader (``live.run_config5_replicated``).  ``ReplicatedPlane`` starts
   three replica children (fsync off, JAX's lease TTL of 2 s; host code,
   no CUDA context), ``r0`` bootstrapping as leader; a ``PodWatch`` opens
   on follower ``r2``, which is never killed; config 5's 10,000 nodes and
   ``EARLY_C5_PODS`` (12,500; 25,000 until phase 32 needed the time) pods
   are created with ``RemoteClient(r0)`` in
   batch creates of 10,000, each group waiting for a follower's ack; then
   ``SchedulerService(RemoteClient(r0, endpoints=[r1, r2], retries=10))``
   starts the full roster with ``device_mode=True`` at its defaults
   (pipelined, waves of 1,024) on the card.  Once the watch has seen
   ``REPL_KILL_BINDS`` (2,500; 5,000 at 25,000 pods) binds, ``r0`` is
   SIGKILLed; the engine
   goes on without a restart, its writes finding the new leader by
   discovery and its informers resuming on a live replica.  When every
   plain pod is seen bound, ``r0`` restarts and must serve as a fenced
   follower at the new leader's rv.  Checks: a new leader within ``2·TTL
   + 1 s`` of the kill; every bind watched before the kill on the new
   leader, on the same node; every plain pod bound and no ``special*``
   pod; phase 17's audit; both informers reconnected; no loop error, the
   assume and Permit ledgers empty; the three WALs identical or prefixes
   of each other (``fsck.wal_compare``); no double bind in any WAL, the
   killed leader's as the kill left it included; ``python3 -m
   minisched_tpu_torch fsck`` exit 0 on the new leader's WAL;
   ``select_hosts`` launched at least once a wave and no plain twin
   called.  Printed: the creates' wall, ``storage.quorum_wait_s`` p50/p99
   off the old leader's ``/metrics`` before the kill and the new one's at
   the end, pods/s before the kill, kill to promotion, kill to the next
   bind, pods/s after, the restarted replica's catch-up seconds, the
   informer and routing counters, ``assume.revalidate_on_reconnect``,
   waves, launches and peak device memory.
32. The sharded write plane (``controlplane/shards.py``), config 5
   scheduled over two leader groups through a live split
   (``live.run_config5_sharded``).  ``ShardedPlane(k=2,
   replicas_per_group=1, fsync=False)`` starts one replica child a group
   (host code, no CUDA context); config 5's 10,000 nodes land on the home
   group (the owner of ""), its ``EARLY_C5_PODS`` pods (12,250 plain,
   250 ``special*``) round-robin over 8 tenant namespaces, 4 owned by
   each group (``live.shard_tenants``, picked as ``bench.py``'s
   ``bench_shard`` picks its writers'), all created through
   ``ShardedClient`` in batch creates of 10,000.  The home group's budget
   document is fetched and applied to a ``BudgetMirror`` once (its bytes
   and seconds printed) before ``SchedulerService(ShardedClient(seeds,
   retries=10))`` starts the full roster with ``device_mode=True`` at its
   defaults (pipelined, waves of 1,024) on the card; a merged
   vector-cursor watch (``live.ShardPodWatch``) reads every pod.  Once it
   has seen ``SHARD_SPLIT_BINDS`` (2,500) binds, ``plane.split`` moves
   ``hot_ns`` (the home group's tenant with the most pods pending) to
   the other group: freeze lease, handoff, seed, renewal, topology flip,
   thaw, keyed purge.  The engine goes on without a restart: its writes
   chase 421s and wait out the freeze, its informers ride the vector
   cursor; binds on the non-home group are checked against the capacity
   mirror.  Checks: every plain pod bound and no ``special*`` pod; 0
   loop errors, the assume and Permit ledgers empty; ``hot_ns``'s
   objects all on the target and none on the source; the freeze shorter
   than ``freeze_ttl_s()`` (30 s); every bind watched before the split on
   the same node at the end; each plain pod's bind seen exactly once by
   the merged watch, none on a second node, no plain pod deleted; no
   node over its allocatable counting both groups' bound pods; no double
   bind in either WAL and ``python3 -m minisched_tpu_torch fsck`` exit 0
   on both; the children and the run's threads gone; ``select_hosts``
   launched at least once a wave and no plain twin called.  Printed: the
   creates' wall, ``start_scheduler``, pods/s before and after the split,
   the freeze, handoff and seed seconds, the time to bind of ``hot_ns``'s
   pods against the other tenants' after the split (p50, p99), the
   ``shard.*`` counters (chases, frozen retries, mirror checks and
   refusals), waves, ``shard-c5`` launches and peak device memory.
33. The fault points (``faults/``): the ``chaos`` bench role
   (``bench.role_chaos``, ``bench_chaos``'s defaults: 128 nodes of 64
   CPU, 1 in 16 cordoned, 2,000 pods of 500m and 64 Mi) with the device
   engine on the card (full roster) over a ``DurableObjectStore``, while
   a fabric at seed 1234 fails ``store.update`` (0.10), ``store.get``
   (0.05), drops Pod and Node watches (``watch.drop`` 0.02, at most 16),
   refuses WAL appends (``wal.append`` 0.03, at most 16) and fails whole
   bind batches (``engine.bind`` 0.05, at most 16).  (a) In waves of 512
   (the role's default), (b) in waves of ``CHAOS_FIRE_WAVE`` (32): at
   512 the run draws each batch-keyed point about 8 times, and seed
   1234's schedules fire none of ``watch.drop``, ``wal.append`` and
   ``engine.bind`` that early.  Checks, each run: every pod bound, no
   assumed capacity left at quiesce, informer staleness at most 30 s,
   ``wal_double_binds`` empty (the role's gates), 0 loop errors,
   ``select_hosts`` launched and no plain twin called; (b) also a fire of
   each of ``CHAOS_GATED_POINTS`` (``store.get``'s draws come from lease
   probes, a timing-dependent count: reported only).  Printed: the fires
   and draws by point, the recovered counters and the wall.
34. The HA engines (``ha/``, ``faults/proc.py``), config 5 scheduled by
   three active-active device engines through a SIGKILL of one
   (``live.run_config5_ha``).  A ``ServerSupervisor`` façade child over a
   WAL (``archive_history=True``, fsync off); config 5's 10,000 nodes and
   its ``special*`` pods created over the wire; three
   ``EngineSupervisor`` children ``engine-0..2`` started side by side,
   each ``start_ha_engine`` over a ``RemoteClient`` with the device engine
   on ``cuda`` (a CUDA context each on this card), the full roster,
   ``max_wave=1024`` and lease TTL 2 s; once all run, the first four
   fifths of ``EARLY_C5_PODS``'s plain pods are created, each engine
   admitting its rendezvous shard.  After ``HA_KILL_BINDS`` (2,500)
   watched binds, with every engine seen to have bound a third of them
   and launched ``select_hosts``, ``engine-1`` is SIGKILLed, its lease
   abandoned, and the last fifth is created.  Checks: the survivors drop
   it and publish new epochs within ``ttl + ttl/3 + 1.5`` s of the kill,
   and their resyncs have queued its pods within it; no engine dropped a
   live peer (no ``ha.lease_expired`` or ``ha.member_lost`` anywhere
   before the kill, one of each on every survivor after it); every
   plain pod bound, on the
   node the watch first saw, no ``special*`` pod; phase 17's audit over
   all binds; ``wal_double_binds`` empty over the archived history;
   ``fsck`` exit 0; every engine's ``select_hosts`` launches at least 1,
   no plain-twin call and no loop error in any child (read off each
   child's ``/metrics``: the victim's before the kill, the survivors' at
   the end); no child left.  Printed: the creates' wall, each engine's
   spawn to lease and to a running engine, pods/s before and after the
   kill, kill to adoption (published, and resynced) and to the next
   bind, each engine's binds before the kill and in all, the ``ha.*``
   counters, the renewals, their widest gap and the view ticks, the
   adopted pods and each child's peak device memory.
35. The device mesh (``parallel/sharding.py``) on a virtual 2 x 4 mesh
   of this card (``make_mesh(8, devices=[cuda:0] * 8)``; 2 x 4 is
   ``default_pod_shards(8)``).  (a) One full-roster repair wave of config
   5 at full width (10,000 nodes, its first 8,192 pods, with the wave's
   constraint tables) through ``RepairingEvaluator(mesh=)`` and mesh-off:
   choices, rounds, unschedulable masks and final node tables
   bit-identical, ``select_hosts`` launched by every tile each round (8 x
   (rounds + the diagnostics evaluation)) and no plain twin; then the
   evaluate-and-commit step (``sharded_wave_step``) against
   ``evaluate`` and ``apply_placements``: choice and best bit-identical.
   (d) ``MINISCHED_MESH=1`` on this card: a 1 x 1 mesh placing that wave
   as mesh-off.  (b) Config 5 live on the serial engine under the mesh,
   10,000 nodes and ``EARLY_C5_PODS`` (12,500) pods (the depth of phases
   25(a) and 29-34), waves of 16,384: every pod bound, phase 17's audit,
   ``wave_mesh.waves`` equal to the waves, no fallback, no loop error, at
   least 8 launches a wave and no plain twin; printed beside phase 17:
   pods/s and ``wave_device``.  (c) The per-wave ladder
   (``live.run_mesh_ladder``): ``mesh.evaluate`` armed once, exactly one
   fallback to the single-device evaluator (on the card), the next
   batch's waves sharded, every pod bound.  (e) The exact scan in the
   scan layout (4 node shards, pods whole) over config 5's first
   ``MESH_SCAN_PLAIN`` (256) plain pods and all 2,000 ``special*`` pods,
   full roster, against the mesh-off scan: choice, best and final node
   table bit-identical, 4 launches a step.  (f) ``select_hosts`` at a
   nonzero node base on ``kernel_cases``' edge rows against its twin,
   and 4 shards' partials merged by ``select_hosts_merge`` against the
   whole row's kernel.  (g) A fresh process with ``MINISCHED_CACHE_DIR``
   set (started with the phase, run beside (a)-(f)) calls
   ``enable_persistent_cache``: the library is built and loaded under
   that directory and launches bit-exact.  Phases 5, 12 and
   13 also check and time ``select_hosts`` at ``SELECT_BASE`` beside
   base 0.  A ``[clock]`` line closes the phase.
36. The mesh across processes (``parallel/distributed.py``): two
   processes started by ``distributed.spawn`` (a ``gloo`` group over a
   ``file://`` rendezvous), each a 1 x 4 row of this card
   (``make_mesh(devices=[cuda:0] * 4)`` under the group), together phase
   35's 2 x 4 mesh, one pod shard each; the children load phase 35(a)'s
   tables and (c)'s from one file and run ``parallel.rank_steps.run_rank``.
   (a) Phase 35(a)'s repair wave (once to warm, once timed): on each
   rank choices, rounds, unschedulable masks, final node table and
   carried volume planes bit-identical to phase 35(a)'s mesh-off wave and
   to the other rank's, 4 ``select_hosts`` launches an evaluation and no
   plain twin.  (b) ``sharded_wave_step``: choice, best and table equal
   ``evaluate`` then ``apply_placements``.  (c) The exact scan of config
   5's first ``MESH_SCAN_PLAIN`` (256) plain pods in the scan layout
   against the mesh-off scan (run here while the children start).  Each
   rank's engine refuses the mesh.  Printed: each rank's wall for the
   wave, its seconds in the gather a round (the exchange, and the wait
   for the card before it), its launches.  A rank that raises, hangs
   past ``PROCESS_MESH_DEADLINE_S`` or disagrees fails the phase.  A
   ``[clock]`` line closes the phase.

Phase 2 also holds ``select_hosts`` against its twin on the repair
route's own planes: round 1 of config 5's wave 0 (tie-heavy) and round 2
of wave 1 (the rows committed in round 1 fully masked); and, once those
tables exist, on the scan lanes' own planes: step 0 of phase 12 (1 x
10,112) and block 0 of phase 13 (32 x 10,112), each also timed with its
bound as in phase 5.

The launch counters are set to 0 just before each path of the main path
(the headline's two routes, the repair waves with each roster and with
hostname labels, config 4, the mixed cluster's card run, the exact scan
of configs 3 and 5, the blocked lane of phase 13, the gang waves, the
gang roster without gangs, the gang exact scan, each ``Evaluate``
call, the six live-engine runs of phases 16-21, the burst of phase 22
and its reduced card run, the exact scan of phase 23, the card runs of
phase 24 with and without the record, phase 25's process, phase 26's
gRPC calls and watched run, each role of phase 28, phase 29's
recovered engine, phase 30's remote engine, phase 31's engine behind
the replicated plane, phase 32's behind the sharded one and both chaos
runs of phase 33, and phase 35's mesh wave and step, 1 x 1 mesh, live
engine, ladder and scan) and read just after it; phase 34's engines are
child processes, whose counts start at 0 and are read off their
``/metrics``, and phase 36's ranks set theirs to 0 before each step and
hand them back with its results.  A scan's step is captured once in a CUDA graph and
replayed; each replay counts the ``select_hosts`` launch recorded in
the graph.  The last three lines of output are the card's name and
power limit, one JSON object describing every kernel, and the
result line ``{"ok": true, "device": {...}}``.  Without a card, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import signal
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor cores,
# which counts an FMA as two operations, i.e. 33.5 T float32 instructions
# a second.  An SM issues int32 arithmetic on 64 lanes a clock against
# float32's 128, so the int32 peak is half that: 16.75 T operations/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2 / 2
# integer operations of one mix32 (3 multiplies, 3 shifts, 4 xors) plus
# the compare against the running minimum
MIX32_OPS = 11
WAVE = 8192
N_NODES, N_PODS = 10_000, 100_000
C5_WAVE = 16_384  # repair waves of config 5
C5_SCAN_PLAIN = 2_096  # phase 12: plain pods scanned before the specials
#: phase 26(b): config 5's serial waves under a gRPC watch.  The servicer
#: evicts a stream that falls DEFAULT_WATCH_STREAM_EVENTS (8,192) behind,
#: as JAX's does; a wave of 16,384 binds is one batch over that bound, so
#: waves of 2,048 let the stream carry events before it falls behind
GRPC_WATCH_WAVE = 2_048
#: config 5's pods in phase 26(b) (100,000 until phases 33-34 needed the
#: time: the smoke took 1,092.8 s of its 1,200 s on an H100 before them,
#: and they add about 86 s; 25,000 until phase 35 did); 7 waves of 2,048,
#: half again the stream's 8,192-event bound
GRPC_WATCH_PODS = 12_500
#: the most events a message of phase 26(b)'s stream: one event a message
#: falls behind the engine's binds (the stream's generator and grpc's
#: completion thread share the engine's interpreter lock; PERF.md §6)
GRPC_WATCH_BATCH = 1_024
TRACE_PODS = 256  # phase 27: pods created after phase 25(a)'s config 5
MIXED_WAVE = 4_096  # repair waves of the mixed cluster (phase 10)
#: phase 10's pending pods of the mixed cluster, card against CPU: a
#: whole wave and half of a second (8,192 until phase 35 needed the time;
#: the CPU twins took 26.4 s of them on a slow host)
MIXED_PODS = 6_144
C5X_SPREAD = 5_000  # config 5's spread pods (phase 13)
#: phase 7's reduced config 5, card against CPU: nodes, pods (20,000 pods
#: until phase 35 needed the time: the CPU twins took 12.5 s of it)
C5_REDUCED = (2_000, 10_000)
C5X_REDUCED_NODES = 1_520  # phase 13's card-vs-CPU run: full enough to race
GANG_REDUCED_NODES = 1_024  # phase 14's card-vs-CPU run: 64 slices
GANG_REDUCED_GANGS = 410  # 10,000 pending pods in config 5's proportions
#: phase 14's exact scan, card against CPU: two chunks (2,048 until phase
#: 35 needed the time; the CPU twins took 24.8 s of it on a slow host)
GANG_SCAN_PODS = 1_280
#: phase 22's preemptors (64 until phase 29 took the script to 1,081-
#: 1,296 s on an H100)
PREEMPT_BURST = 8
#: nodes, pods, preemptors (10,000 pods until phases 33-34; 16
#: preemptors until phase 35: fewer pods would only add fill pods)
PREEMPT_REDUCED = (1_024, 5_000, 8)
MIXED_SCALAR_PODS = 64  # phase 23's scan against the scalar loop
#: phase 24: record_results on the mixed cluster, card against CPU; 512
#: nodes keep the 4,200 assigned web pods of zone z0 under a node's 110;
#: 512 pods, 4 waves of 128
RECORD_NODES, RECORD_PODS, RECORD_WAVE = 512, 512, 128
#: phase 29: binds the watch must have seen before the SIGKILL; with so
#: few, the creates' answers gate the kill, and it lands mid-run
DURABLE_KILL_BINDS = 2_000
#: config 5's pods in phases 17 and 19, and so in phase 22's burst on
#: 19's run (100,000 until phases 33-34: with them and 26(b) cut the
#: smoke took 1,021.7 s, 1,147.5 s and, with 19 cut, 1,205.1 s on H100
#: hosts of different speeds; 50,000 until phase 35 needed the time).
#: The two phases share it so that 19's pipelined run is compared with
#: 17's serial one at one size; at 25,000, phase 22 creates about 25,000
#: more fill pods, which are bound in the store, not scheduled
LIVE_C5_PODS = 25_000
#: pods of phase 21's reduced copy (1,520 nodes, 1,000 of them spread
#: pods), card against CPU (18,000 until phases 33-34; at 6,000 the
#: plain pods leave the nodes too empty for the blocked lane to race)
LIVE_REDUCED_PODS = 9_000
#: config 5's pods in phase 20 (100,000 until phase 29 took the script to
#: 1,081-1,296 s on an H100; 25,000 took it as long as 50,000)
LIVE_C5X_PODS = 50_000
#: config 5's pods in phases 25(a), 29, 30, 31 and 32: phases 25(a), 29
#: and 30 since phase 31 took the script to 1,136-1,297 s on an H100
#: (phase 30: 50,000 before); phase 31 (25,000 before) since phase 32
EARLY_C5_PODS = 12_500
#: phase 30: binds a watch over the wire must have seen before the
#: SIGKILL of the API server (10,000 at 50,000 pods)
REMOTE_KILL_BINDS = 2_500
#: phase 31: binds the watch on follower r2 must have seen before the
#: SIGKILL of the store leader (5,000 at 25,000 pods)
REPL_KILL_BINDS = 2_500
#: phase 32: binds the merged watch must have seen before the split
SHARD_SPLIT_BINDS = 2_500
#: phase 33(b): the chaos role's waves (``BENCH_CHAOS_WAVE``, JAX's knob;
#: the role's default is 512).  At 512 the 2,000 pods take about 8 bind
#: batches, and seed 1234's schedules of ``watch.drop``, ``wal.append``
#: and ``engine.bind`` (one draw a batch each) first fire at draws 53, 55
#: and 34; waves of 32 (``test_chaos_soak.py``'s) give over 60 draws
CHAOS_FIRE_WAVE = 32
#: the points phase 33(b) must see fire: ``store.get`` is drawn only by
#: lease probes after failed binds, a count that depends on timing, and
#: is reported, not gated (JAX's soak leaves it unasserted for that)
CHAOS_GATED_POINTS = ("store.update", "watch.drop", "wal.append",
                      "engine.bind")
#: phase 34: binds the watch must have seen before the SIGKILL of an engine
HA_KILL_BINDS = 2_500
#: phase 35: the virtual mesh's devices (2 x 4, ``default_pod_shards(8)``),
#: its repair wave's pods (config 5's first 8,192 at full width) and its
#: exact scan's plain pods (before all 2,000 ``special*`` pods)
MESH_DEVICES = 8
MESH_WAVE = 8_192
MESH_SCAN_PLAIN = 256
#: phase 36: the processes of the mesh across processes, the devices of
#: each (a 1 x 4 row of this card: together phase 35's 2 x 4), and the
#: deadline of their spawn (the phase's budget is 40 s)
PROCESS_MESH_RANKS = 2
PROCESS_MESH_LOCAL = 4
PROCESS_MESH_DEADLINE_S = 180.0
#: a nonzero node-index base for ``select_hosts`` (phases 5, 12, 13, 35)
SELECT_BASE = 1 << 20


T0 = time.monotonic()


def stamp(phase: str) -> None:
    """The seconds since the script started, as each phase begins."""
    log(f"[clock] phase {phase} at {time.monotonic() - T0:.1f}s")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def check_equal(what: str, got, want) -> int:
    """Raise unless the kernel's (choice, best) equal the twin's."""
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err != 0 or any(not torch.equal(g, w) for g, w in zip(got, want)):
        bad = int((got[0] != want[0]).sum())
        raise AssertionError(f"{what}: kernel differs from its twin "
                             f"({bad} choices, max |err| {err})")
    return err


def _events_ms(run, rounds: int, per_run: int) -> float:
    """Median over ``rounds`` of the milliseconds between two events
    around ``run()``, divided by the ``per_run`` calls it makes."""
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def time_ms(fn, rounds: int, batch: int, warmup: int = 3) -> float:
    """Milliseconds of one call: ``batch`` calls back to back between two
    events; median over ``rounds``.  Includes whatever the host's launch
    path adds where the device waits on it."""
    for _ in range(warmup):
        fn()
    return _events_ms(lambda: [fn() for _ in range(batch)], rounds, batch)


def graph_time_ms(fn, rounds: int, batch: int, warmup: int = 3) -> float:
    """Device milliseconds of one call: ``batch`` calls captured in one
    CUDA graph, whose replay is timed between two events, so that no host
    launch cost is counted; median over ``rounds``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture stream
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    graph.replay()
    return _events_ms(graph.replay, rounds, batch)


def check_twin_runs(what: str, card, cpu, tables) -> None:
    """Raise unless two ``WaveRun``s (card, CPU twins) agree in choices,
    rounds, unschedulable masks and every final node-table column."""
    if not np.array_equal(card.choices, cpu.choices):
        bad = np.flatnonzero(card.choices != cpu.choices)
        raise AssertionError(f"{what}: {bad.size} choices differ card vs "
                             f"CPU, first at pod {int(bad[0])}")
    if card.rounds != cpu.rounds:
        raise AssertionError(f"{what} rounds: card {card.rounds}, CPU "
                             f"{cpu.rounds}")
    if (card.unschedulable.keys() != cpu.unschedulable.keys()
            or not all(np.array_equal(m, cpu.unschedulable[name])
                       for name, m in card.unschedulable.items())):
        raise AssertionError(f"{what}: unschedulable masks differ")
    cpu_cols = tables.table_columns(cpu.node_table)
    for name, col in tables.table_columns(card.node_table).items():
        if not torch.equal(col.cpu(), cpu_cols[name]):
            raise AssertionError(f"{what}: final tables differ in {name}")


#: phase 35(g)'s child: the build directory ``MINISCHED_CACHE_DIR`` gives,
#: the library loaded from there, one launch against the twin
_CACHE_CHILD = """
import json, time
t0 = time.monotonic()
import torch
from minisched_tpu_torch.utils.compilecache import enable_persistent_cache
d = enable_persistent_cache()
from minisched_tpu_torch.utils import build
from minisched_tpu_torch.ops import kernels
lib = build.library_path()
build.load_library()
g = torch.Generator(device="cuda")
g.manual_seed(3)
s = torch.randint(0, 3, (64, 1000), generator=g, device="cuda",
                  dtype=torch.int32)
m = torch.rand((64, 1000), generator=g, device="cuda") < 0.5
sd = torch.arange(64, dtype=torch.int32, device="cuda")
ok = all(torch.equal(a, b) for a, b in zip(
    kernels.select_hosts_cuda(s, m, sd, 7),
    kernels.select_hosts_plain(s, m, sd, 7)))
print(json.dumps({"dir": d, "lib": str(lib), "exists": lib.exists(),
                  "ok": ok, "launches": kernels.launch_counts["select_hosts"],
                  "wall_s": time.monotonic() - t0}))
"""


def phase35(dev, card, launches, main_err, serial17, c5_nodes,
            c5_pods) -> dict:
    """Phase 35: the device mesh (``parallel/sharding.py``) on a virtual
    2 x 4 mesh of this card; ``launches`` and ``main_err`` are the main
    script's ledgers, ``serial17`` phase 17's (first drain, tail, total,
    split), ``c5_nodes``/``c5_pods`` config 5 at full size.  Returns (a)'s
    inputs and mesh-off answers on the host, for phase 36."""
    import shutil
    import tempfile

    from minisched_tpu_torch.kernel_cases import (
        SELECT_NS,
        select_case,
        select_tensors,
    )
    from minisched_tpu_torch.live import (
        audit_store,
        run_config5_live,
        run_mesh_ladder,
    )
    from minisched_tpu_torch.models import tables
    from minisched_tpu_torch.models.constraints import build_constraint_tables
    from minisched_tpu_torch.ops import kernels
    from minisched_tpu_torch.ops.fused import BatchContext, evaluate
    from minisched_tpu_torch.ops.repair import RepairingEvaluator
    from minisched_tpu_torch.ops.sequential import SequentialScheduler
    from minisched_tpu_torch.ops.state import apply_placements
    from minisched_tpu_torch.parallel import rank_steps, sharding
    from minisched_tpu_torch.plugins.registry import build_plugins
    from minisched_tpu_torch.service.config import default_full_roster_config

    stamp("35")
    t_phase = time.monotonic()
    # (g) runs in its own process, started now beside (a)-(f)
    cache_dir = tempfile.mkdtemp(prefix="kernel-cache-")
    env = dict(os.environ, MINISCHED_CACHE_DIR=cache_dir)
    env.pop("MINISCHED_CACHE", None)
    cache_child = subprocess.Popen(
        [sys.executable, "-c", _CACHE_CHILD], env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mesh = sharding.make_mesh(MESH_DEVICES, devices=[dev] * MESH_DEVICES)
    ps, ns = sharding.mesh_axis_sizes(mesh)
    if (ps, ns) != (2, 4):
        raise AssertionError(f"make_mesh(8) factored {ps} x {ns}, not 2 x 4")
    cfg = default_full_roster_config()
    chains = build_plugins(cfg)
    weights = cfg.score_weights()
    chain = (chains.filter, chains.pre_score, chains.score)

    def counted(fn):
        """(fn(), seconds, launches, plain-twin calls), counts from 0."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.monotonic() - t0, kernels.launch_counts["select_hosts"],
                sum(kernels.plain_calls.values()))

    def same_tables(what, got, want) -> None:
        want_cols = tables.table_columns(want)
        for name, col in tables.table_columns(got).items():
            if not torch.equal(col, want_cols[name]):
                raise AssertionError(f"{what}: final node tables differ in "
                                     f"{name}")

    # (a) one full-roster repair wave of config 5 at full width
    nodes, pods = c5_nodes, c5_pods[:MESH_WAVE]
    nt, _ = tables.build_node_table(nodes, device=dev)
    pt, _ = tables.build_pod_table(pods, capacity=MESH_WAVE, device=dev)
    extra = build_constraint_tables(pods, nodes, [], pod_capacity=pt.capacity,
                                    node_capacity=nt.capacity, device=dev)

    def repair(mesh_):
        ev = RepairingEvaluator(*chain, weights=weights,
                                with_diagnostics=True, mesh=mesh_)
        return counted(lambda: ev(pt, nt, extra))

    # off, mesh, mesh, off: the first run of each pays its first-call
    # costs; the times printed are the second runs'
    off, _, _, _ = repair(None)
    on, _, _, _ = repair(mesh)
    on2, on_s, on_n, on_plain = repair(mesh)
    off2, off_s, off_n, _ = repair(None)
    if not (torch.equal(on2.choice, on.choice)
            and torch.equal(off2.choice, off.choice)):
        raise AssertionError("mesh repair wave: a second run placed "
                             "differently")
    del on2, off2
    n_live = len(pods)
    unplaced = bool((off.choice[:n_live] < 0).any())
    if not torch.equal(on.choice, off.choice) or on.rounds != off.rounds:
        bad = int((on.choice != off.choice).sum())
        raise AssertionError(f"mesh repair wave: {bad} choices differ, rounds "
                             f"{on.rounds} against {off.rounds}")
    if not torch.equal(on.unschedulable, off.unschedulable):
        raise AssertionError("mesh repair wave: unschedulable masks differ")
    same_tables("mesh repair wave", on.node_table, off.node_table)
    want_n = mesh.size * (on.rounds + int(unplaced))
    if on_n != want_n or on_plain:
        raise AssertionError(f"mesh repair wave: {on_n} select_hosts "
                             f"launches (want {want_n}: every tile each "
                             f"round), {on_plain} plain-twin calls")
    ctx = BatchContext(weights=tuple(sorted(weights.items())))
    ref, ref_s, _, _ = counted(lambda: evaluate(pt, nt, *chain, ctx,
                                                extra=extra))
    step = sharding.sharded_wave_step(mesh, *chain, ctx)
    (step_nodes, step_choice, step_best), step_s, step_n, step_plain = (
        counted(lambda: step(pt, nt, extra)))
    if (not torch.equal(step_choice, ref.choice)
            or not torch.equal(step_best, ref.best_score)
            or step_n != mesh.size or step_plain):
        raise AssertionError(
            f"mesh wave step: {int((step_choice != ref.choice).sum())} "
            f"choices and {int((step_best != ref.best_score).sum())} best "
            f"scores differ; {step_n} launches, {step_plain} plain calls")
    same_tables("mesh wave step", step_nodes,
                apply_placements(nt, pt, ref.choice))
    launches["select_hosts"]["mesh-wave"] = on_n + step_n
    placed = int((on.choice[:n_live] >= 0).sum())
    log(f"[mesh-wave] {card}: config 5, {N_NODES} nodes x {n_live} pods, "
        f"full roster, one repair wave on a virtual {ps} x {ns} mesh of "
        f"cuda:0 ({MESH_DEVICES} tiles of {pt.capacity // ps} x "
        f"{nt.capacity // ns}) and mesh-off: choices, rounds ({on.rounds}), "
        f"unschedulable masks and final node tables bit-identical "
        f"({placed} placed); the evaluate-and-commit step's choice and best "
        f"bit-identical; wall {on_s:.3f}s on the mesh against {off_s:.3f}s "
        f"off it (the step {step_s:.3f}s against {ref_s:.3f}s); "
        f"select_hosts launches {on_n} = {mesh.size} tiles x "
        f"({on.rounds} rounds + {int(unplaced)} diagnostics evaluation) "
        f"(off the mesh {off_n}), plain-twin calls 0")

    # (d) MINISCHED_MESH=1 on one card: a 1 x 1 mesh, mesh-off placements
    one = sharding.resolve_mesh(env={"MINISCHED_MESH": "1"})
    if one is None or one.shape != {"pods": 1, "nodes": 1}:
        raise AssertionError(f"MINISCHED_MESH=1 on one card gave {one}")
    deg, deg_s, deg_n, deg_plain = repair(one)
    if (not torch.equal(deg.choice, off.choice) or deg.rounds != off.rounds
            or deg_plain):
        raise AssertionError("MINISCHED_MESH=1: the 1 x 1 mesh placed "
                             "differently from mesh-off")
    same_tables("1 x 1 mesh", deg.node_table, off.node_table)
    launches["select_hosts"]["mesh-1x1"] = deg_n
    log(f"[mesh-1x1] MINISCHED_MESH=1 on this card: {one}; the same wave "
        f"placed bit-identically to mesh-off in {deg_s:.3f}s, "
        f"select_hosts launches {deg_n}, plain-twin calls 0")
    # phase 36 runs the same wave and step across two processes: the
    # inputs and the mesh-off answers, on the host
    handoff = {
        "wave": tuple(rank_steps.tables_to(x, "cpu") for x in (pt, nt, extra)),
        "off": {"choice": off.choice.cpu(), "rounds": off.rounds,
                "unschedulable": off.unschedulable.cpu(),
                "node_table": {k: v.cpu() for k, v in
                               tables.table_columns(off.node_table).items()},
                "carried": {f: getattr(off.extra, f).cpu()
                            for f in rank_steps.CARRIED}},
        "step": {"choice": ref.choice.cpu(), "best": ref.best_score.cpu(),
                 "node_table": {k: v.cpu() for k, v in tables.table_columns(
                     apply_placements(nt, pt, ref.choice)).items()}},
    }
    del off, on, deg, ref, step_nodes, nt, pt, extra

    # (b) the live engine on config 5 under the mesh
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    run = run_config5_live(N_NODES, EARLY_C5_PODS, max_wave=C5_WAVE,
                           pipeline=False, mesh=mesh)
    live_n = kernels.launch_counts["select_hosts"]
    live_plain = sum(kernels.plain_calls.values())
    peak = torch.cuda.max_memory_allocated()
    audited = audit_store(run.client, run.labelled)
    mesh_waves = run.counters["wave_mesh.waves"]
    fallbacks = run.counters["wave_mesh.fallbacks"]
    if (audited["bound"] != EARLY_C5_PODS or run.loop_errors
            or run.assumed_left or mesh_waves != run.waves or fallbacks
            or live_plain or live_n < mesh.size * run.waves):
        raise AssertionError(
            f"mesh live config 5: {audited['bound']}/{EARLY_C5_PODS} bound, "
            f"{run.loop_errors} loop errors, {run.assumed_left} assumed "
            f"left, wave_mesh.waves {mesh_waves} of {run.waves} waves, "
            f"fallbacks {fallbacks}, launches {live_n}, plain calls "
            f"{live_plain}")
    launches["select_hosts"]["mesh-live"] = live_n
    s17 = serial17[3]
    log(f"[mesh-live] {card}: config 5 live on the {ps} x {ns} virtual "
        f"mesh, {N_NODES} nodes x {EARLY_C5_PODS} pods, full roster, serial, "
        f"waves of {C5_WAVE}: {audited['bound']} of {EARLY_C5_PODS} bound; "
        f"first drain {run.first_drain_s:.3f}s, total {run.total_s:.3f}s = "
        f"{EARLY_C5_PODS / run.total_s:,.0f} pods/s (phase 17 off the mesh, "
        f"{LIVE_C5_PODS} pods: {LIVE_C5_PODS / serial17[2]:,.0f} "
        f"pods/s); "
        f"wave_device {run.split.get('wave_device', 0.0):.3f}s over "
        f"{run.waves} waves = "
        f"{run.split.get('wave_device', 0.0) / max(run.waves, 1):.3f}s a "
        f"wave (phase 17, {LIVE_C5_PODS} pods: "
        f"{s17.get('wave_device', 0.0):.3f}s over all its waves); "
        f"wave_mesh.waves {mesh_waves} = the waves, fallbacks 0, pad rows "
        f"pods {run.counters['wave_mesh.pad_pod_rows']} nodes "
        f"{run.counters['wave_mesh.pad_node_rows']}; audit passed, assume "
        f"cache drained, loop errors 0; select_hosts launches {live_n}, "
        f"plain-twin calls 0; peak device memory {peak / 2**30:.2f} GiB")
    del run

    # (c) the per-wave ladder: mesh.evaluate armed once
    kernels.reset_launch_counts()
    ladder = run_mesh_ladder(mesh, device=dev)
    ladder_n = kernels.launch_counts["select_hosts"]
    ladder_plain = sum(kernels.plain_calls.values())
    unbound = [k for k, v in ladder.placements.items() if not v]
    if (ladder.fires != 1 or ladder.after_first["wave_mesh.fallbacks"] != 1
            or ladder.after_second["wave_mesh.fallbacks"] != 1
            or ladder.after_second["wave_mesh.waves"] < 1 or unbound
            or ladder.loop_errors or ladder_plain or not ladder_n):
        raise AssertionError(
            f"mesh ladder: fires {ladder.fires}, counters after the first "
            f"batch {ladder.after_first}, after the second "
            f"{ladder.after_second}, unbound {unbound[:5]}, loop errors "
            f"{ladder.loop_errors}, launches {ladder_n}, plain calls "
            f"{ladder_plain}")
    launches["select_hosts"]["mesh-ladder"] = ladder_n
    log(f"[mesh-ladder] mesh.evaluate armed once (seed 1234): "
        f"{len(ladder.placements)} pods all bound in {ladder.wall_s:.3f}s; "
        f"after the first batch {ladder.after_first}, after the second "
        f"{ladder.after_second}: exactly one fallback, later waves sharded; "
        f"the single-device rung on the card, select_hosts launches "
        f"{ladder_n}, plain-twin calls 0")

    # (e) the exact scan lane under the mesh, against mesh-off
    c5n = c5_nodes
    plain = [p for p in c5_pods if not p.metadata.name.startswith("special")]
    special = [p for p in c5_pods if p.metadata.name.startswith("special")]
    scan_pods = plain[:MESH_SCAN_PLAIN] + special
    snt, _ = tables.build_node_table(c5n, device=dev)
    spt, _ = tables.build_pod_table(scan_pods, device=dev)
    sex = build_constraint_tables(scan_pods, c5n, [], pod_capacity=spt.capacity,
                                  node_capacity=snt.capacity, scan_planes=True,
                                  device=dev)
    soff, soff_s, soff_n, _ = counted(lambda: SequentialScheduler(
        *chain, weights=weights)(spt, snt, sex))
    son, son_s, son_n, son_plain = counted(lambda: SequentialScheduler(
        *chain, weights=weights, mesh=mesh)(spt, snt, sex))
    # every tile launches once a step: the replays, and the warm-up step
    # run once before the capture
    want_scan = ns * (len(scan_pods) + 1)
    if (not torch.equal(son[1], soff[1]) or not torch.equal(son[2], soff[2])
            or son_plain or son_n != want_scan):
        raise AssertionError(
            f"mesh scan: {int((son[1] != soff[1]).sum())} choices and "
            f"{int((son[2] != soff[2]).sum())} best scores differ; "
            f"{son_n} launches (want {want_scan}), "
            f"{son_plain} plain calls")
    same_tables("mesh scan", son[0], soff[0])
    n_special_placed = int((son[1][MESH_SCAN_PLAIN:len(scan_pods)] >= 0).sum())
    if n_special_placed:
        raise AssertionError(f"mesh scan: {n_special_placed} special pods "
                             "placed")
    launches["select_hosts"]["mesh-scan"] = son_n
    log(f"[mesh-scan] {card}: the exact scan of config 5's first "
        f"{MESH_SCAN_PLAIN} plain and all {len(special)} special pods, full "
        f"roster, in the scan layout ({ns} node shards, pods whole): choice, "
        f"best and final node table bit-identical to mesh-off; "
        f"{son_s:.3f}s on the mesh ({son_s / len(scan_pods) * 1e3:.2f} ms a "
        f"step: one CUDA graph of the {ns} tiles' step, replayed) against "
        f"{soff_s:.3f}s off it; select_hosts launches {son_n} = {ns} x "
        f"({len(scan_pods)} steps + the warm-up step), plain-twin calls 0")
    del soff, son, snt, spt, sex

    # (f) select_hosts at a nonzero node-index base, and the shard merge
    bases = 0
    for n in SELECT_NS:
        for tie_heavy in (False, True):
            sc, mk, sd = select_tensors(*select_case(n, 9, n, tie_heavy), dev)
            for base in (SELECT_BASE, (1 << 31) - 1 - n):
                main_err["select_hosts base"] = max(
                    main_err.get("select_hosts base", 0),
                    check_equal(f"select_hosts N={n} base={base}",
                                kernels.select_hosts_cuda(sc, mk, sd, base),
                                kernels.select_hosts_plain(sc, mk, sd, base)))
                bases += 1
    sc, mk, sd = select_tensors(*select_case(11, 64, 10112), dev)
    width = 10112 // ns
    parts = [kernels.select_hosts_cuda(sc[:, j * width:(j + 1) * width]
                                       .contiguous(),
                                       mk[:, j * width:(j + 1) * width]
                                       .contiguous(), sd, j * width)
             for j in range(ns)]
    check_equal("select_hosts_merge over 4 node shards 64x10112",
                kernels.select_hosts_merge(parts, sd),
                kernels.select_hosts_cuda(sc, mk, sd))
    log(f"[check] select_hosts at a nonzero node base: {bases} edge-row "
        f"cases of kernel_cases (every N of SELECT_NS, base {SELECT_BASE} "
        f"and the largest) bit-exact with the twin; 4 shards' partials of "
        f"64 x 10112 merged by select_hosts_merge equal the whole row's")

    # (g) the compile cache: MINISCHED_CACHE_DIR in a fresh process
    try:
        out, err = cache_child.communicate(timeout=600)
        if cache_child.returncode != 0:
            raise AssertionError(f"compile-cache child: rc "
                                 f"{cache_child.returncode}: {err[-2000:]}")
        info = json.loads(out.strip().splitlines()[-1])
        if (not info["dir"] or not info["dir"].startswith(cache_dir)
                or not info["lib"].startswith(info["dir"])
                or not info["exists"] or not info["ok"]
                or info["launches"] != 1):
            raise AssertionError(f"compile cache: {info}")
        log(f"[compile-cache] MINISCHED_CACHE_DIR=<tmp>: a fresh process "
            f"(run beside (a)-(f)) built and loaded the kernels from "
            f"{info['lib'].replace(cache_dir, '<tmp>')} and launched "
            f"select_hosts bit-exact with its twin, in {info['wall_s']:.1f}s "
            f"from its start")
    finally:
        if cache_child.poll() is None:
            cache_child.kill()
            cache_child.wait()
        shutil.rmtree(cache_dir, ignore_errors=True)
    log(f"[clock] phase 35 took {time.monotonic() - t_phase:.1f}s")
    return handoff


def phase36(dev, card, launches, handoff, c5_nodes, c5_pods) -> None:
    """Phase 36: the mesh across processes (``parallel/distributed.py``):
    two spawned processes, each a 1 x 4 row of this card, form phase
    35's 2 x 4 mesh, one pod shard a process, and run (a)'s repair wave,
    the wave step and the exact scan; ``handoff`` is phase 35's inputs
    and mesh-off answers."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from minisched_tpu_torch.models import tables
    from minisched_tpu_torch.models.constraints import build_constraint_tables
    from minisched_tpu_torch.ops.sequential import SequentialScheduler
    from minisched_tpu_torch.parallel import distributed, rank_steps
    from minisched_tpu_torch.plugins.registry import build_plugins
    from minisched_tpu_torch.service.config import default_full_roster_config

    stamp("36")
    t_phase = time.monotonic()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # (c)'s tables: config 5's first plain pods, the full roster, in scan
    # planes; the children load them with (a)'s from one file
    plain = [p for p in c5_pods if not p.metadata.name.startswith("special")]
    scan_pods = plain[:MESH_SCAN_PLAIN]
    snt, _ = tables.build_node_table(c5_nodes, device=dev)
    spt, _ = tables.build_pod_table(scan_pods, device=dev)
    sex = build_constraint_tables(scan_pods, c5_nodes, [],
                                  pod_capacity=spt.capacity,
                                  node_capacity=snt.capacity,
                                  scan_planes=True, device=dev)
    workdir = tempfile.mkdtemp(prefix="process-mesh-")
    path = os.path.join(workdir, "inputs.pt")
    pt, nt, extra = handoff["wave"]
    rank_steps.save_inputs(path, repair=(pt, nt, extra),
                           step=(pt, nt, extra, "full"), scan=(spt, snt, sex))
    t_spawn = time.monotonic()
    try:
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(distributed.spawn, PROCESS_MESH_RANKS,
                              rank_steps.run_rank,
                              (path, "cuda", PROCESS_MESH_LOCAL, None, 1),
                              PROCESS_MESH_DEADLINE_S)
            # the mesh-off scan, while the children start
            cfg = default_full_roster_config()
            chains = build_plugins(cfg)
            soff = SequentialScheduler(chains.filter, chains.pre_score,
                                       chains.score,
                                       weights=cfg.score_weights())(
                                           spt, snt, sex)
            torch.cuda.synchronize()
            scan_off = {"choice": soff[1].cpu(), "best": soff[2].cpu(),
                        "node_table": {k: v.cpu() for k, v in
                                       tables.table_columns(soff[0]).items()}}
            del soff, snt, spt, sex
            ranks = fut.result()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    spawn_s = time.monotonic() - t_spawn
    off, step_ref = handoff["off"], handoff["step"]
    n_live = MESH_WAVE
    diag = int(bool((off["choice"][:n_live] < 0).any()))

    def same(what, got, want) -> None:
        if isinstance(want, dict):
            if got.keys() != want.keys():
                raise AssertionError(f"{what}: keys {sorted(got)} against "
                                     f"{sorted(want)}")
            for k in want:
                same(f"{what} {k}", got[k], want[k])
        elif isinstance(want, torch.Tensor):
            if not torch.equal(got, want):
                bad = int((got != want).sum()) if got.shape == want.shape \
                    else "shape"
                raise AssertionError(f"{what}: {bad} entries differ")
        elif got != want:
            raise AssertionError(f"{what}: {got} against {want}")

    total = 0
    lines = []
    for rank, r in enumerate(ranks):
        who = f"process mesh rank {rank}"
        if (r["rank"], r["processes"], r["shape"], r["rows"]) != (
                rank, PROCESS_MESH_RANKS,
                (PROCESS_MESH_RANKS, PROCESS_MESH_LOCAL), [rank]):
            raise AssertionError(f"{who}: rank {r['rank']} of "
                                 f"{r['processes']}, mesh {r['shape']}, "
                                 f"rows {r['rows']}")
        if "spans processes" not in (r["engine_refusal"] or ""):
            raise AssertionError(f"{who}: the engine took a mesh across "
                                 f"processes ({r['engine_refusal']})")
        rep, st, sc = r["repair"], r["step"], r["scan"]
        for name in ("choice", "rounds", "unschedulable", "node_table",
                     "carried"):
            same(f"{who}: (a) {name} against phase 35's mesh-off", rep[name],
                 off[name])
        for name in ("choice", "best", "node_table"):
            same(f"{who}: (b) {name} against evaluate and apply_placements",
                 st[name], step_ref[name])
            same(f"{who}: (c) {name} against the mesh-off scan", sc[name],
                 scan_off[name])
        if rank:
            for part in ("repair", "step", "scan"):
                for name, want in ranks[0][part].items():
                    if not name.endswith("_s"):
                        same(f"{who}: {part} {name} against rank 0",
                             r[part][name], want)
        want = {"repair": PROCESS_MESH_LOCAL * (rep["rounds"] + diag),
                "step": PROCESS_MESH_LOCAL,
                "scan": PROCESS_MESH_LOCAL * (len(scan_pods) + 1)}
        for part, n in want.items():
            if r[part]["launches"] != n or r[part]["plain"]:
                raise AssertionError(
                    f"{who}: {part} launched select_hosts "
                    f"{r[part]['launches']} times (want {n}: 4 tiles an "
                    f"evaluation), {r[part]['plain']} plain-twin calls")
            total += r[part]["launches"]
        lines.append(
            f"rank {rank}: wave {rep['wall_s']:.3f}s ({rep['rounds']} rounds; "
            f"in the gather a round {rep['gather_s'] / rep['gather_calls'] * 1e3:.2f}"
            f" ms exchanging after "
            f"{rep['gather_wait_s'] / rep['gather_calls'] * 1e3:.2f} ms "
            f"waiting for the card, over {rep['gather_calls']} gathers), step "
            f"{st['wall_s']:.3f}s (exchange {st['gather_s'] * 1e3:.2f} ms, "
            f"wait {st['gather_wait_s'] * 1e3:.2f} ms, 2 gathers), "
            f"scan {sc['wall_s']:.3f}s ({sc['wall_s'] / len(scan_pods) * 1e3:.2f}"
            f" ms a step); select_hosts launches {rep['launches']} + "
            f"{st['launches']} + {sc['launches']}")
    launches["select_hosts"]["mesh-processes"] = total
    placed = int((off["choice"][:n_live] >= 0).sum())
    log(f"[mesh-processes] {card}: {PROCESS_MESH_RANKS} processes (spawn, "
        f"gloo), each a 1 x {PROCESS_MESH_LOCAL} row of cuda:0, one "
        f"{PROCESS_MESH_RANKS} x {PROCESS_MESH_LOCAL} mesh: (a) config 5's "
        f"repair wave ({N_NODES} nodes x {n_live} pods, full roster, "
        f"diagnostics): choices, rounds, unschedulable masks, final node "
        f"table and carried volume planes bit-identical to phase 35's "
        f"mesh-off wave on every rank ({placed} placed); (b) the wave step's "
        f"choice, best and table equal evaluate and apply_placements; (c) "
        f"the exact scan of {len(scan_pods)} plain pods in the scan layout "
        f"equal the mesh-off scan; ranks equal; the engine refused the "
        f"mesh; spawn to results {spawn_s:.1f}s; " + "; ".join(lines)
        + "; plain-twin calls 0")
    log(f"[clock] phase 36 took {time.monotonic() - t_phase:.1f}s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # imported here: a bare copy of this script must fail, not half-run
    from minisched_tpu_torch.api.objects import Toleration, make_pod
    from minisched_tpu_torch.audit import audit_config5, spread_audit
    from minisched_tpu_torch.engine.oracle import (
        FullRosterScanOracle,
        fullchain_scan_oracle,
        headline_oracle,
    )
    from minisched_tpu_torch.engine.scan_groups import (
        interaction_sets,
        order_into_blocks,
    )
    from minisched_tpu_torch.audit import one_slice_share
    from minisched_tpu_torch.controlplane.codec import _encode
    from minisched_tpu_torch.controlplane.evaluate import evaluate_cluster
    from minisched_tpu_torch.engine.gang import gang_keys, gang_view_from_infos
    from minisched_tpu_torch.engine.scheduler import schedule_pods_sequentially
    from minisched_tpu_torch.controlplane.client import Client
    from minisched_tpu_torch.framework.nodeinfo import build_node_infos
    from minisched_tpu_torch.fullchain import (
        C5_MAX_SKEW,
        HOST_KEY,
        SCAN_BLOCK_SIZE,
        SCAN_MAX_CHUNK,
        c3_roster_config,
        mk_c3_cluster,
        mk_c4_cluster,
        mk_c5_cluster,
        mk_c5_gang_cluster,
        mk_mixed_cluster,
        schedule_crosspod,
        schedule_repair_waves,
        schedule_scan,
    )
    from minisched_tpu_torch.headline import (
        BoundPod,
        make_step,
        mk_cluster,
        pods_by_node,
        repair_evaluator,
        schedule_waves,
    )
    from minisched_tpu_torch.kernel_cases import (
        SELECT_NS,
        garble,
        offset_view,
        repair_planes,
        scan_planes,
        select_case,
        select_tensors,
        toleration_cluster,
    )
    from minisched_tpu_torch.models import tables
    from minisched_tpu_torch.models.constraints import build_constraint_tables
    from minisched_tpu_torch.ops import kernels
    from minisched_tpu_torch.ops.fused import FusedEvaluator
    from minisched_tpu_torch.ops.repair import MAX_ROUNDS
    from minisched_tpu_torch.ops.sequential import (
        BlockedSequentialScheduler,
        SequentialScheduler,
        StepLog,
    )
    from minisched_tpu_torch.plugins.interpodaffinity import InterPodAffinity
    from minisched_tpu_torch.plugins.nodeunschedulable import (
        NodeUnschedulable,
        tolerates_unschedulable,
    )
    from minisched_tpu_torch.plugins.podtopologyspread import PodTopologySpread
    from minisched_tpu_torch.plugins.registry import build_plugins
    from minisched_tpu_torch.profile_repair import profile_repair
    from minisched_tpu_torch.live import (
        AFTER_RESTART_PODS,
        BURST_CPU_M,
        BURST_PRIORITY,
        SPLIT,
        SPLIT_MORE,
        audit_gangs,
        audit_spread,
        audit_records,
        audit_store,
        audit_trace,
        count_grpc_binds,
        free_port,
        HA_TTL_S,
        run_config5_durable,
        run_config5_ha,
        run_config5_http,
        run_config5_live,
        run_config5_remote,
        run_config5_replicated,
        run_config5_sharded,
        run_mixed_recorded,
        run_crosspod_drain,
        run_gang_live,
        store_choices,
    )
    from minisched_tpu_torch.controlplane.httpserver import HTTPClient
    from minisched_tpu_torch.observability.hist import (
        parsed_histogram_quantile,
    )
    from minisched_tpu_torch.scenario.runner import (
        ScenarioHarness,
        readme_scenario,
        readme_scenario_http,
    )
    from minisched_tpu_torch.service.config import (
        default_full_roster_config,
        default_scheduler_config,
        gang_roster_config,
        node_local_roster_config,
    )
    from minisched_tpu_torch.utils import build
    from minisched_tpu_torch import bench as port_bench
    from minisched_tpu_torch.observability import trace as trace_ring

    dev = torch.device("cuda")
    torch.cuda.init()

    # -- phase 1: build ----------------------------------------------------
    stamp("1")
    t0 = time.monotonic()
    build.load_library()
    log(f"[build] kernels built in {time.monotonic() - t0:.2f}s "
        f"({build.library_path()})")
    for line in build.build_log().splitlines():
        if ("registers" in line or "spill" in line or "entry function" in line
                or line.startswith("==")):
            log(f"[build] {line.strip()}")
    smem, resident = kernels.nodenumber_launch_shape(dev)
    log(f"[build] nodenumber_select_hosts_kernel: {smem} B dynamic shared "
        f"memory a block, {resident} blocks resident (its persistent grid)")
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- phase 2: kernels against their twins ------------------------------
    stamp("2")
    gen = torch.Generator(device=dev)

    def plane_case(seed: int, P: int, N: int, tie_heavy: bool,
                   high_seeds: bool = False):
        gen.manual_seed(seed)
        if tie_heavy:
            scores = torch.randint(0, 2, (P, N), generator=gen, device=dev,
                                   dtype=torch.int32) * 10
        else:
            scores = torch.randint(-50, 500, (P, N), generator=gen,
                                   device=dev, dtype=torch.int32)
        mask = torch.rand((P, N), generator=gen, device=dev) < 0.7
        lo = (1 << 32) - 4096 if high_seeds else 0
        seeds = torch.randint(lo, 1 << 32, (P,), generator=gen, device=dev,
                              dtype=torch.int64)
        seeds = torch.where(seeds >= 1 << 31, seeds - (1 << 32), seeds)
        mask[0] = False  # a pod with no feasible node
        return scores.contiguous(), mask.contiguous(), seeds.to(torch.int32)

    plane_cases = {
        "random 256x2048": plane_case(1, 256, 2048, False),
        "tie-heavy 256x2048": plane_case(2, 256, 2048, True),
        "seeds near 2**32 256x2048": plane_case(3, 256, 2048, True, True),
        "P=1 N=300": plane_case(4, 1, 300, True),
        "ragged 77x300": plane_case(5, 77, 300, False, True),
        "main shape 8192x10112 tie-heavy": plane_case(6, WAVE, 10112, True),
    }
    sc, mk, _ = plane_cases["random 256x2048"]
    sc[1], mk[1] = torch.iinfo(torch.int32).min, True  # feasible at INT32_MIN
    for n in SELECT_NS:
        for tie_heavy in (False, True):
            plane_cases[f"edge rows P=9 N={n} tie_heavy={tie_heavy}"] = (
                select_tensors(*select_case(n, 9, n, tie_heavy), dev))
    sc, mk, sd = select_tensors(*select_case(7, 9, 10112), dev)
    plane_cases["planes at a 1-element offset 9x10112"] = (
        offset_view(sc), offset_view(mk), sd)
    for name, (scores, mask, seeds) in plane_cases.items():
        check_equal(f"select_hosts {name}",
                    kernels.select_hosts_cuda(scores, mask, seeds),
                    kernels.select_hosts_plain(scores, mask, seeds))
        log(f"[check] select_hosts {name}: bit-exact with the twin")

    nodes, pods = mk_cluster(N_NODES, N_PODS)
    node_table, _ = tables.build_node_table(nodes, device=dev)
    wave0, _ = tables.build_pod_table(pods[:WAVE], capacity=WAVE, device=dev)

    def tolerating_pods(n: int, seed: int):
        rng = np.random.default_rng(seed)
        tol = Toleration(key="node.kubernetes.io/unschedulable",
                         operator="Exists", effect="NoSchedule")
        return [make_pod(f"tol{i}", tolerations=[tol] if rng.random() < 0.3
                         else []) for i in range(n)]

    small_nodes = nodes[:300]
    nn_cases = {
        "tolerations 100x200": (
            tables.build_pod_table(tolerating_pods(100, 1), device=dev)[0],
            tables.build_node_table(nodes[:200], device=dev)[0]),
        "P=1 N=300": (
            tables.build_pod_table(pods[:1], capacity=1, device=dev)[0],
            tables.build_node_table(small_nodes, capacity=300, device=dev)[0]),
        "ragged 77x300 tolerations": (
            tables.build_pod_table(tolerating_pods(77, 2), capacity=77,
                                   device=dev)[0],
            tables.build_node_table(small_nodes, capacity=300, device=dev)[0]),
        "main shape 8192x10112": (wave0, node_table),
        "main shape, tolerations": (
            tables.build_pod_table(tolerating_pods(WAVE, 3), capacity=WAVE,
                                   device=dev)[0], node_table),
    }
    high = torch.arange(WAVE, device=dev, dtype=torch.int32) - WAVE
    nn_cases["main shape, seeds near 2**32"] = (
        replace(wave0, seed=high), node_table)  # 2**32 - 8192 .. 2**32 - 1
    # every toleration form, garbage past num_tols, invalid rows; one node
    # tile and several (the kernel stages 7,680 nodes at a time)
    for n_nodes, n_pods in ((300, 1), (200, 100), (7681, 77), (20000, 301),
                            (10112, 8191)):
        t_nodes, t_pods = toleration_cluster(n_nodes + n_pods, n_nodes, n_pods)
        nn_cases[f"toleration forms {n_pods}x{n_nodes}"] = (
            garble(tables.build_pod_table(t_pods, capacity=n_pods,
                                          device=dev)[0], n_pods),
            tables.build_node_table(t_nodes, capacity=n_nodes, device=dev)[0])
    main_err = {}
    for name, (pt, nt) in nn_cases.items():
        err = check_equal(f"nodenumber_select_hosts {name}",
                          kernels.nodenumber_select_hosts_cuda(pt, nt),
                          kernels.nodenumber_select_hosts_plain(pt, nt))
        if name == "main shape 8192x10112":
            main_err["nodenumber_select_hosts"] = err
        log(f"[check] nodenumber_select_hosts {name}: bit-exact with the twin")
    pt, nt = nn_cases["toleration forms 301x20000"]
    for ms in (0, -5, 7):
        check_equal(f"nodenumber_select_hosts match_score={ms}",
                    kernels.nodenumber_select_hosts_cuda(pt, nt, ms),
                    kernels.nodenumber_select_hosts_plain(pt, nt, ms))
        log(f"[check] nodenumber_select_hosts 301x20000 match_score={ms}: "
            "bit-exact with the twin")

    # the main-path inputs of the generic route's select_hosts: wave 0's
    # NodeUnschedulable mask and NodeNumber scores against the fresh table
    tol0 = tolerates_unschedulable(wave0)
    main_scores, main_mask = kernels.nodenumber_planes(tol0, wave0, node_table,
                                                       10)
    main_err["select_hosts"] = check_equal(
        "select_hosts main-path planes",
        kernels.select_hosts_cuda(main_scores, main_mask, wave0.seed),
        kernels.select_hosts_plain(main_scores, main_mask, wave0.seed))
    log("[check] select_hosts on the main path's wave-0 planes: bit-exact")

    # the repair route's own planes at config 5's full size: round 1 of
    # wave 0 (every feasible node an identical empty node: tie-heavy) and
    # round 2 of wave 1 (rows committed in round 1 fully masked)
    c5_nodes, c5_pods = mk_c5_cluster(N_NODES, N_PODS)
    repair_ev = repair_evaluator(node_local_roster_config())
    c5_table, _ = tables.build_node_table(c5_nodes, device=dev)
    c5_wave0, _ = tables.build_pod_table(c5_pods[:C5_WAVE], device=dev)
    rep_scores, rep_mask = repair_planes(c5_wave0, c5_table, repair_ev, 0)
    main_err["select_hosts repair"] = check_equal(
        "select_hosts repair round 1 of wave 0",
        kernels.select_hosts_cuda(rep_scores, rep_mask, c5_wave0.seed),
        kernels.select_hosts_plain(rep_scores, rep_mask, c5_wave0.seed))
    log(f"[check] select_hosts on config 5's round-1 repair planes "
        f"{tuple(rep_scores.shape)}: bit-exact")
    c5_wave1, _ = tables.build_pod_table(c5_pods[C5_WAVE:2 * C5_WAVE],
                                         device=dev)
    later_scores, later_mask = repair_planes(
        c5_wave1, repair_ev(c5_wave0, c5_table)[0], repair_ev, 1)
    masked = float((~later_mask.any(dim=1)).float().mean())
    check_equal("select_hosts repair round 2 of wave 1",
                kernels.select_hosts_cuda(later_scores, later_mask,
                                          c5_wave1.seed),
                kernels.select_hosts_plain(later_scores, later_mask,
                                           c5_wave1.seed))
    log(f"[check] select_hosts on config 5's round-2 planes of wave 1 "
        f"({masked:.1%} of rows fully masked): bit-exact")
    del later_scores, later_mask

    # -- phases 3 and 4: the main path, both routes ------------------------
    stamp("3 and 4")
    want = headline_oracle(pods, nodes)
    runs, launches = {}, {}
    for route in ("fused", "generic"):
        kernels.reset_launch_counts()
        run = schedule_waves(nodes, pods, wave=WAVE, route=route)
        counts = dict(kernels.launch_counts)
        runs[route] = run
        log(f"[{route}] {run.n_waves} waves; launches {counts}; host build "
            f"{run.build_s:.3f}s, h2d {run.h2d_s:.3f}s, warmup "
            f"{run.warmup_s:.3f}s, schedule {run.schedule_s:.4f}s = "
            f"{N_PODS / run.schedule_s:,.0f} pods/s")
        if run.choices.shape != (N_PODS,):
            raise AssertionError(f"{route}: {run.choices.shape} choices")
        mismatch = np.flatnonzero(run.choices != want)
        if mismatch.size:
            raise AssertionError(
                f"{route}: {mismatch.size}/{N_PODS} placements differ from "
                f"headline_oracle, first at pod {int(mismatch[0])}")
        log(f"[{route}] all {N_PODS} placements equal headline_oracle")
        kernel = "nodenumber_select_hosts" if route == "fused" else "select_hosts"
        if counts[kernel] <= 0:
            raise AssertionError(f"{route}: {kernel} was never launched")
        launches[kernel] = counts[kernel]
    if not np.array_equal(runs["fused"].choices, runs["generic"].choices):
        raise AssertionError("the two routes chose differently")
    fused_cols = tables.table_columns(runs["fused"].node_table)
    for name, col in tables.table_columns(runs["generic"].node_table).items():
        if not torch.equal(col, fused_cols[name]):
            raise AssertionError(f"final node tables differ in {name}")
    placed = int((runs["fused"].choices >= 0).sum())
    if int(runs["fused"].node_table.req_pods.sum()) != placed or placed != N_PODS:
        raise AssertionError(f"{placed} placed, table holds "
                             f"{int(runs['fused'].node_table.req_pods.sum())}")
    log("[routes] equal choices; final node tables equal column for column")

    # -- phase 5: time per wave at the main-path shapes --------------------
    stamp("5")
    def candidates(scores, mask) -> int:
        best = scores.masked_fill(~mask, torch.iinfo(torch.int32).min)
        return int((mask & (best == best.max(dim=1, keepdim=True).values))
                   .sum())

    P, N = main_scores.shape
    cand = candidates(main_scores, main_mask)
    T = wave0.tol_key.shape[1]
    # the prologue's work per (pod, toleration slot): the slot range, two
    # effect compares and an or, key, op and value compares, the value's
    # or, the wildcard's and, two ands, an or and the any
    prologue_ops = 13 * P * T

    def select_work(scores, mask):
        """(bytes, int ops) of select_hosts: a 4-byte score and a 1-byte
        mask read per pair, seeds read and (choice, best) written per pod;
        a compare and running max per pair and a mix32 and compare per
        candidate at the row's max."""
        p, n = scores.shape
        return (p * n * 5 + p * 4 + 2 * p * 4,
                2 * p * n + MIX32_OPS * candidates(scores, mask))

    # the fused chain's candidates follow from a pod's suffix and
    # toleration class alone, so it needs no work per pair: classifying
    # each node (valid, unschedulable, suffix, its group), the prologue,
    # and the mix32 and compare of each candidate.  Bytes: node
    # unschedulable, suffix, valid; pod valid, suffix, seed, the four i32
    # toleration columns and tol_empty_key per slot, num_tols; choice, best
    cases = {
        ("select_hosts", "generic"): (
            lambda: kernels.select_hosts_cuda(main_scores, main_mask,
                                              wave0.seed),
            lambda: kernels.select_hosts_plain(main_scores, main_mask,
                                               wave0.seed),
            select_work(main_scores, main_mask), (P, N)),
        ("select_hosts", "repair"): (
            lambda: kernels.select_hosts_cuda(rep_scores, rep_mask,
                                              c5_wave0.seed),
            lambda: kernels.select_hosts_plain(rep_scores, rep_mask,
                                               c5_wave0.seed),
            select_work(rep_scores, rep_mask), tuple(rep_scores.shape)),
        ("nodenumber_select_hosts", "fused"): (
            lambda: kernels.nodenumber_select_hosts_cuda(wave0, node_table),
            lambda: kernels.nodenumber_select_hosts_plain(wave0, node_table),
            (N * 6 + P * (1 + 4 + 4) + P * T * 17 + P * 4 + 2 * P * 4,
             4 * N + prologue_ops + MIX32_OPS * cand), (P, N)),
    }
    timed = {}

    def time_kernel(name, path, kernel_fn, plain_fn, work, shape) -> None:
        """Phase 5's timing of one kernel at one shape, into ``timed``."""
        nbytes, n_ops = work
        plain_a = time_ms(plain_fn, rounds=5, batch=2)
        ms = graph_time_ms(kernel_fn, rounds=9, batch=20)
        ms_b = graph_time_ms(kernel_fn, rounds=9, batch=20)
        eager = time_ms(kernel_fn, rounds=9, batch=20)
        plain_b = time_ms(plain_fn, rounds=5, batch=2)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / INT32_OPS_PER_S * 1e3
        timed[name, path] = t = {
            "P": shape[0], "N": shape[1],
            "ms": min(ms, ms_b),
            "plain_ms": min(plain_a, plain_b),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        log(f"[time] {name} ({path} path) P={shape[0]} N={shape[1]}: kernel "
            f"{ms:.5f} / {ms_b:.5f} ms (graph replay; {eager:.5f} ms "
            f"launched one by one from Python), plain {plain_a:.4f} / "
            f"{plain_b:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {nbytes} B, {n_ops} int ops); "
            f"{t['bound_ms'] / t['ms']:.1%} of the bound")

    def select_on_planes(what: str, path: str, scores, mask, seeds) -> None:
        """Phase 2's check and phase 5's timing of ``select_hosts`` on a
        path's own planes."""
        main_err[f"select_hosts {path}"] = check_equal(
            f"select_hosts {what}",
            kernels.select_hosts_cuda(scores, mask, seeds),
            kernels.select_hosts_plain(scores, mask, seeds))
        log(f"[check] select_hosts on {what} {tuple(scores.shape)}: bit-exact "
            f"with the twin")
        time_kernel("select_hosts", path,
                    lambda: kernels.select_hosts_cuda(scores, mask, seeds),
                    lambda: kernels.select_hosts_plain(scores, mask, seeds),
                    select_work(scores, mask), tuple(scores.shape))
        based_time(path, scores, mask, seeds)

    def based_time(path: str, scores, mask, seeds) -> None:
        """``select_hosts`` at a nonzero node-index base (a mesh's node
        shard), checked and timed on the same planes as at base 0."""
        check_equal(f"select_hosts {path} base {SELECT_BASE}",
                    kernels.select_hosts_cuda(scores, mask, seeds,
                                              SELECT_BASE),
                    kernels.select_hosts_plain(scores, mask, seeds,
                                               SELECT_BASE))
        time_kernel("select_hosts", f"{path} base {SELECT_BASE}",
                    lambda: kernels.select_hosts_cuda(scores, mask, seeds,
                                                      SELECT_BASE),
                    lambda: kernels.select_hosts_plain(scores, mask, seeds,
                                                       SELECT_BASE),
                    select_work(scores, mask), tuple(scores.shape))

    for (name, path), (kernel_fn, plain_fn, work, shape) in cases.items():
        time_kernel(name, path, kernel_fn, plain_fn, work, shape)
    based_time("generic", main_scores, main_mask, wave0.seed)
    based_time("repair", rep_scores, rep_mask, c5_wave0.seed)
    del main_scores, main_mask

    # -- phase 6: config 5 at full size, repair waves ----------------------
    stamp("6")
    kernels.reset_launch_counts()
    c5 = schedule_repair_waves(c5_nodes, c5_pods, wave=C5_WAVE,
                               cfg=node_local_roster_config())
    c5_counts = dict(kernels.launch_counts)
    n_special = sum(p.metadata.name.startswith("special") for p in c5_pods)
    placed = c5.choices >= 0
    log(f"[config5] {c5.n_waves} waves of {C5_WAVE}; rounds per wave "
        f"{c5.rounds} ({sum(c5.rounds)} in all); {int(placed.sum())} of "
        f"{len(c5_pods)} pods placed; launches {c5_counts}; host build "
        f"{c5.build_s:.3f}s, h2d {c5.h2d_s:.3f}s, warmup {c5.warmup_s:.3f}s, "
        f"schedule {c5.schedule_s:.4f}s = "
        f"{len(c5_pods) / c5.schedule_s:,.0f} pods/s")
    if max(c5.rounds) >= MAX_ROUNDS:
        raise AssertionError(f"a wave hit the {MAX_ROUNDS}-round cap: "
                             f"{c5.rounds}")
    if c5_counts["select_hosts"] < sum(c5.rounds):
        raise AssertionError(f"select_hosts launched {c5_counts} for "
                             f"{sum(c5.rounds)} rounds")
    audit_config5(c5, c5_nodes, c5_pods)
    if int(placed.sum()) != len(c5_pods) - n_special:
        raise AssertionError(f"{int(placed.sum())} placed, expected "
                             f"{len(c5_pods) - n_special}")
    failing = sorted(name for name, m in c5.unschedulable.items() if m.any())
    log(f"[config5] audit passed: final table = initial + recount, no node "
        f"over allocatable, no pod on a cordoned node, no special pod "
        f"placed, no unplaced plain pod fits; unplaced pods fail {failing}")
    launches = {"select_hosts": {"generic": launches["select_hosts"],
                                 "repair": c5_counts["select_hosts"]},
                "nodenumber_select_hosts": {
                    "fused": launches["nodenumber_select_hosts"]}}

    # -- phase 7: reduced config 5, the card against the twins -------------
    stamp("7")
    r_nodes, r_pods = mk_c5_cluster(*C5_REDUCED)
    t0 = time.monotonic()
    on_card = schedule_repair_waves(r_nodes, r_pods, wave=4_096,
                                    cfg=node_local_roster_config())
    card_s = time.monotonic() - t0
    t0 = time.monotonic()
    on_cpu = schedule_repair_waves(r_nodes, r_pods, wave=4_096, device="cpu",
                                   cfg=node_local_roster_config())
    cpu_s = time.monotonic() - t0
    check_twin_runs("reduced config 5", on_card, on_cpu, tables)
    log(f"[config5-reduced] {C5_REDUCED[0]:,} nodes x {C5_REDUCED[1]:,} "
        f"pods, waves of 4,096: card "
        f"and CPU twins equal (choices, rounds {on_card.rounds}, "
        f"unschedulable masks, every final table column); "
        f"{card_s:.2f}s on the card, {cpu_s:.2f}s on the CPU")

    # -- phase 8: config 5 at full size, the full default roster -----------
    stamp("8")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    c5f = schedule_repair_waves(c5_nodes, c5_pods, wave=C5_WAVE)
    c5f_counts = dict(kernels.launch_counts)
    c5f_peak = torch.cuda.max_memory_allocated()
    if max(c5f.rounds) >= MAX_ROUNDS:
        raise AssertionError(f"full roster: a wave hit the round cap: "
                             f"{c5f.rounds}")
    if c5f_counts["select_hosts"] < sum(c5f.rounds):
        raise AssertionError(f"full roster: select_hosts launched "
                             f"{c5f_counts} for {sum(c5f.rounds)} rounds")
    audit_config5(c5f, c5_nodes, c5_pods)
    if not np.array_equal(c5f.choices, c5.choices) or c5f.rounds != c5.rounds:
        bad = np.flatnonzero(c5f.choices != c5.choices)
        raise AssertionError(f"full roster vs node-local: {bad.size} choices "
                             f"differ; rounds {c5f.rounds} vs {c5.rounds}")
    node_local_cols = tables.table_columns(c5.node_table)
    for name, col in tables.table_columns(c5f.node_table).items():
        if not torch.equal(col, node_local_cols[name]):
            raise AssertionError(f"full roster vs node-local: final tables "
                                 f"differ in {name}")
    failing = sorted(name for name, m in c5f.unschedulable.items() if m.any())
    log(f"[config5-full] {len(c5f.unschedulable)} filters; rounds {c5f.rounds}; "
        f"{int((c5f.choices >= 0).sum())} placed; audit passed; choices, "
        f"rounds and final table equal phase 6's; unplaced pods fail "
        f"{failing}; peak device memory {c5f_peak / 2**30:.2f} GiB")

    # the same with kubelet's labels: every node its own hostname, so the
    # node label sets (Dp) number 10,000 instead of 16
    h_nodes = mk_c5_cluster(N_NODES, N_PODS)[0]
    for node in h_nodes:
        node.metadata.labels[HOST_KEY] = node.metadata.name
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    c5h = schedule_repair_waves(h_nodes, c5_pods, wave=C5_WAVE)
    c5h_counts = dict(kernels.launch_counts)
    c5h_peak = torch.cuda.max_memory_allocated()
    if c5h_counts["select_hosts"] < sum(c5h.rounds):
        raise AssertionError(f"hostnames: select_hosts launched "
                             f"{c5h_counts} for {sum(c5h.rounds)} rounds")
    audit_config5(c5h, h_nodes, c5_pods)
    if not np.array_equal(c5h.choices, c5.choices) or c5h.rounds != c5.rounds:
        bad = np.flatnonzero(c5h.choices != c5.choices)
        raise AssertionError(f"hostnames vs node-local: {bad.size} choices "
                             f"differ; rounds {c5h.rounds} vs {c5.rounds}")
    for name, col in tables.table_columns(c5h.node_table).items():
        if name.startswith("prof_") or name == "profile_id":
            continue  # the label sets differ by construction
        if not torch.equal(col, node_local_cols[name]):
            raise AssertionError(f"hostnames vs node-local: final tables "
                                 f"differ in {name}")
    log(f"[config5-hostnames] {c5h.node_table.prof_label_key.shape[0]} label "
        f"sets; rounds {c5h.rounds}; audit passed; choices, rounds and final "
        f"resource columns equal phase 6's; schedule {c5h.schedule_s:.4f}s "
        f"(constraint build {c5h.constraint_build_s:.4f}s; phase 8 "
        f"{c5f.schedule_s:.4f}s); peak device memory "
        f"{c5h_peak / 2**30:.2f} GiB; select_hosts launches "
        f"{c5h_counts['select_hosts']}")
    del h_nodes
    c5_waves = [c5_pods[s:s + C5_WAVE] for s in range(0, len(c5_pods), C5_WAVE)]
    profiled = {
        roster: profile_repair(make_step("repair", cfg), c5_nodes, c5_waves,
                               dev, reps=0)
        for roster, cfg in (("node-local", node_local_roster_config()),
                            ("full", default_full_roster_config()))}
    for roster, run, counts in (("node-local", c5, c5_counts),
                                ("full", c5f, c5f_counts)):
        pr = profiled[roster]
        log(f"[config5-compare] {roster:10s}: schedule {run.schedule_s:.4f}s "
            f"(constraint build {run.constraint_build_s:.4f}s), "
            f"{sum(run.rounds)} rounds, device "
            f"{pr['device_ms_per_round']:.3f} ms a round (profiled pass: busy "
            f"{pr['device_busy_ms']:.1f} ms, idle share "
            f"{pr['device_idle_share']:.3f}), select_hosts launches "
            f"{counts['select_hosts']}")
    launches["select_hosts"]["full-roster"] = c5f_counts["select_hosts"]
    launches["select_hosts"]["full-roster-hostnames"] = c5h_counts["select_hosts"]

    # -- phase 9: config 4 at its own size ---------------------------------
    stamp("9")
    c4_nodes, c4_assigned, c4_pods = mk_c4_cluster()

    def config4(device):
        t0 = time.monotonic()
        nt, _ = tables.build_node_table(c4_nodes, pods_by_node(c4_assigned),
                                        device=device)
        pt, _ = tables.build_pod_table(c4_pods, device=device)
        t1 = time.monotonic()
        extra = build_constraint_tables(
            c4_pods, c4_nodes, c4_assigned, pod_capacity=pt.capacity,
            node_capacity=nt.capacity, device=device)
        build = (t1 - t0, time.monotonic() - t1)
        ipa, ts = InterPodAffinity(), PodTopologySpread()
        ev = FusedEvaluator([NodeUnschedulable(), ipa, ts], [], [ipa, ts])
        ev(pt, nt, extra)  # first launches
        best = float("inf")
        for _ in range(3):
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.monotonic()
            res = ev(pt, nt, extra)
            choice = res.choice.cpu().numpy()[: len(c4_pods)]
            best = min(best, time.monotonic() - t0)
        return choice, best, build, extra

    kernels.reset_launch_counts()
    c4_card, c4_s, c4_build, c4_extra = config4(dev)
    c4_counts = dict(kernels.launch_counts)
    c4_cpu, c4_cpu_s, _, _ = config4(torch.device("cpu"))
    if not np.array_equal(c4_card, c4_cpu):
        bad = np.flatnonzero(c4_card != c4_cpu)
        raise AssertionError(f"config 4: {bad.size} choices differ card vs "
                             f"CPU, first at pod {int(bad[0])}")
    if c4_counts["select_hosts"] < 4:
        raise AssertionError(f"config 4: select_hosts launches {c4_counts}")
    placed4 = int((c4_card >= 0).sum())
    log(f"[config4] {len(c4_nodes)} nodes x {len(c4_pods)} pods "
        f"({len(c4_assigned)} assigned), affinity+spread wave: "
        f"{c4_s * 1e3:.3f} ms best of 3 = {len(c4_pods) / c4_s:,.0f} pods/s "
        f"({placed4} placed; slots in use {c4_extra.in_use}); host builds: "
        f"node+pod tables {c4_build[0]:.3f}s, constraint tables "
        f"{c4_build[1]:.3f}s; CPU twins {c4_cpu_s * 1e3:.1f} ms; card and "
        f"CPU choices equal")
    launches["select_hosts"]["config4"] = c4_counts["select_hosts"]
    del c4_extra

    # -- phase 10: the mixed cluster, the card against the twins -----------
    stamp("10")
    m_nodes, m_assigned, m_pods, m_pvcs, m_pvs = mk_mixed_cluster(
        n_pods=MIXED_PODS)
    probe = build_constraint_tables(
        m_pods[:MIXED_WAVE], m_nodes, m_assigned, pod_capacity=MIXED_WAVE,
        node_capacity=tables.pad_to(len(m_nodes)), pvcs=m_pvcs, pvs=m_pvs,
        scan_planes=False, device=dev)
    top = int(probe.combo_dsum.max())
    if top <= 4096 or not (probe.in_use.ts_hard and probe.in_use.ts_soft
                           and probe.in_use.ex and probe.in_use.rev):
        raise AssertionError(f"mixed cluster misses a feature: top domain "
                             f"sum {top}, {probe.in_use}")
    del probe
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    m_card = schedule_repair_waves(m_nodes, m_pods, wave=MIXED_WAVE,
                                   assigned=m_assigned, pvcs=m_pvcs, pvs=m_pvs)
    m_card_s = time.monotonic() - t0
    m_counts = dict(kernels.launch_counts)
    m_peak = torch.cuda.max_memory_allocated()
    t0 = time.monotonic()
    m_cpu = schedule_repair_waves(m_nodes, m_pods, wave=MIXED_WAVE,
                                  device="cpu", assigned=m_assigned,
                                  pvcs=m_pvcs, pvs=m_pvs)
    m_cpu_s = time.monotonic() - t0
    check_twin_runs("mixed cluster", m_card, m_cpu, tables)
    for w, (got, want) in enumerate(zip(m_card.volumes, m_cpu.volumes)):
        for name in want:
            if not np.array_equal(got[name], want[name]):
                raise AssertionError(f"mixed cluster wave {w}: carried "
                                     f"{name} differs card vs CPU")
    if len(m_card.volumes) != m_card.n_waves:
        raise AssertionError("mixed cluster: carried volume planes missing")
    if m_counts["select_hosts"] < sum(m_card.rounds):
        raise AssertionError(f"mixed cluster: select_hosts {m_counts}")
    failing = sorted(name for name, m in m_card.unschedulable.items()
                     if m.any())
    log(f"[mixed] {len(m_nodes)} nodes x {len(m_pods)} pods "
        f"({len(m_assigned)} assigned; top zone domain sum {top}), waves of "
        f"{MIXED_WAVE}: rounds {m_card.rounds}, "
        f"{int((m_card.choices >= 0).sum())} placed; card and CPU twins equal "
        f"(choices, rounds, unschedulable masks, final tables, carried "
        f"vol_any/vol_rw/node_vols_fam); unplaced pods fail {failing}; "
        f"{m_card_s:.2f}s on the card (constraint build "
        f"{m_card.constraint_build_s:.2f}s, peak device memory "
        f"{m_peak / 2**30:.2f} GiB, {m_card.node_table.prof_label_key.shape[0]} "
        f"label sets), {m_cpu_s:.2f}s on the CPU")
    launches["select_hosts"]["mixed"] = m_counts["select_hosts"]
    del m_card, m_cpu

    # -- phases 11-13: the scan lanes --------------------------------------
    def loop_line(lg, n_pods: int, wall: float, peak: int) -> str:
        """The step loops of one scan: steps replayed, device ms a step
        (CUDA events around the replays), device ops and select_hosts
        launches recorded in one step's graph, capture time, wall, peak."""
        steps = sum(s.steps for s in lg.loops)
        timed_steps = [s for s in lg.loops if s.device_ms_per_step]
        dev_ms = (sum(s.device_ms_per_step * s.steps for s in timed_steps)
                  / sum(s.steps for s in timed_steps))
        ops = sorted({s.device_ops_per_step for s in lg.loops})
        first = lg.loops[0]
        top = "; ".join(f"{name[:60]} x{count} {us:.1f} us"
                        for name, count, us in first.top_ops)
        return (f"{len(lg.loops)} graphs, {steps} steps replayed, device "
                f"{dev_ms:.4f} ms a step, device ops a step {ops}, "
                f"select_hosts {first.select_hosts_per_step} a step, "
                f"capture {sum(s.capture_s for s in lg.loops):.3f}s; wall "
                f"{wall:.3f}s = {n_pods / wall:,.0f} pods/s; peak device "
                f"memory {peak / 2**30:.2f} GiB; first graph's profiled "
                f"replay: ops busy {first.replay_busy_us:.1f} us of a "
                f"{first.replay_span_us:.1f} us span, most time: {top}")

    def check_scan_counts(what: str, lg, counts) -> None:
        steps = sum(s.steps for s in lg.loops)
        if counts["select_hosts"] < steps or any(
                s.select_hosts_per_step != 1 for s in lg.loops):
            raise AssertionError(f"{what}: select_hosts launched "
                                 f"{counts['select_hosts']} for {steps} steps")

    # -- phase 11: config 3, the exact scan ---------------------------------
    stamp("11")
    c3_nodes, c3_pods = mk_c3_cluster()
    c3_chains = build_plugins(c3_roster_config())
    c3_sched = SequentialScheduler(c3_chains.filter, c3_chains.pre_score,
                                   c3_chains.score)

    def c3_tables(pods, device):
        nt, _ = tables.build_node_table(c3_nodes, device=device)
        pt, _ = tables.build_pod_table(pods, device=device)
        return pt, nt

    c3_pt, c3_nt = c3_tables(c3_pods, dev)
    c3_log = StepLog(count_ops=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    _, c3_choice, c3_best = c3_sched(c3_pt, c3_nt, log=c3_log)
    c3_choice = c3_choice.cpu().numpy()[: len(c3_pods)]
    c3_wall = time.monotonic() - t0
    c3_counts = dict(kernels.launch_counts)
    c3_peak = torch.cuda.max_memory_allocated()
    check_scan_counts("config 3", c3_log, c3_counts)
    c3_want = FullRosterScanOracle(
        c3_nodes, tables.DEFAULT_NONZERO_CPU, tables.DEFAULT_NONZERO_MEM_MIB,
        with_balanced=False).place_all(c3_pods)
    bad = np.flatnonzero(c3_choice != c3_want)
    if bad.size:
        raise AssertionError(f"config 3: {bad.size}/{len(c3_pods)} placements "
                             f"differ from the oracle, first at pod {bad[0]}")
    C3_PREFIX = 256
    _, cpu_choice, cpu_best = c3_sched(*c3_tables(c3_pods[:C3_PREFIX], "cpu"))
    if not (np.array_equal(cpu_choice.numpy()[:C3_PREFIX],
                           c3_choice[:C3_PREFIX])
            and np.array_equal(cpu_best.numpy()[:C3_PREFIX],
                               c3_best.cpu().numpy()[:C3_PREFIX])):
        raise AssertionError("config 3: card and CPU twins differ on the "
                             f"first {C3_PREFIX} pods")
    log(f"[scan-c3] {len(c3_nodes)} nodes x {len(c3_pods)} pods, Fit + "
        f"LeastAllocated, exact scan: all {len(c3_pods)} placements equal "
        f"FullRosterScanOracle ({int((c3_choice >= 0).sum())} placed); card "
        f"= CPU twins on the first {C3_PREFIX}; "
        + loop_line(c3_log, len(c3_pods), c3_wall, c3_peak))
    launches["select_hosts"]["scan-c3"] = c3_counts["select_hosts"]
    del c3_pt, c3_nt

    # -- phase 12: config 5, the full roster, the exact scan ----------------
    stamp("12")
    # the first plain pods, then every special* pod (a selector no node
    # matches): all of config 5 took the whole script to 1,131 s of its
    # 1,200 on an H100 80GB HBM3 at 700 W (PERF.md §5)
    c5_special = [p_ for p_ in c5_pods
                  if p_.metadata.name.startswith("special")]
    s5_nodes = c5_nodes
    s5_pods = c5_pods[:C5_SCAN_PLAIN] + c5_special
    full_cfg = default_full_roster_config()
    full_chains = build_plugins(full_cfg)
    full_scan = SequentialScheduler(full_chains.filter, full_chains.pre_score,
                                    full_chains.score,
                                    weights=full_cfg.score_weights())
    # step 0's planes: select_hosts at (1, 10,112)
    s5_nt, _ = tables.build_node_table(s5_nodes, device=dev)
    s5_pt, _ = tables.build_pod_table(s5_pods[:SCAN_MAX_CHUNK], device=dev)
    s5_ex = build_constraint_tables(
        s5_pods[:SCAN_MAX_CHUNK], s5_nodes, [], pod_capacity=s5_pt.capacity,
        node_capacity=s5_nt.capacity, scan_planes=True, device=dev)
    select_on_planes("step 0 of the config-5 exact scan", "scan-c5",
                     *scan_planes(full_scan, s5_pt, s5_nt, s5_ex, 1),
                     s5_pt.seed[:1])
    del s5_nt, s5_pt, s5_ex
    s5_log = StepLog(count_ops=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    s5 = schedule_scan(s5_nodes, s5_pods, log=s5_log)
    s5_counts = dict(kernels.launch_counts)
    s5_peak = torch.cuda.max_memory_allocated()
    check_scan_counts("config 5 scan", s5_log, s5_counts)
    t0 = time.monotonic()
    s5_want = fullchain_scan_oracle(s5_pods, s5_nodes)
    oracle_s = time.monotonic() - t0
    bad = np.flatnonzero(s5.choices != s5_want)
    if bad.size:
        raise AssertionError(f"config 5 scan: {bad.size}/{len(s5_pods)} "
                             "placements differ from fullchain_scan_oracle, "
                             f"first at pod {bad[0]}")
    if (s5.choices[C5_SCAN_PLAIN:] >= 0).any():
        raise AssertionError("config 5 scan: a special* pod was placed")
    C5_PREFIX = 64
    s5_cpu = schedule_scan(s5_nodes, s5_pods[:C5_PREFIX], device="cpu")
    if not (np.array_equal(s5_cpu.choices, s5.choices[:C5_PREFIX])
            and np.array_equal(s5_cpu.best, s5.best[:C5_PREFIX])):
        raise AssertionError("config 5 scan: card and CPU twins differ on "
                             f"the first {C5_PREFIX} pods")
    log(f"[scan-c5] {N_NODES} nodes x {len(s5_pods)} pods (the first "
        f"{C5_SCAN_PLAIN} plain pods and the {len(c5_special)} special* "
        f"pods of config 5), full roster, exact scan in {s5.chunks} chunks of "
        f"{SCAN_MAX_CHUNK}: all placements equal fullchain_scan_oracle "
        f"({int((s5.choices >= 0).sum())} placed; oracle {oracle_s:.1f}s); "
        f"card = CPU twins on the first {C5_PREFIX}; host node table "
        f"{s5.build_s:.3f}s, constraint builds {s5.constraint_build_s:.3f}s "
        f"of the wall; " + loop_line(s5_log, len(s5_pods), s5.schedule_s,
                                     s5_peak))
    launches["select_hosts"]["scan-c5"] = s5_counts["select_hosts"]
    del s5

    # -- phase 13: config 5 with 5,000 spread pods, the blocked lane --------
    stamp("13")
    def crosspod_run(nodes, pods, device, wave, lg=None):
        """Repair waves of ``wave`` for the plain and special pods, then
        the blocked lane for the spread pods: (waves, lane run, choices of
        every pod in the cluster's order)."""
        is_spread = np.array([p.metadata.name.startswith("spread")
                              for p in pods])
        spread = [p for p, sp in zip(pods, is_spread) if sp]
        rest = [p for p, sp in zip(pods, is_spread) if not sp]
        waves = schedule_repair_waves(nodes, rest, wave=wave, device=device)
        placed = [BoundPod(p, waves.node_names[c])
                  for p, c in zip(rest, waves.choices) if c >= 0]
        if lg is not None:  # the first block's planes: select_hosts at 32 rows
            order = [m for m in order_into_blocks(
                spread, interaction_sets(spread), SCAN_BLOCK_SIZE)[0]
                if m is not None]
            pt, _ = tables.build_pod_table(order, device=device)
            ex = build_constraint_tables(
                order, nodes, placed, pod_capacity=pt.capacity,
                node_capacity=waves.node_table.capacity, scan_planes=True,
                device=device)
            blocked = BlockedSequentialScheduler(
                full_chains.filter, full_chains.pre_score, full_chains.score,
                weights=full_cfg.score_weights())
            sc, mk = scan_planes(blocked, pt, waves.node_table, ex,
                                 len(order))
            select_on_planes("block 0 of the config-5 blocked lane",
                             "blocked-c5x", sc, mk, pt.seed[:len(order)])
            del pt, ex, sc, mk
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
        lane = schedule_crosspod(nodes, spread, waves.node_table, placed,
                                 device=device, log=lg)
        choices = np.full(len(pods), -1, np.int64)
        choices[~is_spread] = waves.choices
        choices[is_spread] = lane.choices
        return waves, lane, choices

    x_nodes, x_pods = mk_c5_cluster(N_NODES, N_PODS, n_crosspod=C5X_SPREAD)
    x_log = StepLog(count_ops=True)
    x_waves, x_lane, x_choices = crosspod_run(x_nodes, x_pods, dev, C5_WAVE,
                                              x_log)
    x_counts = dict(kernels.launch_counts)
    x_peak = torch.cuda.max_memory_allocated()
    check_scan_counts("config 5 blocked lane", x_log, x_counts)
    audit_config5(SimpleNamespace(node_table=x_lane.node_table,
                                  choices=x_choices), x_nodes, x_pods)
    spread_apps = spread_audit(x_nodes, x_pods, x_choices, C5_MAX_SKEW)
    log(f"[blocked-c5x] {N_NODES} nodes x {N_PODS} pods with {C5X_SPREAD} "
        f"spread pods: repair waves {x_waves.rounds} for the rest "
        f"({x_waves.schedule_s:.3f}s), then the blocked lane: blocks per "
        f"attempt {x_lane.blocks}, {x_lane.attempts} attempts, "
        f"{len(x_lane.calls)} calls, {x_lane.exact_pods} pods left to the "
        f"exact scan, {int((x_lane.choices >= 0).sum())} of {C5X_SPREAD} "
        f"placed; audit passed over every pod; spread audit: {spread_apps} "
        f"apps within max skew {C5_MAX_SKEW}; grouping "
        f"{x_lane.grouping_s:.3f}s, constraint builds "
        f"{x_lane.constraint_build_s:.3f}s of the wall; "
        + loop_line(x_log, C5X_SPREAD, x_lane.schedule_s, x_peak))
    launches["select_hosts"]["blocked-c5x"] = x_counts["select_hosts"]
    del x_waves, x_lane

    # 1,520 nodes leave about one free slot a node after the plain pods,
    # so the spread pods race for them: retries in every attempt
    r_nodes, r_pods = mk_c5_cluster(C5X_REDUCED_NODES, 20_000, n_crosspod=1_000)
    t0 = time.monotonic()
    _, r_card, r_card_choices = crosspod_run(r_nodes, r_pods, dev, 4_096)
    card_s = time.monotonic() - t0
    t0 = time.monotonic()
    _, r_cpu, r_cpu_choices = crosspod_run(r_nodes, r_pods,
                                           torch.device("cpu"), 4_096)
    cpu_s = time.monotonic() - t0
    if not np.array_equal(r_card_choices, r_cpu_choices):
        raise AssertionError("reduced blocked lane: choices differ card vs CPU")
    if ((r_card.attempts, r_card.blocks, r_card.exact_pods)
            != (r_cpu.attempts, r_cpu.blocks, r_cpu.exact_pods)
            or len(r_card.calls) != len(r_cpu.calls)):
        raise AssertionError("reduced blocked lane: attempts, blocks or "
                             "leftovers differ card vs CPU")
    if r_card.attempts < 2:
        raise AssertionError("reduced blocked lane: no capacity race, so no "
                             "retry was compared")
    for (rows, won), (c_rows, c_won) in zip(r_card.calls, r_cpu.calls):
        if not (np.array_equal(rows, c_rows) and np.array_equal(won, c_won)):
            raise AssertionError("reduced blocked lane: a call's choices or "
                                 "accepted masks differ card vs CPU")
    cpu_cols = tables.table_columns(r_cpu.node_table)
    for name, col in tables.table_columns(r_card.node_table).items():
        if not torch.equal(col.cpu(), cpu_cols[name]):
            raise AssertionError(f"reduced blocked lane: final tables differ "
                                 f"in {name}")
    log(f"[blocked-c5x-reduced] {C5X_REDUCED_NODES:,} nodes x 20,000 pods "
        f"with 1,000 spread pods: card and CPU twins equal (every choice, "
        f"{len(r_card.calls)} calls' choices and accepted masks, "
        f"{r_card.attempts} attempts, blocks per attempt {r_card.blocks}, "
        f"{r_card.exact_pods} exact-lane leftovers, every final table "
        f"column); {int((r_card.choices >= 0).sum())} spread pods placed; "
        f"{card_s:.2f}s on the card, {cpu_s:.2f}s on the CPU")

    # -- phase 14: config 5 with gangs, repair waves -----------------------
    stamp("14")
    g_nodes, g_assigned, g_pods = mk_c5_gang_cluster()
    gang_cfg = gang_roster_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    g = schedule_repair_waves(g_nodes, g_pods, wave=C5_WAVE, cfg=gang_cfg,
                              assigned=g_assigned)
    g_counts = dict(kernels.launch_counts)
    g_peak = torch.cuda.max_memory_allocated()
    if max(g.rounds) >= MAX_ROUNDS:
        raise AssertionError(f"gangs: a wave hit the round cap: {g.rounds}")
    if g_counts["select_hosts"] < sum(g.rounds):
        raise AssertionError(f"gangs: select_hosts launched {g_counts} for "
                             f"{sum(g.rounds)} rounds")
    audit_config5(g, g_nodes, g_pods, g_assigned)
    g_special = sum(p.metadata.name.startswith("special") for p in g_pods)
    if int((g.choices >= 0).sum()) != len(g_pods) - g_special:
        raise AssertionError(f"gangs: {int((g.choices >= 0).sum())} placed")
    # (b) each wave's gang columns against the view of a snapshot of the
    # placements so far
    on_node = {n.metadata.name: [] for n in g_nodes}
    for p in g_assigned:
        on_node[p.spec.node_name].append(p)
    warm_rows = []
    for w, s in enumerate(range(0, len(g_pods), C5_WAVE)):
        batch = g_pods[s:s + C5_WAVE]
        infos = [SimpleNamespace(node=n, pods=on_node[n.metadata.name])
                 for n in g_nodes]
        want_view = gang_view_from_infos(infos, gang_keys(batch))
        if g.gang_views[w] != want_view:
            raise AssertionError(f"gangs wave {w}: the view differs from "
                                 "gang_view_from_infos")
        used = tables.with_gang_view(
            tables.build_pod_table(batch, capacity=C5_WAVE, device=dev)[0],
            batch, g.gang_views[w])
        want_cols = tables.build_pod_table(batch, capacity=C5_WAVE,
                                           device=dev, gang_view=want_view)[0]
        for name in ("gang_id",) + tables.GANG_AGG_FIELDS:
            if not torch.equal(getattr(used, name), getattr(want_cols, name)):
                raise AssertionError(f"gangs wave {w}: column {name} differs")
        warm_rows.append(int((used.gang_n > 0).sum()))
        for p, c in zip(batch, g.choices[s:s + C5_WAVE]):
            if c >= 0:
                on_node[g_nodes[c].metadata.name].append(p)
    del used, want_cols
    g_waves = [g_pods[s:s + C5_WAVE] for s in range(0, len(g_pods), C5_WAVE)]
    g_prof = profile_repair(make_step("repair", gang_cfg), g_nodes, g_waves,
                            dev, reps=0, assigned=g_assigned)
    share = one_slice_share(g_nodes, g_assigned, g_pods, g.choices)
    g_full = schedule_repair_waves(g_nodes, g_pods, wave=C5_WAVE,
                                   assigned=g_assigned)
    share_full = one_slice_share(g_nodes, g_assigned, g_pods, g_full.choices)
    del g_full
    log(f"[gang-c5] {len(g_nodes)} nodes on {len(g_nodes) // 16} slices x "
        f"{len(g_pods)} pods ({sum(p.spec.gang is not None for p in g_pods)} "
        f"pending gang members, {len(g_assigned)} assigned), "
        f"gang_roster_config, waves of {C5_WAVE}: rounds {g.rounds}, "
        f"{int((g.choices >= 0).sum())} placed; audit passed; every wave's "
        f"gang view and columns equal gang_view_from_infos' (warm rows per "
        f"wave {warm_rows}); schedule {g.schedule_s:.4f}s = "
        f"{len(g_pods) / g.schedule_s:,.0f} pods/s (constraint build "
        f"{g.constraint_build_s:.4f}s, gang views {g.gang_view_s:.4f}s), "
        f"host build {g.build_s:.3f}s, h2d {g.h2d_s:.3f}s; device "
        f"{g_prof['device_ms_per_round']:.3f} ms a round (profiled pass: "
        f"idle share {g_prof['device_idle_share']:.3f}); peak device memory "
        f"{g_peak / 2**30:.2f} GiB; select_hosts launches "
        f"{g_counts['select_hosts']}; gangs on one slice: {share['one_slice']}"
        f" of {share['complete']} ({share['share']:.3f}) with GangTopology, "
        f"{share_full['one_slice']} ({share_full['share']:.3f}) under "
        f"default_full_roster_config")
    launches["select_hosts"]["gang-c5"] = g_counts["select_hosts"]
    del g

    # (c) no gang specs: the gang roster places config 5 as phase 8
    kernels.reset_launch_counts()
    c5g = schedule_repair_waves(c5_nodes, c5_pods, wave=C5_WAVE, cfg=gang_cfg)
    c5g_counts = dict(kernels.launch_counts)
    if not np.array_equal(c5g.choices, c5f.choices) or c5g.rounds != c5f.rounds:
        raise AssertionError("gang roster without gangs differs from phase 8")
    full_cols = tables.table_columns(c5f.node_table)
    for name, col in tables.table_columns(c5g.node_table).items():
        if not torch.equal(col, full_cols[name]):
            raise AssertionError(f"gang roster without gangs: final tables "
                                 f"differ in {name}")
    log(f"[gang-identity] config 5 without gang specs under "
        f"gang_roster_config: choices, rounds {c5g.rounds} and final table "
        f"equal phase 8's; schedule {c5g.schedule_s:.4f}s (phase 8 "
        f"{c5f.schedule_s:.4f}s)")
    launches["select_hosts"]["gang-identity"] = c5g_counts["select_hosts"]
    del c5g

    # (d) a reduced copy, the card against the twins: repair waves and the
    # exact scan of its first pods
    rg_nodes, rg_assigned, rg_pods = mk_c5_gang_cluster(
        GANG_REDUCED_NODES, 10_000, n_gangs=GANG_REDUCED_GANGS)
    t0 = time.monotonic()
    rg_card = schedule_repair_waves(rg_nodes, rg_pods, wave=4_096,
                                    cfg=gang_cfg, assigned=rg_assigned)
    card_s = time.monotonic() - t0
    t0 = time.monotonic()
    rg_cpu = schedule_repair_waves(rg_nodes, rg_pods, wave=4_096,
                                   device="cpu", cfg=gang_cfg,
                                   assigned=rg_assigned)
    cpu_s = time.monotonic() - t0
    check_twin_runs("reduced gang cluster", rg_card, rg_cpu, tables)
    if rg_card.gang_views != rg_cpu.gang_views:
        raise AssertionError("reduced gang cluster: gang views differ")
    warm = sum(len(v) for v in rg_card.gang_views)
    rg_share = one_slice_share(rg_nodes, rg_assigned, rg_pods, rg_card.choices)
    kernels.reset_launch_counts()
    sg_card = schedule_scan(rg_nodes, rg_pods[:GANG_SCAN_PODS], cfg=gang_cfg,
                            assigned=rg_assigned)
    sg_counts = dict(kernels.launch_counts)
    sg_cpu = schedule_scan(rg_nodes, rg_pods[:GANG_SCAN_PODS], cfg=gang_cfg,
                           assigned=rg_assigned, device="cpu")
    if not (np.array_equal(sg_card.choices, sg_cpu.choices)
            and np.array_equal(sg_card.best, sg_cpu.best)
            and sg_card.gang_views == sg_cpu.gang_views):
        raise AssertionError("gang exact scan: card and CPU twins differ")
    if sg_counts["select_hosts"] < GANG_SCAN_PODS:
        raise AssertionError(f"gang exact scan: select_hosts {sg_counts}")
    log(f"[gang-reduced] {GANG_REDUCED_NODES} nodes x {len(rg_pods)} pods "
        f"({GANG_REDUCED_GANGS} gangs), waves of 4,096: card and CPU twins "
        f"equal (choices, rounds {rg_card.rounds}, unschedulable masks, "
        f"final tables, gang views: {warm} warm gang entries); gangs on one "
        f"slice: {rg_share['one_slice']} of {rg_share['complete']} "
        f"({rg_share['share']:.3f}); "
        f"{card_s:.2f}s on the card, {cpu_s:.2f}s on the CPU; exact scan "
        f"of the first {GANG_SCAN_PODS} pods in {sg_card.chunks} chunks: "
        f"card = CPU twins (choices, best, {len(sg_card.gang_views)} chunk "
        f"views); scan {sg_card.schedule_s:.3f}s on the card, "
        f"{sg_cpu.schedule_s:.2f}s on the CPU")
    launches["select_hosts"]["scan-gang"] = sg_counts["select_hosts"]
    del rg_card, rg_cpu, sg_card, sg_cpu

    # -- phase 15: Evaluate ------------------------------------------------
    stamp("15")
    def request(nodes_, pods_, assigned_=(), pvcs_=(), pvs_=(), mode="repair"):
        return {"nodes": [_encode(o) for o in nodes_],
                "pods": [_encode(o) for o in pods_],
                "assigned": [_encode(o) for o in assigned_],
                "pvcs": [_encode(o) for o in pvcs_],
                "pvs": [_encode(o) for o in pvs_], "mode": mode}

    ev_cases = {
        "config4 wave": request(c4_nodes, c4_pods, c4_assigned, mode="wave"),
        "config4 repair": request(c4_nodes, c4_pods, c4_assigned),
        "mixed repair": request(m_nodes, m_pods[:MIXED_WAVE], m_assigned,
                                m_pvcs, m_pvs),
    }
    ev_launches = 0
    ev_results = {}  # name -> (card answer, CPU answer, wall, times)
    for name, req in ev_cases.items():
        evaluate_cluster(req)  # first launches of this shape
        times = {}
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        card_out = evaluate_cluster(req, times=times)
        wall = time.monotonic() - t0
        counts = dict(kernels.launch_counts)
        t0 = time.monotonic()
        cpu_out = evaluate_cluster(req, device="cpu")
        cpu_wall = time.monotonic() - t0
        if card_out != cpu_out:
            bad = sum(card_out["placements"][k] != v
                      for k, v in cpu_out["placements"].items())
            raise AssertionError(f"evaluate {name}: card and CPU differ "
                                 f"({bad} placements, rounds "
                                 f"{card_out['rounds']} vs {cpu_out['rounds']})")
        if counts["select_hosts"] < card_out["rounds"]:
            raise AssertionError(f"evaluate {name}: select_hosts {counts}")
        ev_launches += counts["select_hosts"]
        ev_results[name] = (card_out, cpu_out, wall, times)
        placed_n = sum(v is not None for v in card_out["placements"].values())
        log(f"[evaluate] {name}: {len(req['nodes'])} nodes x "
            f"{len(req['pods'])} pods, rounds {card_out['rounds']}, "
            f"{placed_n} placed; card = CPU; a call {wall * 1e3:.1f} ms = "
            f"decode {times['decode'] * 1e3:.1f} + build "
            f"{times['build'] * 1e3:.1f} + evaluate "
            f"{times['evaluate'] * 1e3:.1f} ms; CPU {cpu_wall:.2f}s")
    launches["select_hosts"]["evaluate"] = ev_launches

    def diagnostics(device):
        nt, _ = tables.build_node_table(c4_nodes, pods_by_node(c4_assigned),
                                        device=device)
        pt, _ = tables.build_pod_table(c4_pods, device=device)
        extra = build_constraint_tables(
            c4_pods, c4_nodes, c4_assigned, pod_capacity=pt.capacity,
            node_capacity=nt.capacity, device=device)
        cfg = default_full_roster_config()
        chains = build_plugins(cfg)
        return FusedEvaluator(chains.filter, chains.pre_score, chains.score,
                              weights=cfg.score_weights(),
                              with_diagnostics=True)(pt, nt, extra)

    d_card, d_cpu = diagnostics(dev), diagnostics(torch.device("cpu"))
    for field in ("choice", "best_score", "feasible_count", "filter_masks",
                  "score_matrices", "raw_score_matrices"):
        if not torch.equal(getattr(d_card, field).cpu(),
                           getattr(d_cpu, field)):
            raise AssertionError(f"config 4 diagnostics: {field} differs "
                                 "card vs CPU")
    log(f"[evaluate-diagnostics] config 4, full roster, FusedEvaluator with "
        f"diagnostics: filter masks {tuple(d_card.filter_masks.shape)}, "
        f"score matrices {tuple(d_card.score_matrices.shape)} and raw score "
        f"matrices equal card vs CPU")
    del d_card, d_cpu

    def counters_line(cnt) -> str:
        return ", ".join(f"{k} {v}" for k, v in cnt.items())

    def lanes_line(stats) -> str:
        return "; ".join(
            f"{name}: {st.placed} pods placed in {st.calls} calls, "
            f"{st.steps} {'blocks' if name == 'blocked' else 'steps'}, "
            f"{st.rounds} rounds, {st.to_exact} left to the exact scan, "
            f"capture {st.capture_s:.3f}s, select_hosts {st.select_hosts}"
            for name, st in stats.items())

    def live_launches(what: str, min_launches: int) -> int:
        """The ``select_hosts`` launches of the live run just finished;
        raises unless it launched on the card and called no plain twin."""
        counts, plain = dict(kernels.launch_counts), dict(kernels.plain_calls)
        if counts["select_hosts"] < min_launches or any(plain.values()):
            raise AssertionError(f"{what}: launches {counts}, plain-twin "
                                 f"calls {plain}")
        return counts["select_hosts"]

    def check_burst(what: str, b, n_burst: int) -> None:
        """Phase 22's checks of a burst: every preemptor bound; the pods
        gone from the store exactly the reported victims, each of
        priority 0."""
        highs = [k for k, v in b.placements.items()
                 if k.startswith("high") and v]
        low = [k for k, prio in b.deleted.items() if prio != 0]
        if (len(highs) != n_burst or set(b.deleted) != set(b.reported)
                or low or not b.deleted or not b.passes):
            raise AssertionError(
                f"{what} burst: {len(highs)}/{n_burst} bound, deleted "
                f"{sorted(b.deleted)[:5]} ({len(b.deleted)}), reported "
                f"{sorted(b.reported)[:5]} ({len(b.reported)}), priority "
                f"above 0: {low[:5]}, passes {b.passes}")

    # -- phase 16: the README scenario on the live engine ------------------
    stamp("16")
    kernels.reset_launch_counts()
    with ScenarioHarness(default_scheduler_config(time_scale=0.01),
                         max_wave=64) as h:
        readme_node = readme_scenario(h, log=lambda m: log(f"[readme] {m}"))
        readme_errors = h.service.scheduler.loop_errors
    if readme_node != "node10" or readme_errors:
        raise AssertionError(f"README scenario: pod1 on {readme_node!r}, "
                             f"{readme_errors} loop errors")
    launches["select_hosts"]["live-readme"] = live_launches("readme", 2)
    log(f"[readme] live engine on the card: pod1 parked, then bound to "
        f"node10; loop errors 0; select_hosts launches "
        f"{launches['select_hosts']['live-readme']}")

    # -- phase 17: config 5, live, full width ------------------------------
    stamp("17")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    c5l = run_config5_live(N_NODES, LIVE_C5_PODS, max_wave=C5_WAVE,
                           pipeline=False)
    phase17_pods_s = LIVE_C5_PODS / c5l.total_s
    launches["select_hosts"]["live-c5"] = live_launches("live config 5",
                                                        c5l.waves)
    c5l_peak = torch.cuda.max_memory_allocated()
    audited = audit_store(c5l.client, c5l.labelled)
    if (audited["bound"] != LIVE_C5_PODS or c5l.loop_errors
            or c5l.assumed_left):
        raise AssertionError(f"live config 5: {audited['bound']} bound, "
                             f"{c5l.loop_errors} loop errors, "
                             f"{c5l.assumed_left} assumed left")
    ref = schedule_repair_waves(c5l.nodes, c5l.pods, wave=C5_WAVE)
    want = [ref.node_names[c] if c >= 0 else "" for c in ref.choices]
    got = [c5l.first_drain[p.metadata.name] for p in c5l.pods]
    bad = [p.metadata.name for p, g_, w in zip(c5l.pods, got, want)
           if g_ != w]
    if bad:
        raise AssertionError(f"live config 5: {len(bad)} first-drain binds "
                             f"differ from schedule_repair_waves, first "
                             f"{bad[:3]}")
    del ref
    c5l_prof = profile_repair(make_step("repair", default_full_roster_config()),
                              c5l.nodes, [c5l.pods[:C5_WAVE]], dev, reps=0)
    split_line = ", ".join(f"{k} {c5l.split[k]:.3f}s" for k in SPLIT)
    log(f"[live-c5] {card}: config 5 live, {N_NODES} nodes x "
        f"{LIVE_C5_PODS} pods, full roster, waves of {C5_WAVE} "
        f"({c5l.waves} waves): store setup {c5l.setup_s:.2f}s, service "
        f"start {c5l.start_s:.2f}s; first drain {c5l.first_drain_s:.3f}s "
        f"({LIVE_C5_PODS - len(c5l.labelled)} bound, "
        f"{len(c5l.labelled)} parked; every bind equal to "
        f"schedule_repair_waves on the same waves); requeue tail "
        f"{c5l.total_s - c5l.first_drain_s:.3f}s (label loop "
        f"{c5l.label_loop_s:.3f}s, bound wait {c5l.bound_wait_s:.3f}s); "
        f"total {c5l.total_s:.3f}s = {LIVE_C5_PODS / c5l.total_s:,.0f} "
        f"pods/s; "
        f"split: {split_line}; device {c5l_prof['device_ms_per_round']:.3f} "
        f"ms a round (one wave profiled); peak device memory "
        f"{c5l_peak / 2**30:.2f} GiB; time to bind p50 <= "
        f"{c5l.ttb_p50_le_s}s, p99 <= {c5l.ttb_p99_le_s}s; audit passed, "
        f"assume cache drained, loop errors 0, select_hosts launches "
        f"{launches['select_hosts']['live-c5']}, plain-twin calls 0; "
        f"builder: {counters_line(c5l.counters)}")
    serial17 = (c5l.first_drain_s, c5l.total_s - c5l.first_drain_s,
                c5l.total_s, dict(c5l.split))
    del c5l

    # -- phase 18: gangs, live, all or nothing -----------------------------
    stamp("18")
    kernels.reset_launch_counts()
    gl = run_gang_live(GANG_REDUCED_NODES, 10_000, GANG_REDUCED_GANGS)
    launches["select_hosts"]["live-gang"] = live_launches("live gangs", 1)
    gangs_audited = audit_gangs(gl.client)
    if gl.loop_errors or gl.assumed_left or gl.pending_gangs:
        raise AssertionError(f"live gangs: {gl.loop_errors} loop errors, "
                             f"{gl.assumed_left} assumed left, ledger "
                             f"{gl.pending_gangs}")
    gl_share = one_slice_share(gl.nodes, gl.assigned, gl.pods,
                               store_choices(gl.client, gl.nodes, gl.pods))
    log(f"[live-gang] {GANG_REDUCED_NODES} nodes x {len(gl.pods)} pods "
        f"({gangs_audited['gangs']} gangs of 8), gang_roster_config, waves "
        f"of 4,096: {gl.bound} bound in {gl.wall_s:.3f}s; every gang fully "
        f"bound, none partly; Coscheduling ledger empty, assume cache "
        f"drained, no node over allocatable, loop errors 0; gangs on one "
        f"slice: {gl_share['one_slice']} of {gl_share['complete']} "
        f"({gl_share['share']:.3f}) live, {rg_share['one_slice']} of "
        f"{rg_share['complete']} ({rg_share['share']:.3f}) in phase 14's "
        f"wave driver; select_hosts launches "
        f"{launches['select_hosts']['live-gang']}")
    del gl

    # -- phase 19: config 5 live, pipelined --------------------------------
    stamp("19")
    # (phase 22's burst follows on the same run: the counts of phase 19
    # are read, and set to 0, just before the preemptors arrive)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    phase19 = {}

    def end_of_phase19() -> None:
        phase19["launches"] = live_launches("pipelined config 5", 1)
        phase19["peak"] = torch.cuda.max_memory_allocated()
        kernels.reset_launch_counts()

    c5p = run_config5_live(N_NODES, LIVE_C5_PODS,
                           max_wave=C5_WAVE,
                           preempt_burst=PREEMPT_BURST,
                           before_burst=end_of_phase19)
    burst = c5p.burst
    launches["select_hosts"]["live-preempt"] = live_launches(
        "preemption burst", burst.waves)
    if phase19["launches"] < c5p.waves:
        raise AssertionError(f"pipelined config 5: {phase19['launches']} "
                             f"launches for {c5p.waves} waves")
    launches["select_hosts"]["live-c5-pipelined"] = phase19["launches"]
    c5p_peak = phase19["peak"]
    audited = audit_store(c5p.client, c5p.labelled)
    n_final = (LIVE_C5_PODS + burst.fillers + PREEMPT_BURST
               - len(burst.deleted))
    if (audited["bound"] != n_final or c5p.loop_errors or c5p.assumed_left
            or not c5p.pipelined or not c5p.counters["wave_pipeline.waves"]):
        raise AssertionError(f"pipelined config 5: {audited['bound']} bound, "
                             f"{c5p.loop_errors} loop errors, "
                             f"{c5p.assumed_left} assumed left, counters "
                             f"{c5p.counters}")
    fd17, tail17, total17, split17 = serial17
    keys = SPLIT + SPLIT_MORE
    split_line = ", ".join(f"{k} {c5p.split[k]:.3f}s (serial {split17[k]:.3f})"
                           for k in keys)
    log(f"[live-c5-pipelined] {card}: config 5 live, pipelined, {N_NODES} "
        f"nodes x {LIVE_C5_PODS} pods, waves of {C5_WAVE} "
        f"({c5p.waves} waves): first drain {c5p.first_drain_s:.3f}s (serial, "
        f"phase 17: {fd17:.3f}s); tail "
        f"{c5p.total_s - c5p.first_drain_s:.3f}s (serial {tail17:.3f}s); "
        f"total {c5p.total_s:.3f}s = {LIVE_C5_PODS / c5p.total_s:,.0f} "
        f"pods/s (serial {total17:.3f}s = {LIVE_C5_PODS / total17:,.0f} "
        f"pods/s); split: "
        f"{split_line}; counters: {counters_line(c5p.counters)}; peak "
        f"device memory {c5p_peak / 2**30:.2f} GiB; time to bind p50 <= "
        f"{c5p.ttb_p50_le_s}s, p99 <= {c5p.ttb_p99_le_s}s; audit passed, "
        f"assume cache drained, loop errors 0, select_hosts launches "
        f"{launches['select_hosts']['live-c5-pipelined']}")
    phase19.update(first_drain_s=c5p.first_drain_s, total_s=c5p.total_s)
    check_burst("config 5", burst, PREEMPT_BURST)
    per_pass = burst.post_filter_s / max(burst.passes, 1)
    log(f"[live-preempt] {card}: phase 19's config 5, all "
        f"{LIVE_C5_PODS} bound, "
        f"most CPU free on a node {burst.max_free_cpu_m}m; {burst.fillers} "
        f"fill pods (500m, priority 0) topped nodes up to at most "
        f"{burst.max_free_filled_cpu_m}m free; {PREEMPT_BURST} preemptors "
        f"of {BURST_CPU_M}m and 1Gi at priority {BURST_PRIORITY}: all "
        f"bound, burst wall {burst.wall_s:.3f}s (first create to last "
        f"bind) in {burst.waves} waves; PostFilter passes {burst.passes}, "
        f"{per_pass:.3f}s a pass ({burst.post_filter_s:.3f}s); victims "
        f"{len(burst.deleted)}, every one reported in last_victims and of "
        f"priority 0; losers_handle {burst.losers_handle_s:.3f}s, "
        f"wave_preempt_eligible {burst.preempt_eligible}; audit passed "
        f"({audited['bound']} bound), assume cache drained, loop errors 0, "
        f"select_hosts launches {launches['select_hosts']['live-preempt']}, "
        f"plain-twin calls 0")
    del c5p, burst

    # -- phase 20: config 5 with 5,000 spread pods, live, pipelined --------
    stamp("20")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    c5x = run_config5_live(N_NODES, LIVE_C5X_PODS, max_wave=C5_WAVE,
                           n_crosspod=C5X_SPREAD)
    launches["select_hosts"]["live-c5x"] = live_launches(
        "live config 5 with spread pods", c5x.waves)
    c5x_peak = torch.cuda.max_memory_allocated()
    audited = audit_store(c5x.client, c5x.labelled)
    apps = audit_spread(c5x.client, C5_MAX_SKEW)
    lanes = c5x.scan_stats
    lane_placed = lanes["blocked"].placed + lanes["exact"].placed
    if (audited["bound"] != LIVE_C5X_PODS or c5x.loop_errors
            or c5x.assumed_left or lane_placed != C5X_SPREAD or not lanes["blocked"].calls):
        raise AssertionError(f"live config 5 with spread pods: "
                             f"{audited['bound']} bound, {c5x.loop_errors} "
                             f"loop errors, {c5x.assumed_left} assumed left, "
                             f"lanes {lanes}")
    scan_line = ", ".join(f"{k} {c5x.split[k]:.3f}s" for k in keys)
    log(f"[live-c5x] {card}: config 5 with {C5X_SPREAD} spread pods live, "
        f"pipelined, {N_NODES} nodes x {LIVE_C5X_PODS} pods ({c5x.waves} "
        f"waves): "
        f"first drain {c5x.first_drain_s:.3f}s, tail "
        f"{c5x.total_s - c5x.first_drain_s:.3f}s, total {c5x.total_s:.3f}s "
        f"= {LIVE_C5X_PODS / c5x.total_s:,.0f} pods/s; lanes: "
        f"{lanes_line(lanes)}; "
        f"select_hosts launches at P = 32: {lanes['blocked'].select_hosts}, "
        f"at P = 1: {lanes['exact'].select_hosts}, all "
        f"{launches['select_hosts']['live-c5x']}; split: {scan_line}; "
        f"counters: {counters_line(c5x.counters)}; peak device memory "
        f"{c5x_peak / 2**30:.2f} GiB; audit and spread audit ({apps} apps, "
        f"max skew {C5_MAX_SKEW}) passed, every special pod bound through "
        f"requeue, loop errors 0")
    del c5x

    # -- phase 21: reduced, serial engine, card against CPU ----------------
    stamp("21")
    r21 = (C5X_REDUCED_NODES, LIVE_REDUCED_PODS, 1_000)
    for attempt in range(1, 4):
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        d_card = run_crosspod_drain(*r21, max_wave=4_096)
        card_s = time.monotonic() - t0
        launches["select_hosts"]["live-reduced"] = live_launches(
            "reduced live, card", d_card.waves)
        t0 = time.monotonic()
        d_cpu = run_crosspod_drain(*r21, max_wave=4_096, device="cpu")
        cpu_s = time.monotonic() - t0
        if d_card.loop_errors or d_cpu.loop_errors:
            raise AssertionError(f"reduced live: loop errors card "
                                 f"{d_card.loop_errors}, CPU "
                                 f"{d_cpu.loop_errors}")
        bad = [k for k, v in d_card.placements.items()
               if d_cpu.placements.get(k) != v]
        shape = [(d.waves, {k: (v.calls, v.steps, v.rounds)
                            for k, v in d.scan_stats.items()})
                 for d in (d_card, d_cpu)]
        if not bad:
            log(f"[live-reduced] attempt {attempt}: every binding equal")
            break
        if shape[0] == shape[1]:
            raise AssertionError(f"reduced live: {len(bad)} bindings differ "
                                 f"card vs CPU on equal waves and lane calls, "
                                 f"first {bad[:3]}")
        log(f"[live-reduced] attempt {attempt}: {len(bad)} bindings differ; "
            f"cause: a timing race (waves and lane calls card {shape[0]}, "
            f"CPU {shape[1]})")
    else:
        raise AssertionError("reduced live: card and CPU differ in 3 attempts")
    n_bound = sum(1 for v in d_card.placements.values() if v)
    lanes = d_card.scan_stats
    if lanes["exact"].placed < 1 or lanes["blocked"].rounds < 2:
        raise AssertionError(f"reduced live: lanes {lanes}: the lone pod "
                             f"skipped the exact scan or no blocked retry")
    kernels.reset_launch_counts()
    d_pipe = run_crosspod_drain(*r21, max_wave=4_096, pipeline=True)
    launches["select_hosts"]["live-reduced-pipelined"] = live_launches(
        "reduced live, pipelined", d_pipe.waves)
    audit_store(d_pipe.client)
    apps = audit_spread(d_pipe.client, C5_MAX_SKEW)
    if d_pipe.loop_errors or not d_pipe.placements["lone"]:
        raise AssertionError(f"reduced live, pipelined: {d_pipe.loop_errors} "
                             f"loop errors, lone pod on "
                             f"{d_pipe.placements['lone']!r}")
    log(f"[live-reduced] {C5X_REDUCED_NODES:,} nodes x {r21[1]:,} pods with "
        f"{r21[2]:,} spread pods, serial engine, to the first drain and a "
        f"lone spread pod: card and CPU twins bind alike ({n_bound} bound, "
        f"every binding equal; {d_card.waves} waves; lanes: "
        f"{lanes_line(lanes)}); {card_s:.2f}s on the card, {cpu_s:.2f}s on "
        f"the CPU; pipelined on the card: {d_pipe.wall_s:.2f}s, "
        f"{d_pipe.waves} waves, audits passed ({apps} apps), lone pod bound")
    del d_card, d_cpu, d_pipe

    # -- phase 22, reduced: serial engine, card against CPU ----------------
    stamp("22")
    n22, p22, b22 = PREEMPT_REDUCED
    for attempt in range(1, 4):
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        r_card = run_config5_live(n22, p22, max_wave=4_096, pipeline=False,
                                  preempt_burst=b22)
        card_s = time.monotonic() - t0
        launches["select_hosts"]["live-preempt-reduced"] = live_launches(
            "reduced preemption, card", r_card.waves + r_card.burst.waves)
        t0 = time.monotonic()
        r_cpu = run_config5_live(n22, p22, max_wave=4_096, pipeline=False,
                                 preempt_burst=b22, device="cpu")
        cpu_s = time.monotonic() - t0
        for what, r in (("card", r_card), ("CPU", r_cpu)):
            if r.loop_errors or r.assumed_left:
                raise AssertionError(f"reduced preemption, {what}: "
                                     f"{r.loop_errors} loop errors, "
                                     f"{r.assumed_left} assumed left")
            check_burst(f"reduced ({what})", r.burst, b22)
            audit_store(r.client, r.labelled)
        bc, bp = r_card.burst, r_cpu.burst
        diff = {k: getattr(bc, k) != getattr(bp, k)
                for k in ("placements", "nominations", "reported")}
        shape = [(r.waves, r.burst.waves, r.burst.passes)
                 for r in (r_card, r_cpu)]
        if not any(diff.values()):
            log(f"[live-preempt-reduced] attempt {attempt}: every binding, "
                f"nomination and victim equal")
            break
        if shape[0] == shape[1]:
            raise AssertionError(f"reduced preemption: {diff} differ card "
                                 f"vs CPU on equal waves and passes {shape}")
        log(f"[live-preempt-reduced] attempt {attempt}: {diff} differ; "
            f"cause: a timing race (waves, burst waves, passes: card "
            f"{shape[0]}, CPU {shape[1]})")
    else:
        raise AssertionError("reduced preemption: card and CPU differ in 3 "
                             "attempts")
    log(f"[live-preempt-reduced] {n22:,} nodes x {p22:,} pods, serial "
        f"engine, {bc.fillers} fill pods, {b22} preemptors: card and CPU "
        f"twins alike ({len(bc.placements)} bindings, {len(bc.nominations)} "
        f"nominations, {len(bc.deleted)} victims, every one reported and of "
        f"priority 0); burst wall {bc.wall_s:.3f}s on the card, "
        f"{bp.wall_s:.3f}s on the CPU; {bc.passes} passes, "
        f"{bc.post_filter_s / max(bc.passes, 1):.3f}s a pass on the card; "
        f"whole runs {card_s:.2f}s and {cpu_s:.2f}s")
    del r_card, r_cpu, bc, bp

    # -- phase 23: the exact scan against the scalar loop, mixed cluster ---
    stamp("23")
    x_nodes, x_assigned, x_pods, x_pvcs, x_pvs = mk_mixed_cluster()
    x_pods = x_pods[:MIXED_SCALAR_PODS]
    x_log = StepLog()
    kernels.reset_launch_counts()
    x_scan = schedule_scan(x_nodes, x_pods, assigned=x_assigned, pvcs=x_pvcs,
                           pvs=x_pvs, log=x_log)
    x_counts = dict(kernels.launch_counts)
    check_scan_counts("mixed scan", x_log, x_counts)
    launches["select_hosts"]["scan-mixed-scalar"] = x_counts["select_hosts"]
    x_cfg = default_full_roster_config()
    x_chains = build_plugins(x_cfg)
    x_client = Client()
    for pvc in x_pvcs:
        x_client.store.create("PersistentVolumeClaim", pvc)
    for pv in x_pvs:
        x_client.store.create("PersistentVolume", pv)
    for p in x_chains.needs_client:
        p.store_client = x_client
    t0 = time.monotonic()
    x_want = schedule_pods_sequentially(
        x_chains.filter, x_chains.pre_score, x_chains.score,
        x_cfg.score_weights(), x_pods,
        build_node_infos(sorted(x_nodes, key=lambda n: n.metadata.name),
                         x_assigned))
    x_scalar_s = time.monotonic() - t0
    x_got = [x_scan.node_names[c] if c >= 0 else "" for c in x_scan.choices]
    bad = [i for i, (g_, w) in enumerate(zip(x_got, x_want)) if g_ != w]
    if bad:
        raise AssertionError(f"mixed scan: {len(bad)}/{len(x_pods)} "
                             f"placements differ from "
                             f"schedule_pods_sequentially, first at pod "
                             f"{bad[0]}")
    kernels.reset_launch_counts()
    with ScenarioHarness(default_scheduler_config(time_scale=0.01),
                         device_mode=False) as h:
        scalar_node = readme_scenario(h, log=lambda m: None)
        scalar_errors = h.service.scheduler.loop_errors
    scalar_counts = dict(kernels.launch_counts)
    scalar_plain = dict(kernels.plain_calls)
    if (scalar_node != "node10" or scalar_errors
            or any(scalar_counts.values()) or any(scalar_plain.values())):
        raise AssertionError(f"README scenario, scalar engine: pod1 on "
                             f"{scalar_node!r}, {scalar_errors} loop errors, "
                             f"launches {scalar_counts}, plain-twin calls "
                             f"{scalar_plain}")
    log(f"[scan-mixed-scalar] {len(x_nodes)} nodes x the first "
        f"{len(x_pods)} pods of the mixed cluster ({len(x_assigned)} "
        f"assigned, {len(x_pvcs)} claims), full roster: every exact-scan "
        f"placement on the card equal to schedule_pods_sequentially "
        f"({sum(1 for g_ in x_got if g_)} placed; scan "
        f"{x_scan.schedule_s:.3f}s, scalar loop {x_scalar_s:.3f}s on the "
        f"host); select_hosts launches "
        f"{launches['select_hosts']['scan-mixed-scalar']}; README scenario "
        f"on the scalar engine (device_mode=False): pod1 bound to node10, "
        f"host only (0 kernel launches, 0 plain-twin calls), loop errors 0")
    del x_scan, x_client

    # -- phase 24: record_results, the mixed cluster, card against CPU ------
    stamp("24")
    for attempt in range(1, 4):
        kernels.reset_launch_counts()
        rec_card = run_mixed_recorded(RECORD_NODES, RECORD_PODS,
                                      max_wave=RECORD_WAVE)
        launches["select_hosts"]["live-record"] = live_launches(
            "record_results, card", rec_card.waves + rec_card.record_calls)
        rec_cpu = run_mixed_recorded(RECORD_NODES, RECORD_PODS,
                                     max_wave=RECORD_WAVE, device="cpu")
        for what, r in (("card", rec_card), ("CPU", rec_cpu)):
            if r.loop_errors or r.record_errors:
                raise AssertionError(f"record_results, {what}: "
                                     f"{r.loop_errors} loop errors, "
                                     f"{r.record_errors} record errors")
        bad = [k for k, v in rec_card.placements.items()
               if rec_cpu.placements.get(k) != v]
        bad_ann = [k for k, v in rec_card.annotations.items()
                   if rec_cpu.annotations.get(k) != v]
        shape = [(r.waves, r.record_calls,
                  {k: (v.calls, v.steps, v.rounds)
                   for k, v in r.scan_stats.items()})
                 for r in (rec_card, rec_cpu)]
        if not bad and not bad_ann:
            log(f"[live-record] attempt {attempt}: every binding and every "
                f"annotation equal")
            break
        if shape[0] == shape[1]:
            raise AssertionError(f"record_results: {len(bad)} bindings and "
                                 f"{len(bad_ann)} annotations differ card "
                                 f"vs CPU on equal waves and lane calls, "
                                 f"first {(bad + bad_ann)[:3]}")
        log(f"[live-record] attempt {attempt}: {len(bad)} bindings and "
            f"{len(bad_ann)} annotations differ; cause: a timing race "
            f"(waves, records and lane calls card {shape[0]}, CPU "
            f"{shape[1]})")
    else:
        raise AssertionError("record_results: card and CPU differ in 3 "
                             "attempts")
    rec_counts = audit_records(rec_card)
    audit_records(rec_cpu)
    kernels.reset_launch_counts()
    rec_off = run_mixed_recorded(RECORD_NODES, RECORD_PODS,
                                 max_wave=RECORD_WAVE, record=False)
    launches["select_hosts"]["live-record-off"] = live_launches(
        "record_results off, card", rec_off.waves)
    if rec_off.placements != rec_card.placements or rec_off.loop_errors:
        raise AssertionError(f"record_results changed placements or the "
                             f"run without it failed ({rec_off.loop_errors} "
                             f"loop errors)")
    entries = sum(len(plugins) for ann in rec_card.annotations.values()
                  for plane in ann if plane for plugins in plane.values())
    n_rec_bound = sum(1 for v in rec_card.placements.values() if v)
    log(f"[live-record] {card}: the mixed cluster, {RECORD_NODES} nodes x "
        f"{RECORD_PODS} pods, serial engine, waves of {RECORD_WAVE}, full "
        f"roster with record_results: card and CPU twins alike "
        f"({n_rec_bound} bound; {rec_counts['with_record']} with a record, "
        f"{rec_counts['without_record']} placed by the blocked lane without "
        f"one; {rec_card.record_calls} records over {rec_card.waves} waves "
        f"and the exact-scan chunks); wall {rec_card.wall_s:.3f}s with "
        f"record_results, {rec_off.wall_s:.3f}s without (same placements), "
        f"{rec_cpu.wall_s:.3f}s on the CPU; record evaluate "
        f"{rec_card.record_evaluate_s:.3f}s, host ingest "
        f"{rec_card.record_ingest_s:.3f}s; {entries:,} recorded entries, "
        f"annotations {rec_card.annotation_bytes:,} bytes "
        f"({rec_card.annotation_bytes / max(n_rec_bound, 1):,.0f} a bound "
        f"pod); record errors 0, loop errors 0, select_hosts launches "
        f"{launches['select_hosts']['live-record']} (without: "
        f"{launches['select_hosts']['live-record-off']}), plain-twin calls 0")
    del rec_card, rec_cpu, rec_off

    # -- phase 25: the standalone process -----------------------------------
    stamp("25")
    # (a) in process: __main__.start, config 5 over HTTP
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    hr = run_config5_http(N_NODES, EARLY_C5_PODS, trace_pods=TRACE_PODS)
    launches["select_hosts"]["process-c5"] = live_launches(
        "config 5 over HTTP", hr.waves)
    n_plain = hr.n_plain
    types, samples = hr.metrics
    ttb = "sched_time_to_bind_seconds"
    ttb_count = sum(v for n_, _l, v in samples if n_ == ttb + "_count")
    if (hr.bound < n_plain or hr.audit["bound"] != n_plain or hr.loop_errors
            or types.get(ttb) != "histogram" or ttb_count != n_plain
            or hr.threads_left):
        raise AssertionError(f"config 5 over HTTP: {hr.bound} seen bound, "
                             f"audit {hr.audit}, {hr.loop_errors} loop "
                             f"errors, {ttb_count} binds in /metrics, "
                             f"threads left {hr.threads_left}")
    p50 = parsed_histogram_quantile(samples, ttb, 0.5)
    p99 = parsed_histogram_quantile(samples, ttb, 0.99)
    phase25_pods_s = n_plain / hr.bind_s
    log(f"[process-c5] {card}: __main__.start (device engine, pipelined, "
        f"waves of 1,024), config 5 over HTTP: {N_NODES} nodes and "
        f"{EARLY_C5_PODS} pods in batch creates, create wall "
        f"{hr.create_s:.3f}s; "
        f"first create to last bind {hr.bind_s:.3f}s = "
        f"{n_plain / hr.bind_s:,.0f} pods/s ({hr.waves} waves; phase 19 in "
        f"process at {LIVE_C5_PODS} pods: first drain "
        f"{phase19['first_drain_s']:.3f}s, total "
        f"{phase19['total_s']:.3f}s); boot {hr.setup_s:.3f}s; "
        f"{hr.bound} pods seen bound over the HTTP watch "
        f"({hr.watch_events} events, {hr.watch_reconnects} resumes after "
        f"an eviction, {hr.watch_relists} of them relists; the watch's "
        f"JSON decode "
        f"{hr.watch_decode_s:.3f}s); split: "
        f"{', '.join(f'{k} {v:.3f}s' for k, v in hr.split.items())}; "
        f"façade handlers: "
        f"{', '.join(f'{k} {v:.3f}s' for k, v in sorted(hr.handler_s.items()))}; "
        f"HTTP list audited in {hr.list_s:.3f}s ({hr.audit['bound']} "
        f"bound); /metrics counts {int(ttb_count)} binds, time to bind p50 "
        f"in ({p50[0]}, {p50[1]}]s, p99 in ({p99[0]}, {p99[1]}]s; loop "
        f"errors 0, stop() left no non-daemon thread, select_hosts launches "
        f"{launches['select_hosts']['process-c5']}, plain-twin calls 0")

    # -- phase 27: the trace ring, on phase 25(a)'s process -----------------
    stamp("27")
    cap = trace_ring._default_cap()
    if len(hr.trace) > cap:
        raise AssertionError(f"/debug/trace: {len(hr.trace)} spans over the "
                             f"cap {cap}")
    chains = audit_trace(hr.trace, hr.trace_pods)
    stages = sorted({sp["stage"] for sp in hr.trace})
    log(f"[trace] {card}: GET /debug/trace on phase 25(a)'s process after "
        f"{TRACE_PODS} more pods bound over HTTP: {chains['spans']} spans "
        f"(cap {cap}; stages {', '.join(stages)}); every one of the "
        f"{chains['pods']} pods has enqueue -> pop -> bind -> bind_ack in "
        f"order, bound in {chains['waves']} waves each named by a "
        f"wave_build span (and wave_evaluate when pipelined)")
    del hr, samples

    # (b) the child process, python3 -m minisched_tpu_torch
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PORT=str(port),
               FRONTEND_URL="http://localhost:3000")
    t0 = time.monotonic()
    child = subprocess.Popen([sys.executable, "-m", "minisched_tpu_torch"],
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        lines: list = []
        up = threading.Event()

        def read_child() -> None:
            # read to the end, so the child never blocks on a full pipe
            for line in child.stdout:
                lines.append(line)
                up.set()
            up.set()

        reader = threading.Thread(target=read_child, daemon=True)
        reader.start()
        up.wait(300)
        if not lines or f"API on {base}" not in lines[0]:
            raise AssertionError(f"child process: no API line ({lines[-20:]}"
                                 f", exit {child.poll()})")
        boot_s = time.monotonic() - t0
        node = readme_scenario_http(HTTPClient(base), log=lambda m: None)
        scrape = subprocess.run(
            [sys.executable, "-m", "minisched_tpu_torch", "metrics", base],
            capture_output=True, text=True, timeout=120)
        if node != "node10" or scrape.returncode != 0:
            raise AssertionError(f"child process: pod1 on {node!r}, metrics "
                                 f"exit {scrape.returncode}: {scrape.stderr}")
        t1 = time.monotonic()
        child.send_signal(signal.SIGTERM)
        rc = child.wait(timeout=30)
        stop_s = time.monotonic() - t1
        reader.join(10)
        if rc != 0:
            raise AssertionError(f"child process: exit {rc} on SIGTERM")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    log(f"[process-child] {card}: python3 -m minisched_tpu_torch (device "
        f"engine on the card): API line after {boot_s:.3f}s; the README "
        f"scenario over HTTPClient: pod1 pending, then bound to node10; "
        f"'metrics {base}' exit 0 ({len(scrape.stdout.splitlines())} "
        f"lines); exit 0 {stop_s:.3f}s after SIGTERM")

    # -- phase 26: the gRPC servicer ----------------------------------------
    stamp("26")
    # grpcio is part of the card machine's installation: without it the
    # phase fails here
    import grpc

    from minisched_tpu_torch.controlplane.grpcserver import (
        DEFAULT_WATCH_STREAM_EVENTS,
        EvaluatorClient,
        _unwrap_json,
        _wrap_json,
        start_grpc_server,
    )
    from minisched_tpu_torch.observability import counters as tcounters
    from minisched_tpu_torch.observability import hist as thist

    # (a) config 4 over EvaluatorClient.evaluate, in both modes
    _srv, grpc_addr, grpc_stop = start_grpc_server()
    ec = EvaluatorClient(grpc_addr)
    try:
        if ec.health() != {"ok": True}:
            raise AssertionError("gRPC Health")
        grpc_launches = 0
        for mode in ("wave", "repair"):
            name = f"config4 {mode}"
            card_want, cpu_want, in_wall, in_times = ev_results[name]
            req = ev_cases[name]
            child = thist.GLOBAL.get("grpc.request_s", method="Evaluate")
            served0 = child.sum if child is not None else 0.0
            kernels.reset_launch_counts()
            t0 = time.monotonic()
            got = ec.evaluate(c4_nodes, c4_pods, assigned=c4_assigned,
                              mode=mode)
            wall = time.monotonic() - t0
            counts = dict(kernels.launch_counts)
            served = (thist.GLOBAL.get("grpc.request_s", method="Evaluate")
                      .sum - served0)
            if got != card_want or got != cpu_want:
                raise AssertionError(f"gRPC {name}: the answer differs from "
                                     "in-process evaluate_cluster")
            if counts["select_hosts"] < got["rounds"] or any(
                    kernels.plain_calls.values()):
                raise AssertionError(f"gRPC {name}: launches {counts}")
            grpc_launches += counts["select_hosts"]
            # the split: the client's encode (objects to framed bytes),
            # the server's handler (decode, evaluate, encode), the
            # client's decode of an answer of the same bytes; the rest is
            # the wire and grpc's own work
            t0 = time.monotonic()
            body = _wrap_json(json.dumps(
                {"nodes": [_encode(n_) for n_ in c4_nodes],
                 "pods": [_encode(p_) for p_ in c4_pods],
                 "assigned": [_encode(a_) for a_ in c4_assigned],
                 "pvcs": [], "pvs": [], "mode": mode}).encode())
            enc_s = time.monotonic() - t0
            answer = _wrap_json(json.dumps(got).encode())
            t0 = time.monotonic()
            json.loads(_unwrap_json(answer).decode("utf-8"))
            dec_s = time.monotonic() - t0
            log(f"[grpc-evaluate] {card}: {name} over gRPC "
                f"({len(body):,} request bytes, {len(answer):,} answer "
                f"bytes): equal to evaluate_cluster on the card and on the "
                f"CPU twins (rounds {got['rounds']}); a call {wall:.3f}s = "
                f"client encode {enc_s:.3f} + server handler {served:.3f} "
                f"+ client decode {dec_s:.3f} + wire and grpc "
                f"{wall - enc_s - served - dec_s:.3f}s; in process "
                f"{in_wall:.3f}s (decode {in_times['decode']:.3f} + build "
                f"{in_times['build']:.3f} + evaluate "
                f"{in_times['evaluate']:.3f}s); select_hosts launches "
                f"{counts['select_hosts']}")
        launches["select_hosts"]["grpc-evaluate"] = grpc_launches
        big = ev_cases["mixed repair"]
        big_bytes = len(_wrap_json(json.dumps(big).encode()))
        if big_bytes <= 4 * 2**20:
            raise AssertionError(f"the mixed request is {big_bytes} bytes, "
                                 "not over grpc's 4 MiB default")
        try:
            ec._call("Evaluate", big)
        except grpc.RpcError as err:
            refused = err.code()
        else:
            refused = None
        if refused != grpc.StatusCode.RESOURCE_EXHAUSTED:
            raise AssertionError(f"gRPC over-limit request: {refused}")
        log(f"[grpc-evaluate] the mixed request ({big_bytes:,} bytes, over "
            f"grpc's default 4 MiB) refused RESOURCE_EXHAUSTED")
    finally:
        ec.close()
        grpc_stop()

    # (b) phase 17's routine under a gRPC Watch on Pods from its store,
    # read by an external watcher in its own process
    gw: dict = {}
    ctx = multiprocessing.get_context("spawn")
    from_watcher, to_parent = ctx.Pipe(duplex=False)

    def attach_watch(client_) -> None:
        _s, addr, stop_fn = start_grpc_server(store=client_.store)
        proc = ctx.Process(target=count_grpc_binds,
                           args=(addr, GRPC_WATCH_PODS, to_parent,
                                 GRPC_WATCH_BATCH),
                           daemon=True)
        proc.start()
        gw.update(stop=stop_fn, proc=proc)
        if not from_watcher.poll(180):
            raise AssertionError("the gRPC watcher never opened its stream")
        gw["sync"] = from_watcher.recv()

    kernels.reset_launch_counts()
    try:
        c5w = run_config5_live(N_NODES, GRPC_WATCH_PODS,
                               max_wave=GRPC_WATCH_WAVE,
                               pipeline=False, after_setup=attach_watch)
        launches["select_hosts"]["live-c5-grpc-watch"] = live_launches(
            "config 5 under a gRPC watch", c5w.waves)
        if not from_watcher.poll(180):
            raise AssertionError("the gRPC watcher sent no result")
        seen = from_watcher.recv()
        evicted = tcounters.get("grpc.watch.evicted")
    finally:
        if gw:
            gw["proc"].join(30)
            if gw["proc"].is_alive():
                gw["proc"].terminate()
                gw["proc"].join(10)
            gw["stop"]()
    audited = audit_store(c5w.client, c5w.labelled)
    final = {p_.metadata.name: p_.spec.node_name
             for p_ in c5w.client.pods().list()}
    wrong = [n_ for n_, node in seen["bound"].items() if final[n_] != node]
    if (len(seen["bound"]) != GRPC_WATCH_PODS
            or seen["error"] is not None
            or evicted or wrong or not seen["rv_ordered"]
            or audited["bound"] != GRPC_WATCH_PODS or c5w.loop_errors
            or c5w.assumed_left):
        raise AssertionError(
            f"config 5 under a gRPC watch: {len(seen['bound'])} binds seen "
            f"over the stream, ended {seen['error']}, {evicted} evicted, "
            f"{len(wrong)} on another node than the store's, rv order "
            f"{seen['rv_ordered']}; {audited['bound']} bound, "
            f"{c5w.loop_errors} loop errors")
    log(f"[grpc-watch] {card}: config 5 live, serial, waves of "
        f"{GRPC_WATCH_WAVE} ({c5w.waves} waves), {GRPC_WATCH_PODS} bound "
        f"in {c5w.total_s:.3f}s = {GRPC_WATCH_PODS / c5w.total_s:,.0f} "
        f"binds/s, under "
        f"one gRPC Watch on Pods read by a watcher process, opened after "
        f"the creates (sync {gw['sync']['sync']}, rv "
        f"{gw['sync']['resource_version']}): {len(seen['bound'])} binds seen "
        f"over the stream, {seen['events']} events in "
        f"{seen['messages']} messages (up to {GRPC_WATCH_BATCH} a message) "
        f"in {seen['span_s']:.3f}s = "
        f"{seen['events'] / max(seen['span_s'], 1e-9):,.0f} events/s, in "
        f"resource_version order, each on the node the store holds; none "
        f"evicted (stream bound {DEFAULT_WATCH_STREAM_EVENTS} events); "
        f"audit passed, loop errors 0, select_hosts launches "
        f"{launches['select_hosts']['live-c5-grpc-watch']}")
    del c5w, final

    # -- phase 28: the churn and gang roles on the card --------------------
    stamp("28")
    for role in ("churn", "gang", "wire"):
        kernels.reset_launch_counts()
        rec = getattr(port_bench, f"role_{role}")()
        launches["select_hosts"][f"bench-{role}"] = live_launches(
            f"the {role} role", 1)
        rec.pop("metrics_snapshot", None)
        log(f"[bench-{role}] {card}: gates met; select_hosts launches "
            f"{launches['select_hosts'][f'bench-{role}']}; "
            + json.dumps(rec, sort_keys=True))

    # -- phase 29: the durable store, config 5 through a SIGKILL ------------
    stamp("29")
    import resource
    import tempfile

    with tempfile.TemporaryDirectory(prefix="c5-wal-") as workdir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        dr = run_config5_durable(workdir, N_NODES, EARLY_C5_PODS,
                                 kill_binds=DURABLE_KILL_BINDS)
        launches["select_hosts"]["durable-c5"] = live_launches(
            "recovered config 5", max(dr.waves, 1))
    dr_peak = torch.cuda.max_memory_allocated()
    if (dr.waves < 1 or dr.threads_left or dr.loop_errors
            or dr.assumed_left or dr.waiting_left):
        raise AssertionError(f"recovered config 5: {dr.waves} waves, "
                             f"threads left {dr.threads_left}, "
                             f"{dr.loop_errors} loop errors, "
                             f"{dr.assumed_left} assumed and "
                             f"{dr.waiting_left} waiting left")
    rest = dr.left_at_boot
    log(f"[durable-c5] {card}: python3 -m minisched_tpu_torch over "
        f"file://<tmp>/c5.wal (device engine, pipelined, waves of 1,024, "
        f"fsync off): config 5 created over HTTP in {dr.create_s:.3f}s; "
        f"SIGKILL {dr.kill_s:.3f}s after the first create with "
        f"{dr.seen_at_kill} binds seen; WAL {dr.wal_bytes} bytes, "
        f"{dr.wal_records} records.  Recovery in process: replay "
        f"{dr.replay_s:.3f}s, boot {dr.boot_s:.3f}s, {rest} plain pods "
        f"left, bound in {dr.bind_s:.3f}s after boot = "
        f"{rest / dr.bind_s:,.0f} pods/s ({dr.waves} waves; phase 25(a), "
        f"over HTTP at {EARLY_C5_PODS} pods: {phase25_pods_s:,.0f} pods/s); "
        f"every watched bind on its node "
        f"after replay and at the end, all {dr.n_plain} plain pods bound, "
        f"no special pod, audit {dr.audit}; group commit: {dr.groups} "
        f"groups, {dr.records} records; compaction {dr.compact_s:.3f}s, "
        f"checkpoint {dr.ckpt_bytes} bytes; read-only reopen "
        f"{dr.reopen_s:.3f}s, same objects and resource_version "
        f"{dr.resource_version}; fsck exit 0 in {dr.fsck_s:.3f}s "
        f"({dr.fsck_records} WAL records, objects {dr.fsck_objects}); "
        f"the test watch resumed {dr.watch_reconnects} times; "
        f"peak device memory {dr_peak / 2**30:.2f} GiB, host peak RSS "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} "
        f"GiB (this process), "
        f"{resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 2**20:.2f}"
        f" GiB (largest child); loop errors 0, assume and Permit ledgers "
        f"empty, select_hosts launches "
        f"{launches['select_hosts']['durable-c5']}, plain-twin calls 0")

    # -- phase 30: config 5 over the wire through an API-server restart ----
    stamp("30")
    with tempfile.TemporaryDirectory(prefix="c5-remote-") as workdir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        rr = run_config5_remote(workdir, N_NODES, EARLY_C5_PODS,
                                kill_binds=REMOTE_KILL_BINDS)
        launches["select_hosts"]["remote-c5"] = live_launches(
            "config 5 over the wire", max(rr.waves, 1))
    rr_peak = torch.cuda.max_memory_allocated()
    if rr.waves < 1 or rr.threads_left:
        raise AssertionError(f"remote config 5: {rr.waves} waves, threads "
                             f"left {rr.threads_left}")
    rc = rr.counters
    log(f"[remote-c5] {card}: the port's start_api_server in a child over "
        f"file://<tmp>/remote.wal (stream loop on, fsync off); the device "
        f"engine (full roster, pipelined, waves of 1,024) behind "
        f"RemoteClient(base, retries=10): config 5, {N_NODES} nodes and "
        f"{EARLY_C5_PODS} pods, created over the wire in "
        f"{rr.create_s:.3f}s; start_scheduler (informer sync over the wire) "
        f"{rr.sync_s:.3f}s; SIGKILL {rr.kill_s:.3f}s after the start with "
        f"{rr.seen_at_kill} binds watched = "
        f"{rr.seen_at_kill / rr.kill_s:,.0f} pods/s before the kill; "
        f"restart on the same port: replay {rr.replay_s:.3f}s, spawn to "
        f"ready {rr.boot_s:.3f}s, {rr.left_at_boot} plain pods unbound at "
        f"boot, next bind {rr.next_bind_s:.3f}s after the spawn, the rest "
        f"(and {AFTER_RESTART_PODS} pods created after the restart) bound "
        f"{rr.bind_s:.3f}s after ready = "
        f"{(rr.left_at_boot + AFTER_RESTART_PODS) / rr.bind_s:,.0f} "
        f"pods/s after the "
        f"restart (phase 25(a) over HTTP in process "
        f"{phase25_pods_s:,.0f}, phase 17 in process "
        f"{phase17_pods_s:,.0f}); {rr.waves} waves; informers "
        f"{rr.reconnects}; counters {json.dumps(rc, sort_keys=True)}; "
        f"the scheduler's watch streams decoded "
        f"{rr.decoded.get('Pod', 0)} Pod events in "
        f"{rr.decode_s.get('Pod', 0.0):.3f}s and "
        f"{rr.decoded.get('Node', 0)} Node events in "
        f"{rr.decode_s.get('Node', 0.0):.3f}s (RemoteWatch._read); the "
        f"test watches resumed {rr.watch_reconnects} times; every "
        f"watched bind on its node, all {rr.n_plain} plain pods bound once, "
        f"no special pod, audit {rr.audit}, double binds 0, fsck exit 0 in "
        f"{rr.fsck_s:.3f}s; split "
        + ", ".join(f"{k} {rr.split.get(k, 0.0):.3f}s" for k in SPLIT)
        + f"; peak device memory {rr_peak / 2**30:.2f} GiB; loop errors 0, "
        f"assume and Permit ledgers empty, select_hosts launches "
        f"{launches['select_hosts']['remote-c5']}, plain-twin calls 0")

    # -- phase 31: config 5 through a SIGKILL of the store leader ---------
    stamp("31")
    from minisched_tpu_torch.controlplane.replproc import DEFAULT_TTL_S

    with tempfile.TemporaryDirectory(prefix="c5-repl-") as workdir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        pr = run_config5_replicated(workdir, N_NODES, EARLY_C5_PODS,
                                    kill_binds=REPL_KILL_BINDS)
        launches["select_hosts"]["repl-c5"] = live_launches(
            "config 5 through a leader kill", max(pr.waves, 1))
    pr_peak = torch.cuda.max_memory_allocated()
    if pr.waves < 1 or pr.threads_left:
        raise AssertionError(f"replicated config 5: {pr.waves} waves, "
                             f"threads left {pr.threads_left}")
    qb, qa = pr.quorum_wait["before"], pr.quorum_wait["after"]
    left = pr.n_plain - pr.seen_at_kill
    log(f"[repl-c5] {card}: ReplicatedPlane of 3 replica children (fsync "
        f"off, lease TTL {DEFAULT_TTL_S} s); the device engine (full "
        f"roster, pipelined, waves of 1,024) behind RemoteClient(r0, "
        f"endpoints=[r1, r2], retries=10), a pod watch on follower r2: "
        f"config 5, {N_NODES} nodes and {EARLY_C5_PODS} pods, created over "
        f"the wire in {pr.create_s:.3f}s; start_scheduler "
        f"{pr.sync_s:.3f}s; storage.quorum_wait_s before the kill "
        f"({pr.old_leader}'s /metrics) p50 <= {qb['p50_le_s']}s, p99 <= "
        f"{qb['p99_le_s']}s over {qb['groups']} groups, at the end "
        f"({pr.new_leader}'s) p50 <= {qa['p50_le_s']}s, p99 <= "
        f"{qa['p99_le_s']}s over {qa['groups']} groups; SIGKILL of "
        f"{pr.old_leader} {pr.kill_s:.3f}s after the start with "
        f"{pr.seen_at_kill} binds watched = "
        f"{pr.seen_at_kill / pr.kill_s:,.0f} pods/s before the kill; "
        f"{pr.new_leader} promoted {pr.promote_s:.3f}s after the kill "
        f"(gate {2 * DEFAULT_TTL_S + 1:.1f}s); next bind "
        f"{pr.next_bind_s:.3f}s after the kill; the other {left} plain "
        f"pods bound {pr.after_s:.3f}s after the kill = "
        f"{left / pr.after_s:,.0f} pods/s after it (phase 30 before its "
        f"kill {rr.seen_at_kill / rr.kill_s:,.0f}); {pr.old_leader} "
        f"restarted, a fenced follower at the leader's rv in "
        f"{pr.catchup_s:.3f}s; {pr.waves} waves; informers "
        f"{pr.reconnects}; counters "
        f"{json.dumps(pr.counters, sort_keys=True)}; WALs {pr.wal_pairs}; "
        f"double binds {pr.double_binds}; fsck exit 0 in "
        f"{pr.fsck_s:.3f}s; every watched bind on its node, all "
        f"{pr.n_plain} plain pods bound once, no special pod, audit "
        f"{pr.audit}; split "
        + ", ".join(f"{k} {pr.split.get(k, 0.0):.3f}s" for k in SPLIT)
        + f"; peak device memory {pr_peak / 2**30:.2f} GiB; loop errors 0, "
        f"assume and Permit ledgers empty, select_hosts launches "
        f"{launches['select_hosts']['repl-c5']}, plain-twin calls 0")

    # -- phase 32: config 5 over two leader groups through a live split --
    stamp("32")
    from minisched_tpu_torch.controlplane.shards import freeze_ttl_s

    with tempfile.TemporaryDirectory(prefix="c5-shard-") as workdir:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        sr = run_config5_sharded(workdir, N_NODES, EARLY_C5_PODS,
                                 split_binds=SHARD_SPLIT_BINDS)
        launches["select_hosts"]["shard-c5"] = live_launches(
            "config 5 over two leader groups", max(sr.waves, 1))
    sr_peak = torch.cuda.max_memory_allocated()
    if sr.waves < 1 or sr.threads_left or sr.children_left:
        raise AssertionError(f"sharded config 5: {sr.waves} waves, threads "
                             f"left {sr.threads_left}, children left "
                             f"{sr.children_left}")
    sp, tt = sr.split, sr.ttb
    after = sr.n_plain - sr.seen_at_split
    bd = sr.budget_doc
    log(f"[shard-c5] {card}: ShardedPlane of 2 leader groups, one replica "
        f"child each (fsync off); the device engine (full roster, "
        f"pipelined, waves of 1,024) behind ShardedClient(seeds, "
        f"retries=10), a merged vector-cursor watch on every pod: config "
        f"5, {N_NODES} nodes on the home group {sr.source}, "
        f"{EARLY_C5_PODS} pods over 8 tenants "
        f"{json.dumps(sr.tenants, sort_keys=True)}, created through the "
        f"router in {sr.create_s:.3f}s; budget document {bd['bytes']:.0f} "
        f"bytes, served in {bd['serve_s']:.3f}s, applied to a mirror in "
        f"{bd['apply_s']:.3f}s; start_scheduler {sr.sync_s:.3f}s; split "
        f"of {sr.hot_ns} ({sp['objects']} objects) {sr.source} -> "
        f"{sr.target} {sr.split_at_s:.3f}s after the start with "
        f"{sr.seen_at_split} binds watched = "
        f"{sr.seen_at_split / sr.split_at_s:,.0f} pods/s before the split; "
        f"freeze {sp['freeze_s']:.3f}s (TTL {freeze_ttl_s():.0f}s), "
        f"handoff {sp['handoff_s']:.3f}s, seed {sp['seed_s']:.3f}s; the "
        f"other {after} plain pods bound {sr.after_s:.3f}s after the split "
        f"= {after / sr.after_s:,.0f} pods/s after it (phase 31 before its "
        f"kill {pr.seen_at_kill / pr.kill_s:,.0f}); time to bind after the "
        f"split, {sr.hot_ns}'s {tt['hot']['n']:.0f} pods p50 "
        f"{tt['hot']['p50']:.3f}s p99 {tt['hot']['p99']:.3f}s, the other "
        f"tenants' {tt['other']['n']:.0f} p50 {tt['other']['p50']:.3f}s "
        f"p99 {tt['other']['p99']:.3f}s; {sr.waves} waves; merged watch "
        f"{json.dumps(sr.watch, sort_keys=True)}; counters "
        f"{json.dumps(sr.counters, sort_keys=True)}; hot_ns left "
        f"{sr.hot_left}; double binds {sr.double_binds}; fsck exit 0 on "
        f"both WALs in {sr.fsck_s:.3f}s; every watched bind on its node, "
        f"all {sr.n_plain} plain pods bound once, no special pod, audit "
        f"over both groups {sr.audit}; split "
        + ", ".join(f"{k} {sr.split_phases.get(k, 0.0):.3f}s" for k in SPLIT)
        + f"; peak device memory {sr_peak / 2**30:.2f} GiB; loop errors 0, "
        f"assume and Permit ledgers empty, select_hosts launches "
        f"{launches['select_hosts']['shard-c5']}, plain-twin calls 0")

    # -- phase 33: the chaos role's cluster on the card ---------------------
    stamp("33")
    for label, wave in (("chaos", None), ("chaos-waves-32", CHAOS_FIRE_WAVE)):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        saved = os.environ.pop("BENCH_CHAOS_WAVE", None)
        if wave is not None:
            os.environ["BENCH_CHAOS_WAVE"] = str(wave)
        try:
            rec = port_bench.role_chaos()
        finally:
            os.environ.pop("BENCH_CHAOS_WAVE", None)
            if saved is not None:
                os.environ["BENCH_CHAOS_WAVE"] = saved
        launches["select_hosts"][label] = live_launches(
            f"the chaos role ({label})", 1)
        stale = max(r["staleness_s"] for r in rec["staleness"].values())
        unfired = [p_ for p_ in CHAOS_GATED_POINTS
                   if wave is not None and not rec["injected"].get(p_)]
        if rec["loop_errors"] or stale > 30.0 or unfired:
            raise AssertionError(f"{label}: {rec['loop_errors']} loop "
                                 f"errors, staleness {stale}s, not fired "
                                 f"{unfired}: {json.dumps(rec)}")
        log(f"[{label}] {card}: bench_chaos's cluster ({rec['nodes']} "
            f"nodes of 64 CPU, 1 in 16 cordoned; {rec['pods']} pods of 500m "
            f"and 64Mi), the device engine (full roster, waves of "
            f"{wave or 512}) over a DurableObjectStore, fabric seed "
            f"{rec['seed']}: all bound in {rec['total_s']:.3f}s; fires "
            f"{json.dumps(rec['injected'], sort_keys=True)} of draws "
            f"{json.dumps(rec['draws'], sort_keys=True)}; recovered "
            f"{json.dumps(rec['recovered'], sort_keys=True)}; no assumed-"
            f"capacity leak, informer staleness at most {stale:.3f}s, "
            f"wal_double_binds empty, loop errors 0, select_hosts launches "
            f"{launches['select_hosts'][label]}, plain-twin calls 0")

    # -- phase 34: config 5 by three HA engine children through a kill ------
    stamp("34")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="c5-ha-") as workdir:
        har = run_config5_ha(workdir, N_NODES, EARLY_C5_PODS,
                             kill_binds=HA_KILL_BINDS)
    launches["select_hosts"]["ha-c5"] = sum(har.launches.values())
    before_n = har.seen_at_kill
    after_n = har.n_plain - before_n
    log(f"[ha-c5] {card}: a ServerSupervisor façade child over "
        f"file://<tmp>/ha.wal (archived history, fsync off); "
        f"{len(har.boot_s)} EngineSupervisor children (the device engine "
        f"on cuda, full roster, max_wave 1024, lease TTL {HA_TTL_S} s), "
        f"each with its own CUDA context on this card: spawn to member "
        f"lease live "
        + ", ".join(f"{k} {v:.3f}s" for k, v in sorted(har.boot_s.items()))
        + "; child start to a running engine "
        + ", ".join(f"{k} {v:.3f}s" for k, v in sorted(har.ready_s.items()))
        + f"; all running {har.start_s:.3f}s after the first spawn; config "
        f"5, {N_NODES} nodes and {EARLY_C5_PODS} pods created over the wire "
        f"(nodes and specials {har.create_s['setup']:.3f}s, four fifths of "
        f"the plain pods {har.create_s['first']:.3f}s, the last fifth "
        f"{har.create_s['after_kill']:.3f}s after the kill); SIGKILL of "
        f"{har.victim} {har.kill_s:.3f}s after the first plain create with "
        f"{before_n} binds watched = {before_n / har.kill_s:,.0f} pods/s "
        f"before the kill (binds by engine before it "
        f"{json.dumps(har.binds_before, sort_keys=True)}, ha counters "
        f"before it {json.dumps(har.ha_before, sort_keys=True)}); "
        f"survivors adopted (new epochs, {har.victim} gone) "
        f"{har.adopt_s:.3f}s after the kill, their resyncs had queued its "
        f"pods {har.resync_s:.3f}s after it (gate "
        f"{HA_TTL_S + HA_TTL_S / 3 + 1.5:.3f}s); next bind "
        f"{har.next_bind_s:.3f}s after the kill; the other {after_n} plain "
        f"pods bound {har.after_s:.3f}s after it = "
        f"{after_n / har.after_s:,.0f} pods/s; binds by engine "
        f"{json.dumps(har.binds, sort_keys=True)} ({har.victim}'s read "
        f"before the kill); adopted pods {har.adopted}; ha counters "
        f"{json.dumps(har.ha_counters, sort_keys=True)}, no live peer "
        f"dropped; renewals (ha.heartbeat_s), their gaps (ha.renew_gap_s, "
        f"widest gap_max_s) and view ticks (ha.view_s): count, p50 and "
        f"p99 bucket bounds {json.dumps(har.heartbeat, sort_keys=True)}; "
        f"peak device memory "
        + ", ".join(f"{k} {v / 2**30:.2f} GiB"
                    for k, v in sorted(har.peak_bytes.items()))
        + f"; every plain pod bound once on the node first watched, no "
        f"special pod, audit {har.audit}, double binds {har.double_binds} "
        f"over the archived history, fsck exit 0 in {har.fsck_s:.3f}s; "
        f"no child left; loop errors "
        f"{json.dumps(har.loop_errors, sort_keys=True)}, select_hosts "
        f"launches {json.dumps(har.launches, sort_keys=True)}, plain-twin "
        f"calls {json.dumps(har.plain_calls, sort_keys=True)}")

    handoff = phase35(dev, card, launches, main_err, serial17, c5_nodes,
                      c5_pods)
    phase36(dev, card, launches, handoff, c5_nodes, c5_pods)

    stamp("end")
    report = []
    replaces = {
        "select_hosts": "minisched_tpu/ops/pallas_kernels.py:221",
        "nodenumber_select_hosts": "minisched_tpu/ops/pallas_kernels.py:174",
    }
    errs = {"select_hosts": max(v for k, v in main_err.items()
                                if k.startswith("select_hosts")),
            "nodenumber_select_hosts": main_err["nodenumber_select_hosts"]}
    for name, first_path in (("select_hosts", "generic"),
                             ("nodenumber_select_hosts", "fused")):
        by_path = launches[name]
        first = timed[name, first_path]
        report.append({
            "name": name,
            "route": "cuda",
            "source": "minisched_tpu_torch/csrc/select_hosts.cu",
            "replaces": replaces[name],
            "launches": sum(by_path.values()),
            "max_abs_err": errs[name],
            "ms": first["ms"],
            "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"],
            "library_ms": None,
            "launches_by_path": by_path,
            "by_path": {path: t for (n, path), t in timed.items() if n == name},
        })

    log(card)
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
