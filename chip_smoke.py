"""Drive the port's scheduling rounds, its descheduler, its manager and
its node agent on one NVIDIA H100 and check them.

    python3 chip_smoke.py    # 10240 pods x 5120 nodes, one card

Phases, one JSON line each:
  device  the card (nvidia-smi name and power limit), torch and CUDA
          versions; builds the CUDA kernels from koordinator_tpu_torch/csrc/
          (full_chain.cu, schedule_step.cu, explain_counts.cu) with nvcc,
          one process per source started together, and times the build.
  scheduler  BASELINE config 4 through the real scheduler cycle, in the shape
          of bench.py's run_churn: three stores from synth_full_cluster(5000,
          10000, seed=42, num_quotas=100, num_gangs=200), each driven by
          Scheduler(store, waves=1, device="cuda") — plain, under
          CyclePipeline, and with IncrementalSnapshot off (the full-rebuild
          twin) — through cycle 0 (cold, the first kernel call of the run)
          and 1 warm-up + 1 measured churn cycle of 1000 arrivals. The
          twins' ordered bindings, failed and rejected lists must be
          identical every cycle, and every dispatch window must have
          launched the full-chain kernel exactly once (launch counts set to
          0 before each cycle and read after). Prints cycle 0's seconds and
          span split, the steady cycle's median, kernel and host ms and its
          median span split, the full-rebuild and pipelined twins' cycle ms,
          pods/s end to end, the mirror's and the pack cache's stats, the
          churn cycles' padded P and the kernel's time there. Then the
          twin's DeviceSnapshot must hand the round exactly what to_device
          gives (dtype and value, field by field), and a fresh one must
          scatter rows on the card into a clone while a round is in
          flight and in place after it. The incremental world's outcome
          SHA-256 (testing/churn.outcome_sha: every cycle's bindings in
          order, failed and rejected lists, every PodScheduled condition)
          must be CONFIG4_SERIAL_JAX_SHA256, the JAX package's
          Scheduler(waves=1) over the same cycles.
  scheduler_waves  config 4 through the Scheduler's default path: waves
          "auto" (K = 8 at cycle 0's 10000 pending pods, 4 at the churn
          cycles' ~1126) with replay overlap on, the chained dispatch (each
          wave's evaluation in the full-chain kernel, its kept-only replay
          in the node-parallel replay kernel, the host replaying wave w while
          the card runs wave w+1). Three stores from churn_store(5000,
          10000, seed=42): (a) Scheduler(store, device="cuda") with its
          defaults, (b) the same with replay_overlap=False (all K waves in
          one call), (c) Scheduler(store, waves=1, device="cuda") running as
          many serial cycles as (a) consumed (CycleResult.waves), through
          cycle 0 and 1 measured churn cycle of 1000 arrivals.
          The concatenated bound sequences and failed/rejected lists must be
          identical every round, and the canonical dumps after a final flush.
          Prints the K each cycle resolved to, the device waves run and the
          per-wave bound counts and device ms, cycle ms and span splits of
          (a) and (b), both kernels' launches, and the replay alone at
          cycle 0's kept set (CUDA events, median of 10: the wrapper's call
          and, apart, the kernels' launch alone; the most kept pods on one
          node) against its plain version replay_kept on the card, bit
          for bit, with no error bit set; then the kept pods of
          mixed_cluster(7, 200 nodes, 400 pods) over affinity counts
          planted at 2^24 - 1, on its active axes (the common-shape
          instance) and on all 14 (the generic one), each against
          replay_kept bit for bit, the kernel's one-by-one adds reported
          by its error bit.
          The default path's outcome SHA-256 (testing/churn.outcome_sha)
          must be CONFIG4_WAVES_JAX_SHA256 and each cycle's
          CycleResult.waves CONFIG4_WAVES_JAX_WAVES: the JAX package's
          default path over the same cycles.
  scheduler_mesh  the same default path on a mesh of 2 virtual shards of
          the card (parallel/mesh.py): churn_store(5000, 10000, seed=42)
          through Scheduler(store, mesh=2 shards, device="cuda"), the
          cycles scheduler_waves ran; every wave's node fields gathered
          from the shards into kernel 1 and the replay kernel (the
          steps built for the mesh), the outcome's SHA-256 equal to
          scheduler_waves' (no new twin).
  scheduler_xchg  the same default path on a mesh of 2 virtual CARDS of
          the card (testing/mesh_round.exchanging_mesh: mesh.exchange set,
          the route a mesh of two cards takes): the cycles scheduler_waves
          ran, every wave's round in kernel 1's exchange instance (each
          shard a cluster of one launch, the pod's stats and winner
          exchanged through the mailboxes) and its replay in the per-card
          replay, no single-device launch and no node row gathered; the
          outcome's SHA-256 equal to scheduler_waves'.
  scheduler_waves_mixed  the mixed cluster (500 x 1000) with default
          waves on the card and in a CPU twin (the plain wave step): the
          canonical dumps must be identical after each of 2 cycles. As
          mixed_cluster builds it, the world's shared claims overflow the
          volume-group budget and the cycle demotes to serial dispatch
          (claim-entangled, checked first), so the twins keep the shared
          claims of 8 pending pods and drop the others' claims.
  waves_carried  scheduler/pipeline_parity.run_carried_state_parity on the
          card for the reservation, claim, prod-usage and transformer
          worlds: each must report ok and a fused dispatch that ran more
          than one wave. Also the shared memory a config-4 launch takes
          with a claim world's [P, N] volume view.
  storage config 4's churn store with a seeded storage layer
          (testing/storage.py): three zones over the nodes, a
          WaitForFirstConsumer no-provisioner class with static zonal PVs,
          a WaitForFirstConsumer CSI class whose allowedTopologies name two
          zones, an Immediate class with bound zonal PVs; 20% of the
          pending pods and of each cycle's 1000 arrivals carry 1-2 claims
          (half of the arrivals' a bound claim shared by two pods). The
          default path (auto waves, chained) and a serial twin run cycle 0
          and 1 churn cycle, the dynamic provisioner creating PVs for the
          claims the scheduler selected nodes for in between. Bindings,
          failure lists, every claim's and volume's binding (the PV picks)
          and the canonical dumps (PodScheduled messages) must be equal
          every cycle, every window in kernel 1, and the scheduler must
          have bound static PVs and served provisioning. Then the fused
          waves' claims world with every claim a bound PVC
          (testing/storage.bound_claims_world) at K = 4 on the card
          against a CPU twin: hot claims from real objects through the
          fused dispatch, the cycle equal. Prints per cycle
          the K, waves and demotion reasons (claim-entangled wherever
          unbound claims sit on two or more pending pods, in both
          packages), the PVs bound, the cycle ms and the span splits.
  ladder  the degradation ladder at config 4: two stores from
          churn_store(5000, 10000, seed=42), each through Scheduler(store,
          device="cuda") at its defaults for cycle 0 and 10 churn cycles of
          1000 arrivals; (a) with a FaultPlan on its three hooks, a 2 s
          dispatch deadline and a ladder that promotes after 2 clean
          cycles, (b) unfaulted (cycles 0-3 only). One dispatch fault, one
          upload OOM and one
          4 s readback each retry at full, and (a) must equal (b) through
          them; then a fault storm demotes full -> serial-waves (the fused
          window's pass re-runs serially) -> host-fallback, and clean
          cycles promote back -> serial-waves -> full. The store
          invariants (sim/invariants) hold after every cycle, the host
          fallback binds no gang or quota pod, the retries per stage and
          the level after each cycle are as planned, and kernel 1 launches
          again once the ladder is above the host fallback. Prints the
          transitions, each cycle's ms and level beside (b)'s, and the
          host-fallback pass's seconds.
  sim     the sim's smoke (50 cycles), gang-storm (60 of its 300),
          spot-churn (40 of 300), crash-restart (36), drain-storm (40 of
          200), hotspot (80 of 160) and overcommit-shift (80 of 160)
          scenarios on the card, each with a CPU twin in this process
          (gang-storm's cut to 40 cycles and spot-churn's to 30, for the
          time limit): the CPU's binding log equal to the card's over
          the same cycles, zero invariant breaches and cycle exceptions on
          both, smoke's ladder round trip in cycles_at_level. drain-storm
          and hotspot run the co-located descheduler: every rebalance pass
          on the card (none retried, none on the host oracle), and
          hotspot's rebalance report (migrations, dissipation) equal on the
          card and the CPU. overcommit-shift runs the co-located manager:
          every round a device colo pass, none on the host, the staleness
          SLO met, the colo report equal on the CPU, and the binding log's
          SHA the JAX package's at the same 80 cycles (printed beside the
          older record of 160 in COLO_r01.json). Prints each scenario's
          SHA prefix, cycles at each level, SLO flags, rebalance passes
          and wall seconds on each device.
  fault_ladder  the sim's fault-ladder scenario (72 cycles, mesh = 2
          virtual shards of the card, fused waves, explain counts, a
          150 ms deadline; a device loss naming shard 1, a slow device, a
          fault storm, a crash-restart): its binding log's SHA-256 equal
          to the JAX package's, its ladder walk the plan's, two deadline
          overruns, launches of kernel 1 and the stage-count pass.
  racecheck  koordrace on the card (sim/racecheck.py check_races): the
          smoke scenario's first 24 cycles (10 nodes, the cycle-20
          dispatch fault down to the host fallback and back) at fused
          waves K = 2 (the catalog's smoke dispatches serially and never
          reaches the replay kernel) under the race harness at
          preemption seeds 101 and 202: every guarded-field touchpoint of
          the static guard map witness-checked and seeded to yield, the
          canonical lock order checked as locks are taken, /metrics and
          /debug/timeline scraped the whole run, the pipeline overlap on,
          the dispatch watchdog armed (30 s) over the chained dispatch's
          readback of each wave, the warm-up ladder in the background.
          The seeds share one rung index, so the second seed's ladder
          replays the first's rungs on its own CUDA stream while its
          first cycles dispatch. 0 witnesses, 0 order inversions, 0 torn
          scrapes, touches at both seeds, no static race finding over the
          port's tree, both binding logs the JAX package's racecheck
          SHA-256 at waves=2, the second seed's ladder warmed, kernel 1
          and the replay kernel launched inside the phase. Prints each
          seed's bindings, SHA, touches, preemptions, scrapes, unchecked
          touches and warm-up stats, the launches and the seconds.
  pack_overlap  scheduler/pipeline_parity.run_pack_overlap_parity on the
          card at its own world (24 nodes, 70 pods, 4 rounds of churn), at
          waves 1 and 4, then on config 4's churn store with its 1000
          arrivals a round (cycle 0 and 2 churn rounds) at the default
          waves: the cycle that pre-packs the next cycle's pod rows inside
          the device window against its gap-pack twin. Every uploaded
          FullChainInputs array byte-identical encode for encode (by its
          SHA-256), bindings, failure lists, PodScheduled conditions and
          final assignments equal, rows pre-packed, kernel 1 launched,
          within 20 s at the small world and 120 s at config 4. Prints
          each run's pods, conditions and encodes compared, the launches
          and the seconds.
  scrape_convoy  the JAX package's concurrent-scrape case (tests/
          test_koordwatch.py test_concurrent_scrapes_during_churn) on the
          card, its body verbatim (testing/scrape_convoy.reference_case):
          14 churn cycles of the sim's smoke scenario beside five threads
          scraping /metrics, /debug/timeline, /debug/slo, /healthz and
          /traces in a loop that never waits, every scrape checked
          (status 200, the cycle-seconds TYPE line, the timeline and SLO
          bundles load, /healthz parses), then scrapes > 0, no error, no
          invariant breach. Before it the same 14 cycles with no scraper
          on the card, its torch calls counted by route, and on the CPU:
          the three binding logs' SHA-256 equal. Fails past 150 s with
          the scrapers, on any failed check, or with no kernel 1 launch.
          Prints both card runs' wall seconds, the torch calls a cycle by
          route (round, pack, upload, diagnose, rest), the scrapes served
          and kernel 1's launches.
  rebalance  BASELINE config 5 (koord-descheduler LowNodeLoad, 50,000
          running pods x 5,000 nodes, testing/rebalance_fixture.py, nothing
          cut) through Descheduler(store, device="cuda"): a warm-up pass,
          then 10 passes of the host oracle and 10 device passes over one
          packed view (each device pass on the card, its victims equal to
          the host oracle's, order included, is_low/is_high equal to
          classify_nodes); the step alone (CUDA events, median of 10), its
          launches (torch.profiler, once) and its bytes bound; then
          run_once against a rebalance="host" twin on an identical store:
          the PodMigrationJob lists must be equal, order included. Prints
          the host and device pass times, the device pass's spans, and
          the victim and job counts.
  lownodeload_floor  (inside rebalance, before run_once) the compiled
          serial floor (native/serial_floor.cpp, g++ -O2 -ffp-contract=off
          -fno-fast-math, built into build/native/) on pack_floor_inputs of
          the same store, on the host CPU: its victims must be the device
          pass's pods. Prints its ms (median of 3) beside the host oracle's
          and the device pass's medians.
  rebalance_colocated  config 4 (churn_store(5000, 10000, seed=42)):
          Scheduler(store) through cycle 0, then Descheduler(store,
          scheduler=sched): the rb_* fields ride the scheduler's
          DeviceSnapshot, the pass runs on the card with the host oracle's
          victims over the same view, run_once writes one job per victim,
          and the scheduler's ladder stays at full. Prints the victim
          count (0 included).
  rebalance_mesh  config 5 through a standalone Descheduler whose pass
          runs on KOORD_TPU_MESH=2 virtual shards of the card beside a
          single-device one on an identical store: 4 passes' victims
          (order included), classification and margins, then run_once's
          migration jobs, equal.
  colo    config 4's nodes, pods and NodeMetrics (churn_store(5000, 10000,
          seed=42)) without its ElasticQuotas, one NodeMetric in 20 stale,
          through Manager(store, device="cuda"): 2 warm-up and 5 timed
          ticks with 50 NodeMetrics changed a tick, then a tick under each
          calculate policy (usage, request, maxUsageRequest) after a
          ConfigMap hot reload, each beside a Manager(colo="host") twin on
          an identical store. Every pass on the card; the batch/mid
          integers on every node and the degraded set equal the twin's.
          Prints the device pass's median and range and its spans (pack,
          encode, kernel, readback, writeback; host clock), the host
          pass, and the step alone (CUDA events, median of 10) against the
          same step on the CPU, bit for bit, with its launches
          (torch.profiler) and its bytes bound.
  colo_mesh  the same world through a standalone Manager whose pass runs
          on KOORD_TPU_MESH=2 virtual shards of the card, beside a
          single-device Manager on an identical store: 5 ticks' published
          batch/mid integers and degraded sets equal.
  colo_quota  config 4's quota tree (root, 25 teams, 74 jobs; G = 128
          padded), the root given a shared weight, on the largest prefix
          of config 4's nodes inside the fold's f32 envelope (found with
          _device_eligible; printed with the cluster total and the
          verdicts, the unmodified config 4 store's included): 10 ticks
          with quota churn (a running member pod added, a job's min and
          max shrunk) beside a host twin. Every pass on the card, the
          runtime matrix equal to compute_runtime_quotas, the revoke
          victim lists equal, order included. Prints the pass and step
          times and the fold's launches.
  colo_colocated  the quota-free config 4 store through Scheduler(store)
          cycle 0, then Manager(store, scheduler=sched), two manager ticks
          each followed by a cycle with 100 batch-class arrivals, beside a
          colo="host" twin: the cycles bind identically, the colo_* fields
          sit in the scheduler's mirror beside its own and no private
          mirror is built. Prints the first pass (every field put) and the
          steady pass.
  scheduler_explain  config 4 (churn_store(5000, 10000, seed=42))
          through the default path (auto waves, chained dispatch) with
          explain "counts" and "full" beside an explain-off twin, and a
          serial "counts" twin (waves=1) running as many cycles as the
          default path consumed: cycle 0 and EXPLAIN_MEASURED churn
          cycles of 1000 arrivals. Bindings, failure lists and every
          PodScheduled message equal every cycle; on every cycle with
          explain on, one stage-count pass (explain_counts.cu) per round,
          and at "full" every round in kernel 1's terms instance; none
          with explain off. Prints the median cycle ms of each, explain's
          overhead, the spans diagnose, kernel, replay_drain and encode,
          and the explain readback bytes a cycle.
  ladder_explain  config 4 through Scheduler(explain="counts") at its
          default waves under a dispatch-fault storm: full ->
          serial-waves -> no-explain (the pass binds there without
          attribution) and back through serial-waves to full, as
          planned, with zero invariant breaches; the stage-count pass
          launches on every cycle above no-explain and on none at it.
  koord_scheduler  the port's binary, cmd.koord_scheduler.main, on the
          card at --synth KOORD_SCHEDULER_SYNTH (2500x5000) with
          KOORD_TPU_EXPLAIN=counts and
          KOORD_TPU_WAVES=1 (BINARY_ENV says why), three ticks
          KOORD_SCHEDULER_INTERVAL seconds apart, --obs-port on a
          free port; between the last two /healthz, /metrics and /explain
          for a bound pod and an unschedulable one (a pod no node fits,
          added to the binary's store) over HTTP, each /explain body
          equal to the Scheduler's own record.
  cold_start  two child processes in turn (testing/cold_start.py, config 4's
          churn store at the default path, cycle 0 and 1 churn cycle) on
          a fresh KOORD_TPU_COMPILE_CACHE_DIR: the cold process with
          warm-up off records the steps it builds in the rung index; the
          restart with KOORD_TPU_WARMUP=sync replays them before its first
          cycle. Gates: every rung warmed (warmed == rungs > 0), none
          failed or invalidated, zero steady-state step builds, the cold
          process's bindings every cycle. Prints both processes'
          construction and construction-to-first-bind seconds, cycle 0's
          kernel spans and the warm-up seconds.
  koord_descheduler, koord_manager  the port's two binaries,
          cmd.koord_descheduler.main and cmd.koord_manager.main, on the
          card at --synth 5000x10000 for 3 ticks 1 s apart: exit 0 and one
          device pass a tick (rebalance windows, colo passes by engine).
  scheduler_sidecar  config 4 (churn_store(5000, 10000, seed=42)) through
          Scheduler(store, device="cuda", sidecar_address=...) against a
          ScheduleBatch server in this process (serve_sidecar on an
          abstract unix socket, SidecarServer(device="cuda")), beside its
          serial twin Scheduler(waves=1) on an identical store, for cycle
          0 and 1 churn cycle of 1000 arrivals: bindings, failure lists
          and canonical dumps identical, every cycle demoted with reason
          sidecar, no fallback, kernel 1 launched by the server. Then the
          server stops and one more churn cycle must bind as the twin does
          through the Scheduler's own step (kernel 1 launched locally),
          with sidecar_fallbacks 1.
  soak    the sim's 1000-cycle soak on the card (a dispatch fault, a
          store-write fault, a dispatch storm to the host fallback, three
          dead-sidecar cycles; pipeline on, waves auto): the binding log's
          SHA-256 the JAX package's (pinned), three sidecar fallbacks, no
          invariant breach, the store-write fault the only cycle
          exception. No CPU twin (time limit).
  node_probe  the koordlet's device probes on this card:
          collect_gpu_devices reports one device, nvidia-smi's uuid, minor
          0, torch's total memory as gpu_memory; sample_gpu_devices' bytes
          in use rise by at least 1 GiB with a 1 GiB allocation; a child
          process samples as a fresh agent does, and its bytes in use less
          this process's are the CUDA context an agent costs the card.
          The perf reader (native/perf_reader.cpp) builds into
          build/native/; perf.available() is printed (False where the
          kernel denies perf_event_open).
  node_agent  the colocation loop at config 4's width with a GPU pool:
          two stores from churn_store(5000, 10000, seed=42), 64 nodes of
          each (testing/gpu_pool.py) running a koordlet Daemon on its own
          FakeFS with the real device collector (each publishes this
          card), a manager tick (GPUDeviceResource writes the pool's GPU
          totals; the replica then stops, its webhook refusing the synth
          world's LSR/koord-batch pods at bind time), 128 GPU-share pods
          (gpu_core and gpu_memory_ratio cycling 25, 50, 100: 7,425 of
          the pool's 6,400 core-percent), then Scheduler(store) at its
          defaults beside a waves=1 twin through cycle 0 and 1 churn
          cycle of 1000 arrivals (1 of the 2 first planned, for the time
          limit). Gates: the twins' bindings and failure
          lists equal every cycle and their final dumps (PodScheduled
          messages) equal; kernel 1 once per serial window and in every
          wave; the round's R above config 4's 3; the last cycle's first
          R = 5 round with a GPU pod (kernel 1's generic instance) equal
          to the plain round on the same tensors, in shared and in device
          memory; every bound GPU pod on a pool node, each card's gpu_core
          at most 100 and gpu_memory at most its total, every
          allocation's minor the probed one on a node whose Device CR
          names the probed uuid; for each pending GPU pod and each pool
          node, the Filter stages that reject it (the scheduler's own
          diagnosis over one more twin cycle, which binds nothing): every
          pair rejected, the GPU axes exactly where the card lacks the
          pod's gpu_core by the allocation annotations, no device reason
          in a PodScheduled message; the GPU outcome's SHA-256 the pinned
          one. Prints each cycle's R and kernel 1's route (state,
          instance), the spans, the GPU pods bound, the rejection split
          and a pool Daemon.run_once's median ms (16 of them, timed after
          the cycles).
  demo    cmd.demo.main([]) in this process with its defaults (the card):
          exit 0, "demo complete", 2 of its 3 BE pods bound (the JAX
          demo's outcome: the batch allocatable fits two) through kernel 1
          and their BE cgroup values read back from its FakeFS.
  node_binaries  cmd.koordlet.main --fake-node for two ticks: exit 0 and
          its log's Device CR line naming this card; then cmd/koord_runtime_proxy.py
          (--mode cri) as a child process between a fake containerd and
          the koordlet's hook server over unix sockets
          (testing/cri.py): a BE pod's RunPodSandbox and CreateContainer,
          the container request reaching containerd with the hook's
          cgroup writes.
  scheduler_mixed  mixed_cluster(101, 500 nodes, 1000 pods) as a store,
          through Scheduler(device="cuda", waves=1) and a
          Scheduler(device="cpu", waves=1) twin (the plain round) for cycle 0
          and 1 churn cycle of 100 arrivals: the canonical dumps of both
          worlds (every pod's node, annotations and PodScheduled condition,
          every PodGroup's status, every ElasticQuota's used vector) must be
          identical after every cycle.
  main    BASELINE config 4 (synth_full_cluster(5000, 10000, seed=42,
          num_quotas=100, num_gangs=200), bucket-padded to 5120 nodes x
          10240 pods): host pack -> active-axis reduction ->
          SidecarServer.schedule_batch on CUDA, with the launch counts read
          around that call; a second, warm call split into its layers
          (upload, round, Permit, readback; host clock, synchronised
          between them); then the full-chain kernel's time (CUDA events,
          median of repeated rounds after a warm-up) and the plain torch
          round on the card over the same inputs, as its explain "full"
          variant, which must give the same bindings. Both rounds' chosen
          must have the digest CONFIG4_ROUND_JAX_CHOSEN_SHA256, and their
          requested and quota_used must be within ROUND_ATOL of the
          arrays in tests/fixtures/config4_round_jax.npz: the JAX
          package's XLA step on its own pack of the same cluster.
  sidecar_grpc  the same batch over gRPC: serve_sidecar around main's
          SidecarServer on an abstract unix socket, a SidecarClient sending
          it (1 cold call, 3 warm): chosen, requested and quota_used equal
          the in-process call's bit for bit, one kernel 1 launch a call.
          Prints the request and response bytes, a warm call's split
          (pack, serialize, transport, the handler's unpack, upload,
          round, permit, readback and response, the decode) and
          kernel_seconds. The C++ client does not run: the card's machine
          has no protoc and no libprotobuf headers.
  compiled_floor  the compiled serial floor on main's batch on the host
          CPU (median of 3): its bindings equal kernel 1's and the plain
          round's bit for bit. Prints vs_compiled_floor (the floor's
          seconds over the warm schedule_batch call's, bench.py's ratio)
          and the round-only ratio (over kernel 1's CUDA-event time), with
          the card's name and power limit.
  explain_round  koordexplain's two kernels at config 4 (P = 10240)
          against that plain round: the stage-count pass
          (csrc/explain_counts.cu) equal to the plain counts exactly;
          kernel 1's terms instance giving the chosen, requested and
          quota of the instance without terms, and the whole explain
          step (Permit, counts, terms) equal to the plain round's bit for
          bit; both timed (CUDA events, median of 10) at P = 10240 and
          at the churn wave's P = 1280 beside kernel 1 without terms. The
          pass also equals the plain counts at P = 1280; called alone it
          is timed as a call, as its launch alone and as its kernel's
          device time (torch.profiler); the explain step must launch it
          once on the round's own pack (ops/explain_kernel.self_packs
          stays 0), and the step at "counts" and the round with the pass
          beside it are timed against the step and the round without.
  wave_round  the wave-parallel round (models/wave_chain.py, plain
          PyTorch, kernel="wave" in the selector) at config 4 (P = 10240)
          and at P = 1280: chosen, requested and quota_used equal to
          kernel 1's bit for bit; its time against kernel 1's (CUDA
          events, median), its launches (torch.profiler), its waves and
          host reads of the wave cut (one a wave), and a bound from the
          inputs and each wave's [W, N] rows.
  main_global  the same kernel with its carried state in device memory
          (smem_budget_bytes=0), against the plain round of `main`.
  mixed   mixed_cluster at 500 nodes x 1000 pods (affinity, spread,
          preferred node/pod affinity, ports, images, CSI volume groups,
          taints): kernel against the plain round; the stage-count pass
          against the plain counts at the cycle-start and a perturbed
          state, alone and over 2 and 3 shards of the card.
  prod    the mixed cluster with score_according_prod_usage: kernel against
          the plain round.
  loadaware  the LoadAware-only round of bench.py's default chain
          (synth_cluster(5000, 10000, seed=42), padded to 10240 pods x 5120
          nodes x 14 axes): pack -> make_inputs -> build_best_schedule_step
          on CUDA, with the launch counts read around that call; then the
          LoadAware kernel's time, the plain torch round on the card (same
          bindings, requested within 1e-4) and the numpy oracle
          serial_schedule on the first 25 pods (same bindings). Both
          rounds' chosen must have the digest LOADAWARE_JAX_CHOSEN_SHA256,
          the JAX package's XLA step on its own pack of the same
          cluster.
  loadaware_prod  the same with score_according_prod_usage (no JAX pin).
  loadaware_global  the LoadAware kernel with its carried state in device
          memory (smem_budget_bytes=0), against the plain round of
          `loadaware`.
  generic both kernels with a third weighted axis (cpu, memory and pods),
          which takes their generic instances instead of the ones
          specialised for the common shape (3 axes, 2 zones, 2 weights):
          the full chain on the mixed cluster and the LoadAware round on
          synth_cluster(500, 1000, seed=7), each in both states against
          its plain round.
  mesh_round  the sharded full-chain step (explain "full": kernel 1, its
          terms instance and the stage-count pass on the gathered node
          fields) and the sharded LoadAware step (kernel 2) at D = 1, 2,
          3, 4 and 8 virtual shards of the card, on `main`'s batch and
          `loadaware`'s, each against the single-device launches on the
          same padded tensors: 0 mismatches; both timed (CUDA events,
          median of 10). Then the instances over a mesh of cards
          (testing/mesh_round.py): at D = 2, 4 and 8 virtual cards, all
          in one launch, kernel 1's round and terms instances, the
          per-card replay, the per-card stage counts and kernel 2's
          exchange instance against the single-device kernels, bit for bit
          (timed at D = 2); a lone shard of a D = 2 exchange times out
          (the exchange's 2 s limit) naming shard 1 and the next launch
          passes; shard 1 launched late, its first entries planted at
          shard 0's (shortened) deadline, ends every group with
          ExchangeTimeout or the single-device bindings, never a trap
          (check_deadline); the sharded steps
          (explain "full", LoadAware) on 2 exchanging virtual cards with
          their launch counts set to 0 before and read after, against the
          single-device kernels; and each instance against its plain
          version on the card (the plain sharded round with its terms,
          the plain per-shard replay and counts, the plain sharded
          LoadAware round) on the first PLAIN_PODS valid pods.
  mesh_procs  the mesh of cards across processes: 2 worker processes on
          the one card (testing/xproc_cards.py), one shard each, whose
          exchange maps each other's mailboxes through CUDA IPC; each
          must hold this process's card (PCI bus id). They measure the
          mailbox round trip between them, then run testing/mesh_round.
          run_checks: kernel 1's exchange round and terms instance, the
          per-card replay and stage counts and kernel 2's exchange
          instance at `main`'s and `loadaware`'s node widths, the score
          matrix over both mesh axes (each process's blocks against its
          own whole matrix), the fused wave step at K = 2 with explain
          "counts" and one chained wave (config 4's world), all on
          P_XPROC pods, and a launch group that rank 1 skips (both
          processes raise ExchangeTimeout naming shard 1 within 2 x the
          limit + 1 s; the next group passes). Both processes print one
          digest; every output equals the single-card kernels' in this
          process (mesh_round.reference), bit for bit, and both digests
          equal its digest.
Every phase that injects no fault ends with each scheduler's ladder at
full, no transition and no dispatch retry (ladder_full in its line).
Each kernel's phase line names the launch: the state it kept (smem or
global), the instance (common or generic), cluster_size, block_threads and
smem_bytes_per_block. Every phase holds the kernel's bindings and outputs
equal to the plain round's: 0 mismatches and max |err| 0.0. Then a line
of each phase's wall seconds and the script's, the
kernels line (kernel 1, kernel 2, the replay kernel, the stage-count
pass and the terms instance, each with its launches on the scheduler
paths; then their instances over a mesh of cards: kernel 1's exchange
round and terms round, the per-card replay, the per-card stage counts and
kernel 2's exchange instance, with their launches on scheduler_xchg,
mesh_round's exchange path and mesh_procs' processes), the card line, and the result line. Any failure raises: the
script exits non-zero and prints no result. It imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import hashlib
import json
import os
import pickle
import resource
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
import urllib.request

import numpy as np
import torch

from koordinator_tpu_torch.api.resources import ResourceName
from koordinator_tpu_torch.client.store import KIND_POD
from koordinator_tpu_torch.models.convert import (
    schedule_inputs_from_numpy,
    to_device,
)
from koordinator_tpu_torch.models import fused_waves
from koordinator_tpu_torch.models.full_chain import (
    NUM_EXPLAIN_STAGES,
    build_full_chain_step,
    cycle_start_state,
    explain_stage_counts,
    permit,
    plain_round,
    resolve_balance_idx,
    resolve_weight_idx,
)
from koordinator_tpu_torch.models.scheduler_model import (
    build_best_schedule_step,
    build_schedule_step,
)
from koordinator_tpu_torch.ops import explain_kernel as ek
from koordinator_tpu_torch.ops import full_chain_kernel as fck
from koordinator_tpu_torch.ops import schedule_kernel as sk
from koordinator_tpu_torch.ops.kernel_common import (
    BUILD_LOG,
    EXCHANGE_TIMEOUT_S,
    IPC_SOURCE,
    SMEM_BUDGET_BYTES,
    build_libraries,
)
from koordinator_tpu_torch.ops.loadaware import LoadAwareArgs
from koordinator_tpu_torch.scheduler import metrics as scheduler_metrics
from koordinator_tpu_torch.scheduler import pipeline_parity
from koordinator_tpu_torch.scheduler.cycle import CyclePipeline, Scheduler
from koordinator_tpu_torch.scheduler.degrade import DegradationLadder
from koordinator_tpu_torch.scheduler.parity import serial_schedule
from koordinator_tpu_torch.scheduler.snapshot_cache import DeviceSnapshot
from koordinator_tpu_torch.scheduler.sidecar import SidecarServer
from koordinator_tpu_torch.scheduler.snapshot import (
    build_full_chain_inputs,
    reduce_to_active_axes,
)
from koordinator_tpu_torch.sim.faults import Fault, FaultPlan
from koordinator_tpu_torch.sim.harness import run_scenario
from koordinator_tpu_torch.sim.invariants import check_invariants
from koordinator_tpu_torch.sim.scenarios import SCENARIOS
from koordinator_tpu_torch.testing import (
    loadaware_inputs,
    mixed_cluster,
    synth_cluster,
    synth_full_cluster,
)
from koordinator_tpu_torch.testing import (
    churn,
    cross_card,
    mailbox_rtt,
    mesh_round,
    xproc_cards,
)
from koordinator_tpu_torch.testing.kernel_ab import (
    counts_timings,
    launch_alone_ms,
    pod_rows,
)
from koordinator_tpu_torch.testing.churn import (
    add_arrivals,
    arrival_specs,
    conditions,
    cycle_dump,
    outcome_sha,
    result_key,
    churn_schedule,
    round_sha,
    store_from_state,
)
from koordinator_tpu_torch.utils.features import SCHEDULER_GATES

SCRIPT_START = time.perf_counter()
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
REPS = 10  # timed rounds after the warm-up
# the numpy oracle's pods (bench.py's --serial-sample default is 200; cut
# to 100, then to 50, then to 25 when the racecheck phase joined the
# script, for its time limit)
ORACLE_PODS = 25
# bench.py run_churn's shape: warm-up (its 2, cut to 1 for the time
# limit; without it the serial cycle measured was the first churn cycle,
# 960.9 ms against 668.9-891.4 after one, NVIDIA H100 80GB HBM3, 700.00 W)
# and measured churn cycles (--smoke's count, 3, until the mesh phases
# joined the script, 2 until the racecheck phase did), num_pods // 10
# arrivals each
CHURN_WARMUP, CHURN_MEASURED = 1, 1
# the spans a cycle is split into (direct children of the cycle root, and
# the upload/readback and pack_incremental children of kernel and encode)
CYCLE_SPANS = ("reservation_prepass", "snapshot", "encode", "compile",
               "kernel", "bind", "diagnose", "overlap_wait", "prepack",
               "store_flush")
NESTED_SPANS = ("pack_incremental", "upload", "readback")
# the fused path adds the chained replay's span (wave_replay children)
WAVE_SPANS = CYCLE_SPANS + ("replay_drain",)
# the default-waves phase: cycle 0, then warm-up (1 until the racecheck
# phase joined the script: on the card the default path's first churn
# cycle takes what the next one does, 1397 against 1363 ms, NVIDIA H100
# 80GB HBM3, 700.00 W) and measured churn cycles
# (3 measured until the storage, cold start, binary and wave phases
# joined the script, 2 until the mesh phases did)
WAVE_CHURN_WARMUP, WAVE_CHURN_MEASURED = 0, 1
# the ladder phase: churn cycles after cycle 0, the ladder's re-promotion
# probe, the dispatch deadline armed in the faulted scheduler and the
# delay of the latency fault (a wave 1 takes at most ~0.1 s on the card)
LADDER_CYCLES, LADDER_PROMOTE_AFTER = 10, 2
# the unfaulted twin (b) runs cycle 0 and the retry-only faults' cycles,
# the ones (a) is held to it (all 11 until the racecheck phase joined the
# script)
LADDER_TWIN_CYCLES = 4
LADDER_DEADLINE_MS, LADDER_DELAY_MS = 2000.0, 4000.0
# the fault plan, by churn cycle, and the ladder level after each cycle
LADDER_FAULTS = (
    Fault(cycle=1, kind="dispatch", message="ladder: one dispatch fault"),
    Fault(cycle=2, kind="oom_upload", message="ladder: one upload OOM"),
    Fault(cycle=3, kind="latency", delay_ms=LADDER_DELAY_MS,
          message="ladder: one slow readback"),
    # the fused window: retry, then demote to serial waves (the pass
    # re-runs serially); next cycle the serial window: retry, then demote
    # to the host fallback
    Fault(cycle=4, kind="dispatch", count=2, message="ladder: fault storm"),
    Fault(cycle=5, kind="dispatch", count=2, message="ladder: fault storm"),
)
LADDER_LEVELS = [0, 0, 0, 0, 3, 5, 5, 3, 3, 0, 0]
LADDER_WALK = [("full", "serial-waves"), ("serial-waves", "host-fallback"),
               ("host-fallback", "serial-waves"), ("serial-waves", "full")]
# the sim phase: the catalog scenarios the port runs, on the card and in
# a CPU twin, cut for the script's time limit: gang-storm to 60 of its 300
# cycles (its CPU twin to 40), spot-churn to 40 of 300 (30), drain-storm
# to 40 of 200, and hotspot and overcommit-shift to 80 of 160 (one
# hotspot and its 30-cycle dissipation window, one prod-usage surge);
# a CPU twin cut below its card run (the plain round's per-pod loop over
# the backlog takes ~0.1-0.4 s a cycle on the host) is held against the
# card run's first cycles
SIM_SCENARIOS = (("smoke", 50, 50), ("gang-storm", 60, 40),
                 ("spot-churn", 40, 30), ("crash-restart", 36, 36),
                 ("drain-storm", 40, 40), ("hotspot", 80, 80),
                 ("overcommit-shift", 80, 80))
# overcommit-shift's binding log at the 80 cycles above in the JAX package
# as it stands (koordinator_tpu.sim.harness.run_scenario on the CPU, with
# resolved(cycles=80)); COLO_r01.json holds an older tree's record of the
# scenario at its catalog 160
OVERCOMMIT_SHIFT_JAX_SHA256 = (
    "1afd292185dc2cd14637d85e1387ae8f616ef50849309a907a6e027a439070f8")
# the colo phases: warm-up and timed manager ticks (colo's timed ticks
# 10 until the racecheck phase joined the script; colo_quota's quota
# churn keeps its 10), and one NodeMetric in COLO_STALE_EVERY made stale
# (5% of config 4's nodes)
COLO_WARMUP, COLO_TICKS, COLO_STALE_EVERY = 2, 5, 20
QUOTA_TICKS = 10
# koordexplain: the warm-up and measured churn cycles of
# scheduler_explain after cycle 0 (1 warm-up until the racecheck phase
# joined the script; see WAVE_CHURN_WARMUP), the explain ladder's fault
# storm (the fused window: retry, demote to serial waves, whose pass
# retries and demotes to no-explain and binds there), its level after
# each cycle and its walk, and the koord_scheduler binary's seconds
# between its two ticks (the probe reads /explain between them); 2
# measured cycles until the mesh phases joined the script
EXPLAIN_WARMUP, EXPLAIN_MEASURED = 0, 1
EXPLAIN_LADDER_FAULTS = (
    Fault(cycle=1, kind="dispatch", count=4,
          message="ladder_explain: fault storm"),
)
EXPLAIN_LADDER_LEVELS = [0, 4, 4, 3, 3, 0]
EXPLAIN_LADDER_WALK = [("full", "serial-waves"),
                       ("serial-waves", "no-explain"),
                       ("no-explain", "serial-waves"),
                       ("serial-waves", "full")]
KOORD_SCHEDULER_INTERVAL = 2.0
# the binary's environment: explain counts, and serial dispatch. The
# binary's --synth world is preemption-heavy: at 5000x10000 ~1,500 pods
# stay pending, and the host's DefaultPreemption dry runs over 5,000 nodes
# take ~16 s a logical cycle, so default waves (8 logical cycles at the
# first tick, 4 at the next) cost ~250 s over three ticks (NVIDIA H100
# 80GB HBM3, 700.00 W); the default path with explain is
# scheduler_explain's
BINARY_ENV = {"KOORD_TPU_EXPLAIN": "counts", "KOORD_TPU_WAVES": "1"}
# the binary's --synth world: config 4's 5000x10000 until the mesh phases
# joined the script, halved for its time limit (its three serial ticks
# took 44-52 s there, most of it in those preemption dry runs)
KOORD_SCHEDULER_SYNTH = "2500x5000"
# the storage phase: the share of pending pods and arrivals carrying
# claims, and the churn cycles after cycle 0 (2 until the racecheck phase
# joined the script; the provisioner serves cycle 0's claims before
# cycle 1)
STORAGE_CLAIMS, STORAGE_CHURN = 0.2, 1
# the wave round's timed calls beside the compare call at P = 10240 (each
# ~2,400 waves, ~24 s on the card) and at P = 1280 (2 until the mesh
# phases joined the script, 1 until the racecheck phase did), and the two
# batch prefixes its launches are counted on
WAVE_ROUND_REPS = (0, 0)
WAVE_PROFILE_PODS = (32, 64)
# the mixed-cluster cycle phases: cycle 0 and churn cycles (2 until the
# slice-10 phases joined the script)
MIXED_CYCLES = 2
# the mixed clusters' nodes and pods (scheduler_mixed,
# scheduler_waves_mixed, mixed, prod and generic's full chain; generic's
# LoadAware round on synth_cluster at the same size): 1000 x 2000 until
# the mesh phases joined the script, halved for its time limit (the packed
# widths T, S, S2, PT, SI and VG are the same at both sizes)
MIXED_NODES, MIXED_PODS = 500, 1000
# a cold-start child's time limit, and the two binaries' ticks and the
# seconds between them
COLD_START_TIMEOUT_S = 600
# the cold-start children's churn cycles after cycle 0 (the module's
# default 2 until the mesh phases joined the script)
COLD_START_CHURN = 1
BINARY_TICKS, BINARY_INTERVAL = 3, 1.0
# slice 11: the compiled floors' timed runs; the gRPC phase's warm calls;
# the sidecar Scheduler's churn cycles after cycle 0 (the server up; one
# more runs with it stopped); and koordinator_tpu.sim's soak (its catalog
# 1000 cycles, seed 7) on the CPU: the binding log's SHA-256, which
# tests/test_torch_sim.py pins too
FLOOR_REPS = 3
SIDECAR_REPS = 3
# (2 churn cycles with the server up until the racecheck phase joined the
# script)
SIDECAR_CHURN = 1
SOAK_JAX_SHA256 = (
    "ec11853b366b054bae39759292b5a9540823fc6083de5f83cf7cb6e38287e880")
# slice 12, the node side: the GPU pool (64 of config 4's 5,000 nodes, one
# card each), its GPU-share pods and the churn cycles after cycle 0 (1 of
# the 2 first planned: with 2, the four node phases took 99.6 s of the
# 90 s they may add, NVIDIA H100 80GB HBM3, 700.00 W)
GIB = 1024 ** 3
NODE_POOL, NODE_GPU_PODS, NODE_CHURN = 64, 128, 1
# the pool Daemons whose run_once is timed after the cycles (all 64 until
# the racecheck phase joined the script)
NODE_RUN_ONCE_TIMED = 16
# node_agent's GPU outcome (gpu_outcome_hash) for seed 42, pinned from a
# run on the card: 55 of the 128 GPU pods bound, filling 31 cards
NODE_AGENT_OUTCOME = (
    "4ee342900c9a575bf165c59581bd13b33c6211278810c86e634f3329717e7336")
# BASELINE config 4 ("Full plugin chain"): the nodes and pods of every
# phase held to a JAX pin below
CONFIG4_NODES, CONFIG4_PODS = 5000, 10000
# config 4 held to the JAX package's own decisions, each regenerated on
# the CPU by a tier-1 test (tests/test_torch_full_width_*.py), digests by
# testing/churn.outcome_sha and round_sha:
# - the default path: koordinator_tpu.scheduler.cycle.Scheduler(store,
#   explain="off", mesh="off", warmup="off") on the JAX twin of
#   churn_store(5000, 10000, seed=42), cycle 0 and WAVE_CHURN_WARMUP +
#   WAVE_CHURN_MEASURED churn cycles of arrival_specs(c, 1000) (created at
#   now + c, run at now + 2c); its outcome digest and each cycle's
#   CycleResult.waves (testing/churn.churn_schedule's cycles)
CONFIG4_WAVES_JAX_SHA256 = (
    "c7253e03f18776a33d56e453f216808e07a67c93526d537a4de0a25303fd8d09")
CONFIG4_WAVES_JAX_WAVES = (8, 4)
# - serial dispatch: the same Scheduler with waves=1 over the scheduler
#   phase's cycle 0 and CHURN_WARMUP + CHURN_MEASURED churn cycles
CONFIG4_SERIAL_JAX_SHA256 = (
    "b10610f8ee277ca9f6b7d88edbb552e65ae4e07e388b319486c9b5ae41c62e4c")
# - main's round: koordinator_tpu.models.full_chain.build_full_chain_step
#   (XLA) on the JAX package's build_full_chain_inputs of
#   synth_full_cluster(5000, 10000, seed=42, num_quotas=100,
#   num_gangs=200), reduced by its reduce_to_active_axes; the digest of
#   chosen, and requested and quota_used kept in tests/fixtures/ (held at
#   ROUND_ATOL, tests/test_torch_full_chain.py's tolerance against the JAX
#   package)
CONFIG4_ROUND_JAX_CHOSEN_SHA256 = (
    "1985af7402cfcc6c965bc3baf75a7bdadafd625d3e941d439dc7006cc41cad24")
CONFIG4_ROUND_JAX_FIXTURE = "config4_round_jax.npz"
ROUND_ATOL = 1e-3
# - the LoadAware headline: koordinator_tpu.models.scheduler_model.
#   build_schedule_step (XLA) on synth_cluster(5000, 10000, seed=42) packed
#   as bench.py's default chain packs it (10240 x 5120 x 14); the digest of
#   chosen
LOADAWARE_JAX_CHOSEN_SHA256 = (
    "b5e3aa264b6152da64edfcb9a711c99ed4b1a1b4d8722e0448596dcc0fea336d")


def round_ops(fc, W: int, balanced: bool) -> int:
    """f32 operations of one round on these inputs, counted from
    csrc/full_chain.cu for R resource axes, K zones and W weighted axes.
    Every (pod, node) pair: Fit 2R, LoadAware and NUMA least-allocated
    2W x 5 plus two weighted sums 2W x 2 and two divides, balanced
    allocation 10 where both its axes are active, score sum 3. Each (cpuset
    pod, node) pair adds the SMT and capacity test, 5; each (NUMA pod, node)
    pair adds the zone fits 2KR and zone totals (K-1)R."""
    P, R = fc.base.fit_requests.shape
    N = fc.base.allocatable.shape[0]
    K = fc.numa_free.shape[1]
    per_pair = 2 * R + 14 * W + 2 + (10 if balanced else 0) + 3
    n_bind = int(fc.needs_bind.sum())
    n_numa = int(fc.needs_numa.sum())
    return N * (P * per_pair + n_bind * 5 + n_numa * (3 * K - 1) * R)


def loadaware_ops(inputs, W: int) -> int:
    """f32 operations of one LoadAware round on these inputs, counted from
    csrc/schedule_step.cu. Every (valid pod, node) pair: Fit 2 per axis the
    pod requests (add, compare), 10 per weighted axis (term + delta, + est,
    the least-requested guard, subtract, multiply, divide, floor, weight,
    sum), 5 for the final divide and floor, the two selects and the argmax
    compare. Padded pods are skipped by the kernel and not counted."""
    fit_req = inputs.fit_requests.cpu().numpy()
    valid = inputs.pod_valid.cpu().numpy().astype(bool)
    N = inputs.allocatable.shape[0]
    fit_axes = int((fit_req[valid] > 0).sum())
    return N * (2 * fit_axes + int(valid.sum()) * (10 * W + 5))


def launch_fields(module):
    """The last launch of a kernel wrapper, for a phase line."""
    return {k: module.last_launch[k] for k in (
        "state", "instance", "cluster_size", "block_threads",
        "smem_bytes_per_block")}


def run_loadaware(tag, args, n_nodes, n_pods, device, jax_sha=None):
    """The LoadAware-only round through its entry point on the card, then
    the kernel's time, the plain round on the card and the oracle on the
    first ORACLE_PODS pods; with ``jax_sha``, both rounds' chosen must
    have that digest (the JAX package's round on the same cluster).
    Returns the kernels-line entry and the inputs and plain outputs, for
    the device-memory phase."""
    t0 = time.perf_counter()
    inputs = loadaware_inputs(
        synth_cluster(num_nodes=n_nodes, num_pods=n_pods, seed=42), args)
    pack_s = time.perf_counter() - t0
    # the oracle orders its f32 additions differently (it adds each
    # estimate into the term in place); the forms agree where the values
    # the round adds are integers below 2^24, so name those that are not
    non_integer = [f for f in ("fit_requests", "estimated", "allocatable",
                               "requested", "la_term_nonprod", "la_term_prod")
                   if not (np.all(np.floor(getattr(inputs, f))
                                  == getattr(inputs, f))
                           and np.abs(getattr(inputs, f)).max() < 2**24)]

    step = build_best_schedule_step(args, device=device)
    fck.launches = sk.launches = 0
    t0 = time.perf_counter()
    chosen, requested = step(inputs)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = {"schedule_step": sk.launches, "full_chain": fck.launches}
    launch = launch_fields(sk)
    if step.last_backend != "cuda" or launches["schedule_step"] < 1:
        raise AssertionError(
            f"{tag} did not run the kernel (backend {step.last_backend}, "
            f"launches {launches})")
    P, R = inputs.fit_requests.shape
    N = inputs.allocatable.shape[0]
    if chosen.shape != (P,) or requested.shape != (N, R):
        raise AssertionError(f"{tag}: unexpected output shapes")

    dev_inputs = schedule_inputs_from_numpy(inputs._asdict(), device)
    widx = resolve_weight_idx(args)
    prod = args.score_according_prod_usage
    kernel_ms = time_cuda(lambda: sk.schedule_round(dev_inputs, widx, prod),
                          REPS)
    plain = build_schedule_step(args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = plain(dev_inputs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    chosen_k, req_k = chosen.cpu().numpy(), requested.cpu().numpy()
    chosen_p, req_p = (x.cpu().numpy() for x in out_p)
    if not np.isfinite(req_k).all():
        raise AssertionError(f"{tag}: non-finite requested")
    if not ((chosen_k >= -1) & (chosen_k < N)).all():
        raise AssertionError(f"{tag}: chosen out of range")
    mism = int((chosen_k != chosen_p).sum())
    err = float(np.abs(req_k - req_p).max())
    if mism or err != 0.0:
        raise AssertionError(
            f"{tag}: kernel disagrees with plain round: {mism} bindings "
            f"differ, max |err| {err}")
    pin = {}
    if jax_sha is not None:
        shas = {round_sha(chosen_k), round_sha(chosen_p)}
        if shas != {jax_sha}:
            raise AssertionError(f"{tag}: chosen digests {shas}, not the "
                                 f"JAX package's {jax_sha}")
        pin = {"chosen_sha256": jax_sha, "jax_sha256_equal": True}

    # the oracle on the queue's first pods: the round is serial, so their
    # picks do not depend on the pods after them
    k = min(ORACLE_PODS, P)
    head = inputs._replace(**{
        f: np.asarray(getattr(inputs, f))[:k] for f in (
            "fit_requests", "estimated", "is_prod", "is_daemonset",
            "pod_valid")})
    t0 = time.perf_counter()
    chosen_o = serial_schedule(head, args)
    oracle_s = time.perf_counter() - t0
    oracle_mism = int((chosen_o != chosen_k[:k]).sum())
    if oracle_mism:
        raise AssertionError(
            f"{tag}: kernel disagrees with the oracle on {oracle_mism} of "
            f"the first {k} pods")

    in_bytes = sum(t.numel() * t.element_size() for t in dev_inputs)
    nbytes = in_bytes + P * 4 + N * R * 4
    ops = loadaware_ops(dev_inputs, len(widx))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    emit({"phase": tag, "nodes": n_nodes, "pods": n_pods, "P": int(P),
          "N": int(N), "R": int(R), "W": len(widx), "prod_mode": prod,
          **launch,
          "pack_seconds": round(pack_s, 3),
          "entry_point_seconds": round(call_s, 3),
          "pods_bound": int((chosen_k >= 0).sum()), "launches": launches,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "plain_compared_pods": int(P), "mismatches": mism,
          "max_abs_err": err, "oracle_pods": k,
          "oracle_seconds": round(oracle_s, 3),
          "oracle_mismatches": oracle_mism, "non_integer": non_integer,
          **pin,
          "input_bytes": int(in_bytes), "ops": ops,
          "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms})
    return (kernel_entry("schedule_step_round", "schedule_step.cu",
                         "koordinator_tpu/ops/pallas_step.py:46",
                         launches["schedule_step"], mism, err, kernel_ms,
                         plain_ms, bytes_ms, ops_ms),
            (inputs, out_p))


def run_loadaware_global(args, inputs, out_p, device):
    """The LoadAware kernel with its carried state in device memory, through
    the entry point, against the plain round already computed."""
    step = build_best_schedule_step(args, device=device, smem_budget_bytes=0)
    sk.launches = 0
    chosen, requested = step(inputs)
    torch.cuda.synchronize()
    if step.last_state != "global" or sk.launches != 1:
        raise AssertionError(f"loadaware_global ran state {step.last_state} "
                             f"with {sk.launches} launches")
    launch = launch_fields(sk)
    dev_inputs = schedule_inputs_from_numpy(inputs._asdict(), device)
    widx = resolve_weight_idx(args)
    kernel_ms = time_cuda(lambda: sk.schedule_round(
        dev_inputs, widx, args.score_according_prod_usage,
        smem_budget_bytes=0), REPS)
    mism = int((chosen != out_p[0]).sum())
    err = float((requested - out_p[1]).abs().max())
    if mism or err != 0.0:
        raise AssertionError(
            f"loadaware_global: kernel disagrees with plain round: {mism} "
            f"bindings differ, max |err| {err}")
    emit({"phase": "loadaware_global", **launch, "launches": 1,
          "kernel_ms": kernel_ms, "mismatches": mism, "max_abs_err": err})


def run_generic(device):
    """Both kernels' generic instances (three weighted axes) in both
    states, each against its plain round on the card."""
    args = LoadAwareArgs(resource_weights={
        ResourceName.CPU: 1, ResourceName.MEMORY: 1, ResourceName.PODS: 1})
    _c, state = mixed_cluster(7, MIXED_NODES, MIXED_PODS)
    fc, ng, ngroups, active = pack(state, args)
    dev_fc = to_device(fc, device)
    out_p = build_full_chain_step(args, ng, ngroups, active)(dev_fc)
    N = fc.base.allocatable.shape[0]
    inputs = loadaware_inputs(
        synth_cluster(num_nodes=MIXED_NODES, num_pods=MIXED_PODS, seed=7),
        args)
    dev_inputs = schedule_inputs_from_numpy(inputs._asdict(), device)
    la_p = build_schedule_step(args)(dev_inputs)
    for budget in (None, 0):
        step = fck.build_cuda_full_chain_step(args, ng, ngroups, active,
                                              smem_budget_bytes=budget)
        mism, err = compare("generic", step(dev_fc), out_p, N)
        la = build_best_schedule_step(args, device=device,
                                      smem_budget_bytes=budget)
        chosen, requested = la(inputs)
        la_mism = int((chosen != la_p[0]).sum())
        la_err = float((requested - la_p[1]).abs().max())
        if la_mism or la_err != 0.0:
            raise AssertionError(
                f"generic: LoadAware kernel disagrees with plain round: "
                f"{la_mism} bindings differ, max |err| {la_err}")
        if (fck.last_launch["instance"], sk.last_launch["instance"]) != (
                "generic", "generic"):
            raise AssertionError("generic: a specialised instance ran")
        emit({"phase": "generic", "W": 3, "full_chain": launch_fields(fck),
              "schedule_step": launch_fields(sk), "mismatches": mism,
              "max_abs_err": err, "loadaware_mismatches": la_mism,
              "loadaware_max_abs_err": la_err})


def last_cycle_root(sched):
    return [r for r in sched.tracer.roots() if r.name == "cycle"][-1]


def span_split(sched, names=CYCLE_SPANS) -> dict:
    """Milliseconds per span of the scheduler's last cycle: each direct
    child of the cycle root (summed by name), the upload/readback and
    pack_incremental children, and the rest of the cycle."""
    root = last_cycle_root(sched)
    out = {name: 0.0 for name in names + NESTED_SPANS}
    for child in root.children:
        if child.name in out:
            out[child.name] += child.duration_seconds * 1e3
        for sub in child.children:
            if sub.name in NESTED_SPANS:
                out[sub.name] += sub.duration_seconds * 1e3
    out["rest"] = root.duration_seconds * 1e3 - sum(
        out[name] for name in names)
    out["cycle"] = root.duration_seconds * 1e3
    return out


def median_split(splits) -> dict:
    return {k: statistics.median(s[k] for s in splits) for k in splits[0]}


def checked_cycle(tag, sched, run, now):
    """One cycle of ``sched`` (``run`` is its run_cycle or its pipeline's)
    with the launch counts set to 0 just before it and read just after:
    every dispatch window on the card launches the full-chain kernel
    exactly once and the LoadAware kernel never. Returns (result, wall
    seconds, launches, full garbage collections during the cycle)."""
    d0 = sched.dispatches
    gc0 = gc.get_stats()[2]["collections"]
    fck.launches = sk.launches = 0
    t0 = time.perf_counter()
    res = run(now=now)
    wall = time.perf_counter() - t0
    # Python's full (generation 2) collections inside the cycle: a pause
    # no span owns
    gc_full = gc.get_stats()[2]["collections"] - gc0
    windows = sched.dispatches - d0
    if sched.device.type == "cuda" and (
            sched.last_backend != "cuda" or fck.launches != windows
            or sk.launches != 0 or windows < 1):
        raise AssertionError(
            f"{tag}: {windows} dispatch windows, backend "
            f"{sched.last_backend}, launches full_chain {fck.launches} "
            f"schedule_step {sk.launches}")
    return res, wall, fck.launches, gc_full


def fc_fields(fc) -> dict:
    out = {f"base.{k}": v for k, v in fc.base._asdict().items()}
    out.update((k, v) for k, v in fc._asdict().items() if k != "base")
    return out


def check_mirror(fc, device) -> dict:
    """DeviceSnapshot on the card over one real batch: a put of every
    field, a row scatter while a round is in flight (into a clone) and one
    after it (in place), each tensor equal to to_device's in dtype and
    value. Returns the mirror's stats."""
    snap = DeviceSnapshot(device=device)
    snap.upload(fc)
    old = snap.upload(fc)  # nothing changed since the put: reused
    batches, step = [], fc
    n = fc.base.requested.shape[0]
    for rows in ((0, 7, n // 2), (1, 2)):
        req = np.array(step.base.requested, copy=True)
        req[list(rows)] += 1.0
        step = step._replace(base=step.base._replace(requested=req))
        batches.append(step)

    def check(got, host):
        want = fc_fields(to_device(host, device))
        for name, t in fc_fields(got).items():
            if t.dtype != want[name].dtype or not torch.equal(t, want[name]):
                raise AssertionError(f"mirror: {name} differs from to_device")

    snap.begin_dispatch()
    in_flight = snap.upload(batches[0])
    snap.end_dispatch()
    check(in_flight, batches[0])
    if not torch.equal(old.base.requested,
                       to_device(fc, device).base.requested):
        raise AssertionError("mirror: an in-flight scatter wrote in place")
    in_place = snap.upload(batches[1])
    check(in_place, batches[1])
    if in_place.base.requested is not in_flight.base.requested:
        raise AssertionError("mirror: a scatter after the sync cloned")
    if (snap.stats["scattered"], snap.stats["scattered_safe"]) != (2, 1):
        raise AssertionError(f"mirror: unexpected path {snap.stats}")
    return dict(snap.stats)


def run_scheduler(device):
    """BASELINE config 4 through Scheduler.run_cycle (bench.py run_churn's
    shape), three twins that must agree every cycle, then the kernel alone
    at the churn cycles' padded P. Returns the phase's full-chain
    launches."""
    arrivals = CONFIG4_PODS // 10
    retries0 = retries_now()
    t0 = time.perf_counter()
    (store_inc, state), (store_pipe, _s2), (store_cold, _s3) = (
        churn_store(CONFIG4_NODES, CONFIG4_PODS, seed=42) for _ in range(3))
    inc = Scheduler(store_inc, waves=1, device=device)
    pipe_sched = Scheduler(store_pipe, waves=1, device=device)
    pipe = CyclePipeline(pipe_sched, enabled=True)
    SCHEDULER_GATES.set_from_map({"IncrementalSnapshot": False})
    try:
        cold = Scheduler(store_cold, waves=1, device=device)
    finally:
        SCHEDULER_GATES.reset()
    if inc.snapshot_cache is None or cold.snapshot_cache is not None:
        raise AssertionError("scheduler: IncrementalSnapshot gate not applied")
    fixture_s = time.perf_counter() - t0
    twins = (("incremental", inc, inc.run_cycle),
             ("pipelined", pipe_sched, pipe.run_cycle),
             ("rebuild", cold, cold.run_cycle))
    observed = []
    now = state.now
    total_launches = 0
    walls = {name: [] for name, _s, _r in twins}
    kernel_s, splits, padded_p = [], [], []
    cycle0 = {}
    outcome = []  # the incremental world's result keys, for the JAX pin
    for c, specs, created, t in churn_schedule(
            now, CHURN_WARMUP + CHURN_MEASURED, arrivals):
        for store in (store_inc, store_pipe, store_cold):
            add_arrivals(store, specs, created)
        inc.encode_observer = lambda fc: observed.append(
            (fc.base.fit_requests.shape[0], fc))
        keys = {}
        for name, sched, run in twins:
            res, wall, launches, gc_full = checked_cycle(
                f"scheduler cycle {c} {name}", sched, run, t)
            total_launches += launches
            keys[name] = result_key(res)
            if name == "incremental":
                if c == 0:
                    cycle0 = {"seconds": wall,
                              "kernel_seconds": res.kernel_seconds,
                              "bound": len(res.bound),
                              "failed": len(res.failed),
                              "rejected": len(res.rejected),
                              "spans_ms": span_split(inc)}
                elif c > CHURN_WARMUP:
                    kernel_s.append(res.kernel_seconds)
                    splits.append(span_split(inc))
                    splits[-1]["gc_full_collections"] = gc_full
                    padded_p.append(int(observed[-1][0]))
            if c > CHURN_WARMUP:
                walls[name].append(wall)
        inc.encode_observer = None
        if not (keys["incremental"] == keys["pipelined"] == keys["rebuild"]):
            raise AssertionError(f"scheduler cycle {c}: twins disagree")
        if c and not keys["incremental"][0]:
            raise AssertionError(f"scheduler cycle {c}: nothing bound")
        outcome.append(keys["incremental"])
    pipe.flush()
    inc.flush_deferred()
    serial_sha = outcome_sha(outcome, store_inc)
    if serial_sha != CONFIG4_SERIAL_JAX_SHA256:
        raise AssertionError(f"scheduler: the outcome {serial_sha} is not "
                             f"the JAX package's {CONFIG4_SERIAL_JAX_SHA256}")

    # the kernel alone at the churn cycles' padded P: the last measured
    # cycle's inputs, with the step arguments its cached step was keyed on
    fc = observed[-1][1]
    sig = (fc.base.fit_requests.shape[0], fc.base.allocatable.shape[0],
           fc.quota_runtime.shape[0])
    actives = {key[3] for key in inc._step_cache if key[0] == sig}
    if len(actives) != 1:
        raise AssertionError(f"scheduler: steps for {sig} disagree on the "
                             f"active axes: {actives}")
    active = list(actives.pop())
    dev_fc = to_device(fc, device)
    wi, bi = resolve_weight_idx(inc.args, active), resolve_balance_idx(active)
    prod = inc.args.score_according_prod_usage
    churn_kernel_ms = time_cuda(
        lambda: fck.full_chain_round(dev_fc, wi, prod, bi), REPS)
    # the twin's mirror hands the round what to_device would
    mirror = fc_fields(inc.device_snapshot.upload(fc))
    for name, t in fc_fields(dev_fc).items():
        if mirror[name].dtype != t.dtype or not torch.equal(mirror[name], t):
            raise AssertionError(f"scheduler: mirror field {name} differs "
                                 "from to_device")
    mirror_check = check_mirror(fc, device)
    assert_ladder_full("scheduler", retries0, inc, pipe_sched, cold)

    t_inc = statistics.median(walls["incremental"])
    t_kernel = statistics.median(kernel_s)
    emit({"phase": "scheduler", "nodes": CONFIG4_NODES,
          "pods": CONFIG4_PODS,
          "arrivals_per_cycle": arrivals, "warmup_cycles": CHURN_WARMUP,
          "measured_cycles": CHURN_MEASURED,
          "fixture_seconds": round(fixture_s, 3),
          "twins_identical_every_cycle": True, "ladder_full": True,
          "launches": total_launches, "cycle0": cycle0,
          "cycle_ms": t_inc * 1e3, "cycle_ms_each": [w * 1e3 for w in
                                                     walls["incremental"]],
          "kernel_seconds_ms": t_kernel * 1e3,
          "host_ms": (t_inc - t_kernel) * 1e3,
          "spans_ms": median_split(splits),
          "spans_ms_each": splits,
          "pipelined_cycle_ms": statistics.median(walls["pipelined"]) * 1e3,
          "pipelined_cycle_ms_each": [w * 1e3 for w in walls["pipelined"]],
          "rebuild_cycle_ms": statistics.median(walls["rebuild"]) * 1e3,
          "rebuild_cycle_ms_each": [w * 1e3 for w in walls["rebuild"]],
          "pods_per_second": arrivals / t_inc,
          "device_snapshot": inc.device_snapshot.stats,
          "snapshot_cache": inc.snapshot_cache.stats,
          "mirror_check": mirror_check,
          "churn_padded_P": padded_p,
          "churn_kernel_ms": churn_kernel_ms,
          "churn_kernel_state": fck.last_launch["state"],
          "outcome_sha256": serial_sha, "jax_sha256_equal": True})
    return total_launches


def run_scheduler_mixed(device, n_nodes=MIXED_NODES, n_pods=MIXED_PODS):
    """The mixed cluster through the whole cycle on the card and in a CPU
    twin (the plain round): identical worlds after every cycle."""
    retries0 = retries_now()
    worlds = []
    for dev in (device, "cpu"):
        _c, state = mixed_cluster(101, n_nodes, n_pods)
        store = store_from_state(state)
        worlds.append((store, Scheduler(store, waves=1, device=dev)))
    now = state.now
    launches, walls = 0, {device: [], "cpu": []}
    for c in range(MIXED_CYCLES):
        if c:
            specs = arrival_specs(c, n_pods // 10)
            for store, _s in worlds:
                add_arrivals(store, specs, now + c)
        keys, dumps = [], []
        for store, sched in worlds:
            res, wall, n, _gc = checked_cycle(
                f"scheduler_mixed cycle {c}", sched, sched.run_cycle,
                now + 2 * c)
            launches += n if sched.device.type == "cuda" else 0
            walls[sched.device.type].append(wall)
            keys.append(result_key(res))
            dumps.append(cycle_dump(sched))
        if keys[0] != keys[1] or dumps[0] != dumps[1]:
            raise AssertionError(
                f"scheduler_mixed cycle {c}: the card's world differs from "
                "the plain round's")
        if worlds[1][1].last_backend != "serial":
            raise AssertionError("scheduler_mixed: the CPU twin did not run "
                                 "the plain round")
    assert_ladder_full("scheduler_mixed", retries0,
                       *(s for _st, s in worlds))
    pods = dumps[0]["pods"]
    emit({"phase": "scheduler_mixed", "nodes": n_nodes, "pods": n_pods,
          "cycles": MIXED_CYCLES, "dumps_identical_every_cycle": True,
          "ladder_full": True,
          "launches": launches,
          "cuda_cycle_seconds": walls[device], "cpu_cycle_seconds": walls["cpu"],
          "pods_bound": sum(1 for v in pods.values() if v[0]),
          "pods_unschedulable": sum(1 for v in pods.values()
                                    if v[2] is not None and v[2][0] == "False"),
          "messages": len({v[2][2] for v in pods.values()
                           if v[2] is not None and v[2][0] == "False"})})
    return launches


def wave_cycle(tag, sched, now):
    """One cycle of ``sched`` with the launch counts set to 0 just before
    it and read just after. On the card the cycle must have run its rounds
    in the full-chain kernel, and a fused dispatch (K > 1) its kept-only
    replays in the replay kernel, one of each per device wave. Returns
    (result, wall seconds, launches, the K the cycle resolved to)."""
    d0 = sched.dispatches
    fck.launches = fck.replay_launches = sk.launches = 0
    t0 = time.perf_counter()
    res = sched.run_cycle(now=now)
    wall = time.perf_counter() - t0
    launches = {"full_chain": fck.launches,
                "full_chain_replay": fck.replay_launches,
                "schedule_step": sk.launches}
    kspan = last_cycle_root(sched).find("kernel")
    k = int(kspan.attributes.get("waves", "1")) if kspan else 1
    if sched.device.type == "cuda" and (
            sched.last_backend != "cuda" or sched.dispatches - d0 < 1
            or sk.launches != 0 or fck.launches < fck.replay_launches
            or (k > 1 and fck.replay_launches < 1)
            or (k == 1 and fck.replay_launches != 0)):
        raise AssertionError(f"{tag}: K {k}, backend {sched.last_backend}, "
                             f"launches {launches}")
    return res, wall, launches, k


def wave_detail(sched) -> dict:
    """The last cycle's waves: the chained replay's per-logical-cycle
    spans (bound, the wave's device ms), its waits for later waves' rows,
    and the single-call twin's wave markers under the kernel span
    (bound)."""
    root = last_cycle_root(sched)
    kspan = root.find("kernel")
    return {
        "kernel_span_ms": kspan.duration_seconds * 1e3 if kspan else None,
        "wave_replay": [
            {"bound": int(sp.attributes["bound"]),
             "device_ms": (float(sp.attributes["device_ms"])
                           if "device_ms" in sp.attributes else None)}
            for sp in root.find_all("wave_replay")],
        "waves": [int(sp.attributes["bound"])
                  for sp in (kspan.find_all("wave") if kspan else [])],
        # the host's wait for a later wave's rows after replaying the one
        # before: near 0 where the card finished it during the replay
        "later_wave_wait_ms": [
            sp.duration_seconds * 1e3 for sp in root.find_all("overlap_wait")
            if "wave" in sp.attributes],
    }


def clone_fc(fc):
    return type(fc)(type(fc.base)(*(t.clone() for t in fc.base)),
                    *(t.clone() for t in fc[1:]))


def replay_bound(fc, n_kept: int, n_numa: int):
    """(bytes ms, operations ms) of one kept-only replay on these inputs:
    every pod's kept flag and chosen node, the kept pods' fields (fit
    requests, requests and estimates, three flags, cores, quota id, the
    match and anti bytes, the port bytes, one volume need), the node rows
    the commit reads (policy, volume group, aff_dom), the ancestors and
    the state read once, the state and the zones written once; per kept
    pod the commit's f32 operations (csrc/filter_chain.cuh commit_node
    and the quota cells): requested R, the LoadAware sums R, bindable cpus
    and volume headroom 2, the quota chain D x R, and for a pod with NUMA
    needs the zone fits K x R and the fill 3 x K x R."""
    P, R = fc.base.fit_requests.shape
    N = fc.base.allocatable.shape[0]
    K = fc.numa_free.shape[1]
    G, D = fc.quota_ancestors.shape
    T, PT = fc.aff_dom.shape[1], fc.port_used.shape[1]
    state = N * (3 * R + K * R + 2 + PT + 2 * T) + G * R + T
    pod = 3 * R * 4 + 3 + 4 + 4 + 2 * T + PT + 4
    nbytes = (P * 5 + n_kept * pod + N * (8 + 4 * T) + G * D * 4
              + 2 * state * 4 + P * 4)
    ops = n_kept * (2 * R + 2 + D * R) + n_numa * 4 * K * R
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3


def replay_mismatch(out_k, zones_k, out_p, zones_p):
    """(values that differ, max |err| over finite values) between a replay
    kernel's (state, zones) and the plain replay's."""
    mism = int((zones_k != zones_p).sum())
    err = 0.0
    for a, b in zip(out_k, out_p):
        if a.dtype == torch.bool:
            mism += int((a != b).sum())
            continue
        # bit for bit: equal values are not enough where a -0.0 hides, and
        # a node without a volume limit carries +inf headroom
        mism += int((a.view(torch.int32) != b.view(torch.int32)).sum())
        fin = torch.isfinite(a) & torch.isfinite(b)
        if fin.any():
            err = max(err, float((a[fin] - b[fin]).abs().max()))
    return mism, err


def check_replay_bound(device, seed=7, n_nodes=200, n_pods=400):
    """The replay kernel past the affinity counts' exact range, on
    mixed_cluster(seed, n_nodes, n_pods) (affinity and anti terms, which
    config 4 lacks): its kernel round's kept pods after Permit, replayed
    from its own state with every affinity count and anti cover planted
    at 2^24 - 1, so that each node whose domain gains two or more takes
    the kernel's one-by-one adds of 1.0; once on its active axes (R = 3,
    K = 2: the common-shape instance) and once on every axis (R = 14,
    K = 8: the generic instance). Each bit for bit against replay_kept,
    and the kernel must report REPLAY_ERR_BOUND (the branch ran). These
    launches compare and are not counted on the main path."""
    from koordinator_tpu_torch.parallel.full_chain_mesh import replay_state0

    args = LoadAwareArgs()
    _c, state = mixed_cluster(seed, n_nodes, n_pods)
    full, _p, _n, _t, _gi, ng, ngroups = build_full_chain_inputs(state, args)
    fc, active = reduce_to_active_axes(full)
    fc, full = to_device(fc, device), to_device(full, device)
    prod = args.score_according_prod_usage
    chosen = fck.full_chain_round(fc, resolve_weight_idx(args, active), prod,
                                  resolve_balance_idx(active))[0]
    kept = permit(fc, chosen, ng, ngroups) >= 0
    out = {"world": f"mixed_cluster({seed}, {n_nodes}, {n_pods})",
           "kept": int(kept.sum()), "terms": int(fc.aff_dom.shape[1])}
    for want, world in (("common", fc), ("generic", full)):
        st = list(replay_state0(world, prod))
        st[2] = torch.zeros_like(st[0])  # est_sum_prod outside prod mode
        for k in (6, 7):  # aff_count, anti_cover
            st[k] = torch.full_like(st[k], float(2**24 - 1))
        st = tuple(st)
        out_k, zones_k = fck.full_chain_replay(world, chosen, kept, st, prod)
        errors = fck.replay_errors()
        instance = fck.last_replay["instance"]
        out_p, zones_p = fused_waves.replay_kept(world, prod, st, chosen,
                                                 kept)
        mism, err = replay_mismatch(out_k, zones_k, out_p, zones_p)
        if (mism or err != 0.0 or not errors & fck.REPLAY_ERR_BOUND
                or instance != want):
            raise AssertionError(
                f"replay past 2^24 ({instance}, want {want}): {mism} values "
                f"differ (max |err| {err}), error bits {errors}")
        out[instance] = {"R": int(world.base.fit_requests.shape[1]),
                         "K": int(world.numa_free.shape[1]),
                         "errors": errors, "mismatches": mism}
    return out


def run_scheduler_waves(device):
    """Config 4 through Scheduler(store) with its defaults (auto waves,
    chained dispatch), against the single-call twin and the serial twin;
    then the replay kernel alone at cycle 0's kept set against the plain
    replay on the card. Returns (the default twin's launches, the replay
    instance's kernels-line entry, cycle 0's first-wave inputs with their
    active axes)."""
    arrivals = CONFIG4_PODS // 10
    retries0 = retries_now()
    t0 = time.perf_counter()
    (store_a, state), (store_b, _s2), (store_c, _s3) = (
        churn_store(CONFIG4_NODES, CONFIG4_PODS, seed=42) for _ in range(3))
    chained = Scheduler(store_a, device=device)
    fused = Scheduler(store_b, device=device, replay_overlap=False)
    serial = Scheduler(store_c, waves=1, device=device)
    if chained.waves_spec != "auto" or not chained.replay_overlap:
        raise AssertionError("scheduler_waves: the defaults are not auto "
                             "waves with replay overlap")
    fixture_s = time.perf_counter() - t0
    # the replay's inputs at cycle 0's first wave, for the timing below
    captured = {}
    real_replay = fck.full_chain_replay

    def spy(fc_carry, chosen, kept, state_, prod_mode, **kw):
        if not captured:
            captured["args"] = (
                clone_fc(fc_carry), chosen.clone(), kept.clone(),
                tuple(t.clone() for t in state_), prod_mode)
        return real_replay(fc_carry, chosen, kept, state_, prod_mode, **kw)

    real_build = fused_waves.build_chained_wave_step
    axes = {}

    def spy_build(*a, **kw):
        # the active axes of the chained step's batch, for waves_carried
        axes.setdefault("active", kw["active_axes"])
        return real_build(*a, **kw)

    now = state.now
    total = {"full_chain": 0, "full_chain_replay": 0}
    rows, walls = [], {"chained": [], "fused": [], "serial": []}
    splits = {"chained": [], "fused": []}
    cycle0 = {}
    outcome = []  # the default path's result keys, for scheduler_mesh
    fused_waves.build_chained_wave_step = spy_build
    for c, specs, created, t in churn_schedule(
            now, WAVE_CHURN_WARMUP + WAVE_CHURN_MEASURED, arrivals):
        for store in (store_a, store_b, store_c):
            add_arrivals(store, specs, created)
        fck.full_chain_replay = spy if c == 0 else real_replay
        try:
            res_a, wall_a, la, k_a = wave_cycle(
                f"scheduler_waves cycle {c} chained", chained, t)
        finally:
            fck.full_chain_replay = real_replay
        detail_a = wave_detail(chained)
        split_a = span_split(chained, WAVE_SPANS)
        res_b, wall_b, lb, k_b = wave_cycle(
            f"scheduler_waves cycle {c} fused", fused, t)
        detail_b = wave_detail(fused)
        split_b = span_split(fused, WAVE_SPANS)
        if (k_a, res_a.waves) != (k_b, res_b.waves):
            raise AssertionError(f"scheduler_waves cycle {c}: K/waves differ "
                                 f"({k_a}, {res_a.waves}) vs ({k_b}, "
                                 f"{res_b.waves})")
        keys = {"chained": result_key(res_a), "fused": result_key(res_b)}
        ser_key = ([], [], [])
        wall_c = 0.0
        for _w in range(res_a.waves):
            res_c, wall, _n, _gc = checked_cycle(
                f"scheduler_waves cycle {c} serial", serial,
                serial.run_cycle, t)
            wall_c += wall
            for part, got in zip(ser_key, result_key(res_c)):
                part.extend(got)
        keys["serial"] = ser_key
        if not (keys["chained"] == keys["fused"] == keys["serial"]):
            raise AssertionError(f"scheduler_waves cycle {c}: twins disagree")
        if not keys["chained"][0]:
            raise AssertionError(f"scheduler_waves cycle {c}: nothing bound")
        outcome.append(keys["chained"])
        for key in total:
            total[key] += la[key]
        rows.append({"cycle": c, "K": k_a, "logical_cycles": res_a.waves,
                     "device_waves": la["full_chain_replay"],
                     "bound": len(res_a.bound), "failed": len(res_a.failed),
                     "rejected": len(res_a.rejected),
                     "launches_chained": la, "launches_fused": lb,
                     "chained": detail_a, "fused": detail_b,
                     "chained_ms": wall_a * 1e3, "fused_ms": wall_b * 1e3,
                     "serial_ms": wall_c * 1e3,
                     "chained_kernel_seconds_ms": res_a.kernel_seconds * 1e3,
                     "fused_kernel_seconds_ms": res_b.kernel_seconds * 1e3})
        if c == 0:
            cycle0 = {"chained_spans_ms": split_a, "fused_spans_ms": split_b}
        elif c > WAVE_CHURN_WARMUP:
            walls["chained"].append(wall_a)
            walls["fused"].append(wall_b)
            walls["serial"].append(wall_c)
            splits["chained"].append(split_a)
            splits["fused"].append(split_b)
    fused_waves.build_chained_wave_step = real_build
    for sched in (chained, fused):
        sched.flush_deferred()
    dumps = [cycle_dump(s) for s in (chained, fused, serial)]
    if not (dumps[0] == dumps[1] == dumps[2]):
        raise AssertionError("scheduler_waves: the final dumps differ")
    waves_sha = outcome_sha(outcome, store_a)
    waves_each = tuple(r["logical_cycles"] for r in rows)
    if (waves_sha, waves_each) != (CONFIG4_WAVES_JAX_SHA256,
                                   CONFIG4_WAVES_JAX_WAVES):
        raise AssertionError(
            f"scheduler_waves: the outcome {waves_sha} with waves "
            f"{waves_each} is not the JAX package's "
            f"{CONFIG4_WAVES_JAX_SHA256} with {CONFIG4_WAVES_JAX_WAVES}")
    assert_ladder_full("scheduler_waves", retries0, chained, fused, serial)
    if rows[0]["K"] != 8 or any(r["K"] != 4 for r in rows[1:]):
        raise AssertionError(f"scheduler_waves: K per cycle "
                             f"{[r['K'] for r in rows]}, expected 8 then 4")

    # ---- the replay alone at cycle 0's first wave: the wrapper's call as
    # the wave body makes it, then the kernels' launch alone
    fc_c, chosen, kept, state0, prod = captured["args"]
    n_kept = int(kept.sum())
    n_numa = int((kept & fc_c.needs_numa).sum())
    most = int(torch.bincount(chosen[kept].long()).max()) if n_kept else 0

    def replay():
        return real_replay(fc_c, chosen, kept, state0, prod)

    replay_ms = time_cuda(replay, REPS)
    kernel_ms = launch_alone_ms(fck, "_replay_lib", "replay_launch", replay,
                                REPS)
    out_k, zones_k = replay()
    launch = {k: v for k, v in fck.last_replay.items() if k != "errors"}
    errors = fck.replay_errors()
    if errors:
        raise AssertionError(f"replay: error bits {errors} at config 4")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, zones_p = fused_waves.replay_kept(fc_c, prod, state0, chosen,
                                             kept)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    mism, err = replay_mismatch(out_k, zones_k, out_p, zones_p)
    if mism or err != 0.0:
        raise AssertionError(f"replay kernel disagrees with replay_kept "
                             f"({mism} values, max |err| {err})")
    planted = check_replay_bound(device)
    bytes_ms, ops_ms = replay_bound(fc_c, n_kept, n_numa)
    t_chained = statistics.median(walls["chained"])
    emit({"phase": "scheduler_waves", "nodes": CONFIG4_NODES,
          "pods": CONFIG4_PODS,
          "arrivals_per_cycle": arrivals,
          "warmup_cycles": WAVE_CHURN_WARMUP,
          "measured_cycles": WAVE_CHURN_MEASURED,
          "fixture_seconds": round(fixture_s, 3),
          "twins_identical_every_cycle": True, "final_dumps_identical": True,
          "ladder_full": True, "launches": total, "cycles": rows,
          "cycle_ms": t_chained * 1e3,
          "cycle_ms_each": [w * 1e3 for w in walls["chained"]],
          "fused_cycle_ms": statistics.median(walls["fused"]) * 1e3,
          "serial_round_ms": statistics.median(walls["serial"]) * 1e3,
          "pods_per_second": arrivals / t_chained,
          "spans_ms": median_split(splits["chained"]),
          "fused_spans_ms": median_split(splits["fused"]),
          "cycle0": cycle0,
          "replay": {"P": int(kept.shape[0]), "kept": n_kept,
                     "kept_numa": n_numa, "most_kept_on_a_node": most,
                     **launch, "wrapper_ms": replay_ms,
                     "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                     "mismatches": mism, "max_abs_err": err,
                     "errors": errors, "count_bound": planted,
                     "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms},
          "outcome_sha256": waves_sha, "waves_each_cycle": waves_each,
          "jax_sha256_equal": True})
    entry = kernel_entry(
        "replay_by_node", "replay_by_node.cu",
        "koordinator_tpu/models/fused_waves.py:559 (the rbody fori_loop, no "
        "TPU kernel)", total["full_chain_replay"], mism, err, replay_ms,
        plain_ms, bytes_ms, ops_ms, kernel_alone_ms=kernel_ms,
        most_kept_on_a_node=most)
    return total, entry, (fc_c, axes["active"]), waves_sha


def keep_shared_claims(state, keep):
    """Drop the claims of every pending pod past the first ``keep`` that
    shares a running pod's claim. At full size the mixed cluster's shared
    claims attach to more node groups than the volume-group budget holds,
    and the Scheduler (like the JAX one) demotes such a batch to serial
    dispatch (claim-entangled). Returns the count of pods left sharing."""
    running = {c for p in state.pods_by_key.values() if p.is_assigned
               for c in p.spec.pvc_names}
    kept = 0
    for pod in state.pending_pods:
        if pod.spec.pvc_names and running.intersection(pod.spec.pvc_names):
            if kept < keep:
                kept += 1
            else:
                pod.spec.pvc_names = []
    return kept


def run_scheduler_waves_mixed(device, n_nodes=MIXED_NODES,
                              n_pods=MIXED_PODS):
    """The mixed cluster with default waves on the card and in a CPU twin
    (the plain wave step): identical worlds after every cycle. The world as
    mixed_cluster builds it demotes to serial dispatch (checked here), so
    its shared claims are cut to 8 pods first."""
    retries0 = retries_now()
    _c, state = mixed_cluster(101, n_nodes, n_pods)
    untrimmed = Scheduler(store_from_state(state), device=device)
    res = untrimmed.run_cycle(now=state.now)
    if res.demotions != ["claim-entangled"] or res.waves != 1:
        raise AssertionError(f"scheduler_waves_mixed: the untrimmed world "
                             f"gave {res.demotions}, K {res.waves}")
    res0 = res
    worlds = []
    for dev in (device, "cpu"):
        _c, state = mixed_cluster(101, n_nodes, n_pods)
        sharing = keep_shared_claims(state, 8)
        store = store_from_state(state)
        worlds.append((store, Scheduler(store, device=dev)))
    now = state.now
    launches = {"full_chain": 0, "full_chain_replay": 0}
    ks, walls = [], {device: [], "cpu": []}
    for c in range(MIXED_CYCLES):
        if c:
            specs = arrival_specs(c, n_pods // 10)
            for store, _s in worlds:
                add_arrivals(store, specs, now + c)
        keys, dumps = [], []
        for store, sched in worlds:
            res, wall, n, k = wave_cycle(f"scheduler_waves_mixed cycle {c}",
                                         sched, now + 2 * c)
            if sched is worlds[0][1]:
                ks.append(k)
                for key in launches:
                    launches[key] += n[key]
            walls[sched.device.type].append(wall)
            keys.append(result_key(res) + ([res.waves],))
            dumps.append(cycle_dump(sched))
        if keys[0] != keys[1] or dumps[0] != dumps[1]:
            raise AssertionError(
                f"scheduler_waves_mixed cycle {c}: the card's world differs "
                "from the plain wave step's")
    if ks[0] < 2 or launches["full_chain_replay"] < 1:
        raise AssertionError(f"scheduler_waves_mixed: K {ks}, launches "
                             f"{launches}")
    assert_ladder_full("scheduler_waves_mixed", retries0, untrimmed,
                       *(s for _st, s in worlds))
    pods = dumps[0]["pods"]
    emit({"phase": "scheduler_waves_mixed", "nodes": n_nodes, "pods": n_pods,
          "cycles": MIXED_CYCLES, "K": ks,
          "dumps_identical_every_cycle": True,
          "ladder_full": True,
          "untrimmed_demotions": res0.demotions,
          "pods_sharing_claims": sharing, "launches": launches,
          "cuda_cycle_seconds": walls[device],
          "cpu_cycle_seconds": walls["cpu"],
          "pods_bound": sum(1 for v in pods.values() if v[0])})


def run_waves_carried(device, fc4):
    """The carried-state worlds on the card, each against its serial twin
    on one card; the shared memory of a config-4 launch whose records
    carry a claim world's [P, N] volume view; then the worlds again with
    the fused world on 2 exchanging virtual cards and kernel 1's exchange
    round at config 4 over the claim view built per card against the
    single-device round over the [P, N] view (testing/cross_card.py
    ``check_worlds``: the per-card reservation pre-passes, claim view and
    boundary and score passes; exchange launches and no single-device
    launch in the fused world's cycles, no node row gathered, bit for
    bit). No dispatch may retry. Returns the exchange route's
    launches."""
    fc4, active = fc4
    retries0 = retries_now()
    reports = []
    for feature in ("reservations", "claims", "prod", "transformer"):
        fck.launches = fck.replay_launches = 0
        report = pipeline_parity.run_carried_state_parity(feature,
                                                          device=device)
        report["launches"] = {"full_chain": fck.launches,
                              "full_chain_replay": fck.replay_launches}
        if (not report["ok"] or report["fused_engaged"] < 1
                or fck.replay_launches < 1):
            raise AssertionError(f"waves_carried {feature}: {report}")
        reports.append(report)
    P = fc4.base.fit_requests.shape[0]
    N = fc4.base.allocatable.shape[0]
    dev = fc4.vol_needed.device
    claims_fc = fc4._replace(
        vol_needed=torch.zeros((P, N), device=dev),
        node_vol_group=torch.arange(N, dtype=torch.int32, device=dev))
    assert_ladder_full("waves_carried", retries0)
    kind, _plan, smem = fck.state_for(claims_fc, (0, 1))
    if smem > SMEM_BUDGET_BYTES:
        raise AssertionError("waves_carried: a claim-world launch does not "
                             "fit a block")
    worlds = cross_card.check_worlds(
        mesh_round.exchanging_mesh(MESH_SHARDS, device), fc4,
        resolve_weight_idx(LoadAwareArgs(), active), False,
        resolve_balance_idx(active), device=device)
    xchg = collections.Counter()
    for world in cross_card.WORLDS:
        xchg.update(worlds[world]["launches"])
    assert_ladder_full("waves_carried on 2 exchanging virtual cards",
                       retries0)
    emit({"phase": "waves_carried", "reports": reports,
          "claims_full_size": {"P": int(P), "N": int(N), "VG": int(N),
                               "state": kind, "smem_bytes_per_block": smem,
                               "budget": SMEM_BUDGET_BYTES},
          "xchg": worlds, "launches_xchg": dict(xchg)})
    return dict(xchg)


def retries_now() -> dict:
    return {stage: scheduler_metrics.DISPATCH_RETRIES.get(stage=stage) or 0.0
            for stage in ("serial", "fused")}


def assert_ladder_full(tag, retries0, *scheds) -> None:
    """A phase that injects no fault: every scheduler ends at the full
    rung with no transitions, and no dispatch attempt was retried."""
    for sched in scheds:
        if sched.ladder.level != 0 or sched.ladder.transitions:
            raise AssertionError(f"{tag}: the ladder moved: "
                                 f"{sched.ladder.transitions}")
    if retries_now() != retries0:
        raise AssertionError(f"{tag}: dispatch retries moved from "
                             f"{retries0} to {retries_now()}")


def host_fallback_seconds(sched) -> float:
    """Seconds of the host-fallback passes in the scheduler's last cycle
    (the kernel spans with host_fallback="1")."""
    return sum(sp.duration_seconds
               for sp in last_cycle_root(sched).find_all("kernel")
               if sp.attributes.get("host_fallback") == "1")


def run_ladder(device, n_nodes=5000, n_pods=10000):
    """Config 4 through two Scheduler(store) twins at their defaults:
    (a) with LADDER_FAULTS attached through the three hooks, (b) with
    none. Through the retry-only faults (a) must equal (b) cycle by cycle;
    from the storm on, (a) walks full -> serial-waves -> host-fallback
    and back and is held to the store invariants instead. Returns the
    kernels' launches in both twins."""
    arrivals = n_pods // 10
    (store_a, state), (store_b, _s) = (
        churn_store(n_nodes, n_pods, seed=42) for _ in range(2))
    plan = FaultPlan(LADDER_FAULTS)
    faulted = Scheduler(store_a, device=device,
                        dispatch_deadline_ms=LADDER_DEADLINE_MS,
                        ladder=DegradationLadder(
                            promote_after=LADDER_PROMOTE_AFTER))
    twin = Scheduler(store_b, device=device)
    faulted.fault_injector = plan.dispatch_hook
    faulted.sync_delay_injector = plan.sync_delay_hook
    faulted.upload_fault_injector = plan.upload_hook
    retries0 = retries_now()
    overruns0 = (scheduler_metrics.DISPATCH_DEADLINE_OVERRUNS.get(
        path="fused") or 0.0)
    now = state.now
    total = {"full_chain": 0, "full_chain_replay": 0}
    rows, fallback_s = [], []
    for c in range(1 + LADDER_CYCLES):
        with_twin = c < LADDER_TWIN_CYCLES
        if c:
            specs = arrival_specs(c, arrivals)
            for store in (store_a, store_b) if with_twin else (store_a,):
                add_arrivals(store, specs, now + c)
        t = now + 2 * c
        plan.begin_cycle(c)
        r0 = retries_now()
        snap0 = faulted.device_snapshot
        puts0 = (snap0.stats["put"], twin.device_snapshot.stats["put"])
        res_a, wall_a, la, k_a = ladder_cycle(faulted, t)
        hf_s = host_fallback_seconds(faulted)
        res_b, wall_b, lb, k_b = (
            ladder_cycle(twin, t) if with_twin
            else (None, None, {"full_chain": 0, "full_chain_replay": 0},
                  None))
        level = faulted.ladder.level
        dr = {s: retries_now()[s] - r0[s] for s in r0}
        for key in total:
            total[key] += la[key] + lb[key]
        breaches = check_invariants(store_a, now=t)
        if breaches:
            raise AssertionError(f"ladder cycle {c}: {breaches[:3]}")
        if level != LADDER_LEVELS[c]:
            raise AssertionError(f"ladder cycle {c}: level {level}, "
                                 f"expected {LADDER_LEVELS[c]}")
        if with_twin and result_key(res_a) != result_key(res_b):
            raise AssertionError(f"ladder cycle {c}: (a) differs from (b) "
                                 "through a retry-only fault")
        expect = {1: {"fused": 1.0, "serial": 0.0},
                  2: {"fused": 1.0, "serial": 0.0},
                  3: {"fused": 1.0, "serial": 0.0},
                  4: {"fused": 2.0, "serial": 0.0},
                  5: {"fused": 0.0, "serial": 2.0}}.get(
                      c, {"fused": 0.0, "serial": 0.0})
        if dr != expect:
            raise AssertionError(f"ladder cycle {c}: retries {dr}, "
                                 f"expected {expect}")
        if c == 2 and not (snap0.stats["put"] - puts0[0]
                           > twin.device_snapshot.stats["put"] - puts0[1]):
            raise AssertionError("ladder: the OOM'd field was not rolled "
                                 "back to a full put")
        if c == 3 and faulted.device_snapshot is snap0:
            raise AssertionError("ladder: the deadline overrun kept the "
                                 "abandoned mirror")
        on_host = faulted.last_backend == "host-fallback"
        bound_pods = [store_a.get(KIND_POD, b.pod_key) for b in res_a.bound]
        if on_host and any(p is not None and (p.gang_name or p.quota_name)
                           for p in bound_pods):
            raise AssertionError(f"ladder cycle {c}: the host fallback "
                                 "bound a gang or quota pod")
        if on_host != (c in (5, 6, 7)):
            raise AssertionError(f"ladder cycle {c}: host fallback "
                                 f"{on_host}")
        if device == "cuda" and (
                (on_host and la["full_chain"] != 0)
                or (not on_host and la["full_chain"] < 1)
                or (c == 4 and la != {"full_chain": 1,
                                      "full_chain_replay": 0})
                or (c == LADDER_CYCLES and la["full_chain_replay"] < 1)):
            # cycle 4's pass re-runs serially after the fused window's
            # demotion; back at full, the fused dispatch replays again
            raise AssertionError(f"ladder cycle {c}: launches {la}")
        if not res_a.bound:
            raise AssertionError(f"ladder cycle {c}: nothing bound")
        if on_host:
            fallback_s.append(hf_s)
        rows.append({"cycle": c, "level": faulted.ladder.level_name,
                     "K": k_a, "twin_K": k_b, "waves": res_a.waves,
                     "ms": wall_a * 1e3,
                     "twin_ms": wall_b * 1e3 if with_twin else None,
                     "bound": len(res_a.bound),
                     "twin_bound": len(res_b.bound) if with_twin else None,
                     "retries": dr, "launches": la,
                     "host_fallback_s": hf_s})
    transitions = [(t["from"], t["to"]) for t in faulted.ladder.transitions]
    if transitions != LADDER_WALK:
        raise AssertionError(f"ladder: transitions {transitions}")
    if len(plan.injected) != sum(f.count for f in LADDER_FAULTS):
        raise AssertionError(f"ladder: faults fired {plan.injected}")
    overruns = (scheduler_metrics.DISPATCH_DEADLINE_OVERRUNS.get(
        path="fused") or 0.0) - overruns0
    if overruns != 1:
        raise AssertionError(f"ladder: {overruns} deadline overruns")
    assert_ladder_full("ladder twin (b)", retries_now(), twin)
    retries = {s: retries_now()[s] - retries0[s] for s in retries0}
    emit({"phase": "ladder", "nodes": n_nodes, "pods": n_pods,
          "arrivals_per_cycle": arrivals, "churn_cycles": LADDER_CYCLES,
          "promote_after": LADDER_PROMOTE_AFTER,
          "dispatch_deadline_ms": LADDER_DEADLINE_MS,
          "latency_delay_ms": LADDER_DELAY_MS,
          "faults": plan.injected,
          "transitions": faulted.ladder.transitions,
          "retries": retries, "deadline_overruns": overruns,
          "identical_through_retries": True,
          "invariant_breaches": 0, "cycles": rows,
          "host_fallback_seconds": fallback_s,
          "repromoted_cycle_ms": rows[-1]["ms"],
          "launches": total})
    return total


def ladder_cycle(sched, now):
    """One cycle with the launch counts set to 0 just before it and read
    just after. Returns (result, wall seconds, launches, K)."""
    fck.launches = fck.replay_launches = sk.launches = 0
    t0 = time.perf_counter()
    res = sched.run_cycle(now=now)
    wall = time.perf_counter() - t0
    if sk.launches:
        raise AssertionError("the LoadAware kernel ran in a scheduler cycle")
    kspan = last_cycle_root(sched).find("kernel")
    k = int(kspan.attributes.get("waves", "1")) if kspan else 1
    return (res, wall, {"full_chain": fck.launches,
                        "full_chain_replay": fck.replay_launches}, k)


def run_sim(device):
    """The sim's scenarios on the card and on the CPU in this process: the
    CPU run's binding log (SHA-256) must equal the card run's over the
    cycles both ran, with zero invariant breaches and no cycle exception
    on either, smoke's ladder round trip in cycles_at_level, and in every
    scenario that injects no fault the card's ladder at full in every
    cycle with no dispatch retry. Returns the kernels' launches on the
    card."""
    rows = []
    total = {"full_chain": 0, "full_chain_replay": 0}
    for name, cycles, cpu_cycles in SIM_SCENARIOS:
        retries0 = retries_now()
        fck.launches = fck.replay_launches = sk.launches = 0
        t0 = time.perf_counter()
        card = run_scenario(SCENARIOS[name].resolved(cycles=cycles),
                            device=device)
        card_s = time.perf_counter() - t0
        if not SCENARIOS[name].faults and (
                card.cycles_at_level != {"full": cycles}
                or card.ladder_transitions or retries_now() != retries0):
            raise AssertionError(
                f"sim {name}: the ladder moved with no fault injected: "
                f"{card.cycles_at_level} {card.ladder_transitions} "
                f"retries {retries0} -> {retries_now()}")
        launches = {"full_chain": fck.launches,
                    "full_chain_replay": fck.replay_launches}
        t0 = time.perf_counter()
        cpu = run_scenario(SCENARIOS[name].resolved(cycles=cpu_cycles),
                           device="cpu")
        cpu_s = time.perf_counter() - t0
        for key in total:
            total[key] += launches[key]
        # the binding log's lines start with their cycle
        prefix = [line for line in card.binding_log
                  if int(line.split("\t", 1)[0]) < cpu_cycles]
        if prefix != cpu.binding_log:
            first = next((i for i, (a, b) in enumerate(
                zip(prefix, cpu.binding_log)) if a != b),
                min(len(prefix), len(cpu.binding_log)))
            raise AssertionError(
                f"sim {name}: the card's binding log differs from the "
                f"CPU's at line {first}: "
                f"{prefix[first:first + 1]} != "
                f"{cpu.binding_log[first:first + 1]}")
        for where, rep in (("card", card), ("cpu", cpu)):
            if rep.invariant_breaches or rep.cycle_exceptions:
                raise AssertionError(
                    f"sim {name} on the {where}: "
                    f"{rep.invariant_breaches[:3]} "
                    f"{rep.cycle_exceptions[:3]}")
        if cpu_cycles == cycles and (
                card.cycles_at_level != cpu.cycles_at_level
                or card.ladder_transitions != cpu.ladder_transitions):
            raise AssertionError(f"sim {name}: the ladders differ")
        if device == "cuda" and launches["full_chain"] < 1:
            raise AssertionError(f"sim {name}: no kernel launch on the card")
        if name == "smoke" and (
                set(card.cycles_at_level) != {"full", "host-fallback"}
                or card.final_level != "full"):
            raise AssertionError(f"sim smoke: no ladder round trip: "
                                 f"{card.cycles_at_level}")
        report = card.to_dict()
        if SCENARIOS[name].descheduler_every:
            # the co-located descheduler: every rebalance pass on the
            # card, none retried or served by the host oracle
            passes = card.rebalance_passes
            if (card.descheduler_runs < 1
                    or passes["device"] != card.descheduler_runs
                    or passes["host"] or passes["failures"]):
                raise AssertionError(
                    f"sim {name}: rebalance passes {passes} over "
                    f"{card.descheduler_runs} descheduler runs")
            if cpu_cycles == cycles and (
                    report["rebalance"] != cpu.to_dict()["rebalance"]):
                raise AssertionError(
                    f"sim {name}: the rebalance report differs: "
                    f"{report['rebalance']} != {cpu.to_dict()['rebalance']}")
        if SCENARIOS[name].colo_every:
            # the co-located manager: every round a device colo pass, the
            # staleness SLO met, the report equal on the CPU
            colo = report["colo"]
            if (colo["manager_rounds"] != cycles
                    or colo["device_passes"] != cycles
                    or colo["host_passes"] or not colo["staleness_slo_met"]
                    or colo != cpu.to_dict()["colo"]):
                raise AssertionError(f"sim {name}: colo {colo}")
            if card.binding_log_sha256 != OVERCOMMIT_SHIFT_JAX_SHA256:
                raise AssertionError(
                    f"sim {name}: {card.binding_log_sha256} is not the JAX "
                    f"package's {OVERCOMMIT_SHIFT_JAX_SHA256}")
        rows.append({
            "scenario": name, "cycles": cycles, "cpu_cycles": cpu_cycles,
            "sha256": card.binding_log_sha256[:16],
            "cpu_sha256": cpu.binding_log_sha256[:16],
            "bindings": len(card.binding_log),
            "cycles_at_level": card.cycles_at_level,
            "transitions": [(t["from"], t["to"])
                            for t in card.ladder_transitions],
            "slo_met": {"ttb_p99": report["slo"]["met"],
                        "restart": report["restart"]["met"],
                        **{k: v["met"] for k, v in report["slos"].items()}},
            "ttb_p99_seconds": report["time_to_bind_seconds"]["p99"],
            "descheduler_runs": card.descheduler_runs,
            "rebalance_passes": card.rebalance_passes,
            "rebalance": report["rebalance"],
            "colo": report["colo"] if SCENARIOS[name].colo_every else None,
            "card_seconds": card_s, "cpu_seconds": cpu_s,
            "card_ms_per_cycle": card_s / cycles * 1e3,
            "cpu_ms_per_cycle": cpu_s / cpu_cycles * 1e3,
            "launches": launches})
    with open("COLO_r01.json") as f:
        colo_r01 = json.load(f)
    emit({"phase": "sim", "scenarios": rows, "sha_equal": True,
          "invariant_breaches": 0,
          "overcommit_shift_jax_sha256": OVERCOMMIT_SHIFT_JAX_SHA256,
          "colo_r01": {"binding_log_sha256": colo_r01["binding_log_sha256"],
                       "batch_pods_bound":
                           colo_r01["colo_device"]["batch_pods_bound"],
                       "overcommit_shifts":
                           colo_r01["colo_device"]["overcommit_shifts"]},
          "cut": "gang-storm runs 60 of its 300 catalog cycles on the "
                 "card (40 on the CPU), spot-churn 40 of 300 (30), "
                 "drain-storm 40 of 200, hotspot and overcommit-shift 80 "
                 "of 160 (time limit)"})
    return total


def step_args(fields, device):
    """The rebalance step's arguments from the rebalancer's prepped host
    arrays, on ``device``, in call order."""
    from koordinator_tpu_torch.models.convert import as_tensor

    return [as_tensor(fields[f"rb_{name}"], device) for name in (
        "usage_pct", "has_metric", "low_thr", "high_thr", "rhs_hi",
        "rhs_lo", "pod_node", "pod_prio", "pod_cpu", "pod_req", "pod_ok")]


def rebalance_bytes(args, out) -> int:
    """The step's input bytes read once and its outputs written once."""
    return (sum(t.numel() * t.element_size() for t in args)
            + sum(t.numel() * t.element_size() for t in out))


def profile_launches(fn) -> dict:
    """One call of ``fn`` under torch.profiler: the device kernels and
    memory operations it ran (CUPTI), and the CUDA runtime launch calls
    on the host side, which count even where the device trace is empty."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    mem = [e for e in device if e.name.startswith(("Memcpy", "Memset"))]
    calls = [e for e in prof.events()
             if e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    by_name = {}
    for e in device:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"device_kernels": len(device) - len(mem),
            "device_memops": len(mem), "cuda_launch_calls": len(calls),
            "device_ms": sum(ms for ms, _n in by_name.values()),
            "top_kernels": [{"name": name[:120], "ms": ms, "count": n}
                            for name, (ms, n) in top]}


def job_list(store):
    """The PodMigrationJobs in store order, by what they migrate."""
    from koordinator_tpu_torch.client.store import KIND_POD_MIGRATION_JOB

    return [(j.meta.key, j.pod_namespace, j.pod_name, j.mode)
            for j in store.list(KIND_POD_MIGRATION_JOB)]


def run_rebalance(device, n_pods=50_000, n_nodes=5_000):
    """BASELINE config 5 through the standalone Descheduler on the card: a
    warm-up pass, 10 passes of the host oracle and 10 device passes over
    one packed view (victims equal to the host's, order included, and
    is_low/is_high equal to classify_nodes), the step alone (CUDA events,
    median of 10) and its launches (torch.profiler, once), then
    Descheduler.run_once against a rebalance="host" twin on an identical
    store: the PodMigrationJob lists must be equal, order included."""
    from koordinator_tpu_torch.balance.rebalancer import DeviceRebalancer
    from koordinator_tpu_torch.balance.step import build_rebalance_step
    from koordinator_tpu_torch.descheduler.descheduler import Descheduler
    from koordinator_tpu_torch.descheduler.lownodeload import classify_nodes
    from koordinator_tpu_torch.testing.rebalance_fixture import (
        rebalance_store,
    )

    now = 1_000_000.0
    t0 = time.perf_counter()
    store = rebalance_store(n_pods, n_nodes, now)
    fixture_s = time.perf_counter() - t0
    desch = Descheduler(store, device=device, rebalance="on")
    plugin = desch.profiles[0].balance_plugins[0].inner
    reb = desch.rebalancer
    if plugin.device is not reb or reb.device != torch.device(device):
        raise AssertionError("rebalance: the device pass is not attached")
    t0 = time.perf_counter()
    plugin.select_victims(now=now)  # warm-up: the first device pass
    warm_s = time.perf_counter() - t0
    if plugin.last_pass_stats["engine"] != "device":
        raise AssertionError(f"rebalance warm-up served "
                             f"{plugin.last_pass_stats['engine']}")
    t0 = time.perf_counter()
    view, pods_src = plugin._view(now)
    view_s = time.perf_counter() - t0
    low = plugin._thr_vec(plugin.args.low_thresholds)
    high = plugin._thr_vec(plugin.args.high_thresholds)
    host_ms, device_ms = [], []
    for _ in range(REPS):
        t0 = time.perf_counter()
        host = plugin.select_victims_host(view)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    is_low_h, is_high_h = classify_nodes(view["usage_pct"],
                                         view["has_metric"], low, high)
    reb.tracer.clear()
    for i in range(REPS):
        t0 = time.perf_counter()
        picked, stats = reb.select_victims(plugin, view, now)
        device_ms.append((time.perf_counter() - t0) * 1e3)
        if stats["engine"] != "device":
            raise AssertionError(f"rebalance pass {i} served "
                                 f"{stats['engine']}")
        if picked.tolist() != host.tolist():
            raise AssertionError(
                f"rebalance pass {i}: {picked.size} device victims against "
                f"{host.size} host victims, or another order")
        if not (np.array_equal(stats["is_low"], is_low_h)
                and np.array_equal(stats["is_high"], is_high_h)):
            raise AssertionError(f"rebalance pass {i}: classification "
                                 f"differs from classify_nodes")
    spans = {}
    for root in reb.tracer.roots():
        spans.setdefault(root.name, []).append(root.duration_seconds * 1e3)
    t0 = time.perf_counter()
    for _ in range(REPS):
        DeviceRebalancer._device_eligible(view)
    eligible_ms = (time.perf_counter() - t0) * 1e3 / REPS
    # the step alone, on the same prepped arrays
    fields = DeviceRebalancer._prep(view, low, high)
    args = step_args(fields, device)
    step = build_rebalance_step(plugin.args.max_pods_to_evict_per_node,
                                device=device)
    out = step(*args)
    torch.cuda.synchronize()
    n = view["alloc"].shape[0]
    sel = int(out.sel_count.item())
    if out.sel_pod[:sel].cpu().numpy().tolist() != host.tolist():
        raise AssertionError("rebalance step alone: victims differ")
    step_ms = time_cuda(lambda: step(*args), REPS)
    launches = profile_launches(lambda: step(*args))
    nbytes = rebalance_bytes(args, out)
    # the compiled serial floor on the same store, before run_once moves it
    run_lownodeload_floor(store, plugin, pods_src, host, now, host_ms,
                          device_ms)
    # the descheduler end to end against its host twin
    twin_store = rebalance_store(n_pods, n_nodes, now)
    twin = Descheduler(twin_store, rebalance="host")
    t0 = time.perf_counter()
    out_dev = desch.run_once(now=now)
    run_once_s = time.perf_counter() - t0
    if plugin.last_pass_stats["engine"] != "device":
        raise AssertionError("rebalance run_once did not run on the card")
    t0 = time.perf_counter()
    out_host = twin.run_once(now=now)
    twin_s = time.perf_counter() - t0
    jobs, twin_jobs = job_list(store), job_list(twin_store)
    if jobs != twin_jobs or out_dev != out_host:
        raise AssertionError(
            f"rebalance run_once: {len(jobs)} jobs on the card against "
            f"{len(twin_jobs)} on the host twin, or another order")
    if reb.ladder.level != 0 or reb.ladder.transitions or reb.failures:
        raise AssertionError(f"rebalance: the ladder moved: "
                             f"{reb.ladder.transitions}")
    row = {"phase": "rebalance", "pods": n_pods, "nodes": n_nodes,
           "P": int(fields["rb_pod_node"].shape[0]), "N": int(
               fields["rb_usage_pct"].shape[0]),
           "R": int(fields["rb_usage_pct"].shape[1]),
           "fixture_seconds": fixture_s, "warm_pass_seconds": warm_s,
           "view_seconds": view_s,
           "candidates": int(stats["candidates"]), "victims": int(sel),
           "low_nodes": int(is_low_h[:n].sum()),
           "high_nodes": int(is_high_h[:n].sum()),
           "host_pass_ms": host_ms, "host_pass_ms_median":
               statistics.median(host_ms),
           "device_pass_ms": device_ms, "device_pass_ms_median":
               statistics.median(device_ms),
           "device_pass_spans_ms_median": {
               k: statistics.median(v) for k, v in spans.items()},
           "device_eligible_ms": eligible_ms,
           "step_ms": step_ms, "step_launches": launches,
           "step_bytes": nbytes,
           "step_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "run_once_seconds": run_once_s,
           "run_once_host_twin_seconds": twin_s,
           "jobs_created": out_dev["jobs_created"],
           "migration_transitions": out_dev["migration_transitions"],
           "jobs_equal": True, "engine": "device", "ladder_full": True}
    emit(row)
    return row


def run_rebalance_colocated(device, n_nodes=5000, n_pods=10000):
    """Config 4 with the descheduler co-located: Scheduler(store) through
    cycle 0, then a Descheduler sharing its snapshot. The rb_* fields
    ride the scheduler's DeviceSnapshot, the pass runs on the card with
    the host oracle's victims over the same view, run_once runs on the
    card, and the scheduler's ladder stays at full. Returns kernel 1's
    launches in cycle 0."""
    from koordinator_tpu_torch.descheduler.descheduler import Descheduler

    retries0 = retries_now()
    store, state = churn_store(n_nodes, n_pods, seed=42)
    sched = Scheduler(store, device=device)
    fck.launches = fck.replay_launches = sk.launches = 0
    t0 = time.perf_counter()
    res = sched.run_cycle(now=state.now)
    cycle0_s = time.perf_counter() - t0
    launches = fck.launches
    if device == "cuda" and launches < 1:
        raise AssertionError("rebalance_colocated: cycle 0 ran no kernel")
    desch = Descheduler(store, scheduler=sched)
    plugin = desch.profiles[0].balance_plugins[0].inner
    if plugin.pack_cache is not sched.snapshot_cache.rebalance_pack(
            plugin.args.node_metric_expiration_seconds):
        raise AssertionError("rebalance_colocated: the pack is not shared")
    now = state.now + 1.0
    t0 = time.perf_counter()
    picked, _src, view = plugin.select_victims(now=now)
    pass_s = time.perf_counter() - t0
    stats = dict(plugin.last_pass_stats)
    host = plugin.select_victims_host(view)
    rb = sorted(k for k in sched.device_snapshot._fields
                if k.startswith("rb_"))
    if len(rb) != 11:
        raise AssertionError(f"rebalance_colocated: rb fields {rb}")
    if stats["engine"] != "device" or picked.tolist() != host.tolist():
        raise AssertionError(
            f"rebalance_colocated: engine {stats['engine']}, "
            f"{picked.size} victims against {host.size} on the host")
    t0 = time.perf_counter()
    out = desch.run_once(now=now)
    run_once_s = time.perf_counter() - t0
    if plugin.last_pass_stats["engine"] != "device":
        raise AssertionError("rebalance_colocated: run_once left the card")
    if out["jobs_created"] != picked.size:
        raise AssertionError(f"rebalance_colocated: {out['jobs_created']} "
                             f"jobs for {picked.size} victims")
    assert_ladder_full("rebalance_colocated", retries0, sched)
    if desch.rebalancer.ladder.transitions or desch.rebalancer.failures:
        raise AssertionError("rebalance_colocated: the rebalancer's "
                             "ladder moved")
    emit({"phase": "rebalance_colocated", "nodes": n_nodes, "pods": n_pods,
          "cycle0_seconds": cycle0_s, "cycle0_bound": len(res.bound),
          "full_chain_launches": launches,
          "rb_fields": rb, "candidates": int(stats["candidates"]),
          "victims": int(picked.size), "pass_seconds": pass_s,
          "run_once_seconds": run_once_s,
          "jobs_created": out["jobs_created"], "engine": "device",
          "ladder_full": True})
    return launches


# ---------------------------------------------------------------------------
# koord-manager: the colo pass
# ---------------------------------------------------------------------------

def colo_store(n_nodes=5000, n_pods=10000, quotas=False):
    """Config 4's nodes, pods and NodeMetrics as churn_store(5000, 10000,
    seed=42) builds them, its ElasticQuotas left out unless ``quotas``,
    and every COLO_STALE_EVERY-th NodeMetric stale (the degrade window is
    15 minutes)."""
    from koordinator_tpu_torch.client.store import (
        KIND_ELASTIC_QUOTA,
        KIND_NODE_METRIC,
    )

    store, state = churn_store(n_nodes, n_pods, seed=42)
    if not quotas:
        for q in store.list(KIND_ELASTIC_QUOTA):
            store.delete(KIND_ELASTIC_QUOTA, q.meta.key)
    for i, nm in enumerate(store.list(KIND_NODE_METRIC)):
        if i % COLO_STALE_EVERY == 0:
            nm.update_time = state.now - 10_000.0
            store.update(KIND_NODE_METRIC, nm)
    return store, state


def shift_metrics(store, k, now) -> None:
    """Tick k's metric churn: 50 fresh NodeMetrics get a new usage (the
    stale ones stay stale), identical in every world it is applied to."""
    from koordinator_tpu_torch.api.objects import NodeMetricInfo
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.client.store import KIND_NODE_METRIC

    metrics = store.list(KIND_NODE_METRIC)
    for j in range(50):
        i = (k * 50 + j) * 7 % len(metrics)
        nm = metrics[i]
        if i % COLO_STALE_EVERY == 0:
            continue
        nm.node_metric = NodeMetricInfo(node_usage=ResourceList.of(
            cpu=4000 + 1000 * ((i + k) % 24),
            memory=(16 + 8 * ((i + k) % 16)) * 1024 ** 3))
        nm.update_time = now
        store.update(KIND_NODE_METRIC, nm)


def set_policy(store, policy) -> None:
    """Hot-reload the slo-controller-config ConfigMap's calculate
    policies (created on first use)."""
    from koordinator_tpu_torch.api.objects import ConfigMap, ObjectMeta
    from koordinator_tpu_torch.client.store import KIND_CONFIG_MAP

    data = {"colocation-config": json.dumps({
        "enable": True, "cpuCalculatePolicy": policy,
        "memoryCalculatePolicy": policy})}
    cm = store.get(KIND_CONFIG_MAP, "koordinator-system/slo-controller-config")
    if cm is None:
        store.add(KIND_CONFIG_MAP, ConfigMap(
            meta=ObjectMeta(name="slo-controller-config",
                            namespace="koordinator-system"), data=data))
    else:
        cm.data = data
        store.update(KIND_CONFIG_MAP, cm)


OVERCOMMIT = (ResourceName.BATCH_CPU, ResourceName.BATCH_MEMORY,
              ResourceName.MID_CPU, ResourceName.MID_MEMORY)


def overcommit_rows(store):
    """Every node's published batch/mid integers, in store order."""
    from koordinator_tpu_torch.client.store import KIND_NODE

    return [(n.meta.name, tuple(n.allocatable[a] for a in OVERCOMMIT))
            for n in store.list(KIND_NODE)]


def colo_roots(mgr):
    """The manager's colo pass roots: (ms, {child span: ms})."""
    out = []
    for root in mgr.tracer.roots():
        if root.name == "colo":
            out.append((root.duration_seconds * 1e3,
                        {c.name: c.duration_seconds * 1e3
                         for c in root.children}))
    return out


def checked_colo_tick(tag, mgr, twin, now):
    """Tick the card's manager and its host twin; the pass must run on
    the card, and the batch/mid integers and the degraded set must equal
    the twin's."""
    if not (mgr.tick(now=now) and twin.tick(now=now)):
        raise AssertionError(f"{tag}: a manager did not lead")
    stats = mgr.colo.last_pass_stats
    if stats.get("engine") != "device":
        raise AssertionError(f"{tag}: engine {stats.get('engine')}")
    if overcommit_rows(mgr.store) != overcommit_rows(twin.store):
        raise AssertionError(f"{tag}: batch/mid differ from the host twin")
    if not np.array_equal(stats["degraded"],
                          twin.colo.last_pass_stats["degraded"]):
        raise AssertionError(f"{tag}: the degraded sets differ")
    return stats


def colo_step_args(mgr, now, device):
    """The step's arguments from the reconciler's own prep of the current
    view, on ``device``, with the host's water-filling plan."""
    from koordinator_tpu_torch.colo.reconciler import DeviceColoReconciler
    from koordinator_tpu_torch.colo.step import STEP_FIELDS
    from koordinator_tpu_torch.models.convert import as_tensor

    view = mgr.colo.pack.view(now)
    qv = mgr.colo.pack.quota_view(mgr.colo.quota_plugin)
    fields, plan = DeviceColoReconciler._prep(view, qv)
    args = [as_tensor(fields[f"colo_{name}"], device)
            for name in STEP_FIELDS]
    return view, args, plan


def colo_step_check(tag, view, args, plan, device, compare_total):
    """The step alone on the card against the same step on the CPU (the
    plain version), bit for bit; its time (CUDA events, median of REPS),
    launches (torch.profiler, once), bytes and bytes bound."""
    from koordinator_tpu_torch.colo.step import build_colo_step

    policies = (view["cpu_policy"], view["memory_policy"])
    step = build_colo_step(*policies, device=device)
    plain = build_colo_step(*policies, device="cpu")
    cpu_args = [t.cpu() for t in args]
    out = step(*args, plan=plan)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain(*cpu_args, plan=plan)
    plain_ms = (time.perf_counter() - t0) * 1e3
    fields = [f for f in ref._fields
              if compare_total or f != "predicted_total"]
    err = 0.0
    for f in fields:
        a, b = getattr(out, f).cpu(), getattr(ref, f)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{tag}: step field {f} differs from "
                                 f"the plain step on the CPU")
        if a.dtype.is_floating_point:
            err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
    step_ms = time_cuda(lambda: step(*args, plan=plan), REPS)
    launches = profile_launches(lambda: step(*args, plan=plan))
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + sum(t.numel() * t.element_size() for t in out))
    return {"step_ms": step_ms, "plain_ms": plain_ms,
            "step_launches": launches, "step_bytes": nbytes,
            "step_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": err, "compared_fields": fields}


def run_colo(device, n_nodes=5000, n_pods=10000):
    """Config 4's nodes, pods and NodeMetrics without ElasticQuotas through
    the standalone Manager(store, device="cuda"): 2 warm-up and COLO_TICKS
    timed ticks with metric churn, then one tick under each calculate policy
    after a ConfigMap hot reload, each against a Manager(colo="host")
    twin on an identical store; then the step alone."""
    from koordinator_tpu_torch.manager import Manager

    t0 = time.perf_counter()
    store, state = colo_store(n_nodes, n_pods)
    twin_store, _ = colo_store(n_nodes, n_pods)
    fixture_s = time.perf_counter() - t0
    mgr = Manager(store, identity="colo-card", device=device)
    twin = Manager(twin_store, identity="colo-host", colo="host",
                   device=device)
    if mgr.colo.device != torch.device(device):
        raise AssertionError("colo: the pass is not on the card")
    now = state.now
    tick_ms = []
    for k in range(COLO_WARMUP + COLO_TICKS):
        now += 10.0
        for s in (store, twin_store):
            shift_metrics(s, k, now)
        if k == COLO_WARMUP:
            mgr.tracer.clear()
            twin.tracer.clear()
        t0 = time.perf_counter()
        stats = checked_colo_tick(f"colo tick {k}", mgr, twin, now)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    passes, twin_passes = colo_roots(mgr), colo_roots(twin)
    device_ms = [ms for ms, _ in passes]
    host_ms = [ms for ms, _ in twin_passes]
    spans = {name: statistics.median(c.get(name, 0.0) for _, c in passes)
             for name in ("pack", "encode", "kernel", "readback",
                          "writeback")}
    degraded = int(np.count_nonzero(stats["degraded"]))
    policy_rows = []
    for policy in ("usage", "request", "maxUsageRequest"):
        now += 10.0
        for s in (store, twin_store):
            set_policy(s, policy)
        mgr.tracer.clear()
        twin.tracer.clear()
        checked_colo_tick(f"colo policy {policy}", mgr, twin, now)
        if mgr.colo.pack.view(now)["cpu_policy"] != policy:
            raise AssertionError(f"colo: the {policy} reload did not land")
        policy_rows.append({
            "policy": policy, "pass_ms": colo_roots(mgr)[-1][0],
            "host_pass_ms": colo_roots(twin)[-1][0],
            "batch_cpu_total": int(sum(r[1][0] for r in
                                       overcommit_rows(store)))})
    view, args, plan = colo_step_args(mgr, now, device)
    step = colo_step_check("colo", view, args, plan, device,
                           compare_total=False)
    if mgr.colo.ladder.level != 0 or mgr.colo.failures or (
            mgr.colo.stats["host_passes"]):
        raise AssertionError("colo: the ladder moved")
    row = {"phase": "colo", "nodes": n_nodes, "pods": n_pods,
           "N": int(args[0].shape[0]), "R": int(args[0].shape[1]),
           "G": int(args[12].shape[0]), "plan": list(plan),
           "fixture_seconds": fixture_s,
           "degraded_nodes": degraded,
           "device_pass_ms": device_ms,
           "device_pass_ms_median": statistics.median(device_ms),
           "device_pass_ms_range": [min(device_ms), max(device_ms)],
           "device_pass_spans_ms_median": spans,
           "host_pass_ms": host_ms,
           "host_pass_ms_median": statistics.median(host_ms),
           "tick_ms_with_twin": tick_ms[COLO_WARMUP:],
           "policies": policy_rows, **step,
           "device_passes": mgr.colo.stats["device_passes"],
           "engine": "device", "batch_mid_equal": True,
           "degraded_equal": True, "ladder_full": True}
    emit(row)
    return row


def quota_world(n_nodes=None):
    """Config 4's store with its quota tree (root, teams and jobs), the
    root given a shared weight (a lone root's weight changes no runtime,
    but its default, its max of 10^9 cores and 2^60 bytes, puts every
    per-parent weight sum out of the envelope), cut to the first
    ``n_nodes`` nodes (their NodeMetrics and running pods kept)."""
    from koordinator_tpu_torch.api.objects import LABEL_QUOTA_SHARED_WEIGHT
    from koordinator_tpu_torch.client.store import (
        KIND_ELASTIC_QUOTA,
        KIND_NODE,
        KIND_NODE_METRIC,
    )

    store, state = colo_store(quotas=True)
    root = next(q for q in store.list(KIND_ELASTIC_QUOTA)
                if q.meta.name == "root")
    root.meta.annotations[LABEL_QUOTA_SHARED_WEIGHT] = json.dumps(
        {"cpu": "1", "memory": "1Gi"})
    store.update(KIND_ELASTIC_QUOTA, root)
    if n_nodes is not None:
        nodes = store.list(KIND_NODE)
        keep = {n.meta.name for n in nodes[:n_nodes]}
        for n in nodes[n_nodes:]:
            store.delete(KIND_NODE, n.meta.key)
        for nm in store.list(KIND_NODE_METRIC):
            if nm.meta.name not in keep:
                store.delete(KIND_NODE_METRIC, nm.meta.key)
        for p in store.list(KIND_POD):
            if p.spec.node_name and p.spec.node_name not in keep:
                store.delete(KIND_POD, p.meta.key)
    return store, state


def envelope_nodes(device):
    """The unmodified config 4 churn store's verdict, then the largest
    node count (a prefix of config 4's nodes) whose cluster total keeps
    the port's _device_eligible at None for config 4's tree."""
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.client.store import KIND_NODE
    from koordinator_tpu_torch.colo.reconciler import DeviceColoReconciler
    from koordinator_tpu_torch.manager import Manager

    eligible = DeviceColoReconciler._device_eligible
    store, _state = churn_store(5000, 10000, seed=42)
    mgr = Manager(store, identity="colo-env", device=device)
    qv = mgr.colo.pack.quota_view(mgr.colo.quota_plugin)
    verdicts = {"config4_churn_store": eligible(qv)}
    store, _state = quota_world()
    mgr = Manager(store, identity="colo-env", device=device)
    qv = mgr.colo.pack.quota_view(mgr.colo.quota_plugin)
    verdicts["config4_root_weighted"] = eligible(qv)
    total, n = ResourceList(), 0
    for node in store.list(KIND_NODE):
        grown = total.add(node.allocatable)
        verdict = eligible(dict(qv, q_total=grown.to_vector()))
        if verdict is not None:
            verdicts[f"prefix_{n + 1}"] = verdict
            break
        total, n = grown, n + 1
    return n, total.to_vector(), verdicts


def quota_churn(store, k, now, n_nodes) -> None:
    """Tick k's quota churn: a running member pod added to a job quota,
    and that job's min and max shrunk under its use (the revoke path)."""
    from koordinator_tpu_torch.api.objects import (
        LABEL_QUOTA_NAME,
        ObjectMeta,
        Pod,
        PodSpec,
    )
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.client.store import (
        KIND_ELASTIC_QUOTA,
        KIND_NODE,
    )

    node = store.list(KIND_NODE)[k % n_nodes].meta.name
    store.add(KIND_POD, Pod(
        meta=ObjectMeta(name=f"colo-q-{k}", namespace="colo",
                        uid=f"colo-q-{k}", creation_timestamp=now,
                        labels={LABEL_QUOTA_NAME: f"job-{k % 7}"},
                        owner_kind="ReplicaSet", owner_name=f"rs-{k % 3}"),
        spec=PodSpec(node_name=node, priority=5500,
                     requests=ResourceList.of(cpu=4000, memory=8 * 1024 ** 3)),
        phase="Running"))
    q = next(q for q in store.list(KIND_ELASTIC_QUOTA)
             if q.meta.name == f"job-{k % 7}")
    q.min = ResourceList.of(cpu=1000, memory=1024 ** 3)
    q.max = ResourceList.of(cpu=2000 + 1000 * k, memory=(4 + k) * 1024 ** 3)
    store.update(KIND_ELASTIC_QUOTA, q)


def run_colo_quota(device):
    """Config 4's quota tree on the largest node count inside the f32
    envelope: 10 ticks with quota churn through Manager(store,
    device="cuda") against a Manager(colo="host") twin; the runtime
    matrix equals the host compute_runtime_quotas over the same
    post-writeback store, the revoke victim lists are equal (order
    included); then the step alone and the fold's launches."""
    from koordinator_tpu_torch.colo.step import build_colo_step
    from koordinator_tpu_torch.manager import Manager
    from koordinator_tpu_torch.scheduler.config import SchedulerConfiguration

    n_nodes, total, verdicts = envelope_nodes(device)
    if verdicts["config4_churn_store"] != (
            "cluster total exceeds the f32-exact bound"):
        raise AssertionError(f"colo_quota: config 4's verdict "
                             f"{verdicts['config4_churn_store']}")
    if n_nodes < 1:
        raise AssertionError(f"colo_quota: no node count is eligible: "
                             f"{verdicts}")
    args = dataclasses.replace(SchedulerConfiguration().elastic_quota,
                               monitor_all_quotas=True,
                               delay_evict_time_seconds=5.0,
                               revoke_pod_interval_seconds=1.0)
    worlds = []
    for colo in ("on", "host"):
        store, state = quota_world(n_nodes)
        mgr = Manager(store, identity=f"colo-q-{colo}", colo=colo,
                      device=device)
        # synth's tree does not pass the quota webhook's topology checks
        # (no group is marked a parent, the teams' mins exceed the
        # root's), so the churn is written past the webhook, as a
        # controller's own writes would be
        store.set_admission("koord-manager-webhook", None)
        worlds.append((store, mgr, mgr.colo.quota_plugin.revoke_controller(
            store, args)))
    (store, mgr, revoker), (twin_store, twin, twin_revoker) = worlds
    now = state.now
    pass_ms, victims, consumed = [], 0, 0
    for k in range(QUOTA_TICKS):
        now += 10.0
        for s in (store, twin_store):
            quota_churn(s, k, now, n_nodes)
        stats = checked_colo_tick(f"colo_quota tick {k}", mgr, twin, now)
        pass_ms.append(colo_roots(mgr)[-1][0])
        plugin = mgr.colo.quota_plugin
        consumed += plugin.fresh_device_runtime() is not None
        _tree, host_rt = plugin.tree_snapshot(store)
        if not np.array_equal(stats["runtime"], host_rt):
            raise AssertionError(f"colo_quota tick {k}: the runtime matrix "
                                 f"differs from compute_runtime_quotas")
        got, want = revoker.reconcile(now), twin_revoker.reconcile(now)
        if list(got) != list(want):
            raise AssertionError(f"colo_quota tick {k}: revoke victims "
                                 f"{got[:3]} != {want[:3]}")
        victims += len(got)
    if consumed < QUOTA_TICKS or victims < 1:
        raise AssertionError(f"colo_quota: device runtime consumed "
                             f"{consumed} times, {victims} victims")
    view, step_args, plan = colo_step_args(mgr, now, device)
    step = colo_step_check("colo_quota", view, step_args, plan, device,
                           compare_total=True)
    # the fold alone: the same node arrays with an empty quota side
    empty = [t.clone() for t in step_args]
    empty[13] = torch.full_like(empty[13], -1)   # q_level: no row
    empty[22] = torch.zeros_like(empty[22])      # q_valid
    no_fold = profile_launches(lambda: build_colo_step(
        view["cpu_policy"], view["memory_policy"], device=device)(
            *empty, plan=(-1,) * len(plan)))
    row = {"phase": "colo_quota", "nodes": n_nodes,
           "cluster_total": [float(x) for x in total],
           "verdicts": verdicts, "G": int(step_args[12].shape[0]),
           "groups": len(mgr.colo.pack.quota_view(plugin)["names"]),
           "N": int(step_args[0].shape[0]), "plan": list(plan),
           "pass_ms": pass_ms, "pass_ms_median": statistics.median(pass_ms),
           "host_pass_ms_median": statistics.median(
               ms for ms, _ in colo_roots(twin)),
           **step,
           "fold_launches": (step["step_launches"]["device_kernels"]
                             - no_fold["device_kernels"]),
           "fold_device_ms": (step["step_launches"]["device_ms"]
                              - no_fold["device_ms"]),
           "victims": victims, "revoke_equal": True, "runtime_equal": True,
           "engine": "device", "ladder_full": True}
    emit(row)
    return row


def run_colo_colocated(device, n_nodes=5000, n_pods=10000):
    """The quota-free config 4 store through Scheduler(store) cycle 0,
    then Manager(store, scheduler=sched), beside a twin whose manager is
    colo="host": the colo_* fields ride the scheduler's mirror (no
    private one), and the cycles after the manager ticks (200
    batch-class pods arriving) bind as the twin's do. Returns kernel 1's
    launches."""
    from koordinator_tpu_torch.api.objects import ObjectMeta, Pod, PodSpec
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.colo.reconciler import COLO_NODE_FIELDS
    from koordinator_tpu_torch.manager import Manager

    retries0 = retries_now()
    fck.launches = fck.replay_launches = sk.launches = 0
    worlds = {}
    for colo in ("on", "host"):
        store, state = colo_store(n_nodes, n_pods)
        sched = Scheduler(store, device=device)
        res0 = sched.run_cycle(now=state.now)
        own = set(sched.device_snapshot._fields)
        mgr = Manager(store, identity=f"colo-{colo}", scheduler=sched,
                      colo=colo)
        now = state.now + 1.0
        bound = [result_key(res0)]
        for k in range(2):
            mgr.tick(now=now)
            for i in range(100):
                store.add(KIND_POD, Pod(
                    meta=ObjectMeta(name=f"batch-{k}-{i}", namespace="colo",
                                    uid=f"batch-{k}-{i}",
                                    creation_timestamp=now),
                    spec=PodSpec(priority=5500, requests=ResourceList.of(
                        batch_cpu=1000 * (1 + i % 4),
                        batch_memory=(1 + i % 2) * 1024 ** 3))))
            res = sched.run_cycle(now=now + 0.5)
            bound.append(result_key(res))
            now += 10.0
        worlds[colo] = (store, sched, mgr, own, bound)
    store, sched, mgr, own, bound = worlds["on"]
    if bound != worlds["host"][4]:
        raise AssertionError("colo_colocated: the cycles bind otherwise "
                             "than the colo=\"host\" twin's")
    fields = set(sched.device_snapshot._fields)
    colo_fields = {f for f in fields if f.startswith("colo_")}
    if (not set(COLO_NODE_FIELDS) <= colo_fields or len(colo_fields) != 24
            or not own <= fields or mgr.colo._own_snapshot is not None):
        raise AssertionError(f"colo_colocated: mirror fields {sorted(fields)}")
    if mgr.colo.stats["device_passes"] != 2 or mgr.colo.stats["host_passes"]:
        raise AssertionError(f"colo_colocated: {mgr.colo.stats}")
    assert_ladder_full("colo_colocated", retries0, sched, worlds["host"][1])
    passes = colo_roots(mgr)
    batch_bound = sum(1 for key in bound[1:] for b in key[0]
                      if b[0].startswith("colo/batch-"))
    if batch_bound < 1:
        raise AssertionError("colo_colocated: no batch-class pod bound")
    emit({"phase": "colo_colocated", "nodes": n_nodes, "pods": n_pods,
          "first_pass_ms": passes[0][0], "first_pass_spans_ms": passes[0][1],
          "steady_pass_ms": passes[1][0],
          "steady_pass_spans_ms": passes[1][1],
          "mirror_colo_fields": len(colo_fields),
          "mirror_fields": len(fields), "batch_pods_bound": batch_bound,
          "bound_per_cycle": [len(key[0]) for key in bound],
          "full_chain_launches": fck.launches, "binds_equal": True,
          "engine": "device", "ladder_full": True})
    return fck.launches


# ---------------------------------------------------------------------------
# koordexplain: the stage-count pass, the terms instance, the Scheduler with
# explain on, the ladder through no-explain and the koord-scheduler binary
# ---------------------------------------------------------------------------

def explain_ops(fc, n_real: int) -> int:
    """Operations of one stage-count pass on these inputs, counted from
    csrc/filter_chain.cuh and csrc/explain_counts.cu. Every (pod, real
    node) pair: Fit 2R (add, compare), the LoadAware test 2, the taint bit
    test 2, 6 per affinity term, 2 per hostPort slot, the volume test 2
    and the 9 stage counts; a cpuset pod's pairs 5 more (max, fmod, abs,
    two compares), a NUMA pod's the zone fits 2KR and zone totals (K-1)R.
    A pod with a spread term: per such term 3 per node in the first sweep
    (taint, domain, min) over all N nodes."""
    P, R = fc.base.fit_requests.shape
    N = fc.base.allocatable.shape[0]
    K = fc.numa_free.shape[1]
    T, PT = fc.aff_dom.shape[1], fc.port_used.shape[1]
    per_pair = 2 * R + 2 + 2 + 6 * T + 2 * PT + 2 + 9
    n_bind = int(fc.needs_bind.sum())
    n_numa = int(fc.needs_numa.sum())
    spread_terms = int((fc.pod_spread_skew > 0).sum())
    return (n_real * (P * per_pair + n_bind * 5
                      + n_numa * (2 * K * R + (K - 1) * R))
            + spread_terms * 3 * N)


def explain_bytes(fc) -> int:
    """Bytes one stage-count pass must move: each pod record, the frozen
    node state and node rows, the quota chain read once; the counts
    written once."""
    P, R = fc.base.fit_requests.shape
    N = fc.base.allocatable.shape[0]
    K = fc.numa_free.shape[1]
    G, D = fc.quota_ancestors.shape
    T, PT = fc.aff_dom.shape[1], fc.port_used.shape[1]
    VG = fc.vol_needed.shape[1]
    stride = fck.record_layout(R, T, PT, VG)["rec_stride"]
    node = N * (2 * R + K * R + 3 + 3 * T + PT) * 4 + N * (1 + 3 * 4)
    return P * stride * 4 + node + T + G * D * 4 + 2 * G * R * 4 + (
        P * NUM_EXPLAIN_STAGES * 4)


def bits_equal(a, b) -> int:
    """Entries of two f32 tensors that differ bit for bit."""
    return int((a.contiguous().view(torch.int32)
                != b.contiguous().view(torch.int32)).sum())


def run_explain_round(dev_fc, args, ng, ngroups, active, n_real, out_full,
                      full_ms, kernel_ms):
    """The stage-count pass and the terms instance at config 4 (P =
    10240) against ``out_full``, the plain round's explain "full" outputs
    on the same inputs (timed as ``full_ms``): the pass's counts equal
    the plain counts exactly, the terms instance's chosen, requested and
    quota equal the instance without terms and its rows the plain round's
    bit for bit; then both timed (CUDA events, median of REPS) at P =
    10240 and at the churn wave's P = 1280 beside kernel 1 without terms
    (``kernel_ms`` at 10240). The pass also equals the plain counts at P =
    1280; called alone it is timed three ways (the call, its launch alone,
    its kernel's device time under torch.profiler), and the explain step
    must take the round's pack (no pack of the pass's own) and launch it
    once, beside the round: the step at "counts" and the round with the
    pass beside it are timed against the step and the round without.
    Returns the two kernels-line entries."""
    wi, bi = resolve_weight_idx(args, active), resolve_balance_idx(active)
    prod = args.score_according_prod_usage
    state = cycle_start_state(dev_fc)
    ek.launches = 0
    counts = ek.explain_counts(dev_fc, state, n_real)
    torch.cuda.synchronize()
    count_launch = dict(ek.last_launch)
    c_mism = int((counts.to(torch.int64)
                  != out_full[3].stage_counts.to(torch.int64)).sum())
    if c_mism or ek.launches != 1:
        raise AssertionError(f"explain_round: the stage-count pass "
                             f"disagrees with the plain counts in {c_mism} "
                             f"entries ({ek.launches} launches)")
    wave = pod_rows(dev_fc, 1280)
    wstate = cycle_start_state(wave)
    counts_w = ek.explain_counts(wave, wstate, n_real)
    count_launch_1280 = dict(ek.last_launch)
    c_mism_1280 = int((counts_w.to(torch.int64) != explain_stage_counts(
        wave, wstate, n_real).to(torch.int64)).sum())
    if c_mism_1280:
        raise AssertionError(f"explain_round: the stage-count pass "
                             f"disagrees with the plain counts at P = 1280 "
                             f"in {c_mism_1280} entries")
    fck.terms_launches = 0
    out_t = fck.full_chain_round(dev_fc, wi, prod, bi, terms=True)
    out_n = fck.full_chain_round(dev_fc, wi, prod, bi)
    torch.cuda.synchronize()
    if fck.terms_launches != 1:
        raise AssertionError("explain_round: the terms instance did not "
                             "launch")
    t_mism = int((out_t[0] != out_n[0]).sum()) + bits_equal(
        out_t[1], out_n[1]) + bits_equal(out_t[2], out_n[2])
    if t_mism:
        raise AssertionError(f"explain_round: the terms instance moved "
                             f"{t_mism} values of chosen/requested/quota")
    step = fck.build_cuda_full_chain_step(args, ng, ngroups, active,
                                          explain="full")
    ek.launches = ek.self_packs = 0
    out_k = step(dev_fc, n_real)
    torch.cuda.synchronize()
    terms_launch = launch_fields(fck)
    if ek.launches != 1 or ek.self_packs != 0:
        raise AssertionError(f"explain_round: the explain step launched the "
                             f"pass {ek.launches} times and packed "
                             f"{ek.self_packs} times for it")
    terms_mism = bits_equal(out_k[3].terms, out_full[3].terms)
    s_mism = int((out_k[0] != out_full[0]).sum()) + bits_equal(
        out_k[1], out_full[1]) + bits_equal(out_k[2], out_full[2]) + int(
            (out_k[3].stage_counts.to(torch.int64)
             != out_full[3].stage_counts.to(torch.int64)).sum())
    t_err = float((out_k[3].terms - out_full[3].terms).abs().max())
    if terms_mism or s_mism or t_err != 0.0:
        raise AssertionError(f"explain_round: the explain step disagrees "
                             f"with the plain round: {terms_mism} terms, "
                             f"{s_mism} other values")
    if not torch.isfinite(out_k[3].terms).all():
        raise AssertionError("explain_round: non-finite terms")
    bound = out_k[0] >= 0
    if not bool((out_k[3].terms[bound, 3] >= out_k[3].terms[bound, 4]).all()):
        raise AssertionError("explain_round: a bound pod's runner-up beats "
                             "its best")
    # the times: the pass and kernel 1 with and without terms, at both P
    alone = counts_timings(ek, dev_fc, n_real)
    alone_1280 = counts_timings(ek, wave, n_real)
    # the kernels line's time: the call as the main path makes it, on the
    # round's pack
    count_ms = alone["call_on_pack_ms"]
    count_ms_1280 = alone_1280["call_on_pack_ms"]
    steps = {ex: fck.build_cuda_full_chain_step(args, ng, ngroups, active,
                                                explain=ex)
             for ex in (None, "counts")}
    step_off_ms = time_cuda(lambda: steps[None](dev_fc), REPS)
    step_counts_ms = time_cuda(lambda: steps["counts"](dev_fc, n_real),
                               REPS)
    beside_ms = time_cuda(lambda: fck.full_chain_round(
        dev_fc, wi, prod, bi, counts_n_real=n_real), REPS)
    terms_ms = time_cuda(lambda: fck.full_chain_round(
        dev_fc, wi, prod, bi, terms=True), REPS)
    terms_ms_1280 = time_cuda(lambda: fck.full_chain_round(
        wave, wi, prod, bi, terms=True), REPS)
    round_ms_1280 = time_cuda(lambda: fck.full_chain_round(
        wave, wi, prod, bi), REPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_counts = explain_stage_counts(dev_fc, state, n_real)
    torch.cuda.synchronize()
    count_plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(plain_counts.to(torch.int64),
                       out_full[3].stage_counts.to(torch.int64)):
        raise AssertionError("explain_round: the plain counts moved")
    P = dev_fc.base.fit_requests.shape[0]
    c_bytes_ms = explain_bytes(dev_fc) / HBM_BYTES_PER_S * 1e3
    c_ops_ms = explain_ops(dev_fc, n_real) / F32_OPS_PER_S * 1e3
    W = len(wi)
    # the round's operations and the runner-up's compare and max per pair
    t_ops = round_ops(dev_fc, W, bi[0] >= 0) + (
        2 * P * dev_fc.base.allocatable.shape[0])
    t_ops_ms = t_ops / F32_OPS_PER_S * 1e3
    t_bytes_ms = (tensor_bytes(dev_fc) + P * 4 * (1 + len(fck.EXPLAIN_TERMS))
                  ) / HBM_BYTES_PER_S * 1e3
    emit({"phase": "explain_round", "P": int(P), "n_real": int(n_real),
          "stage_counts": {"launch": count_launch,
                           "launch_P1280": count_launch_1280,
                           "mismatches": c_mism,
                           "mismatches_P1280": c_mism_1280,
                           "kernel_ms": count_ms,
                           "kernel_ms_P1280": count_ms_1280,
                           "alone": alone, "alone_P1280": alone_1280,
                           "step_off_ms": step_off_ms,
                           "step_counts_ms": step_counts_ms,
                           "round_ms": kernel_ms,
                           "round_beside_ms": beside_ms,
                           "plain_ms": count_plain_ms,
                           "bound_bytes_ms": c_bytes_ms,
                           "bound_ops_ms": c_ops_ms,
                           "ops": explain_ops(dev_fc, n_real),
                           "rejections": int(out_k[3].stage_counts[
                               :, :9].to(torch.int64).sum())},
          "terms": {"launch": terms_launch, "mismatches": terms_mism,
                    "max_abs_err": t_err, "kernel_ms": terms_ms,
                    "kernel_ms_P1280": terms_ms_1280,
                    "round_ms": kernel_ms, "round_ms_P1280": round_ms_1280,
                    "overhead_pct": (terms_ms / kernel_ms - 1.0) * 100.0,
                    "plain_full_round_ms": full_ms,
                    "bound_bytes_ms": t_bytes_ms, "bound_ops_ms": t_ops_ms},
          "pods_bound": int(bound.sum())})
    return (
        {"mismatches": c_mism, "err": 0.0, "ms": count_ms,
         "plain_ms": count_plain_ms, "bytes_ms": c_bytes_ms,
         "ops_ms": c_ops_ms, "ms_P1280": count_ms_1280},
        {"mismatches": terms_mism, "err": t_err, "ms": terms_ms,
         "plain_ms": full_ms, "bytes_ms": t_bytes_ms, "ops_ms": t_ops_ms,
         "ms_P1280": terms_ms_1280})


def explain_launches_now() -> dict:
    return {"explain_counts": ek.launches,
            "full_chain_terms": fck.terms_launches}


def explain_cycle(tag, sched, now):
    """One cycle with every launch count (and the explain readback
    counter) set to 0 just before it and read just after. On the card:
    with explain on, one stage-count pass per device wave (per dispatch
    on the serial path), on the round's own pack (none of its own) and,
    at "full", every round in the terms instance; with explain off,
    neither."""
    ek.launches = ek.self_packs = fck.terms_launches = 0
    ex0 = scheduler_metrics.EXPLAIN_READBACK_BYTES.get() or 0.0
    res, wall, launches, k = wave_cycle(tag, sched, now)
    launches.update(explain_launches_now())
    ex_bytes = (scheduler_metrics.EXPLAIN_READBACK_BYTES.get() or 0.0) - ex0
    if sched.device.type == "cuda":
        spec = sched.explain_spec
        rounds = launches["full_chain"]
        if spec is None and (launches["explain_counts"]
                             or launches["full_chain_terms"]):
            raise AssertionError(f"{tag}: explain off launched {launches}")
        if spec is not None and (launches["explain_counts"] != rounds
                                 or ek.self_packs != 0 or ex_bytes <= 0):
            raise AssertionError(f"{tag}: {rounds} rounds, launches "
                                 f"{launches}, {ek.self_packs} packs of "
                                 f"the pass's own, {ex_bytes} explain "
                                 "bytes")
        if (spec == "full") != (launches["full_chain_terms"] == rounds):
            raise AssertionError(f"{tag}: terms launches {launches}")
    return res, wall, launches, k, ex_bytes


def run_scheduler_explain(device, n_nodes=5000, n_pods=10000,
                          measured=EXPLAIN_MEASURED):
    """Config 4 through the default path (auto waves, chained dispatch)
    with explain "counts" and "full" beside an explain-off twin, and a
    serial "counts" twin (waves=1) running as many cycles as the default
    path consumed: cycle 0, EXPLAIN_WARMUP and ``measured`` churn cycles of
    n_pods // 10 arrivals. The bindings, failure lists and every
    PodScheduled message must be equal every cycle. Returns the phase's
    launches per kernel."""
    arrivals = n_pods // 10
    retries0 = retries_now()
    worlds = {name: churn_store(n_nodes, n_pods, seed=42)
              for name in ("off", "counts", "full", "serial")}
    now = worlds["off"][1].now
    scheds = {
        "off": Scheduler(worlds["off"][0], device=device, explain="off"),
        "counts": Scheduler(worlds["counts"][0], device=device,
                            explain="counts"),
        "full": Scheduler(worlds["full"][0], device=device,
                          explain="full"),
        "serial": Scheduler(worlds["serial"][0], device=device, waves=1,
                            explain="counts"),
    }
    total = {"full_chain": 0, "full_chain_replay": 0, "explain_counts": 0,
             "full_chain_terms": 0}
    walls = {name: [] for name in scheds}
    splits = {name: [] for name in ("off", "counts", "full")}
    ex_bytes = {name: [] for name in scheds}
    rows = []
    for c in range(1 + EXPLAIN_WARMUP + measured):
        if c:
            specs = arrival_specs(c, arrivals)
            for store, _state in worlds.values():
                add_arrivals(store, specs, now + c)
        t = now + 2 * c
        keys, row = {}, {"cycle": c}
        for name in ("off", "counts", "full"):
            res, wall, la, k, xb = explain_cycle(
                f"scheduler_explain cycle {c} {name}", scheds[name], t)
            keys[name] = result_key(res)
            row[name] = {"K": k, "waves": res.waves, "ms": wall * 1e3,
                         "launches": la, "explain_readback_bytes": xb}
            for key in total:
                total[key] += la[key]
            if c > EXPLAIN_WARMUP:
                walls[name].append(wall)
                splits[name].append(span_split(scheds[name], WAVE_SPANS))
                ex_bytes[name].append(xb)
        waves = {row[n]["waves"] for n in ("off", "counts", "full")}
        if len(waves) != 1:
            raise AssertionError(f"scheduler_explain cycle {c}: logical "
                                 f"cycles differ {waves}")
        ser_key, wall_s, xb_s = ([], [], []), 0.0, 0.0
        for _w in range(waves.pop()):
            res_s, wall, la, _k, xb = explain_cycle(
                f"scheduler_explain cycle {c} serial", scheds["serial"], t)
            wall_s += wall
            xb_s += xb
            for key in total:
                total[key] += la[key]
            for part, got in zip(ser_key, result_key(res_s)):
                part.extend(got)
        keys["serial"] = ser_key
        row["serial"] = {"ms": wall_s * 1e3, "explain_readback_bytes": xb_s}
        if c > EXPLAIN_WARMUP:
            walls["serial"].append(wall_s)
            ex_bytes["serial"].append(xb_s)
        if not (keys["off"] == keys["counts"] == keys["full"]
                == keys["serial"]):
            raise AssertionError(f"scheduler_explain cycle {c}: the "
                                 "bindings differ")
        conds = {name: conditions(store)
                 for name, (store, _s) in worlds.items()}
        if not (conds["off"] == conds["counts"] == conds["full"]
                == conds["serial"]):
            raise AssertionError(f"scheduler_explain cycle {c}: the "
                                 "PodScheduled messages differ")
        row["bound"] = len(keys["off"][0])
        row["unschedulable"] = sum(1 for v in conds["off"].values()
                                   if v[0] == "False")
        rows.append(row)
    # the /explain records: every pod the default path saw, both levels
    counts_idx, full_idx = (scheds[n].explain_index for n in ("counts",
                                                              "full"))
    verdicts = {v["verdict"] for v in counts_idx.values()}
    if verdicts != {"bound", "unschedulable"}:
        raise AssertionError(f"scheduler_explain: verdicts {verdicts}")
    with_terms = sum(1 for v in full_idx.values() if "terms" in v)
    if not with_terms:
        raise AssertionError("scheduler_explain: no bound pod has terms")
    assert_ladder_full("scheduler_explain", retries0, *scheds.values())
    med = {name: statistics.median(w) * 1e3 for name, w in walls.items()}
    spans = {name: median_split(s) for name, s in splits.items()}
    emit({"phase": "scheduler_explain", "nodes": n_nodes, "pods": n_pods,
          "arrivals_per_cycle": arrivals, "measured_cycles": measured,
          "bindings_and_messages_equal_every_cycle": True,
          "ladder_full": True, "cycle_ms": med,
          "counts_overhead_pct": (med["counts"] / med["off"] - 1) * 100,
          "full_overhead_pct": (med["full"] / med["off"] - 1) * 100,
          "spans_ms": {name: {k: s[k] for k in ("diagnose", "kernel",
                                                  "replay_drain", "encode",
                                                  "cycle")}
                       for name, s in spans.items()},
          "explain_readback_bytes": {
              name: statistics.median(b) for name, b in ex_bytes.items()},
          "explain_index": {"counts": len(counts_idx),
                            "full": len(full_idx),
                            "full_with_terms": with_terms},
          "launches": total, "cycles": rows})
    return total


def run_ladder_explain(device, n_nodes=5000, n_pods=10000):
    """Config 4 through Scheduler(store, explain="counts") at its default
    waves with EXPLAIN_LADDER_FAULTS on its dispatch hook and a ladder
    that promotes after 2 clean cycles: the storm demotes the fused window
    to serial waves and the serial pass to no-explain, where it binds
    without attribution (the host recompute writes the messages); clean
    cycles promote it back through serial waves to full. The store
    invariants hold after every cycle; the stage-count pass launches on
    every cycle above the no-explain rung and on none at it. Returns the
    launches per kernel."""
    arrivals = n_pods // 10
    store, state = churn_store(n_nodes, n_pods, seed=42)
    plan = FaultPlan(EXPLAIN_LADDER_FAULTS)
    sched = Scheduler(store, device=device, explain="counts",
                      ladder=DegradationLadder(
                          promote_after=LADDER_PROMOTE_AFTER))
    sched.fault_injector = plan.dispatch_hook
    now = state.now
    total = {"full_chain": 0, "full_chain_replay": 0, "explain_counts": 0,
             "full_chain_terms": 0}
    rows = []
    for c in range(len(EXPLAIN_LADDER_LEVELS)):
        if c:
            add_arrivals(store, arrival_specs(c, arrivals), now + c)
        t = now + 2 * c
        plan.begin_cycle(c)
        level0 = sched.ladder.level
        ek.launches = fck.terms_launches = 0
        res, wall, la, k = ladder_cycle(sched, t)
        la.update(explain_launches_now())
        for key in total:
            total[key] += la[key]
        level = sched.ladder.level
        breaches = check_invariants(store, now=t)
        if breaches:
            raise AssertionError(f"ladder_explain cycle {c}: "
                                 f"{breaches[:3]}")
        if level != EXPLAIN_LADDER_LEVELS[c]:
            raise AssertionError(f"ladder_explain cycle {c}: level {level},"
                                 f" expected {EXPLAIN_LADDER_LEVELS[c]}")
        # the cycle ran at no-explain where it started or ended there
        no_explain = "explain-ladder" in res.demotions
        if no_explain != (level0 == 4 or level == 4):
            raise AssertionError(f"ladder_explain cycle {c}: demotions "
                                 f"{res.demotions} at level {level}")
        if device == "cuda" and (
                (no_explain and la["explain_counts"] != 0)
                or (not no_explain and la["explain_counts"] < 1)
                or la["full_chain"] < 1):
            raise AssertionError(f"ladder_explain cycle {c}: launches {la}")
        if not res.bound:
            raise AssertionError(f"ladder_explain cycle {c}: nothing bound")
        rows.append({"cycle": c, "level": sched.ladder.level_name, "K": k,
                     "waves": res.waves, "ms": wall * 1e3,
                     "bound": len(res.bound), "demotions": res.demotions,
                     "launches": la})
    walk = [(t["from"], t["to"]) for t in sched.ladder.transitions]
    if walk != EXPLAIN_LADDER_WALK:
        raise AssertionError(f"ladder_explain: transitions {walk}")
    if len(plan.injected) != sum(f.count for f in EXPLAIN_LADDER_FAULTS):
        raise AssertionError(f"ladder_explain: faults fired {plan.injected}")
    emit({"phase": "ladder_explain", "nodes": n_nodes, "pods": n_pods,
          "arrivals_per_cycle": arrivals,
          "promote_after": LADDER_PROMOTE_AFTER, "faults": plan.injected,
          "transitions": sched.ladder.transitions, "invariant_breaches": 0,
          "cycles": rows, "launches": total})
    return total


# ---------------------------------------------------------------------------
# storage worlds, the wave round, cold start, the two binaries
# ---------------------------------------------------------------------------

def run_storage(device, n_nodes=5000, n_pods=10000):
    """Config 4's churn store with the seeded storage layer of
    testing/storage.py (three zones; a WaitForFirstConsumer static class
    with zonal PVs, a WaitForFirstConsumer dynamic class limited to two
    zones, an Immediate class with bound zonal PVs; STORAGE_CLAIMS of the
    pending pods and of the arrivals carry claims) through the default
    path and a serial twin: cycle 0 and STORAGE_CHURN churn cycles of 1000
    arrivals, the dynamic provisioner between cycles. Bindings, failure
    lists, every claim's and volume's binding (the PV picks) and the
    canonical dumps (PodScheduled messages) equal every cycle, every
    dispatch window in kernel 1. Returns the phase's launches."""
    from koordinator_tpu_torch.client.store import KIND_PV, KIND_PVC
    from koordinator_tpu_torch.testing.storage import (
        add_storage,
        claim_arrivals,
        provision,
        storage_churn_store,
        storage_dump,
    )

    def pvs_bound(dump):
        return sum(1 for v in dump["pvs"].values() if v[1] == "Bound")

    arrivals = n_pods // 10
    retries0 = retries_now()
    t0 = time.perf_counter()
    (store_a, state), (store_b, _s) = (
        storage_churn_store(n_nodes, n_pods, seed=42,
                            claim_fraction=STORAGE_CLAIMS)
        for _ in range(2))
    fixture_s = time.perf_counter() - t0
    world = {"pvcs": len(store_a.list(KIND_PVC)),
             "pvs": len(store_a.list(KIND_PV)),
             "pvs_bound": pvs_bound(storage_dump(store_a)),
             "claim_pods": sum(1 for p in store_a.list(KIND_POD)
                               if p.spec.pvc_names and not p.is_assigned)}
    default = Scheduler(store_a, device=device)
    serial = Scheduler(store_b, waves=1, device=device)
    launches = {"full_chain": 0, "full_chain_replay": 0}
    cycles = []
    for c in range(1 + STORAGE_CHURN):
        provisioned = 0
        if c:
            made = [provision(s) for s in (store_a, store_b)]
            if made[0] != made[1]:
                raise AssertionError(f"storage cycle {c}: provisioned {made}")
            provisioned = made[0]
            specs, storage = claim_arrivals(
                arrival_specs(c, arrivals), c, seed=42,
                claim_fraction=STORAGE_CLAIMS)
            for store in (store_a, store_b):
                add_storage(store, storage)
                add_arrivals(store, specs, state.now + c)
        now = state.now + 2 * c
        res_a, wall_a, la, k = wave_cycle(f"storage cycle {c} default",
                                          default, now)
        spans_a = span_split(default, WAVE_SPANS)
        res_b, wall_b, lb, _k = wave_cycle(f"storage cycle {c} serial",
                                           serial, now)
        for key in launches:
            launches[key] += la[key] + lb[key]
        if result_key(res_a) != result_key(res_b):
            raise AssertionError(f"storage cycle {c}: bindings differ")
        dump_a = storage_dump(store_a)
        if dump_a != storage_dump(store_b):
            raise AssertionError(f"storage cycle {c}: PV picks differ")
        if cycle_dump(default) != cycle_dump(serial):
            raise AssertionError(f"storage cycle {c}: the dumps differ")
        if not res_a.bound:
            raise AssertionError(f"storage cycle {c}: nothing bound")
        cycles.append({
            "bound": len(res_a.bound), "failed": len(res_a.failed),
            "rejected": len(res_a.rejected), "K": k, "waves": res_a.waves,
            "demotions": list(res_a.demotions),
            "serial_demotions": list(res_b.demotions),
            "pvs_bound": pvs_bound(dump_a),
            "claims_waiting_for_provisioning": sum(
                1 for v in dump_a["pvcs"].values() if v[2] and not v[0]),
            "provisioned_before": provisioned,
            "cycle_ms": wall_a * 1e3, "serial_cycle_ms": wall_b * 1e3,
            "spans_ms": spans_a,
            "serial_spans_ms": span_split(serial, WAVE_SPANS),
            "launches": la, "serial_launches": lb})
    # the scheduler picked PVs (static claims bound at schedule time) and
    # selected nodes the provisioner then served
    if cycles[0]["pvs_bound"] <= world["pvs_bound"] or not any(
            cyc["provisioned_before"] for cyc in cycles):
        raise AssertionError(f"storage: no PV picks or provisioning: "
                             f"{world} {cycles}")
    # hot claims from real objects through the fused dispatch on the card:
    # the bound-claims world at K = 4 against a CPU twin
    from koordinator_tpu_torch.client.store import ObjectStore
    from koordinator_tpu_torch.testing.storage import bound_claims_world

    store_c, store_h = (bound_claims_world(ObjectStore()) for _ in range(2))
    card = Scheduler(store_c, waves=4, device=device)
    host = Scheduler(store_h, waves=4, device="cpu")
    res_c, _wall, lc, k = wave_cycle("storage hot claims", card, 1e6)
    res_h = host.run_cycle(now=1e6)
    for key in launches:
        launches[key] += lc[key]
    if (result_key(res_c) != result_key(res_h)
            or storage_dump(store_c) != storage_dump(store_h)
            or cycle_dump(card) != cycle_dump(host)):
        raise AssertionError("storage hot claims: the card and the CPU "
                             "differ")
    hot = {"bound": len(res_c.bound), "K": k, "waves": res_c.waves,
           "demotions": list(res_c.demotions), "launches": lc}
    if hot["waves"] < 2 or hot["demotions"]:
        raise AssertionError(f"storage hot claims: not fused: {hot}")
    assert_ladder_full("storage", retries0, default, serial, card)
    emit({"phase": "storage", "nodes": n_nodes, "pods": n_pods,
          "claim_fraction": STORAGE_CLAIMS, "fixture_seconds": fixture_s,
          "world": world, "twins_identical_every_cycle": True,
          "ladder_full": True, "cycles": cycles, "hot_claims": hot,
          "launches": launches})
    return launches


def run_wave_round(dev_fc, args, ng, ngroups, active):
    """The wave-parallel round (models/wave_chain.py, plain PyTorch on the
    card, kernel="wave" in the selector) at config 4 (P = 10240) and at
    the churn wave's P = 1280, against kernel 1 on the same inputs:
    chosen, requested and quota_used equal bit for bit. Times both (CUDA
    events, median of the compare call and WAVE_ROUND_REPS more), counts
    its waves and its host reads of the wave cut (one a wave), and bounds
    it by the inputs read once plus each wave's [W, N] score and
    balanced-allocation rows written once, against kernel 1's operations
    bound. Its launches are a fixed count plus a count a wave (the same
    operations every wave): torch.profiler counts both from two short
    prefixes of the batch (WAVE_PROFILE_PODS pods), and the line gives
    the launches of each full call from them."""
    from koordinator_tpu_torch.models.full_chain import (
        build_best_full_chain_step,
    )
    from koordinator_tpu_torch.models.wave_chain import DEFAULT_WAVE

    kernel = fck.build_cuda_full_chain_step(args, ng, ngroups, active)
    wave = build_best_full_chain_step(args, ng, ngroups, active,
                                      kernel="wave")
    if wave.last_backend != "wave":
        raise AssertionError("wave_round: the selector did not take the "
                             "wave round")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("wave_round: TF32 matmuls are on")
    # launches = fixed + per_wave x waves, from two short prefixes
    counted = []
    for n in WAVE_PROFILE_PODS:
        prof = profile_launches(lambda: wave(pod_rows(dev_fc, n)))
        counted.append((wave.last_waves, prof["cuda_launch_calls"]))
    (w0, l0), (w1, l1) = counted
    per_wave = (l1 - l0) / (w1 - w0)
    fixed = l0 - per_wave * w0
    wi, bi = resolve_weight_idx(args, active), resolve_balance_idx(active)
    out = {}
    for tag, fc, reps in (("P10240", dev_fc, WAVE_ROUND_REPS[0]),
                          ("P1280", pod_rows(dev_fc, 1280),
                           WAVE_ROUND_REPS[1])):
        P = fc.base.fit_requests.shape[0]
        N = fc.base.allocatable.shape[0]
        R = fc.base.fit_requests.shape[1]
        G = fc.quota_used.shape[0]
        out_k = kernel(fc)
        torch.cuda.synchronize()
        # the compare call is timed too (the step ran on two prefixes
        # above, so nothing in it is a first call)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out_w = wave(fc)
        stop.record()
        stop.synchronize()
        times = [start.elapsed_time(stop)]
        mism = int((out_k[0] != out_w[0]).sum())
        bits = bits_equal(out_k[1], out_w[1]) + bits_equal(out_k[2],
                                                           out_w[2])
        if mism or bits:
            raise AssertionError(f"wave_round {tag}: {mism} bindings and "
                                 f"{bits} state words differ from kernel 1")
        waves, reads = wave.last_waves, wave.last_pos_reads
        if reads != waves:
            raise AssertionError(f"wave_round {tag}: {reads} reads of the "
                                 f"cut for {waves} waves")
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            wave(fc)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        kernel_ms = time_cuda(lambda: kernel(fc), REPS)
        W = min(DEFAULT_WAVE, P)
        nbytes = (tensor_bytes(fc) + waves * W * N * 8
                  + P * 4 + N * R * 4 + G * R * 4)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = round_ops(fc, len(wi), bi[0] >= 0) / F32_OPS_PER_S * 1e3
        out[tag] = {
            "P": int(P), "N": int(N), "W": int(W), "waves": waves,
            "pos_reads": reads, "pods_bound": int((out_w[0] >= 0).sum()),
            "mismatches": mism, "state_bits_differing": bits,
            "ms": statistics.median(times), "ms_each": times,
            "kernel1_ms": kernel_ms,
            "launches": round(fixed + per_wave * waves),
            "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    emit({"phase": "wave_round", "timed_calls_P10240": 1 + WAVE_ROUND_REPS[0],
          "timed_calls_P1280": 1 + WAVE_ROUND_REPS[1],
          "launch_count": {"pods": list(WAVE_PROFILE_PODS),
                           "waves_and_launches": counted,
                           "per_wave": per_wave, "fixed": fixed},
          **out})
    return out


def cold_start_child(env_extra, cache_dir) -> dict:
    """One process of the cold-start pair (testing/cold_start.py) with
    ``env_extra`` over this process's environment and the cache dir set;
    returns its JSON line."""
    env = dict(os.environ)
    env.pop("KOORD_TPU_WARMUP", None)
    env.update(env_extra, KOORD_TPU_COMPILE_CACHE_DIR=cache_dir)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "koordinator_tpu_torch.testing.cold_start",
         "--device", "cuda", "--cycles", str(COLD_START_CHURN)],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=COLD_START_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise AssertionError(f"cold_start: child {env_extra} exited "
                             f"{proc.returncode}")
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    rep["process_wall_s"] = wall
    return rep


def run_cold_start():
    """Two scheduler processes in turn on a fresh cache dir, on config 4's
    churn store (testing/cold_start.py: cycle 0 and COLD_START_CHURN churn
    cycles at the default path): the cold one with warm-up off records its
    rungs; the restart with warm-up "sync" replays them before its first
    cycle.
    Gates: warmed == rungs > 0, failed == invalidated == 0, zero
    steady-state step builds, the cold process's bindings every cycle.
    Returns the full-chain launches of both children."""
    cache_dir = tempfile.mkdtemp(prefix="koord_cold_start_")
    try:
        cold = cold_start_child({"KOORD_TPU_WARMUP": "off"}, cache_dir)
        warm = cold_start_child({"KOORD_TPU_WARMUP": "sync"}, cache_dir)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    wu = warm["warmup"] or {}
    problems = []
    if not (wu.get("complete") and wu.get("rungs", 0) > 0
            and wu.get("warmed") == wu.get("rungs")):
        problems.append(f"not every rung warmed: {wu}")
    if wu.get("failed") or wu.get("invalidated"):
        problems.append(f"rungs failed or invalidated: {wu}")
    if warm["steady_state_compiles"] or warm["steady_state_compiles_metric"]:
        problems.append("the restart built steps in steady state")
    if ([c["bindings_sha256"] for c in cold["cycles"]]
            != [c["bindings_sha256"] for c in warm["cycles"]]):
        problems.append("the restart's bindings differ from the cold run's")
    for rep in (cold, warm):
        if rep["last_backend"] != "cuda" or rep["launches"]["full_chain"] < 1:
            problems.append(f"{rep['mode']}: backend {rep['last_backend']} "
                            f"launches {rep['launches']}")
    if problems:
        raise AssertionError(f"cold_start: {problems}")

    def summary(rep):
        return {"construction_s": rep["construction_s"],
                "construction_to_first_bind_s":
                    rep["construction_to_first_bind_s"],
                "cycle0_kernel_span_ms": rep["cycles"][0]["kernel_ms"],
                "cycle_ms": [c["wall_s"] * 1e3 for c in rep["cycles"]],
                "kernel_span_ms": [c["kernel_ms"] for c in rep["cycles"]],
                "waves": [c["waves"] for c in rep["cycles"]],
                "bound": [c["bound"] for c in rep["cycles"]],
                "fixture_s": rep["fixture_s"],
                "process_wall_s": rep["process_wall_s"],
                "launches": rep["launches"]}

    emit({"phase": "cold_start", "cold": summary(cold),
          "restart": summary(warm), "warmup": wu,
          "warmup_seconds": wu.get("seconds"),
          "rungs_recorded": cold["index_rungs"],
          "steady_state_compiles": warm["steady_state_compiles"],
          "bindings_equal": True})
    return {"full_chain": cold["launches"]["full_chain"]
            + warm["launches"]["full_chain"],
            "full_chain_replay": cold["launches"]["full_chain_replay"]
            + warm["launches"]["full_chain_replay"]}


def metric_sample(registry, series: str) -> float:
    """One exposed series' value (0 while it is not exposed)."""
    for line in registry.expose().splitlines():
        name, _, value = line.rpartition(" ")
        if name == series:
            return float(value)
    return 0.0


def run_binary(device, name, synth="5000x10000", ticks=BINARY_TICKS):
    """The port's koord-descheduler or koord-manager binary on the card,
    its main() at --synth ``synth`` for ``ticks`` ticks
    BINARY_INTERVAL seconds apart: exit 0, and one pass on the card a
    tick (the descheduler's rebalance windows, the manager's colo passes
    by engine, read off each binary's registry as deltas)."""
    from koordinator_tpu_torch import manager_metrics
    from koordinator_tpu_torch.cmd import koord_descheduler, koord_manager
    from koordinator_tpu_torch.descheduler import metrics as dm

    main_fn, registry, series, seconds = {
        "koord_descheduler": (
            koord_descheduler.main, dm.REGISTRY,
            'koord_device_window_seconds_count{consumer="rebalance",'
            'path="serial"}', "koord_descheduler_rebalance_pass_seconds_sum"),
        "koord_manager": (
            koord_manager.main, manager_metrics.REGISTRY,
            'koord_manager_colo_passes_total{engine="device"}',
            "koord_manager_colo_pass_seconds_sum"),
    }[name]
    before = metric_sample(registry, series)
    pass_s0 = metric_sample(registry, seconds)
    t0 = time.perf_counter()
    rc = main_fn(["--synth", synth, "--max-ticks", str(ticks),
                  "--interval", str(BINARY_INTERVAL), "--device", device])
    wall = time.perf_counter() - t0
    passes = metric_sample(registry, series) - before
    if rc != 0 or passes != ticks:
        raise AssertionError(f"{name}: rc {rc}, {passes} device passes in "
                             f"{ticks} ticks")
    emit({"phase": name, "synth": synth, "ticks": ticks,
          "interval_s": BINARY_INTERVAL, "rc": rc, "wall_s": wall,
          "device_passes": passes,
          "passes_s": metric_sample(registry, seconds) - pass_s0})


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_json(url: str):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, resp.read().decode()


def run_koord_scheduler(device, synth=KOORD_SCHEDULER_SYNTH, ticks=3,
                        interval=KOORD_SCHEDULER_INTERVAL):
    """The port's koord-scheduler binary on the card:
    cmd.koord_scheduler.main at --synth ``synth`` with BINARY_ENV
    (KOORD_TPU_EXPLAIN=counts, serial dispatch), --obs-port on a free port
    and ``ticks``
    ticks ``interval`` seconds apart. Between the last two ticks a probe
    thread
    reads /healthz, /metrics and /explain for a bound pod and for an
    unschedulable one (a pod no node fits, added to the binary's store)
    over HTTP, each /explain body equal to the Scheduler's own record.
    Returns the launches per kernel."""
    from koordinator_tpu_torch.api.objects import ObjectMeta, Pod, PodSpec
    from koordinator_tpu_torch.api.resources import ResourceList
    from koordinator_tpu_torch.cmd import koord_scheduler
    from koordinator_tpu_torch.scheduler import cycle as cycle_mod

    made = []

    class Recording(cycle_mod.Scheduler):
        """The binary's Scheduler, kept for the probe, with one pod no
        node fits in its store."""

        def __init__(self, store, **kw):
            super().__init__(store, **kw)
            store.add(KIND_POD, Pod(
                meta=ObjectMeta(name="hog", uid="hog",
                                creation_timestamp=1.0),
                spec=PodSpec(requests=ResourceList.of(
                    cpu=10 ** 9, memory=1024 ** 3, pods=1))))
            made.append(self)

    port = free_port()
    base = f"http://127.0.0.1:{port}"
    seen, failures = {}, []

    def probe():
        try:
            # wait for the second tick to finish: the first binds ~8,500
            # pods, whose records fill the index's 4096 most recent
            # entries; the second's unschedulable pods come back
            deadline = time.time() + 900
            while time.time() < deadline:
                rec = made[0].explain_record("default/hog") if made else None
                if rec is not None and rec["cycle"] >= ticks - 1:
                    break
                time.sleep(0.05)
            status, body = http_json(base + "/healthz")
            seen["healthz"] = json.loads(body)
            status, body = http_json(base + "/metrics")
            seen["metrics_bytes"] = len(body)
            seen["metrics_has_rejections"] = (
                "koord_scheduler_filter_rejections_total" in body)
            sched = made[0]
            with sched._health_lock:  # the index's writer holds it
                index = list(sched.explain_index.items())
            bound = next(k for k, v in index if v["verdict"] == "bound")
            unsched = "default/hog"
            for verdict, key in (("bound", bound),
                                 ("unschedulable", unsched)):
                want = {"pod": key, **sched.explain_record(key)}
                status, body = http_json(
                    base + "/explain?pod=" + urllib.parse.quote(key))
                seen[verdict] = (status, json.loads(body),
                                 json.loads(json.dumps(want)))
        except Exception as exc:  # surfaced in the main thread below
            failures.append(exc)

    env0 = {k: os.environ.get(k) for k in BINARY_ENV}
    os.environ.update(BINARY_ENV)
    cycle_mod.Scheduler = Recording
    fck.launches = fck.replay_launches = fck.terms_launches = 0
    ek.launches = sk.launches = 0
    thread = threading.Thread(target=probe, daemon=True)
    t0 = time.perf_counter()
    try:
        thread.start()
        rc = koord_scheduler.main([
            "--synth", synth, "--max-ticks", str(ticks), "--device", device,
            "--obs-port", str(port), "--interval", str(interval)])
    finally:
        cycle_mod.Scheduler = Scheduler
        for key, value in env0.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    wall = time.perf_counter() - t0
    thread.join(timeout=60)
    launches = {"full_chain": fck.launches,
                "full_chain_replay": fck.replay_launches,
                **explain_launches_now(), "schedule_step": sk.launches}
    if failures:
        raise failures[0]
    if rc != 0 or not made or made[0].explain_spec != "counts":
        raise AssertionError(f"koord_scheduler: rc {rc}")
    sched = made[0]
    for verdict in ("bound", "unschedulable"):
        status, got, want = seen[verdict]
        if status != 200 or got != want or got["verdict"] != verdict:
            raise AssertionError(f"koord_scheduler: /explain for a "
                                 f"{verdict} pod: {got} vs {want}")
    if not seen["unschedulable"][1].get("message", "").startswith("0/"):
        raise AssertionError("koord_scheduler: the unschedulable pod's "
                             f"message {seen['unschedulable'][1]}")
    if (seen["healthz"]["degraded"]["level_name"] != "full"
            or not seen["metrics_has_rejections"]):
        raise AssertionError(f"koord_scheduler: /healthz {seen['healthz']}")
    if device == "cuda" and (sched.last_backend != "cuda"
                             or launches["explain_counts"] < 1
                             or launches["full_chain"] < 1
                             or launches["schedule_step"]):
        raise AssertionError(f"koord_scheduler: launches {launches}")
    emit({"phase": "koord_scheduler", "synth": synth, "ticks": ticks,
          "interval_s": interval, "wall_s": wall,
          "cycles": sched.health_snapshot()["cycles"],
          "healthz": seen["healthz"],
          "metrics_bytes": seen["metrics_bytes"],
          "explain_bound": seen["bound"][1],
          "explain_unschedulable": seen["unschedulable"][1],
          "explain_equal_to_record": True, "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# slice 11: the compiled serial floors, the gRPC sidecar, the Scheduler's
# sidecar dispatch and the soak
# ---------------------------------------------------------------------------


def sidecar_address(tag: str) -> str:
    """A Linux abstract unix socket: no file, no path length to fit."""
    return f"unix-abstract:koord-chip-smoke-{tag}-{os.getpid()}"


def run_lownodeload_floor(store, plugin, pods_src, picked, now, host_ms,
                          device_ms):
    """BASELINE config 5's LowNodeLoad pass as the compiled serial floor
    (native/serial_floor.cpp on the host CPU) on pack_floor_inputs of the
    same store: its victims must be the device pass's, as a set of pods."""
    from koordinator_tpu_torch.descheduler.lownodeload import (
        pack_floor_inputs,
    )
    from koordinator_tpu_torch.native import floor as native_floor

    t0 = time.perf_counter()
    native_floor.load()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pods_l, arrays = pack_floor_inputs(store, plugin, now)
    pack_s = time.perf_counter() - t0
    floor_ms = []
    for _ in range(FLOOR_REPS):
        t0 = time.perf_counter()
        victim = native_floor.lownodeload_floor_native(**arrays)
        floor_ms.append((time.perf_counter() - t0) * 1e3)
    floor_keys = {pods_l[i].meta.key for i in np.nonzero(victim)[0]}
    pass_keys = {pods_src[k].meta.key for k in picked}
    if floor_keys != pass_keys:
        raise AssertionError(
            f"lownodeload_floor: {len(floor_keys)} floor victims against "
            f"{len(pass_keys)} from the device pass, or other pods")
    emit({"phase": "lownodeload_floor", "pods": len(pods_l),
          "nodes": int(arrays["alloc"].shape[0]), "victims": len(floor_keys),
          "victims_equal": True, "floor_build_seconds": build_s,
          "pack_floor_inputs_seconds": pack_s, "floor_ms": floor_ms,
          "floor_ms_median": statistics.median(floor_ms),
          "device_pass_ms_median": statistics.median(device_ms),
          "host_pass_ms_median": statistics.median(host_ms)})


def run_compiled_floor(fc, args, ng, ngroups, active, chosen, plain_chosen,
                       kernel_ms, warm_s, card):
    """BASELINE config 4's full chain as the compiled serial floor on the
    host CPU, on the batch kernel 1 served through
    SidecarServer.schedule_batch: its bindings must equal kernel 1's and
    the plain round's, bit for bit. vs_compiled_floor is the floor's
    seconds over the warm schedule_batch call's (bench.py's ratio), the
    round-only ratio over kernel 1's CUDA-event time beside it."""
    from koordinator_tpu_torch.native import floor as native_floor

    t0 = time.perf_counter()
    native_floor.load()
    build_s = time.perf_counter() - t0
    floor_s = []
    for _ in range(FLOOR_REPS):
        t0 = time.perf_counter()
        floor_chosen = native_floor.serial_schedule_full_native(
            fc, args, num_groups=ngroups, active_axes=active)
        floor_s.append(time.perf_counter() - t0)
    mism = {"kernel": int((floor_chosen != chosen).sum()),
            "plain": int((floor_chosen != plain_chosen).sum())}
    if any(mism.values()):
        raise AssertionError(f"compiled_floor: the floor's bindings differ: "
                             f"{mism}")
    median_s = statistics.median(floor_s)
    valid = int(np.asarray(fc.base.pod_valid).sum())
    emit({"phase": "compiled_floor", "P": int(chosen.shape[0]),
          "N": int(np.asarray(fc.base.allocatable).shape[0]),
          "pods": valid, "pods_bound": int((floor_chosen >= 0).sum()),
          "mismatches": mism, "floor_build_seconds": build_s,
          "floor_seconds": floor_s, "floor_seconds_median": median_s,
          "floor_pods_per_s": valid / median_s,
          "kernel_round_ms": kernel_ms,
          "schedule_batch_warm_ms": warm_s * 1e3,
          "vs_compiled_floor": median_s / warm_s,
          "vs_compiled_floor_round": median_s / (kernel_ms / 1e3),
          "card": card})


def run_sidecar_grpc(server, fc, args, ng, ngroups, active, main_out,
                     in_process_s, card):
    """The config 4 batch over gRPC: serve_sidecar on an abstract unix
    socket in this process around the main path's SidecarServer (its step
    is built), a SidecarClient sending the batch. Every call's chosen,
    requested and quota_used must equal the in-process call's, bit for
    bit, and launch kernel 1 once. Prints the message sizes and a warm
    call's split (median of SIDECAR_REPS): pack and serialize on the
    client, the transport (the call's wall less the handler's), the
    handler's unpack and upload, round, permit, readback and response,
    and the client's decode. The C++ client is not run: the card's machine
    has no protoc and no libprotobuf headers to build it."""
    from koordinator_tpu_torch.scheduler.sidecar import (
        SidecarClient,
        pack_request,
        serve_sidecar,
        tensor_to_np,
    )

    address = sidecar_address("grpc")
    grpc_server = serve_sidecar(address, server)
    client = SidecarClient(address)
    splits, kernel_seconds = [], []
    try:
        fck.launches = 0
        t0 = time.perf_counter()
        client.schedule_batch(pack_request(fc, ng, ngroups, args,
                                           active_axes=active))
        cold_s = time.perf_counter() - t0
        for _ in range(SIDECAR_REPS):
            t0 = time.perf_counter()
            req = pack_request(fc, ng, ngroups, args, active_axes=active)
            pack_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            blob = req.SerializeToString()
            serialize_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            resp = client.schedule_batch(req)
            call_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = tuple(tensor_to_np(t) for t in (
                resp.chosen, resp.requested, resp.quota_used))
            decode_s = time.perf_counter() - t0
            srv = dict(server.last_timings)
            handler_s = sum(srv.values())
            for a, b in zip(out, main_out):
                if a.shape != b.shape or a.dtype != b.dtype or (a != b).any():
                    raise AssertionError("sidecar_grpc: the gRPC call's "
                                         "outputs differ from the in-process "
                                         "call's")
            splits.append({"pack": pack_s, "serialize": serialize_s,
                           "transport": call_s - handler_s,
                           **{f"server_{k}": v for k, v in srv.items()},
                           "decode": decode_s,
                           "total": pack_s + call_s + decode_s})
            kernel_seconds.append(resp.kernel_seconds)
        launches = fck.launches
    finally:
        client.close()
        grpc_server.stop(0)
    if server.device.type == "cuda" and (
            launches != 1 + SIDECAR_REPS or server.last_backend != "cuda"):
        raise AssertionError(f"sidecar_grpc: {launches} kernel launches in "
                             f"{1 + SIDECAR_REPS} calls, backend "
                             f"{server.last_backend}")
    split = median_split(splits)
    emit({"phase": "sidecar_grpc", "address": "unix-abstract",
          "request_bytes": len(blob), "response_bytes": resp.ByteSize(),
          "cold_call_s": cold_s, "warm_split_s": split,
          "kernel_seconds": kernel_seconds,
          "in_process_warm_s": in_process_s,
          "overhead_over_in_process_s": split["total"] - in_process_s,
          "launches": launches, "outputs_equal": True,
          "cpp_client": "not built: no protoc, no libprotobuf headers on "
                        "this machine", "card": card})
    return launches


def run_scheduler_sidecar(device, n_nodes=5000, n_pods=10000):
    """Config 4's churn store through Scheduler(device=, sidecar_address=)
    against a ScheduleBatch server in this process, beside its serial twin
    Scheduler(waves=1) on an identical store, for cycle 0 and
    SIDECAR_CHURN churn cycles: bindings, failure lists and the canonical
    dumps (PodScheduled messages) identical every cycle, every cycle
    demoted with reason sidecar, no fallback, kernel 1 launched by the
    server. Then the server stops and one more churn cycle runs: the
    Scheduler's own step on the card (kernel 1 launches here), one
    fallback, the twin's bindings. Returns the phase's kernel 1
    launches."""
    from koordinator_tpu_torch.scheduler.sidecar import serve_sidecar

    arrivals = n_pods // 10
    address = sidecar_address("scheduler")
    server = SidecarServer(device=device)
    grpc_server = serve_sidecar(address, server)
    (store, state), (twin_store, _s) = (
        churn_store(n_nodes, n_pods, seed=42) for _ in range(2))
    sched = Scheduler(store, device=device, sidecar_address=address)
    twin = Scheduler(twin_store, device=device, waves=1)
    now = state.now
    rows, total = [], 0
    try:
        for c in range(2 + SIDECAR_CHURN):
            if c == 1 + SIDECAR_CHURN:
                grpc_server.stop(0)  # the sidecar dies
            if c:
                specs = arrival_specs(c, arrivals)
                for s in (store, twin_store):
                    add_arrivals(s, specs, now + c)
            fck.launches = 0
            t0 = time.perf_counter()
            res = sched.run_cycle(now=now + 2 * c)
            wall = time.perf_counter() - t0
            launches = fck.launches
            total += launches
            twin_res, twin_wall, twin_launches, _gc = checked_cycle(
                f"scheduler_sidecar cycle {c} twin", twin, twin.run_cycle,
                now + 2 * c)
            dead = c == 1 + SIDECAR_CHURN
            want_backend = (("cuda" if device == "cuda" else "serial")
                            if dead else "sidecar")
            if (result_key(res) != result_key(twin_res)
                    or cycle_dump(sched) != cycle_dump(twin)):
                raise AssertionError(f"scheduler_sidecar cycle {c}: the "
                                     f"sidecar's cycle differs from the twin")
            if ("sidecar" not in res.demotions
                    or sched.sidecar_fallbacks != int(dead)
                    or sched.last_backend != want_backend
                    or (device == "cuda" and launches < 1)):
                raise AssertionError(
                    f"scheduler_sidecar cycle {c}: demotions "
                    f"{res.demotions}, fallbacks {sched.sidecar_fallbacks}, "
                    f"backend {sched.last_backend}, launches {launches}")
            rows.append({"cycle": c, "server": "stopped" if dead else "up",
                         "bound": len(res.bound), "ms": wall * 1e3,
                         "twin_ms": twin_wall * 1e3,
                         "kernel_span_ms": res.kernel_seconds * 1e3,
                         "demotions": res.demotions,
                         "backend": sched.last_backend,
                         "launches": launches, "twin_launches": twin_launches,
                         "fallbacks": sched.sidecar_fallbacks})
    finally:
        grpc_server.stop(0)
    emit({"phase": "scheduler_sidecar", "nodes": n_nodes, "pods": n_pods,
          "cycles": rows, "twin_equal": True,
          "sidecar_fallbacks": sched.sidecar_fallbacks})
    return total


def run_soak(device):
    """The sim's soak on the card at its catalog 1000 cycles (four faults:
    a transient dispatch fault, a store-write fault, a dispatch storm down
    to the host fallback, three dead-sidecar cycles; pipeline on, waves
    auto): the binding log's SHA-256 must be the JAX package's, with zero
    invariant breaches, the store-write fault the only cycle exception,
    and three sidecar fallbacks. No CPU twin (the time limit): the CPU's
    equality to the JAX package is tests/test_torch_sim.py's. Returns the
    kernels' launches."""
    fck.launches = fck.replay_launches = sk.launches = 0
    t0 = time.perf_counter()
    report = run_scenario(SCENARIOS["soak"], device=device)
    wall = time.perf_counter() - t0
    launches = {"full_chain": fck.launches,
                "full_chain_replay": fck.replay_launches}
    if (report.binding_log_sha256 != SOAK_JAX_SHA256
            or report.sidecar_fallbacks != 3 or report.invariant_breaches
            or len(report.cycle_exceptions) != 1
            or report.final_level != "full"
            or (device == "cuda" and launches["full_chain"] < 1)):
        raise AssertionError(
            f"soak: sha {report.binding_log_sha256}, fallbacks "
            f"{report.sidecar_fallbacks}, breaches "
            f"{report.invariant_breaches[:3]}, exceptions "
            f"{report.cycle_exceptions[:3]}, level {report.final_level}, "
            f"launches {launches}")
    emit({"phase": "soak", "cycles": SCENARIOS["soak"].cycles,
          "sha256": report.binding_log_sha256, "jax_sha_equal": True,
          "bindings": len(report.binding_log),
          "sidecar_fallbacks": report.sidecar_fallbacks,
          "cycles_at_level": report.cycles_at_level,
          "cycle_exceptions": len(report.cycle_exceptions),
          "invariant_breaches": 0, "wall_s": wall,
          "ms_per_cycle": wall / SCENARIOS["soak"].cycles * 1e3,
          "launches": launches, "cpu_twin": "not run (time limit)"})
    return launches


def nvidia_smi_uuid() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# a child process that samples the card as a fresh node agent does: its
# first sample opens the CUDA context, then it reports what it saw
PROBE_CHILD = (
    "import json, time\n"
    "from koordinator_tpu_torch.koordlet.metricsadvisor import "
    "sample_gpu_devices\n"
    "t0 = time.perf_counter(); first = sample_gpu_devices()\n"
    "t1 = time.perf_counter(); again = sample_gpu_devices()\n"
    "t2 = time.perf_counter()\n"
    "print(json.dumps({'first_ms': (t1 - t0) * 1e3, "
    "'warm_ms': (t2 - t1) * 1e3, 'mem_bytes': again[0]['mem_bytes']}))\n")


def run_node_probe():
    """The koordlet's two device probes on the card: collect_gpu_devices
    reports exactly this card (nvidia-smi's uuid, torch's total memory);
    sample_gpu_devices' bytes in use rise by at least 1 GiB with a 1 GiB
    allocation; a fresh agent process's context cost (its first sample's
    bytes in use less this process's); the perf reader built from the
    port's source into build/native/. Returns the probed device."""
    from koordinator_tpu_torch.koordlet.metricsadvisor import (
        sample_gpu_devices,
    )
    from koordinator_tpu_torch.koordlet.statesinformer import (
        collect_gpu_devices,
    )
    from koordinator_tpu_torch.native import perf
    from koordinator_tpu_torch.native.build import BUILD_DIR

    t0 = time.perf_counter()
    devices = collect_gpu_devices()
    probe_ms = (time.perf_counter() - t0) * 1e3
    props = torch.cuda.get_device_properties(0)
    smi_uuid = nvidia_smi_uuid()
    if len(devices) != torch.cuda.device_count() or len(devices) != 1:
        raise AssertionError(f"node_probe: {len(devices)} devices")
    (dev,) = devices
    if (dev.uuid != smi_uuid or dev.minor != 0 or not dev.health
            or dev.type != "gpu"
            or dev.resources[ResourceName.GPU_MEMORY] != props.total_memory
            or dev.resources[ResourceName.GPU_CORE] != 100
            or dev.resources[ResourceName.GPU_MEMORY_RATIO] != 100):
        raise AssertionError(f"node_probe: probed {dev}, nvidia-smi "
                             f"{smi_uuid}, total {props.total_memory}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    before = sample_gpu_devices()
    sample_ms = (time.perf_counter() - t0) * 1e3
    block = torch.empty(GIB, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
    after = sample_gpu_devices()
    rise = after[0]["mem_bytes"] - before[0]["mem_bytes"]
    del block
    torch.cuda.empty_cache()
    if (before[0]["uuid"] != smi_uuid or rise < GIB
            or not 0.0 < after[0]["core_pct"] <= 100.0):
        raise AssertionError(f"node_probe: samples {before} -> {after}")
    base = sample_gpu_devices()[0]["mem_bytes"]
    child = subprocess.run([sys.executable, "-c", PROBE_CHILD],
                           capture_output=True, text=True, timeout=120,
                           check=True, cwd=os.path.dirname(
                               os.path.abspath(__file__)))
    agent = json.loads(child.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    lib = perf.build()
    perf_build_s = time.perf_counter() - t0
    if lib.parent != BUILD_DIR or not lib.exists():
        raise AssertionError(f"node_probe: libkoordperf at {lib}")
    emit({"phase": "node_probe", "uuid": dev.uuid, "nvidia_smi_uuid":
          smi_uuid, "gpu_memory": dev.resources[ResourceName.GPU_MEMORY],
          "total_memory": props.total_memory, "probe_ms": probe_ms,
          "sample_ms": sample_ms, "mem_bytes_before": before[0]["mem_bytes"],
          "mem_bytes_after_1GiB": after[0]["mem_bytes"], "rise": rise,
          "core_pct_after": after[0]["core_pct"],
          "agent_context_bytes": agent["mem_bytes"] - base,
          "agent_first_sample_ms": agent["first_ms"],
          "agent_warm_sample_ms": agent["warm_ms"],
          "perf_library": os.path.relpath(lib, os.getcwd()),
          "perf_build_s": perf_build_s, "perf_available": perf.available()})
    return dev


def run_node_agent(device, dev, n_nodes=5000, n_pods=10000):
    """The colocation loop at config 4's width with a GPU pool: two stores
    from churn_store(5000, 10000, seed=42), NODE_POOL nodes of each
    running a koordlet Daemon on its own FakeFS with the default (real)
    device collector, a manager tick (GPUDeviceResource writes the pool's
    GPU totals), NODE_GPU_PODS GPU-share pods, then Scheduler(store) at
    its defaults beside a waves=1 twin for cycle 0 and NODE_CHURN churn
    cycles. Gates: the twins' bindings, failure lists and PodScheduled
    messages identical; kernel 1 once per serial window and in every wave,
    the round's R and route printed; one R = 5 round of the last cycle
    held against the plain round on the same tensors in both states
    (check_gpu_round); every bound GPU pod on a pool node, each card's
    gpu_core at most 100 and gpu_memory at most its total, the
    annotation's minor the probed one on a node whose Device CR names the
    probed uuid; why each pending GPU pod stays pending (explain_gpu_pending);
    the GPU outcome's hash the pinned one. Then each pool Daemon's
    run_once, timed. Returns the kernels' launches."""
    from koordinator_tpu_torch.client.store import KIND_DEVICE, KIND_NODE
    from koordinator_tpu_torch.manager import Manager
    from koordinator_tpu_torch.testing import gpu_pool

    retries0 = retries_now()
    arrivals = n_pods // 10
    worlds = []
    try:
        t0 = time.perf_counter()
        for _w in range(2):
            store, state = churn_store(n_nodes, n_pods, seed=42)
            pool = gpu_pool.pool_nodes(store, NODE_POOL)
            worlds.append((store, state, pool, gpu_pool.start_pool_agents(
                store, pool, state.now)))
            mgr = Manager(store, identity="node-agent", device=device)
            mgr.tick(now=state.now + 11)
            # the webhook refuses churn_store's LSR/koord-batch pods at bind
            # time (in the JAX package too): the replica stops
            mgr.stop(now=state.now + 11)
            gpu_pool.add_gpu_share_pods(store, gpu_pool.gpu_share_specs(
                NODE_GPU_PODS), state.now + 12)
        fixture_s = time.perf_counter() - t0
        (store, state, pool, agents), (twin_store, _s, _p, _a) = worlds
        devices = {d.meta.name: d for d in store.list(KIND_DEVICE)}
        if sorted(devices) != sorted(pool) or any(
                [(x.uuid, x.minor) for x in d.devices]
                != [(dev.uuid, dev.minor)] for d in devices.values()):
            raise AssertionError(f"node_agent: Device CRs {len(devices)}")
        totals = {n.meta.name: n.allocatable[ResourceName.GPU_CORE]
                  for n in store.list(KIND_NODE)
                  if n.allocatable[ResourceName.GPU_CORE]}
        if totals != {name: 100 for name in pool}:
            raise AssertionError(f"node_agent: GPU totals {totals}")
        sched = Scheduler(store, device=device)
        twin = Scheduler(twin_store, waves=1, device=device)
        rounds, captured = [], {}
        real_round = fck.full_chain_round

        def spy(fc, weight_idx, prod_mode, bal_idx, **kw):
            R = int(fc.base.fit_requests.shape[1])
            if (captured.get("armed") and R >= 5 and "fc" not in captured
                    and bool(((fc.base.fit_requests[:, 3:] > 0).any(1)
                              & fc.base.pod_valid).any())):
                captured.update(fc=clone_fc(fc), args=(
                    list(weight_idx), prod_mode, tuple(bal_idx)))
            out = real_round(fc, weight_idx, prod_mode, bal_idx, **kw)
            rounds.append((R, dict(fck.last_launch)))
            return out

        now = state.now + 15
        total = {"full_chain": 0, "full_chain_replay": 0}
        rows = []
        fck.full_chain_round = spy
        try:
            for c in range(1 + NODE_CHURN):
                if c:
                    specs = arrival_specs(c, arrivals)
                    for st in (store, twin_store):
                        add_arrivals(st, specs, now + c)
                t = now + 2 * c
                rounds.clear()
                # the last cycle's first R = 5 round with a GPU pod is
                # kept for check_gpu_round
                captured["armed"] = c == NODE_CHURN
                res, wall, la, k = wave_cycle(f"node_agent cycle {c}", sched,
                                              t)
                captured["armed"] = False
                twin_key = ([], [], [])
                twin_wall, twin_launches = 0.0, 0
                for _w in range(res.waves):
                    res_t, w, n, _gc = checked_cycle(
                        f"node_agent cycle {c} serial", twin, twin.run_cycle,
                        t)
                    twin_wall += w
                    twin_launches += n
                    for part, got in zip(twin_key, result_key(res_t)):
                        part.extend(got)
                if result_key(res) != twin_key:
                    raise AssertionError(f"node_agent cycle {c}: the twins "
                                         "disagree")
                for key in total:
                    total[key] += la[key]
                total["full_chain"] += twin_launches
                widths = sorted({r for r, _l in rounds})
                rows.append({"cycle": c, "K": k, "logical_cycles": res.waves,
                             "bound": len(res.bound),
                             "failed": len(res.failed),
                             "gpu_bound": sum(b.pod_key.startswith("gpu/")
                                              for b in res.bound),
                             "gpu_failed": sum(k.startswith("gpu/")
                                               for k in res.failed),
                             "cycle_ms": wall * 1e3,
                             "spans_ms": span_split(sched, WAVE_SPANS),
                             "twin_ms": twin_wall * 1e3, "launches": la,
                             "twin_launches": twin_launches, "R": widths,
                             "route": sorted({(l["state"], l["instance"])
                                              for _r, l in rounds})})
        finally:
            fck.full_chain_round = real_round
        sched.flush_deferred()
        if cycle_dump(sched) != cycle_dump(twin):
            raise AssertionError("node_agent: the final dumps differ")
        assert_ladder_full("node_agent", retries0, sched, twin)
        if not all(r["R"] for r in rows) or max(
                max(r["R"]) for r in rows) <= 3:
            raise AssertionError(f"node_agent: the GPU axes never reached "
                                 f"the round: R {[r['R'] for r in rows]}")
        if "fc" not in captured:
            raise AssertionError("node_agent: no R = 5 round in the last "
                                 "cycle")
        gpu_round = check_gpu_round(captured["fc"], *captured["args"])
        # DeviceShare's outcome on the pool
        used = {}
        gpu_pods = [p for p in store.list(KIND_POD)
                    if p.meta.namespace == "gpu"]
        for pod in gpu_pods:
            if not pod.spec.node_name:
                continue
            if pod.spec.node_name not in pool:
                raise AssertionError(f"node_agent: {pod.meta.key} on "
                                     f"{pod.spec.node_name}, off the pool")
            for alloc in gpu_pool.allocations(pod)["gpu"]:
                if alloc["minor"] != dev.minor:
                    raise AssertionError(f"node_agent: {alloc}")
                u = used.setdefault(pod.spec.node_name, [0, 0])
                u[0] += alloc["core"]
                u[1] += alloc["memory"]
        total_memory = dev.resources[ResourceName.GPU_MEMORY]
        if any(c > 100 or m > total_memory for c, m in used.values()):
            raise AssertionError(f"node_agent: a card overcommitted {used}")
        bound_gpu = sum(1 for p in gpu_pods if p.spec.node_name)
        if not 0 < bound_gpu < NODE_GPU_PODS:
            raise AssertionError(f"node_agent: {bound_gpu} of "
                                 f"{NODE_GPU_PODS} GPU pods bound")
        pending = explain_gpu_pending(
            twin, now + 2 * NODE_CHURN + 2, gpu_pods, pool,
            {name: u[0] for name, u in used.items()})
        outcome = gpu_outcome_hash(gpu_pods)
        if outcome != NODE_AGENT_OUTCOME:
            raise AssertionError(f"node_agent: the GPU outcome's hash "
                                 f"{outcome}, pinned {NODE_AGENT_OUTCOME}")
        # each pool Daemon's run_once, after the cycles (the pods are
        # bound), on a fresh /proc/stat sample
        run_once_ms = []
        for daemon, fs in agents[:NODE_RUN_ONCE_TIMED]:
            fs.set_proc("stat", "cpu  3000 0 3000 16000 0 0 0 0 0 0\n")
            t0 = time.perf_counter()
            daemon.run_once(now=now + 2 * NODE_CHURN + 4)
            run_once_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        for _st, _s2, _p2, ag in worlds:
            gpu_pool.cleanup(ag)
    emit({"phase": "node_agent", "nodes": n_nodes, "pods": n_pods,
          "pool": NODE_POOL, "gpu_pods": NODE_GPU_PODS,
          "gpu_core_asked": sum(s["gpu"] for s in gpu_pool.gpu_share_specs(
              NODE_GPU_PODS)),
          "churn_cycles": NODE_CHURN, "fixture_seconds": fixture_s,
          "run_once_ms_median": statistics.median(run_once_ms),
          "run_once_ms_max": max(run_once_ms),
          "gpu_pods_bound": bound_gpu, "cards_used": len(used),
          "gpu_core_used": sum(c for c, _m in used.values()),
          "gpu_outcome_sha256": outcome, "gpu_round": gpu_round,
          "gpu_pending": pending,
          "twins_identical_every_cycle": True, "final_dumps_identical": True,
          "ladder_full": True, "launches": total, "cycles": rows})
    return total


def check_gpu_round(fc, weight_idx, prod_mode, bal_idx):
    """Kernel 1 at R = 5 (cpu, memory, pods and the two GPU axes the
    GPU-share pods ask for) against the plain round on the same card
    tensors: chosen, requested and quota_used equal (0 mismatches, max
    |err| 0.0) with the carried state in shared memory where it fits and
    in device memory (budget 0); both launches on the generic instance.
    These launches are checks and count for no path."""
    R = int(fc.base.fit_requests.shape[1])
    valid = fc.base.pod_valid
    gpu_rows = int(((fc.base.fit_requests[:, 3:] > 0).any(1)
                    & valid).sum())
    if R != 5 or not gpu_rows:
        raise AssertionError(f"node_agent: the kept round has R {R} and "
                             f"{gpu_rows} GPU pods")
    N = int(fc.base.allocatable.shape[0])
    t0 = time.perf_counter()
    chosen_p, state_p = plain_round(fc, weight_idx, prod_mode, bal_idx)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain = (chosen_p, state_p[0], state_p[5])
    out = {"R": R, "P": int(valid.shape[0]), "pods": int(valid.sum()),
           "gpu_pods": gpu_rows, "N": N, "plain_s": plain_s,
           "pods_chosen": int((chosen_p >= 0).sum())}
    for budget in (None, 0):
        got = fck.full_chain_round(fc, weight_idx, prod_mode, bal_idx,
                                   smem_budget_bytes=budget)
        launch = dict(fck.last_launch)
        torch.cuda.synchronize()
        mism, err = compare(f"node_agent R = 5 budget {budget}", got, plain,
                            N)
        if launch["instance"] != "generic" or (
                budget == 0 and launch["state"] != "global"):
            raise AssertionError(f"node_agent: R = 5 at budget {budget} ran "
                                 f"{launch}")
        out["budget_0" if budget == 0 else "default"] = {
            "state": launch["state"], "instance": launch["instance"],
            "smem_bytes_per_block": launch["smem_bytes_per_block"],
            "mismatches": mism, "max_abs_err": err}
    return out


def explain_gpu_pending(twin, now, gpu_pods, pool, card_core):
    """Why each pending GPU pod stays pending. One more serial cycle of
    the twin (it must bind nothing) keeps its host batch
    (``encode_observer``); for every pending GPU pod and every pool node
    the scheduler's own diagnosis (scheduler/diagnose.py) gives the
    Filter stages that reject it. Gates: every (pod, pool node) pair is
    rejected; the GPU axes reject exactly where the card lacks the pod's
    gpu_core by the allocation annotations (``card_core``: the cores
    allocated per node), so DeviceShare's Filter refuses only full cards;
    each pod's PodScheduled message is the Filter breakdown, naming no
    device reason of DeviceShare's Reserve. Returns the split: pairs per
    set of rejecting stages, "insufficient resources" split into the GPU
    axes and cpu/memory/pods."""
    from koordinator_tpu_torch.scheduler.diagnose import (
        _stage_verdicts,
        shared_state,
    )

    batches = []
    twin.encode_observer = batches.append
    try:
        res, _w, _n, _gc = checked_cycle("node_agent diagnosis", twin,
                                         twin.run_cycle, now)
    finally:
        twin.encode_observer = None
    pending = [p for p in gpu_pods if not p.spec.node_name]
    if res.bound or sorted(res.failed) != sorted(
            p.meta.key for p in pending):
        raise AssertionError(f"node_agent diagnosis: {len(res.bound)} "
                             f"bound, {len(res.failed)} failed")
    fc = batches[-1]
    base = fc.base
    fit = np.asarray(base.fit_requests, np.float32)
    alloc = np.asarray(base.allocatable, np.float32)
    valid = np.asarray(base.pod_valid, bool)
    n = int(np.asarray(base.node_ok).shape[0])
    rows = np.flatnonzero(valid & (fit[:, 3:] > 0).any(1))
    cols = np.flatnonzero(alloc[:, 3] > 0)
    if fit.shape[1] != 5 or len(rows) != len(pending) or len(cols) != len(
            pool):
        raise AssertionError(f"node_agent diagnosis: R {fit.shape[1]}, "
                             f"{len(rows)} GPU rows, {len(cols)} GPU nodes")
    shared = shared_state(fc, n)
    req = shared["requested"]
    # the round's per-node gpu_core in use is DeviceShare's allocations
    core_in_use = sorted(int(v) for v in req[cols, 3])
    card_use = sorted(card_core.get(name, 0) for name in pool)
    if core_in_use != card_use:
        raise AssertionError("node_agent diagnosis: the round's gpu_core in "
                             "use differs from the allocation annotations")
    split = collections.Counter()
    for i in rows:
        _gang, _quota, reasons = _stage_verdicts(fc, int(i), n,
                                                 shared=shared)
        asks = fit[i][None, :] > 0
        short = asks & (req[cols] + fit[i][None, :] > alloc[cols])
        for j, col in enumerate(cols):
            stages = [label for label, bad in reasons.items()
                      if bad[col] and label != "insufficient resources"]
            if short[j, 3:].any():
                stages.append("GPU axes")
            if short[j, :3].any():
                stages.append("cpu/memory/pods")
            if not stages:
                raise AssertionError(f"node_agent diagnosis: pod row {i} "
                                     f"passes every Filter on node {col}")
            card_free = 100 - req[col, 3]
            if short[j, 3:].any() != (fit[i, 3] > card_free):
                raise AssertionError(f"node_agent diagnosis: the GPU axes "
                                     f"on node {col} with {card_free} "
                                     f"gpu_core free, pod asks {fit[i, 3]}")
            split[" + ".join(sorted(stages))] += 1
    for pod in pending:
        cond = pod.get_condition("PodScheduled")
        if (cond is None or cond.reason != "Unschedulable"
                or not cond.message.startswith("0/")
                or "gpu" in cond.message):
            raise AssertionError(f"node_agent: {pod.meta.key} pending with "
                                 f"{cond}")
    room = 100 - req[cols, 3] >= fit[rows, 3].min()
    numa = np.asarray(fc.numa_policy)[cols] != 0
    return {"pods": len(pending), "pairs": len(pending) * len(pool),
            "cards_with_room": int(room.sum()),
            "numa_policy_nodes": int(numa.sum()),
            "cards_with_room_on_numa_policy_nodes": int((room & numa).sum()),
            "split": dict(split.most_common())}


def gpu_outcome_hash(gpu_pods) -> str:
    """SHA-256 of the GPU pods' outcome: each pod's node, its allocations'
    (minor, core) and its PodScheduled message, in pod-key order. Card
    memory and uuid are left out, so the pin does not name one card."""
    from koordinator_tpu_torch.testing.gpu_pool import allocations

    rows = []
    for pod in sorted(gpu_pods, key=lambda p: p.meta.key):
        cores = [[a["minor"], a["core"]]
                 for a in allocations(pod).get("gpu", [])]
        cond = pod.get_condition("PodScheduled")
        rows.append([pod.meta.key, pod.spec.node_name, cores,
                     None if cond is None else cond.message])
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def run_demo():
    """The all-in-one demo, cmd.demo.main([]), in this process with its
    defaults (the card): exit 0, "demo complete", its BE pods bound
    through kernel 1 (the count rises) and their BE cgroup values read
    back from its FakeFS. The JAX package's demo binds 2 of its 3 BE pods
    (the batch allocatable fits two; tests/test_torch_node_cmd.py holds
    the port's log to the JAX one line for line). Returns kernel 1's
    launches."""
    import contextlib
    import io

    from koordinator_tpu_torch.cmd import demo

    err = io.StringIO()
    fck.launches = sk.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = demo.main([])
    wall = time.perf_counter() - t0
    log = err.getvalue().splitlines()
    bound = [ln for ln in log if ln.startswith("[koord-scheduler] bound")]
    enforced = "[koordlet] BE cgroups enforced: cfs_quota=200000 bvt=-1"
    if (rc != 0 or not log or not log[-1].startswith("demo complete")
            or len(bound) != 1 or not bound[0].startswith(
                "[koord-scheduler] bound 2 BE pods")
            or enforced not in log or fck.launches < 1 or sk.launches):
        raise AssertionError(f"demo: rc {rc}, launches {fck.launches}, "
                             f"log {log}")
    emit({"phase": "demo", "rc": rc, "wall_s": wall,
          "launches": {"full_chain": fck.launches}, "bound": bound[0],
          "cgroups": enforced})
    return fck.launches


def run_node_binaries(dev):
    """The koordlet binary (cmd.koordlet.main --fake-node, two ticks):
    exit 0 and its log's Device CR line naming the probed card; then the
    runtime proxy binary's CRI round trip (testing/cri.py
    binary_roundtrip)."""
    import contextlib
    import io

    from koordinator_tpu_torch.cmd import koordlet
    from koordinator_tpu_torch.testing.cri import binary_roundtrip

    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = koordlet.main(["--fake-node", "--max-ticks", "2",
                            "--interval", "0"])
    koordlet_s = time.perf_counter() - t0
    log = err.getvalue().splitlines()
    want = f"koordlet: Device CR gpu/{dev.minor}/{dev.uuid}"
    if rc != 0 or want not in log:
        raise AssertionError(f"node_binaries: koordlet rc {rc}, log {log}")
    t0 = time.perf_counter()
    cri = binary_roundtrip()
    cri_s = time.perf_counter() - t0
    emit({"phase": "node_binaries", "koordlet_rc": rc,
          "koordlet_s": koordlet_s, "device_cr": want,
          "cri_s": cri_s, **cri})


# ---------------------------------------------------------------------------
# the mesh (parallel/): virtual shards of this card
# ---------------------------------------------------------------------------

# the mesh phases' shards of the card (the fault-ladder scenario's own mesh
# is its catalog's 2)
MESH_SHARDS = 2
# koordinator_tpu.sim's fault-ladder (72 catalog cycles, seed 13) on the
# CPU; tests/test_torch_sim.py pins it too
FAULT_LADDER_JAX_SHA256 = ("e34631b68f3dd0bfa18371c00836b6e2583dea074009b6f0a"
                           "3b0e82a5f2acb26")
FAULT_LADDER_WALK = [
    ("full", "partial-mesh"), ("partial-mesh", "full"), ("full", "no-mesh"),
    ("no-mesh", "full"), ("full", "no-mesh"), ("no-mesh", "serial-waves"),
    ("serial-waves", "no-explain"), ("no-explain", "host-fallback"),
    ("host-fallback", "no-explain"), ("no-explain", "serial-waves"),
    ("serial-waves", "no-mesh"), ("no-mesh", "full")]


class mesh_env:
    """KOORD_TORCH_VIRTUAL_DEVICES and KOORD_TPU_MESH set for the block
    (the knobs a standalone descheduler or manager reads), then
    restored."""

    def __init__(self, shards: int) -> None:
        self.values = {"KOORD_TORCH_VIRTUAL_DEVICES": str(shards),
                       "KOORD_TPU_MESH": str(shards)}
        self.saved = {}

    def __enter__(self):
        for k, v in self.values.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_mesh_round(fc, args, ng, ngroups, active, n_real, la_inputs):
    """The sharded full-chain step (explain "full") and the sharded
    LoadAware step at D = 1, 2, 3, 4 and 8 virtual shards of the card,
    each against the single-device launches on the same (padded) tensors:
    config 4's batch and the LoadAware headline's (testing/mesh_round.py).
    0 mismatches, CUDA events median of 10. These launches compare and are
    not counted on the main path. Returns the sharded times by depth."""
    rows = mesh_round.check_full_chain(fc, args, ng, ngroups, active,
                                       n_real)
    la_rows = mesh_round.check_schedule(la_inputs, args)
    x_rows = mesh_round.check_exchange(fc, args, ng, ngroups, active, n_real,
                                       la_inputs)
    timeout = mesh_round.check_timeout(fc, args, active)
    deadline = mesh_round.check_deadline(fc, args, active)
    path = mesh_round.check_sharded_exchange(fc, args, ng, ngroups, active,
                                             n_real, la_inputs)
    for row in rows + x_rows + [timeout, deadline, path]:
        bad = {k: v for k, v in row.items()
               if k.endswith("mismatches") and v}
        if bad:
            raise AssertionError(f"mesh_round D={row.get('depth')}: {bad}")
    for row in la_rows:
        if row["mismatches"]:
            raise AssertionError(f"mesh_round loadaware D={row['depth']}: "
                                 f"{row['mismatches']} mismatches")
    if timeout["seconds"] > 2 * timeout["timeout_s"] + 1.0:
        raise AssertionError(f"mesh_round: the timeout took {timeout}")
    emit({"phase": "mesh_round", "full_chain": rows, "loadaware": la_rows,
          "exchange": x_rows, "timeout": timeout, "deadline": deadline,
          "exchange_path": path,
          "mismatches": 0})
    return {
        "full_chain": {str(r["depth"]): r["sharded_ms"] for r in rows},
        "schedule_step": {str(r["depth"]): r["sharded_ms"]
                          for r in la_rows},
        "exchange": x_rows[0], "path": path}


# the mesh_procs phase: two processes time-slice one card, so each
# exchange waits for the other process's slice: the mailbox round trip
# between two processes on the card took 4.475 ms (NVIDIA H100 80GB HBM3,
# 700.00 W; testing/mailbox_rtt.ipc_round_trip), against 568.9 ns in one
# launch: ~2.24 ms an exchange (one a valid pod at config 4). The phase
# runs ~27 rounds of kernels 1 and 2 (timing included), so 256 of config
# 4's 10,240 pods keep its exchanges near 15 s and the phase near 30 s.
P_XPROC = 256
XPROC_REPS = 3  # timed calls of each instance, after a warm-up
XPROC_TIMEOUT_S = 300
XPROC_CHECKS = ("rtt", "round", "replay", "counts", "loadaware", "matrix",
                "waves", "timeout")


def run_mesh_procs(state, args, n_real, la_inputs):
    """The mesh of cards across processes on the one card (the
    mesh_procs phase): the batch written once, two worker processes
    (testing/xproc_cards.py) run the checks through the mesh's entry
    points, and this process holds their outputs against the single-card
    kernels on the same padded tensors. Raises on any mismatch, a
    digest that differs, a child's failure or timeout, or a child on
    another card. Returns the children's summed launches, their times and
    the round trip."""
    tmp = tempfile.mkdtemp(prefix="koord_xproc_")
    try:
        t0 = time.perf_counter()
        data = xproc_cards.batch_data(state, args, n_real, P_XPROC,
                                      la_inputs=la_inputs)
        path = os.path.join(tmp, "data.pkl")
        xproc_cards.write_data(path, data)
        data_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs = xproc_cards.launch(2, path, os.path.join(tmp, "out"),
                                  XPROC_CHECKS, reps=XPROC_REPS,
                                  timeout_s=XPROC_TIMEOUT_S)
        procs_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref = mesh_round.reference(data, XPROC_CHECKS, 2, "cuda")
    res = mesh_round.compare(ref, outs, 2)
    if res["total"]:
        raise AssertionError(f"mesh_procs: mismatches "
                             f"{ {k: v for k, v in res['mismatches'].items() if v} }")
    if res["digests"] != [res["reference_digest"]]:
        raise AssertionError(f"mesh_procs: digests {res['digests']}, the "
                             f"single card's {res['reference_digest']}")
    limit = 2 * EXCHANGE_TIMEOUT_S + 1.0
    timeouts = [o["extra"]["timeout"] for o in outs]
    for t in timeouts:
        if t["failed_shards"] != [1] or t["seconds"] > limit:
            raise AssertionError(f"mesh_procs: the timeout took {t}")
    if timeouts[0]["message"] != timeouts[1]["message"]:
        raise AssertionError(f"mesh_procs: the processes named the timeout "
                             f"differently: {timeouts}")
    launches = collections.Counter()
    for o in outs:
        launches.update(o["launches"])
    for key in ("full_chain_kernel.xchg_launches",
                "full_chain_kernel.xchg_terms_launches",
                "full_chain_kernel.xchg_replay_launches",
                "explain_kernel.shard_launches",
                "schedule_kernel.xchg_launches"):
        if launches[key] < 2:
            raise AssertionError(f"mesh_procs: {key} {launches[key]}")
    rtt = outs[0]["extra"]["rtt"]
    row = {"phase": "mesh_procs", "processes": 2, "pods": P_XPROC,
           "cards": outs[0]["extra"]["mesh"]["cards"],
           "bus_ids": [o["extra"]["mesh"]["bus_ids"] for o in outs],
           "digest": res["reference_digest"], "mismatches": 0,
           "outputs": len(res["mismatches"]),
           "bound": int((ref["rep"]["round.chosen"] >= 0).sum()),
           "round_trip_ns": rtt["round_trip_ns"], "rtt": rtt,
           "times": [o["times"] for o in outs],
           "timeout": timeouts, "launches": dict(launches),
           "children_seconds": [o["extra"]["seconds"] for o in outs],
           "data_seconds": data_s, "processes_seconds": procs_s}
    if row["bound"] < P_XPROC // 2:
        raise AssertionError(f"mesh_procs: {row['bound']} pods bound")
    emit(row)
    return {"launches": dict(launches), "times": outs[0]["times"],
            "round_trip_ns": rtt["round_trip_ns"]}


def run_scheduler_xchg(device, waves_sha, n_nodes=5000, n_pods=10000):
    """Config 4's churn store through Scheduler(store, mesh=2 virtual cards
    of the card, exchanging) on the default path, through the cycles
    scheduler_waves ran: every wave's round in kernel 1's exchange
    instance and its replay in the per-card replay (``xchg_churn``); the
    outcome's SHA-256 must equal the single-device default path's. Then
    the same churn with pipeline_parity's parity transformer (a
    DeviceScoreTransformer) registered, on 2 exchanging virtual cards and
    on one card: the two SHA-256 must be equal. Returns the exchange
    launches of the plain and the transformer run, and the one-card
    transformer run's launches."""
    retries0 = retries_now()
    mesh = mesh_round.exchanging_mesh(MESH_SHARDS, device)
    sha, rows, total, fixture_s = xchg_churn("scheduler_xchg", device, mesh,
                                             n_nodes, n_pods)
    if sha != waves_sha:
        raise AssertionError(f"scheduler_xchg: outcome {sha} is not the "
                             f"single-device default path's {waves_sha}")
    tf = {}
    for tag, mesh_ in (("one_card", None),
                       ("xchg", mesh_round.exchanging_mesh(MESH_SHARDS,
                                                           device))):
        tf[tag] = dict(zip(("outcome_sha256", "cycles", "launches",
                            "fixture_seconds"),
                           xchg_churn(f"scheduler_xchg transformer {tag}",
                                      device, mesh_, n_nodes, n_pods,
                                      transformer=True)))
    if tf["xchg"]["outcome_sha256"] != tf["one_card"]["outcome_sha256"]:
        raise AssertionError(f"scheduler_xchg: the transformer churn on 2 "
                             f"exchanging virtual cards is not its one-card "
                             f"twin's: {tf}")
    assert_ladder_full("scheduler_xchg", retries0)
    emit({"phase": "scheduler_xchg", "shards": MESH_SHARDS,
          "nodes": n_nodes, "pods": n_pods, "fixture_seconds": fixture_s,
          "cycles": rows, "outcome_sha256": sha,
          "equals_scheduler_waves": True, "launches": total,
          "transformer": tf, "transformer_equals_one_card": True,
          "transformer_moved_outcome": (
              tf["one_card"]["outcome_sha256"] != waves_sha)})
    return total, tf["xchg"]["launches"], tf["one_card"]["launches"]


def xchg_churn(tag, device, mesh, n_nodes, n_pods, transformer=False):
    """Config 4's churn store through the default path (auto waves, replay
    overlap) for the cycles scheduler_waves ran, with the parity
    transformer registered when ``transformer``: on ``mesh`` (an
    exchanging mesh: exchange launches, no single-device launch) or on one
    card (``mesh`` None: single-device launches, no exchange launch).
    Every launch count is set to 0 before each cycle and read after; no
    node row is gathered, no cycle demotes, the ladder stays full.
    Returns (the outcome's SHA-256, the cycles' rows, the launches, the
    fixture's seconds)."""
    arrivals = n_pods // 10
    t0 = time.perf_counter()
    store, state = churn_store(n_nodes, n_pods, seed=42)
    sched = (Scheduler(store, device=device) if mesh is None
             else Scheduler(store, device=device, mesh=mesh))
    if transformer:
        sched.extender.register_transformer(
            pipeline_parity._make_parity_transformer())
    fixture_s = time.perf_counter() - t0
    if sched.mesh is not mesh or (mesh is not None and not mesh.exchange) or (
            sched.waves_spec != "auto" or not sched.replay_overlap):
        raise AssertionError(f"{tag}: not the default path")
    now = state.now
    keys, rows = [], []
    total = collections.Counter()
    for c, specs, created, t in churn_schedule(
            now, WAVE_CHURN_WARMUP + WAVE_CHURN_MEASURED, arrivals):
        add_arrivals(store, specs, created)
        zero_mesh_launches()
        cross_card.zero_xchg_launches()
        t0 = time.perf_counter()
        with cross_card.no_gather():
            res = sched.run_cycle(now=t)
        wall = time.perf_counter() - t0
        la = {**mesh_launches_now(), "schedule_step": sk.launches,
              **cross_card.xchg_launches()}
        kspan = last_cycle_root(sched).find("kernel")
        k = int(kspan.attributes.get("waves", "1")) if kspan else 1
        single = la["full_chain"] + la["full_chain_replay"]
        if mesh is None:
            wrong = la["full_chain_xchg"] or not single
        else:
            wrong = (la["full_chain_xchg"] < 1 or single or la["schedule_step"]
                     or (k > 1 and la["full_chain_xchg_replay"] < 1))
        if sched.last_backend != "cuda" or res.demotions or wrong:
            raise AssertionError(f"{tag} cycle {c}: K {k}, backend "
                                 f"{sched.last_backend}, demotions "
                                 f"{res.demotions}, launches {la}")
        keys.append(result_key(res))
        total.update(la)
        rows.append({"cycle": c, "K": k, "logical_cycles": res.waves,
                     "bound": len(res.bound), "launches": la,
                     "cycle_ms": wall * 1e3,
                     "spans_ms": span_split(sched, WAVE_SPANS)})
    sched.flush_deferred()
    if sched.ladder.level != 0 or sched.ladder.transitions:
        raise AssertionError(f"{tag}: the ladder moved: "
                             f"{sched.ladder.transitions}")
    return outcome_sha(keys, store), rows, dict(total), fixture_s


def mesh_launches_now() -> dict:
    return {"full_chain": fck.launches,
            "full_chain_replay": fck.replay_launches,
            "explain_counts": ek.launches,
            "full_chain_terms": fck.terms_launches}


def zero_mesh_launches() -> None:
    fck.launches = fck.replay_launches = 0
    fck.terms_launches = ek.launches = sk.launches = 0


def run_scheduler_mesh(device, waves_sha, n_nodes=5000, n_pods=10000):
    """Config 4's churn store through Scheduler(store, mesh=2 virtual shards
    of the card) on the default path (auto waves, replay overlap): the
    sharded upload, the sharded chained step (every wave's node fields
    gathered into kernel 1 and the replay kernel) and the per-shard
    readback merge, through the cycles scheduler_waves ran. Its bindings, failed and
    rejected lists and PodScheduled conditions must hash to the
    single-device default path's SHA-256 (no new twin)."""
    arrivals = n_pods // 10
    retries0 = retries_now()
    t0 = time.perf_counter()
    store, state = churn_store(n_nodes, n_pods, seed=42)
    sched = Scheduler(store, device=device,
                      mesh=mesh_round.virtual_mesh(MESH_SHARDS, device))
    fixture_s = time.perf_counter() - t0
    if sched.mesh is None or sched.mesh.size != MESH_SHARDS or (
            sched.waves_spec != "auto" or not sched.replay_overlap):
        raise AssertionError("scheduler_mesh: not the default path on a "
                             "mesh")
    now = state.now
    keys, rows, walls = [], [], []
    total = {"full_chain": 0, "full_chain_replay": 0}
    for c, specs, created, t in churn_schedule(
            now, WAVE_CHURN_WARMUP + WAVE_CHURN_MEASURED, arrivals):
        add_arrivals(store, specs, created)
        res, wall, la, k = wave_cycle(f"scheduler_mesh cycle {c}", sched, t)
        if not any(sched.mesh.tag in key for key in sched._step_cache):
            raise AssertionError(f"scheduler_mesh cycle {c}: no step built "
                                 "for the mesh")
        keys.append(result_key(res))
        for key in ("full_chain", "full_chain_replay"):
            total[key] += la[key]
        rows.append({"cycle": c, "K": k, "logical_cycles": res.waves,
                     "bound": len(res.bound), "launches": la,
                     "cycle_ms": wall * 1e3,
                     "spans_ms": span_split(sched, WAVE_SPANS)})
        if c > WAVE_CHURN_WARMUP:
            walls.append(wall)
    sched.flush_deferred()
    sha = outcome_sha(keys, store)
    if sha != waves_sha:
        raise AssertionError(f"scheduler_mesh: outcome {sha} is not the "
                             f"single-device default path's {waves_sha}")
    assert_ladder_full("scheduler_mesh", retries0, sched)
    emit({"phase": "scheduler_mesh", "shards": MESH_SHARDS,
          "nodes": n_nodes, "pods": n_pods,
          "fixture_seconds": fixture_s, "cycles": rows,
          "cycle_ms": statistics.median(walls) * 1e3,
          "outcome_sha256": sha, "equals_scheduler_waves": True,
          "launches": total})
    return total


def run_fault_ladder(device):
    """The sim's fault-ladder scenario on the card: mesh = 2 virtual shards
    of the card, fused waves, explain counts, a 150 ms dispatch deadline; a
    device loss naming shard 1 (partial-mesh), a slow device (the
    watchdog's no-mesh), an anonymous storm down to the host fallback, a
    crash-restart. Its binding log must hash to the JAX package's, its
    ladder walk be the plan's."""
    zero_mesh_launches()
    t0 = time.perf_counter()
    card = run_scenario(SCENARIOS["fault-ladder"], device=device)
    card_s = time.perf_counter() - t0
    launches = mesh_launches_now()
    walk = [(t["from"], t["to"]) for t in card.ladder_transitions]
    if card.binding_log_sha256 != FAULT_LADDER_JAX_SHA256:
        raise AssertionError(f"fault_ladder: {card.binding_log_sha256} is "
                             f"not the JAX package's {FAULT_LADDER_JAX_SHA256}")
    if walk != FAULT_LADDER_WALK:
        raise AssertionError(f"fault_ladder: walk {walk}")
    if card.invariant_breaches or card.cycle_exceptions or (
            card.deadline_overruns != 2):
        raise AssertionError(
            f"fault_ladder: {card.invariant_breaches[:3]} "
            f"{card.cycle_exceptions[:3]} overruns {card.deadline_overruns}")
    if device == "cuda" and (launches["full_chain"] < 1
                             or launches["explain_counts"] < 1):
        raise AssertionError(f"fault_ladder: no launch: {launches}")
    emit({"phase": "fault_ladder", "cycles": card.cycles,
          "sha256": card.binding_log_sha256, "jax_sha256_equal": True,
          "transitions": walk, "cycles_at_level": card.cycles_at_level,
          "deadline_overruns": card.deadline_overruns,
          "bindings": len(card.binding_log), "card_seconds": card_s,
          "launches": launches})
    return launches


# koordinator_tpu.sim.racecheck's run_racecheck(preempt_seed=101) on the
# CPU over racecheck_scenario(24) at waves=2 (the catalog's smoke
# dispatches serially, and its waves=1 log, eda59ef2..., never reaches the
# replay kernel); tests/test_torch_racecheck_gate.py pins both
RACECHECK_WAVES_JAX_SHA256 = ("97ba4807280ecd6a3c756daa5ddfa9e98e077eb9936e"
                              "2f40af3e5d86d6d64bb8")
RACECHECK_SEEDS = (101, 202)
RACECHECK_CYCLES = 24
# the gate's fused waves on the card (the catalog's serial dispatch at
# both seeds, then a third run at waves=2, until the script's time limit)
RACECHECK_WAVES = 2


def run_racecheck(device):
    """koordrace's gate on the card: check_races at both preemption seeds
    at RACECHECK_WAVES (the chained dispatch: kernel 1 and its replay
    instance), over one rung index (the second seed's background ladder
    replays the first's rungs while its first cycles dispatch). Fails on
    any failure class of the gate, a binding log that is not the JAX
    package's, a second seed whose ladder warmed nothing, or a phase that
    launched neither kernel 1 nor the replay kernel."""
    from koordinator_tpu_torch.sim.racecheck import check_races

    # the threads the earlier phases left behind: the harness traces only
    # the ones it starts, the others still take the GIL when they wake
    left = collections.Counter(t.name.rstrip("0123456789-_ ")
                               for t in threading.enumerate())
    zero_mesh_launches()
    t0 = time.perf_counter()
    gate = check_races(seeds=RACECHECK_SEEDS, cycles=RACECHECK_CYCLES,
                       device=device, waves=RACECHECK_WAVES)
    phase_s = time.perf_counter() - t0
    launches = mesh_launches_now()
    if gate.failures:
        raise AssertionError("racecheck: " + "; ".join(gate.failures[:10]))
    shas = [r.binding_log_sha256 for r in gate.reports]
    if shas != [RACECHECK_WAVES_JAX_SHA256] * len(RACECHECK_SEEDS):
        raise AssertionError(f"racecheck: binding logs {shas}, not the JAX "
                             f"package's {RACECHECK_WAVES_JAX_SHA256}")
    if gate.reports[-1].warmup.get("warmed", 0) < 1:
        raise AssertionError(f"racecheck: the second seed's ladder warmed "
                             f"nothing: {gate.reports[-1].warmup}")
    if launches["full_chain"] < 1 or launches["full_chain_replay"] < 1:
        raise AssertionError(f"racecheck: no launch: {launches}")
    emit({"phase": "racecheck", "cycles": RACECHECK_CYCLES,
          "waves": RACECHECK_WAVES,
          "runs": [{"seed": r.preempt_seed, "bindings": r.bindings,
                    "sha256": r.binding_log_sha256,
                    "touches": r.touches, "preemptions": r.preemptions,
                    "scrapes": r.scrapes, "unchecked": r.unchecked,
                    "witnesses": len(r.witnesses),
                    "order_violations": len(r.order_violations),
                    "scrape_errors": len(r.scrape_errors),
                    "warmup": r.warmup}
                   for r in gate.reports],
          "static_findings": len(gate.static), "jax_sha256_equal": True,
          "launches": launches, "threads_before": dict(left),
          "seconds": phase_s})
    return launches


# the pack_overlap phase's time limits (their share of the run's 1200 s):
# the harness's own world, and config 4's churn world with its churn
# rounds after cycle 0 (14.1 s on an H100 80GB HBM3 at 700 W: about three
# times that, for a host 1.3x slower and the spread of its cycle-0 packs)
PACK_OVERLAP_LIMIT_S = 20.0
PACK_OVERLAP_CONFIG4_LIMIT_S = 45.0
PACK_OVERLAP_CONFIG4_ROUNDS = 2


def run_pack_overlap(device):
    """The pack-overlap gate on the card: scheduler/pipeline_parity's
    run_pack_overlap_parity at its own world (24 nodes, 70 pods, 4
    rounds of churn) at waves 1 and 4, then on config 4's churn store
    (churn_store(5000, 10000, seed=42)) with its arrivals (1000 a round,
    PACK_OVERLAP_CONFIG4_ROUNDS rounds after cycle 0) at the Scheduler's
    default waves — the cycle that pre-packs the next cycle's pod rows
    inside the device window against its gap-pack twin, every uploaded
    FullChainInputs array byte for byte (by its SHA-256). Fails on any
    mismatch, on a run that compared no encode, pre-packed no row or
    logged a failed pre-pack (either leaves the overlap world packing
    cold in the gap, the twin's path), on no round kernel launched, past
    PACK_OVERLAP_LIMIT_S for the small world and past
    PACK_OVERLAP_CONFIG4_LIMIT_S for config 4."""
    zero_mesh_launches()
    t0 = time.perf_counter()
    reports = [pipeline_parity.run_pack_overlap_parity(waves=w,
                                                       device=device)
               for w in (1, 4)]
    phase_s = time.perf_counter() - t0
    launches = mesh_launches_now()

    def world():
        store, state = churn_store(CONFIG4_NODES, CONFIG4_PODS, seed=42)
        return state, store

    zero_mesh_launches()
    t0 = time.perf_counter()
    reports.append(pipeline_parity.run_pack_overlap_parity(
        waves=None, rounds=PACK_OVERLAP_CONFIG4_ROUNDS, device=device,
        world=world, churn_arrivals=CONFIG4_PODS // 10))
    config4_s = time.perf_counter() - t0
    config4_launches = mesh_launches_now()
    for rep in reports:
        if (not rep["ok"] or rep["encodes_compared"] < 1
                or rep["prepacked_rows"] < 1 or rep["prepack_failures"]):
            raise AssertionError(
                f"pack_overlap: waves={rep['waves']}: "
                f"{rep['mismatches'][:4]} ({rep['encodes_compared']} "
                f"encodes, {rep['prepacked_rows']} rows pre-packed, "
                f"{rep['prepack_failures']} pre-packs failed)")
    if launches["full_chain"] < 1 or config4_launches["full_chain"] < 1:
        raise AssertionError(f"pack_overlap: no launch: {launches}, "
                             f"config 4 {config4_launches}")
    if phase_s > PACK_OVERLAP_LIMIT_S:
        raise AssertionError(f"pack_overlap: {phase_s:.1f} s, over "
                             f"{PACK_OVERLAP_LIMIT_S} s")
    if config4_s > PACK_OVERLAP_CONFIG4_LIMIT_S:
        raise AssertionError(f"pack_overlap: config 4 took {config4_s:.1f} "
                             f"s, over {PACK_OVERLAP_CONFIG4_LIMIT_S} s")
    emit({"phase": "pack_overlap",
          "runs": [{k: rep[k] for k in ("waves", "rounds", "pods",
                                        "conditions_checked",
                                        "encodes_compared",
                                        "prepacked_rows")}
                   for rep in reports],
          "mismatches": 0, "launches": launches, "seconds": phase_s,
          "config4_launches": config4_launches,
          "config4_seconds": config4_s})


def run_rebalance_mesh(device, n_pods=50_000, n_nodes=5_000):
    """BASELINE config 5 through a standalone Descheduler whose pass runs
    on KOORD_TPU_MESH=2 virtual shards of the card, beside a single-device
    Descheduler on an identical store: the device passes' victims (order
    included), classification and margins, then run_once's migration
    jobs, must be equal."""
    from koordinator_tpu_torch.descheduler.descheduler import Descheduler
    from koordinator_tpu_torch.testing.rebalance_fixture import (
        rebalance_store,
    )

    now = 1_000_000.0
    t0 = time.perf_counter()
    store_s, store_m = (rebalance_store(n_pods, n_nodes, now)
                        for _ in range(2))
    fixture_s = time.perf_counter() - t0
    single = Descheduler(store_s, device=device, rebalance="on")
    with mesh_env(MESH_SHARDS):
        meshed = Descheduler(store_m, device=device, rebalance="on")
    reb_s, reb_m = single.rebalancer, meshed.rebalancer
    if reb_s.mesh is not None or reb_m.mesh is None or (
            reb_m.mesh.size != MESH_SHARDS):
        raise AssertionError("rebalance_mesh: the meshes are not 0 and 2")
    plug_s = single.profiles[0].balance_plugins[0].inner
    plug_m = meshed.profiles[0].balance_plugins[0].inner
    view_s, _src = plug_s._view(now)
    view_m, _src = plug_m._view(now)
    ms_s, ms_m = [], []
    for i in range(1 + 3):
        t0 = time.perf_counter()
        picked_s, stats_s = reb_s.select_victims(plug_s, view_s, now)
        ms_s.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        picked_m, stats_m = reb_m.select_victims(plug_m, view_m, now)
        ms_m.append((time.perf_counter() - t0) * 1e3)
        if stats_s["engine"] != "device" or stats_m["engine"] != "device":
            raise AssertionError(f"rebalance_mesh pass {i}: engines "
                                 f"{stats_s['engine']} {stats_m['engine']}")
        if picked_s.tolist() != picked_m.tolist():
            raise AssertionError(f"rebalance_mesh pass {i}: victims differ")
        for key in ("is_low", "is_high", "margin", "victim_nodes",
                    "victim_scores"):
            if not np.array_equal(stats_s[key], stats_m[key]):
                raise AssertionError(f"rebalance_mesh pass {i}: {key}")
    single.run_once(now=now)
    meshed.run_once(now=now)
    jobs_s, jobs_m = job_list(store_s), job_list(store_m)
    if not jobs_s or jobs_s != jobs_m:
        raise AssertionError(f"rebalance_mesh: {len(jobs_s)} single-device "
                             f"jobs against {len(jobs_m)} on the mesh, or "
                             "another order")
    emit({"phase": "rebalance_mesh", "shards": MESH_SHARDS,
          "pods": n_pods, "nodes": n_nodes, "fixture_seconds": fixture_s,
          "victims": int(picked_m.size), "jobs": len(jobs_m),
          "pass_ms": ms_m[1:], "single_device_pass_ms": ms_s[1:],
          "pass_ms_median": statistics.median(ms_m[1:]),
          "single_device_pass_ms_median": statistics.median(ms_s[1:]),
          "victims_equal": True, "jobs_equal": True})


def run_colo_mesh(device, n_nodes=5000, n_pods=10000):
    """Config 4's colo world through a standalone Manager whose pass runs
    on KOORD_TPU_MESH=2 virtual shards of the card, beside a single-device
    Manager on an identical store: every tick's published batch/mid
    integers and degraded set must be equal."""
    from koordinator_tpu_torch.manager import Manager

    t0 = time.perf_counter()
    store_s, state = colo_store(n_nodes, n_pods)
    store_m, _ = colo_store(n_nodes, n_pods)
    fixture_s = time.perf_counter() - t0
    single = Manager(store_s, identity="colo-single", device=device)
    with mesh_env(MESH_SHARDS):
        meshed = Manager(store_m, identity="colo-mesh", device=device)
    if meshed.colo.mesh is None or meshed.colo.mesh.size != MESH_SHARDS:
        raise AssertionError("colo_mesh: the pass is not on the mesh")
    now = state.now
    for k in range(COLO_WARMUP + 3):
        now += 10.0
        for s_ in (store_s, store_m):
            shift_metrics(s_, k, now)
        checked_colo_tick(f"colo_mesh tick {k}", meshed, single, now)
        if single.colo.last_pass_stats.get("engine") != "device":
            raise AssertionError(f"colo_mesh tick {k}: the single-device "
                                 "twin left the card")
    ms_m = [ms for ms, _ in colo_roots(meshed)][COLO_WARMUP:]
    ms_s = [ms for ms, _ in colo_roots(single)][COLO_WARMUP:]
    emit({"phase": "colo_mesh", "shards": MESH_SHARDS, "nodes": n_nodes,
          "pods": n_pods, "fixture_seconds": fixture_s,
          "pass_ms": ms_m, "single_device_pass_ms": ms_s,
          "device_passes": meshed.colo.stats["device_passes"],
          "writes_equal": True})


def explain_entry(name, source, replaces, key, launches, res):
    """The kernels-line entry of one koordexplain kernel: its launches on
    the main path's explain phases (``key`` in each phase's counts, split
    by phase) and its explain_round numbers."""
    per_phase = {phase: la[key] for phase, la in launches.items()}
    return kernel_entry(
        name, source, replaces, sum(per_phase.values()), res["mismatches"],
        res["err"], res["ms"], res["plain_ms"], res["bytes_ms"],
        res["ops_ms"], ms_P1280=res["ms_P1280"],
        **{f"launches_{phase}": n for phase, n in per_phase.items()})


def xchg_entries(sharded_ms, sched_launches, bytes_ms, ops_ms, la_kernel,
                 replay_entry, count_res, more_launches, procs):
    """The kernels-line entries of the instances over a mesh of cards.
    Their launches: the scheduler_xchg phase's (the default path on 2
    exchanging virtual cards: kernel 1's exchange round, the per-card
    replay), ``more_launches``' (phase -> its launches on the exchange
    route: the transformer churn, the carried worlds) and the sharded
    steps' run in mesh_round (the terms instance, the per-card stage
    counts, kernel 2's exchange instance); ms: the
    CUDA-event medians at D = 2 (testing/mesh_round.check_exchange);
    plain_ms and the errors: the plain versions on the card on the first
    PLAIN_PODS valid pods (check_sharded_exchange, ``plain_pods``; the
    stage counts on every pod). The work is the single-device kernels', so
    are the bounds. ``procs``: mesh_procs' two processes' summed launches
    (``launches_mesh_procs``) and their times (``ms_mesh_procs``, at
    P_XPROC pods)."""
    x, path = sharded_ms["exchange"], sharded_ms["path"]
    la = path["launches"]
    common = {"plain_pods": path["plain_pods"], "shards": x["depth"]}
    kbytes = (bytes_ms, ops_ms)
    rbound = replay_entry["bound_ms"]
    rbound = ((rbound, 0.0) if replay_entry["bound_by"] == "bytes"
              else (0.0, rbound))
    lbound = la_kernel["bound_ms"]
    lbound = ((lbound, 0.0) if la_kernel["bound_by"] == "bytes"
              else (0.0, lbound))
    cbound = ((count_res["bytes_ms"], count_res["ops_ms"]))

    def more(key):
        split = {f"launches_{ph}": la_[key]
                 for ph, la_ in more_launches.items()}
        return sum(split.values()), split

    more_round, split_round = more("full_chain_xchg")
    more_replay, split_replay = more("full_chain_xchg_replay")
    pl, pt = procs["launches"], procs["times"]
    xp = {"pods_mesh_procs": P_XPROC,
          "round_trip_ns_mesh_procs": procs["round_trip_ns"]}
    return [
        kernel_entry(
            "full_chain_round_xchg", "full_chain.cu",
            "koordinator_tpu/ops/pallas_full_chain.py:90 (over a mesh of "
            "cards: parallel/full_chain_mesh.py:82)",
            sched_launches["full_chain_xchg"] + la[
                "full_chain_kernel.xchg_launches"] + more_round
            + pl["full_chain_kernel.xchg_launches"],
            path["round_plain_mismatches"], path["round_err"],
            x["round_xchg_ms"], path["round_plain_ms"], *kbytes,
            launches_scheduler_xchg=sched_launches["full_chain_xchg"],
            launches_sharded_step=la["full_chain_kernel.xchg_launches"],
            launches_mesh_procs=pl["full_chain_kernel.xchg_launches"],
            ms_mesh_procs=pt["round_ms"], ms_mesh_procs_waves=pt["waves_ms"],
            **xp, **split_round, ms_single=x["round_single_ms"], **common),
        kernel_entry(
            "full_chain_terms_xchg", "full_chain.cu",
            "koordinator_tpu/models/full_chain.py:549 (the explain=full body "
            "of the XLA serial step, no TPU kernel), over a mesh of cards",
            la["full_chain_kernel.xchg_terms_launches"]
            + pl["full_chain_kernel.xchg_terms_launches"],
            path["terms_plain_mismatches"], path["round_err"],
            x["terms_xchg_ms"], path["round_plain_ms"], *kbytes,
            launches_mesh_procs=pl["full_chain_kernel.xchg_terms_launches"],
            ms_mesh_procs=pt["terms_ms"], **xp,
            ms_single=x["terms_single_ms"], **common),
        kernel_entry(
            "replay_by_node_cards", "replay_by_node.cu",
            "koordinator_tpu/models/fused_waves.py:559 (the kept-only "
            "replay, an XLA fori_loop, no TPU kernel), per card",
            sched_launches["full_chain_xchg_replay"] + more_replay
            + pl["full_chain_kernel.xchg_replay_launches"],
            path["replay_plain_mismatches"], path["replay_err"],
            x["replay_cards_ms"], path["replay_plain_ms"], *rbound,
            launches_scheduler_xchg=sched_launches["full_chain_xchg_replay"],
            launches_mesh_procs=pl["full_chain_kernel.xchg_replay_launches"],
            ms_mesh_procs=pt["replay_ms"], **xp, **split_replay, ms_single=x["replay_single_ms"],
            replay_plain_pods=path["replay_pods"], **common),
        kernel_entry(
            "explain_counts_shards", "explain_counts.cu",
            "koordinator_tpu/models/full_chain.py:415 (explain_stage_counts,"
            " a jax.vmap in XLA, no TPU kernel), per card",
            la["explain_kernel.shard_launches"]
            + pl["explain_kernel.shard_launches"],
            path["counts_plain_mismatches"], 0.0, x["counts_shards_ms"],
            path["counts_plain_ms"], *cbound,
            launches_mesh_procs=pl["explain_kernel.shard_launches"],
            ms_mesh_procs=pt["counts_ms"], **xp,
            ms_single=x["counts_single_ms"], shards=x["depth"]),
        kernel_entry(
            "schedule_step_xchg", "schedule_step.cu",
            "koordinator_tpu/ops/pallas_step.py:46 (over a mesh of cards: "
            "koordinator_tpu/parallel/mesh.py build_sharded_schedule_step)",
            la["schedule_kernel.xchg_launches"]
            + pl["schedule_kernel.xchg_launches"],
            path["loadaware_plain_mismatches"], path["loadaware_err"],
            x["loadaware_xchg_ms"], path["loadaware_plain_ms"], *lbound,
            launches_mesh_procs=pl["schedule_kernel.xchg_launches"],
            ms_mesh_procs=pt["loadaware_ms"], **xp,
            ms_single=x["loadaware_single_ms"], **common),
    ]


def kernel_entry(name, source, replaces, launches, mism, err, ms, plain_ms,
                 bytes_ms, ops_ms, **extra):
    """One kernel's entry of the kernels line. No PyTorch call computes
    either serial round, nor the kept-only replay, so library_ms is null.
    ``extra`` adds keys (the full chain's launches split by path: the
    sidecar call, the serial Scheduler cycles, the waves' pass 1)."""
    return {**extra,
        "name": name,
        "route": "cuda",
        "source": f"koordinator_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "mismatches": mism,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


# wall seconds of each phase: the time from the previous phase line to
# its own (phases run one after another, each ending with its line)
PHASE_SECONDS = {}
_last_emit = [time.perf_counter()]


def emit(obj) -> None:
    if "phase" in obj:
        now = time.perf_counter()
        PHASE_SECONDS[obj["phase"]] = (PHASE_SECONDS.get(obj["phase"], 0.0)
                                       + now - _last_emit[0])
    print(json.dumps(obj), flush=True)
    if "phase" in obj:
        _last_emit[0] = time.perf_counter()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def tensor_bytes(fc) -> int:
    n = sum(t.numel() * t.element_size() for t in fc.base)
    return n + sum(t.numel() * t.element_size() for t in fc[1:])


def check_round_pin(kernel_out, plain_out) -> dict:
    """main's round against the JAX package's on the same cluster: both
    chosen vectors' digest CONFIG4_ROUND_JAX_CHOSEN_SHA256, and requested
    and quota_used within ROUND_ATOL of the JAX arrays kept in
    tests/fixtures/ (tests/test_torch_full_width_round.py writes and holds
    them)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", CONFIG4_ROUND_JAX_FIXTURE)
    with np.load(path) as kept:
        want = {k: kept[k] for k in ("requested", "quota_used")}
    shas, errs = {}, {}
    for name, out in (("kernel", kernel_out), ("plain", plain_out)):
        chosen, requested, quota_used = (t.cpu().numpy() for t in out)
        shas[name] = round_sha(chosen)
        for key, got in (("requested", requested),
                         ("quota_used", quota_used)):
            if got.shape != want[key].shape:
                raise AssertionError(
                    f"main: {name} {key} has shape {got.shape}, the JAX "
                    f"package's {want[key].shape}")
            errs[f"{name}_{key}"] = float(np.abs(got - want[key]).max())
    if set(shas.values()) != {CONFIG4_ROUND_JAX_CHOSEN_SHA256}:
        raise AssertionError(f"main: chosen digests {shas}, not the JAX "
                             f"package's {CONFIG4_ROUND_JAX_CHOSEN_SHA256}")
    if max(errs.values()) > ROUND_ATOL:
        raise AssertionError(f"main: max |err| against the JAX package "
                             f"{errs}, over {ROUND_ATOL}")
    return {"chosen_sha256": shas["kernel"], "jax_sha256_equal": True,
            "jax_max_abs_err": errs, "jax_atol": ROUND_ATOL}


def compare(tag, kernel_out, plain_out, n_nodes):
    """Kernel vs plain on the same inputs: chosen bit-identical and
    requested/quota_used equal (max |err| 0.0): the kernel repeats the
    plain round's f32 operations in order."""
    chosen_k, req_k, q_k = (x.cpu().numpy() for x in kernel_out)
    chosen_p, req_p, q_p = (x.cpu().numpy() for x in plain_out)
    for name, arr in (("requested", req_k), ("quota_used", q_k)):
        if not np.isfinite(arr).all():
            raise AssertionError(f"{tag}: non-finite {name}")
    if not ((chosen_k >= -1) & (chosen_k < n_nodes)).all():
        raise AssertionError(f"{tag}: chosen out of range")
    mismatches = int((chosen_k != chosen_p).sum())
    err = float(max(np.abs(req_k - req_p).max(), np.abs(q_k - q_p).max()))
    if mismatches or err != 0.0:
        raise AssertionError(
            f"{tag}: kernel disagrees with plain round: {mismatches} "
            f"bindings differ, max |err| {err}")
    return mismatches, err


def time_cuda(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after a warm-up,
    each run bracketed by CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


_CHURN_STATES = {}


def churn_store(num_nodes, num_pods, seed=42):
    """testing/churn.churn_store's (store, state) with the synth run once
    per shape and seed: every later call loads its own copy of that state
    (a pickle round trip, about a third of the synth's time) into a new
    store, so twin worlds still share no object."""
    key = (num_nodes, num_pods, seed)
    if key not in _CHURN_STATES:
        store, state = churn.churn_store(num_nodes, num_pods, seed=seed)
        _CHURN_STATES[key] = pickle.dumps(state, pickle.HIGHEST_PROTOCOL)
        return store, state
    state = pickle.loads(_CHURN_STATES[key])
    return store_from_state(state), state


def pack(state, args):
    fc, _pods, _nodes, _tree, _gi, ng, ngroups = build_full_chain_inputs(
        state, args)
    fc, active = reduce_to_active_axes(fc)
    return fc, ng, ngroups, active


def check_counts_world(tag, fc, seed=7) -> dict:
    """The stage-count pass on a world with affinity, spread, port and
    volume terms (the paths config 4 leaves dark: the spread minima, the
    affinity rows of the tile), at the cycle-start state and at a
    perturbed one (more requested, more affinity counts on labelled
    domains, more ports in use; from ``seed``), over every row and a cut
    below it: equal to the plain counts exactly, called alone and over 2
    and 3 shards of the card (per-card minima and counts)."""
    from koordinator_tpu_torch.parallel.full_chain_mesh import node_rows

    g = torch.Generator(device="cpu").manual_seed(seed)
    N = fc.base.allocatable.shape[0]
    # the node rows of cycle_start_state's 9-tuple (not quota_used, not
    # the exists flags)
    NODE_SLOTS = (0, 1, 2, 4, 5, 7, 8)

    def rand(shape, hi):
        return torch.randint(0, hi, tuple(shape), generator=g).to(
            fc.base.allocatable.device, torch.float32)

    start = cycle_start_state(fc)
    dom = (fc.aff_dom >= 0).to(torch.float32)
    perturbed = (start[0] + rand(start[0].shape, 3) * 500.0, *start[1:4],
                 start[4] + dom * rand(start[4].shape, 2), start[5],
                 start[6], torch.maximum(start[7], rand(start[7].shape, 2)),
                 start[8])
    ek.launches = ek.shard_launches = 0
    mism = {}
    for name, state in (("cycle_start", start), ("perturbed", perturbed)):
        for n_real in (N, N - 7):
            want = explain_stage_counts(fc, state, n_real).to(torch.int64)
            got = {"alone": ek.explain_counts(fc, state, n_real)}
            for depth in (2, 3):
                cut = [N * k // depth for k in range(depth + 1)]
                got[f"shards_{depth}"] = ek.explain_counts_shards(
                    [(node_rows(fc, lo, hi),
                      tuple(t[lo:hi] if i in NODE_SLOTS else t
                            for i, t in enumerate(state)), lo)
                     for lo, hi in zip(cut, cut[1:])], n_real)
            for key, c in got.items():
                k = f"{name}_{n_real}_{key}"
                mism[k] = int((c.to(torch.int64) != want).sum())
    if any(mism.values()) or ek.launches != 4:
        raise AssertionError(f"{tag}: the stage-count pass disagrees with "
                             f"the plain counts: {mism}")
    return {"mismatches": mism, "launches": ek.launches,
            "shard_launches": ek.shard_launches,
            "spread_pods": int((fc.pod_spread_skew > 0).any(1).sum()),
            "rejections": int(want[:, :9].sum())}


def run_pair(tag, state, args, device):
    """Kernel and plain round over one cluster on the card; on the mixed
    cluster also the stage-count pass against its plain counts."""
    fc, ng, ngroups, active = pack(state, args)
    dev_fc = to_device(fc, device)
    kern = fck.build_cuda_full_chain_step(args, ng, ngroups, active)
    plain = build_full_chain_step(args, ng, ngroups, active)
    out_k = kern(dev_fc)
    launch = launch_fields(fck)
    out_p = plain(dev_fc)
    torch.cuda.synchronize()
    mism, err = compare(tag, out_k, out_p, fc.base.allocatable.shape[0])
    dims = dict(P=int(fc.base.fit_requests.shape[0]),
                N=int(fc.base.allocatable.shape[0]),
                R=int(fc.base.fit_requests.shape[1]),
                K=int(fc.numa_free.shape[1]), T=int(fc.aff_dom.shape[1]),
                S=int(fc.pref_scores.shape[1]),
                S2=int(fc.ppref_w.shape[0]) if fc.aff_dom.shape[1] else 0,
                PT=int(fc.port_used.shape[1]),
                SI=int(fc.img_scores.shape[1]),
                VG=int(fc.vol_needed.shape[1]))
    counts = (check_counts_world(tag, dev_fc) if tag == "mixed" else None)
    emit({"phase": tag, **dims, **launch,
          "prod_mode": args.score_according_prod_usage,
          "pods_bound": int((out_k[0] >= 0).sum().item()),
          "mismatches": mism, "max_abs_err": err,
          **({"stage_counts": counts} if counts else {})})
    return dims


# the scrape_convoy phase's bound on the case's cycles beside the
# scrapers: about 2.2x the JAX package's 68.66 s for the same case on the
# CPU (PERF.md section 7)
SCRAPE_CONVOY_LIMIT_S = 150.0


def run_scrape_convoy(device) -> int:
    """The concurrent-scrape case verbatim on the card (testing/
    scrape_convoy.reference_case), after the same cycles alone on the card
    (torch calls counted by route) and on the CPU. Fails past
    SCRAPE_CONVOY_LIMIT_S, on any of the case's checks, on binding logs
    that differ and on no kernel 1 launch. Returns the case's kernel 1
    launches."""
    from koordinator_tpu_torch.testing import scrape_convoy

    cycles = scrape_convoy.CYCLES
    zero_mesh_launches()
    alone = scrape_convoy.run(cycles, scrapers=0, limit=600.0, device=device,
                              count=True)
    alone_launches = mesh_launches_now()
    zero_mesh_launches()
    case = scrape_convoy.reference_case(device, cycles)
    launches = mesh_launches_now()
    cpu = scrape_convoy.run(cycles, scrapers=0, limit=600.0, device="cpu")
    shas = {"alone": alone["binding_log_sha256"],
            "scrapers": case["binding_log_sha256"],
            "cpu": cpu["binding_log_sha256"]}
    bad = []
    if alone["cycles"] != cycles or cpu["cycles"] != cycles:
        bad.append(f"cycles run: card {alone['cycles']}, cpu {cpu['cycles']}")
    if case["errors"] or case["scrapes"] <= 0 or case["threads_alive"]:
        bad.append(f"{case['scrapes']} scrapes, errors {case['errors'][:4]}, "
                   f"{case['threads_alive']} scrapers left running")
    if case["invariant_breaches"]:
        bad.append(f"invariant breaches {case['invariant_breaches'][:4]}")
    if len(set(shas.values())) != 1:
        bad.append(f"binding logs differ: {shas}")
    if launches["full_chain"] < 1 or alone_launches["full_chain"] < 1:
        bad.append(f"kernel 1 launches: case {launches}, alone "
                   f"{alone_launches}")
    if case["seconds"] > SCRAPE_CONVOY_LIMIT_S:
        bad.append(f"{case['seconds']:.1f} s beside the scrapers, over "
                   f"{SCRAPE_CONVOY_LIMIT_S} s")
    if bad:
        raise AssertionError("scrape_convoy: " + "; ".join(bad))
    routes = alone["torch_calls_by_route"]
    emit({"phase": "scrape_convoy", "cycles": cycles,
          "seconds_alone": alone["seconds"],
          "seconds_scrapers": case["seconds"],
          "seconds_cpu_alone": cpu["seconds"],
          "scrapers": case["scrapers"], "scrapes": case["scrapes"],
          "torch_calls": alone["torch_calls"],
          "torch_calls_per_cycle": {k: v / cycles for k, v in routes.items()},
          "torch_calls_by_cycle": alone["torch_calls_per_cycle"],
          "binding_log_sha256": shas["scrapers"],
          "launches": launches, "launches_alone": alone_launches,
          "limit_seconds": SCRAPE_CONVOY_LIMIT_S})
    return launches["full_chain"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    device = "cuda"
    # Python's cyclic collector off for the whole run, and what piled up
    # frozen at the end, so the interpreter's exit does not walk it
    # either: a full collection walks every live and dead world (a config
    # 4 world with its Scheduler leaves ~0.8 million objects in cycles),
    # and the automatic ones (60, 134 s of an 840 s run), one after every
    # phase (45, 162 s of 786) or one per 20 million objects (4, 47 s of
    # 818) cost more than the phases they sat in (NVIDIA H100 80GB HBM3,
    # 700.00 W, chip_smoke_profile.py); the host memory this costs is the
    # last phase line's max_rss_mib
    gc.disable()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    # ---- device + build: one nvcc per kernel source, all at once
    t0 = time.perf_counter()
    build_libraries(fck.SOURCE, sk.SOURCE, ek.SOURCE, fck.REPLAY_SOURCE,
                    IPC_SOURCE, mailbox_rtt.SOURCE)
    build_s = time.perf_counter() - t0
    ptxas = {stem: [ln.strip() for ln in str(log["ptxas"]).splitlines()
                    if "registers" in ln or "spill" in ln]
             for stem, log in BUILD_LOG.items()}
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device_name": torch.cuda.get_device_name(0),
          "build_seconds": round(build_s, 3),
          "build_seconds_each": {stem: round(log["seconds"], 3)
                                 for stem, log in BUILD_LOG.items()},
          "ptxas": ptxas})

    # ---- the scheduler cycle: config 4 with churn, then the mixed cluster
    # against its CPU twin (first, so cycle 0 holds the run's first call of
    # the kernel library)
    scheduler_launches = run_scheduler(device)
    run_scheduler_mixed(device)
    # ---- the default path: auto waves, chained dispatch
    wave_launches, replay_entry, fc4, waves_sha = run_scheduler_waves(device)
    # ---- the same default path on a mesh of 2 virtual shards of the card,
    # then on 2 exchanging virtual cards
    mesh_launches = run_scheduler_mesh(device, waves_sha)
    xchg_launches, tf_xchg_launches, tf_one_launches = run_scheduler_xchg(
        device, waves_sha)
    run_scheduler_waves_mixed(device)
    carried_xchg_launches = run_waves_carried(device, fc4)
    # ---- storage-aware clusters: config 4 with PVCs, PVs, StorageClasses
    storage_launches = run_storage(device)
    # ---- the degradation ladder at config 4, then the sim's scenarios
    ladder_launches = run_ladder(device)
    sim_launches = run_sim(device)
    ladder_mesh_launches = run_fault_ladder(device)
    # ---- koordrace: the race gate over the smoke scenario on the card
    race_launches = run_racecheck(device)
    # ---- the in-window pre-pack against its gap-pack twin, byte for byte
    run_pack_overlap(device)
    # ---- the JAX package's concurrent-scrape case, verbatim on the card
    scrape_launches = run_scrape_convoy(device)
    # ---- the descheduler: config 5 standalone (and on a mesh), then
    # co-located at config 4
    run_rebalance(device)
    run_rebalance_mesh(device)
    colocated_launches = run_rebalance_colocated(device)
    # ---- the manager: the colo pass standalone at config 4's width, the
    # quota fold inside the f32 envelope, co-located on the mirror
    run_colo(device)
    run_colo_mesh(device)
    run_colo_quota(device)
    colo_launches = run_colo_colocated(device)
    # ---- koordexplain: the default and serial paths with explain on,
    # the ladder through no-explain, the koord-scheduler binary
    explain_launches = {"scheduler_explain": run_scheduler_explain(device),
                        "ladder_explain": run_ladder_explain(device),
                        "koord_scheduler": run_koord_scheduler(device),
                        # the fault-ladder scenario runs explain counts on
                        # its mesh
                        "fault_ladder": ladder_mesh_launches}
    # ---- cold start: a cold process and a warm restart, then the
    # descheduler's and the manager's binaries
    cold_launches = run_cold_start()
    run_binary(device, "koord_descheduler")
    run_binary(device, "koord_manager")
    # ---- the Scheduler over the gRPC sidecar, then the 1000-cycle soak
    sidecar_sched_launches = run_scheduler_sidecar(device)
    soak_launches = run_soak(device)
    # ---- the node side: the koordlet's probes of this card, the
    # colocation loop with a GPU pool at config 4's width, the demo, the
    # koordlet and runtime-proxy binaries
    dev = run_node_probe()
    node_launches = run_node_agent(device, dev)
    demo_launches = run_demo()
    run_node_binaries(dev)
    replay_entry.update(
        launches_waves=replay_entry["launches"],
        launches_ladder=ladder_launches["full_chain_replay"],
        launches_sim=sim_launches["full_chain_replay"],
        launches_racecheck=race_launches["full_chain_replay"],
        launches_explain={k: v["full_chain_replay"]
                          for k, v in explain_launches.items()})
    replay_entry.update(
        launches_storage=storage_launches["full_chain_replay"],
        launches_cold_start=cold_launches["full_chain_replay"],
        launches_soak=soak_launches["full_chain_replay"],
        launches_node_agent=node_launches["full_chain_replay"])
    replay_entry.update(
        launches_scheduler_mesh=mesh_launches["full_chain_replay"],
        launches_scheduler_xchg_one_card=tf_one_launches[
            "full_chain_replay"])
    replay_entry["launches"] += (ladder_launches["full_chain_replay"]
                                 + mesh_launches["full_chain_replay"]
                                 + tf_one_launches["full_chain_replay"]
                                 + node_launches["full_chain_replay"]
                                 + storage_launches["full_chain_replay"]
                                 + cold_launches["full_chain_replay"]
                                 + soak_launches["full_chain_replay"]
                                 + sim_launches["full_chain_replay"]
                                 + race_launches["full_chain_replay"]
                                 + sum(v["full_chain_replay"]
                                       for v in explain_launches.values()))

    # ---- main path: BASELINE config 4 through the sidecar entry point
    n_nodes, n_pods = CONFIG4_NODES, CONFIG4_PODS
    args = LoadAwareArgs()
    t0 = time.perf_counter()
    _cluster, state = synth_full_cluster(
        n_nodes, n_pods, seed=42, num_quotas=max(n_pods // 100, 1),
        num_gangs=n_pods // 50)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fc, ng, ngroups, active = pack(state, args)
    pack_s = time.perf_counter() - t0
    server = SidecarServer(device=device)
    fck.launches = sk.launches = 0
    t0 = time.perf_counter()
    chosen, requested, quota_used = server.schedule_batch(
        fc, args, ng, ngroups, active)
    call_s = time.perf_counter() - t0
    main_launches = fck.launches
    launches = {"full_chain": fck.launches, "schedule_step": sk.launches}
    launch = launch_fields(fck)
    if server.last_backend != "cuda" or main_launches < 1:
        raise AssertionError(
            f"main path did not run the kernel (backend "
            f"{server.last_backend}, launches {launches})")
    P, R = fc.base.fit_requests.shape
    N = fc.base.allocatable.shape[0]
    if chosen.shape != (P,) or requested.shape != (N, R):
        raise AssertionError("unexpected output shapes")
    if not (np.isfinite(requested).all() and np.isfinite(quota_used).all()):
        raise AssertionError("non-finite outputs")

    # the warm call, split into its layers
    warm = {}
    t0 = time.perf_counter()
    warm_out = server.schedule_batch(fc, args, ng, ngroups, active,
                                     timings=warm)
    warm["total"] = time.perf_counter() - t0
    if any((a != b).any() for a, b in zip(warm_out, (chosen, requested,
                                                     quota_used))):
        raise AssertionError("the warm call changed the bindings")

    dev_fc = to_device(fc, device)
    wi, bi = resolve_weight_idx(args, active), resolve_balance_idx(active)
    prod = args.score_according_prod_usage
    kernel_ms = time_cuda(lambda: fck.full_chain_round(dev_fc, wi, prod, bi),
                          REPS)
    # the plain round as its explain "full" variant: one ~50 s run gives
    # the bindings kernel 1 is held to and the counts and terms the
    # explain kernels are held to
    plain = build_full_chain_step(args, ng, ngroups, active, explain="full")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_full = plain(dev_fc, n_nodes)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    out_p = out_full[:3]
    out_k = tuple(torch.from_numpy(x) for x in (chosen, requested,
                                                 quota_used))
    mism, err = compare("main", out_k, out_p, N)
    jax_pin = check_round_pin(out_k, out_p)
    K = fc.numa_free.shape[1]
    G = fc.quota_used.shape[0]
    nbytes = tensor_bytes(dev_fc) + P * 4 + N * R * 4 + G * R * 4
    ops = round_ops(dev_fc, len(wi), bi[0] >= 0)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    emit({"phase": "main", "nodes": n_nodes, "pods": n_pods, "P": int(P),
          "N": int(N), "R": int(R), "K": int(K), "G": int(G),
          "T": int(fc.aff_dom.shape[1]), "VG": int(fc.vol_needed.shape[1]),
          "input_bytes": int(tensor_bytes(dev_fc)),
          "synth_seconds": round(synth_s, 3), "pack_seconds": round(pack_s, 3),
          "schedule_batch_seconds": round(call_s, 3),
          "warm_call_seconds": {k: round(v, 6) for k, v in warm.items()},
          **launch,
          "pods_bound": int((chosen >= 0).sum()), "launches": launches,
          "kernel_ms": kernel_ms,
          "plain_ms": plain_ms,
          "plain_compared_pods": int(P), "mismatches": mism,
          "max_abs_err": err, **jax_pin, "ops": ops,
          "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms})
    # ---- the same batch over gRPC, then the compiled serial floor on it
    grpc_launches = run_sidecar_grpc(
        server, fc, args, ng, ngroups, active,
        (chosen, requested, quota_used), warm["total"], card)
    run_compiled_floor(fc, args, ng, ngroups, active, chosen,
                       out_p[0].cpu().numpy(), kernel_ms, warm["total"], card)

    # ---- the same kernel with its carried state in device memory
    glob = fck.build_cuda_full_chain_step(args, ng, ngroups, active,
                                          smem_budget_bytes=0)
    fck.launches = 0
    out_g = glob(dev_fc)
    torch.cuda.synchronize()
    if glob.last_state != "global" or fck.launches != 1:
        raise AssertionError(f"main_global ran state {glob.last_state} with "
                             f"{fck.launches} launches")
    launch_g = launch_fields(fck)
    g_mism, g_err = compare("main_global", out_g, out_p, N)
    global_ms = time_cuda(lambda: fck.full_chain_round(
        dev_fc, wi, prod, bi, smem_budget_bytes=0), REPS)
    emit({"phase": "main_global", **launch_g, "launches": 1,
          "kernel_ms": global_ms, "mismatches": g_mism,
          "max_abs_err": g_err})

    # ---- koordexplain's two kernels at config 4, against the plain round
    count_res, terms_res = run_explain_round(
        dev_fc, args, ng, ngroups, active, n_nodes, out_full, plain_ms,
        kernel_ms)
    # ---- the wave-parallel round against kernel 1
    run_wave_round(dev_fc, args, ng, ngroups, active)

    # ---- mixed features, then prod mode, kernel against the plain round
    m_nodes, m_pods = MIXED_NODES, MIXED_PODS
    _c, mstate = mixed_cluster(7, m_nodes, m_pods)
    dims = run_pair("mixed", mstate, LoadAwareArgs(), device)
    for key in ("T", "S", "S2", "PT", "SI"):
        if dims[key] <= 0:
            raise AssertionError(f"mixed cluster left {key} == 0")
    if dims["VG"] <= 1:
        raise AssertionError("mixed cluster has a single volume group")
    _c, pstate = mixed_cluster(7, m_nodes, m_pods)
    run_pair("prod", pstate, LoadAwareArgs(score_according_prod_usage=True),
             device)

    # ---- the LoadAware-only round, default args and prod mode
    la_kernel, (la_inputs, la_plain) = run_loadaware(
        "loadaware", LoadAwareArgs(), n_nodes, n_pods, device,
        jax_sha=LOADAWARE_JAX_CHOSEN_SHA256)
    run_loadaware("loadaware_prod",
                  LoadAwareArgs(score_according_prod_usage=True), n_nodes,
                  n_pods, device)
    run_loadaware_global(LoadAwareArgs(), la_inputs, la_plain, device)
    run_generic(device)
    # ---- the sharded steps against the single-device kernels
    sharded_ms = run_mesh_round(fc, args, ng, ngroups, active, n_nodes,
                                la_inputs)
    la_kernel["ms_sharded_by_depth"] = sharded_ms["schedule_step"]
    # ---- the mesh of cards across processes: 2 processes on the card
    procs = run_mesh_procs(state, args, n_nodes, la_inputs)

    emit({"phase_seconds": PHASE_SECONDS,
          "total_seconds": time.perf_counter() - SCRIPT_START,
          "tracked_objects": sum(gc.get_count()),
          "max_rss_mib": resource.getrusage(
              resource.RUSAGE_SELF).ru_maxrss / 1024})
    emit({"kernels": [
        kernel_entry("full_chain_round", "full_chain.cu",
                     "koordinator_tpu/ops/pallas_full_chain.py:90",
                     main_launches + scheduler_launches
                     + wave_launches["full_chain"]
                     + ladder_launches["full_chain"]
                     + storage_launches["full_chain"]
                     + cold_launches["full_chain"]
                     + sim_launches["full_chain"]
                     + race_launches["full_chain"] + scrape_launches
                     + colocated_launches
                     + colo_launches + grpc_launches
                     + sidecar_sched_launches + soak_launches["full_chain"]
                     + node_launches["full_chain"] + demo_launches
                     + mesh_launches["full_chain"]
                     + tf_one_launches["full_chain"]
                     + sum(la["full_chain"]
                           for la in explain_launches.values()),
                     mism, err, kernel_ms,
                     plain_ms, bytes_ms, ops_ms, launches_sidecar=main_launches,
                     launches_scheduler=scheduler_launches,
                     launches_waves=wave_launches["full_chain"],
                     launches_ladder=ladder_launches["full_chain"],
                     launches_storage=storage_launches["full_chain"],
                     launches_cold_start=cold_launches["full_chain"],
                     launches_sim=sim_launches["full_chain"],
                     launches_racecheck=race_launches["full_chain"],
                     launches_scrape_convoy=scrape_launches,
                     launches_rebalance_colocated=colocated_launches,
                     launches_colo_colocated=colo_launches,
                     launches_sidecar_grpc=grpc_launches,
                     launches_scheduler_sidecar=sidecar_sched_launches,
                     launches_soak=soak_launches["full_chain"],
                     launches_node_agent=node_launches["full_chain"],
                     launches_demo=demo_launches,
                     launches_scheduler_mesh=mesh_launches["full_chain"],
                     launches_scheduler_xchg_one_card=tf_one_launches[
                         "full_chain"],
                     launches_explain={k: v["full_chain"] for k, v in
                                       explain_launches.items()},
                     ms_sharded_by_depth=sharded_ms["full_chain"]),
        la_kernel, replay_entry,
        *xchg_entries(sharded_ms, xchg_launches, bytes_ms, ops_ms,
                      la_kernel, replay_entry, count_res,
                      {"scheduler_xchg_transformer": tf_xchg_launches,
                       "waves_carried": carried_xchg_launches}, procs),
        explain_entry(
            "explain_counts", "explain_counts.cu",
            "koordinator_tpu/models/full_chain.py:415 (explain_stage_counts,"
            " a jax.vmap in XLA, no TPU kernel)", "explain_counts",
            explain_launches, count_res),
        explain_entry(
            "full_chain_terms", "full_chain.cu",
            "koordinator_tpu/models/full_chain.py:549 (the explain=full "
            "body of the XLA serial step, no TPU kernel)",
            "full_chain_terms", explain_launches, terms_res)]})
    print(card, flush=True)
    # count: the cards this script drives
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    gc.freeze()
    return 0


if __name__ == "__main__":
    sys.exit(main())
