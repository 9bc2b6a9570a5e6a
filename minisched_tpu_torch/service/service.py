"""Scheduler service: the lifecycle around the live engine.

A copy of ``minisched_tpu/service/service.py``: the ``Service`` that owns
the informer factory and the event recorder, builds the engine from a
``SchedulerConfig``, starts and syncs the informers, spawns the run loop,
and restarts or shuts it all down.

Unlike the JAX service, whose default is the scalar engine,
``start_scheduler`` defaults to ``device_mode=True``: the entry point runs
on the card unless the caller asks otherwise.
``start_scheduler(device_mode=True)`` runs
``engine/device_scheduler.DeviceScheduler`` on ``device`` (None: the
card, and without one it raises; the tests pass ``"cpu"``), pipelined
unless ``pipeline=False`` or ``MINISCHED_PIPELINE=0``.  The engine's
evaluator and kernels, and with ``prewarm_scan`` (the default, as in JAX)
both scan lanes with one step each, are built on the calling thread
before the loop starts (``prewarm``): a build or capture failure raises
here, and the engine thread is the only one that then touches the card.
``device_mode=False`` runs the scalar engine
(``build_scheduler_from_config``: ``engine/scheduler.Scheduler``, one pod
a cycle through the plugins' scalar halves), which is host only and
ignores ``device``, ``max_wave``, ``prewarm_scan`` and ``pipeline``.
Nothing falls back from one engine to the other.

``record_results=True`` (JAX ``service.py:43-110``) builds a result store
(``self.result_store``), registers the ``<name>ForSimulator`` wrappers of
every plugin with the config's score weights and converts the config to
them, and puts the store's flush on the pod informer's updates, so each
pod's per-plugin verdicts land on its ``scheduler-simulator/*``
annotations when its bind does.  The scalar engine records per cycle
through the wrappers; the device engine, whose loop then stays serial,
records per wave and per exact-scan chunk with one diagnostics
evaluation.  ``restart_scheduler`` keeps recording.

``shard_filter`` (JAX ``:51``, ``:114``, ``:158-170``): the HA
queue-admission predicate (pod → bool, ``ha/membership.Membership.
owns_pod``), installed on the engine before the informers start, so even
the first snapshot replay admits only this engine's shard;
``restart_scheduler`` keeps it.  N services with complementary filters
run active-active against one control plane (``ha/plane.py``).

``device_mesh`` (JAX ``:46-104``, ``:157-169``; device mode only): a
``parallel.sharding.Mesh`` the engine's waves are evaluated over (pod
rows data-parallel, node columns model-parallel); None defers to the
config's ``mesh_devices``/``mesh_pod_shards`` pin, then to
``MINISCHED_MESH``; ``restart_scheduler`` keeps it.
"""

from __future__ import annotations

from typing import Any, Optional

from minisched_tpu_torch.controlplane.client import Client, EventRecorder
from minisched_tpu_torch.controlplane.informer import (
    ResourceEventHandlers,
    SharedInformerFactory,
)
from minisched_tpu_torch.engine.device_scheduler import new_device_scheduler
from minisched_tpu_torch.engine.scheduler import Scheduler
from minisched_tpu_torch.observability.resultstore import Store
from minisched_tpu_torch.plugins.registry import build_plugins, inject
from minisched_tpu_torch.plugins.simulator import (
    convert_configuration_for_simulator,
    register_simulator_plugins,
)
from minisched_tpu_torch.service.config import (
    SchedulerConfig,
    default_scheduler_config,
)


class SchedulerService:
    def __init__(self, client: Client):
        self._client = client
        self._current_cfg: Optional[SchedulerConfig] = None
        self._scheduler: Optional[Scheduler] = None
        self._factory: Optional[SharedInformerFactory] = None
        # events land in the store as Event objects
        self.recorder = EventRecorder(store=client.store)
        #: set by ``start_scheduler(record_results=True)``
        self.result_store: Optional[Store] = None
        self._record_results = False
        self._device_mode = True
        self._max_wave = 1024
        self._device: Any = None
        self._pipeline: Optional[bool] = None
        self._shard_filter = None

    def start_scheduler(
        self,
        cfg: Optional[SchedulerConfig] = None,
        record_results: bool = False,
        device_mode: bool = True,
        max_wave: int = 1024,
        on_decision=None,
        metrics=None,
        device: Any = None,
        prewarm_scan: bool = True,
        pipeline: Optional[bool] = None,
        shard_filter=None,
        device_mesh: Any = None,
    ) -> Scheduler:
        """Build the engine for ``cfg`` (default: the reference's default
        wiring), start and sync the informers, then the run loop: the
        device engine, or with ``device_mode=False`` the scalar engine.
        ``on_decision`` (pod, node name or None, status) and ``metrics``
        are installed before the loop starts.  The sync replays every
        pod already in the store through the queue handlers, so the loop
        starts with every pending pod queued, in store order.
        ``record_results``, ``shard_filter`` and ``device_mesh``: see the
        module docstring."""
        if self._scheduler is not None:
            raise RuntimeError(
                "scheduler already running; use restart_scheduler")
        cfg = (cfg or default_scheduler_config()).clone()
        orig_cfg = cfg.clone()  # before conversion: what restart re-applies
        self._factory = SharedInformerFactory(self._client.store)
        if record_results:
            self.result_store = Store(self._client)
            register_simulator_plugins(
                self.result_store,
                {e.name: e.weight for e in cfg.score.enabled})
            cfg = convert_configuration_for_simulator(cfg)
            # flush hook: pod Update events write the results onto the
            # pod's annotations (store.go:62-67)
            self._factory.informer_for("Pod").add_event_handlers(
                ResourceEventHandlers(
                    on_update=self.result_store.add_scheduling_result_to_pod))
        if device_mode:
            sched = new_device_scheduler(self._client, self._factory, cfg,
                                         max_wave=max_wave, device=device,
                                         pipeline=pipeline, mesh=device_mesh)
            if record_results:
                sched.result_store = self.result_store
        else:
            sched = build_scheduler_from_config(self._client, self._factory,
                                                cfg)
        # before the informers start: the first replay must already be
        # shard-filtered, or a rebalance-sized purge follows at once
        sched.shard_filter = shard_filter
        self.recorder.eventf(None, "Normal", "SchedulerStarted",
                             "scheduler starting")
        self._factory.start()
        if not self._factory.wait_for_cache_sync(timeout=300.0):
            raise RuntimeError("informer caches failed to sync")
        # hooks must be live BEFORE the engine thread starts
        if on_decision is not None:
            sched.on_decision = on_decision
        if metrics is not None:
            sched.metrics = metrics
        if sched.on_decision is None:
            def emit(pod, node_name, status):
                if node_name:
                    self.recorder.eventf(
                        pod, "Normal", "Scheduled",
                        f"Successfully assigned {pod.metadata.key} to "
                        f"{node_name}")
                else:
                    self.recorder.eventf(
                        pod, "Warning", "FailedScheduling",
                        "; ".join(status.reasons) or status.code.name)

            sched.on_decision = emit
        if device_mode:
            sched.prewarm(scan=prewarm_scan)
        sched.run()
        self._scheduler = sched
        self._current_cfg = orig_cfg
        self._record_results = record_results
        self._device_mode = device_mode
        self._max_wave = max_wave
        self._device = device
        self._pipeline = pipeline
        self._shard_filter = shard_filter
        self._device_mesh = device_mesh
        return sched

    def restart_scheduler(self, cfg: Optional[SchedulerConfig] = None
                          ) -> Scheduler:
        self.shutdown_scheduler()
        return self.start_scheduler(cfg or self._current_cfg,
                                    record_results=self._record_results,
                                    device_mode=self._device_mode,
                                    max_wave=self._max_wave,
                                    device=self._device,
                                    pipeline=self._pipeline,
                                    shard_filter=self._shard_filter,
                                    device_mesh=self._device_mesh)

    def shutdown_scheduler(self) -> None:
        if self._scheduler is not None:
            self.recorder.eventf(None, "Normal", "SchedulerStopped",
                                 "scheduler stopping")
            self._scheduler.stop()
            self._scheduler = None
        if self._factory is not None:
            self._factory.shutdown()
            self._factory = None
        self.recorder.flush()

    def close(self) -> None:
        """Full teardown: shutdown plus the recorder's writer thread."""
        self.shutdown_scheduler()
        self.recorder.close()

    def get_scheduler_config(self) -> Optional[SchedulerConfig]:
        return self._current_cfg

    @property
    def scheduler(self) -> Optional[Scheduler]:
        return self._scheduler

    @property
    def informer_factory(self) -> Optional[SharedInformerFactory]:
        return self._factory


def build_scheduler_from_config(client: Client,
                                factory: SharedInformerFactory,
                                cfg: SchedulerConfig) -> Scheduler:
    """The scalar engine for a SchedulerConfig (plugin enablement and
    weights; initialize.go:35-78), its handles and the client injected."""
    chains = build_plugins(cfg)
    sched = Scheduler(
        client,
        factory,
        filter_plugins=chains.filter,
        post_filter_plugins=chains.post_filter,
        pre_score_plugins=chains.pre_score,
        score_plugins=chains.score,
        permit_plugins=chains.permit,
        reserve_plugins=chains.reserve,
        score_weights=cfg.score_weights(),
        queue_opts=cfg.queue_opts,
    )
    for p in chains.needs_handle:
        inject(p, "h", sched)
    for p in chains.needs_client:
        inject(p, "store_client", client)
    return sched
