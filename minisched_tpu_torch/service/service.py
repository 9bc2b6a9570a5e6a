"""Scheduler service: the lifecycle around the live engine.

A copy of ``minisched_tpu/service/service.py``: the ``Service`` that owns
the informer factory and the event recorder, builds the engine from a
``SchedulerConfig``, starts and syncs the informers, spawns the run loop,
and restarts or shuts it all down.

Only the device engine is ported: ``start_scheduler(device_mode=True)``
runs ``engine/device_scheduler.DeviceScheduler`` on ``device`` (None: the
card; the tests pass ``"cpu"``), pipelined unless ``pipeline=False`` or
``MINISCHED_PIPELINE=0``.  The scalar engine (``device_mode=False``)
raises until ROADMAP item 10e; ``record_results``, the mesh and the HA
shard filter are not ported.  The engine's evaluator and kernels, and
with ``prewarm_scan`` (the default, as in JAX) both scan lanes with one
step each, are built on the calling thread before the loop starts
(``prewarm``): a build or capture failure raises here, and the engine
thread is the only one that then touches the card.
"""

from __future__ import annotations

from typing import Any, Optional

from minisched_tpu_torch.controlplane.client import Client, EventRecorder
from minisched_tpu_torch.controlplane.informer import SharedInformerFactory
from minisched_tpu_torch.engine.device_scheduler import (
    DeviceScheduler,
    new_device_scheduler,
)
from minisched_tpu_torch.service.config import (
    SchedulerConfig,
    default_scheduler_config,
)


class SchedulerService:
    def __init__(self, client: Client):
        self._client = client
        self._current_cfg: Optional[SchedulerConfig] = None
        self._scheduler: Optional[DeviceScheduler] = None
        self._factory: Optional[SharedInformerFactory] = None
        # events land in the store as Event objects
        self.recorder = EventRecorder(store=client.store)
        self._max_wave = 1024
        self._device: Any = None
        self._pipeline: Optional[bool] = None

    def start_scheduler(
        self,
        cfg: Optional[SchedulerConfig] = None,
        device_mode: bool = False,
        max_wave: int = 1024,
        on_decision=None,
        metrics=None,
        device: Any = None,
        prewarm_scan: bool = True,
        pipeline: Optional[bool] = None,
    ) -> DeviceScheduler:
        """Build the engine for ``cfg`` (default: the reference's default
        wiring), start and sync the informers, then the run loop.
        ``on_decision`` (pod, node name or None, status) and ``metrics``
        are installed before the loop starts.  The sync replays every
        pod already in the store through the queue handlers, so the loop
        starts with every pending pod queued, in store order."""
        if not device_mode:
            raise NotImplementedError(
                "the scalar engine needs the plugins' scalar filter and "
                "score halves: ROADMAP item 10e; pass device_mode=True")
        if self._scheduler is not None:
            raise RuntimeError(
                "scheduler already running; use restart_scheduler")
        cfg = (cfg or default_scheduler_config()).clone()
        self._factory = SharedInformerFactory(self._client.store)
        sched = new_device_scheduler(self._client, self._factory, cfg,
                                     max_wave=max_wave, device=device,
                                     pipeline=pipeline)
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
        sched.prewarm(scan=prewarm_scan)
        sched.run()
        self._scheduler = sched
        self._current_cfg = cfg.clone()
        self._max_wave = max_wave
        self._device = device
        self._pipeline = pipeline
        return sched

    def restart_scheduler(self, cfg: Optional[SchedulerConfig] = None
                          ) -> DeviceScheduler:
        self.shutdown_scheduler()
        return self.start_scheduler(cfg or self._current_cfg,
                                    device_mode=True,
                                    max_wave=self._max_wave,
                                    device=self._device,
                                    pipeline=self._pipeline)

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
    def scheduler(self) -> Optional[DeviceScheduler]:
        return self._scheduler

    @property
    def informer_factory(self) -> Optional[SharedInformerFactory]:
        return self._factory
