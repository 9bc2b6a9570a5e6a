"""Simulator plugin wrapper: every Filter and Score call recorded.

A copy of ``minisched_tpu/plugins/simulator.py``, which re-creates
``scheduler/plugin/plugins.go``: the layer that wraps each filter and
score plugin so every ``Filter`` / ``Score`` / ``NormalizeScore`` call
also records its outcome in the result store (plugins.go:229-325), the
``<name>ForSimulator`` naming (:242-244), the registry of wrapped
factories (NewRegistry, :24-70) and the configuration conversion that
swaps the enabled plugins for wrapped ones (ConvertForSimulator,
:146-202; convertConfigurationForSimulator, scheduler/scheduler.go:97-142).

Wrappers are composed per capability (filter only, score only, both) so
the capability probes stay truthful; every other attribute (pre-score,
pre-filter, permit, events, and the whole batch half: ``has_batch``,
``batch_filter``, ``batch_score``, ``needs_extra``, ...) is the wrapped
plugin's own, through ``__getattr__``.  So both engines run wrapped
chains: the scalar engine records per cycle through the scalar calls
here, the device engine per wave through ``Store.record_batch_result``
(``DeviceScheduler._record_wave``: one diagnostics evaluation a wave, not
a host callback per pod and node).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from minisched_tpu_torch.framework.types import (
    CycleState,
    NodeScoreList,
    Status,
)
from minisched_tpu_torch.observability.resultstore import (
    PASSED_FILTER_MESSAGE,
    Store,
)
from minisched_tpu_torch.service.config import (
    PluginEnabled,
    PluginSet,
    SchedulerConfig,
)

SUFFIX = "ForSimulator"  # plugins.go:242-244


def plugin_name(name: str) -> str:
    return name + SUFFIX


class _Base:
    """Shared wrapper plumbing: naming and transparent delegation."""

    def __init__(self, inner: Any, store: Store, weight: int = 1):
        self._inner = inner
        self._store = store
        self._weight = weight

    def name(self) -> str:
        return plugin_name(self._inner.name())

    @property
    def original_name(self) -> str:
        return self._inner.name()

    def __getattr__(self, item):
        # every other extension point, the batch half, and injected
        # attributes read through: a probe sees what the plugin has
        return getattr(self._inner, item)


class _FilterRecorder(_Base):
    """plugins.go:311-325: record pass or reason for every Filter call."""

    def filter(self, state: CycleState, pod: Any, node_info: Any) -> Status:
        status = self._inner.filter(state, pod, node_info)
        msg = (PASSED_FILTER_MESSAGE
               if (status is None or status.is_success())
               else ("; ".join(status.reasons) or "failed"))
        self._store.add_filter_result(pod.metadata.key, node_info.name,
                                      self._inner.name(), msg)
        return status


class _ScoreRecorder(_Base):
    """plugins.go:294-309 and :275-292: record raw and final scores."""

    def score(self, state: CycleState, pod: Any,
              node_name: str) -> Tuple[int, Status]:
        score, status = self._inner.score(state, pod, node_name)
        self._store.add_score_result(pod.metadata.key, node_name,
                                     self._inner.name(), score)
        # a plugin without NormalizeScore never gets a normalize call, so
        # its raw score (× weight) is its final score
        if self._inner_extensions() is None:
            self._store.add_normalized_score_result(
                pod.metadata.key, node_name, self._inner.name(), score,
                self._weight)
        return score, status

    def _inner_extensions(self):
        ext = getattr(self._inner, "score_extensions", None)
        return ext() if callable(ext) else None

    def score_extensions(self):
        if self._inner_extensions() is None:
            return None
        return _RecordingScoreExtensions(self)


class _RecordingScoreExtensions:
    def __init__(self, wrapper: _ScoreRecorder):
        self._w = wrapper

    def normalize_score(self, state: CycleState, pod: Any,
                        scores: NodeScoreList) -> Status:
        status = self._w._inner_extensions().normalize_score(state, pod,
                                                              scores)
        if status is None or status.is_success():
            for ns in scores:
                self._w._store.add_normalized_score_result(
                    pod.metadata.key, ns.name, self._w.original_name,
                    ns.score, self._w._weight)
        return status


class _FilterScoreRecorder(_FilterRecorder, _ScoreRecorder):
    pass


def make_simulator_plugin(inner: Any, store: Store, weight: int = 1) -> Any:
    """Wrap one plugin with the recorders matching its capabilities (the
    reference composes fake and real plugins the same way,
    plugins_test.go:981-1042)."""
    f = callable(getattr(inner, "filter", None))
    s = callable(getattr(inner, "score", None))
    cls = (_FilterScoreRecorder if f and s
           else _FilterRecorder if f else _ScoreRecorder if s else _Base)
    return cls(inner, store, weight)


def wrap_chains(filter_plugins: List[Any], score_plugins: List[Any],
                store: Store, weights: Optional[dict] = None
                ) -> Tuple[List[Any], List[Any]]:
    """Wrap instantiated plugin chains; a plugin serving filter and score
    gets one wrapper, like the reference's singleton factories
    (plugins.go:24-70)."""
    weights = weights or {}
    cache: dict = {}

    def wrap(p: Any) -> Any:
        if id(p) not in cache:
            cache[id(p)] = make_simulator_plugin(p, store,
                                                 weights.get(p.name(), 1))
        return cache[id(p)]

    return [wrap(p) for p in filter_plugins], [wrap(p) for p in score_plugins]


def register_simulator_plugins(store: Store,
                               weights: Optional[dict] = None) -> None:
    """NewRegistry (plugins.go:24-70): register a ``<name>ForSimulator``
    factory for every known plugin, wrapping the original factory.  A
    later call rebinds every wrapper to its store."""
    from minisched_tpu_torch.plugins import registry

    weights = weights or {}
    for name in registry.registered_names():
        if name.endswith(SUFFIX):
            continue
        original = registry._REGISTRY[name]

        def factory(args, ts, _orig=original, _name=name):
            return make_simulator_plugin(_orig(args, ts), store,
                                         weights.get(_name, 1))

        registry.register(plugin_name(name), factory)


def convert_for_simulator(plugin_set: PluginSet) -> PluginSet:
    """ConvertForSimulator (plugins.go:146-202): every enabled plugin is
    replaced by its ``<name>ForSimulator`` version and all default plugins
    are disabled (wildcard)."""
    return PluginSet(
        enabled=[PluginEnabled(plugin_name(e.name), e.weight)
                 for e in plugin_set.enabled],
        disabled=["*"],
    )


def convert_configuration_for_simulator(cfg: SchedulerConfig
                                        ) -> SchedulerConfig:
    """convertConfigurationForSimulator (scheduler/scheduler.go:97-142):
    only plugin enablement and args are taken from ``cfg``; the filter and
    score sets become simulator-wrapped ones."""
    out = cfg.clone()
    out.filter = convert_for_simulator(cfg.filter)
    out.score = convert_for_simulator(cfg.score)
    return out
