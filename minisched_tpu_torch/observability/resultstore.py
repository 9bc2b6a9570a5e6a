"""Result store: per-decision scheduling results flushed to pod annotations.

A copy of ``minisched_tpu/observability/resultstore.py``, which
re-creates ``scheduler/plugin/resultstore/store.go``: a thread-safe map of
pod → node → plugin → {filter reason, raw score, final (normalized ×
weight) score}.  On every pod Update event the pod's accumulated results
are JSON-serialized onto its own annotations (``annotation`` keys) with an
exponential-backoff-retried read-modify-write, then dropped from the store
(store.go:90-135): the scheduling framework has no phase that marks a
pod's scheduling finished, so the pod's own update event is the flush
trigger.

``record_batch_result`` ingests a diagnostics ``PlacementResult``
(``ops/fused.py``: ``filter_masks``, ``score_matrices``,
``raw_score_matrices``, on the card or the CPU; it copies each to the host
once), so the device engine's waves emit the same per-decision artifact as
the scalar engine's cycles.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Any, Dict, Optional, Sequence

from minisched_tpu_torch.observability import annotation
from minisched_tpu_torch.utils.retry import (
    RetryTimeoutError,
    retry_with_exponential_backoff,
)

PASSED_FILTER_MESSAGE = "passed"  # store.go's success marker


class Store:
    """store.go:24-69.  All three result kinds keyed [pod key][node][plugin]."""

    def __init__(self, client: Optional[Any] = None):
        self._mu = threading.Lock()
        self._filter: Dict[str, Dict[str, Dict[str, str]]] = {}
        self._score: Dict[str, Dict[str, Dict[str, int]]] = {}
        self._final: Dict[str, Dict[str, Dict[str, int]]] = {}
        self._client = client

    # -- recording (store.go:171-229) --------------------------------------
    def add_filter_result(self, pod_key: str, node: str, plugin: str,
                          reason: str) -> None:
        with self._mu:
            self._filter.setdefault(pod_key, {}).setdefault(
                node, {})[plugin] = reason

    def add_score_result(self, pod_key: str, node: str, plugin: str,
                         score: int) -> None:
        with self._mu:
            self._score.setdefault(pod_key, {}).setdefault(
                node, {})[plugin] = int(score)

    def add_normalized_score_result(self, pod_key: str, node: str,
                                    plugin: str, score: int,
                                    weight: int = 1) -> None:
        """Final score = normalized score × plugin weight (store.go:208-234)."""
        with self._mu:
            self._final.setdefault(pod_key, {}).setdefault(
                node, {})[plugin] = int(score) * weight

    # -- reading / lifecycle -----------------------------------------------
    def get_data(self, pod_key: str):
        with self._mu:
            return (
                {n: dict(v) for n, v in self._filter.get(pod_key, {}).items()},
                {n: dict(v) for n, v in self._score.get(pod_key, {}).items()},
                {n: dict(v) for n, v in self._final.get(pod_key, {}).items()},
            )

    def has_data(self, pod_key: str) -> bool:
        with self._mu:
            return (pod_key in self._filter or pod_key in self._score
                    or pod_key in self._final)

    def delete_data(self, pod_key: str) -> None:
        """store.go:134's DeleteData."""
        with self._mu:
            self._filter.pop(pod_key, None)
            self._score.pop(pod_key, None)
            self._final.pop(pod_key, None)

    def take_data(self, pod_key: str):
        """Atomically pop the pod's results (one lock hold): the flush
        takes its snapshot out of the store first, so results recorded
        concurrently (a re-scheduling attempt racing the flush) stay for
        the next flush trigger."""
        with self._mu:
            return (
                self._filter.pop(pod_key, {}),
                self._score.pop(pod_key, {}),
                self._final.pop(pod_key, {}),
            )

    # -- annotation flush (store.go:90-168) --------------------------------
    def add_scheduling_result_to_pod(self, old: Any, new: Any) -> None:
        """Pod-update handler: write the pod's accumulated results onto its
        annotations with retried updates, then drop them (store.go:90-135).
        Wire via ``informer_for("Pod").add_event_handlers(on_update=...)``.
        """
        if self._client is None:
            return
        pod_key = new.metadata.key
        if not self.has_data(pod_key):
            return
        # pop, then flush: on retry exhaustion the snapshot is dropped (and
        # logged), so a pod that keeps failing never stalls the informer's
        # dispatch thread on every later event
        filter_r, score_r, final_r = self.take_data(pod_key)

        def apply(pod: Any) -> Any:
            ann = pod.metadata.annotations
            ann[annotation.FILTER_RESULT] = json.dumps(filter_r,
                                                       sort_keys=True)
            ann[annotation.SCORE_RESULT] = json.dumps(score_r, sort_keys=True)
            ann[annotation.FINAL_SCORE_RESULT] = json.dumps(final_r,
                                                            sort_keys=True)
            return pod

        def try_update() -> bool:
            # an atomic read-modify-write: a get → clone → update would
            # clobber a concurrent bind
            try:
                self._client.pods().mutate(new.metadata.name, apply,
                                           new.metadata.namespace)
                return True
            except KeyError:
                return True  # pod gone; nothing to annotate
            except Exception:
                return False  # transient store error: retry (util/retry.go)

        try:
            retry_with_exponential_backoff(try_update)
        except RetryTimeoutError:
            logging.getLogger(__name__).warning(
                "dropping scheduling results for %s: annotation flush "
                "retries exhausted", pod_key)

    # -- batch (device) ingestion ------------------------------------------
    def record_batch_result(
        self,
        result: Any,
        pod_keys: Sequence[str],
        node_names: Sequence[str],
        filter_plugin_names: Sequence[str],
        score_plugin_names: Sequence[str],
        reasons: Optional[Dict[str, str]] = None,
    ) -> None:
        """Ingest a diagnostics evaluation (``PlacementResult`` with
        ``filter_masks`` / ``score_matrices`` / ``raw_score_matrices``) so
        a wave's decisions carry the same per-plugin record as scalar
        cycles.

        ``reasons``: plugin name → rejection reason string (defaults to the
        plugin name itself).

        Cost note: the record is O(pods × nodes × plugins) of Python dict
        entries by design: the reference's artifact has the same shape (a
        full node map per pod, store.go:90-135).  Dicts are built outside
        the lock and installed with one lock hold per pod; at headline wave
        sizes (8k × 10k) record selectively, not every wave.
        """
        reasons = reasons or {}
        n_nodes = len(node_names)

        def host(planes: Any) -> Any:
            """[K, P, N] planes → per pod, per node, the K plugin values
            as Python lists (one device copy, one tolist per pod)."""
            if planes is None:
                return None
            return planes[:, :len(pod_keys), :n_nodes].permute(
                1, 2, 0).cpu().numpy()

        masks = host(result.filter_masks)
        finals = host(result.score_matrices)
        raws = host(result.raw_score_matrices)
        rejected = [reasons.get(p, p) for p in filter_plugin_names]
        for pi, pod_key in enumerate(pod_keys):
            filt: Dict[str, Dict[str, str]] = {}
            score: Dict[str, Dict[str, int]] = {}
            final: Dict[str, Dict[str, int]] = {}
            if masks is not None:
                filt = {
                    node: {plugin: PASSED_FILTER_MESSAGE if ok else why
                           for plugin, ok, why in zip(filter_plugin_names,
                                                      row, rejected)}
                    for node, row in zip(node_names, masks[pi].tolist())
                }
            if raws is not None:
                score = {node: dict(zip(score_plugin_names, row))
                         for node, row in zip(node_names, raws[pi].tolist())}
            if finals is not None:
                final = {node: dict(zip(score_plugin_names, row))
                         for node, row in zip(node_names,
                                              finals[pi].tolist())}
            with self._mu:
                # merge per plugin: a wholesale node-map replace would drop
                # results another chain recorded for the same pod and node
                for target, data in ((self._filter, filt),
                                     (self._score, score),
                                     (self._final, final)):
                    if data:
                        pod_map = target.setdefault(pod_key, {})
                        for node, plugins in data.items():
                            pod_map.setdefault(node, {}).update(plugins)
