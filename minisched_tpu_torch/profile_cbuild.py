"""The host constraint builds of the full-roster runs, for comparing two
trees of the port on one card.

Run from the root of the repository on a machine with a CUDA card:

    PYTHONPATH=. python3 minisched_tpu_torch/profile_cbuild.py

It imports ``minisched_tpu_torch`` from ``PYTHONPATH``, so the same file
times an older tree of the port too: name that tree's root there.  It uses only entry points the port has had since its
scan lanes.  The runs are those of ``chip_smoke.py``:

* ``c5-waves``: config 5 in full-roster repair waves of 16,384 (phase 8);
* ``mixed``: the mixed cluster in repair waves of 4,096 (phase 10);
* ``c5-scan``: the exact scan of all of config 5's 100,000 pods (phase 12);
* ``c5x-lane``: config 5 with 5,000 spread pods, the blocked lane after
  the repair waves of the others (phase 13).

For each it prints one JSON line: the host seconds in constraint builds,
the whole schedule wall, and a digest of the choices (equal digests mean
equal placements).  Without a card it raises.
"""

from __future__ import annotations

import hashlib
import json
import time

import numpy as np
import torch

from minisched_tpu_torch import fullchain
from minisched_tpu_torch.headline import BoundPod

C5X_SPREAD = 5_000  # as chip_smoke.py's phase 13


def _digest(choices) -> str:
    return hashlib.sha256(np.asarray(choices, np.int64).tobytes()).hexdigest()[:16]


def _line(run: str, constraint_build_s: float, wall_s: float, choices,
          **extra) -> None:
    print(json.dumps({"run": run, "constraint_build_s": constraint_build_s,
                      "wall_s": wall_s, "choices": _digest(choices), **extra}),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    nodes, pods = fullchain.mk_c5_cluster()
    fullchain.schedule_repair_waves(nodes, pods[:fullchain.WAVE])  # warm-up
    run = fullchain.schedule_repair_waves(nodes, pods)
    _line("c5-waves", run.constraint_build_s, run.schedule_s, run.choices)

    m_nodes, m_assigned, m_pods, m_pvcs, m_pvs = fullchain.mk_mixed_cluster()
    t0 = time.monotonic()
    run = fullchain.schedule_repair_waves(m_nodes, m_pods, wave=4_096,
                                          assigned=m_assigned, pvcs=m_pvcs,
                                          pvs=m_pvs)
    _line("mixed", run.constraint_build_s, time.monotonic() - t0, run.choices)

    scan = fullchain.schedule_scan(nodes, pods)
    _line("c5-scan", scan.constraint_build_s, scan.schedule_s, scan.choices)

    x_nodes, x_pods = fullchain.mk_c5_cluster(n_crosspod=C5X_SPREAD)
    spread = [p for p in x_pods if p.metadata.name.startswith("spread")]
    rest = [p for p in x_pods if not p.metadata.name.startswith("spread")]
    waves = fullchain.schedule_repair_waves(x_nodes, rest)
    placed = [BoundPod(p, waves.node_names[c])
              for p, c in zip(rest, waves.choices) if c >= 0]
    lane = fullchain.schedule_crosspod(x_nodes, spread, waves.node_table,
                                       placed)
    _line("c5x-lane", lane.constraint_build_s, lane.schedule_s, lane.choices,
          waves_constraint_build_s=waves.constraint_build_s)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
