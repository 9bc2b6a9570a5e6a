"""The control: the reference, with one guarantee left out, in the
program's place, judged by the same comparison as a run.

``python3 -m schedbench.control --workload <cell> --seeds <n>...
[--rollouts R] [--kind spread|tiebreak]`` places the cell's traffic (``R``
rollouts, the warm ones and as many as a run's window holds) with the
control and prints, per seed, each number compared beside its limit, and
a last JSON line.  A control that comes out correct is a comparison that
cannot see the guarantee it left out.  It runs on the host; it needs no
card and imports nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

from schedbench.check import CONTROLS, LIMITS, control_events, judge, passed
from schedbench.cluster import make_cluster
from schedbench.spec import PACKAGE_DIR, find_cell, generator


def traffic_order(cell, seed: int, rollouts: int) -> List[Tuple]:
    """The mix's creates and deletes in order, as if every pod were bound
    as soon as it was created: ``rollouts`` creations in all."""
    loop = generator(cell, seed)
    order: List[Tuple] = []
    pending = list(loop.start())
    started = 0
    while pending and started < rollouts:
        kind, plans = pending.pop(0)
        if kind == "delete":
            order += [("delete", p.name) for p in plans]
            continue
        started += 1
        order += [("create", p.name, p.uid, p.pod) for p in plans]
        for p in plans:
            pending += loop.on_bound(p.name)
    return order


def run_control(cell, seed: int, rollouts: int, kind: str
                ) -> Dict[str, int]:
    cluster = make_cluster(cell.config, seed)
    order = traffic_order(cell, seed, rollouts)
    plans = {s[1]: (s[2], s[3]) for s in order if s[0] == "create"}
    events = control_events(cluster, order, kind)
    return judge(cluster, plans, events, None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="schedbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rollouts", type=int, default=16)
    ap.add_argument("--kind", choices=sorted(CONTROLS), default="spread")
    args = ap.parse_args(argv)
    cell = find_cell(PACKAGE_DIR.parent, args.workload)
    out = {}
    for seed in args.seeds:
        counts = run_control(cell, seed, args.rollouts, args.kind)
        out[str(seed)] = counts
        print(f"control {args.kind} seed {seed}: "
              + ", ".join(f"{k} {v} limit {LIMITS[k]}"
                          for k, v in counts.items())
              + f"; correct {passed(counts)}", file=sys.stderr)
    print(json.dumps({"workload": args.workload, "kind": args.kind,
                      "rollouts": args.rollouts, "seeds": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
