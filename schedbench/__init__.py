"""The benchmark of ``minisched_tpu_torch``: spread-Deployment rollouts
through the live engine on one card.  Run a cell with ``python3 -m
schedbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
