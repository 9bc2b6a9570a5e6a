"""Annotation keys for per-decision scheduling results.

A copy of ``minisched_tpu/observability/annotation.py``, which re-creates
``scheduler/plugin/annotation/annotation.go:3-10`` verbatim so
consumers of the reference's simulator annotations can read ours unchanged.
"""

#: per-plugin filter reasons, JSON: {node: {plugin: reason-or-"passed"}}
FILTER_RESULT = "scheduler-simulator/filter-result"
#: per-plugin raw scores, JSON: {node: {plugin: score}}
SCORE_RESULT = "scheduler-simulator/score-result"
#: per-plugin normalized+weighted scores, JSON: {node: {plugin: score}}
FINAL_SCORE_RESULT = "scheduler-simulator/finalscore-result"
