"""Cluster-level scheduling policies.

Analog of the reference's scheduling policy suite
(ray: src/ray/raylet/scheduling/policy/): hybrid pack-then-spread default
(hybrid_scheduling_policy.h:50), spread and node-affinity.  The bundle
placement policies come with placement groups, a later slice of the port
(ROADMAP.md queue 1).

Used in two places, exactly like the reference's two-level scheduler:
  - the controller places actors cluster-wide;
  - each node agent consults its synced cluster view to spill tasks it
    cannot run locally (ray: LocalTaskManager::Spillback).
"""
from __future__ import annotations

from dataclasses import dataclass

# view: {node_id: {"agent_addr", "total", "available", "load", "labels"}}
View = dict[str, dict]


@dataclass
class NodeAffinity:
    node_id: str | None
    soft: bool = False


@dataclass
class Spread:
    pass


def labels_match(node_labels: dict | None, constraints: dict | None) -> bool:
    """constraints: {key: {"op": "in"|"notin"|"exists"|"absent",
    "values": [...]}} (lowered by NodeLabelSchedulingStrategy)."""
    if not constraints:
        return True
    labels = node_labels or {}
    for key, c in constraints.items():
        op = c.get("op", "in")
        has = key in labels
        val = labels.get(key)
        if op == "in" and (not has or val not in c.get("values", [])):
            return False
        if op == "notin" and has and val in c.get("values", []):
            return False
        if op == "exists" and not has:
            return False
        if op == "absent" and has:
            return False
    return True


def feasible(total: dict[str, float], demand: dict[str, float]) -> bool:
    return all(total.get(k, 0.0) >= v for k, v in demand.items() if v > 0)


def available(avail: dict[str, float], demand: dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v - 1e-9 for k, v in demand.items() if v > 0)


def _utilization(node: dict) -> float:
    total, avail = node["total"], node["available"]
    utils = [1.0 - avail.get(k, 0.0) / t for k, t in total.items() if t > 0]
    return max(utils) if utils else 0.0


def pick_node(view: View, demand: dict[str, float], config,
              strategy=None, label_hard: dict | None = None,
              label_soft: dict | None = None) -> str | None:
    """Pick the best node for one resource demand; None if nothing fits now.

    Default hybrid policy (ray: hybrid_scheduling_policy.h:50): prefer the
    lowest-id node whose utilization stays under the spread threshold (pack);
    once every candidate is above it, prefer the least utilized (spread).
    """
    if isinstance(strategy, NodeAffinity) and strategy.node_id is not None:
        node = view.get(strategy.node_id)
        if node and feasible(node["total"], demand) \
                and available(node["available"], demand):
            return strategy.node_id
        if not strategy.soft:
            return None
        # soft affinity: fall through to hybrid over remaining nodes

    candidates = [
        (nid, n) for nid, n in sorted(view.items())
        if feasible(n["total"], demand) and available(n["available"], demand)
        and labels_match(n.get("labels"), label_hard)
    ]
    if not candidates:
        return None
    if label_soft:
        # Prefer soft-matching nodes; fall back to the rest (ray: soft
        # label constraints bias, never exclude).
        preferred = [(nid, n) for nid, n in candidates
                     if labels_match(n.get("labels"), label_soft)]
        if preferred:
            candidates = preferred
    if isinstance(strategy, Spread):
        return min(candidates, key=lambda kv: (_utilization(kv[1]), kv[0]))[0]
    threshold = config.scheduler_spread_threshold
    for nid, n in candidates:
        if _utilization(n) <= threshold:
            return nid
    return min(candidates, key=lambda kv: (_utilization(kv[1]), kv[0]))[0]

