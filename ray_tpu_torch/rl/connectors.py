"""ConnectorV2 pipelines: composable batch transforms between env
runners and learners (a copy of ray_tpu/rl/connectors.py, which the port
may not import).

Each piece is a pure callable `(batch_or_fragments, ctx) -> batch` on
numpy arrays, and a pipeline is their composition (ray:
rllib/connectors/connector_v2.py:29, connector_pipeline_v2.py).
Algorithms build their env->learner pipeline in
`build_env_to_learner_pipeline()`: PPO, DQN and SAC concatenate fragments
into time-flattened rows, IMPALA and APPO stack them into the V-trace
[B, T] layout.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np


class ConnectorCtx:
    """Per-pass context: the algorithm (for metric sinks) + scratch."""

    def __init__(self, algorithm=None):
        self.algorithm = algorithm
        self.extra: dict[str, Any] = {}


class ConnectorV2:
    """One transform in a pipeline (ray: connector_v2.py:29)."""

    def __call__(self, data, ctx: ConnectorCtx):
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


class ConnectorPipelineV2(ConnectorV2):
    """Sequential composition with list surgery (ray:
    connector_pipeline_v2.py append/prepend/insert_before_or_after)."""

    def __init__(self, *pieces: ConnectorV2):
        self.pieces: list[ConnectorV2] = list(pieces)

    def __call__(self, data, ctx: ConnectorCtx):
        for p in self.pieces:
            data = p(data, ctx)
        return data

    def append(self, piece: ConnectorV2) -> "ConnectorPipelineV2":
        self.pieces.append(piece)
        return self

    def prepend(self, piece: ConnectorV2) -> "ConnectorPipelineV2":
        self.pieces.insert(0, piece)
        return self

    def insert_before(self, name: str,
                      piece: ConnectorV2) -> "ConnectorPipelineV2":
        self.pieces.insert(self._index(name), piece)
        return self

    def insert_after(self, name: str,
                     piece: ConnectorV2) -> "ConnectorPipelineV2":
        self.pieces.insert(self._index(name) + 1, piece)
        return self

    def remove(self, name: str) -> "ConnectorPipelineV2":
        self.pieces.pop(self._index(name))
        return self

    def _index(self, name: str) -> int:
        for i, p in enumerate(self.pieces):
            if p.name == name:
                return i
        raise ValueError(f"no connector named {name!r} in pipeline "
                         f"({[p.name for p in self.pieces]})")


# ------------------------------------------------------------- pieces
class RecordEpisodeMetrics(ConnectorV2):
    """Pop per-fragment episode returns + count env steps into the
    algorithm's metric state (ray: the metrics-logger episode connector)."""

    def __call__(self, fragments: list[dict], ctx: ConnectorCtx):
        algo = ctx.algorithm
        for b in fragments:
            if "episode_returns" in b:
                rets = b.pop("episode_returns")
                if algo is not None:
                    algo._episode_returns.extend(np.asarray(rets).tolist())
            if algo is not None:
                algo._timesteps += len(b["obs"])
        return fragments


class ConcatFragments(ConnectorV2):
    """Fragments → one time-flattened batch [N, ...] (PPO/DQN layout)."""

    def __call__(self, fragments: list[dict], ctx: ConnectorCtx):
        return {k: np.concatenate([b[k] for b in fragments])
                for k in fragments[0]}


class StackFragments(ConnectorV2):
    """Fragments → [B, T, ...] batch, one row per time-ordered fragment
    (the V-trace layout: IMPALA/APPO)."""

    def __call__(self, fragments: list[dict], ctx: ConnectorCtx):
        return {k: np.stack([b[k] for b in fragments])
                for k in fragments[0]}


class FnConnector(ConnectorV2):
    """Wrap a plain function as a pipeline piece."""

    def __init__(self, fn: Callable, name: str | None = None):
        self._fn = fn
        self._name = name or getattr(fn, "__name__", "FnConnector")

    def __call__(self, data, ctx: ConnectorCtx):
        return self._fn(data, ctx)

    @property
    def name(self) -> str:
        return self._name
