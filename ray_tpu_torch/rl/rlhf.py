"""Online GRPO-style RLHF: serve-engine rollouts -> learner update -> live
weight sync (port of ray_tpu/rl/rlhf.py).

The loop
--------
1. **Rollout**: `LLMRolloutWorker`s (rl/rollout_llm.py) generate K
   completions per prompt through the paged-KV serve engine; the radix
   prefix cache makes a GRPO group cost about one prompt prefill.
2. **Update**: `GRPOLearner` computes group-relative advantages (reward
   standardized within each K-completion group, no value network) and
   one clipped-surrogate policy update plus `kl_coeff` times the k1 KL
   against the behavior policy, through `llama.token_logprobs`, with
   `torch.optim.Adam` (b1 0.9, b2 0.999, eps 1e-8: optax.adam's
   defaults; moments in the parameters' dtype).  On CUDA the backward
   runs the flash dQ and dK/dV kernels.  The learner owns its parameter
   tensors (with requires_grad) and updates them in place.
3. **Sync**: generation never lags the learner by more than
   `max_weight_lag` versions; engines swap weights between decode
   windows, so decode never drains.

Topologies
----------
- `num_rollout_workers=0` (local): one worker and the learner in the
  caller's process.  A sync stages the learner's tensors themselves on
  the engine (on the card, one device-to-device copy at the swap), and
  the trainer waits until the engine has swapped (`weight_version`
  flips) before it returns: the learner's next in-place update must not
  reach the engine under the old version.
- `num_rollout_workers=W > 0`: W rollout workers as actors of
  `cfg.runtime` (`serve/runtime.py`: a `LocalRuntime`, or a binding to a
  cluster), prompt j to worker j % W, the trajectories' refs handed to
  the learner, which resolves them through the runtime.  The learner is
  an actor too with `remote_learner=True`, else it lives in the trainer.
  A sync is one packed broadcast (`collective.broadcast_pytree`) from
  the learner, rank 0, to every worker over an epoch-named group.

Failure model (the reference's): a rollout actor that dies
(`rl.rollout_step` crash) loses only its in-flight group: the trainer
respawns it, pushes the current weights, and regenerates the group.  A
learner actor that dies (`rl.weight_sync` crash) resumes from the newest
completed async checkpoint; parked receivers are released through
`destroy_collective_group(reason)` and the group re-forms at the next
epoch.  `rollout_regens`, `learner_restarts` and `epoch` count it, in
`step()`'s metrics and in `stats()`.

Kill switches: RAY_TPU_RL_WEIGHT_SYNC=0 freezes the serving policy (read
per call by the engine: the same-run frozen-policy A/B); `sync_every=0`
never syncs.

Determinism: the minibatch order comes from a `torch.Generator` seeded
by (seed + 101, version), sampling from the engine's counter-hash
Gumbel-max, `params=None` weights from a `torch.Generator` seeded by
`seed`: two local runs from one seed are bit-identical on one device,
but neither matches JAX's threefry streams.

The mesh learner
----------------
`GRPOLearner(cfg, params, mesh=mesh)` lays its parameters out on a torch
`DeviceMesh` (parallel/mesh.py) by `llama.param_logical_axes`, as
`train/step.py`'s `sharded_init` does; Adam's moments take the same
layout.  The port's mesh is one rank per device, where the reference's is
one GSPMD program over all of them, so a mesh learner is a GROUP of
ranks: every rank of the mesh builds `GRPOLearner(..., mesh=mesh)` from
the same params and calls `update` with the same trajectories.  Each
minibatch's arrays are split over data x fsdp (`batch_shardings`), the
same `_minibatch` runs on the DTensors (attention on local shards,
through the kernels on CUDA), and every rank returns the same metrics and
advantages.  Gathering the full tree is a collective, so every rank
calls `get_params_numpy`, `param_hash`, `params_tree`, `state_tree`,
`save_async` / `ckpt_wait` / `load` and `broadcast_weights` together: the
mesh's first rank (its "lead") writes the checkpoint, joins the weight
broadcast group and broadcasts; the others gather and return.  A
checkpoint holds full tensors, so a mesh learner's loads into a
single-device learner and the reverse.  `RLHFTrainer` builds no mesh
learner, as in the reference.

Differences from the reference (ROADMAP.md queue 3): `cfg.runtime` (an
added config field) carries every runtime call, and the actor topology
needs one that makes actors (ValueError otherwise).  The mesh learner is
a group of ranks, and its gathers are collectives (above).
`get_params_numpy` returns CPU tensors (numpy has no bf16).  Checkpoints
are `train/checkpoint.py`'s torch format.  The learner's metrics carry
"update_s" (its own time, after the trajectories are in hand) and
"rollout" (the trajectories' generation and scoring sums, and "gen_s_max",
the slowest worker's generation).  The rollout metrics and the engines'
observability go through the runtime (rl/rollout_llm.py, serve/llm.py).
`device` (an added config field) places the learner and the engines: CUDA
unless "cpu" is asked for; on CUDA the learner and rollout actors ask the
runtime for a share of "GPU" besides the reference's `num_cpus=1`
(`RLHFTrainer._placement`), since the port's cluster gives CUDA only to
its device worker.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
import time
import uuid
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, distribute_tensor

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import as_tensor
from ray_tpu_torch.parallel.sharding import (logical_sharding, shard_params,
                                             tree_map)
from ray_tpu_torch.collective.collective import broadcast_pytree
from ray_tpu_torch.rl import rollout_llm
from ray_tpu_torch.serve.runtime import ServeRuntime, makes_actors
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.step import batch_shardings, param_leaves

ADAM = dict(betas=(0.9, 0.999), eps=1e-8)     # optax.adam's defaults


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a collective); a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


@dataclasses.dataclass
class RLHFConfig:
    """Knobs for the online loop."""
    model: Any = "debug"            # llama_configs name or LlamaConfig
    params: Any = None              # explicit init params (tests)
    seed: int = 0
    # Prompt pool (synthetic, seeded): n_prompts of prompt_len tokens.
    n_prompts: int = 8
    prompt_len: int = 12
    # GRPO shape.
    group_size: int = 4
    prompts_per_step: int = 2
    max_new_tokens: int = 8
    temperature: float = 1.0
    eos_id: int | None = None
    # Learner.
    lr: float = 1e-3
    clip: float = 0.2
    kl_coeff: float = 0.0
    adv_eps: float = 1e-4
    minibatch_size: int | None = None
    # Topology: 0 rollout workers = everything in-process (seeded,
    # bit-deterministic); >0 = actors of `runtime` + the packed weight
    # broadcast.  remote_learner puts the learner in its own actor
    # (required for learner-crash recovery to be survivable).
    num_rollout_workers: int = 0
    remote_learner: bool = False
    # Weight sync: every `sync_every` updates (0 = never); generation may
    # lag the learner by at most `max_weight_lag` versions before the
    # trainer forces a sync.
    sync_every: int = 1
    max_weight_lag: int = 1
    # Async checkpoints every N updates (0 = off) under checkpoint_dir.
    checkpoint_every: int = 0
    checkpoint_dir: str | None = None
    # Engine kwargs for rollout workers (page_size, kv_pages, ...).
    engine: dict = dataclasses.field(default_factory=dict)
    # Reward: "near_token" | "target_token" | callable(prompt, completion).
    reward: Any = "near_token"
    target_token: int | None = None
    rollout_retries: int = 2        # regen attempts per dead rollout
    # Extension points: custom rollout-worker / learner classes (same
    # constructor contracts as LLMRolloutWorker / GRPOLearner).
    worker_cls: Any = None
    learner_cls: Any = None
    name: str = "rlhf"
    # The port's additions: where the learner and the engines run (None =
    # cuda; "cpu" runs the plain versions), and the runtime of the actor
    # topology (serve/runtime.py: a LocalRuntime or a binding to a
    # cluster; None is a process outside any cluster, local mode only).
    device: Any = None
    runtime: Any = None


def _to_config(config, overrides) -> RLHFConfig:
    if config is None:
        cfg = RLHFConfig()
    elif isinstance(config, RLHFConfig):
        cfg = dataclasses.replace(config)
    else:
        cfg = RLHFConfig(**dict(config))
    for k, v in (overrides or {}).items():
        if not hasattr(cfg, k):
            raise ValueError(f"unknown RLHF config field {k!r}")
        setattr(cfg, k, v)
    return cfg


def _model_config(cfg: RLHFConfig) -> llama.LlamaConfig:
    return llama.llama_configs()[cfg.model] \
        if isinstance(cfg.model, str) else cfg.model


def _reward_fn(cfg: RLHFConfig) -> Callable:
    mcfg = _model_config(cfg)
    target = cfg.target_token if cfg.target_token is not None \
        else mcfg.vocab_size // 3
    if callable(cfg.reward):
        return cfg.reward
    if cfg.reward == "near_token":
        return rollout_llm.near_token_reward(target, mcfg.vocab_size)
    if cfg.reward == "target_token":
        return rollout_llm.target_token_reward(target)
    raise ValueError(
        f"unknown reward {cfg.reward!r}; valid: 'near_token', "
        "'target_token', or a callable(prompt, completion)")


def group_advantages(rewards, group_size: int, eps: float = 1e-4):
    """Group-relative advantages (the GRPO estimator, no value network):
    standardize each K-completion group's rewards to zero mean / unit
    std (population std).  A degenerate group (all rewards equal)
    contributes zero advantage; eps keeps it finite.  A tensor in gives a
    float32 tensor on its device; anything else a float32 numpy array."""
    is_tensor = isinstance(rewards, torch.Tensor)
    r = rewards.float() if is_tensor \
        else torch.from_numpy(np.asarray(rewards, np.float32))
    g = r.reshape(-1, group_size)
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, keepdim=True, correction=0)
    adv = ((g - mean) / (std + eps)).reshape(-1)
    return adv if is_tensor else adv.numpy()


def _concat_trajs(trajs: list[dict]) -> dict:
    """Stack worker trajectory batches into one learner batch, padding to
    the widest T (all are pow2-padded already, so this is a max)."""
    T = max(t["tokens"].shape[1] for t in trajs)

    def padded(key, width):
        out = []
        for t in trajs:
            a = np.asarray(t[key])
            if a.shape[1] < width:
                a = np.pad(a, ((0, 0), (0, width - a.shape[1])))
            out.append(a)
        return np.concatenate(out, axis=0)

    return {
        "tokens": padded("tokens", T).astype(np.int32),
        "logprobs": padded("logprobs", T - 1).astype(np.float32),
        "mask": padded("mask", T - 1).astype(np.float32),
        "rewards": np.concatenate(
            [np.asarray(t["rewards"], np.float32) for t in trajs]),
        "group_size": trajs[0]["group_size"],
        "rollout_tokens": int(sum(t["rollout_tokens"] for t in trajs)),
        "weight_version": min(int(t["weight_version"]) for t in trajs),
    }


class GRPOLearner:
    """GRPO policy update over llama params, in place.

    The update consumes a trajectory batch and returns metrics INCLUDING
    the advantages (numpy), which the determinism tests hash bit for
    bit.  Its state (`state_tree`) is the params, Adam's moments "mu" /
    "nu" and update "count", and the version: what `save_async` writes,
    `load` reads, and `models.convert.grpo_state_from_jax` builds from
    the reference learner's state.  With `mesh` (a DeviceMesh on the
    learner's device type) the params and moments are DTensors and the
    learner is one rank of a group (module docstring, "The mesh
    learner")."""

    def __init__(self, config=None, params: Any = None, mesh=None,
                 device=None, **overrides):
        cfg = _to_config(config, overrides)
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(
                f"GRPOLearner(mesh=...) takes a torch DeviceMesh (from "
                f"ray_tpu_torch.parallel.mesh.create_mesh over the default "
                f"process group), got {type(mesh).__name__}")
        self.cfg = cfg
        self._runtime = cfg.runtime or ServeRuntime()
        self.mcfg = _model_config(cfg)
        self.device = resolve_device(
            device if device is not None else cfg.device, "GRPOLearner")
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(
                f"GRPOLearner: the mesh is on {mesh.device_type!r} but the "
                f"learner on {self.device.type!r}; pass "
                f"device={mesh.device_type!r}, or a mesh made with "
                f"create_mesh(..., {self.device.type!r})")
        self.mesh = mesh
        src = params if params is not None else cfg.params
        if src is None:
            src = llama.init_params(self.mcfg, torch.Generator(
                device=self.device).manual_seed(cfg.seed))
        # The learner's own tensors: never shared with an engine.
        params = tree_map(
            lambda t: as_tensor(t).detach().to(
                device=self.device, dtype=self.mcfg.dtype, copy=True), src)
        if mesh is not None:
            params = shard_params(params, llama.param_logical_axes(
                self.mcfg), mesh)
        self.params = tree_map(lambda t: t.requires_grad_(True), params)
        # On a mesh Adam's moments are made like their params: DTensors
        # of the same layout.
        self.opt = torch.optim.Adam(param_leaves(self.params), lr=cfg.lr,
                                    **ADAM)
        self.version = 0
        self._pending_ckpt = None       # (version, path, Checkpoint)

    # ----------------------------------------------------------- update
    def _shuffle(self, B: int) -> np.ndarray:
        """Deterministic minibatch order from (seed + 101, version): the
        reference's fold_in discipline, with torch's generator."""
        seed = ((self.cfg.seed + 101) * 1_000_003 + self.version) % 2**63
        gen = torch.Generator().manual_seed(seed)
        return torch.randperm(B, generator=gen).numpy()

    def _minibatch(self, tokens, mask, blogp, adv):
        clip, klc = self.cfg.clip, self.cfg.kl_coeff
        for p in param_leaves(self.params):
            p.grad = None
        lp = llama.token_logprobs(self.params, tokens, self.mcfg)
        ratio = torch.exp(lp - blogp)
        a = adv[:, None]
        per = torch.minimum(ratio * a,
                            torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * a)
        denom = torch.clamp(mask.sum(), min=1.0)
        pi_loss = -(per * mask).sum() / denom
        # k1 KL estimate vs the behavior policy (bounds the off-policy
        # drift live sync introduces).
        kl = ((blogp - lp) * mask).sum() / denom
        loss = pi_loss + klc * kl
        loss.backward()
        if self.mesh is not None:
            for p in param_leaves(self.params):
                if tuple(p.grad.placements) != tuple(p.placements):
                    # A partial sum or another layout: reduce it to the
                    # parameter's, as GSPMD does.
                    p.grad = p.grad.redistribute(p.device_mesh,
                                                 p.placements)
        self.opt.step()
        return [_full(x.detach()) for x in (loss, pi_loss, kl,
                                            (ratio * mask).sum() / denom)]

    @property
    def _lead(self) -> bool:
        """Whether this rank leads its mesh (its first rank); a learner
        without a mesh leads itself."""
        if self.mesh is None:
            return True
        return int(self.mesh.mesh.flatten()[0]) == self.mesh.get_rank()

    def _placed(self, a: np.ndarray, axes: tuple) -> torch.Tensor:
        """A host array on the learner's device; on a mesh, split by the
        logical `axes`."""
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        if self.mesh is None:
            return t
        sh = logical_sharding(self.mesh, axes)
        return distribute_tensor(t, sh.mesh, sh.placements)

    def update(self, trajs) -> dict:
        """One GRPO update over a trajectory batch or a list of them (or
        of runtime refs to them, resolved here)."""
        rt = self._runtime
        trajs = [rt.get(t, timeout=600.0) if rt.is_ref(t) else t
                 for t in (trajs if isinstance(trajs, (list, tuple))
                           else [trajs])]
        t0 = time.perf_counter()
        batch = _concat_trajs(trajs)
        B = batch["tokens"].shape[0]
        K = batch["group_size"]
        if B % K:
            raise ValueError(
                f"batch rows {B} not a multiple of group_size {K} — "
                "trajectory groups arrived truncated")
        adv_all = group_advantages(batch["rewards"], K, self.cfg.adv_eps)
        mb = self.cfg.minibatch_size or B
        idx_order = self._shuffle(B) if mb < B else np.arange(B)
        rows = ("batch", "seq")       # batch_shardings' axes, [b, s] arrays
        if self.mesh is not None:
            assert batch_shardings(self.mesh).placements == \
                logical_sharding(self.mesh, rows).placements
        out, n_mb = None, 0
        for s in range(0, B, mb):
            idx = idx_order[s:s + mb]
            out = self._minibatch(self._placed(batch["tokens"][idx], rows),
                                  self._placed(batch["mask"][idx], rows),
                                  self._placed(batch["logprobs"][idx], rows),
                                  self._placed(adv_all[idx], ("batch",)))
            n_mb += 1
        loss, pi_loss, kl, ratio = (float(x) for x in out)
        self.version += 1
        rollout = {k: sum(t.get(k, 0) for t in trajs) for k in (
            "gen_s", "score_s", "rollout_tokens", "prefix_hit_tokens",
            "prefill_tokens")}
        rollout["gen_s_max"] = max(t.get("gen_s", 0.0) for t in trajs)
        return {
            "version": self.version,
            "loss": loss, "policy_loss": pi_loss, "kl": kl,
            "ratio_mean": ratio,
            "reward_mean": float(batch["rewards"].mean()),
            "reward_std": float(batch["rewards"].std()),
            "advantages": adv_all,
            "rollout_tokens": batch["rollout_tokens"],
            "batch_weight_version": batch["weight_version"],
            "minibatches": n_mb,
            "update_s": time.perf_counter() - t0,
            "rollout": rollout,
        }

    # ---------------------------------------------------- weight export
    def broadcast_weights(self, group_name: str,
                          src_rank: int = 0) -> int:
        """Rank-0 side of the live weight sync: the param tree as one
        packed broadcast (packed before this returns).  Failpoint
        `rl.weight_sync` fires inside the sync window: a crash models the
        learner dying mid-broadcast.  On a mesh every rank gathers the
        tree (a collective) and only the lead fires the failpoint and
        broadcasts; the others return the version."""
        tree = self.params_tree()
        if not self._lead:
            return self.version
        self._runtime.failpoint("rl.weight_sync")
        broadcast_pytree(tree, src_rank, group_name, runtime=self._runtime)
        return self.version

    def init_collective_group(self, world_size: int, rank: int,
                              backend: str = "object_store",
                              group_name: str = "default") -> None:
        """Join the weight-broadcast group (`backend` is the runtime's
        business and not read).  Of a mesh, only the lead joins."""
        if self._lead:
            self._runtime.init_collective_group(world_size, rank,
                                                group_name)

    def deregister_collective_group(self, group_name: str) -> None:
        """Drop this learner's state for a stale weight-sync epoch."""
        if self._lead:
            self._runtime.deregister_collective_group(group_name)

    def params_tree(self) -> dict:
        """The learner's parameter tensors themselves (detached views, no
        copy): what a local weight sync stages on the engine.  They change
        at the next update.  On a mesh: full copies, gathered (a
        collective)."""
        return tree_map(lambda t: _full(t.detach()), self.params)

    def get_params_numpy(self) -> dict:
        """Host copy of the param tree.  The name is the reference's; the
        leaves are CPU tensors, since numpy has no bf16.  On a mesh every
        rank calls it (the gather is a collective) and gets the whole
        tree."""
        return tree_map(lambda t: _full(t.detach()).to("cpu", copy=True),
                        self.params)

    def param_hash(self) -> str:
        """Stable content hash of the param tree: each leaf's raw bytes,
        in param_leaves order (process-stable, never Python hash()).  On a
        mesh, of the full leaves (a collective)."""
        h = hashlib.blake2b(digest_size=16)
        for leaf in param_leaves(self.params):
            raw = _full(leaf.detach()).cpu().contiguous().reshape(-1)
            h.update(raw.view(torch.uint8).numpy().tobytes())
        return h.hexdigest()

    # ------------------------------------------------------- state
    def state_tree(self) -> dict:
        """(params, Adam mu / nu / count, version) as one tree of tensors
        (views of the live state, not copies; zeros before the first
        update, as optax's fresh state).  On a mesh: full copies,
        gathered (a collective)."""
        def moment(key):
            def get(p):
                t = self.opt.state.get(p, {}).get(key)
                return _full(torch.zeros_like(p) if t is None else t)
            return tree_map(get, self.params)

        first = self.opt.state.get(param_leaves(self.params)[0], {})
        return {"params": self.params_tree(),
                "opt_state": {"mu": moment("exp_avg"),
                              "nu": moment("exp_avg_sq"),
                              "count": torch.tensor(
                                  float(first.get("step", 0.0)))},
                "version": np.asarray(self.version)}

    def load_state(self, state: dict) -> int:
        """Install a state tree (`state_tree`'s layout, tensors or numpy
        leaves): params copied into the learner's tensors in place, Adam's
        moments and count replaced.  Returns the version.  The leaves are
        whole tensors; a mesh learner lays them out like its params."""
        def like(p, s, what):
            """Whole leaf `s` on the learner's device, laid out as `p`."""
            s = as_tensor(s)
            if tuple(s.shape) != tuple(p.shape):
                raise ValueError(f"load_state: {what} shape "
                                 f"{tuple(s.shape)} != {tuple(p.shape)}")
            s = s.to(device=self.device, dtype=self.mcfg.dtype, copy=True)
            if isinstance(p, DTensor):
                s = distribute_tensor(s, p.device_mesh, p.placements)
            return s

        with torch.no_grad():
            tree_map(lambda p, s: p.copy_(like(p, s, "param")),
                     self.params, state["params"])
        opt = state["opt_state"]
        count = float(np.asarray(as_tensor(opt["count"]).cpu()))
        moments = [param_leaves(tree_map(
            lambda p, s: like(p, s, "moment"), self.params, opt[k]))
            for k in ("mu", "nu")]
        self.opt.state.clear()
        for p, mu, nu in zip(param_leaves(self.params), *moments):
            self.opt.state[p] = {"step": torch.tensor(count),
                                 "exp_avg": mu, "exp_avg_sq": nu}
        self.version = int(np.asarray(as_tensor(state["version"]).cpu()))
        return self.version

    # ------------------------------------------------------ checkpoints
    def save_async(self, path: str) -> int:
        """Kick an ASYNC checkpoint of (params, opt_state, version).  The
        state is snapshot before this returns, so the next update may run
        at once; `ckpt_wait()` confirms the write landed.  On a mesh every
        rank gathers the state and the lead writes it."""
        tree = self.state_tree()
        ckpt = Checkpoint.from_pytree_async(tree, path=path) \
            if self._lead else None
        self._pending_ckpt = (self.version, path, ckpt)
        return self.version

    def ckpt_wait(self) -> tuple | None:
        """Block for the in-flight async save; returns (version, path)
        once durable, None if nothing pending.  On a mesh every rank
        calls it and returns once the lead's write landed."""
        if self._pending_ckpt is None:
            return None
        version, path, ckpt = self._pending_ckpt
        if ckpt is not None:
            ckpt.wait()
        if self.mesh is not None:
            self._mesh_barrier()
        self._pending_ckpt = None
        return (version, path)

    def _mesh_barrier(self) -> None:
        """Return on every rank of the mesh once all have reached it (an
        all-reduce of a zero over every mesh dim)."""
        z = torch.zeros((), device=self.device)
        DTensor.from_local(z, self.mesh, [Partial()] * self.mesh.ndim,
                           run_check=False).full_tensor()

    def load(self, path: str) -> int:
        """Resume from a COMPLETED checkpoint directory (on a mesh, every
        rank reads it)."""
        state = Checkpoint(path).to_pytree(target=self.state_tree())
        return self.load_state(state)

    def pid(self) -> int:
        return os.getpid()


class RLHFTrainer:
    """The online loop driver: rollouts -> learner update -> async
    checkpoint -> live weight sync, with rollout-actor and learner crash
    recovery.  `num_rollout_workers=0` runs everything in-process (seeded,
    bit-deterministic on one device); otherwise the rollout workers (and,
    with `remote_learner`, the learner) are actors of `cfg.runtime` and
    weight sync rides the packed broadcast."""

    def __init__(self, config: RLHFConfig | dict | None = None,
                 **overrides):
        cfg = _to_config(config, overrides)
        self.cfg = cfg
        mcfg = _model_config(cfg)
        rng = np.random.default_rng(cfg.seed)
        self.prompts = [rng.integers(
            1, mcfg.vocab_size, cfg.prompt_len).tolist()
            for _ in range(cfg.n_prompts)]
        self._reward = _reward_fn(cfg)
        self._uid = uuid.uuid4().hex[:8]
        self._epoch = 0
        self._group_formed = False
        self._prompt_cursor = 0
        self.version = 0
        self.weight_syncs = 0
        self.weight_sync_ms = 0.0
        self.rollout_regens = 0
        self.learner_restarts = 0
        self._newest_ckpt: tuple | None = None    # (version, path)
        self._worker_version: list[int] = []
        self._local = cfg.num_rollout_workers == 0
        self._rt = cfg.runtime or ServeRuntime()
        self.workers: list = []
        self._build_learner()
        self._build_workers()

    # ------------------------------------------------------------ build
    def _worker_kwargs(self, i: int) -> dict:
        return dict(model=self.cfg.model, params=self.cfg.params,
                    seed=self.cfg.seed, engine=dict(self.cfg.engine),
                    reward_fn=self._reward,
                    name=f"{self.cfg.name}-w{i}", device=self.cfg.device,
                    runtime=self.cfg.runtime)

    def _learner_cls(self):
        return self.cfg.learner_cls or GRPOLearner

    def _worker_cls(self):
        return self.cfg.worker_cls or rollout_llm.LLMRolloutWorker

    def _placement(self) -> dict:
        """Actor options of the learner and the rollout workers: one CPU
        each, as the reference's, and where the config runs on CUDA a
        share of "GPU" too, so that a cluster places them where the card
        is (the port's device worker; a plain worker sees no CUDA device,
        and an actor that cannot reach one raises at construction).  The
        shares of the whole topology add up to half a card, so a full set
        of replacements fits beside actors not yet reaped."""
        opts = {"num_cpus": 1}
        if torch.device(self.cfg.device or "cuda").type == "cuda":
            opts["num_gpus"] = 1 / (2 * (1 + self.cfg.num_rollout_workers))
        return opts

    def _spawn_learner(self):
        return self._rt.remote(self._learner_cls()).options(
            **self._placement()).remote(self.cfg)

    def _spawn_worker(self, i: int):
        return self._rt.remote(self._worker_cls()).options(
            max_concurrency=4, **self._placement()).remote(
                **self._worker_kwargs(i))

    def _build_learner(self) -> None:
        if self.cfg.remote_learner and self._local:
            raise ValueError(
                "remote_learner requires num_rollout_workers >= 1 "
                "(a lone in-process loop has nothing to broadcast to)")
        if not self._local and not makes_actors(self.cfg.runtime):
            raise ValueError(
                f"num_rollout_workers={self.cfg.num_rollout_workers} needs "
                "a runtime that makes actors: set RLHFConfig.runtime to a "
                "LocalRuntime (serve/runtime.py; one process) or a binding "
                "to a cluster, or use num_rollout_workers=0")
        if self.cfg.remote_learner:
            self.learner = self._spawn_learner()
            # Fail fast if the actor cannot build (model typo etc.).
            self._rt.get(self.learner.pid.remote(), timeout=300.0)
        else:
            self.learner = self._learner_cls()(self.cfg)

    def _build_workers(self) -> None:
        if self._local:
            self.workers = [self._worker_cls()(**self._worker_kwargs(0))]
            self._worker_version = [0]
            return
        self.workers = [self._spawn_worker(i)
                        for i in range(self.cfg.num_rollout_workers)]
        self._rt.get([w.pid.remote() for w in self.workers], timeout=300.0)
        self._worker_version = [0] * len(self.workers)

    def _replace_worker(self, i: int) -> None:
        """Respawn a dead rollout actor and bootstrap it to the current
        policy with a direct weight push (it starts at version 0 from the
        seed); the broadcast group re-forms at the next sync (membership
        changed: a new epoch)."""
        try:
            self._rt.kill(self.workers[i])
        except Exception:  # noqa: BLE001 - already dead
            pass
        if self._group_formed:
            # The dead member invalidates the epoch: reap it now (N
            # crashes must not leak N groups).
            try:
                self._rt.destroy_collective_group(
                    self._group_name(),
                    reason=f"rlhf rollout worker {i} replaced; epoch "
                           f"{self._epoch} abandoned")
            except Exception:  # noqa: BLE001 - best effort
                pass
        self.workers[i] = self._spawn_worker(i)
        if self.version > 0:
            # Remote learner: the call's ref is the argument, so the tree
            # moves learner -> worker without the trainer holding it.
            params = self.learner.get_params_numpy.remote() \
                if self.cfg.remote_learner \
                else self.learner.get_params_numpy()
            v = self._rt.get(self.workers[i].update_weights.remote(
                params, self.version), timeout=120.0)
            self._worker_version[i] = v
        self._group_formed = False

    # ------------------------------------------------- learner recovery
    def _learner_call(self, method: str, *args, timeout: float = 300.0):
        fn = getattr(self.learner, method)
        if self.cfg.remote_learner:
            return self._rt.get(fn.remote(*args), timeout=timeout)
        return fn(*args)

    def _recover_learner(self) -> None:
        """A dead learner actor resumes from the newest completed async
        checkpoint (or from the seed's state when none finished); parked
        broadcast waiters are released first."""
        self.learner_restarts += 1
        if self._group_formed:
            self._rt.destroy_collective_group(
                self._group_name(),
                reason=f"rlhf learner died (restart "
                       f"{self.learner_restarts}); weight sync epoch "
                       f"{self._epoch} abandoned")
            self._group_formed = False
        try:
            self._rt.kill(self.learner)
        except Exception:  # noqa: BLE001
            pass
        self.learner = self._spawn_learner()
        if self._newest_ckpt is not None:
            self.version = self._learner_call("load", self._newest_ckpt[1])
        else:
            self.version = 0
            self._learner_call("pid")

    # -------------------------------------------------------- collective
    def _group_name(self) -> str:
        return f"rlhf_w:{self.cfg.name}:{self._uid}:{self._epoch}"

    def _form_group(self) -> None:
        """(Re-)form the weight-broadcast group: learner rank 0, rollout
        workers ranks 1..W, a fresh epoch-suffixed name per membership
        change."""
        if self._epoch >= 1:
            # Every member drops its own state for the previous epoch
            # (best effort: a dead member is being replaced anyway).
            prev = self._group_name()
            try:
                refs = [w.deregister_collective_group.remote(prev)
                        for w in self.workers]
                if self.cfg.remote_learner:
                    refs.append(self.learner.deregister_collective_group
                                .remote(prev))
                else:
                    self.learner.deregister_collective_group(prev)
                self._rt.get(refs, timeout=60.0)
            except Exception:  # noqa: BLE001 - best effort
                pass
        self._epoch += 1
        name = self._group_name()
        world = 1 + len(self.workers)
        refs = []
        if self.cfg.remote_learner:
            refs.append(self.learner.init_collective_group.remote(
                world, 0, "object_store", name))
        else:
            # In-trainer learner: rank 0 lives in this process.
            self.learner.init_collective_group(world, 0, "object_store",
                                               name)
        refs += [w.init_collective_group.remote(
            world, r + 1, "object_store", name)
            for r, w in enumerate(self.workers)]
        self._rt.get(refs, timeout=120.0)
        self._group_formed = True

    # ----------------------------------------------------------- rollout
    def _next_prompts(self) -> list[list[int]]:
        n = min(self.cfg.prompts_per_step, len(self.prompts))
        out = [self.prompts[(self._prompt_cursor + j)
                            % len(self.prompts)] for j in range(n)]
        self._prompt_cursor = (self._prompt_cursor + n) \
            % len(self.prompts)
        return out

    def _rollout_kwargs(self) -> dict:
        return dict(group_size=self.cfg.group_size,
                    max_new_tokens=self.cfg.max_new_tokens,
                    temperature=self.cfg.temperature,
                    eos_id=self.cfg.eos_id)

    def _gather_rollouts(self, prompts: list) -> list:
        """Dispatch prompt groups across workers: prompt j to worker
        j % W.  Local mode returns trajectory dicts; actor mode the
        rollout refs, which go to the learner untouched (it resolves them;
        the trainer never holds the bulk).  A dead worker surfaces when
        the learner resolves its ref: step() heals and regenerates."""
        if self._local:
            return [self.workers[0].rollout(prompts,
                                            **self._rollout_kwargs())]
        shards: dict[int, list] = {}
        for j, p in enumerate(prompts):
            shards.setdefault(j % len(self.workers), []).append(p)
        kw = self._rollout_kwargs()
        return [self.workers[i].rollout.remote(ps, **kw)
                for i, ps in shards.items()]

    def _heal_workers(self) -> None:
        """Replace every dead rollout actor (a liveness probe each);
        survivors keep their engines and prefix caches."""
        for i, w in enumerate(self.workers):
            try:
                self._rt.get(w.pid.remote(), timeout=60.0)
            except Exception:  # noqa: BLE001 - dead actor
                self._replace_worker(i)

    # ------------------------------------------------------ weight sync
    def _sync_weights(self) -> None:
        """Push the current learner policy to every engine, timed end to
        end as weight_sync_ms.  Decode never pauses: engines swap between
        decode windows."""
        t0 = time.perf_counter()
        mode = "local" if self._local else (
            "remote_learner" if self.cfg.remote_learner
            else "driver_learner")
        with self._rt.span("rl.weight_sync",
                           attrs={"version": self.version, "mode": mode}):
            self._sync_weights_inner()
        self.weight_syncs += 1
        self.weight_sync_ms += (time.perf_counter() - t0) * 1000.0

    def _sync_local(self) -> None:
        self._rt.failpoint("rl.weight_sync")
        v = self.learner.version
        ret = self.workers[0].update_weights(self.learner.params_tree(), v)
        if ret == v:
            # Staged (not kill-switched): the engine holds the learner's
            # own tensors and copies them at the swap, so wait until it
            # SWAPPED (stats().weight_version flips).  Then the next
            # rollout samples the new policy (local mode's determinism),
            # and the learner's next in-place update cannot reach the
            # engine under this version.  A frozen engine
            # (RAY_TPU_RL_WEIGHT_SYNC=0) returned its CURRENT version
            # instead, so there is nothing to wait for.
            deadline = time.monotonic() + 30.0
            while self.workers[0].stats()["weight_version"] < v:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"weight v{v} never became visible on the "
                        "local engine (loop dead?)")
                time.sleep(0.001)
        self._worker_version[0] = ret

    def _dispatch_broadcast(self) -> tuple:
        """A remote learner's broadcast call and every receiver's, on the
        current epoch's group."""
        name = self._group_name()
        bc = self.learner.broadcast_weights.remote(name)
        return bc, [w.recv_weights.remote(self.version, name)
                    for w in self.workers]

    def _finish_broadcast(self, bc, recv) -> None:
        self._rt.get(bc, timeout=300.0)
        for i, r in enumerate(recv):
            self._worker_version[i] = self._rt.get(r, timeout=300.0)

    def _sync_weights_inner(self) -> None:
        if self._local:
            self._sync_local()
        elif not self.cfg.remote_learner:
            # Actor workers, in-trainer learner: dispatch every receiver
            # first, then broadcast from this process.  A learner crash
            # here is a trainer crash, so no recovery arm.
            if not self._group_formed:
                self._form_group()
            name = self._group_name()
            recv = [w.recv_weights.remote(self.version, name)
                    for w in self.workers]
            self.learner.broadcast_weights(name)
            for i, r in enumerate(recv):
                self._worker_version[i] = self._rt.get(r, timeout=300.0)
        else:
            if not self._group_formed:
                self._form_group()
            bc, recv = self._dispatch_broadcast()
            try:
                self._finish_broadcast(bc, recv)
            except Exception:  # noqa: BLE001 - sync failed: diagnose
                # A dead rollout worker or a collective deadline lands
                # here too: probe the learner before condemning it
                # (recovering a healthy learner would roll training back
                # to the last checkpoint, or to the seed).
                try:
                    self._learner_call("pid", timeout=60.0)
                    learner_dead = False
                except Exception:  # noqa: BLE001
                    learner_dead = True
                if learner_dead:
                    self._recover_learner()
                else:
                    # Release any receiver still parked on the stale
                    # epoch, then replace whichever worker died.
                    self._rt.destroy_collective_group(
                        self._group_name(),
                        reason="rlhf weight sync failed (rollout "
                               "worker died mid-broadcast?); epoch "
                               f"{self._epoch} abandoned")
                    self._group_formed = False
                    self._heal_workers()
                # Drain the stale receivers, then sync again on a fresh
                # epoch so every (possibly replaced) member lands on the
                # current policy.
                for r in recv:
                    try:
                        self._rt.get(r, timeout=60.0)
                    except Exception:  # noqa: BLE001 - drained/aborted
                        pass
                self._form_group()
                self._finish_broadcast(*self._dispatch_broadcast())

    def _lag_exceeded(self) -> bool:
        return (self.version - min(self._worker_version)
                > self.cfg.max_weight_lag)

    def _update_with_recovery(self, trajs) -> dict:
        """Learner update with crash recovery.  A failure here is either
        the learner dying (the liveness probe fails: rebuild from the
        newest async checkpoint, retry) or a trajectory ref whose rollout
        worker died (the probe passes: re-raise, and step() regenerates
        the group)."""
        try:
            return self._learner_call("update", trajs)
        except Exception:  # noqa: BLE001
            if not self.cfg.remote_learner:
                raise
            try:
                self._learner_call("pid", timeout=60.0)
                alive = True
            except Exception:  # noqa: BLE001
                alive = False
            if alive:
                raise        # lost trajectories: step() regenerates
            self._recover_learner()
            return self._learner_call("update", trajs)

    # ------------------------------------------------------------- loop
    def step(self) -> dict:
        """One full cycle: rollout -> update -> (async checkpoint) ->
        (sync).  The staleness bound runs FIRST: generation must never
        start more than max_weight_lag versions behind.  Besides the
        learner's metrics (with its "rollout" sums and "update_s"):
        "weight_syncs", "rollout_regens", "learner_restarts", "epoch" and
        this step's "step_weight_sync_ms"."""
        ms0 = self.weight_sync_ms
        if self.cfg.sync_every and self.version and self._lag_exceeded():
            # sync_every=0 means NEVER sync: the lag bound only applies
            # when sync is enabled at all.
            self._sync_weights()
        prompts = self._next_prompts()
        if self._local:
            metrics = self._learner_call(
                "update", self._gather_rollouts(prompts))
        else:
            metrics = last_err = None
            for _attempt in range(1 + self.cfg.rollout_retries):
                trajs = self._gather_rollouts(prompts)
                try:
                    metrics = self._update_with_recovery(trajs)
                    last_err = None
                    break
                except Exception as e:  # noqa: BLE001 - rollout lost
                    last_err = e
                    self.rollout_regens += 1
                    self._heal_workers()
            if metrics is None:
                raise RuntimeError(
                    f"rollouts failed {1 + self.cfg.rollout_retries}x "
                    "(workers crash-looping?)") from last_err
        self.version = metrics["version"]
        if self.cfg.checkpoint_every and \
                self.version % self.cfg.checkpoint_every == 0:
            self._checkpoint()
        if self.cfg.sync_every and \
                self.version % self.cfg.sync_every == 0:
            self._sync_weights()
        metrics["weight_syncs"] = self.weight_syncs
        metrics["rollout_regens"] = self.rollout_regens
        metrics["learner_restarts"] = self.learner_restarts
        metrics["epoch"] = self._epoch
        metrics["step_weight_sync_ms"] = self.weight_sync_ms - ms0
        return metrics

    def run(self, n_updates: int) -> list[dict]:
        return [self.step() for _ in range(n_updates)]

    def _checkpoint(self) -> None:
        """Async save; the PREVIOUS save is confirmed (waited) first and
        becomes the newest resumable checkpoint, so learner recovery never
        points at a half-written directory."""
        base = self.cfg.checkpoint_dir
        if base is None:
            base = tempfile.mkdtemp(prefix="rlhf-ckpt-")
            self.cfg.checkpoint_dir = base
        done = self._learner_call("ckpt_wait")
        if done is not None:
            self._newest_ckpt = done
        path = os.path.join(base, f"v{self.version:06d}")
        self._learner_call("save_async", path)

    def flush_checkpoints(self) -> tuple | None:
        """Force the in-flight save durable."""
        done = self._learner_call("ckpt_wait")
        if done is not None:
            self._newest_ckpt = done
        return self._newest_ckpt

    # ------------------------------------------------------------ admin
    def stats(self) -> dict:
        out = {
            "version": self.version,
            "weight_syncs": self.weight_syncs,
            "weight_sync_ms": round(self.weight_sync_ms, 3),
            "rollout_regens": self.rollout_regens,
            "learner_restarts": self.learner_restarts,
            "epoch": self._epoch,
            "worker_versions": list(self._worker_version),
            "newest_ckpt": self._newest_ckpt,
        }
        if self._local:
            out["workers"] = [self.workers[0].stats()]
        return out

    def shutdown(self) -> None:
        if self._local:
            self.workers[0].stop()
            return
        if self._group_formed:
            try:
                self._rt.destroy_collective_group(
                    self._group_name(), reason="rlhf trainer shutdown")
            except Exception:  # noqa: BLE001
                pass
        for w in self.workers:
            try:
                self._rt.kill(w)
            except Exception:  # noqa: BLE001
                pass
        if self.cfg.remote_learner:
            try:
                self._rt.kill(self.learner)
            except Exception:  # noqa: BLE001
                pass
