"""Online GRPO-style RLHF in one process: serve-engine rollouts -> learner
update -> live weight sync (port of ray_tpu/rl/rlhf.py, local mode).

The loop
--------
1. **Rollout**: an `LLMRolloutWorker` (rl/rollout_llm.py) generates K
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
3. **Sync**: `update_weights` stages the learner's tensors themselves on
   the engine (on the card, one device-to-device copy at the swap), and
   the trainer waits until the engine has swapped (`weight_version`
   flips) before it returns: the learner's next in-place update must not
   reach the engine under the old version.  The engine swaps between
   decode windows, so decode never drains.  Generation never lags the
   learner by more than `max_weight_lag` versions.

Kill switches: RAY_TPU_RL_WEIGHT_SYNC=0 freezes the serving policy (read
per call by the engine: the same-run frozen-policy A/B); `sync_every=0`
never syncs.

Determinism: the minibatch order comes from a `torch.Generator` seeded
by (seed + 101, version), sampling from the engine's counter-hash
Gumbel-max, `params=None` weights from a `torch.Generator` seeded by
`seed`: two runs from one seed are bit-identical on one device, but
neither matches JAX's threefry streams.

Differences from the reference (ROADMAP.md queue 3): `num_rollout_workers
> 0` and `remote_learner=True` (rollout workers and the learner as
actors, the collective weight broadcast, crash recovery) raise
NotImplementedError: that path waits for the runtime seam (ROADMAP.md
queue 1 item 5b).  `mesh` raises too.  `get_params_numpy` returns CPU
tensors (numpy has no bf16).  Checkpoints are `train/checkpoint.py`'s
torch format.  No tracing spans, metrics or failpoints yet.  The
recovery counters of the reference's metrics and stats() (rollout_regens,
learner_restarts, epoch) come with the actor topology: the reference's
local mode never moves them from 0, so they are left out until then, and
`rollout_retries` is not read.  `device` (an added config field) places
the learner and the engine: CUDA unless "cpu" is asked for.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import as_tensor
from ray_tpu_torch.parallel.sharding import tree_map
from ray_tpu_torch.rl import rollout_llm
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.step import param_leaves

ADAM = dict(betas=(0.9, 0.999), eps=1e-8)     # optax.adam's defaults
ACTOR_TOPOLOGY = (
    "the actor topology (rollout workers or the learner as actors, the "
    "collective weight broadcast, crash recovery) is not ported yet: "
    "ROADMAP.md queue 1 item 5b; use num_rollout_workers=0")


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
    # Topology: 0 rollout workers = everything in-process (the only
    # topology ported); >0 and remote_learner raise NotImplementedError.
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
    # Regen attempts per dead rollout worker: read by the actor topology
    # only (the reference's local mode never reads it either), so here it
    # has no effect.
    rollout_retries: int = 2
    # Extension points: custom rollout-worker / learner classes (same
    # constructor contracts as LLMRolloutWorker / GRPOLearner).
    worker_cls: Any = None
    learner_cls: Any = None
    name: str = "rlhf"
    # The port's addition: where the learner and the engine run (None =
    # cuda; "cpu" runs the plain versions).
    device: Any = None


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
    the reference learner's state."""

    def __init__(self, config=None, params: Any = None, mesh=None,
                 device=None, **overrides):
        cfg = _to_config(config, overrides)
        if mesh is not None:
            raise NotImplementedError(
                "GRPOLearner(mesh=...): the sharded learner is not ported "
                "yet (ROADMAP.md queue 1 item 5b)")
        self.cfg = cfg
        self.mcfg = _model_config(cfg)
        self.device = resolve_device(
            device if device is not None else cfg.device, "GRPOLearner")
        src = params if params is not None else cfg.params
        if src is None:
            src = llama.init_params(self.mcfg, torch.Generator(
                device=self.device).manual_seed(cfg.seed))
        # The learner's own tensors: never shared with an engine.
        self.params = tree_map(
            lambda t: as_tensor(t).detach().to(
                device=self.device, dtype=self.mcfg.dtype,
                copy=True).requires_grad_(True), src)
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
        self.opt.step()
        return [x.detach() for x in (loss, pi_loss, kl,
                                     (ratio * mask).sum() / denom)]

    def update(self, trajs) -> dict:
        """One GRPO update over a trajectory batch or a list of them."""
        trajs = list(trajs) if isinstance(trajs, (list, tuple)) \
            else [trajs]
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

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device)

        out, n_mb = None, 0
        for s in range(0, B, mb):
            idx = idx_order[s:s + mb]
            out = self._minibatch(dev(batch["tokens"][idx]),
                                  dev(batch["mask"][idx]),
                                  dev(batch["logprobs"][idx]),
                                  dev(adv_all[idx]))
            n_mb += 1
        loss, pi_loss, kl, ratio = (float(x) for x in out)
        self.version += 1
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
        }

    # ---------------------------------------------------- weight export
    def params_tree(self) -> dict:
        """The learner's parameter tensors themselves (detached views, no
        copy): what a local weight sync stages on the engine.  They change
        at the next update."""
        return tree_map(torch.Tensor.detach, self.params)

    def get_params_numpy(self) -> dict:
        """Host copy of the param tree.  The name is the reference's; the
        leaves are CPU tensors, since numpy has no bf16."""
        return tree_map(lambda t: t.detach().to("cpu", copy=True),
                         self.params)

    def param_hash(self) -> str:
        """Stable content hash of the param tree: each leaf's raw bytes,
        in param_leaves order (process-stable, never Python hash())."""
        h = hashlib.blake2b(digest_size=16)
        for leaf in param_leaves(self.params):
            raw = leaf.detach().cpu().contiguous().reshape(-1)
            h.update(raw.view(torch.uint8).numpy().tobytes())
        return h.hexdigest()

    # ------------------------------------------------------- state
    def state_tree(self) -> dict:
        """(params, Adam mu / nu / count, version) as one tree of tensors
        (views of the live state, not copies; zeros before the first
        update, as optax's fresh state)."""
        def moment(key):
            def get(p):
                t = self.opt.state.get(p, {}).get(key)
                return torch.zeros_like(p) if t is None else t
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
        moments and count replaced.  Returns the version."""
        def put(p, s):
            s = as_tensor(s)
            if tuple(s.shape) != tuple(p.shape):
                raise ValueError(f"load_state: param shape "
                                 f"{tuple(s.shape)} != {tuple(p.shape)}")
            p.copy_(s)

        with torch.no_grad():
            tree_map(put, self.params, state["params"])
        opt = state["opt_state"]
        count = float(np.asarray(as_tensor(opt["count"]).cpu()))
        moments = [param_leaves(tree_map(
            lambda t: as_tensor(t).to(device=self.device,
                                      dtype=self.mcfg.dtype, copy=True),
            opt[k])) for k in ("mu", "nu")]
        self.opt.state.clear()
        for p, mu, nu in zip(param_leaves(self.params), *moments):
            if tuple(mu.shape) != tuple(p.shape) \
                    or tuple(nu.shape) != tuple(p.shape):
                raise ValueError(f"load_state: moment shape "
                                 f"{tuple(mu.shape)} != {tuple(p.shape)}")
            self.opt.state[p] = {"step": torch.tensor(count),
                                 "exp_avg": mu, "exp_avg_sq": nu}
        self.version = int(np.asarray(as_tensor(state["version"]).cpu()))
        return self.version

    # ------------------------------------------------------ checkpoints
    def save_async(self, path: str) -> int:
        """Kick an ASYNC checkpoint of (params, opt_state, version).  The
        state is snapshot before this returns, so the next update may run
        at once; `ckpt_wait()` confirms the write landed."""
        ckpt = Checkpoint.from_pytree_async(self.state_tree(), path=path)
        self._pending_ckpt = (self.version, path, ckpt)
        return self.version

    def ckpt_wait(self) -> tuple | None:
        """Block for the in-flight async save; returns (version, path)
        once durable, None if nothing pending."""
        if self._pending_ckpt is None:
            return None
        version, path, ckpt = self._pending_ckpt
        ckpt.wait()
        self._pending_ckpt = None
        return (version, path)

    def load(self, path: str) -> int:
        """Resume from a COMPLETED checkpoint directory."""
        state = Checkpoint(path).to_pytree(target=self.state_tree())
        return self.load_state(state)

    def pid(self) -> int:
        return os.getpid()


class RLHFTrainer:
    """The online loop driver, in one process: rollouts -> learner update
    -> async checkpoint -> live weight sync.  Seeded and bit-deterministic
    on one device."""

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
        self._prompt_cursor = 0
        self.version = 0
        self.weight_syncs = 0
        self.weight_sync_ms = 0.0
        self._newest_ckpt: tuple | None = None    # (version, path)
        self._worker_version: list[int] = []
        self._local = cfg.num_rollout_workers == 0
        self.workers: list = []
        self._build_learner()
        self._build_workers()

    # ------------------------------------------------------------ build
    def _worker_kwargs(self, i: int) -> dict:
        return dict(model=self.cfg.model, params=self.cfg.params,
                    seed=self.cfg.seed, engine=dict(self.cfg.engine),
                    reward_fn=self._reward,
                    name=f"{self.cfg.name}-w{i}", device=self.cfg.device)

    def _build_learner(self) -> None:
        if self.cfg.remote_learner and self._local:
            raise ValueError(
                "remote_learner requires num_rollout_workers >= 1 "
                "(a lone in-process loop has nothing to broadcast to)")
        if self.cfg.remote_learner or not self._local:
            raise NotImplementedError(ACTOR_TOPOLOGY)
        self.learner = (self.cfg.learner_cls or GRPOLearner)(self.cfg)

    def _build_workers(self) -> None:
        wcls = self.cfg.worker_cls or rollout_llm.LLMRolloutWorker
        self.workers = [wcls(**self._worker_kwargs(0))]
        self._worker_version = [0]

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
        return [self.workers[0].rollout(prompts, **self._rollout_kwargs())]

    # ------------------------------------------------------ weight sync
    def _sync_weights(self) -> None:
        """Push the current learner policy to the engine, timed
        end-to-end as weight_sync_ms.  Decode never pauses: the engine
        swaps between sync windows."""
        t0 = time.perf_counter()
        self._sync_weights_inner()
        self.weight_syncs += 1
        self.weight_sync_ms += (time.perf_counter() - t0) * 1000.0

    def _sync_weights_inner(self) -> None:
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

    def _lag_exceeded(self) -> bool:
        return (self.version - min(self._worker_version)
                > self.cfg.max_weight_lag)

    # ------------------------------------------------------------- loop
    def step(self) -> dict:
        """One full cycle: rollout -> update -> (async checkpoint) ->
        (sync).  The staleness bound runs FIRST: generation must never
        start more than max_weight_lag versions behind.  Besides the
        learner's metrics: "rollout" (generation and scoring seconds,
        completion tokens, prefix-hit and prefilled tokens), "update_s"
        and this step's "step_weight_sync_ms"."""
        ms0 = self.weight_sync_ms
        if self.cfg.sync_every and self.version and self._lag_exceeded():
            # sync_every=0 means NEVER sync — the lag bound only applies
            # when sync is enabled at all.
            self._sync_weights()
        trajs = self._gather_rollouts(self._next_prompts())
        t0 = time.perf_counter()
        metrics = self.learner.update(trajs)
        update_s = time.perf_counter() - t0
        self.version = metrics["version"]
        if self.cfg.checkpoint_every and \
                self.version % self.cfg.checkpoint_every == 0:
            self._checkpoint()
        if self.cfg.sync_every and \
                self.version % self.cfg.sync_every == 0:
            self._sync_weights()
        metrics["weight_syncs"] = self.weight_syncs
        metrics["rollout"] = {k: sum(t[k] for t in trajs) for k in (
            "gen_s", "score_s", "rollout_tokens", "prefix_hit_tokens",
            "prefill_tokens")}
        metrics["update_s"] = update_s
        metrics["step_weight_sync_ms"] = self.weight_sync_ms - ms0
        return metrics

    def run(self, n_updates: int) -> list[dict]:
        return [self.step() for _ in range(n_updates)]

    def _checkpoint(self) -> None:
        """Async save; the PREVIOUS save is confirmed (waited) first and
        becomes the newest resumable checkpoint."""
        base = self.cfg.checkpoint_dir
        if base is None:
            base = tempfile.mkdtemp(prefix="rlhf-ckpt-")
            self.cfg.checkpoint_dir = base
        done = self.learner.ckpt_wait()
        if done is not None:
            self._newest_ckpt = done
        path = os.path.join(base, f"v{self.version:06d}")
        self.learner.save_async(path)

    def flush_checkpoints(self) -> tuple | None:
        """Force the in-flight save durable."""
        done = self.learner.ckpt_wait()
        if done is not None:
            self._newest_ckpt = done
        return self._newest_ckpt

    # ------------------------------------------------------------ admin
    def stats(self) -> dict:
        return {
            "version": self.version,
            "weight_syncs": self.weight_syncs,
            "weight_sync_ms": round(self.weight_sync_ms, 3),
            "worker_versions": list(self._worker_version),
            "newest_ckpt": self._newest_ckpt,
            "workers": [self.workers[0].stats()],
        }

    def shutdown(self) -> None:
        for w in self.workers:
            w.stop()
