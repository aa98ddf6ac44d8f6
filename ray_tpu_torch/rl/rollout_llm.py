"""LLM rollout workers: GRPO-group generation through the serve engine
(port of ray_tpu/rl/rollout_llm.py).

A rollout worker owns a paged-KV `LLMEngine` (serve/llm.py) and generates
K completions per prompt, a GRPO *group*.  Every member of a group shares
its prompt, so after the first member prefills it the radix prefix cache
serves the other K-1 prompts from cached blocks: a group costs about one
prompt prefill plus K decode streams.

Per-trajectory behavior logprobs come from the model's teacher-forced
scoring path (`llama.token_logprobs`, under torch.no_grad) on the
engine's `params_snapshot()`: the engine samples from these logits, so
the scored logprob is the behavior policy's.  A weight swap can land
between a completion's decode windows; scoring then uses the newest
resident tree, the bounded staleness GRPO's clipped ratio absorbs (the
trainer's `max_weight_lag` bounds it).

Trajectories are dicts of numpy arrays with the reference's keys and
dtypes (int32 tokens, float32 logprobs / mask / rewards), so a batch made
by either framework feeds the other's learner.

The same class runs in the caller's process or as an actor of a runtime
(`serve/runtime.py`: a `LocalRuntime` or a binding to a cluster), spawned
with `max_concurrency >= 2`: `recv_weights` rides a second thread while
`rollout` decodes.  Its runtime calls go through the `runtime` it is
given: joining and leaving the trainer's weight-broadcast group, the
packed broadcast (`collective.broadcast_pytree`), resolving pushed refs,
the failpoint site `rl.rollout_step` (at rollout entry: a `crash` models
a rollout actor dying with a group in flight), and the rollout metrics
(`_rollout_metrics`: rl_rollout_groups, rl_rollout_tokens and
rl_rollout_prefix_hit_rate, tagged `worker`, updated at the end of each
rollout).  The worker's engine reports to the same runtime.  Runs on CUDA
unless `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from ray_tpu_torch.collective.collective import broadcast_pytree
from ray_tpu_torch.models import llama
from ray_tpu_torch.parallel.sharding import tree_map
from ray_tpu_torch.serve.llm import LLMEngine
from ray_tpu_torch.serve.runtime import ServeRuntime, resolve_tree


def _pow2(n: int, lo: int = 8) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


# ------------------------------------------------------------- rewards
def near_token_reward(target: int, vocab: int) -> Callable:
    """Dense builtin reward: mean over completion tokens of
    1 - |tok - target| / vocab.  Dense (every completion scores
    differently) so small GRPO groups see non-degenerate within-group
    variance — the learning-test reward."""
    def fn(prompt, completion) -> float:
        c = np.asarray(completion, np.float32)
        if c.size == 0:
            return 0.0
        return float(np.mean(1.0 - np.abs(c - float(target)) / vocab))
    return fn


def target_token_reward(target: int) -> Callable:
    """Sparse builtin reward: fraction of completion tokens equal to the
    target id."""
    def fn(prompt, completion) -> float:
        c = np.asarray(completion)
        return float(np.mean(c == target)) if c.size else 0.0
    return fn


def _rollout_metrics(runtime) -> dict:
    """The rollout counters on `runtime`, tagged per worker (the
    reference's names and descriptions)."""
    tk = ("worker",)
    return {
        "groups": runtime.metric("counter", "rl_rollout_groups",
                                 "GRPO prompt groups generated", tk),
        "tokens": runtime.metric("counter", "rl_rollout_tokens",
                                 "Completion tokens generated for RLHF",
                                 tk),
        "hit_rate": runtime.metric(
            "gauge", "rl_rollout_prefix_hit_rate",
            "Rollout prompt tokens served from the prefix cache", tk),
    }


class LLMRolloutWorker:
    """One rollout worker: paged-KV engine + trajectory scoring, in the
    caller's process or as an actor of `runtime`."""

    def __init__(self, model: Any = "debug", *, params: Any = None,
                 seed: int = 0, engine: dict | None = None,
                 reward_fn: Callable | None = None,
                 name: str = "rollout", device=None,
                 runtime: ServeRuntime | None = None):
        cfg = llama.llama_configs()[model] if isinstance(model, str) \
            else model
        ekw = dict(max_batch=8, max_len=min(cfg.max_seq, 1024),
                   page_size=64, steps_per_sync=4)
        ekw.update(engine or {})
        device = ekw.pop("device", device)
        self.cfg = cfg
        self.name = name
        self._runtime = runtime or ServeRuntime()
        self.engine = LLMEngine(cfg, params, seed=seed, name=name,
                                device=device, runtime=self._runtime,
                                **ekw)
        self.device = self.engine.device
        self.engine.start()
        self._reward = reward_fn or near_token_reward(
            cfg.vocab_size // 3, cfg.vocab_size)
        self.rollout_groups = 0
        self.rollout_completions = 0
        self.rollout_tokens = 0
        # Scoring needs no gradients, so no recompute either.
        self._score_cfg = dataclasses.replace(cfg, remat=False)

    # ------------------------------------------------------ collective
    def init_collective_group(self, world_size: int, rank: int,
                              backend: str = "object_store",
                              group_name: str = "default") -> None:
        """Join the trainer's weight-broadcast group (the
        create_collective_group contract; the runtime picks the
        transport, so `backend` is not read)."""
        self._runtime.init_collective_group(world_size, rank, group_name)

    def deregister_collective_group(self, group_name: str) -> None:
        """Drop this worker's state for a stale weight-sync epoch (the
        trainer destroys the group itself)."""
        self._runtime.deregister_collective_group(group_name)

    def _params_template(self) -> dict:
        """Shapes and dtypes of the engine's weights as CPU `torch.empty`
        leaves: no device fetch per sync."""
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                        self.engine.params)

    def recv_weights(self, version: int, group_name: str,
                     src_rank: int = 0) -> int:
        """Receive one packed weight broadcast and stage it on the engine;
        returns the staged version.  Decode keeps running: the engine
        swaps between decode windows."""
        tree = broadcast_pytree(self._params_template(), src_rank,
                                group_name, runtime=self._runtime)
        return self.engine.update_weights(tree, version)

    def update_weights(self, refs, version: int | None = None) -> int:
        """Direct weight push (the no-collective path: local mode, and the
        bootstrap of a replacement worker): `refs` is the tree (tensors or
        numpy), a runtime ref to it, or a list of refs to dict shards that
        merge into it.  The engine copies it into its resident weights
        between decode windows; the caller must not change the tree until
        `stats()["weight_version"]` shows the swap."""
        return self.engine.update_weights(
            resolve_tree(self._runtime, refs, timeout=300.0), version)

    def _score(self, params: dict, toks: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            t = torch.from_numpy(toks).to(self.device)
            lp = llama.token_logprobs(params, t, self._score_cfg)
            return lp.float().cpu().numpy()

    # --------------------------------------------------------- rollout
    def rollout(self, prompts: list, *, group_size: int = 4,
                max_new_tokens: int = 8, temperature: float = 1.0,
                eos_id: int | None = None) -> dict:
        """Generate a GRPO group of `group_size` completions per prompt
        and score them.  Returns the trajectory batch (numpy):

          tokens   [B, T]   prompt+completion ids, zero right-padded
          logprobs [B, T-1] behavior logprobs (valid under mask)
          mask     [B, T-1] 1.0 on completion-token positions
          prompt_len/total_len [B], rewards [B] (group-major: the K
          completions of prompt j occupy rows j*K..(j+1)*K-1)

        plus weight_version (the engine's resident policy version when
        scoring ran), gen_s, rollout_tokens, and the rollout's prefix
        hit/prefill token deltas (the group-sharing proof); score_s is
        the scoring time (the port's addition)."""
        self._runtime.failpoint("rl.rollout_step")
        if group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {group_size}")
        eng = self.engine
        hit0 = eng.stats().get("prefix_hit_tokens", 0)
        pre0 = eng.prefill_tokens
        t0 = time.perf_counter()
        # Leader/followers split: the radix cache commits a prompt's
        # blocks when a request FINISHES, so a whole group submitted at
        # once would prefill the shared prompt K times.  One leader per
        # prompt prefills and commits it (all prompts' leaders run
        # concurrently); the K-1 followers then prefix-hit those blocks.
        leader_futs = [eng.submit(
            list(p), max_new_tokens=max_new_tokens,
            temperature=temperature, eos_id=eos_id) for p in prompts]
        leader_outs = [f.result(timeout=600) for f in leader_futs]
        follower_futs = [
            [eng.submit(list(p), max_new_tokens=max_new_tokens,
                        temperature=temperature, eos_id=eos_id)
             for _ in range(group_size - 1)] for p in prompts]
        outs = []
        for j in range(len(prompts)):
            outs.append(leader_outs[j])
            outs.extend(f.result(timeout=600)
                        for f in follower_futs[j])
        gen_s = time.perf_counter() - t0
        # Score under the CURRENT resident tree: one consistent (params,
        # version) pair, copied under the engine's weights lock.
        t1 = time.perf_counter()
        params, version = eng.params_snapshot()
        seqs, plens = [], []
        for j, prompt in enumerate(prompts):
            for k in range(group_size):
                seqs.append(list(prompt)
                            + outs[j * group_size + k]["tokens"])
                plens.append(len(prompt))
        B = len(seqs)
        tlens = [len(s) for s in seqs]
        Tp = _pow2(max(tlens))
        Bp = _pow2(B, lo=1)
        toks = np.zeros((Bp, Tp), np.int32)
        for i, s in enumerate(seqs):
            toks[i, :len(s)] = s
        logp = self._score(params, toks)[:B]               # [B, Tp-1]
        del params
        score_s = time.perf_counter() - t1
        prompt_len = np.asarray(plens, np.int32)
        total_len = np.asarray(tlens, np.int32)
        # Completion token at absolute position j scores at column j-1.
        cols = np.arange(Tp - 1)[None, :]
        mask = ((cols >= (prompt_len - 1)[:, None])
                & (cols < (total_len - 1)[:, None])).astype(np.float32)
        rewards = np.asarray(
            [self._reward(prompts[i // group_size],
                          seqs[i][plens[i]:]) for i in range(B)],
            np.float32)
        new_tokens = int(total_len.sum() - prompt_len.sum())
        self.rollout_groups += len(prompts)
        self.rollout_completions += B
        self.rollout_tokens += new_tokens
        hit = eng.stats().get("prefix_hit_tokens", 0) - hit0
        prefilled = eng.prefill_tokens - pre0
        seen = hit + prefilled
        m = _rollout_metrics(self._runtime)
        tags = {"worker": self.name}
        m["groups"].inc(len(prompts), tags)
        m["tokens"].inc(new_tokens, tags)
        m["hit_rate"].set(hit / seen if seen else 0.0, tags)
        return {
            "tokens": toks[:B], "logprobs": logp, "mask": mask,
            "prompt_len": prompt_len, "total_len": total_len,
            "rewards": rewards, "group_size": group_size,
            "weight_version": version, "gen_s": gen_s,
            "rollout_tokens": new_tokens,
            "prefix_hit_tokens": hit, "prefill_tokens": prefilled,
            "score_s": score_s,
        }

    # ----------------------------------------------------------- admin
    def stats(self) -> dict:
        return {
            "rollout_groups": self.rollout_groups,
            "rollout_completions": self.rollout_completions,
            "rollout_tokens": self.rollout_tokens,
            "weight_version": self.engine.weight_version,
            "engine": self.engine.stats(),
        }

    def kv_check(self) -> dict:
        """Zero-leaked-KV probe: raises on any block accounting
        inconsistency."""
        return self.engine.kv_check()

    def pid(self) -> int:
        return os.getpid()

    def stop(self) -> None:
        self.engine.stop()
