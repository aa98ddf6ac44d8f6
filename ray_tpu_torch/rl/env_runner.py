"""EnvRunner actors: experience collection on the host (port of
ray_tpu/rl/env_runner.py).

N actors step numpy envs with the latest policy params and a numpy
forward pass (`rl/models.py` with xp=np), so collection touches no device
while the learners train on theirs (ray: rllib/env/
single_agent_env_runner.py, env_runner_group.py:71).  The runners are
actors of the runtime the group is given (`serve/runtime.py`: a
`LocalRuntime`, or a binding to a cluster); the numpy code is the
reference's, so the same seed and params give the same fragments bit for
bit.
"""
from __future__ import annotations

import numpy as np

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.serve.runtime import ServeRuntime


class EnvRunner:
    """One sampling actor: runs an env loop with the shipped params."""

    def __init__(self, env_name, seed: int = 0, gamma: float = 0.99,
                 gae_lambda: float = 0.95):
        self.env = make_env(env_name, seed=seed)
        self.rng = np.random.default_rng(seed + 1000)
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.obs = self.env.reset()
        self.episode_return = 0.0
        self.completed_returns: list[float] = []

    def sample(self, params: dict, n_steps: int,
               epsilon: float | None = None,
               with_gae: bool = True) -> dict:
        """Collect n_steps transitions.  With epsilon set, act
        epsilon-greedily on Q-values (DQN); otherwise sample the categorical
        policy, attaching GAE advantages when with_gae (PPO; IMPALA/SAC
        take raw fragments and correct off-policy on the learner).
        """
        obs_buf = np.zeros((n_steps, len(self.obs)), np.float32)
        act_buf = np.zeros((n_steps,), np.int64)
        rew_buf = np.zeros((n_steps,), np.float32)
        done_buf = np.zeros((n_steps,), np.float32)
        trunc_buf = np.zeros((n_steps,), np.float32)
        logp_buf = np.zeros((n_steps,), np.float32)
        next_obs_buf = np.zeros_like(obs_buf)

        for t in range(n_steps):
            obs_buf[t] = self.obs
            logits = models.policy_logits(params, self.obs)
            if epsilon is not None:
                if self.rng.random() < epsilon:
                    a = int(self.rng.integers(len(logits)))
                else:
                    a = int(np.argmax(logits))
                logp = 0.0
            else:
                a, logp = models.sample_action(logits, self.rng)
            nxt, r, terminated, truncated = self.env.step(a)
            act_buf[t], rew_buf[t], logp_buf[t] = a, r, logp
            next_obs_buf[t] = nxt
            self.episode_return += r
            done = terminated or truncated
            done_buf[t] = float(terminated)   # bootstrap through truncation
            trunc_buf[t] = float(truncated and not terminated)
            if done:
                self.completed_returns.append(self.episode_return)
                self.episode_return = 0.0
                self.obs = self.env.reset()
            else:
                self.obs = nxt

        batch = {"obs": obs_buf, "actions": act_buf, "rewards": rew_buf,
                 "dones": done_buf, "truncs": trunc_buf, "logp": logp_buf,
                 "next_obs": next_obs_buf}
        if epsilon is None and with_gae:
            batch.update(self._gae(params, batch))
        rets, self.completed_returns = self.completed_returns, []
        batch["episode_returns"] = np.array(rets, np.float32)
        return batch

    def _gae(self, params: dict, batch: dict) -> dict:
        return compute_gae(params, batch, self.gamma, self.gae_lambda)


def compute_gae(params: dict, batch: dict, gamma: float,
                gae_lambda: float) -> dict:
    """Generalized advantage estimation (rllib:
    connectors/learner/general_advantage_estimation.py semantics), the
    one implementation shared by the single- and multi-agent runners."""
    v = models.value(params, batch["obs"])
    v_next = models.value(params, batch["next_obs"])
    n = len(v)
    adv = np.zeros(n, np.float32)
    last = 0.0
    for t in range(n - 1, -1, -1):
        nonterminal = 1.0 - batch["dones"][t]
        # The lambda-carry must stop at ANY episode edge (terminal or
        # truncation): the next buffer row belongs to a fresh episode.
        boundary = max(batch["dones"][t], batch["truncs"][t])
        delta = batch["rewards"][t] + \
            gamma * v_next[t] * nonterminal - v[t]
        last = delta + gamma * gae_lambda * (1.0 - boundary) * last
        adv[t] = last
    returns = adv + v
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    return {"advantages": adv.astype(np.float32),
            "value_targets": returns.astype(np.float32)}


class EnvRunnerGroup:
    """Caller-side handle to N EnvRunner actors of `runtime` (ray:
    env_runner_group.py:71).  The null runtime makes no actors: building
    a group on it raises, naming LocalRuntime."""

    def __init__(self, env_name, num_env_runners: int = 2,
                 gamma: float = 0.99, gae_lambda: float = 0.95,
                 num_cpus_per_env_runner: float = 1.0, runtime=None):
        self.runtime = runtime or ServeRuntime()
        cls = self.runtime.remote(EnvRunner)
        self.runners = [
            cls.options(num_cpus=num_cpus_per_env_runner).remote(
                env_name, seed=i * 7919, gamma=gamma, gae_lambda=gae_lambda)
            for i in range(num_env_runners)]

    def sample(self, params_np: dict, n_steps_per_runner: int,
               epsilon: float | None = None,
               with_gae: bool = True) -> list[dict]:
        params_ref = self.runtime.put(params_np)   # ship once, not per runner
        return self.runtime.get([
            r.sample.remote(params_ref, n_steps_per_runner, epsilon,
                            with_gae)
            for r in self.runners])

    def stop(self) -> None:
        for r in self.runners:
            try:
                self.runtime.kill(r)
            except Exception:  # noqa: BLE001
                pass
