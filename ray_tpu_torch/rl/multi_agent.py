"""Multi-agent RL: env interface, env runner, and multi-policy PPO (port of
ray_tpu/rl/multi_agent.py).

Analog of ray: rllib/env/multi_agent_env.py (MultiAgentEnv: dict-keyed
obs/action/reward per agent), rllib/env/multi_agent_env_runner.py
(per-agent stepping, per-POLICY batch collection via the agent->policy
mapping) and the multi-policy training loop (one learner group per
policy, ray: config.multi_agent(policies=..., policy_mapping_fn=...)).

The runners are actors of the algorithm's runtime and step numpy envs on
the host; each policy's learner runs on the algorithm's device.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import CartPole, make_env, register_env
from ray_tpu_torch.rl.env_runner import compute_gae
from ray_tpu_torch.rl.learner import LearnerGroup
from ray_tpu_torch.rl.ppo import PPO


class MultiAgentEnv:
    """Dict-keyed multi-agent episode protocol (ray: MultiAgentEnv).

    reset() -> {agent_id: obs}
    step({agent_id: action}) ->
        (obs, rewards, terminateds, truncateds, infos)
      with per-agent dicts.  Agents whose episode ended reset inside the
      env (continuing-stream semantics; per-episode returns are reported
      by the runner); their `obs` entry is then the FRESH episode's
      observation, and infos[agent]["final_obs"] carries the true last
      observation of the ended episode (the gymnasium convention) so
      value bootstrapping through truncation stays correct.
    """

    agents: list[str] = []
    obs_dim: int = 0
    n_actions: int = 0

    def reset(self) -> dict:
        raise NotImplementedError

    def step(self, actions: dict
             ) -> tuple[dict, dict, dict, dict, dict]:
        raise NotImplementedError


class MultiCartPole(MultiAgentEnv):
    """N independent CartPoles under one multi-agent env — the standard
    correctness harness for multi-agent plumbing (each agent's stream
    must train exactly like the single-agent env would)."""

    def __init__(self, seed: int = 0, num_agents: int = 2):
        self.agents = [f"agent_{i}" for i in range(num_agents)]
        self._envs = {aid: CartPole(seed=seed + i * 101)
                      for i, aid in enumerate(self.agents)}
        self.obs_dim = CartPole.obs_dim
        self.n_actions = CartPole.n_actions

    def reset(self) -> dict:
        return {aid: env.reset() for aid, env in self._envs.items()}

    def step(self, actions: dict):
        obs, rew, term, trunc, infos = {}, {}, {}, {}, {}
        for aid, a in actions.items():
            o, r, te, tr = self._envs[aid].step(a)
            infos[aid] = {}
            if te or tr:
                infos[aid]["final_obs"] = o
                o = self._envs[aid].reset()
            obs[aid], rew[aid], term[aid], trunc[aid] = o, r, te, tr
        return obs, rew, term, trunc, infos


register_env("MultiCartPole", MultiCartPole)


class MultiAgentEnvRunner:
    """Per-agent stepping, per-policy batch collection (ray:
    multi_agent_env_runner.py).  Each agent's transition stream stays
    contiguous so GAE carries correctly; per-policy batches concatenate
    the streams of the agents the mapping assigns to that policy."""

    def __init__(self, env_name, policy_mapping: dict[str, str],
                 seed: int = 0, gamma: float = 0.99,
                 gae_lambda: float = 0.95):
        self.env = make_env(env_name, seed=seed)
        self.mapping = dict(policy_mapping)
        self.rng = np.random.default_rng(seed + 1000)
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.obs = self.env.reset()
        self.ep_return = {aid: 0.0 for aid in self.env.agents}
        self.completed: dict[str, list] = {aid: [] for aid in
                                           self.env.agents}

    def sample(self, params_by_policy: dict, n_steps: int,
               with_gae: bool = True) -> dict:
        """n_steps env ticks -> {policy_id: batch} (+ "episode_returns"
        per batch, pooled across that policy's agents)."""
        agents = self.env.agents
        buf = {aid: {"obs": [], "actions": [], "rewards": [], "dones": [],
                     "truncs": [], "logp": [], "next_obs": []}
               for aid in agents}
        for _ in range(n_steps):
            actions = {}
            for aid in agents:
                pid = self.mapping[aid]
                logits = models.policy_logits(
                    params_by_policy[pid], self.obs[aid])
                a, logp = models.sample_action(logits, self.rng)
                actions[aid] = a
                b = buf[aid]
                b["obs"].append(self.obs[aid])
                b["actions"].append(a)
                b["logp"].append(logp)
            nxt, rew, term, trunc, infos = self.env.step(actions)
            for aid in agents:
                b = buf[aid]
                b["rewards"].append(rew[aid])
                b["dones"].append(float(term[aid]))
                b["truncs"].append(float(trunc[aid] and not term[aid]))
                # True last obs of an ended episode (NOT the reset obs):
                # GAE bootstraps V(final_obs) through truncation.
                b["next_obs"].append(
                    infos.get(aid, {}).get("final_obs", nxt[aid]))
                self.ep_return[aid] += rew[aid]
                if term[aid] or trunc[aid]:
                    self.completed[aid].append(self.ep_return[aid])
                    self.ep_return[aid] = 0.0
            self.obs = nxt

        out: dict[str, dict] = {}
        for aid in agents:
            pid = self.mapping[aid]
            b = {k: np.asarray(v, np.float32) if k not in
                 ("actions",) else np.asarray(v, np.int64)
                 for k, v in buf[aid].items()}
            b["obs"] = b["obs"].astype(np.float32)
            if with_gae:
                b.update(self._gae(params_by_policy[pid], b))
            rets = np.asarray(self.completed[aid], np.float32)
            self.completed[aid] = []
            if pid not in out:
                b["episode_returns"] = rets
                out[pid] = b
            else:
                prev = out[pid]
                out[pid] = {
                    k: np.concatenate([prev[k], b[k]]) for k in b
                    if k != "episode_returns"}
                out[pid]["episode_returns"] = np.concatenate(
                    [prev["episode_returns"], rets])
        return out

    def _gae(self, params: dict, batch: dict) -> dict:
        return compute_gae(params, batch, self.gamma, self.gae_lambda)


class MultiAgentPPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.env = "MultiCartPole"
        self.policies: list[str] = ["shared"]
        self.policy_mapping: dict[str, str] | None = None  # aid -> pid

    def multi_agent(self, *, policies=None, policy_mapping=None,
                    **_kw) -> "MultiAgentPPOConfig":
        if policies is not None:
            self.policies = list(policies)
        if policy_mapping is not None:
            self.policy_mapping = dict(policy_mapping)
        return self


class MultiAgentPPO(Algorithm):
    """PPO over a MultiAgentEnv: one learner group per policy, batches
    routed by the agent->policy mapping (ray: multi-agent PPO)."""

    @staticmethod
    def loss_builder(config: dict):
        return PPO.loss_builder(config)

    def setup(self, config: dict) -> None:
        defaults = type(self).get_default_config().to_dict()
        defaults.update(config or {})
        self.cfg = defaults
        probe = make_env(self.cfg["env"], seed=0)
        if not isinstance(probe, MultiAgentEnv):
            raise TypeError(f"{self.cfg['env']} is not a MultiAgentEnv")
        self.obs_dim = probe.obs_dim
        self.n_actions = probe.n_actions
        policies = self.cfg.get("policies") or ["shared"]
        mapping = self.cfg.get("policy_mapping") or {
            aid: policies[i % len(policies)]
            for i, aid in enumerate(probe.agents)}
        unknown = set(mapping.values()) - set(policies)
        if unknown:
            raise ValueError(f"mapping targets unknown policies {unknown}")
        unmapped = set(probe.agents) - set(mapping)
        if unmapped:
            raise ValueError(
                f"agents {sorted(unmapped)} have no policy mapping; "
                f"mapped: {sorted(mapping)}")
        self._mapping = mapping
        self._require_actors()
        learner_cfg = dict(self.cfg, obs_dim=self.obs_dim,
                           n_actions=self.n_actions)
        self.learner_groups = {
            pid: LearnerGroup(dict(learner_cfg, seed=self.cfg["seed"] + i),
                              type(self).loss_builder,
                              num_learners=1, runtime=self.runtime,
                              device=self.device)
            for i, pid in enumerate(policies)}
        runner_cls = self.runtime.remote(MultiAgentEnvRunner)
        self.runners = [
            runner_cls.remote(self.cfg["env"], mapping, seed=i * 7919,
                              gamma=self.cfg["gamma"],
                              gae_lambda=self.cfg.get("gae_lambda", 0.95))
            for i in range(max(1, self.cfg["num_env_runners"]))]
        self._params_np = {pid: lg.get_params_numpy()
                           for pid, lg in self.learner_groups.items()}
        self._timesteps = 0
        self._episode_returns: list[float] = []

    def training_step(self) -> dict:
        per = max(1, self.cfg["train_batch_size"] // len(self.runners))
        params_ref = self.runtime.put(self._params_np)
        frags = self.runtime.get([r.sample.remote(params_ref, per)
                                  for r in self.runners])
        metrics: dict = {}
        for pid, lg in self.learner_groups.items():
            parts = [f[pid] for f in frags if pid in f]
            if not parts:
                continue
            for p in parts:
                self._episode_returns.extend(
                    p.pop("episode_returns").tolist())
                self._timesteps += len(p["obs"])
            batch = {k: np.concatenate([p[k] for p in parts])
                     for k in parts[0]}
            m = lg.update(batch,
                          num_sgd_iter=self.cfg["num_sgd_iter"],
                          minibatch_size=self.cfg["minibatch_size"])
            metrics.update({f"{pid}/{k}": v for k, v in (m or {}).items()})
            self._params_np[pid] = lg.get_params_numpy()
        return metrics

    def cleanup(self) -> None:
        for r in self.runners:
            try:
                self.runtime.kill(r)
            except Exception:  # noqa: BLE001
                pass
        for lg in self.learner_groups.values():
            lg.stop()

    def save_checkpoint(self, checkpoint_dir: str) -> None:
        state = {pid: lg.get_state()
                 for pid, lg in self.learner_groups.items()}
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "wb") as f:
            pickle.dump({"learners": state,
                         "timesteps": self._timesteps}, f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        for pid, lg in self.learner_groups.items():
            params = state["learners"][pid]["params"]
            for ln in lg.learners:
                self.runtime.get(ln.set_params.remote(params))
            self._params_np[pid] = params
        self._timesteps = state["timesteps"]


MultiAgentPPO._default_config = MultiAgentPPOConfig()
MultiAgentPPOConfig.algo_class = MultiAgentPPO
