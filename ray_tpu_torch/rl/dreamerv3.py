"""DreamerV3: model-based RL -- learn a world model, act in imagination
(port of ray_tpu/rl/dreamerv3.py).

The whole algorithm runs in process, as the reference's does: `setup`
builds no env runners and no learner group, collection steps numpy
CartPole envs in this process, and one update is

  1. the world-model loss `wm_loss`: the posterior RSSM rolled over the
     [B, T] sequence (the reference's `lax.scan` is a loop over T here),
     reconstruction + reward + continue + KL with free bits, then Adam on
     the world model;
  2. the actor-critic loss `ac_loss` on the UPDATED world model with its
     gradients stopped: the prior rolled H steps under the actor from the
     posterior features of step 1, which come from the world model's
     forward BEFORE its Adam step; lambda-returns by a reverse loop;
     then Adam on the actor and on the critic.

The update runs eagerly on the algorithm's device (CUDA unless the caller
passes device="cpu"); the MLPs and the one-product GRU are plain
`torch.matmul`, as the reference computes them outside any Pallas kernel.
Three `torch.optim.Adam`s at optax.adam's defaults step every leaf of
their group, as optax does.

The noise seam.  The reference draws `jax.random.gumbel` (the
straight-through latent samples) and `jax.random.categorical` (the
imagined actions) inside its jitted update; threefry cannot be reproduced
in torch.  Here every draw goes through one method, `gumbel(shape)`,
which draws Gumbel noise from a `torch.Generator` seeded from the config's
seed + 1 on the algorithm's device; an action is argmax(logits + gumbel),
which is what `categorical(key, logits)` computes.  A test overrides
`gumbel` to give both sides the same noise.  So the same seed gives other
latent samples and imagined actions than the reference (a deliberate
difference); collection, replay and sequence sampling are numpy and give
the same fragments and windows.

Traps kept as the reference has them: `jnp.split(gates, 3)` orders the
GRU gates r, u, c; the reset mask `keep` cuts both h and z; the advantage
is normalised by numpy's population std (`correction=0`; torch.std
defaults to 1); the sigmoid cross-entropy is optax's form
max(x, 0) - x y + log1p(exp(-|x|)); the straight-through sample is
(onehot + p) - p.detach(), in that order of rounding.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.parallel.sharding import tree_map
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.learner import ADAM, batch_tensor, copy_params
from ray_tpu_torch.rl.models import mlp_apply, mlp_init, to_numpy
from ray_tpu_torch.rl.replay import ReplayBuffer
from ray_tpu_torch.train.step import param_leaves

WM_KEYS = ("enc", "gru_w", "gru_b", "prior", "post", "dec", "rew", "cont")
METRIC_KEYS = ("wm_loss", "ac_loss", "recon", "reward_loss", "cont_loss",
               "kl", "actor_loss", "critic_loss", "entropy", "value_mean")


class DreamerV3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.actor_lr = 1e-4
        self.critic_lr = 1e-4
        self.deter = 64                 # GRU state
        self.groups = 4                 # latent groups
        self.classes = 4                # classes per group
        self.hidden = 64
        self.batch_length = 16          # T per training sequence
        self.batch_rows = 8             # B sequences per update
        self.horizon = 10               # imagination steps
        self.gamma = 0.997
        self.gae_lambda = 0.95
        self.entropy_coeff = 3e-3
        self.free_bits = 1.0
        self.replay_capacity = 20000
        self.updates_per_step = 4
        self.train_batch_size = 256     # env steps collected per step()

    def training(self, *, horizon=None, batch_length=None,
                 updates_per_step=None, entropy_coeff=None, **kw):
        for name, v in [("horizon", horizon),
                        ("batch_length", batch_length),
                        ("updates_per_step", updates_per_step),
                        ("entropy_coeff", entropy_coeff)]:
            if v is not None:
                setattr(self, name, v)
        super().training(**kw)
        return self


def dreamer_params_init(generator: torch.Generator, obs_dim: int,
                        n_actions: int, cfg: dict) -> dict:
    """The reference's tree (rl/models.py MLPs, `gru_w` normal x 0.02,
    `gru_b` zeros), f32 on the generator's device, drawn in key order."""
    deter = cfg["deter"]
    stoch = cfg["groups"] * cfg["classes"]
    hid = cfg["hidden"]
    embed = hid
    g = generator
    return {
        "enc": mlp_init(g, [obs_dim, hid, embed]),
        # GRU: input [z + one-hot action] with state h -> candidate/gates.
        "gru_w": torch.randn((stoch + n_actions + deter, 3 * deter),
                             generator=g, device=g.device) * 0.02,
        "gru_b": torch.zeros((3 * deter,), device=g.device),
        "prior": mlp_init(g, [deter, hid, stoch]),
        "post": mlp_init(g, [deter + embed, hid, stoch]),
        "dec": mlp_init(g, [deter + stoch, hid, obs_dim]),
        "rew": mlp_init(g, [deter + stoch, hid, 1]),
        "cont": mlp_init(g, [deter + stoch, hid, 1]),
        "actor": mlp_init(g, [deter + stoch, hid, n_actions]),
        "critic": mlp_init(g, [deter + stoch, hid, 1]),
    }


def param_shapes(obs_dim: int, n_actions: int, deter: int, stoch: int,
                 hidden: int) -> dict:
    """The shape of every leaf of `dreamer_params_init`'s tree."""
    def mlp(sizes):
        out = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            out[f"w{i}"], out[f"b{i}"] = (a, b), (b,)
        return out

    feat = deter + stoch
    return {"enc": mlp([obs_dim, hidden, hidden]),
            "gru_w": (stoch + n_actions + deter, 3 * deter),
            "gru_b": (3 * deter,),
            "prior": mlp([deter, hidden, stoch]),
            "post": mlp([deter + hidden, hidden, stoch]),
            "dec": mlp([feat, hidden, obs_dim]),
            "rew": mlp([feat, hidden, 1]), "cont": mlp([feat, hidden, 1]),
            "actor": mlp([feat, hidden, n_actions]),
            "critic": mlp([feat, hidden, 1])}


# ------------------------------------------------------------ the update
def gru(p: dict, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Light GRU: one fused [x, h] product; the candidate gated by r
    multiplicatively.  The gates split r, u, c in that order."""
    gates = torch.cat([x, h], -1) @ p["gru_w"] + p["gru_b"]
    r, u, c = gates.chunk(3, dim=-1)
    r, u = torch.sigmoid(r), torch.sigmoid(u)
    cand = torch.tanh(r * c)
    return u * h + (1 - u) * cand


def latent_dist(logits: torch.Tensor, cfg: dict) -> torch.Tensor:
    lg = logits.reshape(*logits.shape[:-1], cfg["groups"], cfg["classes"])
    return torch.log_softmax(lg, dim=-1)


def sample_latent(logits: torch.Tensor, cfg: dict, gumbel) -> torch.Tensor:
    """Straight-through categorical sample per group -> flat."""
    logp = latent_dist(logits, cfg)
    idx = torch.argmax(logp + gumbel(tuple(logp.shape)), dim=-1)
    onehot = F.one_hot(idx, cfg["classes"]).to(logp.dtype)
    probs = torch.exp(logp)
    st = onehot + probs - probs.detach()
    return st.reshape(*st.shape[:-2], cfg["groups"] * cfg["classes"])


def kl(lp_a: torch.Tensor, lp_b: torch.Tensor) -> torch.Tensor:
    """KL over the grouped categoricals, summed across groups."""
    return torch.sum(torch.exp(lp_a) * (lp_a - lp_b), dim=(-2, -1))


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy's form."""
    return torch.maximum(logits, torch.zeros_like(logits)) \
        - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))


def _floor(x: torch.Tensor, free: float) -> torch.Tensor:
    return torch.maximum(x, torch.full_like(x, free))


def wm_loss(wm: dict, batch: dict, cfg: dict, n_actions: int, gumbel):
    """Posterior rollout over [B, T]; recon + reward + cont + KL.  Returns
    (total, aux) with aux's "feat" [B, T, deter + stoch]."""
    obs = batch["obs"]                              # [B, T, obs]
    B, T = obs.shape[:2]
    deter = cfg["deter"]
    act = F.one_hot(batch["actions"].long(), n_actions).to(obs.dtype)
    embed = mlp_apply(wm["enc"], obs, torch)        # [B, T, embed]
    resets = torch.maximum(batch["dones"], batch["truncs"])
    act_prev = torch.cat([torch.zeros_like(act[:, :1]), act[:, :-1]], 1)
    reset_prev = torch.cat([torch.zeros_like(resets[:, :1]),
                            resets[:, :-1]], 1)
    h = obs.new_zeros((B, deter))
    z = obs.new_zeros((B, cfg["groups"] * cfg["classes"]))
    hs, zs, priors, posts = [], [], [], []
    for t in range(T):
        # Episode edges cut the recurrence inside a sequence: both h and z.
        keep = (1.0 - reset_prev[:, t])[:, None]
        h = h * keep
        z = z * keep
        h = gru(wm, h, torch.cat([z, act_prev[:, t]], -1))
        prior_logits = mlp_apply(wm["prior"], h, torch)
        post_logits = mlp_apply(wm["post"], torch.cat([h, embed[:, t]], -1),
                                torch)
        z = sample_latent(post_logits, cfg, gumbel)
        hs.append(h)
        zs.append(z)
        priors.append(prior_logits)
        posts.append(post_logits)
    feat = torch.cat([torch.stack(hs, 1), torch.stack(zs, 1)], -1)
    recon = mlp_apply(wm["dec"], feat, torch)
    rew = mlp_apply(wm["rew"], feat, torch)[..., 0]
    cont = mlp_apply(wm["cont"], feat, torch)[..., 0]
    lp_prior = latent_dist(torch.stack(priors, 1), cfg)
    lp_post = latent_dist(torch.stack(posts, 1), cfg)
    free = cfg["free_bits"]
    dyn = _floor(kl(lp_post.detach(), lp_prior), free)
    rep = _floor(kl(lp_post, lp_prior.detach()), free)
    recon_loss = torch.mean(torch.sum((recon - obs) ** 2, -1))
    rew_loss = torch.mean((rew - batch["rewards"]) ** 2)
    cont_loss = torch.mean(sigmoid_ce(cont, 1.0 - batch["dones"]))
    kl_loss = torch.mean(0.5 * dyn + 0.1 * rep)
    total = recon_loss + rew_loss + cont_loss + kl_loss
    aux = {"recon": recon_loss, "reward_loss": rew_loss,
           "cont_loss": cont_loss, "kl": kl_loss, "feat": feat}
    return total, aux


def imagine(wm: dict, actor: dict, feat0: torch.Tensor, cfg: dict,
            n_actions: int, gumbel):
    """Roll the PRIOR forward H steps under the actor: features
    [H, N, feat], the taken actions' log-probs and the entropies [H, N]."""
    deter = cfg["deter"]
    h, z = feat0[:, :deter], feat0[:, deter:]
    hs, zs, logps, ents = [], [], [], []
    for _ in range(cfg["horizon"]):
        logits = mlp_apply(actor, torch.cat([h, z], -1), torch)
        # categorical(key, logits) = argmax(logits + gumbel)
        a_idx = torch.argmax(logits + gumbel(tuple(logits.shape)), dim=-1)
        a = F.one_hot(a_idx, n_actions).to(logits.dtype)
        logp_all = torch.log_softmax(logits, -1)
        logps.append(torch.gather(logp_all, -1, a_idx[:, None])[:, 0])
        ents.append(-torch.sum(torch.softmax(logits, -1) * logp_all, -1))
        h = gru(wm, h, torch.cat([z, a], -1))
        z = sample_latent(mlp_apply(wm["prior"], h, torch), cfg, gumbel)
        hs.append(h)
        zs.append(z)
    feat = torch.cat([torch.stack(hs), torch.stack(zs)], -1)
    return feat, torch.stack(logps), torch.stack(ents)


def ac_loss(actor: dict, critic: dict, wm: dict, feat0: torch.Tensor,
            cfg: dict, n_actions: int, gumbel):
    """Actor and critic losses over an imagined rollout of the world model
    `wm` (gradients stopped) from `feat0` [N, deter + stoch]."""
    wm = tree_map(torch.Tensor.detach, wm)
    feat, logps, ents = imagine(wm, actor, feat0, cfg, n_actions, gumbel)
    feat = feat.detach()
    rew = mlp_apply(wm["rew"], feat, torch)[..., 0]          # [H, N]
    cont = torch.sigmoid(mlp_apply(wm["cont"], feat, torch)[..., 0])
    v = mlp_apply(critic, feat, torch)[..., 0]               # [H, N]
    disc = cfg["gamma"] * cont
    lam = cfg["gae_lambda"]
    # The reference's reverse scan over the [::-1]-reversed rows (torch has
    # no negative-step slice): t = H-2 .. 0, carried from v[-1].
    acc, rets = v[-1], [None] * (len(v) - 1)
    for t in range(len(v) - 2, -1, -1):
        acc = rew[t] + disc[t] * ((1 - lam) * v[t + 1] + lam * acc)
        rets[t] = acc
    rets = torch.stack(rets).detach()                        # [H-1, N]
    adv = rets - v[:-1].detach()
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    actor_loss = -torch.mean(logps[:-1] * adv_n) \
        - cfg["entropy_coeff"] * torch.mean(ents)
    critic_loss = torch.mean((v[:-1] - rets) ** 2)
    total = actor_loss + critic_loss
    return total, {"actor_loss": actor_loss, "critic_loss": critic_loss,
                   "entropy": torch.mean(ents), "value_mean": torch.mean(v)}


def _step(opt: torch.optim.Optimizer, leaves: list, grads) -> None:
    for p, g in zip(leaves, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    opt.step()


class DreamerV3(Algorithm):
    """Compact DreamerV3 (see the module docstring), in process on
    `device` (cuda unless the caller passes "cpu"); it makes no actors,
    so a `runtime` is accepted and unused."""

    def __init__(self, config: dict | None = None, runtime=None,
                 device=None):
        super().__init__(config, runtime=runtime,
                         device=resolve_device(device, "DreamerV3"))

    def setup(self, config: dict) -> None:
        defaults = type(self).get_default_config().to_dict()
        defaults.update(config or {})
        self.cfg = defaults
        probe = make_env(self.cfg["env"], seed=0)
        self.obs_dim = probe.obs_dim
        self.n_actions = probe.n_actions
        self.replay = ReplayBuffer(self.cfg["replay_capacity"],
                                   seed=self.cfg["seed"])
        gen = torch.Generator(device=self.device).manual_seed(
            self.cfg["seed"])
        params = dreamer_params_init(gen, self.obs_dim, self.n_actions,
                                     self.cfg)
        self.params = tree_map(lambda t: t.requires_grad_(True), params)
        self._noise = torch.Generator(device=self.device).manual_seed(
            self.cfg["seed"] + 1)
        self.opt_wm = torch.optim.Adam(
            param_leaves({k: self.params[k] for k in WM_KEYS}),
            lr=self.cfg["lr"], **ADAM)
        self.opt_actor = torch.optim.Adam(param_leaves(self.params["actor"]),
                                          lr=self.cfg["actor_lr"], **ADAM)
        self.opt_critic = torch.optim.Adam(
            param_leaves(self.params["critic"]), lr=self.cfg["critic_lr"],
            **ADAM)

    # -------------------------------------------------------- noise seam
    def gumbel(self, shape: tuple) -> torch.Tensor:
        """Standard Gumbel noise of `shape` on the algorithm's device, as
        jax.random.gumbel draws it: -log(-log(u)), u in [tiny, 1)."""
        u = torch.rand(shape, generator=self._noise, device=self.device)
        u = u.clamp_min(torch.finfo(u.dtype).tiny)
        return -torch.log(-torch.log(u))

    # ------------------------------------------------------------ update
    def update(self, batch: dict) -> dict:
        """One world-model step, then one actor-critic step, on a [B, T]
        batch of tensors on the device; returns the metrics as device
        scalars.  Each leaf's `.grad` is left holding its gradient."""
        cfg, n_act = self.cfg, self.n_actions
        wm = {k: self.params[k] for k in WM_KEYS}
        wl, aux = wm_loss(wm, batch, cfg, n_act, self.gumbel)
        leaves = param_leaves(wm)
        _step(self.opt_wm, leaves,
              torch.autograd.grad(wl, leaves, allow_unused=True))
        # Features of the forward before the world model's step; imagine
        # runs the updated world model.
        feat0 = aux.pop("feat").detach().reshape(
            -1, cfg["deter"] + cfg["groups"] * cfg["classes"])
        al, aaux = ac_loss(self.params["actor"], self.params["critic"], wm,
                           feat0, cfg, n_act, self.gumbel)
        la = param_leaves(self.params["actor"])
        lc = param_leaves(self.params["critic"])
        grads = torch.autograd.grad(al, la + lc, allow_unused=True)
        _step(self.opt_actor, la, grads[:len(la)])
        _step(self.opt_critic, lc, grads[len(la):])
        return {"wm_loss": wl.detach(), "ac_loss": al.detach(),
                **{k: v.detach() for k, v in aux.items()},
                **{k: v.detach() for k, v in aaux.items()}}

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return batch_tensor(a, self.device)

    # -------------------------------------------------------- acting glue
    def _policy_logits_fn(self):
        """Feedforward acting slice of the recurrent model: actor over
        [h=0, z=mode(post(h=0, enc(obs)))].  CartPole-scale envs are
        fully observed, so the posterior features carry the state."""
        p = self.params
        G, C = self.cfg["groups"], self.cfg["classes"]

        @torch.no_grad()
        def logits_fn(obs_np):
            obs = self._tensor(np.asarray(obs_np, np.float32))
            single = obs.ndim == 1
            if single:
                obs = obs[None]
            emb = mlp_apply(p["enc"], obs, torch)
            h = obs.new_zeros((obs.shape[0], self.cfg["deter"]))
            post = mlp_apply(p["post"], torch.cat([h, emb], -1), torch)
            lg = post.reshape(*post.shape[:-1], G, C)
            mode = F.one_hot(torch.argmax(lg, -1), C).to(post.dtype)
            z = mode.reshape(*mode.shape[:-2], G * C)
            out = mlp_apply(p["actor"], torch.cat([h, z], -1), torch)
            return (out[0] if single else out).cpu().numpy()

        return logits_fn

    def training_step(self) -> dict:
        per = max(1, self.cfg["train_batch_size"]
                  // self.cfg["num_env_runners"])
        fragments = self._sample_with(self._policy_logits_fn(), per)
        for b in fragments:
            self._episode_returns.extend(b.pop("episode_returns").tolist())
            self._timesteps += len(b["obs"])
            self.replay.add_batch(b)
        if len(self.replay) < self.cfg["batch_rows"] * \
                self.cfg["batch_length"]:
            return {"buffer": float(len(self.replay))}
        m = {}
        for _ in range(self.cfg["updates_per_step"]):
            batch = self._sample_sequences()
            m = self.update({k: self._tensor(v) for k, v in batch.items()})
        # The last update's metrics, read back in one copy.
        values = torch.stack([m[k] for k in METRIC_KEYS]).tolist()
        return dict(zip(METRIC_KEYS, values))

    def _sample_with(self, logits_fn, per: int) -> list[dict]:
        """Local sampling with the composed policy: the envs run in this
        process (numpy, the reference's seeds)."""
        if not hasattr(self, "_local_envs"):
            self._local_envs = [
                make_env(self.cfg["env"], seed=1000 + 7919 * i)
                for i in range(self.cfg["num_env_runners"])]
            self._local_obs = [e.reset() for e in self._local_envs]
            self._local_rng = np.random.default_rng(self.cfg["seed"] + 5)
            self._local_ret = [0.0] * len(self._local_envs)
        out = []
        for ei, env in enumerate(self._local_envs):
            cols = {k: [] for k in ("obs", "actions", "rewards", "dones",
                                    "truncs")}
            rets = []
            obs = self._local_obs[ei]
            for _ in range(per):
                logits = logits_fn(obs)
                z = logits - logits.max()
                prob = np.exp(z) / np.exp(z).sum()
                a = int(self._local_rng.choice(len(prob), p=prob))
                nxt, r, term, trunc = env.step(a)
                cols["obs"].append(np.asarray(obs, np.float32))
                cols["actions"].append(a)
                cols["rewards"].append(r)
                cols["dones"].append(float(term))
                cols["truncs"].append(float(trunc and not term))
                self._local_ret[ei] += r
                if term or trunc:
                    rets.append(self._local_ret[ei])
                    self._local_ret[ei] = 0.0
                    obs = env.reset()
                else:
                    obs = nxt
            self._local_obs[ei] = obs
            out.append({
                "obs": np.stack(cols["obs"]),
                "actions": np.asarray(cols["actions"], np.int64),
                "rewards": np.asarray(cols["rewards"], np.float32),
                "dones": np.asarray(cols["dones"], np.float32),
                "truncs": np.asarray(cols["truncs"], np.float32),
                "episode_returns": np.asarray(rets, np.float32),
            })
        return out

    def _sample_sequences(self) -> dict:
        """[B, T] contiguous windows from the replay's flat storage."""
        B, T = self.cfg["batch_rows"], self.cfg["batch_length"]
        data = self.replay.storage()
        n = len(data["obs"])
        rng = np.random.default_rng(int(self._timesteps) + 13)
        starts = rng.integers(0, max(1, n - T), size=B)
        return {k: np.stack([v[s:s + T] for s in starts])
                for k, v in data.items()
                if k in ("obs", "actions", "rewards", "dones", "truncs")}

    # ------------------------------------------------------------ params
    def get_params_numpy(self) -> dict:
        return to_numpy(self.params)

    def set_params(self, params: dict) -> None:
        """Copy a tree (numpy or tensor leaves, the algorithm's keys and
        shapes) into the algorithm's tensors; the Adam moments stay."""
        copy_params(self.params, params)

    def cleanup(self) -> None:
        pass


DreamerV3._default_config = DreamerV3Config()
DreamerV3Config.algo_class = DreamerV3
