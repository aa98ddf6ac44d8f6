"""Single-device training step (port of ray_tpu/train/step.py:29-89).

`make_train_step(cfg, optimizer)(state, batch) -> (state, metrics)`: loss
and gradients through the model's autograd (the flash kernels on CUDA),
the pre-clip global gradient norm, a global-norm clip and AdamW under a
warmup-cosine schedule.  `default_optimizer` reproduces the reference's
optax chain (clip_by_global_norm -> adamw) exactly:

  - the schedule is read at the update count BEFORE the update, as optax's
    scale_by_schedule does, so the first update runs at lr 0 and leaves
    the parameters unchanged;
  - the clip scales by max_norm / |g| only when |g| >= max_norm, with no
    epsilon added to the norm (written out here, not clip_grad_norm_);
  - AdamW decays every leaf (no mask), eps 1e-8 outside the square root,
    and keeps its moments in the parameter dtype (torch.optim.AdamW does
    all of that).

Unlike the reference's pure step, the port updates parameters and
optimizer state IN PLACE: the returned state is the same object.
Entry points run on CUDA unless the caller passes device="cpu".

Sharded training (port of ray_tpu/train/step.py:92-201): on a DeviceMesh
(parallel/mesh.py) the parameters and the AdamW moments are DTensors
placed by the logical-axis rules (parallel/sharding.py), the batch is
split over data x fsdp, and `sharded_train_step` runs the same in-place
step on them: DTensor's op propagation inserts the collectives that GSPMD
inserts in the reference, attention runs on each rank's shards, each
gradient is laid out like its parameter before the update, and the clip
reads the norm of the whole gradient.  The data, fsdp and tensor axes
train in any combination, and with them:

  - expert: an MoE config's expert weights split on their E dim;
  - seq: the sequence split over "seq" (ring attention with
    cfg.use_ring_attention, else attention on the gathered sequence);
  - stage: the pipelined trunk (`llama.pipelined_loss_fn`), the stacked
    layer dim split over "stage".  As in the reference, a stage mesh does
    not take seq or expert > 1, nor a family without a pipelined trunk.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import llama, moe
from ray_tpu_torch.parallel.sharding import (LOGICAL_RULES, NamedSharding,
                                             logical_sharding, mesh_axis_size,
                                             param_shardings, tree_map)

ADAM_EPS = 1e-8          # optax.adamw's default, outside the square root


def model_module(cfg: llama.LlamaConfig):
    """Model family for a config: moe for MoEConfig (a LlamaConfig
    subclass, so it is checked first), llama for LlamaConfig.  Any other
    config raises TypeError: the reference's would hand a vision config
    to llama.  Vision trains through `make_train_step(cfg, opt,
    loss_fn=vit.loss_fn)` (or resnet's) on a TrainState built from the
    family's own params, whose leaves keep their dtypes (ViT's f32
    head_bias, ResNet's f32 tree), which create_train_state would cast to
    cfg.dtype."""
    if isinstance(cfg, moe.MoEConfig):
        return moe
    if not isinstance(cfg, llama.LlamaConfig):
        raise TypeError(f"no ported model family for {type(cfg).__name__}")
    return llama


def param_leaves(params: dict) -> list[torch.Tensor]:
    """The parameter tree's tensors in a fixed order (sorted key paths)."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in param_leaves(params[k])]
    return [params]


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: torch.optim.AdamW
    step: int


@dataclasses.dataclass(frozen=True)
class ClippedAdamW:
    """AdamW + warmup-cosine schedule + global-norm clip: the reference's
    Llama pretrain recipe (see the module docstring for its semantics)."""
    lr: float
    weight_decay: float
    warmup: int
    total_steps: int
    b1: float
    b2: float
    grad_clip: float

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup,
        max(total_steps, warmup + 1), end_value=lr * 0.1) at `count`."""
        if count < self.warmup:
            return self.lr * count / self.warmup
        decay = max(self.total_steps, self.warmup + 1) - self.warmup
        t = min(count - self.warmup, decay)
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay))
        alpha = 0.1                        # end_value / peak_value
        return self.lr * ((1 - alpha) * cosine + alpha)

    def init(self, params: dict) -> torch.optim.AdamW:
        return torch.optim.AdamW(param_leaves(params), lr=0.0,
                                 betas=(self.b1, self.b2), eps=ADAM_EPS,
                                 weight_decay=self.weight_decay)

    def update(self, opt: torch.optim.AdamW, params: dict) -> torch.Tensor:
        """Clip the gradients held in `.grad` and take one AdamW step, in
        place.  Returns the pre-clip global norm (f32, on the device; no
        host sync)."""
        leaves = param_leaves(params)
        for p in leaves:
            if isinstance(p.grad, DTensor) \
                    and tuple(p.grad.placements) != tuple(p.placements):
                # A sharded gradient arrives as a partial sum or in another
                # layout: reduce it to the parameter's, as GSPMD does.
                p.grad = p.grad.redistribute(p.device_mesh, p.placements)
        grads = [p.grad for p in leaves]
        gnorm = global_norm(grads)
        scale = torch.where(gnorm < self.grad_clip, torch.ones_like(gnorm),
                            self.grad_clip / gnorm)
        for g in grads:
            g.mul_(scale)
        state = opt.state.get(leaves[0])
        count = int(state["step"]) if state else 0
        for group in opt.param_groups:
            group["lr"] = self.schedule(count)
        opt.step()
        return gnorm


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                      warmup: int = 100, total_steps: int = 10000,
                      b1: float = 0.9, b2: float = 0.95,
                      grad_clip: float = 1.0) -> ClippedAdamW:
    """AdamW + cosine schedule + global-norm clip (the Llama pretrain
    recipe)."""
    return ClippedAdamW(lr=lr, weight_decay=weight_decay, warmup=warmup,
                        total_steps=total_steps, b1=b1, b2=b2,
                        grad_clip=grad_clip)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32.  A DTensor's
    norm is read whole (a reduction over its shards), so every rank sees
    the norm of the full gradient."""
    def norm(t):
        n = torch.linalg.vector_norm(t, dtype=torch.float32)
        return n.full_tensor() if isinstance(n, DTensor) else n

    return torch.linalg.vector_norm(torch.stack([norm(t) for t in tensors]))


def create_train_state(seed: int, cfg: llama.LlamaConfig,
                       optimizer: ClippedAdamW, device=None,
                       params: dict | None = None) -> TrainState:
    """A fresh TrainState on `device` (cuda by default): parameters from
    `init_params` with a generator seeded by `seed`, or copies of `params`
    when given, as leaves that require gradients."""
    device = resolve_device(device, "create_train_state")

    def copy(t):
        if isinstance(t, dict):
            return {k: copy(v) for k, v in t.items()}
        return t.detach().to(device=device, dtype=cfg.dtype, copy=True)

    if params is None:
        params = model_module(cfg).init_params(
            cfg, torch.Generator(device=device).manual_seed(seed))
    else:
        params = copy(params)
    for p in param_leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=0)


def make_train_step(cfg: llama.LlamaConfig, optimizer: ClippedAdamW,
                    loss_fn: Callable | None = None,
                    device=None) -> Callable:
    """Returns step(state, batch) -> (state, metrics), with the family's
    loss_fn unless one is given (vision passes its own).  The batch's arrays
    move to `device` (cuda by default); the state must live there.
    Metrics: "loss", the pre-clip "grad_norm" (device scalars) and "step".
    Parameters and optimizer state update in place."""
    loss_fn = loss_fn or model_module(cfg).loss_fn
    device = resolve_device(device, "make_train_step")

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        for p in param_leaves(state.params):
            p.grad = None
        loss = loss_fn(state.params, batch, cfg)
        loss.backward()
        gnorm = optimizer.update(state.opt_state, state.params)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": gnorm,
                       "step": state.step}

    return step


# ------------------------------------------------------- sharded wrappers
def _rules_for(mesh: DeviceMesh) -> dict | None:
    """Sharding rules for a mesh: on a stage-bearing (pipeline) mesh the
    stacked "layers" param axis splits over "stage", so each stage holds
    its contiguous layer block.  None = the default LOGICAL_RULES."""
    if mesh_axis_size(mesh, "stage") > 1:
        return {**LOGICAL_RULES, "layers": "stage"}
    return None


def state_shardings(cfg: llama.LlamaConfig, mesh: DeviceMesh,
                    optimizer: ClippedAdamW) -> TrainState:
    """NamedShardings (mesh, placements) for a TrainState: params follow
    the family's logical-axes table (with the stage rules on a stage
    mesh), each AdamW moment tree ("mu", "nu") mirrors the params, the
    update count and the step replicate."""
    p_sh = param_shardings(model_module(cfg).param_logical_axes(cfg), mesh,
                           rules=_rules_for(mesh))
    replicated = NamedSharding(mesh, (Replicate(),) * mesh.ndim)
    return TrainState(params=p_sh, opt_state={"mu": p_sh, "nu": p_sh,
                                              "count": replicated},
                      step=replicated)


def batch_shardings(mesh: DeviceMesh) -> NamedSharding:
    """One sharding for every batch leaf ([b, s] arrays): batch over data
    x fsdp."""
    return logical_sharding(mesh, ("batch", "seq"))


def _full(x) -> torch.Tensor:
    """A leaf as one whole tensor: a DTensor gathered, numpy converted."""
    from ray_tpu_torch.models.convert import as_tensor

    if isinstance(x, DTensor):
        return x.full_tensor()
    return as_tensor(x)


def _state_tree(state: TrainState) -> dict:
    """A TrainState as the tree `reshard_state` takes: params, the AdamW
    moments "mu" / "nu" (zeros before the first update), "count" and
    "step"."""
    slots = {id(p): state.opt_state.state.get(p, {})
             for p in param_leaves(state.params)}

    def moment(key):
        return tree_map(lambda p: slots[id(p)].get(key, torch.zeros_like(p)),
                        state.params)

    first = slots[id(param_leaves(state.params)[0])]
    return {"params": tree_map(torch.Tensor.detach, state.params),
            "mu": moment("exp_avg"), "nu": moment("exp_avg_sq"),
            "count": float(first["step"]) if first else 0.0,
            "step": state.step}


def reshard_state(state, cfg: llama.LlamaConfig, optimizer: ClippedAdamW,
                  mesh: DeviceMesh) -> TrainState:
    """Lay a training state onto `mesh` by the logical-axis rules: a
    TrainState of plain tensors or of DTensors on another mesh, or the
    host tree of `models.convert.train_state_from_jax` (numpy or tensor
    leaves: "params", "mu", "nu", "count", "step").  Every leaf is
    gathered whole and distributed anew (every rank must call this), so
    the same state on any mesh gives bitwise the same full tensors."""
    tree = _state_tree(state) if isinstance(state, TrainState) else state
    sh = state_shardings(cfg, mesh, optimizer)
    shapes = model_module(cfg).param_shapes(cfg)

    def put(x, s, shape):
        t = _full(x)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"reshard_state: leaf shape {tuple(t.shape)} "
                             f"!= {tuple(shape)}")
        t = t.to(device=mesh.device_type, dtype=cfg.dtype, copy=True)
        return distribute_tensor(t, s.mesh, s.placements)

    params = tree_map(put, tree["params"], sh.params, shapes)
    for p in param_leaves(params):
        p.requires_grad_(True)
    opt = optimizer.init(params)
    count = torch.tensor(float(np.asarray(_full(tree["count"]).cpu())))
    moments = [param_leaves(tree_map(put, tree[k], sh.opt_state[k],
                                      shapes)) for k in ("mu", "nu")]
    for p, mu, nu in zip(param_leaves(params), *moments):
        opt.state[p] = {"step": count.clone(), "exp_avg": mu,
                        "exp_avg_sq": nu}
    return TrainState(params=params, opt_state=opt,
                      step=int(np.asarray(_full(tree["step"]).cpu())))


def sharded_init(seed: int, cfg: llama.LlamaConfig, optimizer: ClippedAdamW,
                 mesh: DeviceMesh) -> TrainState:
    """create_train_state(seed) laid out on `mesh`: the full parameters
    are drawn on every rank from the same seeded generator on the mesh's
    device, then distributed, so any mesh gives bitwise the tensors of
    the single-device state (the reference draws each shard in place)."""
    full = create_train_state(seed, cfg, optimizer,
                              device=mesh.device_type)
    return reshard_state(full, cfg, optimizer, mesh)


def sharded_train_step(cfg: llama.LlamaConfig, optimizer: ClippedAdamW,
                       mesh: DeviceMesh, loss_fn: Callable | None = None,
                       n_micro: int | None = None) -> Callable:
    """step(state, batch) -> (state, metrics) on a state laid out for
    `mesh` (sharded_init / reshard_state): the batch's arrays (host
    arrays or tensors holding the global batch, the same on every rank)
    are split over data x fsdp (and the sequence over seq), then
    make_train_step's in-place step runs on the DTensors.  On a
    stage-bearing mesh the trunk runs the GPipe pipeline
    (`pipelined_loss_fn` of the family, `n_micro` microbatches).
    Metrics as make_train_step's; "loss" and "grad_norm" read the same on
    every rank."""
    if loss_fn is None and mesh_axis_size(mesh, "stage") > 1:
        # data / fsdp / tensor compose with the pipeline; seq (ring
        # attention would nest its own ring inside a stage) and expert (no
        # pipelined MoE trunk) do not, as in the reference.
        unsupported = [a for a in ("seq", "expert")
                       if mesh_axis_size(mesh, a) > 1]
        if unsupported:
            raise NotImplementedError(
                f"pipeline meshes compose with data/fsdp/tensor; axes "
                f"{unsupported} > 1 are not supported inside the "
                "pipelined trunk yet")

        def loss_fn(params, batch, cfg_):
            pl = getattr(model_module(cfg_), "pipelined_loss_fn", None)
            if pl is None:
                raise NotImplementedError(
                    f"{model_module(cfg_).__name__} has no pipelined "
                    "trunk; pipeline meshes (stage>1) currently support "
                    "the llama family")
            return pl(params, batch, cfg_, mesh, n_micro)
    b_sh = batch_shardings(mesh)
    step = make_train_step(cfg, optimizer, loss_fn, device=mesh.device_type)

    def sharded(state: TrainState, batch: dict):
        batch = {k: v if isinstance(v, DTensor) else distribute_tensor(
                     torch.as_tensor(v).to(mesh.device_type), b_sh.mesh,
                     b_sh.placements)
                 for k, v in batch.items()}
        state, metrics = step(state, batch)
        loss = metrics["loss"]
        if isinstance(loss, DTensor):
            metrics["loss"] = loss.full_tensor()
        return state, metrics

    return sharded
