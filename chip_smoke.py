"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve-alone   # phases 1, 4c and 25 only

Phases, each printing one JSON line; any failure raises and exits 1:

  1. device   -- the card's name and power limit (nvidia-smi), and the
                 kernels built from csrc/ (one nvcc per source, together).
  2. kernels  -- every kernel of the serving, training and RLHF paths
                 against its plain PyTorch version on the card, at the
                 main paths' shapes in bf16 plus ragged and edge cases
                 (head_dim 32, 64 and 128): the error against the plain
                 version computed in f32 from the same inputs, kernel /
                 plain / library times and the bound.  The flash forward
                 is timed at the 8B wave, the `bench-350m` layer and the
                 rlhf_350m scoring call, the flash backward (dQ, dK/dV) at
                 the `bench-350m` layer and the rlhf_350m learner's; the
                 f32 routes (FMA kernels) at the `debug` training shapes;
                 the paged kernel at the 8B decode state, at a long
                 context, at batch 32 and at the rlhf_350m decode state.
                 Each backward case must launch dQ and dK/dV once each on
                 its dtype's route, and every backward and paged case
                 gives the same bits when run again.
  3. engine_small_f32 -- the whole engine at small depth (`debug`, f32) on
                 CUDA (kernels, captured decode windows) and on the CPU
                 (plain versions, eager windows) from the same parameters:
                 warmup, a shared page-aligned prefix, a whole-prompt hit, a
                 wave mixing base and LoRA rows, a sync-window change to 2,
                 a prefill-only export imported into a second engine, a
                 prefix demoted from one engine and grafted into the other,
                 a live weight swap, and a pool small enough to preempt; the
                 greedy tokens must be identical on both devices, the swap
                 must give a fresh engine's tokens, the migration an
                 uninterrupted run's, the graft a prefix hit.  On CUDA every
                 window after the first of its size K must be a graph
                 replay, and one replayed window runs under CUDA sync
                 debug mode "error".
  3b. engine_small_dense_f32 -- the dense engine (paged=False) at `debug`
                 in f32: its greedy tokens on CUDA (captured windows, the
                 forward kernel in prefill) equal the same engine's on the
                 CPU and the paged engine's on CUDA; every window after the
                 first of its size is a replay and no paged kernel runs;
                 an LLMServer(paged=False) serves concurrent calls and a
                 stream with the same tokens, and a server reconfigured
                 from paged to dense and back gives them in all three.
  4. serve_8b -- `llama3-8b` at full width and depth in bf16 with random
                 seeded weights and the engine's defaults: eight requests
                 of 300-1000 prompt tokens submitted together, 64 new
                 tokens each, then a ninth that shares the first 512
                 tokens of a finished prompt (a prefix-cache hit: the
                 suffix path).  The launch counters are zeroed just before
                 this phase and read just after: both kernels must have
                 run, the forward on its bf16 route only, every decode
                 window must be a replay of the graph the warm-up
                 captured, and the paged kernel's launches must equal
                 replays x layers x K.  Then a wave of fresh prompts runs
                 under torch.profiler (profile_serve.trace_wave): its
                 busy share, and its paged kernels as the trace counts them
                 against the counter.
  4b. serve_8b_engine -- the same model and weights on four engines:
                 a mixed wave of four base and four adapter requests on an
                 engine with LoRA banks (2 slots, rank 16) whose base rows
                 must equal the same requests on a bank-free engine, one
                 request prefilled on a prefill-only engine and decoded on
                 a decode engine (the same tokens as the request run
                 alone; the prefill, decode and bank-free engines share
                 one tree with share_params), and a same-shape
                 update_weights of the banked engine's own copy (version
                 bump, radix tree flushed, graphs still replaying, the
                 same tokens; a sharing engine refuses one).  Counters
                 zeroed before, read after, as in 4.
  4c. serve_8b_server -- `LLMServer`, the serve deployment body, on the
                 same model and weights at the engine's defaults (max_batch
                 8, page 512, K 8), with no runtime (a process outside any
                 cluster).  (a) Unified: eight concurrent `__call__`s
                 (asyncio.gather) must give the greedy tokens of a bare
                 engine on the same params and seed, and a `stream` the
                 tokens of its `__call__`; each wave is queued while the
                 engine loop is stopped and admitted when it restarts, so
                 both engines prefill it as one wave (bf16 tokens depend
                 on the prefill's shapes).  A second pair of waves on fresh
                 prompts, sent as they come, gives tokens/s and TTFT
                 through the server against the bare engine (the server
                 wave's launches counted), then two more prompts go to
                 the server one at a time, for 25.  (c) A
                 `reconfigure` to K 4 rebuilds the engine and serves a
                 bare K-4 engine's tokens; after `shutdown`, `kv_check`
                 passes.  (b) PD, built after (a) is freed: a prefill-role
                 server and a decode-role server linked by an in-process
                 handle (`serve/runtime.LocalHandle`) serve (a)'s eight
                 requests with (a)'s tokens and eight migrations; a
                 handle whose `kv_decode` raises gives a "full_reprefill"
                 fallback.  Counters zeroed before, read after (a) and
                 (b): both kernels launched, the forward on its bf16
                 route only, every counted window a replay.
  4d. serve_8b_dense -- the dense engine on the same model and weights
                 (share_params) at the engine's defaults but paged=False
                 (max_len 8192, max_batch 8, K 8): the eight requests as
                 one held wave, against a paged engine's held wave.  Each
                 first token must be the paged engine's (the same prefill);
                 the share of equal decoded tokens is reported.  Counters
                 zeroed before, read after: the forward on its bf16 route,
                 no paged launch, every counted window a replay.  Then a
                 wave of fresh prompts under torch.profiler: busy share
                 and device time by kernel group.
  4e. serve_8b_observed -- the same model and weights (share_params) on
                 an engine at its defaults whose runtime is a
                 `LocalRuntime` with its recorder on: the serve_8b wave of
                 eight requests, each submitted under a span of its own.
                 Every request's trace holds llm.queue, llm.prefill,
                 llm.first_token and llm.decode_window; the distinct window
                 spans number the wave's decode windows, all replays; the
                 serve_llm_prefill_tokens / _decode_tokens /
                 _prefix_hit_tokens counters after stats() equal stats()'s
                 counts; the hbm_kv row's pool_bytes equal the cache
                 tensors' bytes.  Then four waves of fresh prompts with the
                 recorder off, on, off, on: decode tokens/s of each.  Then
                 a PD pair on one copy of the weights with one
                 `serve.kv_export` error armed: the first request falls
                 back ("export_failed") and completes, the second
                 migrates.  Counters zeroed before the first wave, read
                 after it.
  5. train_small_f32 -- three `make_train_step` steps of `debug` in f32
                 (TF32 off) at seq 100, batch 2, from the same params and
                 batch on CUDA (kernels) and on the CPU (plain versions),
                 with remat flash_resid, nothing and off: losses, pre-clip
                 grad norms and final params agree; the forward kernel runs
                 n_layers times a step under flash_resid and twice that
                 under nothing, the forward, dQ and dK/dV on their f32
                 (FMA) routes only.
  6. train_350m -- `bench-350m` at full width and depth in bf16, weights
                 from seed 0, `default_optimizer(total_steps=1000)`, batch
                 8 x seq 2048 of seeded random tokens, remat flash_resid:
                 one warm-up step (lr 0: params unchanged), five timed
                 steps (loss, grad norm, step ms, tokens/s, MFU, peak
                 memory; the counters are zeroed just before and read just
                 after: 24 launches a step of each flash kernel, all on
                 their bf16 (wgmma) routes), then one step under
                 torch.profiler for the device time by kernel group, in
                 which no FMA flash kernel may run.
  6b. train_350m_sharded -- the same model, state, batch and optimizer
                 through `sharded_train_step` on a one-rank NCCL group and
                 a `create_mesh(MeshConfig(data=1))` DeviceMesh, the state
                 laid out by `reshard_state`: a warm-up step and four timed
                 steps, each beside the single-device step from the same
                 state (loss and grad norm equal to the bit; step ms,
                 tokens/s and MFU of both), and 24 launches a step of each
                 flash kernel on its bf16 route in both; then one sharded
                 step under torch.profiler (busy share, kernel groups).

  7. rlhf_small_f32 -- the in-process online GRPO loop (`RLHFTrainer`,
                 rollouts through the paged engine, the GRPO learner, live
                 weight sync) at `debug` in f32 (TF32 off) on CUDA and on
                 the CPU from the same params: engine max_batch 8, max_len
                 128, page 16, K 3; 4 prompts of 10 tokens, groups of 4, 2
                 prompts a step, 5 new tokens at temperature 1.0, lr 1e-2;
                 three steps.  The trajectories' tokens and masks equal on
                 both devices, each update's advantages and losses within
                 1e-4, the first update's gradients within 1e-4 of the
                 CPU's relative to each leaf's largest (the params after
                 three steps are reported: Adam's eps lets f32 rounding
                 pick the sign of some steps); every kernel on its
                 f32 (FMA) route only, dQ and dK/dV once per layer per
                 update; every window after the first a graph replay,
                 across each weight swap; the engine's weight_version the
                 learner's after every step.  A save_async taken before an
                 update, loaded into a fresh learner, gives the saved
                 state to the bit.
  7b. rlhf_350m -- the same loop at `bench-350m`, full width and depth, in
                 bf16 with weights from seed 0: 8 prompts of 384 tokens,
                 groups of 8, 2 prompts a step (16 completions), 64 new
                 tokens at temperature 1.0, lr 1e-6, engine max_batch 16,
                 max_len 512, page 64, K 4.  One warm-up step, four timed
                 steps (rollout seconds and completion tokens/s, scoring
                 and update seconds, learner tokens/s, weight sync ms,
                 reward, prefix-hit against prefilled tokens, peak
                 memory), then one step under torch.profiler (busy share,
                 kernel groups).  Counters zeroed before the timed steps
                 and read after: the paged kernel replays x layers x K, the
                 forward on bf16 only, dQ and dK/dV 24 per update on bf16
                 only; every timed window a replay; versions equal after
                 every step.  A second trainer from the same seed must
                 sample the same version-0 tokens; the equality of the
                 param hashes after as many steps is reported.
  7c. rlhf_actors_small_f32 -- the RLHF actor topology on a `LocalRuntime`
                 (serve/runtime.py: actors in this process, each on its own
                 threads): 2 rollout workers and the learner as actors, the
                 packed weight broadcast (`collective.broadcast_pytree`),
                 at `debug` in f32 (TF32 off) on CUDA with 7's knobs but
                 temperature 0 and kl_coeff 0.1 (greedy groups give zero
                 advantages; the KL term moves the params).  After each of
                 three steps the learner's params are within 1e-4 of the
                 in-process loop's (`num_rollout_workers=0`) from the same
                 params, and both workers hold the learner's version.  A
                 `broadcast_pytree` from this process (rank 0) to a worker
                 gives its engine the sent tree to the bit.  Counters zeroed
                 before the actor run, read after: the paged kernel and the
                 f32 (FMA) forward, dQ and dK/dV launched, dQ and dK/dV once
                 per layer per update, no bf16 route.
  7d. rlhf_actors_350m -- the same topology at `bench-350m` in bf16 with
                 7b's knobs: 2 rollout actors and the learner actor on the
                 one card.  One warm-up step and four timed steps (step s;
                 completion tokens/s over both workers, beside rlhf_350m's
                 one worker; update s; weight-sync ms, each engine's swap
                 ms (staging to copy done) and the packed bytes, with the
                 pack alone timed three times before; the engines'
                 weight_version equal to the learner's after every sync),
                 counters zeroed before the timed steps and
                 read after (the paged kernel replays x layers x K over both
                 engines, the forward on bf16 only, dQ and dK/dV 24 per
                 update on bf16 only, every timed window a replay), and one
                 step under torch.profiler (the busy share as the union of
                 kernel intervals over the wall: the two engines' streams
                 overlap).  Then two crash runs on a trainer with
                 checkpoint_every=1: a worker killed at rollout entry
                 (`rl.rollout_step` crash; the group is regenerated and
                 rollout_regens is 1), and the learner killed in the sync
                 window (`rl.weight_sync` crash; it resumes from the
                 newest checkpoint, learner_restarts is 1 and epoch
                 advances); after both, `kv_check` on every worker.
  7e. rlhf_mesh_small_f32 -- the mesh GRPO learner (`GRPOLearner(mesh=)`)
                 at `debug` in f32 (TF32 off) on a one-rank NCCL group (a
                 file:// store, a group timeout, the group left at the
                 end) and its `create_mesh(MeshConfig(data=1))`, on CUDA,
                 against the single-device learner on the CPU and on CUDA
                 from the same params: three whole-batch updates (lr 1e-2,
                 kl_coeff 0.1) of a seeded batch of 8 rows in groups of 4.
                 Against the CPU: the advantages of every update, the
                 first update's losses, KL and ratio, and its gradients
                 relative to each leaf's largest, within 1e-4 (the later
                 updates' metrics and the params are reported: Adam's eps
                 lets f32 rounding pick a step's sign, so the devices'
                 params part after the first step).  Against the CUDA
                 single-device learner: the losses equal and the params
                 within 1e-4 after three updates; a checkpoint of the
                 mesh learner loads into a
                 single-device learner to the bit and the reverse;
                 launches: dQ and dK/dV once a layer an update, all on the
                 f32 (FMA) routes.
  7f. rlhf_mesh_learner_350m -- the same at `bench-350m` width and depth
                 in bf16, on a batch of rlhf_350m's shape (16 completions
                 of 64 tokens on 384-token prompts, padded to 512, groups
                 of 8; behavior logprobs the params' scores plus noise),
                 lr 1e-6: the first update's loss and params against the
                 single-device learner's from the same params (equal, or
                 within the bf16 tolerance; the differences printed), then
                 three timed updates of each (a device sync around each),
                 the ms of each learner's `get_params_numpy` (the mesh's
                 is its gather), and the forward, dQ and dK/dV launches of
                 every update, on the bf16 (wgmma) routes only.

  8. moe_small_f32 -- the MoE family (`moe-debug`, f32, TF32 off) on CUDA
                 and on the CPU from the same params and tokens (batch 2 x
                 seq 64): `route` on the same hidden states gives the same
                 dispatch, and combine and aux within 1e-6; on tied
                 probabilities the same dispatch, ties to the lower index
                 (as lax.top_k; whether torch.topk's CUDA path does too is
                 reported); logits and loss
                 within 1e-4, and the first step's gradients within 1e-4 of
                 each leaf's largest; the grad pass launches the forward,
                 dQ and dK/dV once a layer each, on the f32 (FMA) routes
                 only.
  9. train_mixtral_4l -- `mixtral-8x7b` at its published widths (dim 4096,
                 32 / 8 heads of 128, ffn 14336, 8 experts, top 2, capacity
                 factor 1.25, vocab 32000) cut to 4 of its 32 layers for
                 memory (bf16 weights, gradients and AdamW moments: 8
                 bytes a parameter, 48.6 GB for 6.07 G parameters), bf16,
                 weights from seed 0, batch 2 x seq 4096 of seeded random
                 tokens (capacity 2560 an expert), `default_optimizer`,
                 remat flash_resid: one warm-up step, three timed steps
                 (step ms, tokens/s, MFU over active parameters, peak
                 memory, loss; the counters are zeroed just before and read
                 just after: 4 launches a step of each flash kernel, all
                 bf16), a no-grad forward for the aux loss and the share of
                 routed slots that capacity dropped, then one step under
                 torch.profiler split by range of the MoE layer (its
                 attention block; routing, dispatch, the expert GEMMs, the
                 f32 combine; each with its recompute and backward), the
                 flash kernels and the rest.

  10. vit_small_f32 -- a ViT with head_dim 32 (dim 128, 4 heads, 2 layers,
                 32-pixel images in 8-pixel patches; `vit-debug`'s head_dim
                 16 takes no kernel) in f32 (TF32 off) on CUDA and on the
                 CPU from the same params and images: logits and loss
                 within 1e-4, the first gradients within 1e-4 of each
                 leaf's largest; the grad pass (remat: each layer's
                 forward again in the backward) launches the forward twice
                 a layer and dQ and dK/dV once, non-causal, on the f32
                 (FMA) routes only.
  11. resnet_small_f32 -- `resnet-debug` on 33-pixel images (odd at every
                 stride 2) the same way, with cuDNN's TF32 off (printed:
                 f32 convolutions on TF32 would fail 1e-4); no flash
                 kernel runs.
  12. train_vit_b16 -- ViT-B/16 (Dosovitskiy et al. 2021: 224 px, patch 16,
                 dim 768, 12 x 12 heads, mlp 3072, 1000 classes) in bf16
                 with weights from seed 0, batch 256 of seeded random images,
                 `default_optimizer` over a TrainState built by hand from
                 the family's params (head_bias f32): one warm-up step,
                 three timed steps (images/s, MFU = images/s x 3 x forward
                 FLOPs / 989 TFLOP/s, peak memory), the counters zeroed just
                 before and read just after: 24 forward (12 and their remat
                 recompute), 12 dQ and 12 dK/dV launches a step, all on the
                 wgmma route; then one step under torch.profiler split into
                 flash, GEMM and conv, optimizer, norm and elementwise.
  13. train_resnet18 -- ResNet-18 (He et al. 2016, the reference's
                 GroupNorm 32 in place of BatchNorm) the same way at 224 px
                 in bf16 with its f32 parameter tree; no flash kernel.
  14. rl_learners_f32 -- each of the eight algorithms' learners (PPO,
                 IMPALA, APPO, DQN, BC, MARWIL, SAC, CQL) on CUDA and on the
                 CPU from the same params and a seeded batch: the first
                 minibatch's gradients within 1e-4 of each leaf's largest,
                 the first update's metrics within 1e-4 (its params are
                 reported: Adam's first step may flip an element whose
                 gradient is noise near zero).

  15. dreamer_f32 -- one DreamerV3 update (the reference's defaults:
                 deter 64, 4 x 4 latents, hidden 64, B 8, T 16, H 10; f32,
                 TF32 off) on CUDA and on the CPU from the same params, a
                 seeded CartPole batch and the same fixed Gumbel noise
                 through the algorithm's `gumbel` seam: the ten metrics
                 within 1e-4, every leaf's gradient within 1e-4 of its
                 largest; the params after the update are reported.
  16. dreamer_cartpole -- the reference test's DreamerV3 configuration
                 (CartPole, one env, 256 env steps and 3 updates a step(),
                 seed 0) on CUDA: six step()s (the world-model loss must
                 drop, nothing NaN, episodes complete), ms an update timed
                 alone, env steps/s of collection alone, and one update
                 under torch.profiler (busy share: a tiny eager scan model
                 is expected to be host-bound).  No flash kernel runs.
  17. trainer_350m -- the trainer stack at `bench-350m` (bf16): the
                 `ProcessGroupBackend` forms a one-rank NCCL group (file://
                 store) over an in-process worker group, `host_broadcast`
                 of the parameters (a copy at one rank), the device feed
                 (`iter_device_batches`, pinned memory and a side stream)
                 of batch 8 x 2048 from a seeded numpy iterator, a warm-up
                 and five timed `sharded_train_step`s on a data=1 mesh:
                 the warm-up loss equal to train_350m_sharded's first to
                 the bit, step ms against train_350m_sharded's, 24
                 launches a step of each flash kernel on wgmma (counted
                 into the kernels line), a traced step's busy share; the
                 group is left at the end.
  18. rl_algos_f32 -- each of the nine RL algorithms' training loops (PPO,
                 IMPALA, APPO, DQN, SAC, BC, MARWIL, CQL, multi-agent PPO)
                 built on a `LocalRuntime` with its learners on CUDA and
                 with them on the CPU, from the same params (hidden 16,
                 small batches, f32, TF32 off), one step() each: the
                 sampled fragments and every learner batch equal bit for
                 bit (numpy on the host), the counts equal, the learner
                 metrics and the params within 1e-4; no kernel runs.
  19. rl_algos_cartpole -- the nine at their reference tests' settings
                 (CartPole, hidden 64, seed 0), learners on the card, env
                 runners as `LocalRuntime` actors: PPO up to 12 step()s
                 must meet tests/test_rl.py's bar (best return >= 60, and
                 best > 1.2 x first or >= 100), the others 3; per
                 algorithm mean time_this_iter_s, steps/s, the learner's
                 ms a step() (around `learner_group.update` with a device
                 sync), first and best return, and one more step() under
                 torch.profiler (kernel launches, device busy share as the
                 union of device intervals over wall time).  The RL loops
                 launch none of the four kernels.
  20. cluster_core -- the port's own runtime (`ray_tpu_torch.init()`:
                 controller, node agent, plain workers and the device
                 worker, processes of their own; no JAX, ray_tpu, zmq,
                 msgpack, cloudpickle or psutil) on the card: the
                 resources it detects (GPU 1.0, from the /dev/nvidia<N>
                 nodes it may open), the
                 processes' pids, a plain task that sees no CUDA device
                 (CUDA_VISIBLE_DEVICES ""), two num_gpus=1 actors one
                 after the other in one device worker that reports
                 get_gpu_ids() == [0], and a 64 MB bf16 CUDA tensor put by
                 the driver, got in the device worker on cuda, returned
                 and equal bit for bit.  Init, first-task and device-worker
                 first-call times, put/get GB/s, each process's memory.
  21. cluster_rollout_350m -- an LLMRolloutWorker at rlhf_350m's settings
                 (bench-350m, bf16, two 384-token prompts, groups of 8, 64
                 new tokens, engine max_batch 16, page 64, K 4) as a
                 num_gpus=1 actor whose params are one put, against the
                 same worker in process from the same params and seeds:
                 two rollouts each, tokens identical, and the paged-decode
                 and flash-forward launches counted inside the device
                 worker (zeroed and read by remote calls) equal to the
                 in-process counts.  Rollout seconds and completion
                 tokens/s of both.
  22. cluster_rl_cartpole -- PPO at rl_algos_cartpole's settings through
                 ClusterRuntime (env runners in plain workers, the learner
                 with num_gpus_per_learner=1 in the device worker) against
                 LocalRuntime: three step()s each, the first step()'s
                 learner metrics within 1e-4, step() ms of both.
  23. cluster_collective -- collectives over the object plane
                 (ray_tpu_torch.collective) in a group of three: rank 0 a
                 num_gpus actor in the device worker (its tensors on
                 CUDA, copied to the host by the collective), ranks 1-2 in
                 plain workers.  Allreduce, allgather, reducescatter and
                 broadcast at 64 MB each on integer-valued f32 and bf16:
                 every rank's result equal bit for bit to the host
                 reduction, of the input's dtype; the tracer's sent bytes
                 per rank equal to the schedule's (`schedule_bytes`);
                 seconds, GB/s and phase sums per op.
  24. cluster_rlhf_actors_350m -- 7d's settings through ClusterRuntime:
                 the learner and both rollout actors ask for a share of
                 "GPU" and must all run in the device worker's pid.  One
                 warm-up step: each worker's first trajectory tokens equal
                 to 7d's and the learner's metrics and advantages within
                 1e-4.  Counters zeroed inside the device worker before
                 four timed steps and read there after: each equal to 7d's
                 count.  Step s, completion tokens/s, update s, and each
                 weight sync split from its harvested trace into the
                 learner's pack (the `collective.pack` span), each rank's
                 broadcast and the engines' swap ms, for 889,292,800
                 packed bytes; the harvested span names and the
                 rl_rollout_tokens counter the device worker flushed to the
                 controller's KV, equal to the completion tokens of the
                 five steps.  Then one crash run at 2 steps
                 (checkpoint_every=1): `rl.rollout_step` crash armed in
                 the device worker kills that process, so every actor of
                 the topology; the step recovers (rollout_regens and
                 learner_restarts reported, the actors respawned in one
                 new device worker, both engines at the learner's
                 version).
  25. cluster_serve_8b -- `LLMServer("llama3-8b", seed, max_batch 8,
                 page 512)` deployed on the port's serve
                 (`ray_tpu_torch.serve`: `serve.start`, `serve.run`, a
                 `DeploymentHandle`) as one `num_gpus=1` replica; it
                 builds its own weights from the seed, so they equal 4c's.
                 The replica must run in the device worker's pid (a
                 DeviceProbe read just before the deploy) on CUDA and
                 reach RUNNING within the controller's 120 s init
                 deadline (the controller's span from the replica's
                 creation to RUNNING, the server's build inside it, and
                 reserved memory reported).  After a
                 warm-up request, two fresh prompts sent one at a time
                 (64 new tokens, greedy) must give 4c's tokens for the
                 same prompts bit for bit; then 4c's eight prompts sent
                 at once through the handle must each return 64 tokens
                 (tokens/s and each TTFT beside 4c's fresh wave), with the
                 paged and bf16 flash launches counted in the replica
                 (zeroed there before the wave) nonzero and no f32 flash
                 launch, and `replica_metrics` reporting the server's
                 completed count.  `serve.delete` and `serve.shutdown`
                 must leave no controller and no replica.  The runtime is
                 shut down on every exit of phases 20-25.

Phase `kernels` also holds the flash forward and backward at the Mixtral
layer's shape ([2, 4096, 32, 8, 128], bf16, timed) and at the ViT-B/16
layer's ([256, 197, 12, 12, 64], bf16, non-causal, timed).

A line {"phase": "wall", "seconds": ...} gives the script's time.  The
line before the last is {"kernels": [...]}, one entry per kernel
(the forward, dQ and dK/dV: one per dtype route) with each main path's
launches and each timed layer's times; the last line is
{"ok": true, "device": {...}}.  Without CUDA, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound's rates.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Relative error |g - ref| / |ref| of the flash backward against its plain
# version in f32.  bf16: inputs and outputs are rounded to bf16 (2^-9
# relative each), the dQ kernel rounds dS to bf16 before dS K, as the TPU
# kernel does, and the dK/dV kernel rounds P and dS to bf16 for the tensor
# cores, where the f32 plain version does neither: about 3-5e-3 expected,
# 2e-2 allowed.  f32: summation order alone.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------ timing
class Timer:
    """CUDA-event timing of single launches with L2 flushed before each:
    in the model the same layer's call finds its inputs cold, since the
    whole weight set streams through L2 between two of them."""

    def __init__(self):
        self.flush_buf = torch.empty(256 << 20, dtype=torch.uint8,
                                     device="cuda")

    def ms(self, fn, iters: int = 10, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush_buf.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            total += a.elapsed_time(b)
        return total / iters


def kernel_name(mangled: str) -> str:
    """`flash_fwd_wgmma_kernel<128>` from an Itanium-mangled kernel name."""
    rest, parts = mangled[mangled.index("_ZN") + 3:], []
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group()
        parts.append(rest[len(n):len(n) + int(n)])
        rest = rest[len(n) + int(n):]
    args = re.match(r"I(\w+?)EE", rest)
    if not args:
        return parts[-1]
    a = args.group(1).replace("13__nv_bfloat16", "bf16,")
    a = re.sub(r"^f", "f32,", a).replace("Li", "")
    return f"{parts[-1]}<{a}>"


def ptxas_report(log: str) -> dict:
    """From one source's `ptxas -v` log: registers per kernel, the spill
    line of each kernel that spills, and the performance warnings (such as
    wgmma serialised for want of registers)."""
    regs, spills, warnings, name = {}, {}, [], None
    for ln in (x.strip() for x in log.splitlines()):
        m = re.search(r"(?:entry function '|properties for )(_ZN[^' ]+)", ln)
        if m:
            name = kernel_name(m.group(1))
        elif "spill" in ln and name and " 0 bytes spill stores" not in ln:
            spills[name] = ln
        elif "Used" in ln and "registers" in ln and name:
            regs[name] = int(re.search(r"Used (\d+) registers", ln).group(1))
        elif "Performance Loss" in ln or "ignored" in ln:
            warnings.append(ln[:240])
    return {"registers": regs, "spilling": spills, "warnings": warnings}


def bound_ms(nbytes: float, flops: float, flops_rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


# ------------------------------------------------------- phase 2: kernels
def flash_case(timer, name, b, s, hq, hkv, d, dtype, causal=True,
               timed=False):
    from ray_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                   flash_attention_reference)

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q = torch.randn(b, s, hq, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype)
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref_o, ref_lse = flash_attention_reference(q.float(), k.float(),
                                               v.float(), causal=causal)
    err = max(max_err(o, ref_o), max_err(lse, ref_lse))
    row = {"case": name, "shape": [b, s, hq, hkv, d], "dtype": str(dtype),
           "causal": causal, "max_abs_err": err, "tol": TOL[dtype]}
    if err > TOL[dtype] or not torch.isfinite(o.float()).all():
        raise AssertionError(f"flash_attention_fwd {name}: {row}")
    if timed:
        row["ms"] = timer.ms(lambda: flash_attention_fwd(q, k, v, causal))
        row["plain_ms"] = timer.ms(
            lambda: flash_attention_reference(q, k, v, causal), iters=3)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        rep = hq // hkv
        kr = kt.repeat_interleave(rep, dim=1)
        vr = vt.repeat_interleave(rep, dim=1)
        row["library_ms"] = timer.ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kr, vr, is_causal=causal))
        pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
        nbytes = (q.numel() * 2 + k.numel() * 2) * q.element_size() \
            + lse.numel() * 4
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 4 * d * pairs,
            BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    return row


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def flash_bwd_case(timer, name, b, s, hq, hkv, d, dtype, causal=True,
                   timed=False):
    from ray_tpu_torch.ops.flash_attention import (
        attention_delta, flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_bwd_reference, flash_attention_fwd)

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    q = torch.randn(b, s, hq, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dtype)
    do = torch.randn(b, s, hq, d, generator=g, device="cuda").to(dtype)
    o, lse = flash_attention_fwd(q, k, v, causal)
    delta = attention_delta(o, do)
    n0 = flash_counts()
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    # Each wrapper launched once, on its dtype's route only.
    ran = {n: c - n0[n] for n, c in flash_counts().items() if c != n0[n]}
    route = "/wgmma" if dtype == torch.bfloat16 else "/fma"
    if ran != {w + r: 1 for w in ("flash_attention_bwd_dq",
                                  "flash_attention_bwd_dkv")
               for r in ("", route)}:
        raise AssertionError(f"flash backward {name}: launches {ran}")
    # The same bits on a second run: no atomics, one order of sums.
    again = (flash_attention_bwd_dq(q, k, v, do, lse, delta, causal),
             *flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal))
    if not all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)):
        raise AssertionError(f"flash backward {name}: a second run gave "
                             "other bits")
    ref = flash_attention_bwd_reference(q.float(), k.float(), v.float(),
                                        o.float(), lse, do.float(), causal)
    got = dict(zip(("dq", "dk", "dv"), (dq, dk, dv)))
    want = dict(zip(("dq", "dk", "dv"), ref))
    row = {"case": name, "shape": [b, s, hq, hkv, d], "dtype": str(dtype),
           "causal": causal, "launches": ran, "same_bits_on_rerun": True,
           "rel_err": {n: rel_err(got[n], want[n]) for n in got},
           "max_abs_err": {n: max_err(got[n], want[n]) for n in got},
           "tol_rel": BWD_TOL[dtype]}
    if max(row["rel_err"].values()) > BWD_TOL[dtype] or not all(
            torch.isfinite(t.float()).all() for t in got.values()):
        raise AssertionError(f"flash backward {name}: {row}")
    if timed:
        row["dq_ms"] = timer.ms(lambda: flash_attention_bwd_dq(
            q, k, v, do, lse, delta, causal))
        row["dkv_ms"] = timer.ms(lambda: flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, causal))
        # One plain function computes dq, dk and dv together.
        row["plain_ms"] = timer.ms(lambda: flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal), iters=3)
        rep = hq // hkv
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kr = k.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous() \
            .requires_grad_()
        vr = v.transpose(1, 2).repeat_interleave(rep, dim=1).contiguous() \
            .requires_grad_()
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kr, vr, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()
        # The backward alone of SDPA: one call for dq, dk and dv together.
        row["library_ms"] = timer.ms(lambda: torch.autograd.grad(
            out, (qt, kr, vr), dot, retain_graph=True))
        del out
        pairs = b * hq * (s * (s + 1) // 2 if causal else s * s)
        esz = q.element_size()
        qb, kb, f32b = q.numel() * esz, k.numel() * esz, lse.numel() * 4
        rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        # Each input read once, each output written once: q, k, v, dO, lse,
        # delta in; dq (3 products, 6 d flops a pair) or dk, dv (4
        # products, 8 d); the pair fused: 5 products, 10 d.
        row["dq_bound_ms"], row["dq_bound_by"] = bound_ms(
            3 * qb + 2 * kb + 2 * f32b, 6 * d * pairs, rate)
        row["dkv_bound_ms"], row["dkv_bound_by"] = bound_ms(
            2 * qb + 4 * kb + 2 * f32b, 8 * d * pairs, rate)
        row["fused_bound_ms"], row["fused_bound_by"] = bound_ms(
            3 * qb + 4 * kb + 2 * f32b, 10 * d * pairs, rate)
    return row


def paged_inputs(B, kvh, rep, hd, page, maxp, kt, n_pages, dtype, ts, pos,
                 table=None):
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    if table is None:      # distinct pages per slot; unused columns -> 0
        table = torch.zeros(B, maxp, dtype=torch.int32)
        nxt = 1
        for b in range(B):
            for i in range(-(-(int(pos[b]) + 1) // page)):
                table[b, i] = nxt
                nxt += 1
        assert nxt <= n_pages
    return [rnd(B, kvh, rep, hd), rnd(n_pages, kvh, page, hd),
            rnd(n_pages, kvh, page, hd), rnd(B, kvh, kt, hd),
            rnd(B, kvh, kt, hd), table.to("cuda"),
            torch.tensor(pos, dtype=torch.int32, device="cuda"),
            torch.tensor(ts, dtype=torch.int32, device="cuda")]


def paged_case(timer, name, args, timed=False):
    from ray_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                   paged_decode_reference)

    dtype = args[0].dtype
    n0 = paged_decode_attention.launches
    o = paged_decode_attention(*args)
    again = paged_decode_attention(*args)
    torch.cuda.synchronize()
    ref = paged_decode_reference(*[a.float() if a.is_floating_point()
                                   else a for a in args])
    err = max_err(o, ref)
    B, kvh, rep, hd = args[0].shape
    row = {"case": name, "shape": [B, kvh, rep, hd, args[1].shape[2],
                                   args[5].shape[1], args[3].shape[2]],
           "tail_start": args[7].tolist(), "pos": args[6].tolist(),
           "dtype": str(dtype), "max_abs_err": err, "tol": TOL[dtype],
           "same_bits_on_rerun": bool(torch.equal(o, again))}
    if err > TOL[dtype] or not torch.isfinite(o.float()).all() \
            or paged_decode_attention.launches - n0 != 2:
        raise AssertionError(f"paged_decode_attention {name}: {row}")
    if not row["same_bits_on_rerun"]:
        raise AssertionError(f"paged_decode_attention {name}: a second run "
                             "gave other bits")
    if timed:
        row["ms"] = timer.ms(lambda: paged_decode_attention(*args))
        row["plain_ms"] = timer.ms(lambda: paged_decode_reference(*args),
                                   iters=3)
        row["library_ms"] = None
        pos = args[6].cpu().numpy().astype(np.int64)
        ts = args[7].cpu().numpy().astype(np.int64)
        rows = np.minimum(ts, args[5].shape[1] * args[1].shape[2]) \
            + np.maximum(0, np.minimum(pos - ts + 1, args[3].shape[2]))
        esz = args[0].element_size()
        nbytes = (2 * rows.sum() * kvh * hd + 2 * args[0].numel()) * esz \
            + 4 * (args[5].numel() + 2 * B)
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 4 * rep * hd * kvh * rows.sum(),
            BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
    return row


MAIN_PROMPTS = [312, 1000, 457, 803, 640, 999, 388, 725]   # phase 4 lengths


def phase_kernels(timer):
    """Rows by case name: {"fwd": {...}, "paged": {...}, "bwd": {...}}."""
    bf, f32 = torch.bfloat16, torch.float32
    flash = [
        # The 8-request wave's prefill: bucket 1024, Llama-3-8B heads.
        flash_case(timer, "8b_wave_bucket1024", 8, 1024, 32, 8, 128, bf,
                   timed=True),
        # One bench-350m layer call: b 8 x s 2048, 8 q / 4 kv heads.
        flash_case(timer, "350m_train_layer", 8, 2048, 8, 4, 128, bf,
                   timed=True),
        # The rlhf_350m loop: scoring and the learner's forward at b 16 x
        # s 512 (the pow2 scoring width), the leaders' prefill at the
        # width bucket 8 x bucket 512.
        flash_case(timer, "350m_rlhf_score", 16, 512, 8, 4, 128, bf,
                   timed=True),
        flash_case(timer, "350m_rlhf_prefill", 8, 512, 8, 4, 128, bf),
        # One Mixtral layer call in train_mixtral_4l: b 2 x s 4096, 32 q /
        # 8 kv heads.
        flash_case(timer, "mixtral_train_layer", 2, 4096, 32, 8, 128, bf,
                   timed=True),
        # One ViT-B/16 layer call in train_vit_b16: b 256 x 197 tokens, 12
        # heads of 64, no GQA, non-causal.
        flash_case(timer, "vit_b16_layer", 256, 197, 12, 12, 64, bf,
                   causal=False, timed=True),
        flash_case(timer, "8b_single_bucket512", 1, 512, 32, 8, 128, bf),
        flash_case(timer, "ragged_1000", 1, 1000, 32, 8, 128, bf),
        flash_case(timer, "bf16_hd64_ragged", 2, 333, 8, 2, 64, bf),
        flash_case(timer, "bf16_hd32_ragged", 1, 517, 4, 1, 32, bf),
        flash_case(timer, "bf16_noncausal", 1, 300, 4, 2, 128, bf,
                   causal=False),
        # The f32 route (FMA) at the `debug` training shapes.
        flash_case(timer, "f32_debug_train", 2, 100, 4, 2, 32, f32,
                   timed=True),
        flash_case(timer, "f32_hd64_ragged", 2, 77, 8, 2, 64, f32),
        flash_case(timer, "f32_hd32_noncausal", 1, 45, 4, 2, 32, f32,
                   causal=False),
    ]
    # Decode at the main path's state: slots mid-window (pos = ts + 3).
    ts = [n + 32 for n in MAIN_PROMPTS]
    pos = [t + 3 for t in ts]
    paged = [
        paged_case(timer, "8b_decode_window",
                   paged_inputs(8, 8, 4, 128, 512, 16, 8, 65, bf, ts, pos),
                   timed=True),
        # The rlhf_350m decode state: bench-350m heads (kvh 4, rep 2, hd
        # 128), pages of 64, table width 8, K 4; two groups of 8 slots
        # whose 384-token prompt is six shared pages (1-6 and 7-12), each
        # slot's completion on a page of its own, slots spread over the
        # 64 new tokens (pos 384-447) and over the window's four steps.
        paged_case(timer, "350m_rlhf_decode", paged_inputs(
            16, 4, 2, 128, 64, 8, 4, 29, bf,
            [384 + 4 * b for b in range(16)],
            [384 + 4 * b + b % 4 for b in range(16)],
            table=torch.tensor([[1 + 6 * (b // 8) + i for i in range(6)]
                                + [13 + b, 0] for b in range(16)],
                               dtype=torch.int32)),
            timed=True),
        # Page boundaries; an idle slot whose pos ran far past its table
        # row (all zeros: the trash page); a slot with nothing admitted.
        paged_case(timer, "f32_page8_boundaries", paged_inputs(
            4, 2, 2, 32, 8, 4, 4, 20, f32, [0, 7, 8, 27], [2, 9, 10, 29])),
        paged_case(timer, "bf16_runaway_and_empty", paged_inputs(
            3, 2, 4, 64, 16, 2, 4, 8, bf, [3, 10_000, 5], [4, 10_001, 4],
            table=torch.tensor([[1, 2], [0, 0], [3, 0]], dtype=torch.int32))),
        paged_case(timer, "f32_hd128_rep8", paged_inputs(
            2, 1, 8, 128, 16, 3, 8, 9, f32, [17, 40], [20, 40])),
        # A long context at the 8B heads: keys in every split of each
        # cluster, each split's share looping.
        paged_case(timer, "8b_long_context",
                   paged_inputs(2, 8, 4, 128, 512, 16, 8, 26, bf,
                                [7990, 4100], [7993, 4103]),
                   timed=True),
        # Batch 32 at 1000 tokens each: against the 8B state's time, how
        # much of a call is fixed cost and how much moves bytes.
        paged_case(timer, "8b_batch32_decode",
                   paged_inputs(32, 8, 4, 128, 512, 16, 8, 65, bf,
                                [1000] * 32, [1003] * 32),
                   timed=True),
        # Fewer admitted keys than splits (4 and 3): most splits empty.
        paged_case(timer, "bf16_fewer_keys_than_splits", paged_inputs(
            3, 2, 4, 128, 16, 4, 4, 8, bf, [3, 0, 40], [3, 2, 41])),
        # 128 keys in 8 splits of 16 on pages of 16: every split ends on a
        # page boundary (slot 1: the last split is the tail).
        paged_case(timer, "f32_splits_on_page_boundaries", paged_inputs(
            2, 2, 2, 64, 16, 8, 8, 17, f32, [128, 120], [127, 127])),
    ]
    flash_bwd = [
        # One bench-350m layer call: b 8 x s 2048, 8 q / 4 kv heads.
        flash_bwd_case(timer, "350m_train_layer", 8, 2048, 8, 4, 128, bf,
                       timed=True),
        # The rlhf_350m learner's layer call: b 16 x s 512.
        flash_bwd_case(timer, "350m_rlhf_learner", 16, 512, 8, 4, 128, bf,
                       timed=True),
        # The Mixtral layer call of train_mixtral_4l.
        flash_bwd_case(timer, "mixtral_train_layer", 2, 4096, 32, 8, 128,
                       bf, timed=True),
        # The ViT-B/16 layer call of train_vit_b16 (non-causal, head_dim
        # 64).
        flash_bwd_case(timer, "vit_b16_layer", 256, 197, 12, 12, 64, bf,
                       causal=False, timed=True),
        flash_bwd_case(timer, "8b_heads", 1, 1024, 32, 8, 128, bf),
        flash_bwd_case(timer, "ragged_1000", 1, 1000, 8, 4, 128, bf),
        flash_bwd_case(timer, "bf16_hd64_ragged", 2, 333, 8, 2, 64, bf),
        flash_bwd_case(timer, "bf16_hd32_ragged", 1, 517, 4, 1, 32, bf),
        flash_bwd_case(timer, "bf16_noncausal", 1, 300, 4, 2, 128, bf,
                       causal=False),
        # The f32 routes (FMA) at the `debug` training shapes.
        flash_bwd_case(timer, "f32_debug_train", 2, 100, 4, 2, 32, f32,
                       timed=True),
        flash_bwd_case(timer, "f32_hd64_ragged", 2, 77, 8, 2, 64, f32),
        flash_bwd_case(timer, "f32_hd32_noncausal", 1, 45, 4, 2, 32, f32,
                       causal=False),
        flash_bwd_case(timer, "f32_mqa", 2, 130, 4, 1, 64, f32),
    ]
    emit({"phase": "kernels", "flash_attention_fwd": flash,
          "paged_decode_attention": paged, "flash_attention_bwd": flash_bwd})
    return {"fwd": {r["case"]: r for r in flash},
            "paged": {r["case"]: r for r in paged},
            "bwd": {r["case"]: r for r in flash_bwd}}


# ----------------------------------------------- phase 3: small f32 engine
SHARED = [(i * 7 + 3) % 250 + 1 for i in range(32)]      # 2 pages of 16
GRAFT = [(i * 11 + 5) % 250 + 1 for i in range(40)]      # 2 pages + 8
MIGRATE = SHARED[:16] + [(i * 13 + 1) % 250 + 1 for i in range(21)]


def run_small(engine_cls, cfg, params, device, adapter, new_params):
    """Greedy tokens of the small workloads on one device, and each
    engine's counters.  `eng` (LoRA banks) serves the prefix, COW, LoRA,
    sync-window and prefill-only requests, demotes a prefix and takes a
    weight swap; `dec` resumes the exported request and takes the
    demoted prefix as a graft.  Each engine decodes with its own copy of
    `params`."""
    out = {}
    kw = dict(device=device, max_batch=4, max_len=128, page_size=16, seed=0)
    eng = engine_cls(cfg, params, lora_slots=2, lora_rank=4, **kw)
    dec = engine_cls(cfg, params, **kw)
    eng.start()
    dec.start()
    try:
        eng.warmup()
        out["prefix"] = [eng.generate(SHARED + t, max_new_tokens=12)["tokens"]
                         for t in ([40, 41, 42], [50, 51], [60])]
        out["cow"] = [eng.generate(SHARED, max_new_tokens=8)["tokens"]
                      for _ in range(2)]
        st = eng.stats()
        out["hits"], out["cow_copies"] = st["prefix_hit_tokens"], \
            st["cow_copies"]
        # One wave mixing base and adapter rows.
        eng.load_adapter("t/a", adapter)
        futs = [eng.submit(SHARED[:20] + [70 + i], max_new_tokens=12,
                           model_id="t/a" if i % 2 else None)
                for i in range(4)]
        out["lora"] = [f.result(timeout=600)["tokens"] for f in futs]
        # A smaller live window, then back to the configured one.
        eng.set_sync_window(2)
        out["window2"] = eng.generate(SHARED[:9], max_new_tokens=11)["tokens"]
        eng.set_sync_window(None)
        # Prefill on eng, decode on dec.
        out["migrate_ref"] = dec.generate(MIGRATE, max_new_tokens=12,
                                          _cache_ok=False)["tokens"]
        exp = eng.submit(MIGRATE, max_new_tokens=1, prefill_only=True) \
            .result(timeout=600)["kv_export"]
        out["migrated"] = dec.kv_import(
            MIGRATE, exp["tokens"], exp["kv"], kv_len=exp["len"],
            max_new_tokens=12, sample_seed=exp["sample_seed"]
        ).result(timeout=600)["tokens"]
        # Demote GRAFT's two blocks from eng, graft them into dec.
        out["graft_src"] = eng.generate(GRAFT, max_new_tokens=8)["tokens"]
        store = {}
        eng.set_prefix_store(
            lambda e: store.setdefault(tuple(e["tokens"]), e) is e,
            min_idle=0, period_s=0.01, watermark_frac=0.0, limit=8,
            max_inflight=8)
        key, deadline = tuple(GRAFT[:32]), time.time() + 60
        while key not in store and time.time() < deadline:
            eng._wake.set()
            time.sleep(0.01)
        eng.set_prefix_store(None)
        h0 = dec.stats()["prefix_hit_tokens"]
        out["grafted"] = dec.kv_graft(list(key), store[key]["kv"], kv_len=32,
                                      weight_version=0).result(timeout=600)
        out["graft"] = dec.generate(GRAFT, max_new_tokens=8)["tokens"]
        out["graft_hit_tokens"] = dec.stats()["prefix_hit_tokens"] - h0
        # A live weight swap.
        out["before_swap"] = eng.generate(SHARED[:5], 10)["tokens"]
        eng.update_weights(new_params)
        out["swapped"] = eng.generate(SHARED[:5], 10)["tokens"]
        counters = {"eng": eng.stats(), "dec": dec.stats(),
                    "eng_graphs": eng.graph_stats()}
    finally:
        eng.stop()
        dec.stop()
    fresh = engine_cls(cfg, tree_to(new_params, device), **kw)
    try:
        out["fresh"] = fresh.generate(SHARED[:5], 10)["tokens"]
    finally:
        fresh.stop()
    starved = engine_cls(cfg, params, device=device, max_batch=4,
                         max_len=128, page_size=16, kv_pages=7,
                         prefix_cache=False, kv_preempt=True, seed=0)
    futs = [starved.submit([i + 1, i + 2, i + 3, i + 4, i + 5],
                           max_new_tokens=38) for i in range(0, 40, 10)]
    starved.start()
    try:
        out["preempt"] = [f.result(timeout=600)["tokens"] for f in futs]
    finally:
        starved.stop()
    out["preemptions"] = starved.preemptions
    return out, counters


def window_sync_check(cfg, params) -> dict:
    """One decode window dispatched under CUDA sync debug mode "error":
    the K steps, the sampling and the tail merge never wait on the device
    (the engine's one sync per window is its copy of the returned token
    block).  Drives the loop's own steps on this thread; the first window
    captures the graph, the checked one replays it."""
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(cfg, params, device="cuda", max_batch=4, max_len=128,
                    page_size=16, seed=0)
    for i in range(4):
        eng.submit([i + 1, 2, 3, 4, 5], max_new_tokens=20,
                   temperature=0.8 * (i % 2))
    eng._admit()
    active = eng._ensure_decode_blocks()
    eng._decode_window(active)            # first use: eager, then capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._decode_window(active)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if eng.graph_replays != 1:
        raise AssertionError("the checked window was not a graph replay")
    return {"slots": len(active), "replayed": eng.graph_replays}


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.detach().to(device) if isinstance(tree, torch.Tensor) \
        else tree


def graph_accounting(stats: dict) -> dict:
    """Every window after the first of its kind replays its graph."""
    return {k: stats[k] for k in ("decode_windows", "graph_replays",
                                  "graph_captures", "graph_capture_s")}


def phase_engine_small():
    import dataclasses

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention
    from ray_tpu_torch.serve.llm import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 products
    cfg = dataclasses.replace(llama.llama_configs()["debug"],
                              dtype=torch.float32)
    cpu_params = llama.init_params(cfg, torch.Generator().manual_seed(SEED))
    new_params = llama.init_params(cfg,
                                   torch.Generator().manual_seed(SEED + 5))
    adapter = llama.init_lora_adapter(torch.Generator().manual_seed(SEED + 1),
                                      cfg, 4)

    n0 = (flash_counts(), paged_decode_attention.launches)
    t0 = time.perf_counter()
    gpu, counters = run_small(LLMEngine, cfg, tree_to(cpu_params, "cuda"),
                              "cuda", tree_to(adapter, "cuda"), new_params)
    t_gpu = time.perf_counter() - t0
    sync = window_sync_check(cfg, tree_to(cpu_params, "cuda"))
    cpu, _ = run_small(LLMEngine, cfg, cpu_params, "cpu", adapter,
                       new_params)
    fwd = {n: c - n0[0][n] for n, c in flash_counts().items()
           if n.startswith("flash_attention_fwd")}
    launched = {**fwd, "paged_decode_attention":
                paged_decode_attention.launches - n0[1]}
    same = {k: gpu[k] == cpu[k] for k in gpu}
    graphs = {e: graph_accounting(counters[e]) for e in ("eng", "dec")}
    row = {"phase": "engine_small_f32", "same_tokens": same,
           "prefix_hit_tokens": gpu["hits"], "cow_copies": gpu["cow_copies"],
           "preemptions": gpu["preemptions"],
           "graft": gpu["grafted"], "graft_hit_tokens": gpu["graft_hit_tokens"],
           "swap_changed_tokens": gpu["swapped"] != gpu["before_swap"],
           "swapped_equals_fresh_engine": gpu["swapped"] == gpu["fresh"],
           "migrated_equals_uninterrupted":
               gpu["migrated"] == gpu["migrate_ref"],
           "graphs": graphs, "eng_graphs": counters["eng_graphs"],
           "window_without_host_sync": sync,
           "kernel_launches": launched,
           "cuda_seconds": t_gpu}
    emit(row)
    if not all(same.values()) or gpu != cpu:
        raise AssertionError(f"CUDA and CPU engines disagree: {gpu} {cpu}")
    if gpu["preemptions"] == 0 or gpu["cow_copies"] == 0 \
            or gpu["hits"] == 0 or launched["paged_decode_attention"] == 0 \
            or launched["flash_attention_fwd/fma"] == 0 \
            or launched["flash_attention_fwd/wgmma"]:
        raise AssertionError(f"small engine missed a path: {row}")
    if not (row["swap_changed_tokens"] and row["swapped_equals_fresh_engine"]
            and row["migrated_equals_uninterrupted"]
            and gpu["grafted"]["grafted"] == 2
            and gpu["graft_hit_tokens"] >= 32
            and gpu["graft"] == gpu["graft_src"]
            and counters["eng"]["weight_version"] == 1
            and counters["dec"]["kv_imports"] == 1
            and counters["eng"]["kv_exports"] == 1):
        raise AssertionError(f"small engine: a slice path failed: {row}")
    for name, g in graphs.items():
        if g["graph_replays"] == 0 or g["decode_windows"] \
                != g["graph_replays"] + g["graph_captures"]:
            raise AssertionError(f"{name}: a window after the first of its "
                                 f"kind was not a replay: {g}")
    if set(counters["eng_graphs"]) != {"K=8", "K=2"}:
        raise AssertionError(f"captured windows {counters['eng_graphs']} "
                             "are not one per size, K=8 and K=2")
    return launched


# ----------------------------------------- phase 3b: small f32 dense engine
DENSE_PROMPTS = [[(i * k + 3) % 250 + 1 for i in range(n)]
                 for k, n in ((7, 21), (5, 13), (11, 30), (3, 9), (13, 40),
                              (17, 5))]
DENSE_NEW = [9, 6, 12, 7, 5, 10]
SMALL = dict(max_batch=4, max_len=128, steps_per_sync=4, seed=0)


def small_wave(eng):
    """DENSE_PROMPTS submitted together on a started engine; tokens."""
    futs = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(DENSE_PROMPTS, DENSE_NEW)]
    return [f.result(timeout=600)["tokens"] for f in futs]


def phase_engine_small_dense():
    """The dense engine (paged=False) at `debug` in f32: its greedy tokens
    on CUDA (captured windows, the flash forward in prefill) against the
    same engine on the CPU and the paged engine on CUDA, an LLMServer
    (paged=False) serving calls and a stream, and a server reconfigured
    from paged to dense and back."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention
    from ray_tpu_torch.serve.llm import LLMEngine, LLMServer

    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 products
    cfg = dataclasses.replace(llama.llama_configs()["debug"],
                              dtype=torch.float32)
    cpu_params = llama.init_params(cfg, torch.Generator().manual_seed(SEED))
    params = tree_to(cpu_params, "cuda")
    runs, stats = {}, {}
    zero_serve_counts()
    for name, device, kw in (("dense_cuda", "cuda", {"paged": False}),
                             ("dense_cpu", "cpu", {"paged": False}),
                             ("paged_cuda", "cuda", {"page_size": 16})):
        eng = LLMEngine(cfg, params if device == "cuda" else cpu_params,
                        device=device, **SMALL, **kw)
        eng.start()
        try:
            small_wave(eng)                     # the first windows capture
            runs[name] = small_wave(eng)
        finally:
            eng.stop()
        stats[name] = graph_accounting(eng.stats())
        if name == "dense_cuda":
            torch.cuda.synchronize()
            dense_launches = launch_counts()
            stats[name]["kv_check"] = eng.kv_check()
    # The server, on CUDA: concurrent calls and a stream.
    reqs = [{"prompt": p, "max_new_tokens": n}
            for p, n in zip(DENSE_PROMPTS, DENSE_NEW)]

    async def gather(srv):
        return await asyncio.gather(*(srv(r) for r in reqs))

    srv = LLMServer(cfg, params=params, device="cuda", paged=False, **SMALL)
    try:
        served = [r["tokens"]
                  for r in asyncio.run(asyncio.wait_for(gather(srv), 600))]
        streamed = list(srv.stream(reqs[2]))
        srv_check = srv.kv_check()
    finally:
        srv.shutdown()
    # Reconfigure a paged server to dense and back.
    srv = LLMServer(cfg, params=params, device="cuda", page_size=16, **SMALL)
    recon = {}
    try:
        for label, change in (("paged", None), ("dense", {"paged": False}),
                              ("paged_again", {"paged": True})):
            if change:
                srv.reconfigure(change)
            recon[label] = {
                "paged": srv.engine.paged,
                "tokens": [r["tokens"] for r in asyncio.run(
                    asyncio.wait_for(gather(srv), 600))]}
    finally:
        srv.shutdown()
    dense = runs["dense_cuda"]
    row = {"phase": "engine_small_dense_f32", "requests": len(reqs),
           "max_batch": SMALL["max_batch"],
           "dense_cuda_equals_dense_cpu": dense == runs["dense_cpu"],
           "dense_cuda_equals_paged_cuda": dense == runs["paged_cuda"],
           "server_equals_engine": served == dense,
           "stream_equals_call": streamed == dense[2],
           "server_kv_check": srv_check,
           "reconfigure": {k: {"paged": v["paged"],
                               "same_tokens": v["tokens"] == dense}
                           for k, v in recon.items()},
           "graphs": stats, "launches_dense_cuda": dense_launches}
    emit(row)
    if not (row["dense_cuda_equals_dense_cpu"]
            and row["dense_cuda_equals_paged_cuda"]
            and row["server_equals_engine"] and row["stream_equals_call"]
            and all(v["same_tokens"] for v in row["reconfigure"].values())
            and [v["paged"] for v in row["reconfigure"].values()]
            == [True, False, True]):
        raise AssertionError(f"engine_small_dense_f32: tokens: {row}")
    g = stats["dense_cuda"]
    if g["graph_replays"] == 0 or g["decode_windows"] \
            != g["graph_replays"] + g["graph_captures"] \
            or stats["dense_cuda"]["kv_check"] != {"ok": True,
                                                  "paged": False}:
        raise AssertionError(f"engine_small_dense_f32: windows: {g}")
    if dense_launches["paged_decode_attention"] \
            or dense_launches["flash_attention_fwd/fma"] == 0 \
            or dense_launches["flash_attention_fwd/wgmma"]:
        raise AssertionError(f"engine_small_dense_f32: the dense engine's "
                             f"launches {dense_launches}")
    return dense_launches


# ----------------------------------------------- phase 4: full-width 8B
def paged_per_replay(cfg, k: int) -> int:
    """Paged-kernel launches in one replay of a K-step window."""
    return cfg.n_layers * k


def phase_serve_8b(card, cfg, params, t_init):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.tools.profile_serve import trace_wave, wave_decode_rate

    # The hidden states of a real prompt come out finite and shaped.
    probe = torch.arange(1, 65, device="cuda")[None]
    hidden, ks, _ = llama.prefill(params, probe, cfg)
    if hidden.shape != (1, 64, cfg.dim) or ks.shape != (
            cfg.n_layers, 1, 64, cfg.n_kv_heads, cfg.head_dim) \
            or not torch.isfinite(hidden.float()).all():
        raise AssertionError("llama3-8b prefill gave bad hidden states")
    del hidden, ks

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in MAIN_PROMPTS]
    eng = LLMEngine(cfg, params, seed=SEED)      # engine defaults
    K = eng.steps_per_sync
    eng.start()
    try:
        # Warm-up: a 300-token prompt (prefill bucket 512) whose one decode
        # window captures the greedy K-step graph; the wave below pads to
        # bucket 1024 and every one of its windows replays that graph.
        eng.generate(rng.integers(1, cfg.vocab_size, size=300).tolist(),
                     max_new_tokens=8)
        torch.cuda.synchronize()
        zero_flash_counts()
        paged_decode_attention.launches = 0
        s0 = eng.stats()
        t_wave = time.perf_counter()
        futs = [eng.submit(p, max_new_tokens=64) for p in prompts]
        res = [f.result(timeout=600) for f in futs]
        wave_s = time.perf_counter() - t_wave
        ninth = prompts[1][:512] + rng.integers(
            1, cfg.vocab_size, size=200).tolist()
        r9 = eng.submit(ninth, max_new_tokens=64).result(timeout=600)
        torch.cuda.synchronize()
        launches = {n: c for n, c in flash_counts().items()
                    if n.startswith("flash_attention_fwd")}
        launches["paged_decode_attention"] = paged_decode_attention.launches
        s1 = eng.stats()
        # The same wave shape again under torch.profiler (fresh prompts, no
        # prefix hits): the busy share, and the replayed windows' paged
        # kernels counted in the trace against the credited counter.
        traced_prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                          for n in MAIN_PROMPTS]
        p0 = paged_decode_attention.launches
        traced = trace_wave(eng, traced_prompts)
        traced_counter = paged_decode_attention.launches - p0
        graphs = eng.graph_stats()
    finally:
        eng.stop()
    for r in res + [r9]:
        toks = r["tokens"]
        if len(toks) != 64 or not all(0 <= t < cfg.vocab_size
                                      for t in toks):
            raise AssertionError(f"bad completion: {toks}")
    hit = s1["prefix_hit_tokens"] - s0["prefix_hit_tokens"]
    if hit < 512:
        raise AssertionError(f"ninth request missed the prefix cache: {s1}")
    if launches["paged_decode_attention"] == 0 \
            or launches["flash_attention_fwd/wgmma"] == 0 \
            or launches["flash_attention_fwd/wgmma"] \
            != launches["flash_attention_fwd"]:
        raise AssertionError(f"a kernel of the path never launched, or the "
                             f"bf16 forward left its route: {launches}")
    replays = s1["graph_replays"] - s0["graph_replays"]
    windows = s1["decode_windows"] - s0["decode_windows"]
    traced_paged = traced["groups"].get("paged_decode", {}).get("launches")
    if replays == 0 or replays != windows \
            or launches["paged_decode_attention"] \
            != replays * paged_per_replay(cfg, K):
        raise AssertionError(
            f"windows {windows}, replays {replays}, paged launches "
            f"{launches['paged_decode_attention']} != replays x "
            f"{paged_per_replay(cfg, K)}")
    if traced["graph_replays"] != traced["decode_windows"] \
            or traced_paged != traced_counter \
            or traced_counter != traced["graph_replays"] \
            * paged_per_replay(cfg, K):
        raise AssertionError(f"traced wave: profiler counted {traced_paged} "
                             f"paged kernels, the counter {traced_counter}, "
                             f"replays {traced['graph_replays']}")
    ttft = [r["ttft_s"] for r in res]
    emit({"phase": "serve_8b", "card": card, "model": "llama3-8b",
          "dtype": "bfloat16", "requests": len(res) + 1,
          "new_tokens_each": 64, "prompt_tokens": MAIN_PROMPTS,
          "init_params_s": t_init, "wave_s": wave_s,
          "ttft_s": {"min": min(ttft), "max": max(ttft)},
          "prefill_tokens_per_s": sum(MAIN_PROMPTS) / max(ttft),
          "decode_tokens_per_s": wave_decode_rate(res),
          "ninth_ttft_s": r9["ttft_s"], "ninth_prefix_hit_tokens": hit,
          "preemptions": s1["preemptions"], "launches": launches,
          "decode_windows": windows, "graph_replays": replays,
          "graph_capture_s": s1["graph_capture_s"], "graphs": graphs,
          "traced_wave": traced,
          "traced_paged_kernels_profiler": traced_paged,
          "traced_paged_kernels_counter": traced_counter,
          "traced_device_busy_share": traced["device_busy_share"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


LORA_PROMPTS = [300, 420, 510, 350, 470, 280, 505, 390]   # bucket 512


def phase_serve_8b_engine(card, cfg, params):
    """The rest of the engine at `llama3-8b` width and depth in bf16: a
    mixed base / adapter batch on a banked engine (lora_slots 2, rank 16)
    against the same requests on a bank-free engine, one request migrated
    from a prefill engine to a decode engine against the same request run
    alone, and a same-shape weight update on the banked engine, which
    holds its own copy of the weights.  The other three share the
    caller's tree (share_params, read-only); each engine captures its
    greedy window at warm-up, so every counted window is a replay."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.tools.profile_serve import wave_decode_rate

    V = cfg.vocab_size
    rng = np.random.default_rng(SEED + 8)
    prompts = [rng.integers(1, V, size=n).tolist() for n in LORA_PROMPTS]
    mig_prompt = rng.integers(1, V, size=700).tolist()
    swap_prompt = rng.integers(1, V, size=400).tolist()
    adapter = llama.init_lora_adapter(
        torch.Generator(device="cuda").manual_seed(SEED + 1), cfg, 16)
    pool = dict(seed=SEED, kv_pages=1 + 8 * 2)
    banked = LLMEngine(cfg, params, lora_slots=2, lora_rank=16,
                       name="banked", **pool)
    shared = dict(pool, share_params=True)
    plain = LLMEngine(cfg, params, name="plain", **shared)
    pre = LLMEngine(cfg, params, name="prefill", **shared)
    dec = LLMEngine(cfg, params, name="decode", **shared)
    engines = (banked, plain, pre, dec)
    K = banked.steps_per_sync
    for e in engines:
        e.start()
    try:
        banked.load_adapter("t/a", adapter)
        warm = rng.integers(1, V, size=100).tolist()
        for e in (banked, plain, dec):
            e.generate(warm, max_new_tokens=K + 1)
        torch.cuda.synchronize()
        zero_flash_counts()
        paged_decode_attention.launches = 0
        s0 = {e.name: e.stats() for e in engines}
        futs = [banked.submit(p, max_new_tokens=32,
                              model_id="t/a" if i % 2 else None)
                for i, p in enumerate(prompts)]
        mixed_res = [f.result(timeout=600) for f in futs]
        futs = [plain.submit(p, max_new_tokens=32) for p in prompts]
        base_res = [f.result(timeout=600) for f in futs]
        mixed = [r["tokens"] for r in mixed_res]
        base = [r["tokens"] for r in base_res]
        alone = plain.generate(mig_prompt, max_new_tokens=32)["tokens"]
        exp = pre.submit(mig_prompt, max_new_tokens=1, prefill_only=True) \
            .result(timeout=600)["kv_export"]
        migrated = dec.kv_import(
            mig_prompt, exp["tokens"], exp["kv"], kv_len=exp["len"],
            max_new_tokens=32, sample_seed=exp["sample_seed"]
        ).result(timeout=600)["tokens"]
        torch.cuda.synchronize()
        launches = {n: c for n, c in flash_counts().items()
                    if n.startswith("flash_attention_fwd")}
        launches["paged_decode_attention"] = paged_decode_attention.launches
        s1 = {e.name: e.stats() for e in engines}
        # A same-shape update of the banked engine's own copy: the values
        # of the shared tree, copied in.  An engine on the shared tree
        # refuses one.
        before = banked.generate(swap_prompt, max_new_tokens=16)["tokens"]
        cached_before = banked._mgr.cached_count()
        replays_before = banked.graph_replays
        version = banked.update_weights(params)
        after = banked.generate(swap_prompt, max_new_tokens=16)["tokens"]
        torch.cuda.synchronize()
        try:
            dec.update_weights(params)
            shared_refused = False
        except ValueError:
            shared_refused = True
        swap = {"version": banked.stats()["weight_version"],
                "staged_version": version,
                "weight_updates": banked.weight_updates,
                "last_weight_sync_ms": banked.last_weight_sync_ms,
                "cached_blocks_before": cached_before,
                "cached_blocks_after": banked._mgr.cached_count(),
                "replays_after_swap": banked.graph_replays - replays_before,
                "captures": len(banked.graph_stats()),
                "same_tokens": after == before,
                "shared_engine_refused": shared_refused}
        graphs = {e.name: e.graph_stats() for e in engines}
    finally:
        for e in engines:
            e.stop()
    gc.collect()
    torch.cuda.empty_cache()
    base_rows = [i for i in range(8) if i % 2 == 0]
    lora_rows = [i for i in range(8) if i % 2]
    replays = sum(s1[n]["graph_replays"] - s0[n]["graph_replays"]
                  for n in s0)
    windows = sum(s1[n]["decode_windows"] - s0[n]["decode_windows"]
                  for n in s0)
    row = {"phase": "serve_8b_engine", "card": card, "model": "llama3-8b",
           "dtype": "bfloat16", "lora_slots": 2, "lora_rank": 16,
           "prompt_tokens": LORA_PROMPTS, "new_tokens_each": 32,
           "base_rows_equal_bank_free":
               all(mixed[i] == base[i] for i in base_rows),
           "adapter_rows_differ":
               all(mixed[i] != base[i] for i in lora_rows),
           "migrated_equals_alone": migrated == alone,
           "decode_tokens_per_s": {
               "banked_mixed": wave_decode_rate(mixed_res),
               "bank_free": wave_decode_rate(base_res)},
           "kv_export_shape": list(exp["kv"].shape),
           "kv_exports": s1["prefill"]["kv_exports"],
           "kv_imports": s1["decode"]["kv_imports"],
           "weight_swap": swap, "launches": launches,
           "decode_windows": windows, "graph_replays": replays,
           "replays_by_engine": {n: s1[n]["graph_replays"]
                                 - s0[n]["graph_replays"] for n in s0},
           "graph_capture_s": {n: s1[n]["graph_capture_s"] for n in s1},
           "graphs": graphs}
    emit(row)
    if not (row["base_rows_equal_bank_free"] and row["adapter_rows_differ"]
            and row["migrated_equals_alone"] and row["kv_exports"] == 1
            and row["kv_imports"] == 1):
        raise AssertionError(f"serve_8b_engine: tokens disagree: {row}")
    if not (swap["version"] == 1 and swap["weight_updates"] == 1
            and swap["cached_blocks_before"] > 0
            and swap["cached_blocks_after"] == 0
            and swap["replays_after_swap"] > 0 and swap["captures"] == 1
            and swap["same_tokens"] and swap["shared_engine_refused"]):
        raise AssertionError(f"serve_8b_engine: weight swap: {swap}")
    if replays == 0 or replays != windows \
            or launches["paged_decode_attention"] \
            != replays * paged_per_replay(cfg, K) \
            or launches["flash_attention_fwd/wgmma"] \
            != launches["flash_attention_fwd"]:
        raise AssertionError(f"serve_8b_engine: windows {windows}, replays "
                             f"{replays}, launches {launches}")
    return launches


def server_wave(srv, reqs, hold=False):
    """`srv(r)` for every request at once (asyncio.gather); (results,
    seconds).  With `hold`, the requests are queued while the server's
    engine loop is stopped and admitted as one wave when it restarts."""
    async def go():
        eng = srv.engine
        if hold:
            eng.stop()
        tasks = [asyncio.ensure_future(srv(r)) for r in reqs]
        if hold:
            deadline = time.monotonic() + 120
            while eng._waiting.qsize() < len(reqs):
                if time.monotonic() > deadline:
                    raise AssertionError("the held wave never queued")
                await asyncio.sleep(0.001)
            eng.start()
        return await asyncio.gather(*tasks)

    t0 = time.perf_counter()
    res = asyncio.run(asyncio.wait_for(go(), 600))
    return res, time.perf_counter() - t0


def engine_wave(eng, prompts, new, hold=False):
    """The bare engine's counterpart of server_wave."""
    if hold:
        eng.stop()
    t0 = time.perf_counter()
    futs = [eng.submit(p, max_new_tokens=new) for p in prompts]
    if hold:
        eng.start()
    res = [f.result(timeout=600) for f in futs]
    return res, time.perf_counter() - t0


class KvDecodeDown:
    """Decode-pool handle whose `kv_decode` raises (a decode replica lost
    mid-migration); its other methods go to `local`."""

    def __init__(self, local, method_name="__call__"):
        self._local, self._method = local, method_name

    def options(self, *, method_name="__call__"):
        return KvDecodeDown(self._local, method_name)

    def remote(self, *args, **kwargs):
        if self._method == "kv_decode":
            raise RuntimeError("decode replica lost")
        return self._local.options(method_name=self._method).remote(
            *args, **kwargs)


def launch_counts() -> dict:
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    out = {n: c for n, c in flash_counts().items()
           if n.startswith("flash_attention_fwd")}
    out["paged_decode_attention"] = paged_decode_attention.launches
    return out


def zero_serve_counts() -> None:
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    zero_flash_counts()
    paged_decode_attention.launches = 0


def wave_row(res, wave_s) -> dict:
    from ray_tpu_torch.tools.profile_serve import wave_decode_rate

    ttft = [r["ttft_s"] for r in res]
    return {"wave_s": wave_s,
            "tokens_per_s": sum(len(r["tokens"]) for r in res) / wave_s,
            "decode_tokens_per_s": wave_decode_rate(res),
            "ttft_s": {"min": min(ttft), "max": max(ttft)}}


def alone_prompts(vocab: int) -> list:
    """Two prompts sent one at a time to the in-process 8B server (4c) and
    to the serve replica (25), sharing no page with any other request."""
    rng = np.random.default_rng(SEED + 25)
    return [rng.integers(1, vocab, size=n).tolist() for n in (333, 777)]


def phase_serve_8b_server(card, cfg, params, device="cuda"):
    """LLMServer on `cfg` in bf16 with `params` (see 4c in the module
    docstring)."""
    from ray_tpu_torch.serve.llm import LLMEngine, LLMServer
    from ray_tpu_torch.serve.runtime import LocalHandle

    V, new = cfg.vocab_size, 64
    rng = np.random.default_rng(SEED + 16)
    prompts = [rng.integers(1, V, size=n).tolist() for n in MAIN_PROMPTS]
    fresh = [rng.integers(1, V, size=n).tolist() for n in MAIN_PROMPTS]
    warm = rng.integers(1, V, size=300).tolist()
    reqs = [{"prompt": p, "max_new_tokens": new} for p in prompts]
    knobs = dict(seed=SEED, max_batch=8, page_size=512)
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()

    def call(srv, req):
        return asyncio.run(asyncio.wait_for(srv(req), 600))

    # (a) unified, against a bare engine on the caller's tree.
    srv = LLMServer(cfg, params=params, device=device, **knobs)
    bare = LLMEngine(cfg, params, share_params=True, device=device,
                     name="bare", **knobs)
    K = srv.engine.steps_per_sync
    bare.start()
    try:
        call(srv, {"prompt": warm, "max_new_tokens": K + 1})
        bare.generate(warm, max_new_tokens=K + 1)
        torch.cuda.synchronize()
        zero_serve_counts()
        s0 = srv.stats()
        held, _ = server_wave(srv, reqs, hold=True)
        # Alone after the wave: the stream and its call both hit the
        # wave's cached prefix of prompts[0].
        one = {"prompt": prompts[0], "max_new_tokens": new}
        streamed = list(srv.stream(one))
        called = call(srv, one)["tokens"]
        torch.cuda.synchronize()
        launches_a = launch_counts()
        s1 = srv.stats()
        bare_held, _ = engine_wave(bare, prompts, new, hold=True)
        zero_serve_counts()
        srv_t, srv_s = server_wave(
            srv, [{"prompt": p, "max_new_tokens": new} for p in fresh])
        torch.cuda.synchronize()
        launches_fresh = launch_counts()
        bare_t, bare_s = engine_wave(bare, fresh, new)
        bare.stop()
        del bare
        # The requests phase cluster_serve_8b sends its replica one at a
        # time, here one at a time to the same server (K 8).
        alone = [call(srv, {"prompt": p, "max_new_tokens": new})["tokens"]
                 for p in alone_prompts(V)]
        # (c) reconfigure: K 4 rebuilds the engine.
        old = srv.engine
        srv.reconfigure({"steps_per_sync": 4})
        rebuilt = (srv.engine is not old and srv.engine.steps_per_sync == 4
                   and not old._thread.is_alive())
        del old
        gc.collect()
        torch.cuda.empty_cache()
        k4 = LLMEngine(cfg, params, share_params=True, device=device,
                       name="k4", steps_per_sync=4, **knobs)
        k4.start()
        try:
            after = call(srv, {"prompt": prompts[1],
                               "max_new_tokens": new})["tokens"]
            want_k4 = k4.generate(prompts[1], max_new_tokens=new)["tokens"]
        finally:
            k4.stop()
        st_c = srv.stats()
    finally:
        srv.shutdown()
    check_c = srv.kv_check()
    del srv, k4
    gc.collect()
    torch.cuda.empty_cache()

    # (b) PD: a prefill-role and a decode-role server, each with its own
    # copy of the weights, linked by an in-process handle.
    dec = LLMServer(cfg, params=params, device=device, role="decode",
                    **knobs)
    local = LocalHandle(dec)
    pre = LLMServer(cfg, params=params, device=device, role="prefill",
                    decode_deployment=local, **knobs)
    try:
        call(pre, {"prompt": warm, "max_new_tokens": K + 1})
        torch.cuda.synchronize()
        zero_serve_counts()
        p0, d0 = pre.stats(), dec.stats()
        pd_res, pd_s = server_wave(pre, reqs, hold=True)
        torch.cuda.synchronize()
        launches_b = launch_counts()
        p1, d1 = pre.stats(), dec.stats()
        pre.reconfigure({"decode_deployment": KvDecodeDown(local)})
        fb = call(pre, {"prompt": prompts[2], "max_new_tokens": 8})
        fb_stats = pre.stats()["pd"]
        checks_b = (pre.kv_check(), dec.kv_check())
    finally:
        pre.shutdown()
        dec.shutdown()
        local.close()
    del pre, dec
    gc.collect()
    torch.cuda.empty_cache()

    a_tokens = [r["tokens"] for r in held]
    migrations = p1["pd"]["migrations"] - p0["pd"]["migrations"]
    pd_bytes = p1["pd"]["kv_migrate_bytes"] - p0["pd"]["kv_migrate_bytes"]
    replays_a = s1["graph_replays"] - s0["graph_replays"]
    windows_a = s1["decode_windows"] - s0["decode_windows"]
    replays_b = d1["graph_replays"] - d0["graph_replays"]
    windows_b = d1["decode_windows"] - d0["decode_windows"]
    row = {"phase": "serve_8b_server", "card": card, "model": "llama3-8b",
           "dtype": "bfloat16", "max_batch": 8, "page_size": 512,
           "steps_per_sync": K, "prompt_tokens": MAIN_PROMPTS,
           "new_tokens_each": new,
           "unified": {
               "same_tokens_as_bare_engine":
                   a_tokens == [r["tokens"] for r in bare_held],
               "stream_equals_call": streamed == called,
               "stream_tokens": len(streamed),
               "server": wave_row(srv_t, srv_s),
               "bare_engine": wave_row(bare_t, bare_s),
               "fresh_wave_launches": launches_fresh,
               "held_wave_server_ttft_s": [r["ttft_s"] for r in held],
               "decode_windows": windows_a, "graph_replays": replays_a,
               "launches": launches_a},
           "reconfigure": {
               "rebuilt": rebuilt, "sync_window": st_c["sync_window"],
               "same_tokens_as_bare_k4": after == want_k4,
               "same_tokens_as_k8_wave": after == a_tokens[1],
               "kv_check_after_shutdown": check_c},
           "pd": {
               "same_tokens_as_unified": [r["tokens"] for r in pd_res]
                   == a_tokens,
               "migrations": migrations, "requests": len(reqs),
               "wave": wave_row(pd_res, pd_s),
               "kv_migrate_bytes": pd_bytes,
               "kv_migrate_bytes_per_request": pd_bytes / max(1, migrations),
               "kv_migrate_put_ms": p1["pd"]["kv_migrate_put_ms"]
                   - p0["pd"]["kv_migrate_put_ms"],
               "kv_pull_ms": d1["pd"]["kv_pull_ms"] - d0["pd"]["kv_pull_ms"],
               "kv_pull_bytes": d1["pd"]["kv_pull_bytes"]
                   - d0["pd"]["kv_pull_bytes"],
               "total_s": [r["total_s"] for r in pd_res],
               "fallback": fb.get("pd_fallback"),
               "fallback_tokens": len(fb["tokens"]),
               "fallbacks": fb_stats["fallbacks"],
               "decode_windows": windows_b, "graph_replays": replays_b,
               "kv_check": list(checks_b),
               "launches": launches_b},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    u, c, pd = row["unified"], row["reconfigure"], row["pd"]
    if not (u["same_tokens_as_bare_engine"] and u["stream_equals_call"]
            and u["stream_tokens"] == new
            and all(len(t) == new for t in a_tokens)):
        raise AssertionError(f"serve_8b_server: unified tokens: {u}")
    if not (c["rebuilt"] and c["sync_window"] == 4
            and c["same_tokens_as_bare_k4"]):
        raise AssertionError(f"serve_8b_server: reconfigure: {c}")
    if not (pd["same_tokens_as_unified"] and migrations == len(reqs)
            and pd["kv_pull_bytes"] == pd_bytes > 0
            and pd["fallback"] == "full_reprefill"
            and pd["fallback_tokens"] == 8 and pd["fallbacks"] == 1):
        raise AssertionError(f"serve_8b_server: PD: {pd}")
    for name, launches, replays, windows in (
            ("unified", launches_a, replays_a, windows_a),
            ("pd", launches_b, replays_b, windows_b)):
        if launches["paged_decode_attention"] == 0 \
                or launches["flash_attention_fwd/wgmma"] == 0 \
                or launches["flash_attention_fwd/wgmma"] \
                != launches["flash_attention_fwd"] \
                or replays == 0 or replays != windows \
                or launches["paged_decode_attention"] != replays * L * K:
            raise AssertionError(
                f"serve_8b_server {name}: windows {windows}, replays "
                f"{replays}, launches {launches}")
    if not all(len(t) == new for t in alone):
        raise AssertionError(f"serve_8b_server: alone {alone}")
    fresh_wave = {**wave_row(srv_t, srv_s),
                  "ttft_each_s": [r["ttft_s"] for r in srv_t],
                  "launches": launches_fresh}
    return ({"unified": launches_a, "pd": launches_b},
            {"alone_tokens": alone, "fresh_wave": fresh_wave})


def phase_serve_8b_dense(card, cfg, params):
    """The dense engine (paged=False) on `llama3-8b` in bf16 at the
    engine's defaults (max_len cfg.max_seq, max_batch 8, K 8), on the
    caller's weights (share_params), against a paged engine on the same
    weights: the eight MAIN_PROMPTS requests as one held wave on each.
    Both prefill the same wave through the flash forward, so each
    request's first token must be the paged engine's; later tokens come
    from einsum attention over the dense cache against the paged kernel
    and may round differently in bf16 (their share of equal tokens is
    reported, not asserted)."""
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.tools.profile_serve import trace_wave, wave_decode_rate

    V, new = cfg.vocab_size, 64
    rng = np.random.default_rng(SEED + 24)
    prompts = [rng.integers(1, V, size=n).tolist() for n in MAIN_PROMPTS]
    warm = rng.integers(1, V, size=300).tolist()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    paged = LLMEngine(cfg, params, share_params=True, seed=SEED,
                      name="paged")
    paged.start()
    try:
        paged.generate(warm, max_new_tokens=paged.steps_per_sync + 1)
        want, _ = engine_wave(paged, prompts, new, hold=True)
    finally:
        paged.stop()
    del paged
    gc.collect()
    torch.cuda.empty_cache()
    eng = LLMEngine(cfg, params, share_params=True, seed=SEED, paged=False,
                    name="dense")
    K = eng.steps_per_sync
    cache_bytes = sum(t.nbytes for kk in ("k", "v") for t in eng.cache[kk])
    eng.start()
    try:
        # Warm-up captures the K-step window; every counted one replays.
        eng.generate(warm, max_new_tokens=K + 1)
        torch.cuda.synchronize()
        zero_serve_counts()
        s0 = eng.stats()
        res, wave_s = engine_wave(eng, prompts, new, hold=True)
        torch.cuda.synchronize()
        launches = launch_counts()
        s1 = eng.stats()
        check = eng.kv_check()
        # The same wave shape on fresh prompts under torch.profiler.
        traced = trace_wave(eng, [rng.integers(1, V, size=n).tolist()
                                  for n in MAIN_PROMPTS])
        graphs = eng.graph_stats()
    finally:
        eng.stop()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    got = [r["tokens"] for r in res]
    ref = [r["tokens"] for r in want]
    decoded = [(a[1:], b[1:]) for a, b in zip(got, ref)]
    equal = sum(x == y for a, b in decoded for x, y in zip(a, b))
    total = sum(len(a) for a, _ in decoded)
    replays = s1["graph_replays"] - s0["graph_replays"]
    windows = s1["decode_windows"] - s0["decode_windows"]
    row = {"phase": "serve_8b_dense", "card": card, "model": "llama3-8b",
           "dtype": "bfloat16", "paged": False, "max_len": cfg.max_seq,
           "max_batch": 8, "steps_per_sync": K,
           "prompt_tokens": MAIN_PROMPTS, "new_tokens_each": new,
           "first_tokens_equal_paged": [a[0] == b[0]
                                        for a, b in zip(got, ref)],
           "decoded_equal_share": equal / total,
           "decoded_equal": equal, "decoded": total,
           "dense": wave_row(res, wave_s),
           "paged_engine_decode_tokens_per_s": wave_decode_rate(want),
           "dense_cache_bytes": cache_bytes,
           "decode_windows": windows, "graph_replays": replays,
           "graph_capture_s": s1["graph_capture_s"], "graphs": graphs,
           "kv_check": check, "launches": launches,
           "traced_wave": traced,
           "traced_device_busy_share": traced["device_busy_share"],
           "peak_mem_gb": peak}
    emit(row)
    if not all(row["first_tokens_equal_paged"]) \
            or any(len(t) != new for t in got) \
            or not all(0 <= t < V for toks in got for t in toks):
        raise AssertionError(f"serve_8b_dense: tokens: {row}")
    if replays == 0 or replays != windows \
            or launches["paged_decode_attention"] \
            or launches["flash_attention_fwd/wgmma"] == 0 \
            or launches["flash_attention_fwd/wgmma"] \
            != launches["flash_attention_fwd"] \
            or check != {"ok": True, "paged": False}:
        raise AssertionError(f"serve_8b_dense: windows {windows}, replays "
                             f"{replays}, launches {launches}, {check}")
    return launches


# --------------------------------- phase 4e: 8B with the recorder on
def shared_server():
    """LLMServer whose engine decodes with the caller's tensors
    (share_params=True): servers built so share one copy of the 8B
    weights."""
    from ray_tpu_torch.serve.llm import LLMEngine, LLMServer

    class Shared(LLMServer):
        def _new_engine(self, kwargs):
            return LLMEngine(self._cfg, self._params, device=self._device,
                             runtime=self._runtime, share_params=True,
                             **kwargs)

    return Shared


def traced_wave(rt, eng, prompts, new):
    """`prompts` submitted together, each under its own span of `rt` (its
    trace); (results, trace contexts)."""
    ctxs, futs = [], []
    for p in prompts:
        with rt.span("smoke.request"):
            ctxs.append(rt.trace_current())
            futs.append(eng.submit(p, max_new_tokens=new))
    return [f.result(timeout=600) for f in futs], ctxs


def phase_serve_8b_observed(card, cfg, params):
    """The serve_8b wave on an engine whose runtime is a `LocalRuntime`
    with its recorder on, then the same wave shape with it off and on in
    turn, then a PD pair with one `serve.kv_export` error armed (see 4e
    in the module docstring)."""
    from ray_tpu_torch.serve.llm import LLMEngine
    from ray_tpu_torch.serve.runtime import LocalHandle, LocalRuntime
    from ray_tpu_torch.tools.profile_serve import wave_decode_rate

    V, new = cfg.vocab_size, 64
    rng = np.random.default_rng(SEED + 31)
    waves = [[rng.integers(1, V, size=n).tolist() for n in MAIN_PROMPTS]
             for _ in range(5)]
    warm = rng.integers(1, V, size=300).tolist()
    rt = LocalRuntime()
    eng = LLMEngine(cfg, params, share_params=True, seed=SEED,
                    name="observed", runtime=rt)
    K = eng.steps_per_sync
    eng.start()
    try:
        eng.generate(warm, max_new_tokens=K + 1)     # captures the window
        torch.cuda.synchronize()
        zero_serve_counts()
        s0 = eng.stats()
        res, ctxs = traced_wave(rt, eng, waves[0], new)
        s1 = eng.stats()
        torch.cuda.synchronize()
        launches = launch_counts()
        traces = [rt.recorder.spans(c[0]) for c in ctxs]
        metrics = rt.recorder.metrics()
        rows = rt.recorder.memory_rows()
        pool_bytes = sum(t.numel() * t.element_size() for t in
                         eng.cache["k"] + eng.cache["v"]
                         + [eng.cache["pos"]])
        rates = {"off": [], "on": []}
        for i, mode in enumerate(("off", "on", "off", "on")):
            rt.set_enabled(mode == "on")
            res_i, _ = traced_wave(rt, eng, waves[1 + i], new)
            rates[mode].append(wave_decode_rate(res_i))
        rt.set_enabled(True)
        spans_total = len(rt.recorder.spans())
    finally:
        eng.stop()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # A PD pair on one copy of the weights, one serve.kv_export error
    # armed: the first request falls back to serving unified, the second
    # migrates.
    Shared = shared_server()
    prt = LocalRuntime()
    knobs = dict(seed=SEED, max_batch=8, page_size=512, runtime=prt)
    dec = Shared(cfg, params=params, role="decode", **knobs)
    local = LocalHandle(dec)
    pre = Shared(cfg, params=params, role="prefill",
                 decode_deployment=local, **knobs)

    def call(req):
        return asyncio.run(asyncio.wait_for(pre(req), 600))

    try:
        prt.arm("serve.kv_export", "nth:1+raise")
        faulted = call({"prompt": waves[0][2], "max_new_tokens": 8})
        migrated = call({"prompt": waves[0][3], "max_new_tokens": 8})
        pd_stats = pre.stats()["pd"]
        checks = (pre.kv_check(), dec.kv_check())
    finally:
        pre.shutdown()
        dec.shutdown()
        local.close()
    del pre, dec
    gc.collect()
    torch.cuda.empty_cache()

    want = ("llm.queue", "llm.prefill", "llm.first_token",
            "llm.decode_window")
    names = [[r["name"] for r in t] for t in traces]
    windows = {(r["t0"], r["t1"]) for t in traces for r in t
               if r["name"] == "llm.decode_window"}
    wave_windows = s1["decode_windows"] - s0["decode_windows"]
    replays = s1["graph_replays"] - s0["graph_replays"]

    def counter(name):
        # A counter never incremented holds no series: it reads 0.
        vals = [v["value"] for v in metrics[name]["values"]
                if v["tags"]["engine"] == "observed"]
        return vals[0] if vals else 0.0

    counters = {k: counter(f"serve_llm_{k}") for k in (
        "prefill_tokens", "decode_tokens", "prefix_hit_tokens")}
    stats = {k: s1[k] for k in counters}
    hbm = [r for r in rows if r["tag"] == "hbm_kv"]
    mean = {k: sum(v) / len(v) for k, v in rates.items()}
    row = {"phase": "serve_8b_observed", "card": card,
           "model": "llama3-8b", "dtype": "bfloat16", "steps_per_sync": K,
           "prompt_tokens": MAIN_PROMPTS, "new_tokens_each": new,
           "traces_with_every_stage": sum(set(want) <= set(n)
                                          for n in names),
           "requests": len(res), "spans_per_trace": [len(n) for n in names],
           "window_spans_distinct": len(windows),
           "decode_windows": wave_windows, "graph_replays": replays,
           "counters": counters, "stats": stats,
           "hbm_kv_row": hbm[0] if hbm else None,
           "cache_bytes": pool_bytes,
           "decode_tokens_per_s": rates, "mean_decode_tokens_per_s": mean,
           "on_over_off": mean["on"] / mean["off"],
           "spans_recorded": spans_total, "launches": launches,
           "pd": {"faulted": faulted.get("pd_fallback"),
                  "faulted_tokens": len(faulted["tokens"]),
                  "migrated": bool(migrated.get("disagg")),
                  "migrated_tokens": len(migrated["tokens"]),
                  "fallbacks": pd_stats["fallbacks"],
                  "migrations": pd_stats["migrations"],
                  "kv_check": list(checks)}}
    emit(row)
    if row["traces_with_every_stage"] != len(res) \
            or any(len(r["tokens"]) != new for r in res):
        raise AssertionError(f"serve_8b_observed: traces {names}")
    if not (len(windows) == wave_windows == replays > 0):
        raise AssertionError(f"serve_8b_observed: {len(windows)} window "
                             f"spans, {wave_windows} windows, {replays} "
                             "replays")
    if counters != stats:
        raise AssertionError(f"serve_8b_observed: counters {counters} != "
                             f"stats {stats}")
    if not hbm or hbm[0]["pool_bytes"] != pool_bytes:
        raise AssertionError(f"serve_8b_observed: hbm_kv {hbm} against "
                             f"{pool_bytes} cache bytes")
    pd = row["pd"]
    if not (pd["faulted"] == "export_failed" and pd["faulted_tokens"] == 8
            and pd["migrated"] and pd["migrated_tokens"] == 8
            and pd["fallbacks"] == 1 and pd["migrations"] == 1):
        raise AssertionError(f"serve_8b_observed: PD {pd}")
    if launches["paged_decode_attention"] != replays * paged_per_replay(
            cfg, K) or launches["flash_attention_fwd/wgmma"] == 0:
        raise AssertionError(f"serve_8b_observed: launches {launches}")
    return launches


# --------------------------------------------- phase 5: small f32 training
def flash_counts() -> dict:
    """Launches of each flash wrapper and, as "<wrapper>/<route>", of each
    dtype route of the forward and dK/dV."""
    from ray_tpu_torch.ops import flash_attention as fa

    out = {}
    for n in FLASH_KERNELS:
        fn = getattr(fa, n)
        out[n] = fn.launches
        for route, c in getattr(fn, "launches_by_route", {}).items():
            out[f"{n}/{route}"] = c
    return out


def zero_flash_counts() -> None:
    from ray_tpu_torch.ops import flash_attention as fa

    for n in FLASH_KERNELS:
        fn = getattr(fa, n)
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
# CUDA against CPU in f32: the loss and the pre-clip grad norm to 1e-4
# relative, the params after three steps to 5e-5 + 1e-4 relative.  Both
# sides sum in other orders (the kernels' FMA loops, cuBLAS against the
# CPU's BLAS), and Adam's first normalised steps magnify the noise of
# gradient elements near zero.
TRAIN_TOL = dict(atol=5e-5, rtol=1e-4)


def phase_train_small():
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, make_train_step,
                                          param_leaves)

    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    base = dataclasses.replace(llama.llama_configs()["debug"],
                               dtype=torch.float32)
    opt = default_optimizer(lr=1e-3, warmup=2, total_steps=10,
                            grad_clip=0.1)
    params = llama.init_params(base, torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    batch = {"tokens": rng.integers(1, base.vocab_size, size=(2, 101))}
    runs, row = {}, {"phase": "train_small_f32", "seq": 100, "batch": 2,
                     "n_layers": base.n_layers, "steps": 3}
    zero_flash_counts()
    for label, remat in (("flash_resid", True), ("nothing", True),
                         ("remat_off", False)):
        cfg = dataclasses.replace(base, remat=remat,
                                  remat_mode="nothing" if label == "nothing"
                                  else "flash_resid")
        for device in ("cuda", "cpu"):
            state = create_train_state(SEED, cfg, opt, device=device,
                                       params=params)
            step = make_train_step(cfg, opt, device=device)
            out = {"loss": [], "grad_norm": [], "launches_per_step": []}
            for _ in range(3):
                n0 = flash_counts()
                state, m = step(state, batch)
                out["loss"].append(m["loss"].item())
                out["grad_norm"].append(m["grad_norm"].item())
                out["launches_per_step"].append(
                    {n: c - n0[n] for n, c in flash_counts().items()})
            out["params"] = tree_to(state.params, "cpu")
            runs[label, device] = out
        gpu, cpu = runs[label, "cuda"], runs[label, "cpu"]
        diff = max(float((a - b).abs().max()) for a, b in zip(
            param_leaves(gpu["params"]), param_leaves(cpu["params"])))
        row[label] = {"loss_cuda": gpu["loss"], "loss_cpu": cpu["loss"],
                      "grad_norm_cuda": gpu["grad_norm"],
                      "grad_norm_cpu": cpu["grad_norm"],
                      "param_max_abs_diff": diff,
                      "launches_per_step": gpu["launches_per_step"][-1]}
        np.testing.assert_allclose(gpu["loss"], cpu["loss"], rtol=1e-4)
        np.testing.assert_allclose(gpu["grad_norm"], cpu["grad_norm"],
                                   rtol=1e-4)
        for a, b in zip(param_leaves(gpu["params"]),
                        param_leaves(cpu["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TRAIN_TOL)
        fwd = 2 * base.n_layers if label == "nothing" else base.n_layers
        want = {"flash_attention_fwd": fwd, "flash_attention_fwd/fma": fwd,
                "flash_attention_fwd/wgmma": 0,
                "flash_attention_bwd_dq": base.n_layers,
                "flash_attention_bwd_dq/fma": base.n_layers,
                "flash_attention_bwd_dq/wgmma": 0,
                "flash_attention_bwd_dkv": base.n_layers,
                "flash_attention_bwd_dkv/fma": base.n_layers,
                "flash_attention_bwd_dkv/wgmma": 0}
        if any(per != want for per in gpu["launches_per_step"]) or any(
                c for per in cpu["launches_per_step"] for c in per.values()):
            raise AssertionError(f"train_small {label}: launches "
                                 f"{gpu['launches_per_step']} != {want}")
    row["tol"] = {"loss_rel": 1e-4, "grad_norm_rel": 1e-4,
                  "params": TRAIN_TOL}
    row["launches"] = launches = flash_counts()
    emit(row)
    return launches


def named_leaves(tree, prefix=""):
    """(path, tensor) in param_leaves' order (sorted key paths)."""
    if isinstance(tree, dict):
        return [nt for k in sorted(tree)
                for nt in named_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


# ----------------------------------------------- phase 6: bench-350m steps
def phase_train_350m(card):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools.profile_serve import kernel_group, kernel_groups
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, make_train_step)

    cfg = llama.llama_configs()["bench-350m"]
    batch_size, seq, n_timed = 8, 2048, 5
    opt = default_optimizer(total_steps=1000)
    t0 = time.perf_counter()
    state = create_train_state(SEED, cfg, opt)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch_size, seq))).to("cuda")
    batch = {"inputs": tokens, "targets": tokens}      # bench.py's batch
    step = make_train_step(cfg, opt)
    before = {n: p.detach().to("cpu", copy=True)
              for n, p in named_leaves(state.params)}
    torch.cuda.reset_peak_memory_stats()

    def moved_share() -> dict:
        """Per leaf, the share of elements that differ from `before`."""
        return {n: float((p.detach().cpu() != before[n]).float().mean())
                for n, p in named_leaves(state.params)}

    t0 = time.perf_counter()
    state, m = step(state, batch)                      # warm-up, lr 0
    loss0 = m["loss"].item()
    warmup_s = time.perf_counter() - t0
    if any(moved_share().values()):
        raise AssertionError("the first update (lr 0) moved the params")
    losses, norms, step_ms = [], [], []
    torch.cuda.synchronize()
    zero_flash_counts()
    for i in range(n_timed):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        if i == 0:                                     # after update 2
            moved2 = moved_share()
    launches = flash_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = moved_share()
    del before

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels, groups = kernel_groups(prof)
    device_ms = sum(ms for ms, _ in groups.values())
    top_other = sorted(((n, ms, c) for n, (ms, c) in kernels.items()
                        if kernel_group(n) == "other"),
                       key=lambda t: -t[1])[:10]
    fma_traced = {n[:100]: c for n, (_, c) in kernels.items()
                  if any(k in n for k in ("flash_fwd_kernel",
                                          "flash_bwd_dq_kernel",
                                          "flash_bwd_dkv_kernel"))}

    mean_ms = sum(step_ms) / len(step_ms)
    tokens_per_s = batch_size * seq / (mean_ms / 1e3)
    flops_per_token = cfg.flops_per_token()
    row = {"phase": "train_350m", "card": card, "model": "bench-350m",
           "dtype": "bfloat16", "params": cfg.num_params(),
           "batch": batch_size, "seq": seq, "remat_mode": cfg.remat_mode,
           "init_params_s": t_init, "warmup_step_s": warmup_s,
           "first_loss": loss0, "ln_vocab": math.log(cfg.vocab_size),
           "loss": losses, "grad_norm": norms, "step_ms": step_ms,
           "mean_step_ms": mean_ms, "tokens_per_s": tokens_per_s,
           "flops_per_token": flops_per_token,
           "mfu": tokens_per_s * flops_per_token / BF16_FLOPS,
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": {n: c / n_timed
                                 for n, c in launches.items()},
           "moved_share_after_update_2": moved2,
           "moved_share_after_update_6": moved,
           "traced_step_ms": traced_ms, "traced_device_ms": device_ms,
           "traced_device_busy_share": device_ms / traced_ms,
           "traced_groups": {g: {"ms": ms, "launches": n}
                             for g, (ms, n) in sorted(groups.items())},
           "traced_fma_flash_launches": fma_traced,
           "traced_top_other": [{"name": n[:100], "ms": ms, "launches": c}
                                for n, ms, c in top_other]}
    emit(row)
    if not all(math.isfinite(x) for x in losses + norms + [loss0]):
        raise AssertionError(f"non-finite loss or grad norm: {row}")
    if abs(loss0 - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {loss0} is far from ln(vocab)")
    if any(c != (0 if n.endswith("/fma") else n_timed * cfg.n_layers)
           for n, c in launches.items()):
        raise AssertionError(f"flash launches {launches} != "
                             f"{cfg.n_layers} per step, all bf16 routes")
    if fma_traced:
        raise AssertionError(f"FMA flash kernels ran in the bf16 step: "
                             f"{fma_traced}")
    traced = {g: groups.get(g, [0.0, 0])[1]
              for g in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    if any(n != cfg.n_layers for n in traced.values()):
        raise AssertionError(f"traced step's flash groups {traced} != "
                             f"{cfg.n_layers} launches each")
    # Every matrix moves from the second update on.  The norm weights sit
    # at 1.0, where a bf16 step is 2^-7: warm-up updates of about lr *
    # count / warmup (1.5e-5 by the sixth) round away there, as they do in
    # the reference's bf16 params.
    still = [n for n, share in moved2.items()
             if share == 0 and not n.endswith("norm")]
    if still:
        raise AssertionError(f"params did not move: {still}")
    return launches


# ------------------------------------- phase 6b: bench-350m, sharded step
# The sharded step against the single-device step from the same state, in
# bf16: on a one-rank mesh every placement is Replicate and the DTensor ops
# run the same local kernels on the same data in the same order, so the
# loss and the pre-clip grad norm must be equal to the bit (PERF.md keeps
# the readings: every step of every run so far was).  Any difference means
# the sharded path computes something else.


def phase_train_350m_sharded(card):
    """`bench-350m` through `sharded_train_step` on a one-rank NCCL group
    (a file:// store in a temporary directory) and `create_mesh(
    MeshConfig(data=1))` on CUDA: the state, batch and optimizer of
    train_350m laid out with `reshard_state`, then a warm-up step and
    four timed steps, each beside the single-device step from the same
    state.  The group is destroyed whatever happens; if NCCL or the mesh
    cannot be set up, the phase fails."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.tools.profile_serve import kernel_groups
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, make_train_step,
                                          reshard_state, sharded_train_step)

    cfg = llama.llama_configs()["bench-350m"]
    batch_size, seq, n_timed = 8, 2048, 4
    opt = default_optimizer(total_steps=1000)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch_size, seq))).to("cuda")
    batch = {"inputs": tokens, "targets": tokens}      # train_350m's batch
    store = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    torch.cuda.set_device(0)
    try:
        dist.init_process_group(
            "nccl", init_method=f"file://{store}/store", world_size=1,
            rank=0, timeout=datetime.timedelta(seconds=300))
        mesh = create_mesh(MeshConfig(data=1))
        single = create_train_state(SEED, cfg, opt)
        t0 = time.perf_counter()
        sharded = reshard_state(single, cfg, opt, mesh)
        torch.cuda.synchronize()
        reshard_s = time.perf_counter() - t0
        steps = {"single": make_train_step(cfg, opt),
                 "sharded": sharded_train_step(cfg, opt, mesh)}
        states = {"single": single, "sharded": sharded}
        out = {k: {"loss": [], "grad_norm": [], "step_ms": [],
                   "launches": []} for k in steps}
        for i in range(1 + n_timed):          # step 0: warm-up, lr 0
            for name in ("single", "sharded"):
                torch.cuda.synchronize()
                zero_flash_counts()
                t0 = time.perf_counter()
                states[name], m = steps[name](states[name], batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                rec = out[name]
                rec["loss"].append(float(m["loss"]))
                rec["grad_norm"].append(float(m["grad_norm"]))
                rec["launches"].append(flash_counts())
                if i:
                    rec["step_ms"].append(ms)
        placements = {str(p.placements) for p in
                      (states["sharded"].params["embed"],
                       states["sharded"].params["layers"]["wq"])}
        mesh_desc = str(mesh)
        # One more sharded step under torch.profiler: its device time
        # against its wall time.
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            steps["sharded"](states["sharded"], batch)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        _, groups = kernel_groups(prof)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    del states, steps, single, sharded
    gc.collect()
    torch.cuda.empty_cache()

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    flops = cfg.flops_per_token()
    row = {"phase": "train_350m_sharded", "card": card,
           "model": "bench-350m", "dtype": "bfloat16", "mesh": mesh_desc,
           "placements": sorted(placements), "batch": batch_size,
           "seq": seq, "remat_mode": cfg.remat_mode,
           "reshard_state_s": reshard_s, "tol": "bitwise",
           "traced_sharded_step_ms": traced_ms,
           "traced_device_ms": sum(ms for ms, _ in groups.values()),
           "traced_device_busy_share":
               sum(ms for ms, _ in groups.values()) / traced_ms,
           "traced_groups": {g: {"ms": ms, "launches": n}
                             for g, (ms, n) in sorted(groups.items())}}
    for name, rec in out.items():
        mean_ms = sum(rec["step_ms"]) / len(rec["step_ms"])
        tps = batch_size * seq / (mean_ms / 1e3)
        row[name] = {"loss": rec["loss"], "grad_norm": rec["grad_norm"],
                     "step_ms": rec["step_ms"], "mean_step_ms": mean_ms,
                     "tokens_per_s": tps, "mfu": tps * flops / BF16_FLOPS,
                     "launches_per_step": rec["launches"][-1]}
    row["max_loss_rel_diff"] = rel(out["sharded"]["loss"],
                                   out["single"]["loss"])
    row["max_grad_norm_rel_diff"] = rel(out["sharded"]["grad_norm"],
                                        out["single"]["grad_norm"])
    row["max_loss_abs_diff"] = max(abs(x - y) for x, y in zip(
        out["sharded"]["loss"], out["single"]["loss"]))
    emit(row)
    if not all(math.isfinite(x) for rec in out.values()
               for x in rec["loss"] + rec["grad_norm"]):
        raise AssertionError(f"train_350m_sharded: non-finite: {row}")
    if out["sharded"]["loss"] != out["single"]["loss"] \
            or out["sharded"]["grad_norm"] != out["single"]["grad_norm"]:
        raise AssertionError(f"train_350m_sharded: the sharded step left "
                             f"the single-device step: {row}")
    want = {n: (0 if n.endswith("/fma") else cfg.n_layers)
            for n in out["single"]["launches"][-1]}
    for name, rec in out.items():
        if any(per != want for per in rec["launches"]):
            raise AssertionError(f"train_350m_sharded {name}: launches "
                                 f"{rec['launches']} != {want}")
    return {"launches": {n: sum(per[n] for per in out["sharded"]["launches"])
                         for n in want},
            "mean_step_ms": row["sharded"]["mean_step_ms"],
            "loss": out["sharded"]["loss"]}


# ------------------------------------------------------ phase 7: online RLHF
def rlhf_counts() -> dict:
    """The flash counts and the paged kernel's launches."""
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    return {**flash_counts(),
            "paged_decode_attention": paged_decode_attention.launches}


def recording_worker():
    """LLMRolloutWorker that keeps each trajectory it returns (the
    trainer's worker_cls extension point)."""
    from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker

    class Recording(LLMRolloutWorker):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.trajs = []

        def rollout(self, *a, **kw):
            traj = super().rollout(*a, **kw)
            self.trajs.append(traj)
            return traj

        def traj_tokens(self, i: int):
            """The tokens of the i-th trajectory batch this worker
            returned."""
            return self.trajs[i]["tokens"]

    return Recording


def engine_graphs(tr) -> dict:
    return graph_accounting(tr.workers[0].engine.stats())


def phase_rlhf_small():
    """The in-process GRPO loop at `debug` in f32 on CUDA and on the CPU
    from the same params: three steps each (see 7 in the module
    docstring)."""
    import shutil
    import tempfile

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rl.rlhf import GRPOLearner, RLHFConfig, RLHFTrainer
    from ray_tpu_torch.train.step import param_leaves

    torch.backends.cuda.matmul.allow_tf32 = False    # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(llama.llama_configs()["debug"],
                              dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(SEED))
    base = dict(model=cfg, seed=SEED, n_prompts=4, prompt_len=10,
                group_size=4, prompts_per_step=2, max_new_tokens=5,
                temperature=1.0, lr=1e-2, worker_cls=recording_worker(),
                engine=dict(max_batch=8, max_len=128, page_size=16,
                            steps_per_sync=3))
    runs, n_steps = {}, 3
    for device in ("cuda", "cpu"):
        tr = RLHFTrainer(RLHFConfig(**base, params=tree_to(params, device),
                                    device=device))
        try:
            rec = {"metrics": [], "graphs": [], "versions": []}
            if device == "cuda":
                torch.cuda.synchronize()
                zero_serve_counts()
            for i in range(n_steps):
                m = tr.step()
                if i == 0:
                    # The first update's gradients: both learners start
                    # from the same params and trajectories.
                    rec["grads"] = [p.grad.detach().to("cpu", copy=True)
                                    for p in param_leaves(tr.learner.params)]
                rec["metrics"].append(m)
                rec["graphs"].append(engine_graphs(tr))
                rec["versions"].append(
                    (tr.stats()["workers"][0]["weight_version"],
                     tr.learner.version))
            rec["trajs"] = tr.workers[0].trajs
            rec["params"] = tr.learner.get_params_numpy()
            if device == "cuda":
                torch.cuda.synchronize()
                rec["launches"] = rlhf_counts()
                rec["ckpt"] = checkpoint_roundtrip(tr, GRPOLearner,
                                                   tempfile, shutil)
        finally:
            tr.shutdown()
        runs[device] = rec
    gpu, cpu = runs["cuda"], runs["cpu"]
    same_tokens = [bool(np.array_equal(a["tokens"], b["tokens"])
                        and np.array_equal(a["mask"], b["mask"]))
                   for a, b in zip(gpu["trajs"], cpu["trajs"])]
    # The backward kernels are held where their output is: the first
    # update's gradients, leaf by leaf, against the CPU's (max error over
    # the leaf's max).  The params after three Adam steps at lr 1e-2 are
    # reported but not bounded: Adam moves an element by lr * m / (sqrt(v)
    # + eps), so where a gradient sums to near eps, f32 rounding on either
    # device picks the sign of a step of up to lr.
    grad_rel = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                for a, b in zip(gpu["grads"], cpu["grads"])]
    flat = {k: torch.cat([t.detach().reshape(-1).cpu()
                          for t in param_leaves(tree)])
            for k, tree in (("cuda", gpu["params"]), ("cpu", cpu["params"]))}
    diffs = {"advantages": max(float(np.abs(a["advantages"]
                                            - b["advantages"]).max())
                               for a, b in zip(gpu["metrics"],
                                               cpu["metrics"])),
             "first_update_grads_rel": max(grad_rel),
             "params_after_3_updates": float((flat["cuda"]
                                              - flat["cpu"]).abs().max())}
    for k in ("loss", "policy_loss", "kl", "ratio_mean"):
        diffs[k] = max(abs(a[k] - b[k]) for a, b in
                       zip(gpu["metrics"], cpu["metrics"]))
    launches = gpu["launches"]
    g = gpu["graphs"]
    row = {"phase": "rlhf_small_f32", "model": "debug", "dtype": "float32",
           "steps": n_steps, "same_tokens_and_masks": same_tokens,
           "max_abs_diff": diffs, "tol": 1e-4,
           "loss_cuda": [m["loss"] for m in gpu["metrics"]],
           "loss_cpu": [m["loss"] for m in cpu["metrics"]],
           "reward_mean": [m["reward_mean"] for m in gpu["metrics"]],
           "versions_engine_learner": gpu["versions"], "graphs": g,
           "launches": launches, "checkpoint": gpu["ckpt"]}
    emit(row)
    if not all(same_tokens):
        raise AssertionError("rlhf_small: trajectories differ between "
                             "CUDA and the CPU")
    for a, b in zip(gpu["metrics"], cpu["metrics"]):
        np.testing.assert_allclose(a["advantages"], b["advantages"],
                                   atol=1e-4, rtol=0)
        for k in ("loss", "policy_loss", "kl", "ratio_mean"):
            if abs(a[k] - b[k]) > 1e-4 * max(1.0, abs(b[k])):
                raise AssertionError(f"rlhf_small: {k} {a[k]} != {b[k]}")
    if not all(g <= 1e-4 for g in grad_rel):
        raise AssertionError(f"rlhf_small: first-update gradients differ "
                             f"from the CPU's: {grad_rel}")
    if any(e != lv for e, lv in gpu["versions"] + cpu["versions"]):
        raise AssertionError(f"rlhf_small: engine and learner versions "
                             f"{gpu['versions']} {cpu['versions']}")
    per_update = cfg.n_layers * n_steps
    if (launches["paged_decode_attention"] == 0
            or launches["flash_attention_fwd/fma"] < 3 * cfg.n_layers
            * n_steps
            or launches["flash_attention_fwd/wgmma"]
            or launches["flash_attention_bwd_dq/fma"] != per_update
            or launches["flash_attention_bwd_dkv/fma"] != per_update
            or launches["flash_attention_bwd_dq/wgmma"]
            or launches["flash_attention_bwd_dkv/wgmma"]):
        raise AssertionError(f"rlhf_small: launches {launches}")
    for prev, cur in zip(g, g[1:]):
        new = cur["decode_windows"] - prev["decode_windows"]
        if new == 0 or cur["graph_replays"] - prev["graph_replays"] != new:
            raise AssertionError(f"rlhf_small: a window after a weight "
                                 f"swap was not a replay: {g}")
    if g[-1]["decode_windows"] != g[-1]["graph_replays"] \
            + g[-1]["graph_captures"] or g[-1]["graph_captures"] != 1:
        raise AssertionError(f"rlhf_small: windows {g[-1]}")
    if not gpu["ckpt"]["bitwise"]:
        raise AssertionError(f"rlhf_small: checkpoint {gpu['ckpt']}")
    return launches


def checkpoint_roundtrip(tr, learner_cls, tempfile, shutil) -> dict:
    """save_async, then an update (in place) before the write is waited
    for; a fresh learner loaded from the file must hold the saved state
    to the bit."""
    from ray_tpu_torch.train.step import param_leaves

    learner = tr.learner

    def leaves(st):
        o = st["opt_state"]
        return (param_leaves(st["params"]) + param_leaves(o["mu"])
                + param_leaves(o["nu"]) + [o["count"]])

    saved = [t.detach().clone() for t in leaves(learner.state_tree())]
    version = learner.version
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        learner.save_async(os.path.join(d, "v"))
        learner.update(tr.workers[0].trajs[-1])
        learner.ckpt_wait()
        fresh = learner_cls(tr.cfg)
        fresh.load(os.path.join(d, "v"))
        got = leaves(fresh.state_tree())
        moved = any(not torch.equal(a, b) for a, b in
                    zip(saved, leaves(learner.state_tree())))
        bitwise = fresh.version == version and all(
            a.dtype == b.dtype and torch.equal(a.to(b.device), b)
            for a, b in zip(got, saved))
        del fresh
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return {"bitwise": bitwise, "update_moved_state": moved,
            "version": version}


RLHF_350M = dict(n_prompts=8, prompt_len=384, group_size=8,
                 prompts_per_step=2, max_new_tokens=64, temperature=1.0,
                 lr=1e-6, engine=dict(max_batch=16, max_len=512,
                                      page_size=64, steps_per_sync=4))


def rlhf_350m_trainer(cfg):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rl.rlhf import RLHFConfig, RLHFTrainer

    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    return RLHFTrainer(RLHFConfig(model=cfg, params=params, seed=SEED,
                                  worker_cls=recording_worker(),
                                  **RLHF_350M))


def step_row(m: dict, traj: dict, step_s: float) -> dict:
    r = m["rollout"]
    B, T = traj["tokens"].shape
    # The learner's positions that hold a real next token: each row's
    # total_len - 1, not the pow2 width's padding.
    positions = int(traj["total_len"].sum()) - B
    return {"step_s": step_s, "rollout_s": r["gen_s"],
            "decode_tokens_per_s": r["rollout_tokens"] / r["gen_s"],
            "completion_tokens": r["rollout_tokens"],
            "scoring_s": r["score_s"], "update_s": m["update_s"],
            "learner_positions": positions,
            "learner_tokens_per_s": positions / m["update_s"],
            "weight_sync_ms": m["step_weight_sync_ms"],
            "reward_mean": m["reward_mean"], "loss": m["loss"],
            "kl": m["kl"], "ratio_mean": m["ratio_mean"],
            "prefix_hit_tokens": r["prefix_hit_tokens"],
            "prefill_tokens": r["prefill_tokens"],
            "batch": [B, T]}


def phase_rlhf_350m(card):
    """The GRPO loop at `bench-350m`, full width and depth, bf16 (see 7b
    in the module docstring)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.tools.profile_serve import kernel_groups

    cfg = llama.llama_configs()["bench-350m"]
    n_timed = 4
    t0 = time.perf_counter()
    tr = rlhf_350m_trainer(cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    steps, versions = [], []
    try:
        t0 = time.perf_counter()
        m = tr.step()                                  # warm-up
        torch.cuda.synchronize()
        warm = step_row(m, tr.workers[0].trajs[-1],
                        time.perf_counter() - t0)
        versions.append((tr.stats()["workers"][0]["weight_version"],
                         tr.learner.version))
        v0_tokens = tr.workers[0].trajs[0]["tokens"].copy()
        torch.cuda.reset_peak_memory_stats()
        g0 = engine_graphs(tr)
        zero_serve_counts()
        for _ in range(n_timed):
            t0 = time.perf_counter()
            m = tr.step()
            torch.cuda.synchronize()
            steps.append(step_row(m, tr.workers[0].trajs[-1],
                                  time.perf_counter() - t0))
            versions.append((tr.stats()["workers"][0]["weight_version"],
                             tr.learner.version))
        torch.cuda.synchronize()
        launches = rlhf_counts()
        g1 = engine_graphs(tr)
        graph_st = tr.workers[0].engine.graph_stats()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            m = tr.step()
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        traced = step_row(m, tr.workers[0].trajs[-1], traced_s)
        versions.append((tr.stats()["workers"][0]["weight_version"],
                         tr.learner.version))
        kernels, groups = kernel_groups(prof)
        del prof
        hash1 = tr.learner.param_hash()
        n_steps = tr.learner.version
    finally:
        tr.shutdown()
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    # A second trainer from the same seed: version-0 tokens and, after as
    # many steps, the param hash.
    tr = rlhf_350m_trainer(cfg)
    try:
        for _ in range(n_steps):
            tr.step()
        v0_again = tr.workers[0].trajs[0]["tokens"]
        hash2 = tr.learner.param_hash()
    finally:
        tr.shutdown()
        del tr
        gc.collect()
        torch.cuda.empty_cache()

    windows = g1["decode_windows"] - g0["decode_windows"]
    replays = g1["graph_replays"] - g0["graph_replays"]
    device_ms = sum(ms for ms, _ in groups.values())
    top = sorted(((n, ms, c) for n, (ms, c) in kernels.items()),
                 key=lambda t: -t[1])[:12]

    def mean(key):
        return sum(s[key] for s in steps) / len(steps)

    row = {"phase": "rlhf_350m", "card": card, "model": "bench-350m",
           "dtype": "bfloat16", "params": cfg.num_params(),
           "config": {k: v for k, v in RLHF_350M.items()},
           "build_s": build_s, "warmup_step": warm, "steps": steps,
           "mean": {k: mean(k) for k in (
               "step_s", "rollout_s", "decode_tokens_per_s", "scoring_s",
               "update_s", "learner_tokens_per_s", "weight_sync_ms",
               "reward_mean")},
           "prefix_hit_share": sum(s["prefix_hit_tokens"] for s in steps)
           / sum(s["prefix_hit_tokens"] + s["prefill_tokens"]
                 for s in steps),
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": {k: v / n_timed for k, v in
                                 launches.items()},
           "timed_windows": windows, "timed_replays": replays,
           "graphs": g1, "graph_stats": graph_st,
           "versions_engine_learner": versions,
           "traced_step": traced, "traced_device_ms": device_ms,
           "traced_device_busy_share": device_ms / (traced_s * 1e3),
           # The profiler slows the host: the traced step's device time
           # over the mean untraced step.
           "traced_device_ms_over_mean_step": device_ms
           / (mean("step_s") * 1e3),
           "traced_groups": {k: {"ms": ms, "launches": n}
                             for k, (ms, n) in sorted(groups.items())},
           "traced_top": [{"name": n[:100], "ms": ms, "launches": c}
                          for n, ms, c in top],
           "v0_tokens_equal_second_run": bool(np.array_equal(v0_tokens,
                                                             v0_again)),
           "param_hash_equal_second_run": hash1 == hash2,
           "param_hashes": [hash1, hash2], "steps_hashed": n_steps}
    emit(row)
    if not all(math.isfinite(s[k]) for s in steps + [warm, traced]
               for k in ("loss", "kl", "ratio_mean", "reward_mean")):
        raise AssertionError(f"rlhf_350m: non-finite metrics: {steps}")
    if any(e != lv for e, lv in versions):
        raise AssertionError(f"rlhf_350m: versions {versions}")
    if windows == 0 or replays != windows:
        raise AssertionError(f"rlhf_350m: {windows} windows, {replays} "
                             "replays: a window after a swap was not a "
                             "replay")
    want_bwd = cfg.n_layers * n_timed
    if (launches["paged_decode_attention"] == 0
            or launches["paged_decode_attention"] != replays
            * paged_per_replay(cfg, RLHF_350M["engine"]["steps_per_sync"])
            or launches["flash_attention_fwd/wgmma"] == 0
            or launches["flash_attention_fwd/fma"]
            or any(launches[f"flash_attention_bwd_{k}/wgmma"] != want_bwd
                   or launches[f"flash_attention_bwd_{k}/fma"]
                   for k in ("dq", "dkv"))):
        raise AssertionError(f"rlhf_350m: launches {launches}")
    if not row["v0_tokens_equal_second_run"]:
        raise AssertionError("rlhf_350m: a second trainer from the same "
                             "seed sampled other version-0 tokens")
    return launches, row["mean"]


# ------------------------------------ phases 7e-7f: the mesh GRPO learner
MESH_TOL = 1e-4


@contextlib.contextmanager
def one_rank_mesh():
    """A one-rank NCCL group on a file:// store in a temporary directory
    (a group timeout; the group left and the store removed at the end)
    and `create_mesh(MeshConfig(data=1))` over it: the card's mesh."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    store = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    torch.cuda.set_device(0)
    try:
        dist.init_process_group(
            "nccl", init_method=f"file://{store}/store", world_size=1,
            rank=0, timeout=datetime.timedelta(seconds=300))
        yield create_mesh(MeshConfig(data=1))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def grpo_batch(cfg, params, rows, prompt_len, new, width, group, seed):
    """A trajectory batch of `rows` completions of `new` tokens on
    `prompt_len`-token prompts, padded to `width` (the rollout worker's
    pow2 padding), in groups of `group`, from a numpy seed: the behavior
    logprobs are `params`' scores plus noise (so ratios clip), the
    rewards normal."""
    from ray_tpu_torch.models import llama

    rng = np.random.default_rng(seed)
    total = prompt_len + new
    toks = np.zeros((rows, width), np.int32)
    toks[:, :total] = rng.integers(1, cfg.vocab_size, (rows, total))
    with torch.no_grad():
        lp = llama.token_logprobs(
            params, torch.from_numpy(toks).to(params["embed"].device),
            cfg).float().cpu().numpy()
    mask = np.zeros((rows, width - 1), np.float32)
    mask[:, prompt_len - 1:total - 1] = 1.0
    return {"tokens": toks,
            "logprobs": (lp + rng.normal(0, 0.2, lp.shape)).astype(
                np.float32),
            "mask": mask, "rewards": rng.normal(size=rows).astype(
                np.float32),
            "group_size": group, "rollout_tokens": rows * new,
            "weight_version": 0}


def leaf_diffs(a_tree, b_tree) -> tuple[float, float]:
    """(max |a - b|, max over leaves of |a - b| / max |b|) of two param
    trees, DTensors gathered."""
    from ray_tpu_torch.train.step import param_leaves
    from torch.distributed.tensor import DTensor

    def full(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        return t.detach().float()

    worst = rel = 0.0
    for a, b in zip(param_leaves(a_tree), param_leaves(b_tree)):
        a, b = full(a), full(b)
        d = (a - b.to(a.device)).abs().max().item()
        worst = max(worst, d)
        rel = max(rel, d / max(b.abs().max().item(), 1e-30))
    return worst, rel


def phase_rlhf_mesh_small():
    """The mesh GRPO learner at `debug` in f32 (TF32 off) on a one-rank
    NCCL mesh on CUDA, against the single-device learner on the CPU and
    on CUDA from the same params (see 7e in the module docstring)."""
    import shutil
    import tempfile

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rl.rlhf import GRPOLearner, RLHFConfig
    from ray_tpu_torch.train.step import param_leaves
    from torch.distributed.tensor import DTensor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(llama.llama_configs()["debug"],
                              dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(SEED))
    batch = grpo_batch(cfg, params, rows=8, prompt_len=10, new=14,
                       width=32, group=4, seed=SEED + 41)
    rc = RLHFConfig(model=cfg, seed=SEED, lr=1e-2, kl_coeff=0.1,
                    group_size=4)
    n = 3
    cpu = GRPOLearner(rc, params=params, device="cpu")
    d = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
    try:
        with one_rank_mesh() as mesh:
            ml = GRPOLearner(rc, params=tree_to(params, "cuda"), mesh=mesh,
                             device="cuda")
            single = GRPOLearner(rc, params=tree_to(params, "cuda"),
                                 device="cuda")
            placements = sorted({str(p.placements)
                                 for p in param_leaves(ml.params)})
            torch.cuda.synchronize()
            zero_flash_counts()
            runs = {"mesh": [], "cpu": [], "cuda": []}
            grads = {}
            for name, lr in (("mesh", ml), ("cpu", cpu), ("cuda", single)):
                for i in range(n):
                    runs[name].append(lr.update(batch))
                    if i == 0:
                        grads[name] = [
                            (p.grad.full_tensor() if isinstance(
                                p.grad, DTensor) else p.grad).detach()
                            .to("cpu", copy=True)
                            for p in param_leaves(lr.params)]
                if name == "mesh":
                    torch.cuda.synchronize()
                    launches = flash_counts()
            vs_cpu = leaf_diffs(ml.params, cpu.params)
            vs_cuda = leaf_diffs(ml.params, single.params)
            # Checkpoints across layouts: the mesh learner's into a
            # single-device learner, and the reverse.
            ml.save_async(os.path.join(d, "mesh"))
            ml.ckpt_wait()
            into_single = GRPOLearner(rc, params=tree_to(params, "cuda"),
                                      device="cuda")
            into_single.load(os.path.join(d, "mesh"))
            single.save_async(os.path.join(d, "single"))
            single.ckpt_wait()
            into_mesh = GRPOLearner(rc, params=tree_to(params, "cuda"),
                                    mesh=mesh, device="cuda")
            into_mesh.load(os.path.join(d, "single"))
            ckpt = {"mesh_to_single_bitwise":
                        into_single.param_hash() == ml.param_hash(),
                    "single_to_mesh_bitwise":
                        into_mesh.param_hash() == single.param_hash(),
                    "versions": [into_single.version, into_mesh.version]}
            nxt = [lr.update(batch)["loss"] for lr in (ml, into_single)]
            ckpt["next_loss_diff"] = abs(nxt[0] - nxt[1])
            mesh_desc = str(mesh)
            del ml, single, into_single, into_mesh
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    # Per update: the first runs at equal params, the later ones at
    # params that Adam's first steps moved apart on the two devices (the
    # eps amplification noted at rlhf_small), so the bound is the first
    # update's; the later ones are reported, and held against the CUDA
    # single-device learner instead.
    keys = ("loss", "policy_loss", "kl", "ratio_mean")
    diffs = [{k: abs(a[k] - b[k]) for k in keys}
             | {"advantages": float(np.abs(a["advantages"]
                                           - b["advantages"]).max())}
             for a, b in zip(runs["mesh"], runs["cpu"])]
    grad_rel = max(float((a - b).abs().max()
                         / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(grads["mesh"], grads["cpu"]))
    same_as_cuda = all(a["loss"] == b["loss"] for a, b in
                       zip(runs["mesh"], runs["cuda"]))
    row = {"phase": "rlhf_mesh_small_f32", "model": "debug",
           "dtype": "float32", "mesh": mesh_desc, "placements": placements,
           "tf32": torch.backends.cuda.matmul.allow_tf32, "updates": n,
           "tol": MESH_TOL, "max_abs_diff_vs_cpu_per_update": diffs,
           "metrics_mesh": [{k: m[k] for k in keys} for m in runs["mesh"]],
           "first_update_grads_rel_vs_cpu": grad_rel,
           "params_vs_cpu_after_3": {"max_abs": vs_cpu[0],
                                     "max_rel": vs_cpu[1]},
           "params_vs_cuda_single_after_3": {"max_abs": vs_cuda[0],
                                             "max_rel": vs_cuda[1]},
           "losses_equal_cuda_single": same_as_cuda,
           "loss_mesh": [m["loss"] for m in runs["mesh"]],
           "loss_cpu": [m["loss"] for m in runs["cpu"]],
           "checkpoint": ckpt, "launches": launches}
    emit(row)
    bad = [k for k, v in diffs[0].items() if v > MESH_TOL]
    if bad or grad_rel > MESH_TOL \
            or any(d["advantages"] > MESH_TOL for d in diffs):
        raise AssertionError(f"rlhf_mesh_small: {bad}, the advantages or "
                             f"the first gradients ({grad_rel}) left the "
                             "CPU's")
    if vs_cuda[0] > MESH_TOL or not same_as_cuda:
        raise AssertionError(f"rlhf_mesh_small: params {vs_cuda} or losses "
                             "away from the single-device learner on CUDA")
    if not (ckpt["mesh_to_single_bitwise"] and ckpt["single_to_mesh_bitwise"]
            and ckpt["next_loss_diff"] <= MESH_TOL):
        raise AssertionError(f"rlhf_mesh_small: checkpoints {ckpt}")
    per = cfg.n_layers * n
    if (launches["flash_attention_fwd/fma"] < per
            or launches["flash_attention_bwd_dq/fma"] != per
            or launches["flash_attention_bwd_dkv/fma"] != per
            or any(launches[f"{k}/wgmma"] for k in FLASH_KERNELS)):
        raise AssertionError(f"rlhf_mesh_small: launches {launches}")
    return launches


def phase_rlhf_mesh_learner_350m(card):
    """The mesh GRPO learner at `bench-350m` width and depth in bf16 on a
    one-rank NCCL mesh against the single-device learner from the same
    params, on a trajectory batch of rlhf_350m's shape (see 7f in the
    module docstring)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rl.rlhf import GRPOLearner, RLHFConfig

    cfg = llama.llama_configs()["bench-350m"]
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    shape = dict(rows=16, prompt_len=RLHF_350M["prompt_len"],
                 new=RLHF_350M["max_new_tokens"], width=512,
                 group=RLHF_350M["group_size"])
    batch = grpo_batch(cfg, params, seed=SEED + 43, **shape)
    rc = RLHFConfig(model=cfg, seed=SEED, lr=RLHF_350M["lr"],
                    group_size=RLHF_350M["group_size"])
    n_timed = 3
    with one_rank_mesh() as mesh:
        learners = {"single": GRPOLearner(rc, params=params),
                    "mesh": GRPOLearner(rc, params=params, mesh=mesh)}
        del params
        out = {k: {"loss": [], "update_ms": [], "launches": []}
               for k in learners}
        for i in range(1 + n_timed):          # update 0: the comparison
            for name, lr in learners.items():
                torch.cuda.synchronize()
                zero_flash_counts()
                t0 = time.perf_counter()
                m = lr.update(batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                out[name]["loss"].append(m["loss"])
                out[name]["launches"].append(flash_counts())
                if i:
                    out[name]["update_ms"].append(ms)
            if i == 0:
                first = leaf_diffs(learners["mesh"].params,
                                   learners["single"].params)
        gather_ms = {}
        for name, lr in learners.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = lr.get_params_numpy()
            gather_ms[name] = (time.perf_counter() - t0) * 1e3
            del host
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del learners
    gc.collect()
    torch.cuda.empty_cache()
    mean = {k: sum(v["update_ms"]) / n_timed for k, v in out.items()}
    launches = {n: sum(per[n] for per in out["mesh"]["launches"])
                for n in out["mesh"]["launches"][-1]}
    row = {"phase": "rlhf_mesh_learner_350m", "card": card,
           "model": "bench-350m", "dtype": "bfloat16",
           "batch": {**shape, "positions": 16 * (shape["prompt_len"]
                                                 + shape["new"] - 1)},
           "lr": rc.lr, "first_update_loss": {
               k: v["loss"][0] for k, v in out.items()},
           "first_update_loss_diff": abs(out["mesh"]["loss"][0]
                                         - out["single"]["loss"][0]),
           "params_after_first_update": {"max_abs_diff": first[0],
                                         "max_rel_diff": first[1]},
           "update_ms": {k: v["update_ms"] for k, v in out.items()},
           "mean_update_ms": mean,
           "mesh_over_single": mean["mesh"] / mean["single"],
           "get_params_numpy_ms": gather_ms,
           "launches_per_update": {k: v["launches"][-1]
                                   for k, v in out.items()},
           "peak_mem_gb": peak_gb, "tol_bf16": TOL[torch.bfloat16]}
    emit(row)
    if not all(math.isfinite(x) for v in out.values() for x in v["loss"]):
        raise AssertionError(f"rlhf_mesh_learner_350m: non-finite: {row}")
    if row["first_update_loss_diff"] > TOL[torch.bfloat16] * max(
            1.0, abs(out["single"]["loss"][0])) \
            or first[1] > TOL[torch.bfloat16]:
        raise AssertionError(f"rlhf_mesh_learner_350m: the mesh learner "
                             f"left the single-device one: {row}")
    for name, rec in out.items():
        for per in rec["launches"]:
            if (per["flash_attention_fwd/wgmma"] < cfg.n_layers
                    or per["flash_attention_bwd_dq/wgmma"] != cfg.n_layers
                    or per["flash_attention_bwd_dkv/wgmma"] != cfg.n_layers
                    or any(per[f"{k}/fma"] for k in FLASH_KERNELS)):
                raise AssertionError(f"rlhf_mesh_learner_350m {name}: "
                                     f"launches {per}")
    return launches


# ------------------------------- phases 7c-7d: the RLHF actor topology
def params_worker():
    """LLMRolloutWorker that hands out a copy of its engine's weights."""
    from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker

    class ParamsWorker(LLMRolloutWorker):
        def engine_params(self):
            return self.engine.params_snapshot()[0]

    return ParamsWorker


def wait_swapped(rt, workers, version: int, timeout: float = 60.0) -> list:
    """Each worker engine's weight_version, once all equal `version` (the
    swap lands between windows, after recv_weights staged it)."""
    deadline = time.monotonic() + timeout
    while True:
        vs = [rt.get(w.stats.remote(), timeout=60.0)["weight_version"]
              for w in workers]
        if vs == [version] * len(workers) or time.monotonic() > deadline:
            return vs
        time.sleep(0.005)


def swap_ms(rt, workers) -> list:
    """Each engine's last weight swap: from staging to the copy done."""
    return [rt.get(w.stats.remote(), timeout=60.0)["engine"]
            ["last_weight_sync_ms"] for w in workers]


def actor_graphs(rt, workers) -> dict:
    """Graph accounting summed over the workers' engines."""
    out = {"decode_windows": 0, "graph_replays": 0, "graph_captures": 0}
    for w in workers:
        st = rt.get(w.stats.remote(), timeout=60.0)["engine"]
        for k in out:
            out[k] += st[k]
    return out


def union_ms(prof) -> float:
    """Device time as the union of the kernels' intervals (streams of
    concurrent engines overlap, so a sum would count twice)."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False))
    total, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total / 1e3


def phase_rlhf_actors_small():
    """The actor topology at `debug` in f32 on a LocalRuntime against the
    in-process loop (see 7c in the module docstring)."""
    from ray_tpu_torch.collective.collective import broadcast_pytree
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rl.rlhf import RLHFConfig, RLHFTrainer
    from ray_tpu_torch.serve.runtime import LocalRuntime
    from ray_tpu_torch.train.step import param_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(llama.llama_configs()["debug"],
                              dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator().manual_seed(SEED))
    base = dict(model=cfg, seed=SEED, n_prompts=4, prompt_len=10,
                group_size=4, prompts_per_step=2, max_new_tokens=5,
                temperature=0.0, kl_coeff=0.1, lr=1e-2, device="cuda",
                engine=dict(max_batch=8, max_len=128, page_size=16,
                            steps_per_sync=3))
    n_steps = 3

    def host(tree):
        return [t.detach().to("cpu", copy=True) for t in param_leaves(tree)]

    local = RLHFTrainer(RLHFConfig(**base, params=tree_to(params, "cuda")))
    try:
        want = []
        for _ in range(n_steps):
            local.step()
            want.append(host(local.learner.params))
    finally:
        local.shutdown()
    rt = LocalRuntime()
    tr = RLHFTrainer(RLHFConfig(**base, params=tree_to(params, "cuda"),
                                num_rollout_workers=2, remote_learner=True,
                                runtime=rt, worker_cls=params_worker()))
    try:
        torch.cuda.synchronize()
        zero_serve_counts()
        diffs, versions, metrics = [], [], []
        for i in range(n_steps):
            m = tr.step()
            metrics.append({k: m[k] for k in ("version", "loss", "kl",
                                              "epoch", "rollout_regens")})
            got = host(rt.get(tr.learner.get_params_numpy.remote(),
                              timeout=300.0))
            diffs.append(max(float((a - b).abs().max())
                             for a, b in zip(got, want[i])))
            versions.append(wait_swapped(rt, tr.workers, m["version"]))
        torch.cuda.synchronize()
        launches = rlhf_counts()
        moved = max(float((a - b.cpu()).abs().max())
                    for a, b in zip(got, param_leaves(params)))
        # The packed broadcast from this process (rank 0) to worker 0.
        w = tr.workers[0]
        rt.init_collective_group(2, 0, "chip_smoke_rt")
        rt.get(w.init_collective_group.remote(2, 1, "object_store",
                                              "chip_smoke_rt"), timeout=60.0)
        sent = tree_to(llama.init_params(
            cfg, torch.Generator().manual_seed(SEED + 1)), "cuda")
        recv = w.recv_weights.remote(99, "chip_smoke_rt")
        broadcast_pytree(sent, 0, "chip_smoke_rt", runtime=rt, timeout=60.0)
        rt.get(recv, timeout=60.0)
        swapped = wait_swapped(rt, [w], 99)
        eng = rt.get(w.engine_params.remote(), timeout=60.0)
        roundtrip = swapped == [99] and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(param_leaves(eng), param_leaves(sent)))
        rt.destroy_collective_group("chip_smoke_rt", "phase done")
    finally:
        tr.shutdown()
        rt.shutdown()
    row = {"phase": "rlhf_actors_small_f32", "model": "debug",
           "dtype": "float32", "steps": n_steps, "workers": 2,
           "remote_learner": True, "params_max_abs_diff": diffs,
           "tol": 1e-4, "params_moved": moved, "metrics": metrics,
           "engine_versions": versions, "broadcast_roundtrip_bitwise":
           roundtrip, "launches": launches}
    emit(row)
    if not all(d <= 1e-4 for d in diffs) or moved <= 1e-4:
        raise AssertionError(f"rlhf_actors_small: params {diffs}, moved "
                             f"{moved}")
    if any(v != [i + 1] * 2 for i, v in enumerate(versions)):
        raise AssertionError(f"rlhf_actors_small: versions {versions}")
    if not roundtrip:
        raise AssertionError("rlhf_actors_small: the broadcast_pytree "
                             "round trip was not bit for bit")
    per_update = cfg.n_layers * n_steps
    if (launches["paged_decode_attention"] == 0
            or launches["flash_attention_fwd/fma"] == 0
            or launches["flash_attention_fwd/wgmma"]
            or any(launches[f"flash_attention_bwd_{k}/fma"] != per_update
                   or launches[f"flash_attention_bwd_{k}/wgmma"]
                   for k in ("dq", "dkv"))):
        raise AssertionError(f"rlhf_actors_small: launches {launches}")
    return launches


def phase_rlhf_actors_350m(card, one_worker: dict):
    """The actor topology at `bench-350m` in bf16 on the one card (see 7d
    in the module docstring)."""
    import shutil
    import tempfile

    from ray_tpu_torch.collective.collective import pack
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rl.rlhf import RLHFConfig, RLHFTrainer
    from ray_tpu_torch.serve.runtime import LocalRuntime
    from ray_tpu_torch.tools.profile_serve import kernel_groups
    from ray_tpu_torch.train.step import param_leaves

    cfg = llama.llama_configs()["bench-350m"]
    K = RLHF_350M["engine"]["steps_per_sync"]
    n_timed = 4

    # One tree for both trainers: the learner and each engine copy it.
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    packed = sum(t.numel() * t.element_size() for t in param_leaves(params))
    pack_ms = []                    # the learner's half of a sync, alone
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf = pack(param_leaves(params))
        pack_ms.append((time.perf_counter() - t0) * 1e3)
        if buf.nbytes != packed:
            raise AssertionError(f"rlhf_actors_350m: packed {buf.nbytes}")
        del buf

    def trainer(rt, **kw):
        return RLHFTrainer(RLHFConfig(
            model=cfg, params=params, seed=SEED, num_rollout_workers=2,
            remote_learner=True, runtime=rt, worker_cls=recording_worker(),
            **RLHF_350M, **kw))

    def row_of(m, step_s, versions):
        r = m["rollout"]
        return {"step_s": step_s, "rollout_s": r["gen_s_max"],
                "swap_ms": swap_ms(rt, tr.workers),
                "completion_tokens": r["rollout_tokens"],
                "rollout_tokens_per_s": r["rollout_tokens"]
                / r["gen_s_max"],
                "update_s": m["update_s"],
                "weight_sync_ms": m["step_weight_sync_ms"],
                "versions": versions, "loss": m["loss"],
                "reward_mean": m["reward_mean"]}

    rt = LocalRuntime()
    t0 = time.perf_counter()
    tr = trainer(rt)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    steps = []
    try:
        t0 = time.perf_counter()
        m = tr.step()                                  # warm-up
        torch.cuda.synchronize()
        warm = row_of(m, time.perf_counter() - t0,
                      wait_swapped(rt, tr.workers, m["version"]))
        first = first_step(rt, tr, m)
        torch.cuda.reset_peak_memory_stats()
        g0 = actor_graphs(rt, tr.workers)
        zero_serve_counts()
        for _ in range(n_timed):
            t0 = time.perf_counter()
            m = tr.step()
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            steps.append(row_of(m, step_s, wait_swapped(
                rt, tr.workers, m["version"])))
        torch.cuda.synchronize()
        launches = rlhf_counts()
        g1 = actor_graphs(rt, tr.workers)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            m = tr.step()
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        traced = row_of(m, traced_s, wait_swapped(rt, tr.workers,
                                                  m["version"]))
        _, groups = kernel_groups(prof)
        busy_ms = union_ms(prof)
        del prof
    finally:
        tr.shutdown()
        rt.shutdown()
        del tr
        gc.collect()
        torch.cuda.empty_cache()

    # The crash runs: checkpoint_every=1, the failpoints of the reference.
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_rlhf_")
    rt = LocalRuntime()
    tr = trainer(rt, checkpoint_every=1, checkpoint_dir=ckpt)
    try:
        tr.step()
        rt.arm("rl.rollout_step", "nth:1+crash", actor=tr.workers[0])
        m = tr.step()
        regen = {"version": m["version"],
                 "rollout_regens": m["rollout_regens"],
                 "worker_versions": wait_swapped(rt, tr.workers,
                                                 m["version"])}
        newest = tr.flush_checkpoints()
        epoch0 = tr.stats()["epoch"]
        rt.arm("rl.weight_sync", "nth:1+crash", actor=tr.learner)
        m = tr.step()
        st = tr.stats()
        restart = {"update_version": m["version"], "newest_ckpt":
                   newest[0], "resumed_version": st["version"],
                   "learner_restarts": st["learner_restarts"],
                   "epoch_before": epoch0, "epoch_after": st["epoch"],
                   "worker_versions": wait_swapped(rt, tr.workers,
                                                   st["version"])}
        m = tr.step()
        restart["next_version"] = m["version"]
        restart["next_loss_finite"] = math.isfinite(m["loss"])
        kv = [rt.get(w.kv_check.remote(), timeout=60.0)["ok"]
              for w in tr.workers]
    finally:
        tr.shutdown()
        rt.shutdown()
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(ckpt, ignore_errors=True)
    del params

    windows = g1["decode_windows"] - g0["decode_windows"]
    replays = g1["graph_replays"] - g0["graph_replays"]

    def mean(key):
        return sum(s[key] for s in steps) / len(steps)

    row = {"phase": "rlhf_actors_350m", "card": card, "model": "bench-350m",
           "dtype": "bfloat16", "params": cfg.num_params(), "workers": 2,
           "remote_learner": True, "runtime": "LocalRuntime",
           "config": dict(RLHF_350M), "build_s": build_s,
           "warmup_step": warm, "steps": steps,
           "mean": {k: mean(k) for k in (
               "step_s", "rollout_s", "rollout_tokens_per_s", "update_s",
               "weight_sync_ms")},
           "one_worker_rlhf_350m": {
               "decode_tokens_per_s": one_worker["decode_tokens_per_s"],
               "step_s": one_worker["step_s"],
               "weight_sync_ms": one_worker["weight_sync_ms"]},
           "packed_bytes": packed, "pack_ms": pack_ms,
           "peak_mem_gb": peak_gb,
           "launches": launches, "timed_windows": windows,
           "timed_replays": replays, "traced_step": traced,
           "traced_device_union_ms": busy_ms,
           "traced_device_busy_share": busy_ms / (traced_s * 1e3),
           "traced_device_sum_ms": sum(ms for ms, _ in groups.values()),
           "traced_groups": {k: {"ms": ms, "launches": n}
                             for k, (ms, n) in sorted(groups.items())},
           "crash_rollout_worker": regen, "crash_learner": restart,
           "kv_check_ok": kv}
    emit(row)
    for s_ in steps + [warm, traced]:
        if s_["versions"] != [s_["versions"][0]] * 2 or \
                not math.isfinite(s_["loss"]):
            raise AssertionError(f"rlhf_actors_350m: step {s_}")
    if any(s_["versions"][0] != i + 2 for i, s_ in enumerate(steps)):
        raise AssertionError(f"rlhf_actors_350m: versions {steps}")
    want_bwd = cfg.n_layers * n_timed
    if (windows == 0 or replays != windows
            or launches["paged_decode_attention"]
            != replays * paged_per_replay(cfg, K)
            or launches["flash_attention_fwd/wgmma"] == 0
            or launches["flash_attention_fwd/fma"]
            or any(launches[f"flash_attention_bwd_{k}/wgmma"] != want_bwd
                   or launches[f"flash_attention_bwd_{k}/fma"]
                   for k in ("dq", "dkv"))):
        raise AssertionError(f"rlhf_actors_350m: launches {launches}, "
                             f"{windows} windows, {replays} replays")
    if regen["rollout_regens"] != 1 or regen["version"] != 2 \
            or regen["worker_versions"] != [2, 2]:
        raise AssertionError(f"rlhf_actors_350m: worker crash {regen}")
    if (restart["learner_restarts"] != 1
            or restart["resumed_version"] != restart["newest_ckpt"]
            or restart["epoch_after"] <= restart["epoch_before"]
            or restart["worker_versions"] != [restart["resumed_version"]] * 2
            or restart["next_version"] != restart["resumed_version"] + 1
            or not restart["next_loss_finite"]):
        raise AssertionError(f"rlhf_actors_350m: learner crash {restart}")
    if not all(kv):
        raise AssertionError(f"rlhf_actors_350m: kv_check {kv}")
    return launches, first


FIRST_STEP_KEYS = ("loss", "policy_loss", "kl", "ratio_mean", "reward_mean",
                   "reward_std")


def first_step(rt, tr, m) -> dict:
    """A trainer's first step: each worker's first trajectory tokens and
    the learner's metrics (what the cluster phase holds against the
    LocalRuntime phase)."""
    return {"tokens": [rt.get(w.traj_tokens.remote(0), timeout=60.0)
                       for w in tr.workers],
            "metrics": {k: float(m[k]) for k in FIRST_STEP_KEYS},
            "advantages": np.asarray(m["advantages"], np.float32),
            "rollout_tokens": int(m["rollout_tokens"])}


# ------------------------------------------- phase 8: MoE, small f32
# CUDA against the CPU in f32 (TF32 off): routing is exact comparisons and
# counts over f32 probabilities, so the dispatch must be equal and the
# gates within 1e-6; logits, loss and the first step's gradients (relative
# to each leaf's largest, the rlhf_small_f32 rule) within 1e-4.
MOE_ROUTE_TOL = 1e-6
MOE_TOL = 1e-4


def phase_moe_small():
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, param_leaves)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(moe.moe_configs()["moe-debug"],
                              dtype=torch.float32)
    params = moe.init_params(cfg, torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 65)))
    # route() on the same hidden states and router on both devices.
    h = torch.from_numpy(rng.normal(size=(128, cfg.dim)).astype(np.float32))
    w = params["layers"]["router"][0]
    cpu_r = moe.route(h, w, cfg)
    gpu_r = [t.cpu() for t in moe.route(h.cuda(), w.cuda(), cfg)]
    # Tied probabilities (tests/test_torch_moe.py's case): identical
    # router columns but for two rows; experts 1 and 2 tie for second
    # place in the first 32 tokens, 0 and 1 for first in the others.
    ht = torch.from_numpy(rng.normal(size=(64, cfg.dim)).astype(np.float32))
    ht[:, :2] = 0.0
    ht[:32, 0] = ht[32:, 1] = 5.0
    wt = (torch.from_numpy(rng.normal(size=(cfg.dim, 1)).astype(np.float32))
          * 0.1).repeat(1, cfg.n_experts)
    wt[0] = torch.tensor([4.0, 3.0, 3.0, 0.0])
    wt[1] = torch.tensor([3.0, 3.0, 0.0, 0.0])
    tied_cpu = moe.route(ht, wt, cfg)[0]
    tied_gpu = moe.route(ht.cuda(), wt.cuda(), cfg)[0].cpu()
    probs = torch.softmax(ht.cuda() @ wt.cuda(), dim=-1)
    topk_e = torch.topk(probs, cfg.experts_per_token, dim=-1).indices
    row = {"phase": "moe_small_f32", "model": "moe-debug",
           "tied_dispatch_equal": bool(torch.equal(tied_gpu, tied_cpu)),
           "tied_lower_index": bool(tied_gpu[:, 2:].sum() == 0),
           "cuda_topk_picks_lower_index": bool(
               (topk_e.sort(dim=-1).values.cpu()
                == torch.tensor([0, 1])).all()),
           "dtype": "float32", "batch": 2, "seq": 64,
           "route_tokens": 128, "capacity": moe._capacity(128, cfg),
           "dispatch_equal": bool(torch.equal(gpu_r[0], cpu_r[0])),
           "route_kept": float(cpu_r[0].sum()),
           "combine_max_abs_diff": max_err(gpu_r[1], cpu_r[1]),
           "aux_abs_diff": abs(float(gpu_r[2]) - float(cpu_r[2])),
           "tol": {"route": MOE_ROUTE_TOL, "model": MOE_TOL}}
    out = {}
    opt = default_optimizer(lr=1e-3, warmup=2, total_steps=10)
    zero_flash_counts()
    for device in ("cuda", "cpu"):
        state = create_train_state(SEED, cfg, opt, device=device,
                                   params=params)
        toks = tokens.to(device)
        with torch.no_grad():
            logits, aux = moe.forward(state.params, toks[:, :-1], cfg)
        n0 = flash_counts()
        loss = moe.loss_fn(state.params, {"tokens": toks}, cfg)
        loss.backward()
        out[device] = {"logits": logits.cpu(), "aux": aux.item(),
                       "loss": loss.item(),
                       "grads": [p.grad.cpu()
                                 for p in param_leaves(state.params)],
                       "launches": {n: c - n0[n] for n, c in
                                    flash_counts().items()}}
    gpu, cpu = out["cuda"], out["cpu"]
    grad_rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(
        1e-30)) for a, b in zip(gpu["grads"], cpu["grads"]))
    row.update({"logits_max_abs_diff": max_err(gpu["logits"],
                                               cpu["logits"]),
                "loss_cuda": gpu["loss"], "loss_cpu": cpu["loss"],
                "aux_cuda": gpu["aux"], "aux_cpu": cpu["aux"],
                "first_step_grads_rel": grad_rel,
                "launches_grad_pass": gpu["launches"]})
    emit(row)
    if not (row["dispatch_equal"] and row["tied_dispatch_equal"]
            and row["tied_lower_index"]):
        raise AssertionError(f"moe_small: route's dispatch differs on CUDA "
                             f"or breaks a tie upward: {row}")
    if max(row["combine_max_abs_diff"], row["aux_abs_diff"]) \
            > MOE_ROUTE_TOL:
        raise AssertionError(f"moe_small: route differs: {row}")
    np.testing.assert_allclose(gpu["logits"].numpy(), cpu["logits"].numpy(),
                               atol=MOE_TOL, rtol=MOE_TOL)
    np.testing.assert_allclose(gpu["loss"], cpu["loss"], rtol=MOE_TOL)
    if grad_rel > MOE_TOL:
        raise AssertionError(f"moe_small: gradients differ: {grad_rel}")
    L = cfg.n_layers
    want = {"flash_attention_fwd": L, "flash_attention_fwd/fma": L,
            "flash_attention_fwd/wgmma": 0,
            "flash_attention_bwd_dq": L, "flash_attention_bwd_dq/fma": L,
            "flash_attention_bwd_dq/wgmma": 0,
            "flash_attention_bwd_dkv": L, "flash_attention_bwd_dkv/fma": L,
            "flash_attention_bwd_dkv/wgmma": 0}
    if gpu["launches"] != want or any(cpu["launches"].values()):
        raise AssertionError(f"moe_small: launches {gpu['launches']} != "
                             f"{want}")
    return flash_counts()


# ------------------------------------ phase 9: Mixtral, 4 of 32 layers
def range_split(prof, ranges, groups) -> dict:
    """Device ms of a trace by where each kernel came from: a kernel
    launched inside a record_function range (forward, or its remat
    recompute) counts to that range; a backward kernel to the range of
    the forward op whose autograd node launched it (sequence number and
    thread, the profiler's own forward-backward link).  The flash
    kernels, and the "gemm" and "other" kernels outside the ranges, come
    from `groups` (kernel_groups of the same trace: each device kernel
    once); on the card's torch a CPU event's `kernels` can repeat
    kernels of other events, so only the ranges' are read from there,
    and only names seen among the trace's device kernels."""
    from ray_tpu_torch.tools.profile_serve import kernel_group

    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    device_names = {e.name for e in events if e.device_type == cuda
                    and not getattr(e, "is_user_annotation", False)}
    fwd = {}
    for e in events:
        if e.name in ranges:
            stack = list(e.cpu_children)
            while stack:
                c = stack.pop()
                if c.sequence_nr >= 0:
                    fwd[(c.sequence_nr, c.thread)] = e.name
                stack.extend(c.cpu_children)

    def label(e):
        while e is not None:
            if e.name in ranges:
                return e.name
            if e.scope == 1:                       # a backward function
                return fwd.get((e.sequence_nr, e.fwd_thread))
            e = e.cpu_parent
        return None

    out, inside = {}, {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        lab = label(e)
        for k in e.kernels:
            g = kernel_group(k.name)
            if lab is None or k.name not in device_names \
                    or g.startswith("flash"):
                continue
            for d, key in ((out, lab), (inside, g)):
                ms, n = d.get(key, (0.0, 0))
                d[key] = (ms + k.duration / 1e3, n + 1)
    for g, (ms, n) in groups.items():
        ms_in, n_in = inside.get(g, (0.0, 0))
        out[g] = (ms - ms_in, n - n_in)     # outside the ranges
    return out


def phase_train_mixtral_4l(card):
    """`mixtral-8x7b` at its published widths, 4 of its 32 layers (bf16
    weights, gradients and AdamW moments take 8 bytes a parameter: 4
    layers are 6.07 G parameters, 48.6 GB; 32 would be 373 GB)."""
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.tools.profile_serve import kernel_groups
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, make_train_step)

    cfg = dataclasses.replace(moe.moe_configs()["mixtral-8x7b"], n_layers=4)
    batch_size, seq, n_timed = 2, 4096, 3
    opt = default_optimizer(total_steps=1000)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = create_train_state(SEED, cfg, opt)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch_size, seq))).to("cuda")
    batch = {"inputs": tokens, "targets": tokens}      # bench.py's batch
    step = make_train_step(cfg, opt)
    t0 = time.perf_counter()
    state, m = step(state, batch)                      # warm-up, lr 0
    loss0 = m["loss"].item()
    warmup_s = time.perf_counter() - t0
    losses, norms, step_ms = [], [], []
    torch.cuda.synchronize()
    zero_flash_counts()
    for _ in range(n_timed):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    launches = flash_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # Routing of one no-grad forward: slots kept per layer, and the aux.
    kept, plain = [], moe.route
    C = moe._capacity(batch_size * seq, cfg)

    def recording(h, w, cfg_):
        out = plain(h, w, cfg_)
        kept.append(float(out[0].sum(dtype=torch.float32)))
        return out

    moe.route = recording
    try:
        with torch.no_grad():
            _, aux = moe.forward(state.params, tokens, cfg)
    finally:
        moe.route = plain
    routed = batch_size * seq * cfg.experts_per_token

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    _, groups = kernel_groups(prof)
    device_ms = sum(ms for ms, _ in groups.values())
    split = range_split(prof, moe.TRACE_RANGES, groups)

    mean_ms = sum(step_ms) / len(step_ms)
    tokens_per_s = batch_size * seq / (mean_ms / 1e3)
    flops_per_token = 6 * cfg.active_params() \
        + 12 * cfg.n_layers * cfg.dim * seq
    row = {"phase": "train_mixtral_4l", "card": card,
           "model": "mixtral-8x7b", "n_layers": cfg.n_layers,
           "dtype": "bfloat16", "params": cfg.num_params(),
           "active_params": cfg.active_params(), "batch": batch_size,
           "seq": seq, "capacity": C, "remat_mode": cfg.remat_mode,
           "init_params_s": t_init, "warmup_step_s": warmup_s,
           "first_loss": loss0, "ln_vocab": math.log(cfg.vocab_size),
           "loss": losses, "grad_norm": norms, "aux": aux.item(),
           "kept_slots_per_layer": kept, "routed_slots": routed,
           "dropped_share_per_layer": [1 - k / routed for k in kept],
           "step_ms": step_ms, "mean_step_ms": mean_ms,
           "tokens_per_s": tokens_per_s,
           "flops_per_token": flops_per_token,
           "mfu_active": tokens_per_s * flops_per_token / BF16_FLOPS,
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": {n: c / n_timed
                                 for n, c in launches.items()},
           "traced_step_ms": traced_ms, "traced_device_ms": device_ms,
           "traced_device_busy_share": device_ms / traced_ms,
           "traced_groups": {g: {"ms": ms, "launches": n}
                             for g, (ms, n) in sorted(groups.items())},
           "traced_split": {g: {"ms": ms, "launches": n}
                            for g, (ms, n) in sorted(split.items())},
           "traced_split_ranges_ms": sum(ms for g, (ms, _) in split.items()
                                         if g in moe.TRACE_RANGES)}
    emit(row)
    if not all(math.isfinite(x) for x in losses + norms + [loss0,
                                                           aux.item()]):
        raise AssertionError(f"non-finite loss, grad norm or aux: {row}")
    if abs(loss0 - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {loss0} is far from ln(vocab)")
    if len(kept) != cfg.n_layers or not all(0 < k <= routed for k in kept):
        raise AssertionError(f"routing counts {kept} of {routed}")
    if any(c != (0 if n.endswith("/fma") else n_timed * cfg.n_layers)
           for n, c in launches.items()):
        raise AssertionError(f"flash launches {launches} != "
                             f"{cfg.n_layers} per step, all bf16 routes")
    del state, m, prof
    return launches


# ------------------------------------------- phases 10-11: vision, f32
VISION_TOL = 1e-4


def grads_rel(gpu: list, cpu: list) -> float:
    """Largest |g - ref| over each leaf's largest |ref|, over the leaves."""
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(gpu, cpu))


def vision_small(mod, cfg, params, batch) -> tuple[dict, dict]:
    """A vision model's no-grad logits, loss and first gradients on CUDA
    and on the CPU from the same params and batch; the CUDA grad pass's
    flash launches."""
    from ray_tpu_torch.train.step import param_leaves

    out = {}
    for device in ("cuda", "cpu"):
        params_d = tree_to(params, device)
        for p in param_leaves(params_d):
            p.requires_grad_(True)
        b = {k: v.to(device) for k, v in batch.items()}
        with torch.no_grad():
            logits = mod.forward(params_d, b["images"], cfg)
        n0 = flash_counts()
        loss = mod.loss_fn(params_d, b, cfg)
        loss.backward()
        out[device] = {"logits": logits.cpu(), "loss": loss.item(),
                       "grads": [p.grad.cpu()
                                 for p in param_leaves(params_d)],
                       "launches": {n: c - n0[n] for n, c in
                                    flash_counts().items()}}
    gpu, cpu = out["cuda"], out["cpu"]
    row = {"logits_max_abs_diff": max_err(gpu["logits"], cpu["logits"]),
           "logits_max_abs": float(cpu["logits"].abs().max()),
           "loss_cuda": gpu["loss"], "loss_cpu": cpu["loss"],
           "first_step_grads_rel": grads_rel(gpu["grads"], cpu["grads"]),
           "launches_grad_pass": gpu["launches"], "tol": VISION_TOL}
    np.testing.assert_allclose(gpu["logits"].numpy(), cpu["logits"].numpy(),
                               atol=VISION_TOL, rtol=VISION_TOL)
    np.testing.assert_allclose(gpu["loss"], cpu["loss"], rtol=VISION_TOL)
    if row["first_step_grads_rel"] > VISION_TOL:
        raise AssertionError(f"gradients differ: {row}")
    if any(cpu["launches"].values()):
        raise AssertionError(f"a CPU pass launched a kernel: {cpu}")
    return row, gpu["launches"]


def vision_batch(n, size, n_classes, device="cpu", seed=SEED) -> dict:
    rng = np.random.default_rng(seed)
    return {"images": torch.from_numpy(rng.normal(
                size=(n, size, size, 3)).astype(np.float32)).to(device),
            "labels": torch.from_numpy(rng.integers(
                0, n_classes, size=n)).to(device)}


def phase_vit_small():
    """A ViT with head_dim 32 (`vit-debug`'s 16 takes no kernel), f32,
    TF32 off: CUDA (the FMA flash kernels) against the CPU."""
    from ray_tpu_torch.models import vit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = vit.ViTConfig(image_size=32, patch_size=8, dim=128, n_layers=2,
                        n_heads=4, mlp_dim=256, n_classes=10,
                        dtype=torch.float32)
    params = vit.init_params(cfg, torch.Generator().manual_seed(SEED))
    row, launches = vision_small(vit, cfg, params,
                                 vision_batch(4, 32, cfg.n_classes))
    L = cfg.n_layers
    # remat: each layer's forward runs again in the backward.
    want = {"flash_attention_fwd": 2 * L, "flash_attention_fwd/fma": 2 * L,
            "flash_attention_fwd/wgmma": 0,
            "flash_attention_bwd_dq": L, "flash_attention_bwd_dq/fma": L,
            "flash_attention_bwd_dq/wgmma": 0,
            "flash_attention_bwd_dkv": L, "flash_attention_bwd_dkv/fma": L,
            "flash_attention_bwd_dkv/wgmma": 0}
    row = {"phase": "vit_small_f32", "dim": cfg.dim, "n_heads": cfg.n_heads,
           "head_dim": cfg.head_dim, "n_layers": L, "tokens":
           cfg.n_patches + 1, "batch": 4, "remat": cfg.remat, **row}
    emit(row)
    if launches != want:
        raise AssertionError(f"vit_small: launches {launches} != {want}")
    return launches


def phase_resnet_small():
    """`resnet-debug` (f32) on 33-pixel images, cuDNN's TF32 off: CUDA
    against the CPU."""
    from ray_tpu_torch.models import resnet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = resnet.resnet_configs()["resnet-debug"]
    params = resnet.init_params(cfg, torch.Generator().manual_seed(SEED))
    row, launches = vision_small(resnet, cfg, params,
                                 vision_batch(4, 33, cfg.num_classes))
    row = {"phase": "resnet_small_f32", "model": "resnet-debug",
           "image_size": 33, "batch": 4,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32, **row}
    emit(row)
    if any(launches.values()):
        raise AssertionError(f"resnet launched flash kernels: {launches}")


# ------------------------------------- phases 12-13: vision at full width
def vision_groups(kernels: dict) -> dict:
    """Device ms and launches of a traced vision step by group: the
    flash kernels, GEMMs and convolutions, the optimizer's multi-tensor
    kernels, and the rest (norms and elementwise)."""
    from ray_tpu_torch.tools.profile_serve import kernel_group

    out = {}
    for name, (ms, n) in kernels.items():
        g, low = kernel_group(name), name.lower()
        if g == "gemm" or any(k in low for k in (
                "conv", "fprop", "dgrad", "wgrad", "implicit", "winograd")):
            g = "gemm_conv"
        elif "multi_tensor_apply" in low:
            g = "optimizer"
        elif g == "other":
            g = "norm_elementwise"
        acc = out.setdefault(g, [0.0, 0])
        acc[0] += ms
        acc[1] += n
    return out


def train_vision(card, mod, cfg, name, image_size, n_classes,
                 fwd_flops) -> tuple[dict, dict]:
    """Three timed `make_train_step` steps of a vision model in bf16 at
    batch 256 of seeded random images, after one warm-up step (lr 0),
    then one step under torch.profiler.  The TrainState is built by hand
    from the family's own params (create_train_state casts every leaf to
    cfg.dtype)."""
    from ray_tpu_torch.tools.profile_serve import kernel_groups
    from ray_tpu_torch.train.step import (TrainState, default_optimizer,
                                          make_train_step, param_leaves)

    batch_size, n_timed = 256, 3
    opt = default_optimizer(total_steps=1000)
    torch.cuda.reset_peak_memory_stats()
    params = mod.init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(SEED))
    for p in param_leaves(params):
        p.requires_grad_(True)
    dtypes = sorted({str(p.dtype) for p in param_leaves(params)})
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    batch = vision_batch(batch_size, image_size, n_classes, "cuda")
    step = make_train_step(cfg, opt, mod.loss_fn, device="cuda")
    t0 = time.perf_counter()
    state, m = step(state, batch)                      # warm-up, lr 0
    loss0 = m["loss"].item()
    warmup_s = time.perf_counter() - t0
    losses, norms, step_ms = [], [], []
    torch.cuda.synchronize()
    zero_flash_counts()
    for _ in range(n_timed):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    launches = flash_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels, _ = kernel_groups(prof)
    groups = vision_groups(kernels)
    device_ms = sum(ms for ms, _ in groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    mean_ms = sum(step_ms) / len(step_ms)
    images_per_s = batch_size / (mean_ms / 1e3)
    row = {"phase": f"train_{name}", "card": card, "model": name,
           "dtype": str(cfg.dtype), "param_dtypes": dtypes,
           "params": cfg.num_params(), "batch": batch_size,
           "image_size": image_size, "n_classes": n_classes,
           "warmup_step_s": warmup_s, "first_loss": loss0,
           "ln_classes": math.log(n_classes), "loss": losses,
           "grad_norm": norms, "step_ms": step_ms, "mean_step_ms": mean_ms,
           "images_per_s": images_per_s, "forward_flops_per_image":
           fwd_flops, "mfu": images_per_s * 3 * fwd_flops / BF16_FLOPS,
           "peak_mem_gb": peak_gb, "launches": launches,
           "launches_per_step": {n: c / n_timed
                                 for n, c in launches.items()},
           "traced_step_ms": traced_ms, "traced_device_ms": device_ms,
           "traced_device_busy_share": device_ms / traced_ms,
           "traced_groups": {g: {"ms": ms, "launches": n,
                                 "share": ms / device_ms}
                             for g, (ms, n) in sorted(groups.items())},
           "traced_top_kernels": [{"name": n[:100], "ms": ms, "launches": c}
                                  for n, (ms, c) in top]}
    emit(row)
    if not all(math.isfinite(x) for x in losses + norms + [loss0]):
        raise AssertionError(f"non-finite loss or grad norm: {row}")
    # One fixed batch: the warm-up (lr 0) and three small warm-up-schedule
    # updates must lower its loss.  (At init ResNet's logits are far from
    # uniform: its first loss sits well above ln(classes).)
    if not losses[-1] < loss0:
        raise AssertionError(f"the loss did not fall: {loss0} -> {losses}")
    del state, m, prof
    return row, launches


def phase_train_vit_b16(card):
    """ViT-B/16 (Dosovitskiy et al. 2021: 224 px, patch 16, dim 768, 12 x
    12 heads, mlp 3072, 1000 classes) in bf16, remat on: 24 forward (12
    and their recompute), 12 dQ and 12 dK/dV launches a step, all on the
    wgmma route (head_dim 64, non-causal, 197 tokens)."""
    from ray_tpu_torch.models import vit

    cfg = vit.vit_configs()["vit-b16"]
    row, launches = train_vision(card, vit, cfg, "vit_b16", cfg.image_size,
                                 cfg.n_classes, cfg.forward_flops())
    L, n_timed = cfg.n_layers, 3
    want = {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L}
    got = {n: c / n_timed for n, c in launches.items()}
    if any(got[n] != c or got[f"{n}/wgmma"] != c or got[f"{n}/fma"]
           for n, c in want.items()):
        raise AssertionError(f"train_vit_b16: launches per step {got} != "
                             f"{want}, all bf16 (wgmma)")
    fl = row["traced_groups"]
    if any(fl.get(g, {}).get("launches") != c for g, c in (
            ("flash_fwd", 2 * L), ("flash_bwd_dq", L),
            ("flash_bwd_dkv", L))):
        raise AssertionError(f"train_vit_b16: traced flash groups {fl}")
    return launches


def phase_train_resnet18(card):
    """ResNet-18 (He et al. 2016, the reference's GroupNorm 32 in place of
    BatchNorm) in bf16 on 224 px images, 1000 classes; the parameter tree
    stays f32 (master weights).  No flash kernel on this path."""
    from ray_tpu_torch.models import resnet

    cfg = resnet.resnet_configs()["resnet18"]
    row, launches = train_vision(card, resnet, cfg, "resnet18", 224,
                                 cfg.num_classes, cfg.forward_flops(224))
    if any(launches.values()) or row["param_dtypes"] != ["torch.float32"]:
        raise AssertionError(f"train_resnet18: flash launches {launches} or "
                             f"param dtypes {row['param_dtypes']}")
    return launches


# ------------------------------------------------ phase 14: RL learners
RL_ALGOS = ("ppo", "impala", "appo", "dqn", "bc", "marwil", "sac", "cql")


def rl_batch(algo: str, n: int = 64, t: int = 8, obs: int = 8,
             actions: int = 4) -> dict:
    """One seeded batch of what `algo`'s loss reads ([n, t] fragments with
    episode ends and truncations for IMPALA and APPO)."""
    rng = np.random.default_rng(RL_ALGOS.index(algo))
    f32 = np.float32
    lead = (n, t) if algo in ("impala", "appo") else (n,)
    b = {"obs": rng.normal(size=(*lead, obs)).astype(f32),
         "actions": rng.integers(0, actions, size=lead),
         "next_obs": rng.normal(size=(*lead, obs)).astype(f32),
         "rewards": rng.normal(size=lead).astype(f32),
         "dones": (rng.random(lead) < 0.15).astype(f32),
         "truncs": (rng.random(lead) < 0.1).astype(f32),
         "logp": np.log(rng.uniform(0.1, 0.5, lead)).astype(f32),
         "advantages": rng.normal(size=lead).astype(f32),
         "value_targets": rng.normal(size=lead).astype(f32),
         "q_targets": rng.normal(size=lead).astype(f32),
         "returns": rng.normal(size=lead).astype(f32)}
    return b


def phase_rl_learners():
    """Each algorithm's first update on CUDA against the CPU, f32 (TF32
    off): the same initial params (the CPU learner's with its target
    nets moved off the online ones, through set_params), the same batch
    and minibatch order; the first
    minibatch's gradients within 1e-4 of each leaf's largest and the
    update's metrics within 1e-4.  The params after the update (two Adam
    steps) are reported: Adam's first step moves an element by about lr
    whatever its gradient, so an element whose gradient is rounding noise
    near zero may step either way on the two devices (PERF.md, PR 9)."""
    import importlib

    from ray_tpu_torch.parallel.sharding import tree_map
    from ray_tpu_torch.rl.learner import Learner

    torch.backends.cuda.matmul.allow_tf32 = False
    names = {"ppo": "PPO", "impala": "IMPALA", "appo": "APPO", "dqn": "DQN",
             "bc": "BC", "marwil": "MARWIL", "sac": "SAC", "cql": "CQL"}
    rows = {}
    for algo in RL_ALGOS:
        cls = getattr(importlib.import_module(f"ray_tpu_torch.rl.{algo}"),
                      names[algo])
        config = cls.learner_config({"obs_dim": 8, "n_actions": 4,
                                     "hidden": 64, "seed": SEED})
        batch = rl_batch(algo)
        n = len(batch["obs"])
        cpu = Learner(config, cls.loss_builder, device="cpu")
        gpu = Learner(config, cls.loss_builder, device="cuda")
        # Target nets ("pi_t", "q1_t", ...) drifted from the online ones,
        # as after some polyak syncs: while pi_t == pi, APPO's KL gradient
        # on pi_t is rounding noise around zero.
        rng = np.random.default_rng(SEED + 99)
        start = {k: tree_map(lambda a: (a + 0.05 * rng.normal(
                     size=a.shape)).astype(np.float32), v)
                 if k.endswith("_t") else v
                 for k, v in cpu.get_params_numpy().items()}
        cpu.set_params(start)
        gpu.set_params(start)
        idx = np.arange(n)
        np.random.default_rng(SEED + 17).shuffle(idx)
        grads = {}
        for label, ln in (("cuda", gpu), ("cpu", cpu)):
            params = tree_to(ln.params, ln.device)
            leaves = [p.requires_grad_(True) for _, p in
                      named_leaves(params)]
            mb = {k: ln._tensor(v[idx[:n // 2]]) for k, v in batch.items()}
            loss, _ = ln._loss_fn(params, mb)
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads[label] = [torch.zeros_like(p).cpu() if g is None
                            else g.cpu() for p, g in zip(leaves, got)]
        m_gpu = gpu.update(batch, num_sgd_iter=1, minibatch_size=n // 2)
        m_cpu = cpu.update(batch, num_sgd_iter=1, minibatch_size=n // 2)
        p_gpu = dict(named_leaves(gpu.get_params_numpy()))
        p_cpu = dict(named_leaves(cpu.get_params_numpy()))
        rows[algo] = {
            "grads_rel": grads_rel(grads["cuda"], grads["cpu"]),
            "metrics_max_rel": max(abs(m_gpu[k] - v) / max(abs(v), 1e-6)
                                   for k, v in m_cpu.items()),
            "params_max_abs_diff": max(float(np.abs(p_gpu[k] - v).max())
                                       for k, v in p_cpu.items()),
            "loss_cuda": m_gpu["loss"], "loss_cpu": m_cpu["loss"]}
        np.testing.assert_allclose(
            [m_gpu[k] for k in sorted(m_cpu)],
            [m_cpu[k] for k in sorted(m_cpu)], atol=1e-4, rtol=1e-4,
            err_msg=f"rl_learners {algo}: metrics")
    emit({"phase": "rl_learners_f32", "batch": 64, "fragment_steps": 8,
          "obs_dim": 8, "n_actions": 4, "hidden": 64, "tol": 1e-4,
          "algorithms": rows})
    bad = {a: r for a, r in rows.items() if r["grads_rel"] > 1e-4}
    if bad:
        raise AssertionError(f"rl_learners: gradients differ: {bad}")


# ------------------------------------------------- phase 15-16: DreamerV3
DREAMER_TOL = 1e-4


def fixed_gumbel(shape) -> np.ndarray:
    """Standard Gumbel noise, fixed per shape (the same at every step)."""
    shape = tuple(int(s) for s in shape)
    u = np.random.default_rng([len(shape), *shape]).uniform(
        np.finfo(np.float32).tiny, 1.0, size=shape)
    return (-np.log(-np.log(u))).astype(np.float32)


def dreamer_batch(seed: int = 3, n: int = 300, rows: int = 8,
                  length: int = 16) -> dict:
    """[rows, length] windows of a seeded random-action CartPole run."""
    from ray_tpu_torch.rl.env import make_env

    env, rng = make_env("CartPole-v1", seed=seed), np.random.default_rng(seed)
    cols = {k: [] for k in ("obs", "actions", "rewards", "dones", "truncs")}
    obs = env.reset()
    for _ in range(n):
        a = int(rng.integers(2))
        nxt, r, term, trunc = env.step(a)
        for k, v in zip(cols, (obs, a, r, float(term),
                               float(trunc and not term))):
            cols[k].append(v)
        obs = env.reset() if term or trunc else nxt
    data = {k: np.asarray(v, np.int64 if k == "actions" else np.float32)
            for k, v in cols.items()}
    starts = rng.integers(0, n - length, size=rows)
    return {k: np.stack([v[s:s + length] for s in starts])
            for k, v in data.items()}


def phase_dreamer_small():
    """One DreamerV3 update (the reference's defaults, f32, TF32 off) on
    CUDA against the CPU from the same params, a seeded CartPole batch and
    the same fixed Gumbel noise through the `gumbel` seam: the metrics
    within 1e-4 and every leaf's gradient within 1e-4 of its largest; the
    params after the update (one Adam step each) are reported."""
    from ray_tpu_torch.rl.dreamerv3 import DreamerV3

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    algos = {"cuda": DreamerV3({"seed": SEED}, device="cuda"),
             "cpu": DreamerV3({"seed": SEED}, device="cpu")}
    algos["cuda"].set_params(algos["cpu"].get_params_numpy())
    batch = dreamer_batch()
    out = {}
    zero_flash_counts()
    for label, algo in algos.items():
        algo.gumbel = lambda shape, d=algo.device: torch.from_numpy(
            fixed_gumbel(shape)).to(d)
        m = algo.update({k: algo._tensor(v) for k, v in batch.items()})
        out[label] = {
            "metrics": {k: float(v) for k, v in m.items()},
            "grads": [p.grad.cpu() for _, p in named_leaves(algo.params)],
            "params": dict(named_leaves(algo.get_params_numpy()))}
    gpu, cpu = out["cuda"], out["cpu"]
    row = {"phase": "dreamer_f32", "batch_rows": 8, "batch_length": 16,
           "horizon": algos["cpu"].cfg["horizon"], "tol": DREAMER_TOL,
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "metrics_cuda": gpu["metrics"], "metrics_cpu": cpu["metrics"],
           "metrics_max_abs_diff": max(abs(gpu["metrics"][k] - v)
                                       for k, v in cpu["metrics"].items()),
           "first_update_grads_rel": grads_rel(gpu["grads"], cpu["grads"]),
           "params_max_abs_diff": max(
               float(np.abs(gpu["params"][k] - v).max())
               for k, v in cpu["params"].items()),
           "flash_launches": flash_counts()}
    emit(row)
    np.testing.assert_allclose(
        [gpu["metrics"][k] for k in sorted(cpu["metrics"])],
        [cpu["metrics"][k] for k in sorted(cpu["metrics"])],
        atol=DREAMER_TOL, rtol=DREAMER_TOL, err_msg="dreamer_f32: metrics")
    if row["first_update_grads_rel"] > DREAMER_TOL:
        raise AssertionError(f"dreamer_f32: gradients differ: {row}")
    if any(row["flash_launches"].values()):
        raise AssertionError("dreamer_f32: a flash kernel ran")


def phase_dreamer_cartpole(card):
    """The reference test's DreamerV3 run (tests/test_rl_extra.py
    `test_dreamerv3_machinery`: CartPole, one env, 256 env steps and 3
    updates a step(), seed 0) on CUDA: six step()s, the world-model loss
    first and last (it must drop), ms a step, then 20 updates timed alone
    (ms an update), 256 env steps of collection timed alone (env steps/s),
    and one update under torch.profiler (device busy share)."""
    from ray_tpu_torch.rl.dreamerv3 import DreamerV3Config
    from ray_tpu_torch.tools.profile_serve import kernel_groups

    config = (DreamerV3Config()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=1)
              .training(train_batch_size=256, updates_per_step=3)
              .debugging(seed=0))
    algo = config.build(device="cuda")
    wm, step_ms, nan = [], [], []
    zero_flash_counts()
    for _ in range(6):
        t0 = time.perf_counter()
        m = algo.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if "learner/wm_loss" in m:
            wm.append(m["learner/wm_loss"])
            nan += [k for k in ("learner/actor_loss", "learner/critic_loss",
                                "learner/entropy") if m[k] != m[k]]
    batch = {k: algo._tensor(v) for k, v in algo._sample_sequences().items()}
    for _ in range(3):
        algo.update(batch)
    torch.cuda.synchronize()
    n_upd = 20
    t0 = time.perf_counter()
    for _ in range(n_upd):
        algo.update(batch)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3 / n_upd
    t0 = time.perf_counter()
    algo._sample_with(algo._policy_logits_fn(), 256)
    collect_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        algo.update(batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels, groups = kernel_groups(prof)
    device_ms = sum(ms for ms, _ in groups.values())
    row = {"phase": "dreamer_cartpole", "card": card, "env": "CartPole-v1",
           "num_env_runners": 1, "train_batch_size": 256,
           "updates_per_step": 3, "steps": 6, "seed": 0,
           "wm_loss": wm, "wm_loss_first": wm[0] if wm else None,
           "wm_loss_last": wm[-1] if wm else None, "step_ms": step_ms,
           "env_steps_per_s_through_step": 6 * 256 / (sum(step_ms) / 1e3),
           "episodes": len(algo._episode_returns),
           "episode_return_mean": float(np.mean(
               algo._episode_returns[-100:])),
           "update_ms": update_ms, "updates_per_s": 1e3 / update_ms,
           "collect_256_s": collect_s, "env_steps_per_s": 256 / collect_s,
           "traced_update_ms": traced_ms, "traced_device_ms": device_ms,
           "traced_device_busy_share": device_ms / traced_ms,
           "traced_launches": sum(n for _, n in groups.values()),
           "traced_groups": {g: {"ms": ms, "launches": n}
                             for g, (ms, n) in sorted(groups.items())},
           "flash_launches": flash_counts()}
    emit(row)
    if len(wm) < 2 or not wm[-1] < wm[0] or nan:
        raise AssertionError(f"dreamer_cartpole: the world-model loss did "
                             f"not drop, or NaN in {nan}: {wm}")
    if not algo._episode_returns or any(row["flash_launches"].values()):
        raise AssertionError(f"dreamer_cartpole: {row}")


# ------------------------------------------- phase 17: the trainer stack
def phase_trainer_350m(card, sharded: dict):
    """`bench-350m` through the trainer stack on one card: the
    `ProcessGroupBackend` forms a one-rank NCCL group (file:// store in a
    temporary directory) over an in-process worker group; `host_broadcast`
    of the state (at world size 1: a copy); `iter_device_batches` feeds
    batch 8 x 2048 from a seeded numpy iterator (its first batch is
    train_350m_sharded's); then a warm-up step and five timed
    `sharded_train_step`s on a data=1 mesh, against train_350m_sharded's
    step in the same run: the warm-up loss equal to its first to the bit,
    24 launches a step of each flash kernel on wgmma, step ms, and one
    traced step's busy share.  The group is left whatever happens."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from ray_tpu_torch.data.iterator import iter_device_batches
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.sharding import tree_map
    from ray_tpu_torch.tools.profile_serve import kernel_groups
    from ray_tpu_torch.train.backend import (LocalWorkerGroup,
                                             ProcessGroupBackend)
    from ray_tpu_torch.train.session import host_broadcast
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, reshard_state,
                                          sharded_train_step)

    cfg = llama.llama_configs()["bench-350m"]
    batch_size, seq, n_timed = 8, 2048, 5
    opt = default_optimizer(total_steps=1000)

    def batches(n):
        rng = np.random.default_rng(SEED)
        for _ in range(n):
            tokens = rng.integers(0, cfg.vocab_size, size=(batch_size, seq))
            yield {"inputs": tokens, "targets": tokens}

    store = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    group = LocalWorkerGroup()
    backend = ProcessGroupBackend(device="cuda",
                                  init_method=f"file://{store}/store",
                                  timeout_s=300.0)
    try:
        t0 = time.perf_counter()
        backend.on_start(group)
        init_s = time.perf_counter() - t0
        pg = {"backend": dist.get_backend(),
              "world_size": dist.get_world_size(),
              "device": torch.cuda.current_device()}
        state = create_train_state(SEED, cfg, opt, device="cuda")
        tree = tree_map(torch.Tensor.detach, state.params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = host_broadcast(tree)
        torch.cuda.synchronize()
        broadcast_ms = (time.perf_counter() - t0) * 1e3
        del tree
        mesh = create_mesh(MeshConfig(data=1), device_type="cuda")
        state = reshard_state(create_train_state(SEED, cfg, opt, "cuda",
                                                 params=params),
                              cfg, opt, mesh)
        del params
        feed_ms = []
        fed = []
        it = iter_device_batches(batches(2 + n_timed), device="cuda",
                                 dtypes={"inputs": np.int64,
                                         "targets": np.int64})
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            if b is None:
                break
            torch.cuda.synchronize()
            feed_ms.append((time.perf_counter() - t0) * 1e3)
            fed.append(b)
        step = sharded_train_step(cfg, opt, mesh)
        state, m = step(state, fed[0])              # warm-up, lr 0
        loss0 = float(m["loss"])
        torch.cuda.synchronize()
        zero_flash_counts()
        losses, norms, step_ms = [], [], []
        for b in fed[1:1 + n_timed]:
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        launches = flash_counts()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step(state, fed[-1])
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        _, groups = kernel_groups(prof)
    finally:
        backend.on_shutdown(group)
        shutil.rmtree(store, ignore_errors=True)
    left = dist.is_initialized()
    del state, step, fed
    gc.collect()
    torch.cuda.empty_cache()
    mean_ms = sum(step_ms) / len(step_ms)
    tps = batch_size * seq / (mean_ms / 1e3)
    device_ms = sum(ms for ms, _ in groups.values())
    row = {"phase": "trainer_350m", "card": card, "model": "bench-350m",
           "dtype": "bfloat16", "batch": batch_size, "seq": seq,
           "process_group": pg, "backend_init_s": init_s,
           "host_broadcast_ms": broadcast_ms,
           "host_broadcast_world_size": pg["world_size"],
           "host_broadcast_bytes": 2 * cfg.num_params(),
           "feed_ms_per_batch": feed_ms,
           "feed_bytes_per_batch": 2 * batch_size * seq * 8,
           "warmup_loss": loss0,
           "train_350m_sharded_first_loss": sharded["loss"][0],
           "loss": losses, "grad_norm": norms, "step_ms": step_ms,
           "mean_step_ms": mean_ms, "tokens_per_s": tps,
           "mfu": tps * cfg.flops_per_token() / BF16_FLOPS,
           "train_350m_sharded_mean_step_ms": sharded["mean_step_ms"],
           "launches": launches,
           "launches_per_step": {n: c / n_timed
                                 for n, c in launches.items()},
           "traced_step_ms": traced_ms, "traced_device_ms": device_ms,
           "traced_device_busy_share": device_ms / traced_ms,
           "traced_groups": {g: {"ms": ms, "launches": n}
                             for g, (ms, n) in sorted(groups.items())},
           "group_left_after_shutdown": not left}
    emit(row)
    if pg["backend"] != "nccl" or pg["world_size"] != 1 or left:
        raise AssertionError(f"trainer_350m: process group {pg}, "
                             f"still initialised: {left}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"trainer_350m: non-finite: {row}")
    if loss0 != sharded["loss"][0]:
        raise AssertionError(f"trainer_350m: warm-up loss {loss0} != "
                             f"train_350m_sharded's {sharded['loss'][0]}")
    if any(c != (0 if n.endswith("/fma") else n_timed * cfg.n_layers)
           for n, c in launches.items()):
        raise AssertionError(f"trainer_350m: flash launches {launches} != "
                             f"{cfg.n_layers} per step, all bf16 routes")
    return launches


# --------------------------------------- phases 18-19: the RL algorithms
RL_ALGORITHMS = ("ppo", "impala", "appo", "dqn", "sac", "bc", "marwil", "cql",
             "multi_agent")
RL_CONFIGS = {"ppo": "PPOConfig", "impala": "IMPALAConfig",
              "appo": "APPOConfig", "dqn": "DQNConfig", "sac": "SACConfig",
              "bc": "BCConfig", "marwil": "MARWILConfig",
              "cql": "CQLConfig", "multi_agent": "MultiAgentPPOConfig"}
RL_OFFLINE = ("bc", "marwil", "cql")
RL_TOL = dict(atol=1e-4, rtol=1e-4)


def kernel_counts() -> dict:
    """Launches of all four kernel wrappers (and the flash routes)."""
    from ray_tpu_torch.ops.paged_attention import paged_decode_attention

    return {**flash_counts(),
            "paged_decode_attention": paged_decode_attention.launches}


def expert_transitions(n_steps: int, seed: int = 3,
                       explore: float = 0.2) -> dict:
    """Logged CartPole transitions of the lean-direction expert with a
    share `explore` of random actions (tests/test_rl_extra.py's
    `_expert_transitions`; with explore 0, tests/test_rl.py's BC data)."""
    from ray_tpu_torch.rl.env import CartPole

    rng = np.random.default_rng(seed)
    env = CartPole(seed=seed)
    cols = {k: [] for k in ("obs", "actions", "rewards", "next_obs",
                            "dones")}
    obs = env.reset()
    for _ in range(n_steps):
        if explore and rng.random() < explore:
            a = int(rng.integers(2))
        else:
            a = int(obs[2] + 0.3 * obs[3] > 0)
        nxt, r, term, trunc = env.step(a)
        for k, v in zip(cols, (obs.copy(), a, r, nxt.copy(), float(term))):
            cols[k].append(v)
        obs = env.reset() if (term or trunc) else nxt
    return {k: np.array(v, np.int64 if k == "actions" else np.float32)
            for k, v in cols.items()}


def rl_config(algo: str):
    import importlib

    from ray_tpu_torch.rl import multi_agent  # noqa: F401 - MultiCartPole

    mod = importlib.import_module(f"ray_tpu_torch.rl.{algo}")
    cfg = getattr(mod, RL_CONFIGS[algo])()
    return cfg.environment("MultiCartPole" if algo == "multi_agent"
                           else "CartPole-v1").debugging(seed=SEED)


def rl_small_config(algo: str):
    """tests/test_torch_rl_algorithms.py's settings: hidden 16, small
    batches, learning_starts reached in the first step, at most two Adam
    steps a step() (DQN: its fixed four, at lr 5e-5)."""
    cfg = rl_config(algo)
    cfg.hidden = 16
    if algo == "ppo":
        return cfg.env_runners(num_env_runners=2).training(
            lr=3e-4, train_batch_size=64, num_sgd_iter=1, minibatch_size=32)
    if algo in ("impala", "appo"):
        cfg = cfg.env_runners(num_env_runners=2).training(
            lr=3e-4, train_batch_size=32)
        return cfg.training(tau=0.1) if algo == "appo" else cfg
    if algo == "dqn":
        return cfg.env_runners(num_env_runners=1).training(
            lr=5e-5, train_batch_size=64, learning_starts=64,
            sgd_batch_size=16, target_update_freq=64,
            epsilon_decay_steps=1000)
    if algo == "sac":
        return cfg.env_runners(num_env_runners=1).training(
            lr=3e-4, train_batch_size=64, learning_starts=64,
            sgd_batch_size=16, updates_per_step=2, tau=0.1)
    if algo == "multi_agent":
        return cfg.env_runners(num_env_runners=1).multi_agent(
            policies=["p0", "p1"],
            policy_mapping={"agent_0": "p0", "agent_1": "p1"}).training(
            lr=3e-4, train_batch_size=32, num_sgd_iter=1, minibatch_size=16)
    cfg = cfg.offline(offline_data=expert_transitions(64)).training(lr=3e-4)
    cfg.eval_episodes = 1
    if algo == "cql":
        return cfg.training(sgd_batch_size=16, updates_per_step=2, tau=0.1)
    return cfg.training(num_sgd_iter=1, minibatch_size=32)


def rl_groups(algo) -> dict:
    """{policy: LearnerGroup} (None for a single-policy algorithm)."""
    return getattr(algo, "learner_groups", None) or \
        {None: algo.learner_group}


def rl_params(algo) -> dict:
    return algo._params_np if hasattr(algo, "learner_groups") \
        else {None: algo._params_np}


def rl_hand(algo, params: dict) -> None:
    """Every learner of `algo`, its numpy copy and (DQN) its frozen
    target params to `params`."""
    for pid, lg in rl_groups(algo).items():
        algo.runtime.get([ln.set_params.remote(params[pid])
                          for ln in lg.learners])
        fresh = lg.get_params_numpy()
        if pid is None:
            algo._params_np = fresh
        else:
            algo._params_np[pid] = fresh
    if hasattr(algo, "_target_params"):
        algo._target_params = algo._params_np


def rl_record(algo, keep: bool = True) -> dict:
    """Each learner-group update's seconds with a device sync and, with
    `keep`, copies of the fragments each sample returns and of every
    batch a learner group updates on."""
    import copy

    log = {"fragments": [], "batches": [], "update_s": []}
    if keep and hasattr(algo, "env_runner_group"):
        sample = algo.env_runner_group.sample

        def rec_sample(*a, **k):
            out = sample(*a, **k)
            log["fragments"].append(copy.deepcopy(out))
            return out

        algo.env_runner_group.sample = rec_sample
    for lg in rl_groups(algo).values():
        def rec_update(batch, *a, _u=lg.update, **k):
            if keep:
                log["batches"].append(copy.deepcopy(
                    algo.runtime.get(batch)))
            t0 = time.perf_counter()
            out = _u(batch, *a, **k)
            torch.cuda.synchronize()
            log["update_s"].append(time.perf_counter() - t0)
            return out

        lg.update = rec_update
    return log


def same_arrays(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(
        np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        and np.array_equal(got[k], want[k]) for k in want)


def same_counts(a: dict, b: dict) -> bool:
    """Equal env steps, episodes and mean return (NaN before any)."""
    return (a["num_env_steps_sampled_lifetime"]
            == b["num_env_steps_sampled_lifetime"]
            and a["env_runners"]["num_episodes"]
            == b["env_runners"]["num_episodes"]
            and np.array_equal(a["episode_return_mean"],
                               b["episode_return_mean"], equal_nan=True))


def phase_rl_algos_small():
    """Each of the nine algorithms' first step() on a LocalRuntime with
    its learners on CUDA, against the same algorithm with its learners on
    the CPU, f32 (TF32 off), from the same initial params (the CPU
    build's, target nets drifted off the online ones as in the tests):
    the fragments and every learner batch equal bit for bit (numpy on the
    host), the counts and mean return equal, the learner metrics and the
    params after the step within 1e-4; no kernel of the port runs."""
    from ray_tpu_torch.parallel.sharding import tree_map
    from ray_tpu_torch.serve.runtime import LocalRuntime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rt = LocalRuntime()
    rows, bad = {}, []
    zero_serve_counts()
    try:
        for name in RL_ALGORITHMS:
            algos = {d: rl_small_config(name).build(runtime=rt, device=d)
                     for d in ("cuda", "cpu")}
            rng = np.random.default_rng(SEED + 99)
            start = {pid: {k: tree_map(lambda a: (a + 0.05 * rng.normal(
                         size=a.shape)).astype(np.float32), v)
                          if k.endswith("_t") else v for k, v in p.items()}
                     for pid, p in rl_params(algos["cpu"]).items()}
            logs, res = {}, {}
            for d, algo in algos.items():
                rl_hand(algo, start)
                logs[d] = rl_record(algo)
                res[d] = algo.step()
            g, c = logs["cuda"], logs["cpu"]
            frags_equal = len(g["fragments"]) == len(c["fragments"]) and \
                all(len(a) == len(b) and all(map(same_arrays, a, b))
                    for a, b in zip(g["fragments"], c["fragments"]))
            batches_equal = len(g["batches"]) == len(c["batches"]) > 0 \
                and all(map(same_arrays, g["batches"], c["batches"]))
            keys = sorted((k for k in res["cpu"] if k.startswith("learner/")),
                          key=lambda k: not k.endswith("loss"))
            pg = dict(named_leaves(rl_params(algos["cuda"])))
            pc = dict(named_leaves(rl_params(algos["cpu"])))
            row = {
                "updates": len(c["batches"]),
                "fragments_bit_equal": frags_equal,
                "batches_bit_equal": batches_equal,
                "counts_equal": same_counts(res["cuda"], res["cpu"]),
                "metrics_max_abs_diff": max(
                    abs(res["cuda"][k] - res["cpu"][k]) for k in keys),
                "params_max_abs_diff": max(
                    float(np.abs(pg[k] - v).max()) for k, v in pc.items()),
                "metrics_ok": bool(np.allclose(
                    [res["cuda"][k] for k in keys],
                    [res["cpu"][k] for k in keys], **RL_TOL)),
                "params_ok": set(pg) == set(pc) and all(
                    np.allclose(pg[k], v, **RL_TOL) for k, v in pc.items()),
                "loss_cuda": res["cuda"][keys[0]], "loss_key": keys[0],
                "loss_cpu": res["cpu"][keys[0]]}
            rows[name] = row
            if not all(row[k] for k in ("fragments_bit_equal",
                                        "batches_bit_equal", "counts_equal",
                                        "metrics_ok", "params_ok")):
                bad.append(name)
            for algo in algos.values():
                algo.cleanup()
    finally:
        rt.shutdown()
    launches = kernel_counts()
    emit({"phase": "rl_algos_f32", "tol": RL_TOL["atol"],
          "tf32": torch.backends.cuda.matmul.allow_tf32, "hidden": 16,
          "kernel_launches": launches, "algorithms": rows})
    if bad or any(launches.values()):
        raise AssertionError(f"rl_algos_f32: {bad} differ, or a kernel "
                             f"ran: {launches}")


def rl_cartpole_configs() -> dict:
    """Each algorithm at its reference test's settings (tests/test_rl.py,
    tests/test_rl_extra.py): CartPole, hidden 64, seed 0; (config,
    step()s)."""
    c = rl_config
    bc = c("bc").training(lr=2e-3, num_sgd_iter=8, minibatch_size=64) \
        .offline(offline_data={k: v for k, v in expert_transitions(
            600, explore=0.0).items() if k in ("obs", "actions")})
    return {
        "ppo": (c("ppo").env_runners(num_env_runners=2).training(
            lr=1e-3, train_batch_size=1024, num_sgd_iter=6,
            minibatch_size=256, entropy_coeff=0.01), 12),
        "impala": (c("impala").env_runners(num_env_runners=2).training(
            lr=2e-3, train_batch_size=512, entropy_coeff=0.01), 3),
        "appo": (c("appo").env_runners(num_env_runners=2).training(
            lr=2e-3, train_batch_size=512, entropy_coeff=0.01,
            clip_param=0.4, kl_coeff=0.2, tau=0.05), 3),
        "dqn": (c("dqn").env_runners(num_env_runners=1).training(
            train_batch_size=128, learning_starts=128, sgd_batch_size=32),
            3),
        "sac": (c("sac").env_runners(num_env_runners=1).training(
            train_batch_size=128, learning_starts=128, sgd_batch_size=32,
            updates_per_step=2), 3),
        "bc": (bc, 3),
        "marwil": (c("marwil").training(
            lr=2e-3, beta=1.0, num_sgd_iter=8, minibatch_size=256)
            .offline(offline_data=expert_transitions(2000)), 3),
        "cql": (c("cql").training(
            lr=2e-3, sgd_batch_size=128, cql_alpha=0.5, updates_per_step=24)
            .offline(offline_data=expert_transitions(2000)), 3),
        "multi_agent": (c("multi_agent").env_runners(num_env_runners=2)
                        .training(lr=3e-3, train_batch_size=512,
                                  num_sgd_iter=6, minibatch_size=128), 3),
    }


def phase_rl_algos_cartpole(card):
    """The nine algorithms at their reference tests' settings, learners
    on the card, env runners as LocalRuntime actors (numpy on the host).
    PPO runs up to 12 step()s and must meet tests/test_rl.py's bar (best
    return >= 60, and best > 1.2 x first or best >= 100); the others run
    3.  Per algorithm: mean time_this_iter_s, steps/s (env steps; offline
    rows for BC, MARWIL and CQL), the learner's ms a step() timed around
    `learner_group.update` with a device sync, first and best return,
    then one more step() under torch.profiler: its kernel launches and
    device busy share (the union of the device intervals over the step's
    wall time).  No kernel of the port may run."""
    from ray_tpu_torch.serve.runtime import LocalRuntime
    from ray_tpu_torch.tools.profile_serve import kernel_groups

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    rt = LocalRuntime()
    rows = {}
    zero_serve_counts()
    try:
        for name, (cfg, n_steps) in rl_cartpole_configs().items():
            algo = cfg.build(runtime=rt, device="cuda")
            log = rl_record(algo, keep=False)
            iters, learner_ms, rets, first, best = [], [], [], None, -1.0
            for _ in range(n_steps):
                n_upd = len(log["update_s"])
                res = algo.step()
                iters.append(res["time_this_iter_s"])
                learner_ms.append(1e3 * sum(log["update_s"][n_upd:]))
                ret = res["episode_return_mean"]
                rets.append(ret)
                if ret == ret:
                    first = ret if first is None else first
                    best = max(best, ret)
                if name == "ppo" and best >= 120.0:
                    break
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                algo.step()
                torch.cuda.synchronize()
                traced_ms = (time.perf_counter() - t0) * 1e3
            _, groups = kernel_groups(prof)
            n_dev = sum(n for _, n in groups.values())
            n_copy = sum(1 for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and e.name.startswith(("Memcpy", "Memset")))
            steps = res["num_env_steps_sampled_lifetime"]
            metrics = {k: v for k, v in res.items()
                       if k.startswith("learner/")}
            rows[name] = {
                "steps": len(iters), "returns": rets, "return_first": first,
                "return_best": best if first is not None else None,
                "iter_s": iters, "iter_s_mean": float(np.mean(iters)),
                "steps_counted": "offline rows" if name in RL_OFFLINE
                else "env steps",
                "steps_per_s": steps / sum(iters),
                "learner_ms_per_step": float(np.mean(learner_ms)),
                "learner_share": float(np.sum(learner_ms)
                                       / (1e3 * np.sum(iters))),
                "traced_step_ms": traced_ms,
                "traced_device_ms": union_ms(prof),
                "traced_busy_share": union_ms(prof) / traced_ms,
                "traced_kernel_launches": n_dev - n_copy,
                "traced_copies": n_copy,
                "finite": all(v == v and abs(v) != float("inf")
                              for v in metrics.values())}
            algo.cleanup()
            emit({"phase": "rl_algos_cartpole", "algorithm": name,
                  "card": card, **rows[name]})
    finally:
        rt.shutdown()
    launches = kernel_counts()
    ppo = rows["ppo"]
    first, best = ppo["return_first"], ppo["return_best"]
    passed = first is not None and best >= 60.0 and (
        best > 1.2 * first or best >= 100.0)
    emit({"phase": "rl_algos_cartpole", "card": card,
          "ppo_bar_met": passed, "kernel_launches": launches,
          "iter_s_mean": {k: r["iter_s_mean"] for k, r in rows.items()},
          "learner_ms_per_step": {k: r["learner_ms_per_step"]
                                  for k, r in rows.items()},
          "busy_share": {k: r["traced_busy_share"] for k, r in rows.items()}})
    broken = [k for k, r in rows.items() if not r["finite"]]
    if not passed or broken or any(launches.values()):
        raise AssertionError(f"rl_algos_cartpole: PPO bar met {passed} "
                             f"(first {first}, best {best}); non-finite "
                             f"metrics in {broken}; kernels {launches}")


# ------------------------------ phases 20-22: the port's own core runtime
CLUSTER_T = 600.0          # every cluster get waits at most this long
CLUSTER_BYTES = 64 << 20   # the put/get probe: a 64 MB bf16 tensor


def cluster_runtime():
    """ClusterRuntime whose gets wait at most CLUSTER_T seconds and whose
    actors answer `where()` with their process id."""
    from ray_tpu_torch.serve.runtime import ClusterRuntime

    class Timed(ClusterRuntime):
        def remote(self, cls):
            class Placed(cls):
                def where(self):
                    import os as _os

                    return _os.getpid()

            return super().remote(Placed)

        def get(self, ref, timeout=None):
            return super().get(ref, timeout=CLUSTER_T if timeout is None
                               else timeout)

    return Timed()


def gpu_apps() -> str:
    """Each process's device memory as nvidia-smi lists it (may be empty
    where the card's processes are not visible)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except Exception as e:  # noqa: BLE001 - report, never fail on it
        return f"unavailable: {e!r}"


class DeviceProbe:
    """An actor of the cluster phases: where it runs and what it sees."""

    def info(self):
        import os as _os

        import ray_tpu_torch as _rt
        import torch as _torch

        if _torch.cuda.is_available():
            _torch.zeros(1, device="cuda")      # the process's context
            _torch.cuda.synchronize()
        return {"pid": _os.getpid(), "gpu_ids": _rt.get_gpu_ids(),
                "cuda_visible": _os.environ.get("CUDA_VISIBLE_DEVICES"),
                "reserved_gb": _torch.cuda.memory_reserved() / 1e9
                if _torch.cuda.is_available() else None}

    def fetch(self, boxed):
        """Get the ref in `boxed` (a list, so the call does not resolve
        it first); returns (seconds, device, the tensor)."""
        import time as _time

        import ray_tpu_torch as _rt
        import torch as _torch

        t0 = _time.perf_counter()
        x = _rt.get(boxed[0], timeout=600.0)
        _torch.cuda.synchronize()
        return _time.perf_counter() - t0, str(x.device), x


def phase_cluster_core(card):
    """The port's runtime on the card (see 20 in the module docstring);
    returns the init seconds."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import api
    from ray_tpu_torch._private.worker import global_worker

    t0 = time.perf_counter()
    rt.init(object_store_memory=8 << 30)
    init_s = time.perf_counter() - t0
    res = rt.cluster_resources()
    core = global_worker()
    ctl, _ = core.call(core.controller_addr, "modules", {}, timeout=60.0)
    agent, _ = core.call(core.agent_addr, "modules", {}, timeout=60.0)

    def plain_probe():
        import os as _os

        import torch as _torch

        return {"pid": _os.getpid(), "cuda": _torch.cuda.is_available(),
                "cuda_visible": _os.environ.get("CUDA_VISIBLE_DEVICES")}

    t0 = time.perf_counter()
    plain = rt.get(rt.remote(plain_probe).remote(), timeout=CLUSTER_T)
    first_task_s = time.perf_counter() - t0
    probe = rt.remote(DeviceProbe).options(num_gpus=1)
    a = probe.remote()
    t0 = time.perf_counter()
    first = rt.get(a.info.remote(), timeout=CLUSTER_T)
    device_first_s = time.perf_counter() - t0
    rt.kill(a)
    b = probe.remote()
    second = rt.get(b.info.remote(), timeout=CLUSTER_T)

    x = torch.randn(CLUSTER_BYTES // 2, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        SEED)).to(torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = rt.put(x)
    put_s = time.perf_counter() - t0
    out = b.fetch.remote([ref])
    t0 = time.perf_counter()
    get_dev_s, dev_where, back = rt.get(out, timeout=CLUSTER_T)
    round_s = time.perf_counter() - t0
    after = rt.get(b.info.remote(), timeout=CLUSTER_T)
    bitwise = (back.dtype == x.dtype and back.shape == x.shape
               and torch.equal(back.view(torch.int16),
                               x.cpu().view(torch.int16)))
    rt.kill(b)
    gb = CLUSTER_BYTES / 1e9
    row = {"phase": "cluster_core", "card": card, "resources": res,
           "init_s": init_s, "first_task_s": first_task_s,
           "device_worker_first_call_s": device_first_s,
           "pids": {"driver": os.getpid(), "controller": ctl["pid"],
                    "agent": agent["pid"], "plain_worker": plain["pid"],
                    "device_worker": [first["pid"], second["pid"]],
                    "heads": sorted(p.pid for p in api._head_processes)},
           "plain_worker": plain, "device_worker": [first, second],
           "head_modules_torch": ["torch" in ctl["modules"],
                                  "torch" in agent["modules"]],
           "tensor_mb": CLUSTER_BYTES / 2**20, "put_s": put_s,
           "put_gbps": gb / put_s, "device_worker_get_s": get_dev_s,
           "device_worker_get_gbps": gb / get_dev_s,
           "device_worker_tensor_device": dev_where,
           "return_and_driver_get_s": round_s,
           "bitwise_equal": bool(bitwise),
           "memory_gb": {"driver_reserved":
                         torch.cuda.memory_reserved() / 1e9,
                         "device_worker_reserved": after["reserved_gb"]},
           "nvidia_smi_apps": gpu_apps()}
    emit(row)
    forbidden = {"jax", "ray_tpu", "zmq", "msgpack", "cloudpickle",
                 "psutil"}
    bad = [n for n, m in (("controller", ctl), ("agent", agent))
           if forbidden & set(m["modules"]) or "torch" in m["modules"]]
    if (res.get("GPU") != 1.0 or bad or plain["cuda"]
            or plain["cuda_visible"] != ""
            or first["pid"] != second["pid"]
            or first["gpu_ids"] != [0] or second["gpu_ids"] != [0]
            or first["pid"] in (plain["pid"], os.getpid())
            or dev_where != "cuda:0" or not bitwise):
        raise AssertionError(f"cluster_core: {row}")
    return init_s


def cluster_prompts(cfg) -> list:
    rng = np.random.default_rng(SEED)
    return [rng.integers(1, cfg.vocab_size,
                         RLHF_350M["prompt_len"]).tolist()
            for _ in range(RLHF_350M["prompts_per_step"])]


def counting_worker():
    """LLMRolloutWorker whose params come as a positional argument (the
    runtime resolves a ref there) and which zeroes and reads the paged
    and flash launch counters of its own process."""
    from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker

    class Counting(LLMRolloutWorker):
        def __init__(self, model, params, **kw):
            super().__init__(model, params=params, **kw)

        def zero_counts(self):
            zero_serve_counts()

        def counts(self):
            return rlhf_counts()

        def reserved_gb(self):
            return torch.cuda.memory_reserved() / 1e9

    return Counting


def phase_cluster_rollout_350m(card):
    """An LLMRolloutWorker as a num_gpus=1 actor at rlhf_350m's settings
    against the same worker in process (see 21 in the module
    docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker

    cfg = llama.llama_configs()["bench-350m"]
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    prompts = cluster_prompts(cfg)
    kw = dict(group_size=RLHF_350M["group_size"],
              max_new_tokens=RLHF_350M["max_new_tokens"],
              temperature=RLHF_350M["temperature"])
    engine = dict(RLHF_350M["engine"])

    zero_serve_counts()
    w = LLMRolloutWorker(cfg, params=params, seed=SEED, engine=engine)
    local, local_s = [], []
    try:
        for _ in range(2):                     # warm-up (capture), timed
            t0 = time.perf_counter()
            local.append(w.rollout(prompts, **kw))
            local_s.append(time.perf_counter() - t0)
    finally:
        w.stop()
    local_counts = rlhf_counts()
    del w
    gc.collect()
    torch.cuda.empty_cache()

    params_gb = sum(t.numel() * t.element_size()
                    for t in _tensor_leaves(params)) / 1e9
    crt = cluster_runtime()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = crt.put(params)
    put_s = time.perf_counter() - t0
    del params
    t0 = time.perf_counter()
    actor = crt.remote(counting_worker()).options(num_gpus=1).remote(
        cfg, ref, seed=SEED, engine=engine)
    crt.get(actor.zero_counts.remote())
    build_s = time.perf_counter() - t0
    remote, remote_s = [], []
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            remote.append(crt.get(actor.rollout.remote(prompts, **kw)))
            remote_s.append(time.perf_counter() - t0)
        remote_counts = crt.get(actor.counts.remote())
        dev_pid = crt.get(actor.where.remote())
        dev_gb = crt.get(actor.reserved_gb.remote())
    finally:
        crt.get(actor.stop.remote())
        crt.kill(actor)
    keys = ("tokens", "mask", "prompt_len", "total_len")
    same = all(np.array_equal(a[k], b[k]) for a, b in zip(local, remote)
               for k in keys)
    want = ("paged_decode_attention", "flash_attention_fwd/wgmma")
    tokens = [int(t["rollout_tokens"]) for t in remote]
    row = {"phase": "cluster_rollout_350m", "card": card,
           "model": "bench-350m", "dtype": "bfloat16",
           "prompts": [len(p) for p in prompts], **kw, "engine": engine,
           "params_put_s": put_s,
           "params_gb": params_gb,
           "actor_build_s": build_s, "device_worker_pid": dev_pid,
           "rollout_s": {"in_process": local_s, "actor": remote_s},
           "gen_s": {"in_process": [t["gen_s"] for t in local],
                     "actor": [t["gen_s"] for t in remote]},
           "completion_tokens": tokens,
           "completion_tokens_per_s": {
               "in_process": tokens[1] / local_s[1],
               "actor": tokens[1] / remote_s[1]},
           "tokens_equal": bool(same),
           "launches": {"in_process": {k: local_counts[k] for k in want},
                        "device_worker": {k: remote_counts[k]
                                          for k in want}},
           "memory_gb": {"driver_reserved":
                         torch.cuda.memory_reserved() / 1e9,
                         "device_worker_reserved": dev_gb},
           "nvidia_smi_apps": gpu_apps()}
    emit(row)
    if (not same or dev_pid == os.getpid()
            or any(local_counts[k] == 0 or local_counts[k]
                   != remote_counts[k] for k in want)):
        raise AssertionError(f"cluster_rollout_350m: {row}")
    return remote_counts, dev_pid


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def phase_cluster_rl_cartpole(card, device_pid: int):
    """PPO at rl_algos_cartpole's settings through ClusterRuntime against
    LocalRuntime (see 22 in the module docstring); `device_pid` is the
    device worker's."""
    from ray_tpu_torch.serve.runtime import LocalRuntime

    n_steps = 3
    rows = {}
    local_rt = LocalRuntime()
    try:
        for name, rtm in (("local", local_rt),
                          ("cluster", cluster_runtime())):
            cfg = rl_cartpole_configs()["ppo"][0].learners(
                num_gpus_per_learner=1)
            algo = cfg.build(runtime=rtm, device="cuda")
            try:
                res, ms = [], []
                for _ in range(n_steps):
                    t0 = time.perf_counter()
                    res.append(algo.step())
                    ms.append((time.perf_counter() - t0) * 1e3)
                where = None
                if name == "cluster":
                    where = {
                        "learner": [rtm.get(h.where.remote()) for h in
                                    algo.learner_group.learners],
                        "env_runners": [rtm.get(h.where.remote()) for h in
                                        algo.env_runner_group.runners]}
            finally:
                algo.cleanup()
            rows[name] = {"step_ms": ms, "results": res, "pids": where}
    finally:
        local_rt.shutdown()
    first = {k: (rows["local"]["results"][0][k],
                 rows["cluster"]["results"][0][k])
             for k in rows["local"]["results"][0]
             if k.startswith("learner/")
             or k in ("episode_return_mean",
                      "num_env_steps_sampled_lifetime")}
    diffs = {k: abs(float(a) - float(b)) for k, (a, b) in first.items()}
    worst = max(rel_diff(a, b) for a, b in first.values())
    row = {"phase": "cluster_rl_cartpole", "card": card, "algorithm": "ppo",
           "step_ms": {k: r["step_ms"] for k, r in rows.items()},
           "step_ms_after_first": {
               k: float(np.mean(r["step_ms"][1:])) for k, r in rows.items()},
           "first_step": {k: [float(a), float(b)]
                          for k, (a, b) in first.items()},
           "first_step_abs_diff": diffs, "first_step_worst_rel": worst,
           "pids": {"driver": os.getpid(), "device_worker": device_pid,
                    **rows["cluster"]["pids"]}}
    emit(row)
    pids = rows["cluster"]["pids"]
    if (worst > 1e-4 or pids["learner"] != [device_pid]
            or device_pid in pids["env_runners"]
            or os.getpid() in pids["env_runners"]):
        raise AssertionError(f"cluster_rl_cartpole: {row}")


COLLECTIVE_BYTES = 64 << 20      # each op's tensor: 64 MB


def collective_member():
    """A member of the cluster_collective group: it makes its own 64 MB
    integer-valued tensor (on CUDA in the device worker), runs one
    collective on it with the tracer armed, and checks the result against
    the host reduction of every rank's tensor bit for bit."""
    class Member:
        def init_collective_group(self, world_size, rank, backend,
                                  group_name):
            from ray_tpu_torch import collective as c

            c.init_collective_group(world_size, rank, backend, group_name,
                                    timeout_s=300.0)
            self.rank, self.world = rank, world_size
            return rank

        @staticmethod
        def tensor(rank, dtype, device="cpu"):
            import torch as _t

            dt = getattr(_t, dtype)
            n = COLLECTIVE_BYTES // _t.empty(0, dtype=dt).element_size()
            return ((_t.arange(n, device=device) % 7) + rank + 1).to(dt)

        def run(self, op, dtype):
            import time as _time

            import torch as _t

            from ray_tpu_torch import collective as c
            from ray_tpu_torch import profiling

            dev = "cuda" if _t.cuda.is_available() else "cpu"
            mine = self.tensor(self.rank, dtype, dev)
            if dev == "cuda":
                _t.cuda.synchronize()
            allx = [self.tensor(r, dtype) for r in range(self.world)]
            t0 = _time.perf_counter()
            with profiling.collective_trace() as rec:
                if op == "allreduce":
                    out = c.allreduce(mine, "cc")
                elif op == "allgather":
                    out = c.allgather(mine, "cc")
                elif op == "reducescatter":
                    out = c.reducescatter(mine, "cc")
                else:
                    out = c.broadcast(mine if self.rank == 0 else None, 0,
                                      "cc")
            secs = _time.perf_counter() - t0
            total = _t.stack([x.double() for x in allx]).sum(0)
            if op == "allreduce":
                want = [total.to(mine.dtype)]
                got = [out]
            elif op == "allgather":
                want, got = allx, out
            elif op == "reducescatter":
                want = [_t.tensor_split(total, self.world)[self.rank]
                        .to(mine.dtype)]
                got = [out]
            else:
                want, got = [allx[0]], [out]
            same = all(g.device.type == "cpu" and g.dtype == w.dtype
                       and _t.equal(g, w) for g, w in zip(got, want))
            return {"ok": bool(same), "s": secs,
                    "trace": profiling.collective_breakdown_us(rec),
                    "device": dev}

    return Member


def schedule_bytes(nbytes: int, itemsize: int, w: int) -> dict:
    """The bytes each rank sends, by op, for one tensor of `nbytes` on
    every rank of a world of `w`: the ring splits the flat tensor into w
    chunks (tensor_split: sizes differ by one element at most); at world
    3 the tree broadcast's source sends the tensor to each of its two
    children.  Allreduce: every chunk but the rank's own in the
    reduce-scatter, every chunk but its successor's in the allgather,
    2N(w-1)/w up to the split; reducescatter N(w-1)/w; allgather
    N(w-1)."""
    n = nbytes // itemsize
    c = [len(x) * itemsize
         for x in torch.tensor_split(torch.empty(n, dtype=torch.uint8), w)]
    return {"allreduce": [2 * nbytes - c[r] - c[(r + 1) % w]
                          for r in range(w)],
            "reducescatter": [nbytes - c[r] for r in range(w)],
            "allgather": [nbytes * (w - 1)] * w,
            "broadcast": [2 * nbytes] + [0] * (w - 1)}


def phase_cluster_collective(card, device_pid: int):
    """Collectives over the object plane on the card (see 23 in the
    module docstring)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import collective as col

    crt = cluster_runtime()
    member = crt.remote(collective_member())
    ws = [member.options(num_gpus=0.25, num_cpus=0).remote(),
          member.options(num_cpus=0.5).remote(),
          member.options(num_cpus=0.5).remote()]
    try:
        col.create_collective_group(ws, 3, [0, 1, 2], group_name="cc",
                                    timeout=CLUSTER_T)
        pids = [crt.get(w.where.remote()) for w in ws]
        rows, bad = {}, []
        n = COLLECTIVE_BYTES
        for dtype in ("float32", "bfloat16"):
            sent = schedule_bytes(n, torch.empty(
                0, dtype=getattr(torch, dtype)).element_size(), 3)
            for op in ("allreduce", "allgather", "reducescatter",
                       "broadcast"):
                res = crt.get([w.run.remote(op, dtype) for w in ws])
                secs = max(r["s"] for r in res)
                row = {"s": [r["s"] for r in res],
                       "gb_per_s": n / secs / 1e9,
                       "schedule": res[0]["trace"].get("schedule"),
                       "sent_bytes": [r["trace"].get("sent_bytes")
                                      for r in res],
                       "recv_bytes": [r["trace"].get("recv_bytes")
                                      for r in res],
                       "phases_us": [{k: r["trace"].get(k) for k in (
                           "send_us", "pull_us", "reduce_us", "wait_us",
                           "total_us")} for r in res],
                       "equal": [r["ok"] for r in res],
                       "devices": [r["device"] for r in res]}
                rows[f"{op}/{dtype}"] = row
                row["schedule_bytes"] = sent[op]
                if not all(row["equal"]) or \
                        row["sent_bytes"] != sent[op]:
                    bad.append(f"{op}/{dtype}")
    finally:
        for w in ws:
            rt.kill(w)
        col.destroy_collective_group("cc")
    row = {"phase": "cluster_collective", "card": card, "world": 3,
           "bytes": COLLECTIVE_BYTES,
           "pids": {"members": pids, "device_worker": device_pid},
           "ops": rows}
    emit(row)
    if bad or pids[0] != device_pid or device_pid in pids[1:] \
            or rows["allreduce/float32"]["devices"] != ["cuda", "cpu",
                                                        "cpu"]:
        raise AssertionError(f"cluster_collective: {bad} {row}")


def cluster_rlhf_worker():
    """The recording rollout worker, counting the kernels of its own
    process and armable at a failpoint site, for the cluster phase."""
    class Worker(recording_worker()):
        def zero_counts(self):
            zero_serve_counts()

        def counts(self):
            return rlhf_counts()

        def arm(self, site, action):
            from ray_tpu_torch._private import failpoints

            failpoints.arm(site, action)

    return Worker


def flushed_counter(name: str) -> dict:
    """Counter `name` summed over every process's last metrics flush to
    the controller's KV, by its tags."""
    from ray_tpu_torch._private.worker import global_worker

    core = global_worker()
    reply, _ = core.call(core.controller_addr, "kv_keys",
                         {"ns": "metrics"}, timeout=60.0)
    out: dict = {}
    for key in reply["keys"]:
        r, blobs = core.call(core.controller_addr, "kv_get",
                             {"ns": "metrics", "key": key}, timeout=60.0)
        if not r["found"]:
            continue
        for m in json.loads(bytes(blobs[0]))["metrics"]:
            if m["name"] == name:
                for v in m["values"]:
                    tag = json.dumps(v["tags"], sort_keys=True)
                    out[tag] = out.get(tag, 0.0) + v["value"]
    return out


def sync_split(spans: list, tid: str) -> dict:
    """One weight sync's split from its trace: the learner's pack, each
    rank's broadcast (collective.broadcast:0) ms, and the sync's wall."""
    trace = [s for s in spans if s["tid"] == tid]
    ms = lambda s: (s["t1"] - s["t0"]) * 1e3          # noqa: E731
    sync = [s for s in trace if s["name"] == "rl.weight_sync"]
    return {"sync_ms": ms(sync[0]) if sync else None,
            "pack_ms": [ms(s) for s in trace
                        if s["name"] == "collective.pack"],
            "broadcast_ms": {s["attrs"].get("rank"): ms(s) for s in trace
                             if s["name"] == "collective.broadcast:0"},
            "spans": len(trace)}


def phase_cluster_rlhf_actors_350m(card, device_pid: int, local: dict,
                                   local_first: dict):
    """rlhf_actors_350m through ClusterRuntime (see 24 in the module
    docstring); `local` and `local_first` are the LocalRuntime phase's
    launches and first step."""
    import shutil
    import tempfile

    from ray_tpu_torch import tracing
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rl.rlhf import RLHFConfig, RLHFTrainer
    from ray_tpu_torch.train.step import param_leaves

    cfg = llama.llama_configs()["bench-350m"]
    n_timed = 4
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    packed = sum(t.numel() * t.element_size() for t in param_leaves(params))
    crt = cluster_runtime()

    def trainer(**kw):
        return RLHFTrainer(RLHFConfig(
            model=cfg, params=params, seed=SEED, num_rollout_workers=2,
            remote_learner=True, runtime=crt,
            worker_cls=cluster_rlhf_worker(), **RLHF_350M, **kw))

    def row_of(tr, m, step_s):
        r = m["rollout"]
        return {"step_s": step_s, "rollout_s": r["gen_s_max"],
                "swap_ms": swap_ms(crt, tr.workers),
                "completion_tokens": r["rollout_tokens"],
                "rollout_tokens_per_s": r["rollout_tokens"]
                / r["gen_s_max"],
                "update_s": m["update_s"],
                "weight_sync_ms": m["step_weight_sync_ms"],
                "versions": wait_swapped(crt, tr.workers, m["version"]),
                "loss": m["loss"]}

    t0 = time.perf_counter()
    tr = trainer()
    build_s = time.perf_counter() - t0
    try:
        pids = {"learner": crt.get(tr.learner.where.remote()),
                "workers": [crt.get(w.where.remote()) for w in tr.workers]}
        t0 = time.perf_counter()
        m = tr.step()                                    # warm-up
        warm = row_of(tr, m, time.perf_counter() - t0)
        first = first_step(crt, tr, m)
        crt.get(tr.workers[0].zero_counts.remote())
        tracing.harvest(clear_buffers=True, timeout=120.0)
        steps = []
        for _ in range(n_timed):
            t0 = time.perf_counter()
            m = tr.step()
            steps.append(row_of(tr, m, time.perf_counter() - t0))
        launches = crt.get(tr.workers[0].counts.remote())
        spans, diag = tracing.harvest(timeout=120.0, with_diagnostics=True)
        syncs = [sync_split(spans, s["tid"]) for s in spans
                 if s["name"] == "rl.weight_sync"]
        names = sorted({s["name"] for s in spans})
        tokens_all = warm["completion_tokens"] + sum(
            s_["completion_tokens"] for s_ in steps)
        deadline = time.monotonic() + 30.0
        while True:
            counted = flushed_counter("rl_rollout_tokens")
            if sum(counted.values()) >= tokens_all or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.5)
        stats = tr.stats()
    finally:
        tr.shutdown()
        del tr
        gc.collect()

    # One crash run at 2 steps: a rollout actor killed at rollout entry
    # (`rl.rollout_step` crash) takes its whole process down, which on
    # this runtime is the device worker with every actor of the topology.
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_cluster_rlhf_")
    tr = trainer(checkpoint_every=1, checkpoint_dir=ckpt)
    try:
        tr.step()
        tr.flush_checkpoints()
        crt.get(tr.workers[0].arm.remote("rl.rollout_step", "nth:1+crash"))
        t0 = time.perf_counter()
        m = tr.step()
        crash = {"step_s": time.perf_counter() - t0,
                 "version": m["version"],
                 "rollout_regens": m["rollout_regens"],
                 "learner_restarts": m["learner_restarts"],
                 "loss_finite": math.isfinite(m["loss"]),
                 "worker_versions": wait_swapped(crt, tr.workers,
                                                 tr.stats()["version"]),
                 "version_after": tr.stats()["version"],
                 "pids_after": [crt.get(w.where.remote())
                                for w in tr.workers]}
    finally:
        tr.shutdown()
        del tr
        gc.collect()
        shutil.rmtree(ckpt, ignore_errors=True)
    del params
    torch.cuda.empty_cache()

    def mean(key):
        return sum(s_[key] for s_ in steps) / len(steps)

    tok_same = len(first["tokens"]) == len(local_first["tokens"]) and all(
        np.array_equal(a, b) for a, b in zip(first["tokens"],
                                             local_first["tokens"]))
    metric_diff = {k: abs(first["metrics"][k] - local_first["metrics"][k])
                   for k in FIRST_STEP_KEYS}
    adv_diff = float(np.abs(first["advantages"]
                            - local_first["advantages"]).max())
    want = ("paged_decode_attention", "flash_attention_fwd/wgmma",
            "flash_attention_bwd_dq/wgmma", "flash_attention_bwd_dkv/wgmma")
    row = {"phase": "cluster_rlhf_actors_350m", "card": card,
           "model": "bench-350m", "dtype": "bfloat16", "workers": 2,
           "remote_learner": True, "runtime": "ClusterRuntime",
           "config": dict(RLHF_350M), "build_s": build_s,
           "pids": {**pids, "device_worker": device_pid,
                    "driver": os.getpid()},
           "warmup_step": warm, "steps": steps,
           "mean": {k: mean(k) for k in (
               "step_s", "rollout_s", "rollout_tokens_per_s", "update_s",
               "weight_sync_ms")},
           "packed_bytes": packed, "syncs": syncs,
           "first_step": {"tokens_equal": bool(tok_same),
                          "metrics_abs_diff": metric_diff,
                          "advantages_abs_diff": adv_diff,
                          "rollout_tokens": [first["rollout_tokens"],
                                             local_first["rollout_tokens"]]},
           "launches": {k: launches.get(k) for k in launches},
           "launches_local_runtime": {k: local.get(k) for k in want},
           "harvested_span_names": names,
           "harvest_dropped": diag["dropped_total"],
           "harvest_errors": diag["errors"],
           "rl_rollout_tokens_flushed": counted,
           "completion_tokens_all_steps": tokens_all,
           "stats": {k: stats[k] for k in ("weight_syncs", "epoch",
                                           "rollout_regens")},
           "crash_rollout_worker": crash}
    emit(row)
    if (pids["learner"] != device_pid
            or pids["workers"] != [device_pid] * 2):
        raise AssertionError(f"cluster_rlhf_actors_350m: pids {pids}")
    if not tok_same or max(metric_diff.values()) > 1e-4 \
            or adv_diff > 1e-4:
        raise AssertionError(f"cluster_rlhf_actors_350m: first step "
                             f"{row['first_step']}")
    if any(launches.get(k) != local.get(k) for k in want) \
            or any(launches.get(k) for k in launches if k.endswith("/fma")):
        raise AssertionError(f"cluster_rlhf_actors_350m: launches "
                             f"{launches} against {local}")
    if packed != 889_292_800 or len(syncs) != n_timed \
            or any(len(x["pack_ms"]) != 1 or len(x["broadcast_ms"]) != 3
                   for x in syncs):
        raise AssertionError(f"cluster_rlhf_actors_350m: syncs {syncs}")
    for s_ in steps + [warm]:
        if s_["versions"] != [s_["versions"][0]] * 2 or \
                not math.isfinite(s_["loss"]):
            raise AssertionError(f"cluster_rlhf_actors_350m: step {s_}")
    if sum(counted.values()) != tokens_all:
        raise AssertionError(f"cluster_rlhf_actors_350m: rl_rollout_tokens "
                             f"{counted} against {tokens_all}")
    if (crash["rollout_regens"] < 1 or not crash["loss_finite"]
            or crash["worker_versions"] != [crash["version_after"]] * 2
            or crash["version_after"] < 1
            or len(set(crash["pids_after"])) != 1):
        raise AssertionError(f"cluster_rlhf_actors_350m: crash {crash}")
    return launches


def serve_replica():
    """LLMServer of phase cluster_serve_8b: drops the device worker's
    cached blocks before it builds, times its own construction, and
    zeroes and reads the paged and flash launch counters of its own
    process."""
    from ray_tpu_torch.serve.llm import LLMServer

    class Counting(LLMServer):
        def __init__(self, *a, **kw):
            import os as _os
            import time as _time

            torch.cuda.empty_cache()
            self.reserved_before_gb = torch.cuda.memory_reserved() / 1e9
            t0 = _time.perf_counter()
            super().__init__(*a, **kw)
            torch.cuda.synchronize()
            self.init_s = _time.perf_counter() - t0
            self.pid = _os.getpid()

        def zero_counts(self):
            zero_serve_counts()

        def counts(self):
            torch.cuda.synchronize()
            return launch_counts()

        def where(self):
            from ray_tpu_torch import serve as _serve

            return {"pid": self.pid, "init_s": self.init_s,
                    "replica_tag": _serve.get_replica_context().replica_tag,
                    "device": str(self.engine.device),
                    "reserved_before_gb": self.reserved_before_gb,
                    "reserved_gb": torch.cuda.memory_reserved() / 1e9}

    return Counting


def phase_cluster_serve_8b(card, in_process: dict):
    """`LLMServer` on the port's serve (see 25 in the module docstring);
    `in_process` is 4c's second return value.  Boots the port's cluster
    when none is up, so a short script can call it after 4c alone."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.actor import ActorHandle
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.controller import (CONTROLLER_NAME,
                                                REPLICA_INIT_TIMEOUT_S)

    cfg = llama.llama_configs()["llama3-8b"]
    V, new = cfg.vocab_size, 64
    rng = np.random.default_rng(SEED + 16)
    prompts = [rng.integers(1, V, size=n).tolist() for n in MAIN_PROMPTS]
    warm = rng.integers(1, V, size=300).tolist()
    if not rt.is_initialized():
        rt.init(object_store_memory=8 << 30)
    # Where the device worker is, and what it holds, before the deploy.
    probe = rt.remote(DeviceProbe).options(num_gpus=1).remote()
    before = rt.get(probe.info.remote(), timeout=CLUSTER_T)
    rt.kill(probe)

    def call(h, *args, method=None):
        if method is not None:
            h = h.options(method_name=method)
        return h.remote(*args).result(timeout_s=CLUSTER_T)

    app = serve.deployment(serve_replica()).options(
        name="llm", num_replicas=1,
        ray_actor_options={"num_gpus": 1}).bind(
            "llama3-8b", seed=SEED, max_batch=8, page_size=512)
    t0 = time.perf_counter()
    serve.start()
    # Past the controller's init deadline the replica is replaced in a
    # loop: the run's own deadline then fails the phase.
    h = serve.run(app, name="llm8b", timeout_s=REPLICA_INIT_TIMEOUT_S + 30)
    deploy_s = time.perf_counter() - t0
    tag = None
    try:
        where = call(h, method="where")
        tag = where["replica_tag"]
        K = 8
        call(h, {"prompt": warm, "max_new_tokens": K + 1})
        alone = [call(h, {"prompt": p, "max_new_tokens": new})["tokens"]
                 for p in alone_prompts(V)]
        call(h, method="zero_counts")
        t0 = time.perf_counter()
        resps = [h.remote({"prompt": p, "max_new_tokens": new})
                 for p in prompts]
        res = [r.result(timeout_s=CLUSTER_T) for r in resps]
        wave_s = time.perf_counter() - t0
        launches = call(h, method="counts")
        after = call(h, method="where")
        rm = serve.replica_metrics("llm8b", deployment="llm")
        (metrics,) = rm["llm8b"]["llm"].values()
        status = serve.status()["llm8b"]
    finally:
        t0 = time.perf_counter()
        serve.delete("llm8b")
        serve.shutdown()
        teardown_s = time.perf_counter() - t0

    def gone(ref) -> bool:
        try:
            rt.get(ref, timeout=60.0)
        except rt.ActorError:
            return True
        return False

    controller_gone = False
    try:
        rt.get_actor(CONTROLLER_NAME)
    except ValueError:
        controller_gone = True
    replica_gone = gone(ActorHandle(tag).get_queue_len.remote())
    ref_wave = in_process["fresh_wave"]
    # The controller's span from the replica's creation to RUNNING, the
    # one its init deadline bounds; the build alone is `where["init_s"]`.
    init_s = status["deployments"]["llm"]["replica_init_s"][tag[:12]]
    want = ("paged_decode_attention", "flash_attention_fwd/wgmma")
    row = {"phase": "cluster_serve_8b", "card": card, "model": "llama3-8b",
           "dtype": "bfloat16", "max_batch": 8, "page_size": 512,
           "steps_per_sync": K, "new_tokens_each": new,
           "deploy_s": deploy_s, "replica_init_s": init_s,
           "replica_init_deadline_s": REPLICA_INIT_TIMEOUT_S,
           "replica_build_s": where["init_s"],
           "pids": {"replica": where["pid"],
                    "device_worker": before["pid"], "driver": os.getpid()},
           "replica_device": where["device"],
           "memory_gb": {"device_worker_reserved_before_deploy":
                         before["reserved_gb"],
                         "replica_reserved_before_init":
                             where["reserved_before_gb"],
                         "replica_reserved_after_init":
                             where["reserved_gb"],
                         "replica_reserved_after_wave":
                             after["reserved_gb"],
                         "driver_reserved":
                             torch.cuda.memory_reserved() / 1e9},
           "alone": {"prompt_tokens": [len(p) for p in alone_prompts(V)],
                     "same_tokens_as_in_process": alone
                         == in_process["alone_tokens"],
                     "tokens": [len(t) for t in alone]},
           "wave": {**wave_row(res, wave_s),
                    "ttft_each_s": [r["ttft_s"] for r in res],
                    "completed": [len(r["tokens"]) for r in res],
                    "in_process_fresh_wave": ref_wave},
           "launches": {"replica": launches,
                        "in_process_fresh_wave": ref_wave["launches"]},
           "user_stats_completed": metrics["user_stats"]["completed"],
           "replica_metrics": {k: metrics[k] for k in (
               "num_processed", "num_rejected", "max_ongoing")},
           "status": status, "teardown_s": teardown_s,
           "controller_gone": controller_gone,
           "replica_gone": replica_gone}
    emit(row)
    if where["pid"] != before["pid"] or where["pid"] == os.getpid() \
            or torch.device(where["device"]).type != "cuda" \
            or not where["init_s"] <= init_s < REPLICA_INIT_TIMEOUT_S:
        raise AssertionError(f"cluster_serve_8b: placement {row['pids']}, "
                             f"init {where}")
    if not row["alone"]["same_tokens_as_in_process"] \
            or row["alone"]["tokens"] != [new, new]:
        raise AssertionError(f"cluster_serve_8b: alone {alone} against "
                             f"{in_process['alone_tokens']}")
    if row["wave"]["completed"] != [new] * len(prompts) \
            or row["user_stats_completed"] != 1 + 2 + len(prompts):
        raise AssertionError(f"cluster_serve_8b: wave {row['wave']}, "
                             f"completed {row['user_stats_completed']}")
    if any(not launches.get(k) for k in want) \
            or launches.get("flash_attention_fwd/fma") \
            or launches["flash_attention_fwd/wgmma"] \
            != launches["flash_attention_fwd"]:
        raise AssertionError(f"cluster_serve_8b: launches {launches}")
    if not (controller_gone and replica_gone):
        raise AssertionError(f"cluster_serve_8b: teardown controller gone "
                             f"{controller_gone}, replica gone "
                             f"{replica_gone}")
    return launches


def rel_diff(a, b) -> float:
    a, b = float(a), float(b)
    if a != a and b != b:
        return 0.0
    return abs(a - b) / max(1.0, abs(b))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch import _kernels

    card = card_line()
    print(card, flush=True)
    t_start = t0 = time.perf_counter()
    built = _kernels.build_all()
    ptxas = {n: ptxas_report(_kernels.nvcc_log(n)) for n in _kernels.SOURCES}
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": built,
          "build_wall_s": time.perf_counter() - t0,
          "spilling": {n: r["spilling"] for n, r in ptxas.items()},
          "registers": {n: r["registers"] for n, r in ptxas.items()},
          "ptxas_warnings": {n: r["warnings"] for n, r in ptxas.items()}})

    timer = Timer()
    rows = phase_kernels(timer)
    del timer
    small = phase_engine_small()
    small_dense = phase_engine_small_dense()
    from ray_tpu_torch.models import llama

    cfg8 = llama.llama_configs()["llama3-8b"]
    t0 = time.perf_counter()
    params8 = llama.init_params(
        cfg8, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    serve = phase_serve_8b(card, cfg8, params8, time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_8b_engine(card, cfg8, params8)
    gc.collect()
    torch.cuda.empty_cache()
    server, server_alone = phase_serve_8b_server(card, cfg8, params8)
    dense8 = phase_serve_8b_dense(card, cfg8, params8)
    gc.collect()
    torch.cuda.empty_cache()
    observed = phase_serve_8b_observed(card, cfg8, params8)
    del params8
    gc.collect()
    torch.cuda.empty_cache()
    train_small = phase_train_small()
    train = phase_train_350m(card)
    sharded = phase_train_350m_sharded(card)
    gc.collect()
    torch.cuda.empty_cache()
    rlhf_small = phase_rlhf_small()
    rlhf, rlhf_mean = phase_rlhf_350m(card)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_small = phase_rlhf_mesh_small()
    mesh350 = phase_rlhf_mesh_learner_350m(card)
    actors_small = phase_rlhf_actors_small()
    actors, actors_first = phase_rlhf_actors_350m(card, rlhf_mean)
    gc.collect()
    torch.cuda.empty_cache()
    moe_small = phase_moe_small()
    mixtral = phase_train_mixtral_4l(card)
    gc.collect()
    torch.cuda.empty_cache()
    vit_small = phase_vit_small()
    phase_resnet_small()
    vit_b16 = phase_train_vit_b16(card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_resnet18(card)
    phase_rl_learners()
    phase_dreamer_small()
    phase_dreamer_cartpole(card)
    trainer = phase_trainer_350m(card, sharded)
    phase_rl_algos_small()
    phase_rl_algos_cartpole(card)
    gc.collect()
    torch.cuda.empty_cache()
    import ray_tpu_torch

    try:
        phase_cluster_core(card)
        cluster_rollout, device_pid = phase_cluster_rollout_350m(card)
        phase_cluster_rl_cartpole(card, device_pid)
        phase_cluster_collective(card, device_pid)
        cluster_rlhf = phase_cluster_rlhf_actors_350m(
            card, device_pid, actors, actors_first)
        gc.collect()
        torch.cuda.empty_cache()
        cluster_serve = phase_cluster_serve_8b(card, server_alone)
    finally:
        ray_tpu_torch.shutdown()

    def entry(name, kernel, src, replaces, launches, row, part=None,
              errs=()):
        e = {"name": name, "kernel": kernel, "route": "cuda",
             "source": "ray_tpu_torch/csrc/" + src, "replaces": replaces,
             "dtype": row["dtype"], "launches": launches,
             "case": row["case"], "card": card}
        if part is None:
            e.update({k: row[k] for k in (
                "max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")})
        else:
            e.update({
                "max_abs_err": max(row["max_abs_err"][x] for x in errs),
                "rel_err": max(row["rel_err"][x] for x in errs),
                "tol_rel": row["tol_rel"], "ms": row[f"{part}_ms"],
                "plain_ms": row["plain_ms"],
                "bound_ms": row[f"{part}_bound_ms"],
                "bound_by": row[f"{part}_bound_by"],
                "library_ms": row["library_ms"],
                "plain_and_library_cover": "dq, dk and dv together",
                "fused_bound_ms": row["fused_bound_ms"]})
        return e

    fwd, bwd, paged = rows["fwd"], rows["bwd"], rows["paged"]
    fa_py = "ray_tpu/ops/flash_attention.py"
    kernels = [
        entry("paged_decode_attention", "paged_decode_split_kernel",
              "paged_decode.cu", "ray_tpu/ops/paged_attention.py:53",
              serve["paged_decode_attention"], paged["8b_decode_window"]),
        entry("flash_attention_fwd", "flash_fwd_wgmma_kernel",
              "flash_fwd.cu", f"{fa_py}:38",
              serve["flash_attention_fwd/wgmma"], fwd["8b_wave_bucket1024"]),
        entry("flash_attention_fwd", "flash_fwd_kernel", "flash_fwd.cu",
              f"{fa_py}:38", small["flash_attention_fwd/fma"],
              fwd["f32_debug_train"]),
        entry("flash_attention_bwd_dq", "flash_bwd_dq_wgmma_kernel",
              "flash_bwd.cu", f"{fa_py}:142",
              train["flash_attention_bwd_dq/wgmma"],
              bwd["350m_train_layer"], "dq", ("dq",)),
        entry("flash_attention_bwd_dq", "flash_bwd_dq_kernel",
              "flash_bwd.cu", f"{fa_py}:142",
              train_small["flash_attention_bwd_dq/fma"],
              bwd["f32_debug_train"], "dq", ("dq",)),
        entry("flash_attention_bwd_dkv", "flash_bwd_dkv_wgmma_kernel",
              "flash_bwd.cu", f"{fa_py}:192",
              train["flash_attention_bwd_dkv/wgmma"],
              bwd["350m_train_layer"], "dkv", ("dk", "dv")),
        entry("flash_attention_bwd_dkv", "flash_bwd_dkv_kernel",
              "flash_bwd.cu", f"{fa_py}:192",
              train_small["flash_attention_bwd_dkv/fma"],
              bwd["f32_debug_train"], "dkv", ("dk", "dv")),
    ]
    # Launches on the other main path of each kernel, the paged kernel's
    # time at a long context, and the forward's at the training layer.
    long = paged["8b_long_context"]
    for i in (0, 1):
        name = kernels[i]["name"] + ("/wgmma" if i else "")
        kernels[i]["launches_serve_8b_server"] = {
            k: v[name] for k, v in server.items()}
    kernels[0].update({"ms_long_context": long["ms"],
                       "bound_ms_long_context": long["bound_ms"],
                       "plain_ms_long_context": long["plain_ms"]})
    kernels[1]["launches_train_350m"] = train["flash_attention_fwd/wgmma"]
    kernels[1]["ms_350m_train_layer"] = fwd["350m_train_layer"]["ms"]
    kernels[1]["bound_ms_350m_train_layer"] = \
        fwd["350m_train_layer"]["bound_ms"]
    kernels[1]["library_ms_350m_train_layer"] = \
        fwd["350m_train_layer"]["library_ms"]
    kernels[2]["launches_train_small_f32"] = \
        train_small["flash_attention_fwd/fma"]
    # The dense engine's prefill (small f32 and 8B bf16), and the sharded
    # step's forward and backward on a one-rank mesh.
    kernels[0]["launches_serve_8b_dense"] = dense8["paged_decode_attention"]
    kernels[1]["launches_serve_8b_dense"] = dense8["flash_attention_fwd/wgmma"]
    kernels[2]["launches_engine_small_dense_f32"] = \
        small_dense["flash_attention_fwd/fma"]
    for i, name in ((1, "flash_attention_fwd"), (3, "flash_attention_bwd_dq"),
                    (5, "flash_attention_bwd_dkv")):
        kernels[i]["launches_train_350m_sharded"] = \
            sharded["launches"][f"{name}/wgmma"]
        kernels[i]["launches_trainer_350m"] = trainer[f"{name}/wgmma"]
    # The online RLHF loop: the f32 routes at `debug`, bf16 at bench-350m.
    for i, name in enumerate(("paged_decode_attention",
                              "flash_attention_fwd/wgmma",
                              "flash_attention_fwd/fma",
                              "flash_attention_bwd_dq/wgmma",
                              "flash_attention_bwd_dq/fma",
                              "flash_attention_bwd_dkv/wgmma",
                              "flash_attention_bwd_dkv/fma")):
        if i == 0 or name.endswith("/fma"):
            kernels[i]["launches_rlhf_small_f32"] = rlhf_small[name]
            kernels[i]["launches_rlhf_actors_small_f32"] = \
                actors_small[name]
        if i == 0 or name.endswith("/wgmma"):
            kernels[i]["launches_rlhf_350m"] = rlhf[name]
            kernels[i]["launches_rlhf_actors_350m"] = actors[name]
    # The MoE slice: the f32 routes at moe-debug, bf16 at Mixtral's widths.
    for i, name in ((1, "flash_attention_fwd/wgmma"),
                    (2, "flash_attention_fwd/fma"),
                    (3, "flash_attention_bwd_dq/wgmma"),
                    (4, "flash_attention_bwd_dq/fma"),
                    (5, "flash_attention_bwd_dkv/wgmma"),
                    (6, "flash_attention_bwd_dkv/fma")):
        if name.endswith("/fma"):
            kernels[i]["launches_moe_small_f32"] = moe_small[name]
            kernels[i]["launches_vit_small_f32"] = vit_small[name]
        else:
            kernels[i]["launches_train_mixtral_4l"] = mixtral[name]
            kernels[i]["launches_train_vit_b16"] = vit_b16[name]
    # The mesh GRPO learner (f32 at `debug`, bf16 at bench-350m) and the
    # 8B engine with the recorder on.
    for i, name in ((2, "flash_attention_fwd/fma"),
                    (4, "flash_attention_bwd_dq/fma"),
                    (6, "flash_attention_bwd_dkv/fma")):
        kernels[i]["launches_rlhf_mesh_small_f32"] = mesh_small[name]
    for i, name in ((1, "flash_attention_fwd/wgmma"),
                    (3, "flash_attention_bwd_dq/wgmma"),
                    (5, "flash_attention_bwd_dkv/wgmma")):
        kernels[i]["launches_rlhf_mesh_learner_350m"] = mesh350[name]
    # The rollout worker as an actor in the port runtime's device worker,
    # counted there.
    kernels[0]["launches_cluster_rollout_350m"] = \
        cluster_rollout["paged_decode_attention"]
    kernels[1]["launches_cluster_rollout_350m"] = \
        cluster_rollout["flash_attention_fwd/wgmma"]
    # The RLHF actor topology in the device worker, counted there.
    for i, name in ((0, "paged_decode_attention"),
                    (1, "flash_attention_fwd/wgmma"),
                    (3, "flash_attention_bwd_dq/wgmma"),
                    (5, "flash_attention_bwd_dkv/wgmma")):
        kernels[i]["launches_cluster_rlhf_actors_350m"] = cluster_rlhf[name]
    # The 8B LLMServer as a serve replica in the device worker.
    kernels[0]["launches_cluster_serve_8b"] = \
        cluster_serve["paged_decode_attention"]
    kernels[1]["launches_cluster_serve_8b"] = \
        cluster_serve["flash_attention_fwd/wgmma"]
    kernels[0]["launches_serve_8b_observed"] = \
        observed["paged_decode_attention"]
    kernels[1]["launches_serve_8b_observed"] = \
        observed["flash_attention_fwd/wgmma"]
    # Each bf16 kernel's times at the rlhf_350m and Mixtral layer shapes.
    for i, row, part in ((0, paged["350m_rlhf_decode"], None),
                         (1, fwd["350m_rlhf_score"], None),
                         (3, bwd["350m_rlhf_learner"], "dq"),
                         (5, bwd["350m_rlhf_learner"], "dkv"),
                         (1, fwd["mixtral_train_layer"], None),
                         (3, bwd["mixtral_train_layer"], "dq"),
                         (5, bwd["mixtral_train_layer"], "dkv"),
                         (1, fwd["vit_b16_layer"], None),
                         (3, bwd["vit_b16_layer"], "dq"),
                         (5, bwd["vit_b16_layer"], "dkv")):
        pre = "" if part is None else f"{part}_"
        key = (row["case"] if row["case"] in ("mixtral_train_layer",
                                              "vit_b16_layer")
               else "rlhf_350m_shape")
        kernels[i][key] = {
            "case": row["case"], "max_abs_err": row["max_abs_err"],
            "ms": row[f"{pre}ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row[f"{pre}bound_ms"],
            "bound_by": row[f"{pre}bound_by"],
            "library_ms": row["library_ms"]}
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def serve_alone() -> int:
    """`python3 chip_smoke.py --serve-alone`: the kernels' build, phase 4c
    and then phase 25 (cluster_serve_8b) on its output, nothing else."""
    import gc

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ray_tpu_torch
    from ray_tpu_torch import _kernels
    from ray_tpu_torch.models import llama

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "build_s": _kernels.build_all()})
    cfg8 = llama.llama_configs()["llama3-8b"]
    params8 = llama.init_params(
        cfg8, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    _server, alone = phase_serve_8b_server(card, cfg8, params8)
    del params8, _server
    gc.collect()
    torch.cuda.empty_cache()
    try:
        phase_cluster_serve_8b(card, alone)
    finally:
        ray_tpu_torch.shutdown()
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    return 0


if __name__ == "__main__":
    try:
        rc = serve_alone() if sys.argv[1:] == ["--serve-alone"] else main()
    except BaseException:  # noqa: BLE001 - report, then fail the run
        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    os._exit(rc)
