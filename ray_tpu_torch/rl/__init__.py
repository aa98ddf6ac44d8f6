"""ray_tpu_torch.rl: reinforcement learning (port of ray_tpu/rl).

The algorithms' training loops (EnvRunnerGroup actors sampling numpy envs on the
host, LearnerGroup actors updating on the device, connectors, replay,
offline data) on the runtime seam, with PPO, IMPALA, APPO, DQN, SAC, BC,
MARWIL, CQL and multi-agent PPO; DreamerV3 in process; the online RLHF
loop (GRPO rollouts through the paged engine, the GRPO learner, live
weight sync).
"""
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.appo import APPO, APPOConfig
from ray_tpu_torch.rl.bc import BC, BCConfig
from ray_tpu_torch.rl.connectors import (ConnectorCtx, ConnectorPipelineV2,
                                         ConnectorV2)
from ray_tpu_torch.rl.cql import CQL, CQLConfig
from ray_tpu_torch.rl.dqn import DQN, DQNConfig
from ray_tpu_torch.rl.dreamerv3 import DreamerV3, DreamerV3Config
from ray_tpu_torch.rl.env import make_env, register_env
from ray_tpu_torch.rl.env_runner import EnvRunner, EnvRunnerGroup
from ray_tpu_torch.rl.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rl.learner import Learner, LearnerGroup
from ray_tpu_torch.rl.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rl.multi_agent import (MultiAgentEnv, MultiAgentEnvRunner,
                                          MultiAgentPPO, MultiAgentPPOConfig,
                                          MultiCartPole)
from ray_tpu_torch.rl.ppo import PPO, PPOConfig
from ray_tpu_torch.rl.replay import ReplayBuffer
from ray_tpu_torch.rl.rlhf import (GRPOLearner, RLHFConfig, RLHFTrainer,
                                   group_advantages)
from ray_tpu_torch.rl.rollout_llm import LLMRolloutWorker
from ray_tpu_torch.rl.sac import SAC, SACConfig

__all__ = [
    "Algorithm", "AlgorithmConfig", "APPO", "APPOConfig",
    "ConnectorCtx", "ConnectorPipelineV2", "ConnectorV2",
    "PPO", "PPOConfig", "DQN", "DQNConfig",
    "IMPALA", "IMPALAConfig", "SAC", "SACConfig", "BC", "BCConfig",
    "CQL", "CQLConfig", "MARWIL", "MARWILConfig",
    "DreamerV3", "DreamerV3Config",
    "MultiAgentEnv", "MultiAgentEnvRunner",
    "MultiAgentPPO", "MultiAgentPPOConfig", "MultiCartPole",
    "EnvRunner", "EnvRunnerGroup", "Learner", "LearnerGroup",
    "ReplayBuffer", "make_env", "register_env",
    "RLHFConfig", "RLHFTrainer", "GRPOLearner", "LLMRolloutWorker",
    "group_advantages",
]
