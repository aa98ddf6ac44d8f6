"""RL: the in-process online RLHF loop (GRPO rollouts through the paged
engine, the GRPO learner, live weight sync), DreamerV3 from config to
metrics in process (`dreamerv3`, with the numpy `env` and `replay`
copies and the `algorithm` config builder), and the RL algorithms'
learner side (`learner.Learner`, `models`, and the loss builders of PPO,
IMPALA, APPO, DQN, BC, MARWIL, SAC and CQL)."""
