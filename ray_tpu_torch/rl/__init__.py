"""RL: the in-process online RLHF loop (GRPO rollouts through the paged
engine, the GRPO learner, live weight sync)."""
