"""The engine knobs and pool roles of the declarative serve config, copied
from ray_tpu/serve/schema.py.  LLMServer.reconfigure accepts exactly
these keys; the deployment schema itself belongs to the reference's
serve runtime and is not ported."""
from __future__ import annotations

# kv_blocks is the operator-facing name of the engine's kv_pages.
ENGINE_CONFIG_KEYS = {"page_size", "kv_blocks", "prefix_cache",
                      "kv_preempt", "max_batch", "max_len",
                      "steps_per_sync", "role", "decode_deployment",
                      "prefix_store", "lora_slots", "lora_rank"}

ENGINE_ROLES = ("unified", "prefill", "decode")
