"""Layering of the port: ray_tpu_torch and chip_smoke.py import nothing of
JAX or of the JAX package, call no library attention or compiler, and the
entry points refuse to fall back to the CPU quietly."""
import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ray_tpu_torch")
FORBIDDEN_TOP = {"jax", "jaxlib", "flax", "optax", "ray_tpu"}
FORBIDDEN_NAMES = ("scaled_dot_product_attention", "torch.compile")


def _files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _dirs, files in os.walk(PKG):
        if "__pycache__" in dirpath or "_build" in dirpath:
            continue
        out += [os.path.join(dirpath, f) for f in files
                if f.endswith(".py")]
    return sorted(out)


def _imports_of(path):
    """Every module imported anywhere in the file, lazy imports included."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno


def test_walk_covers_the_package_and_chip_smoke():
    files = _files()
    rels = {os.path.relpath(p, REPO) for p in files}
    for rel in ("chip_smoke.py", "ray_tpu_torch/serve/llm.py",
                "ray_tpu_torch/serve/runtime.py",
                "ray_tpu_torch/serve/slo.py",
                "ray_tpu_torch/serve/schema.py",
                "ray_tpu_torch/serve/prefix_store.py",
                "ray_tpu_torch/serve/lora.py",
                "ray_tpu_torch/models/llama.py",
                "ray_tpu_torch/models/moe.py",
                "ray_tpu_torch/models/vit.py",
                "ray_tpu_torch/models/resnet.py",
                "ray_tpu_torch/models/convert.py",
                "ray_tpu_torch/rl/models.py",
                "ray_tpu_torch/rl/learner.py",
                "ray_tpu_torch/rl/algorithm.py",
                "ray_tpu_torch/rl/ppo.py",
                "ray_tpu_torch/rl/impala.py",
                "ray_tpu_torch/rl/appo.py",
                "ray_tpu_torch/rl/dqn.py",
                "ray_tpu_torch/rl/bc.py",
                "ray_tpu_torch/rl/marwil.py",
                "ray_tpu_torch/rl/sac.py",
                "ray_tpu_torch/rl/cql.py",
                "ray_tpu_torch/parallel/comm.py",
                "ray_tpu_torch/parallel/ring.py",
                "ray_tpu_torch/parallel/pipeline.py",
                "ray_tpu_torch/ops/paged_attention.py",
                "ray_tpu_torch/ops/flash_attention.py",
                "ray_tpu_torch/ops/losses.py",
                "ray_tpu_torch/parallel/__init__.py",
                "ray_tpu_torch/parallel/mesh.py",
                "ray_tpu_torch/parallel/sharding.py",
                "ray_tpu_torch/train/step.py"):
        assert rel in rels, rel
    assert all(list(_imports_of(p)) for p in files if
               not p.endswith("__init__.py"))


def test_no_jax_or_reference_package_imports():
    bad = [f"{os.path.relpath(p, REPO)}:{ln}: imports {mod}"
           for p in _files() for mod, ln in _imports_of(p)
           if mod.split(".")[0] in FORBIDDEN_TOP]
    assert not bad, "\n".join(bad)


def test_no_library_attention_or_compiler():
    bad = []
    for p in _files():
        if p.endswith("chip_smoke.py"):     # may time a library yardstick
            continue
        with open(p, encoding="utf-8") as f:
            text = f.read()
        bad += [f"{os.path.relpath(p, REPO)}: {n}" for n in FORBIDDEN_NAMES
                if n in text]
    assert not bad, "\n".join(bad)


def test_engine_without_device_raises_when_cuda_is_absent():
    from ray_tpu_torch.models.llama import llama_configs
    from ray_tpu_torch.serve.llm import LLMEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default engine runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(llama_configs()["debug"])


def test_training_entry_points_raise_when_cuda_is_absent():
    from ray_tpu_torch.models.convert import train_state_from_jax
    from ray_tpu_torch.models.llama import llama_configs
    from ray_tpu_torch.train.step import (create_train_state,
                                          default_optimizer, make_train_step)

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default entry points run")
    cfg, opt = llama_configs()["debug"], default_optimizer()
    for call in (lambda: create_train_state(0, cfg, opt),
                 lambda: make_train_step(cfg, opt),
                 lambda: train_state_from_jax({}, cfg, opt)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    state = create_train_state(0, cfg, opt, device="cpu")
    assert state.step == 0 and state.params["embed"].device.type == "cpu"
    assert callable(make_train_step(cfg, opt, device="cpu"))
