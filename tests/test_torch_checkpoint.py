"""The port's checkpoint module (ray_tpu_torch/train/checkpoint.py) on the
CPU: the torch.save tree format round trip (bf16, numpy and plain
leaves, nested containers), restoring into a target's placement,
structure and shape checks, the async snapshot, and CheckpointManager's
retention held to the reference's (ray_tpu/train/checkpoint.py) on the
same registrations."""
import os
import pickle

import numpy as np
import pytest
import torch

from ray_tpu_torch.train import checkpoint as ck


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(4, 3, generator=g).bfloat16(),
                       "b": torch.randn(3, generator=g)},
            "opt_state": ({"count": torch.tensor(5.0)}, [np.arange(4)]),
            "version": np.asarray(7), "name": "run", "lr": 1e-3,
            "none": None}


def test_round_trip_keeps_structure_dtypes_and_bits(tmp_path):
    tree = _tree()
    c = ck.Checkpoint.from_pytree(tree, path=str(tmp_path / "a"))
    assert os.listdir(c.path) == [ck.STATE_FILE]
    got = c.to_pytree()
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"], tree["params"]["w"])
    assert torch.equal(got["params"]["b"], tree["params"]["b"])
    assert isinstance(got["opt_state"], tuple)
    assert isinstance(got["opt_state"][1], list)
    assert isinstance(got["opt_state"][1][0], np.ndarray)
    np.testing.assert_array_equal(got["opt_state"][1][0], np.arange(4))
    assert int(got["version"]) == 7 and isinstance(got["version"],
                                                   np.ndarray)
    assert (got["name"], got["lr"], got["none"]) == ("run", 1e-3, None)
    # The file loads under weights_only (no pickled code).
    data = torch.load(os.path.join(c.path, ck.STATE_FILE),
                      weights_only=True)
    assert set(data) == {"structure", "leaves"}


def test_views_save_only_their_elements(tmp_path):
    big = torch.zeros(1 << 16)
    c = ck.Checkpoint.from_pytree({"row": big[:8]}, path=str(tmp_path))
    assert os.path.getsize(os.path.join(c.path, ck.STATE_FILE)) < 1 << 14


def test_to_pytree_target_places_and_checks(tmp_path):
    tree = _tree()
    c = ck.Checkpoint.from_pytree(tree, path=str(tmp_path))
    target = _tree()
    target["params"]["b"] = torch.zeros(3, dtype=torch.float64)
    got = c.to_pytree(target=target)
    assert got["params"]["b"].dtype == torch.float64
    np.testing.assert_allclose(got["params"]["b"].numpy(),
                               tree["params"]["b"].numpy())
    bad = _tree()
    bad["params"]["b"] = torch.zeros(4)
    with pytest.raises(ValueError, match="shape"):
        c.to_pytree(target=bad)
    wrong = _tree()
    wrong["params"] = {"w": wrong["params"]["w"]}
    with pytest.raises(ValueError, match="keys"):
        c.to_pytree(target=wrong)
    with pytest.raises(TypeError, match="dict keys"):
        ck.Checkpoint.from_pytree({1: torch.ones(1)}, path=str(tmp_path))


def test_async_write_snapshots_before_returning(tmp_path):
    tree = _tree()
    want = tree["params"]["b"].clone()
    c = ck.Checkpoint.from_pytree_async(tree, path=str(tmp_path / "s"))
    tree["params"]["b"].add_(1.0)            # in place, at once
    tree["opt_state"][1][0][:] = -1
    got = c.wait().to_pytree()
    assert torch.equal(got["params"]["b"], want)
    np.testing.assert_array_equal(got["opt_state"][1][0], np.arange(4))
    # Pickling is a flush point and gives a plain path handle.
    c2 = ck.Checkpoint.from_pytree_async(tree, path=str(tmp_path / "p"))
    back = pickle.loads(pickle.dumps(c2))
    assert back.path == c2.path and back._pending is None
    assert torch.equal(back.to_pytree()["params"]["b"], want + 1.0)
    assert ck.flush_pending_writes() == 0


def test_dict_handles_and_ephemeral_marker(tmp_path):
    c = ck.Checkpoint.from_dict({"step": 3, "loss": 0.5})
    assert c.to_dict() == {"step": 3, "loss": 0.5}
    assert not c.is_ephemeral()
    ck.Checkpoint.mark_ephemeral(c.path)
    assert c.is_ephemeral()
    mgr = ck.CheckpointManager(str(tmp_path / "store"))
    kept = mgr.register(c, {"loss": 0.5})
    assert not os.path.exists(c.path)        # the handoff was consumed
    assert not kept.is_ephemeral()
    assert kept.to_dict() == {"step": 3, "loss": 0.5}


@pytest.mark.parametrize("conf", [
    dict(), dict(num_to_keep=2),
    dict(num_to_keep=2, checkpoint_score_attribute="acc"),
    dict(num_to_keep=1, checkpoint_score_attribute="acc",
         checkpoint_score_order="min")])
def test_manager_retention_matches_reference(tmp_path, conf):
    from ray_tpu.train import checkpoint as jck
    from ray_tpu.train.config import CheckpointConfig as JaxConfig
    from ray_tpu_torch.train.config import CheckpointConfig

    accs = [0.3, 0.9, 0.1, 0.5, 0.7]
    kept = {}
    for name, mod, cls in (("port", ck, CheckpointConfig),
                           ("ref", jck, JaxConfig)):
        mgr = mod.CheckpointManager(str(tmp_path / name), cls(**conf))
        for i, acc in enumerate(accs):
            src = mod.Checkpoint.from_dict({"i": i})
            mgr.register(src, {"acc": acc})
        kept[name] = (sorted(os.listdir(tmp_path / name)),
                      os.path.basename(mgr.latest_checkpoint.path),
                      os.path.basename(mgr.best_checkpoint.path),
                      mgr.best_checkpoint.to_dict())
    assert kept["port"] == kept["ref"]
