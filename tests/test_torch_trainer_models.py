"""``python -m flextree_tpu_torch.trainer --model pipeline|moe`` on the CPU.

- Each model on the (1, 2, 2, 2) mesh trains, and its last line is the
  JAX trainer's (``flextree_tpu.trainer``) for the same flags, the
  losses aside (the two packages draw different initial weights).
- The checkpoint restores to the live state bitwise, the JAX package's
  reader loads it into the tree the JAX trainer's state has (the stacked
  tree for the pipeline), and a run resumes from it.
- ``--devices 8`` splits as the JAX trainer splits it, (1, 2, 2, 2).
- ``--overlap``, ``--shard-optimizer`` and a lossy ``--codec`` train on
  both models for a step: a finite loss, the last line's form, the state
  the option gives (each rank's residual, the sharded moments) and, with
  ``--ckpt-dir``, a checkpoint in the replicated layout.
"""

import importlib
import math
import re

import jax
import numpy as np
import pytest
import torch

from flextree_tpu_torch import trainer
from flextree_tpu_torch.utils import checkpoint as tckpt
from flextree_tpu_torch.utils.tree import tree_leaves

jckpt = importlib.import_module("flextree_tpu.utils.checkpoint")
jtrainer = importlib.import_module("flextree_tpu.trainer")

_SMALL = ["--vocab", "64", "--d-model", "32", "--n-heads", "4", "--d-ff",
          "64", "--seq-len", "32", "--batch", "8", "--corpus-tokens",
          "20000", "--log-every", "1"]
_MODEL = {"pipeline": ["--model", "pipeline", "--n-layers", "4",
                       "--microbatches", "2"],
          "moe": ["--model", "moe", "--n-layers", "2", "--n-experts", "4"]}


def _last(capsys) -> str:
    return capsys.readouterr().out.strip().splitlines()[-1]


def _no_losses(line: str) -> str:
    return re.sub(r"loss \S+ -> \S+", "loss _ -> _", line)


@pytest.mark.parametrize("model", ["pipeline", "moe"])
def test_trainer_model_last_line_and_checkpoint(model, tmp_path, capsys):
    flags = _SMALL + _MODEL[model] + ["--mesh", "1,2,2,2", "--steps", "2"]
    ckpt = str(tmp_path / "ck")
    out: dict = {}
    assert trainer.main(["--cpu"] + flags + ["--ckpt-dir", ckpt],
                        out=out) == 0
    mine = _last(capsys)
    res = out["result"]
    assert res.steps_run == 2
    assert all(math.isfinite(loss) for _, loss in res.losses)
    assert jtrainer.main(flags) == 0
    want = _last(capsys)
    assert _no_losses(mine) == _no_losses(want), (mine, want)
    assert re.fullmatch(rf"{model}: 2 steps on mesh \{{.*\}}; loss "
                        r"\d+\.\d{4} -> \d+\.\d{4}", mine)

    saved = tckpt.restore_train_state(ckpt, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(res.state), tree_leaves(saved)))
    loaded = jckpt.restore_train_state(ckpt)
    if model == "pipeline":
        from flextree_tpu.parallel.pipeline import init_pipeline_train_state

        ref = init_pipeline_train_state(jax.random.PRNGKey(0),
                                        _jax_cfg(model))
    else:
        from flextree_tpu.parallel.moe_train import init_moe_train_state

        ref = init_moe_train_state(jax.random.PRNGKey(0), _jax_cfg(model))
    assert jax.tree.structure(loaded) == jax.tree.structure(ref)
    for a, b, r in zip(jax.tree.leaves(loaded), tree_leaves(res.state),
                       jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b.numpy())
        assert a.shape == r.shape

    resumed: dict = {}
    assert trainer.main(["--cpu"] + flags[:-1] + ["3", "--ckpt-dir", ckpt],
                        out=resumed) == 0
    assert resumed["result"].resumed_from == 2
    assert "(resumed from 2)" in _last(capsys)


def _jax_cfg(model):
    if model == "pipeline":
        from flextree_tpu.models.transformer import TransformerConfig

        return TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                                 n_layers=4, d_ff=64)
    from flextree_tpu.models.moe import MoEConfig

    return MoEConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                     d_ff=64, n_experts=4)


@pytest.mark.parametrize("model", ["pipeline", "moe"])
def test_trainer_model_devices_split(model, capsys):
    out: dict = {}
    assert trainer.main(["--cpu"] + _SMALL + _MODEL[model]
                        + ["--devices", "8", "--steps", "1"], out=out) == 0
    assert out["comm"].shape == (1, 2, 2, 2)
    names = ("dp", "pp" if model == "pipeline" else "ep", "sp", "tp")
    assert out["comm"].axis_names == names
    assert _last(capsys).startswith(
        f"{model}: 1 steps on mesh {dict(zip(names, (1, 2, 2, 2)))}")
    with pytest.raises(ValueError, match="want dp"):
        trainer.main(["--cpu"] + _SMALL + _MODEL[model] + ["--mesh", "2,2,2"])


@pytest.mark.parametrize("flag", [["--overlap"], ["--shard-optimizer"],
                                  ["--codec", "int8"], ["--codec", "bf16"]])
@pytest.mark.parametrize("model", ["pipeline", "moe"])
def test_trainer_model_refusals(model, flag, tmp_path, capsys):
    """Each option that was refused on the (1, 2, 2, 2) meshes trains a
    step there now; its checkpoint is the replicated layout the JAX
    trainer's state has."""
    ckpt = str(tmp_path / "ck")
    out: dict = {}
    assert trainer.main(["--cpu"] + _SMALL + _MODEL[model]
                        + ["--mesh", "1,2,2,2", "--steps", "1",
                           "--ckpt-dir", ckpt] + flag, out=out) == 0
    assert re.fullmatch(rf"{model}: 1 steps on mesh \{{.*\}}; loss "
                        r"\d+\.\d{4} -> \d+\.\d{4}", _last(capsys))
    res = out["result"]
    assert res.steps_run == 1 and math.isfinite(res.losses[-1][1])
    state = res.state
    if "--shard-optimizer" in flag:
        assert "mu_shard" in state and "mu" not in state
    if "--codec" in flag:
        assert isinstance(state["ef"], list) and len(state["ef"]) == 8
    saved = tckpt.restore_train_state(ckpt, "cpu")
    assert {"params", "mu", "nu", "step"} <= set(saved)
    assert ("ef" in saved) == ("--codec" in flag)
    assert tree_leaves(saved["params"])[0].shape == \
        tree_leaves(state["params"])[0].shape
