"""``python -m flextree_tpu_torch.trainer`` over a (dp, sp, tp) mesh on
the CPU at a tiny width: each ``--sp-impl`` trains on ``--mesh 2,2,2``
and ``--devices 8`` gives that mesh, the last line names it and the
first loss is the one-rank run's (rtol 1e-5); ``--overlap``,
``--shard-optimizer`` and a lossy ``--codec`` train on ``--mesh 2,2,2``
and on the pipeline and MoE meshes for a step, the loss the one-rank
run's where the model is the dense one; what stays refused (a pipeline or MoE
step over a ``torch.distributed`` group) names its ROADMAP item; with no
card and no ``--cpu`` the trainer raises."""

import math

import pytest
import torch

from flextree_tpu_torch import trainer

_SMALL = ["--cpu", "--vocab", "64", "--d-model", "32", "--n-heads", "4",
          "--n-layers", "2", "--d-ff", "64", "--seq-len", "16", "--batch",
          "4", "--corpus-tokens", "4000", "--log-every", "1", "--steps", "3"]
_MESH = "{'dp': 2, 'sp': 2, 'tp': 2}"


@pytest.fixture(scope="module")
def one_rank_losses():
    out: dict = {}
    assert trainer.main(_SMALL, out=out) == 0
    return [loss for _, loss in out["result"].losses]


@pytest.mark.parametrize("flags", [
    ["--mesh", "2,2,2", "--sp-impl", "ring"],
    ["--mesh", "2,2,2", "--sp-impl", "zigzag", "--attn-impl", "flash"],
    ["--mesh", "2,2,2", "--sp-impl", "ulysses", "--grad-clip", "0.5"],
    ["--devices", "8", "--sp-impl", "zigzag"],
])
def test_trains_on_a_2_2_2_mesh(flags, capsys, one_rank_losses):
    out: dict = {}
    assert trainer.main(_SMALL + flags, out=out) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith(f"dense: 3 steps on mesh {_MESH}; loss ")
    assert out["model_cfg"].sp_impl == flags[flags.index("--sp-impl") + 1]
    losses = [loss for _, loss in out["result"].losses]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert math.isclose(losses[0], one_rank_losses[0], rel_tol=1e-5)


@pytest.mark.parametrize("flags", [
    ["--overlap"], ["--shard-optimizer"], ["--codec", "int8"],
    ["--codec", "bf16"],
    ["--model", "pipeline", "--mesh", "1,2,2,2", "--overlap"],
    ["--model", "moe", "--mesh", "1,2,2,2", "--codec", "int8"],
])
def test_what_stays_refused_names_its_item(flags, capsys, one_rank_losses):
    """The options the (2, 2, 2) mesh refused train a step there now (the
    last flag given wins for ``--mesh``), their loss the one-rank run's
    on the dense model."""
    out: dict = {}
    assert trainer.main(_SMALL + ["--mesh", "2,2,2", "--steps", "1"]
                        + flags, out=out) == 0
    model = flags[flags.index("--model") + 1] if "--model" in flags \
        else "dense"
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith(f"{model}: 1 steps on mesh ")
    losses = [loss for _, loss in out["result"].losses]
    assert len(losses) == 1 and all(math.isfinite(x) for x in losses)
    if model == "dense":
        assert math.isclose(losses[0], one_rank_losses[0], rel_tol=1e-5)


def test_a_process_group_still_refuses_the_pipeline_and_moe_steps():
    """A ``torch.distributed`` group is one data-parallel axis: the
    pipeline and MoE steps over one, with any option, name their ROADMAP
    item (one gloo rank, in a process of its own)."""
    from flextree_tpu_torch.parallel import launch

    got = launch.spawn(_refuse_on_group, 1, timeout=120)
    assert got == [True]


def _refuse_on_group(rank, world):
    import torch.distributed as dist

    from flextree_tpu_torch.models.moe import MoEConfig
    from flextree_tpu_torch.models.transformer import TransformerConfig
    from flextree_tpu_torch.parallel import moe_train, pipeline
    from flextree_tpu_torch.parallel.train import TrainConfig

    group = dist.group.WORLD
    dims = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
    for kw in ({}, dict(overlap=True), dict(shard_optimizer=True),
               dict(codec="int8")):
        for build in (lambda tc: pipeline.make_pipeline_train_step(
                TransformerConfig(**dims), tc, comm=group, device="cpu"),
                      lambda tc: moe_train.make_moe_train_step(
                MoEConfig(**dims), tc, comm=group, device="cpu")):
            try:
                build(TrainConfig(**kw))
            except NotImplementedError as e:
                assert "Sequence, pipeline and expert parallelism" in str(e)
            else:
                return False
    return True


def test_no_card_without_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the trainer would run on it")
    argv = [a for a in _SMALL if a != "--cpu"] + ["--mesh", "2,2,2"]
    with pytest.raises(RuntimeError):
        trainer.main(argv)
