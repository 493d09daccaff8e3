"""``python -m flextree_tpu_torch.trainer`` over a (dp, sp, tp) mesh on
the CPU at a tiny width: each ``--sp-impl`` trains on ``--mesh 2,2,2``
and ``--devices 8`` gives that mesh, the last line names it and the
first loss is the one-rank run's (rtol 1e-5); what stays refused with sp
or tp above 1 names its ROADMAP item; with no card and no ``--cpu`` the
trainer raises."""

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
    # the pipeline and MoE models train now (test_torch_trainer_models.py);
    # their unported flags stay refused
    ["--model", "pipeline", "--mesh", "1,2,2,2", "--overlap"],
    ["--model", "moe", "--mesh", "1,2,2,2", "--codec", "int8"],
])
def test_what_stays_refused_names_its_item(flags):
    with pytest.raises(NotImplementedError,
                       match="Sequence, pipeline and expert parallelism"):
        trainer.main(_SMALL + ["--mesh", "2,2,2"] + flags)


def test_no_card_without_cpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the trainer would run on it")
    argv = [a for a in _SMALL if a != "--cpu"] + ["--mesh", "2,2,2"]
    with pytest.raises(RuntimeError):
        trainer.main(argv)
