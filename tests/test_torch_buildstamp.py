"""The port's build stamp (``flextree_tpu_torch/utils/buildstamp.py``)
against the JAX package's: the same four keys, the port's version, the
git fields of the checkout the port is imported from, and the bench
CLI's ``--version``, which needs no card."""

import flextree_tpu_torch
from flextree_tpu.utils import buildstamp as jstamp
from flextree_tpu_torch.bench.__main__ import main as bench_main
from flextree_tpu_torch.utils import buildstamp


def test_build_info_has_the_jax_keys_and_the_ports_version():
    info = buildstamp.build_info()
    assert set(info) == set(jstamp.build_info())
    assert info["version"] == flextree_tpu_torch.__version__
    # one checkout holds both packages: the git fields are the same
    assert {k: v for k, v in info.items() if k != "version"} == \
        {k: v for k, v in jstamp.build_info().items() if k != "version"}
    assert info["git_hash"] != "unknown" and len(info["git_hash"]) >= 7
    assert info["git_hash"] in info["git_describe"]
    assert buildstamp.build_info() is info  # cached


def test_version_string_and_artifact_meta():
    info = buildstamp.build_info()
    s = buildstamp.version_string()
    assert s.startswith("flextree-tpu-torch ")
    assert info["version"] in s and info["git_describe"] in s
    meta = buildstamp.artifact_meta()
    assert meta["git_hash"] == info["git_hash"]
    assert "T" in meta["generated_at"]


def test_bench_cli_version_flag_needs_no_card(capsys):
    assert bench_main(["--version"]) == 0
    out = capsys.readouterr().out.strip()
    assert out == buildstamp.version_string()
