"""The port's protocol checker and transition models
(``flextree_tpu_torch/analysis/protocol_check.py``,
``flextree_tpu_torch/serving/rpc_model.py``) against the JAX package's:
the clean RPC and migration worlds explore the same state and transition
counts with no violation, each seeded mutation reaches the same
violation kinds with a real witness, and the models' codes are the
port's own error taxonomy (the JAX conformance cases for these two
models, ``tests/test_control_plane_analysis.py``)."""

from __future__ import annotations

import importlib

import pytest

from flextree_tpu_torch import analysis as tanalysis
from flextree_tpu_torch.analysis import protocol_check as tpc
from flextree_tpu_torch.serving import rpc_model as trm
from flextree_tpu_torch.serving.migration import MigrationError
from flextree_tpu_torch.serving.rpc import RpcConnRefused, RpcShed, RpcTimeout

jpc = importlib.import_module("flextree_tpu.analysis.protocol_check")
jrm = importlib.import_module("flextree_tpu.serving.rpc_model")

#: the JAX suite's pins for these two worlds (states, transitions)
STATE_SPACE_PINS = {
    "rpc@2replicas": (3445, 12301),
    "migration@1hop": (51, 75),
}

MUTATIONS = {
    "replay_miss": ("RpcModel", {"completed-rid-reexecuted"}),
    "skip_release": ("MigrationModel", {"migration-block-leak"}),
}


def _detail(res):
    d = res.to_detail()
    d.pop("elapsed_ms", None)
    return d, {k: (c, w, det) for k, (c, w, det) in res.violations.items()}


@pytest.mark.parametrize("name", sorted(STATE_SPACE_PINS))
def test_clean_world_matches_jax_and_the_pin(name):
    model = {m.name: m for m in tpc.default_models()}[name]
    jmodel = getattr(jrm, type(model).__name__)()
    res, jres = tpc.explore(model), jpc.explore(jmodel)
    assert res.violations == {} and not res.truncated
    assert (res.states, res.transitions) == STATE_SPACE_PINS[name]
    assert _detail(res) == _detail(jres)
    assert res.fault_transitions > 0
    assert res.bounded_frontier == jres.bounded_frontier


def test_default_models_and_the_aggregate():
    """The port's matrix is the RPC and migration worlds (the coordination
    and lease worlds come with their runtime); the aggregate is clean and
    not truncated, and equals JAX's run over the same two models."""
    assert sorted(m.name for m in tpc.default_models()) == \
        sorted(STATE_SPACE_PINS)
    violations, detail = tpc.run_protocol_check()
    jviol, jdetail = jpc.run_protocol_check(
        models=[jrm.RpcModel(), jrm.MigrationModel()])
    assert violations == [] == jviol
    for d in (detail, jdetail):
        for row in d["models"].values():
            row.pop("elapsed_ms", None)
    assert detail == jdetail
    assert detail["states"] == sum(s for s, _ in STATE_SPACE_PINS.values())
    assert detail["transitions"] == sum(t for _, t in
                                        STATE_SPACE_PINS.values())
    times: dict = {}
    _, only = tpc.run_protocol_check(programs=["migration"], times=times)
    assert list(only["models"]) == list(times) == ["migration@1hop"]
    assert tanalysis.run_protocol_check is tpc.run_protocol_check


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_mutation_reaches_the_jax_violation(mutation):
    cls, kinds = MUTATIONS[mutation]
    res = tpc.explore(getattr(trm, cls)(mutation=mutation))
    jres = jpc.explore(getattr(jrm, cls)(mutation=mutation))
    assert set(res.violations) == set(jres.violations)
    assert kinds <= set(res.violations)
    assert _detail(res) == _detail(jres)
    for kind in kinds:
        count, witness, _ = res.violations[kind]
        assert count > 0 and witness and witness != "<initial>"
        assert "->" in witness or witness.count("(") >= 1
    vs, _ = tpc.run_protocol_check(models=[getattr(trm, cls)(
        mutation=mutation)])
    assert kinds <= {v.kind for v in vs}
    assert all(v.layer == "protocol" and "witness:" in v.detail for v in vs)


def test_every_declared_mutation_is_covered_and_unknown_refused():
    assert set(trm.RPC_MUTATIONS) | set(trm.MIGRATION_MUTATIONS) == \
        set(MUTATIONS)
    assert (trm.RPC_MUTATIONS, trm.MIGRATION_MUTATIONS) == \
        (jrm.RPC_MUTATIONS, jrm.MIGRATION_MUTATIONS)
    for cls in (trm.RpcModel, trm.MigrationModel):
        with pytest.raises(ValueError, match="unknown"):
            cls(mutation="nope")


class _Unbounded(trm.MigrationModel):
    """An unbounded counter chain: the hard cap must surface as a red
    ``search-truncated`` violation, never be absorbed as clean."""

    def __init__(self):
        super().__init__()
        self.name = "migration@unbounded"

    def initial(self):
        return ("chain", 0)

    def transitions(self, state):
        return [("tick", ("chain", state[1] + 1), [])]


def test_truncated_search_is_red():
    res = tpc.explore(trm.RpcModel(), max_states=100)
    assert res.truncated and res.states == 100
    vs, detail = tpc.run_protocol_check(models=[_Unbounded()])
    assert [v.kind for v in vs] == ["search-truncated"]
    assert detail["models"]["migration@unbounded"]["truncated"] is True


def test_rpc_model_codes_are_the_port_taxonomy():
    assert trm.FAIL_CODES == (RpcTimeout.code, RpcConnRefused.code,
                              RpcShed.code)
    assert trm.FAIL_CODES == jrm.FAIL_CODES
    assert len(set(trm.FAIL_CODES)) == 3
    assert trm.TERMINAL_STATUSES == ("completed", "shed", "failed")


def test_migration_model_refusal_is_the_port_code():
    assert MigrationError.code == "FT_MIGRATION_REFUSED"
    labels = [label for label, _, _ in trm.MigrationModel().transitions(
        ("exported", True, True, False, 2, 1))]
    assert f"refuse({MigrationError.code})" in labels
    assert f"ship_fail({RpcConnRefused.code})" not in labels  # alive
