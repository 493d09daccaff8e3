"""The port's protocol checker and transition models
(``flextree_tpu_torch/analysis/protocol_check.py``,
``flextree_tpu_torch/runtime/coord_model.py``,
``flextree_tpu_torch/runtime/lease_model.py``,
``flextree_tpu_torch/serving/rpc_model.py``) against the JAX package's:
the six clean worlds (coordination at 2/3/4 ranks, the lease handoff,
RPC, migration) explore the same state and transition counts with no
violation, each seeded mutation reaches the same violation kinds with a
real witness, and the models' codes and constants are the port's own
implementation's (the JAX conformance cases,
``tests/test_control_plane_analysis.py``)."""

from __future__ import annotations

import importlib
import re

import pytest

from flextree_tpu_torch import analysis as tanalysis
from flextree_tpu_torch.analysis import protocol_check as tpc
from flextree_tpu_torch.runtime import coord_model as tcm
from flextree_tpu_torch.runtime import lease_model as tlm
from flextree_tpu_torch.runtime.coordination import (
    DECISION_KINDS,
    decision_fingerprint,
)
from flextree_tpu_torch.serving import rpc_model as trm
from flextree_tpu_torch.serving.migration import MigrationError
from flextree_tpu_torch.serving.rpc import RpcConnRefused, RpcShed, RpcTimeout

jpc = importlib.import_module("flextree_tpu.analysis.protocol_check")
jrm = importlib.import_module("flextree_tpu.serving.rpc_model")
jcm = importlib.import_module("flextree_tpu.runtime.coord_model")
jlm = importlib.import_module("flextree_tpu.runtime.lease_model")

#: the JAX suite's pins for the six worlds (states, transitions)
STATE_SPACE_PINS = {
    "coordination@2ranks": (1009, 1737),
    "coordination@3ranks": (11640, 24916),
    "coordination@4ranks": (61499, 150448),
    "lease@2chips": (21250, 70584),
    "rpc@2replicas": (3445, 12301),
    "migration@1hop": (51, 75),
}

#: mutation -> (model factory per side, violation kinds it must reach)
MUTATIONS = {
    "commit_without_all_acks": (lambda m: m.CoordModel(3, mutation=
                                                       "commit_without_all_acks"),
                                {"commit-quorum"}),
    # the self-ack-held interleaving: the coordinator's own ack still in
    # flight at its deadline, the re-proposal excludes the coordinator
    "drop_survivor_self": (lambda m: m.CoordModel(3, mutation=
                                                  "drop_survivor_self"),
                           {"coordinator-self-excluded",
                            "clean-rank-fenced"}),
    "diverge_commit": (lambda m: m.CoordModel(3, mutation="diverge_commit"),
                       {"commit-proposal-divergence"}),
    "fenced_apply": (lambda m: m.CoordModel(3, mutation="fenced_apply"),
                     {"fenced-apply"}),
    "double_grant": (lambda m: m.LeaseModel(mutation="double_grant"),
                     {"double-grant"}),
    "grant_before_ack": (lambda m: m.LeaseModel(mutation="grant_before_ack"),
                         {"dual-holder-use"}),
    "torn_ack_read": (lambda m: m.LeaseModel(mutation="torn_ack_read"),
                      {"torn-ack-read"}),
    "serve_ack_before_drain": (lambda m: m.LeaseModel(
        mutation="serve_ack_before_drain"), {"dual-holder-use"}),
    "replay_miss": (lambda m: m.RpcModel(mutation="replay_miss"),
                    {"completed-rid-reexecuted"}),
    "skip_release": (lambda m: m.MigrationModel(mutation="skip_release"),
                     {"migration-block-leak"}),
}
#: searches cut short on both sides (the same breadth-first prefix): the
#: full grant_before_ack world is ~3e5 states, its violation is reached
#: within the first 4e4
CAPS = {"grant_before_ack": 40_000}
PORT_MODELS = {"CoordModel": tcm, "LeaseModel": tlm, "RpcModel": trm,
               "MigrationModel": trm}
JAX_MODELS = {"CoordModel": jcm, "LeaseModel": jlm, "RpcModel": jrm,
              "MigrationModel": jrm}


class _Side:
    """``side.CoordModel`` etc.: one package's model classes by name."""

    def __init__(self, mods):
        self._mods = mods

    def __getattr__(self, name):
        return getattr(self._mods[name], name)


PORT, JAX = _Side(PORT_MODELS), _Side(JAX_MODELS)


def _text(det):
    # the JAX model's detail names the interleaving by the change that
    # found it; the port's names it by what it is
    return re.sub(r"\(\S+ \d+'s self-ack", "(the self-ack", str(det))


def _detail(res):
    d = res.to_detail()
    d.pop("elapsed_ms", None)
    return d, {k: (c, w, _text(det))
               for k, (c, w, det) in res.violations.items()}


@pytest.mark.parametrize("name", sorted(STATE_SPACE_PINS))
def test_clean_world_matches_jax_and_the_pin(name):
    model = {m.name: m for m in tpc.default_models()}[name]
    jmodel = {m.name: m for m in jpc.default_models()}[name]
    assert type(model).__name__ == type(jmodel).__name__
    res, jres = tpc.explore(model), jpc.explore(jmodel)
    assert res.violations == {} and not res.truncated
    assert (res.states, res.transitions) == STATE_SPACE_PINS[name]
    assert _detail(res) == _detail(jres)
    assert res.fault_transitions > 0
    assert res.bounded_frontier == jres.bounded_frontier


def test_default_models_and_the_aggregate():
    """The port's matrix is the JAX package's six worlds in its order;
    the aggregate is clean and not truncated, and equals JAX's run."""
    assert [m.name for m in tpc.default_models()] == \
        [m.name for m in jpc.default_models()] == list(STATE_SPACE_PINS)
    violations, detail = tpc.run_protocol_check()
    jviol, jdetail = jpc.run_protocol_check()
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
    factory, kinds = MUTATIONS[mutation]
    kw = {"max_states": CAPS[mutation]} if mutation in CAPS else {}
    res = tpc.explore(factory(PORT), **kw)
    jres = jpc.explore(factory(JAX), **kw)
    assert res.truncated == jres.truncated == bool(kw)
    assert set(res.violations) == set(jres.violations)
    assert kinds <= set(res.violations)
    assert _detail(res) == _detail(jres)
    for kind in kinds:
        count, witness, _ = res.violations[kind]
        assert count > 0 and witness and witness != "<initial>"
        assert "->" in witness or witness.count("(") >= 1


#: one mutation of each model class, its search uncapped
@pytest.mark.parametrize("mutation", ["diverge_commit", "torn_ack_read",
                                      "replay_miss", "skip_release"])
def test_a_mutation_is_a_red_protocol_report(mutation):
    factory, kinds = MUTATIONS[mutation]
    vs, _ = tpc.run_protocol_check(models=[factory(PORT)])
    assert kinds <= {v.kind for v in vs}
    assert all(v.layer == "protocol" and "witness:" in v.detail for v in vs)


def test_every_declared_mutation_is_covered_and_unknown_refused():
    declared = (tcm.COORD_MUTATIONS, tlm.LEASE_MUTATIONS,
                trm.RPC_MUTATIONS, trm.MIGRATION_MUTATIONS)
    assert set().union(*declared) == set(MUTATIONS)
    assert declared == (jcm.COORD_MUTATIONS, jlm.LEASE_MUTATIONS,
                        jrm.RPC_MUTATIONS, jrm.MIGRATION_MUTATIONS)
    for make in (lambda: tcm.CoordModel(3, mutation="nope"),
                 lambda: tlm.LeaseModel(mutation="nope"),
                 lambda: trm.RpcModel(mutation="nope"),
                 lambda: trm.MigrationModel(mutation="nope")):
        with pytest.raises(ValueError, match="unknown"):
            make()


def test_models_share_the_implementation_constants():
    """Decision identity is the implementation's fingerprint over its
    kinds, and the lease model's holders are the ledger's."""
    from flextree_tpu_torch.runtime.leases import ARBITER, SERVE, TRAIN

    m = tcm.CoordModel(3, decisions=2)
    assert m.kind in DECISION_KINDS
    assert m.fps == tuple(decision_fingerprint(m.kind, {"seq": i})
                          for i in range(2))
    assert m.fps == jcm.CoordModel(3, decisions=2).fps
    _, grants, _, _, _, _ = tlm.LeaseModel().initial()
    assert tuple(h for h, _ in grants) == (TRAIN, SERVE, ARBITER)


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
