"""The port's autotune against the JAX reference: the schedule JSON both
ways, the cost model, the batched SQNR profile, the allocator, the
``dynamic_p`` wrappers and the draft-schedule search.

Tolerances.  Schedules, cost-model numbers and the allocator's output are
the same Python on the same inputs: held exactly.  ``profile_array`` sums
the same f32 noise terms in another order (the port over the ``(K, cols)``
view, the reference over the tensor's own shape): within 1e-3 dB, and the
test prints the largest difference it saw.  Draft error profiles are means
over the same decoded payload: rtol 1e-5.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import autotune as jat
from repro import engine as jengine
from repro.autotune import costmodel as jcost
from repro.autotune import search as jsearch
from repro.configs.base import get_smoke_config as j_smoke
from repro.core import dynamic_p as jdyn
from repro.core.policy import StruMConfig as JCfg
from repro.models import model_defs as j_model_defs
from repro_torch import autotune as tat
from repro_torch import engine
from repro_torch.autotune import costmodel as tcost
from repro_torch.autotune import search as tsearch
from repro_torch.core import dynamic_p as tdyn
from repro_torch.core.policy import StruMConfig as TCfg
from repro_torch.models.params import params_from_numpy

import _torch_f64_referee as referee

torch.set_num_threads(1)  # xdist runs several workers side by side: one intra-op thread each

PROFILE_DB = 1e-3
DRAFT_RTOL = 1e-5


def _np_tree():
    rng = np.random.default_rng(0)
    return {
        "friendly": {"w": (2.0 ** rng.integers(0, 5, size=(64, 32))
                           * rng.choice([-1, 1], size=(64, 32))).astype(np.float32)},
        "hard": {"w": rng.standard_t(1.2, size=(64, 32)).astype(np.float32)},
        "blk0": {"w": rng.normal(size=(96, 48)).astype(np.float32)},
        "ln": {"scale": np.ones((32,), np.float32)},   # excluded (1-D + name)
    }


def _both_trees():
    t = _np_tree()
    return jax.tree.map(jnp.asarray, t), params_from_numpy(t, device="cpu")


def _cfg_dicts(assignments):
    return {n: tat.config_to_dict(c) for n, c in assignments.items()}


@pytest.fixture(scope="module")
def ref_schedule():
    jtree, _ = _both_trees()
    return jat.search_schedule(jtree, jat.Budget(target_ratio=0.875))


# ----------------------------------------------------------------- schedule --

def test_schedule_json_loads_both_ways_with_identical_text(ref_schedule, tmp_path):
    ref_text = ref_schedule.to_json()
    port = tat.StruMSchedule.from_json(ref_text)
    assert _cfg_dicts(port.assignments) == {
        n: jat.config_to_dict(c) for n, c in ref_schedule.assignments.items()}
    assert port.exclude == ref_schedule.exclude and port.meta == ref_schedule.meta
    assert port.to_json() == ref_text
    # the port saves, the reference loads
    path = port.save(str(tmp_path / "sub" / "sched.json"))
    back = jat.StruMSchedule.load(path)
    assert back.to_json() == ref_text
    assert back.assignments == ref_schedule.assignments
    # a reference file loads in the port, with the same summary and lowering
    ref_path = ref_schedule.save(str(tmp_path / "ref.json"))
    loaded = tat.StruMSchedule.load(ref_path)
    assert loaded.summary() == json.loads(json.dumps(ref_schedule.summary()))
    pol, jpol = loaded.to_policy(), ref_schedule.to_policy()
    for name in ref_schedule.assignments:
        assert tat.config_to_dict(pol.resolve(name, (64, 32))) == \
            jat.config_to_dict(jpol.resolve(name, (64, 32)))
    assert pol.resolve("blk9/w", (64, 32)) is None       # unassigned: dense


def test_schedule_keys_and_none_assignments_round_trip():
    sched = tat.StruMSchedule(assignments={
        "a/w": TCfg(method="mip2q", p=0.25, L=7), "b/w": None,
        "c/w": TCfg(method="sparsity", p=0.75), "d/w": TCfg(method="dliq", p=1.0, q=3)},
        meta={"note": [1, 2.5]})
    ref = jat.StruMSchedule.from_json(sched.to_json())
    assert ref.to_json() == sched.to_json()
    assert [tat.config_key(c) for c in sched.assignments.values()] == \
        [jat.config_key(c) for c in ref.assignments.values()] == \
        ["mip2q/w16/p0.25/L7", "int8", "sparsity/w16/p0.75/q4", "dliq/w16/p1/q3"]
    assert sched.achieved_ratio({"a/w": 10, "b/w": 30, "c/w": 5, "d/w": 7}) == \
        ref.achieved_ratio({"a/w": 10, "b/w": 30, "c/w": 5, "d/w": 7})


def test_schedule_refuses_newer_version():
    doc = json.loads(tat.StruMSchedule(assignments={}).to_json())
    assert doc["version"] == tat.schedule.SCHEDULE_VERSION == 1
    doc["version"] = 2
    with pytest.raises(ValueError, match="newer"):
        tat.StruMSchedule.from_json(json.dumps(doc))


# ---------------------------------------------------------------- costmodel --

def test_cost_model_equals_reference_over_grid():
    grid = (None,) + tuple(tat.DEFAULT_GRID) + (TCfg(method="mip2q", p=0.5, L=3),
                                                TCfg(method="dliq", p=1.0, q=3))
    for cfg in grid:
        jcfg = None if cfg is None else JCfg(**dataclasses.asdict(cfg))
        for n in (1, 1000, 10_001, 2048 * 8192):
            assert tat.config_cost(cfg, n).astuple() == \
                jat.config_cost(jcfg, n).astuple(), (cfg, n)
        for metric in ("area", "power"):
            assert tcost.pe_mac_cost(cfg, metric) == jcost.pe_mac_cost(jcfg, metric)
    for L in (5, 7):
        for dynamic in (False, True):
            assert tat.level_savings(L, dynamic) == jat.level_savings(L, dynamic)


# -------------------------------------------------------------- sensitivity --

def _leaf_cases():
    rng = np.random.default_rng(4)
    return {
        "2d": rng.normal(size=(64, 48)).astype(np.float32),
        "k_not_multiple_of_w": rng.standard_t(3.0, size=(50, 24)).astype(np.float32),
        "expert_stack": rng.normal(size=(3, 40, 24)).astype(np.float32),
        "bf16": rng.normal(size=(64, 32)).astype(np.float32),
    }


@pytest.mark.parametrize("case", list(_leaf_cases()))
def test_profile_array_matches_reference(case):
    x = _leaf_cases()[case]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if case == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = jat.profile_array(jx, jat.DEFAULT_GRID, use_cache=False)
    got = tat.profile_array(tx, tat.DEFAULT_GRID, use_cache=False)
    assert list(got) == list(want) and len(got) == len(tat.DEFAULT_GRID)
    worst = max(abs(got[k] - want[k]) for k in want)
    print(f"\n{case}: largest |port - reference| SQNR over {len(want)} grid keys: "
          f"{worst:.3e} dB")
    assert worst <= PROFILE_DB, {k: (got[k], want[k]) for k in want}
    assert abs(tat.int8_sqnr_db(tx) - jat.int8_sqnr_db(jx)) <= PROFILE_DB


def test_profile_cache_is_keyed_by_content():
    tat.clear_cache()
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(32, 16)).astype(np.float32))
    a = tat.profile_array(x)
    b = tat.profile_array(x.clone())              # same bytes, new storage
    assert a == b
    assert tat.cache_info() == {"hits": 1, "misses": 1, "entries": 1}
    y = x.clone()
    y[7, 3] += 0.5                                # one element changed
    tat.profile_array(y)
    assert tat.cache_info() == {"hits": 1, "misses": 2, "entries": 2}
    tat.profile_array(x.to(torch.bfloat16))       # same shape, other dtype
    assert tat.cache_info()["misses"] == 3
    tat.clear_cache()
    assert tat.cache_info() == {"hits": 0, "misses": 0, "entries": 0}


def test_profile_tree_names_rows_as_the_reference():
    jtree, ttree = _both_trees()
    want = jat.profile_tree(jtree, use_cache=False)
    got = tat.profile_tree(ttree, use_cache=False)
    assert list(got) == list(want) == ["blk0/w", "friendly/w", "hard/w"]
    for name, row in want.items():
        assert got[name]["size"] == row["size"]
        assert got[name]["ms"] == pytest.approx(row["ms"], rel=1e-12)
        assert abs(got[name]["int8_sqnr_db"] - row["int8_sqnr_db"]) <= PROFILE_DB
        for k, v in row["sqnr_db"].items():
            assert abs(got[name]["sqnr_db"][k] - v) <= PROFILE_DB, (name, k)


# ------------------------------------------------------------------- search --

@pytest.fixture(scope="module")
def ref_profile():
    jtree, _ = _both_trees()
    return jat.profile_tree(jtree, use_cache=False)


def _budgets(profile):
    n = sum(r["size"] for r in profile.values())
    int8_energy = sum(jat.config_cost(None, r["size"]).energy for r in profile.values())
    return {"bytes": dict(target_ratio=0.8),
            "bytes+floor": dict(target_ratio=0.875, min_sqnr_db=25.0),
            "floor": dict(min_sqnr_db=28.0),
            "energy": dict(max_energy=0.8 * int8_energy),
            "energy+floor": dict(max_energy=0.9 * int8_energy, min_sqnr_db=20.0),
            "tight": dict(target_ratio=0.3 * n / n)}


@pytest.mark.parametrize("budget", ["bytes", "bytes+floor", "floor", "energy",
                                    "energy+floor", "tight"])
def test_search_on_reference_profile_gives_reference_schedule(ref_profile, budget):
    kw = _budgets(ref_profile)[budget]
    want = jat.search_schedule(None, jat.Budget(**kw), profile=ref_profile)
    got = tat.search_schedule(None, tat.Budget(**kw), profile=ref_profile)
    assert _cfg_dicts(got.assignments) == _cfg_dicts(want.assignments)
    assert list(got.assignments) == list(want.assignments)
    assert got.meta == want.meta and got.exclude == want.exclude
    assert got.to_json() == want.to_json()


def test_budget_refuses_two_cost_axes():
    with pytest.raises(ValueError, match="alternative cost axes"):
        tat.Budget(target_ratio=0.9, max_energy=1.0)
    with pytest.raises(ValueError, match="at least one"):
        tat.Budget(error_budget=1.0)
    assert tat.Budget(target_ratio=0.9, min_sqnr_db=20.0).to_dict() == \
        jat.Budget(target_ratio=0.9, min_sqnr_db=20.0).to_dict()


def test_pareto_frontier_strictly_improving_and_equal_to_reference(ref_profile):
    for name, row in ref_profile.items():
        for axis in ("bytes", "energy"):
            got = tat.pareto_frontier(tsearch._candidates(
                row, tat.DEFAULT_GRID, tat.Budget(target_ratio=1.0), axis))
            want = jat.pareto_frontier(jsearch._candidates(
                row, jat.DEFAULT_GRID, jat.Budget(target_ratio=1.0), axis))
            assert [(tat.config_key(c.cfg), c.cost, c.loss) for c in got] == \
                [(jat.config_key(c.cfg), c.cost, c.loss) for c in want]
            assert len(got) >= 2
            for a, b in zip(got, got[1:]):
                assert b.cost > a.cost and b.loss < a.loss, name
    # a dominated point and an equal-cost duplicate drop out
    C = tat.Candidate
    pts = [C(None, 0, 5.0, 10.0, 10, 10.0), C(None, 0, 6.0, 10.0, 10, 10.0),
           C(None, 0, 1.0, 8.0, 8, 8.0), C(None, 0, 0.5, 12.0, 12, 12.0),
           C(None, 0, 2.0, 11.0, 11, 11.0)]
    assert [(p.cost, p.loss) for p in tat.pareto_frontier(pts)] == [(8.0, 1.0),
                                                                   (12.0, 0.5)]


@pytest.fixture(scope="module")
def olmo_smoke():
    cfg = j_smoke("olmo_1b")
    jparams = referee.jax_params(j_model_defs(cfg), 0)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def test_profile_and_search_olmo_smoke_end_to_end(olmo_smoke):
    """Both packages profile and search the same weights; the schedules
    must be the same.  A flip names its tensor and the SQNR margin between
    the two profiles (the test is not loosened for it)."""
    jparams, tparams = olmo_smoke
    jprof = jat.profile_tree(jparams, use_cache=False)
    tprof = tat.profile_tree(tparams, use_cache=False)
    assert list(tprof) == list(jprof) and len(jprof) == 7
    margin = max(abs(tprof[n]["sqnr_db"][k] - v)
                 for n in jprof for k, v in jprof[n]["sqnr_db"].items())
    for kw in (dict(target_ratio=0.875), dict(target_ratio=0.7),
               dict(min_sqnr_db=30.0)):
        want = jat.search_schedule(jparams, jat.Budget(**kw), profile=jprof)
        got = tat.search_schedule(tparams, tat.Budget(**kw), profile=tprof)
        flips = {n: (tat.config_key(got.assignments[n]), jat.config_key(c))
                 for n, c in want.assignments.items()
                 if tat.config_key(got.assignments[n]) != jat.config_key(c)}
        assert not flips, (f"{kw}: assignments differ {flips}; largest profile "
                           f"difference {margin:.3e} dB")
        assert got.meta["total_bytes"] == want.meta["total_bytes"]
    # the port profiles straight from the tree when no profile is given
    auto = tat.search_schedule(tparams, tat.Budget(target_ratio=0.875))
    assert _cfg_dicts(auto.assignments) == _cfg_dicts(
        jat.search_schedule(jparams, jat.Budget(target_ratio=0.875),
                            profile=jprof).assignments)


# ---------------------------------------------------------------- dynamic_p --

def test_dynamic_p_wrappers_at_parity():
    jtree, ttree = _both_trees()
    for floor in (20.0, 28.0, 40.0):
        want = jdyn.choose_layer_p(jtree, sqnr_floor_db=floor)
        got = tdyn.choose_layer_p(ttree, sqnr_floor_db=floor)
        assert _cfg_dicts(got) == _cfg_dicts(want), floor
        jpol, tpol = jdyn.dynamic_policy(want), tdyn.dynamic_policy(got)
        for name in ("blk0/w", "friendly/w", "hard/w", "ln/scale", "other/w"):
            assert tat.config_to_dict(tpol.resolve(name, (64, 32))) == \
                jat.config_to_dict(jpol.resolve(name, (64, 32))), name
        assert tdyn.achieved_ratio(got, ttree) == jdyn.achieved_ratio(want, jtree)
    assert tdyn.CANDIDATE_P == jdyn.CANDIDATE_P


# -------------------------------------------------------------- speculative --

@pytest.fixture(scope="module")
def plans():
    """Model-scope plans of a small stacked tree (two layer groups of three
    linears, as the model trees stack them)."""
    rng = np.random.default_rng(6)
    blk = {"attn": {"wq": {"w": rng.normal(size=(2, 64, 32))}},
           "mlp": {"wi": {"w": rng.normal(size=(2, 32, 64))},
                   "wo": {"w": rng.normal(size=(2, 64, 32))}},
           "norm1": {"scale": np.ones((2, 32))}}
    tree = {"blocks": {"pos0": jax.tree.map(lambda a: a.astype(np.float32), blk)}}
    return (jengine.build_plan(jax.tree.map(jnp.asarray, tree), cfg=JCfg()),
            engine.build_plan(params_from_numpy(tree, device="cpu"), cfg=TCfg(),
                              device="cpu"))


@pytest.mark.parametrize("policy", [dict(mode="histream"), dict(mode="maskfree_p"),
                                    dict(mode="histream",
                                         overrides=(("mlp", "maskfree_p"),
                                                    ("wq", "full")))])
def test_draft_error_profile_matches_reference(plans, policy):
    jplan, tplan = plans
    want = jat.draft_error_profile(jplan, jengine.DraftPolicy(**policy))
    got = tat.draft_error_profile(tplan, engine.DraftPolicy(**policy))
    assert got["modes"] == want["modes"]
    assert sorted(got["per_leaf"]) == sorted(want["per_leaf"])
    for name, v in want["per_leaf"].items():
        np.testing.assert_allclose(got["per_leaf"][name], v, rtol=DRAFT_RTOL,
                                   err_msg=name)
    np.testing.assert_allclose(got["total_err2"], want["total_err2"], rtol=DRAFT_RTOL)
    for k in ("draft_bytes", "full_bytes", "ratio"):
        assert got[k] == want[k], k
    # gains scale each leaf's error
    gains = {n: 2.0 for n in want["per_leaf"]}
    g = tat.draft_error_profile(tplan, engine.DraftPolicy(**policy), gains=gains)
    np.testing.assert_allclose(g["total_err2"], 2 * got["total_err2"], rtol=1e-12)


def test_search_draft_schedule_matches_reference(plans):
    jplan, tplan = plans
    want = jat.search_draft_schedule(jplan)
    got = tat.search_draft_schedule(tplan)
    assert [(r["policy"], r["k"]) for r in got["rows"]] == \
        [(r["policy"], r["k"]) for r in want["rows"]]
    for a, b in zip(got["rows"], want["rows"]):
        for k in ("alpha_pred", "cost_ratio", "err2", "speedup_pred"):
            np.testing.assert_allclose(a[k], b[k], rtol=DRAFT_RTOL, err_msg=k)
    assert got["best"]["k"] == want["best"]["k"]
    assert got["best"]["policy"].mode == want["best"]["policy"].mode
    assert got["best"]["policy"].overrides == want["best"]["policy"].overrides
    assert tat.expected_speedup(1.0, 3, 0.5) == jat.expected_speedup(1.0, 3, 0.5)
    assert tat.predicted_acceptance(0.25) == jat.predicted_acceptance(0.25)


# --------------------------------------------------- the output-error arm --

def test_output_error_arm_needs_gains_or_a_forward(ref_profile):
    """A profile without ``output_err2`` rows and no ``fn`` to derive them
    is refused; the arms themselves are held to the reference in
    ``tests/test_torch_numerics.py``."""
    _, ttree = _both_trees()
    with pytest.raises(ValueError, match="output_error_profile"):
        tat.search_schedule(ttree, tat.Budget(target_ratio=0.875),
                            profile=ref_profile, proxy="output_error")
    assert set(tat.__all__) == set(jat.__all__)
