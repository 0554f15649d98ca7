"""The port's HeterPS scheduler (``repro_torch.core``) against the JAX
reference on the CPU.

Both packages get the same NumPy inputs.  The NumPy cost model, plans and
provisioning are held at rtol 1e-12 (never bit for bit: the reference's
own batched stage sums are not bit-exact under NumPy 2).  The device cost
model (``torch_cost``) is held against ``jax_cost`` under
``jax.enable_x64(True)`` and against the NumPy oracle at rtol 1e-9 with
feasibility equal.  The policy gets the reference's weights
(``params_from_reference``) and the reference's Gumbel noise, rebuilt
from its key stream, so sampled actions must be equal exactly.  The
reference's fused search is never called (it raises on JAX 0.9.0); its
``fused=False`` loop is.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core import jax_cost
from repro.core import plan as jplan
from repro.core import profiles as jprof
from repro.core import resources as jres
from repro.core.schedulers import ALL_SCHEDULERS as J_ALL
from repro.core.schedulers import RLScheduler as JRL
from repro.core.schedulers import policy as jpol
from repro.core.schedulers import rl as jrl
from repro_torch.core import cost_model as tcm
from repro_torch.core import plan as tplan
from repro_torch.core import profiles as tprof
from repro_torch.core import resources as tres
from repro_torch.core import torch_cost
from repro_torch.core.schedulers import ALL_SCHEDULERS as T_ALL
from repro_torch.core.schedulers import RLScheduler
from repro_torch.core.schedulers import policy as tpol
from repro_torch.core.schedulers import rl as trl
from repro_torch.core.schedulers.base import CostCache
from repro_torch.core.schedulers.static import BruteForceScheduler

# the packages export a function named like the module
jprov = importlib.import_module("repro.core.provision")
tprov = importlib.import_module("repro_torch.core.provision")
JOB, TJOB = jcm.TrainingJob(), tcm.TrainingJob()
MODELS = tuple(jprof.PAPER_MODELS)
#: (label, reference fleet, port fleet)
FLEETS = {"default": (jres.default_fleet(), tres.default_fleet()),
          "fleet4": (jres.make_fleet(4), tres.make_fleet(4))}
CASES = [(m, f) for m in MODELS for f in FLEETS]
RTOL = 1e-12
PROFS8 = tprof.profile_layers(tprof.ctrdnn_variant(8), tres.default_fleet())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The searches run thousands of tiny ops: with other test workers on
    the same cores, intra-op threads only contend, so hold this module's
    tests to one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiles(model, fleet):
    jf, tf = FLEETS[fleet]
    return (jprof.paper_model_profiles(model, jf), jf,
            tprof.paper_model_profiles(model, tf), tf)


def _plans(n_layers, n_types, n=256, seed=0):
    return np.random.default_rng(seed).integers(0, n_types, (n, n_layers))


def _close(a, b, rtol=RTOL):
    """Equal where infinite, within ``rtol`` elsewhere."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(a)
    np.testing.assert_array_equal(a[~fin], b[~fin])
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=0)


# --- resources and profiles ----------------------------------------------

@pytest.mark.parametrize("types", [2, 4, 32])
def test_fleets_equal_the_reference(types):
    jf, tf = jres.make_fleet(types), tres.make_fleet(types)
    assert [dataclasses.asdict(r) for r in jf] == \
        [dataclasses.asdict(r) for r in tf]
    assert tres.fleet_names(tf) == jres.fleet_names(jf)
    assert dataclasses.asdict(tres.TPU_V5E) == dataclasses.asdict(jres.TPU_V5E)
    assert [r.name for r in tres.default_fleet()] == ["cpu", "v100"]


@pytest.mark.parametrize("model,fleet", CASES)
def test_profiles_equal_the_reference(model, fleet):
    jp, _, tp, _ = _profiles(model, fleet)
    assert [dataclasses.asdict(p) for p in tp] == \
        [dataclasses.asdict(p) for p in jp]
    assert tprof.LAYER_KINDS == jprof.LAYER_KINDS and tprof.B_O == jprof.B_O


@pytest.mark.parametrize("layers", [8, 12, 16, 20])
def test_ctrdnn_variants_equal_the_reference(layers):
    assert tprof.ctrdnn_variant(layers) == jprof.ctrdnn_variant(layers)


def test_profiles_from_json_equal_the_reference(tmp_path):
    rows = [{"kind": "embedding", "oct": [1e-3, 2e-2],
             "odt_sync": [1e-4, 1e-4], "odt_act": [2e-5, 3e-5]},
            {"kind": "fc", "flops": 2e6, "input_bytes": 4e3,
             "weight_bytes": 4e6, "output_bytes": 4e3, "alpha": 0.9}]
    path = tmp_path / "profiles.json"
    path.write_text(json.dumps(rows))
    jp = jprof.profiles_from_json(str(path), jres.default_fleet())
    tp = tprof.profiles_from_json(str(path), tres.default_fleet())
    assert [dataclasses.asdict(p) for p in tp] == \
        [dataclasses.asdict(p) for p in jp]


# --- plan, cost model, provisioning (NumPy) --------------------------------

@pytest.mark.parametrize("model,fleet", CASES)
def test_batched_stages_match_the_reference(model, fleet):
    jp, jf, tp, tf = _profiles(model, fleet)
    A = _plans(len(jp), len(jf))
    jsb = jplan.batched_build_stages(A, jp, jf)
    tsb = tplan.batched_build_stages(A, tp, tf)
    for f in ("rtype", "mask", "num_stages"):
        np.testing.assert_array_equal(getattr(tsb, f), getattr(jsb, f))
    for f in ("oct", "odt", "alpha", "beta"):
        _close(getattr(tsb, f), getattr(jsb, f))
    for row in A[:16]:
        js = jplan.build_stages(jplan.SchedulingPlan(row), jp, jf)
        ts = tplan.build_stages(tplan.SchedulingPlan(row), tp, tf)
        assert [(s.index, s.layer_range, s.resource_type) for s in ts] == \
            [(s.index, s.layer_range, s.resource_type) for s in js]
        _close([(s.oct, s.odt, s.alpha, s.beta) for s in ts],
               [(s.oct, s.odt, s.alpha, s.beta) for s in js])


@pytest.mark.parametrize("model,fleet", CASES)
def test_batched_cost_matches_the_reference(model, fleet):
    jp, jf, tp, tf = _profiles(model, fleet)
    A = _plans(len(jp), len(jf))
    jbc, jsoft = jcm.batched_soft_plan_cost(A, jp, jf, JOB)
    tbc, tsoft = tcm.batched_soft_plan_cost(A, tp, tf, TJOB)
    _close(tbc.costs, jbc.costs)
    _close(tsoft, jsoft)
    for f in ("k", "ps_cores", "num_stages", "feasible"):
        np.testing.assert_array_equal(getattr(tbc, f), getattr(jbc, f))
    _close(tcm.batched_plan_cost(A, tp, tf, TJOB).costs, jbc.costs)


@pytest.mark.parametrize("model,fleet", CASES)
def test_scalar_cost_and_provision_match_the_reference(model, fleet):
    jp, jf, tp, tf = _profiles(model, fleet)
    for row in _plans(len(jp), len(jf), n=24, seed=1):
        jplan_, tplan_ = jplan.SchedulingPlan(row), tplan.SchedulingPlan(row)
        jc, jprov_ = jcm.plan_cost(jplan_, jp, jf, JOB)
        tc, tprov_ = tcm.plan_cost(tplan_, tp, tf, TJOB)
        _close(tc, jc)
        assert (tprov_ is None) == (jprov_ is None)
        if jprov_ is not None:
            assert dataclasses.asdict(tprov_) == dataclasses.asdict(jprov_)
            assert tplan.type_counts(tplan_, tprov_, len(tf)) == \
                jplan.type_counts(jplan_, jprov_, len(jf))
        _close(tcm.soft_plan_cost(tplan_, tp, tf, TJOB),
               jcm.soft_plan_cost(jplan_, jp, jf, JOB))
        js = jplan.build_stages(jplan_, jp, jf)
        ts = tplan.build_stages(tplan_, tp, tf)
        for ps in (False, True):
            a = jprov.provision_sta_ratio(js, jf, JOB, with_ps=ps)
            b = tprov.provision_sta_ratio(ts, tf, TJOB, with_ps=ps)
            assert (a is None and b is None) or \
                dataclasses.asdict(a) == dataclasses.asdict(b)


# --- torch_cost against jax_cost and the NumPy oracle ----------------------

@pytest.mark.parametrize("model,fleet", CASES)
def test_torch_cost_matches_jax_cost_and_the_oracle(model, fleet):
    jp, jf, tp, tf = _profiles(model, fleet)
    A = _plans(len(jp), len(jf), seed=2)
    soft, cost, feas = torch_cost.torch_soft_plan_cost(A, tp, tf, TJOB,
                                                       device="cpu")
    with jax.enable_x64(True):
        js, jc, jfeas = jax_cost.jnp_soft_plan_cost(A, jp, jf, JOB)
    assert js.dtype == np.float64
    bc, nsoft = jcm.batched_soft_plan_cost(A, jp, jf, JOB)
    for ref_soft, ref_cost, ref_feas in ((js, jc, jfeas),
                                         (nsoft, bc.costs, bc.feasible)):
        np.testing.assert_array_equal(feas, ref_feas)
        _close(soft, ref_soft, rtol=1e-9)
        _close(cost, ref_cost, rtol=1e-9)


def test_torch_cost_model_axis_and_padding():
    """Two models of one fleet stacked on the model axis, the shorter one
    padded: each scores as it does alone."""
    fl = tres.default_fleet()
    specs = [tprof.paper_model_profiles(m, fl) for m in ("MATCHNET", "NCE")]
    Lmax = max(len(p) for p in specs)
    ct = torch_cost.stack_cost_tensors([
        torch_cost.cost_tensors(p, fl, TJOB, pad_to=Lmax, device="cpu")
        for p in specs])
    rng = np.random.default_rng(3)
    A = rng.integers(0, len(fl), (2, 64, Lmax))
    both = torch_cost.soft_cost(ct, torch.as_tensor(A))
    for m, p in enumerate(specs):
        alone = torch_cost.torch_soft_plan_cost(A[m, :, :len(p)], p, fl, TJOB,
                                                device="cpu")
        np.testing.assert_array_equal(both.feasible[m].numpy(), alone[2])
        _close(both.soft[m].numpy(), alone[0], rtol=1e-12)
        _close(both.cost[m].numpy(), alone[1], rtol=1e-12)


def test_torch_cost_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    fl = tres.default_fleet()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cost.cost_tensors(PROFS8, fl, TJOB)


# --- the policy, with the reference's weights and noise --------------------

def _plan_noise(key, steps, types):
    """The Gumbel draws ``sample_plan`` makes from ``key``: per step
    ``k, ks = split(k)``, and ``categorical(ks, x)`` is
    ``argmax(x + gumbel(ks, x.shape))``."""
    def body(k, _):
        k, ks = jax.random.split(k)
        return k, jax.random.gumbel(ks, (types,), jnp.float32)

    return jax.lax.scan(body, key, None, length=steps)[1]


def _round_noise(round_key, plans, steps, types):
    keys = jax.random.split(round_key, plans)
    return np.array(jax.vmap(
        lambda k: _plan_noise(k, steps, types))(keys)), keys


@pytest.mark.parametrize("cell,padded", [("lstm", False), ("rnn", False),
                                          ("lstm", True)])
def test_policy_matches_the_reference(cell, padded):
    fl = tres.make_fleet(4)
    profs = tprof.paper_model_profiles("NCE", fl)
    T, L = len(fl), len(profs)
    P = L + 3 if padded else L
    feats, mask = tpol.layer_features(profs, pad_to=P, return_mask=True)
    jfeats = jpol.layer_features(
        jprof.paper_model_profiles("NCE", jres.make_fleet(4)), pad_to=P)
    np.testing.assert_array_equal(feats, jfeats)
    init = jpol.init_lstm if cell == "lstm" else jpol.init_rnn
    params = init(jax.random.PRNGKey(5), feats.shape[1] + T, 32, T)
    policy = tpol.params_from_reference(
        {k: np.asarray(v) for k, v in params.items()})
    N = 32
    g, keys = _round_noise(jax.random.PRNGKey(7), N, P, T)
    jmask = jnp.asarray(mask) if padded else None
    tmask = torch.as_tensor(mask)[None] if padded else None
    ja, jl = jpol.sample_batch(params, jnp.asarray(feats), keys, cell=cell,
                               num_types=T, temperature=2.0, mask=jmask)
    ta, tl = tpol.sample(policy, torch.as_tensor(feats), torch.as_tensor(g),
                         temperature=2.0, mask=tmask)
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja))
    np.testing.assert_allclose(tl[0].detach().numpy(), np.asarray(jl),
                               atol=1e-5)
    np.testing.assert_allclose(
        tpol.plan_logp(policy, torch.as_tensor(feats), ta,
                       mask=tmask)[0].detach().numpy(),
        np.asarray(jl), atol=1e-5)
    np.testing.assert_array_equal(
        tpol.greedy(policy, torch.as_tensor(feats))[0].numpy(),
        np.asarray(jpol.greedy_plan(params, jnp.asarray(feats), cell=cell,
                                    num_types=T)))

    adv = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    jg = jpol.reinforce_grad(params, jnp.asarray(feats), ja, jnp.asarray(adv),
                             cell=cell, num_types=T, mask=jmask)
    tg = tpol.reinforce_grad(policy, torch.as_tensor(feats), ta,
                             torch.as_tensor(adv)[None], mask=tmask)
    # the fused search's gradient: autograd through the sampling pass
    vg = torch.autograd.grad(tl, policy.params(),
                             grad_outputs=torch.as_tensor(adv)[None] / N)
    for name, a, b in zip(policy.names(), tg, vg):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(jg[name]),
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(b[0].numpy(), np.asarray(jg[name]),
                                   atol=1e-5, err_msg=name)


def test_adam_update_matches_the_reference():
    rng = np.random.default_rng(4)
    p = {"w": rng.standard_normal((3, 5)).astype(np.float32)}
    grads = [{"w": rng.standard_normal((3, 5)).astype(np.float32)}
             for _ in range(3)]
    jp_ = {"w": jnp.asarray(p["w"])}
    jstate = ({"w": jnp.zeros((3, 5))}, {"w": jnp.zeros((3, 5))}, 0)
    tp_ = [torch.as_tensor(p["w"]).clone()]
    tstate = ([torch.zeros(3, 5)], [torch.zeros(3, 5)], 0)
    for g in grads:
        jp_, jstate = jrl._adam_update(jp_, {"w": jnp.asarray(g["w"])},
                                       jstate, 0.03)
        tstate = trl._adam_update(tp_, [torch.as_tensor(g["w"])], tstate,
                                  0.03)
        np.testing.assert_allclose(tp_[0].numpy(), np.asarray(jp_["w"]),
                                   atol=1e-6)
    assert tstate[2] == jstate[2] == 3


# --- the search loops ------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_three_unfused_rounds_match_the_reference(monkeypatch, optimizer):
    """The port's ``fused=False`` loop, started from the reference's
    initial weights and fed the reference's noise, samples the same plans
    and ends at the same weights (atol 1e-5) as the reference's
    ``fused=False``.

    The two libraries' float32 gradients differ by ~1e-8.  Adam divides
    each gradient by its own magnitude, so where a gradient is itself
    ~1e-8 (below Adam's eps; a handful of ``wx`` entries here) that
    rounding becomes a ~1e-5 step difference: with Adam the weights are
    held at 1e-5 where every round's reference gradient is 0 or exceeds
    1e-6 (over 95% of each tensor), and everywhere with SGD.  The Adam step itself is held on equal
    gradients in ``test_adam_update_matches_the_reference``."""
    fl = tres.default_fleet()
    profs = tprof.paper_model_profiles("MATCHNET", fl)
    jprofs = jprof.paper_model_profiles("MATCHNET", jres.default_fleet())
    T, L, N, R = len(fl), len(profs), 16, 3
    kw = dict(rounds=R, plans_per_round=N, seed=0, early_stop_rounds=100,
              fused=False, optimizer=optimizer)

    key = jax.random.PRNGKey(0)
    key, kinit = jax.random.split(key)
    F = jpol.layer_features(jprofs).shape[1]
    init = {k: np.asarray(v)
            for k, v in jpol.init_lstm(kinit, F + T, 64, T).items()}
    noise = []
    for _ in range(R):
        key, ks = jax.random.split(key)
        noise.append(torch.as_tensor(_round_noise(ks, N, L, T)[0]))

    seen = {"ref": [], "port": []}
    ref_sample = jpol.sample_batch

    def ref_recording(*a, **k):
        out = ref_sample(*a, **k)
        seen["ref"].append(np.asarray(out[0]))
        return out

    ref_grad, grads = jpol.reinforce_grad, []

    def ref_grad_recording(*a, **k):
        out = ref_grad(*a, **k)
        grads.append({n: np.asarray(v) for n, v in out.items()})
        return out

    monkeypatch.setattr(jpol, "sample_batch", ref_recording)
    monkeypatch.setattr(jpol, "reinforce_grad", ref_grad_recording)
    ref = JRL(**kw)
    ref_select, final = ref._select_plan, {}

    def ref_select_recording(cache, params, *a):
        final["ref"] = {k: np.asarray(v) for k, v in params.items()}
        return ref_select(cache, params, *a)

    ref._select_plan = ref_select_recording
    jr = ref.schedule(jprofs, jres.default_fleet(), JOB)

    port_sample = tpol.sample

    def port_recording(*a, **k):
        out = port_sample(*a, **k)
        seen["port"].append(out[0][0].numpy())
        return out

    monkeypatch.setattr(tpol, "sample", port_recording)

    class Injected(RLScheduler):
        def _init_policy(self, gen, in_dim, T, models):
            return tpol.params_from_reference(init, models=models,
                                              device=self.device)

        def _noise(self, gen, shape):
            return noise.pop(0)

        def _select_plan(self, cache, policy, feats, num_layers):
            final["port"] = policy
            return super()._select_plan(cache, policy, feats, num_layers)

    tr = Injected(device="cpu", **kw).schedule(profs, fl, TJOB)
    assert len(seen["port"]) == len(seen["ref"]) == R
    for a, b in zip(seen["port"], seen["ref"]):
        np.testing.assert_array_equal(a, b)
    assert len(grads) == R
    for name, p in zip(final["port"].names(), final["port"].params()):
        held = np.ones(final["ref"][name].shape, dtype=bool)
        if optimizer == "adam":
            held = np.all([(g[name] == 0) | (np.abs(g[name]) > 1e-6)
                           for g in grads], axis=0)
            assert held.mean() > 0.95, name
        np.testing.assert_allclose(p[0].detach().numpy()[held],
                                   final["ref"][name][held], atol=1e-5,
                                   err_msg=name)
    _close(tr.extra["history"], jr.extra["history"])
    assert tr.evaluations == jr.evaluations
    assert tr.plan.assignment == jr.plan.assignment
    _close(tr.cost, jr.cost)


@pytest.fixture(scope="module")
def bf8():
    return BruteForceScheduler().schedule(PROFS8, tres.default_fleet(), TJOB)


def test_brute_force_equals_the_reference(bf8):
    jr = J_ALL["BF"]().schedule(
        jprof.profile_layers(jprof.ctrdnn_variant(8), jres.default_fleet()),
        jres.default_fleet(), JOB)
    assert bf8.evaluations == jr.evaluations == 2 ** 8
    assert bf8.plan.assignment == jr.plan.assignment
    _close(bf8.cost, jr.cost)


@pytest.mark.parametrize("fused", [True, False])
def test_search_finds_the_brute_force_optimum(bf8, fused):
    """Paper Table 2: the RL plan is the optimal BF plan."""
    r = RLScheduler(rounds=40, seed=0, fused=fused, device="cpu").schedule(
        PROFS8, tres.default_fleet(), TJOB)
    assert math.isfinite(bf8.cost)
    _close(r.cost, bf8.cost)
    assert r.extra["fused"] is fused and r.extra["device"] == "cpu"
    assert len(r.extra["history"]) == r.extra["rounds"] <= 40


def test_fused_and_unfused_agree():
    """Same seed, same draws: the fused search's rewards (device cost
    model) follow the unfused one's (NumPy) to float rounding."""
    fl = tres.default_fleet()
    profs = tprof.paper_model_profiles("MATCHNET", fl)
    rf, ru = (RLScheduler(rounds=20, seed=0, fused=f, device="cpu")
              .schedule(profs, fl, TJOB) for f in (True, False))
    assert rf.plan.assignment == ru.plan.assignment
    assert rf.evaluations == ru.evaluations
    np.testing.assert_allclose(rf.extra["history"], ru.extra["history"],
                               rtol=1e-9)


def test_schedule_many_structure_and_early_exit():
    fl2, fl4 = tres.default_fleet(), tres.make_fleet(4)
    specs = [(tprof.paper_model_profiles("NCE", fl2), fl2, TJOB),
             (PROFS8, fl2, TJOB),
             (tprof.paper_model_profiles("2EMB", fl4), fl4, TJOB)]
    sched = RLScheduler(rounds=60, seed=3, early_stop_rounds=5,
                        chunk_rounds=10, device="cpu")
    res = sched.schedule_many(specs)
    assert [r.plan.num_layers for r in res] == [5, 8, 10]
    assert [r.extra["vmapped_models"] for r in res] == [2, 2, 1]
    for r, (p, f, _) in zip(res, specs):
        assert all(0 <= a < len(f) for a in r.plan.assignment)
        assert math.isfinite(r.cost)
        assert r.extra["rounds"] == len(r.extra["history"]) < 60
        assert r.extra["fused"] and r.extra["compile_s"] >= 0
        # stopped at the first round 5 past the best, never later
        h = np.asarray(r.extra["history"])
        best_at = int(np.argmin(h))
        assert r.extra["rounds"] == best_at + 6
    # a model searched alone gives what it gave inside its group
    alone = sched.schedule_many(specs[1:2])[0]
    assert alone.plan.assignment == res[1].plan.assignment
    np.testing.assert_allclose(alone.extra["history"],
                               res[1].extra["history"], rtol=1e-12)


@pytest.mark.parametrize("fused", [True, False])
def test_warm_start_never_worse_than_incumbent(fused):
    """A warm start is an oracle-scored anchor: a tiny search returns a
    plan no worse than the incumbent it was seeded with."""
    fl = tres.default_fleet()
    profs = tprof.paper_model_profiles("CTRDNN", fl)
    incumbent = tuple(0 if p.kind in ("embedding", "nce") else 1
                      for p in profs)
    inc_cost, _ = tcm.plan_cost(tplan.SchedulingPlan(incumbent), profs, fl,
                                TJOB)
    bad = [(9,) * len(profs), (0,) * (len(profs) - 1)]  # ignored
    r = RLScheduler(rounds=2, plans_per_round=4, fused=fused,
                    device="cpu").schedule_many(
        [(profs, fl, TJOB)], warm_starts=[[incumbent, *bad]])[0]
    assert math.isfinite(inc_cost)
    assert r.cost <= inc_cost


BASELINES = ("BO", "Genetic", "Greedy", "CPU", "GPU", "Heuristic")


@pytest.mark.parametrize("name", BASELINES)
def test_baselines_equal_the_reference_and_no_better_than_bf(bf8, name):
    jr = J_ALL[name]().schedule(
        jprof.profile_layers(jprof.ctrdnn_variant(8), jres.default_fleet()),
        jres.default_fleet(), JOB)
    tr = T_ALL[name]().schedule(PROFS8, tres.default_fleet(), TJOB)
    assert tr.plan.assignment == jr.plan.assignment
    assert tr.evaluations == jr.evaluations
    _close(tr.cost, jr.cost)
    assert tr.cost >= bf8.cost * (1 - RTOL)


def test_all_schedulers_names():
    assert list(T_ALL) == list(J_ALL)


def test_cost_cache_seeding_and_pinning():
    fl = tres.default_fleet()
    cache = CostCache(PROFS8, fl, TJOB)
    a, b = (0,) + (1,) * 7, (1,) * 8
    oracle = cache.batch_call([a])[0]           # oracle-exact, feasible
    assert math.isfinite(oracle)
    assert cache.seed_from_device([a, b], [1.0, 2.0], [True, True]) == 1
    assert cache.soft(a) == cache(a) == oracle   # never overwritten
    assert cache(b) == cache.soft(b) == 2.0
    assert cache.device_seeded and cache.evaluations == 2
    cache.pin_true(b, math.inf)
    assert cache(b) == math.inf and cache.evaluations == 2


def test_rl_scheduler_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RLScheduler()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T_ALL["RL-LSTM"]()
