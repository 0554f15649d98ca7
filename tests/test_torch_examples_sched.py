"""The port's ``repro_torch.examples.quickstart`` and
``schedule_all_archs`` against the reference's examples on the CPU.

The searches are shortened on both sides: ``RL_ROUNDS`` of the port's
modules and the ``rounds`` of the reference's ``RLScheduler`` (built
through a recording subclass) become ``ROUNDS``, and
``schedule_all_archs`` schedules ``ARCHS``, 3 of the 10 (the port's
``ARCHS``, the reference's ``ARCH_IDS``).  The reference's fused search
runs with R1 patched.

The baselines and the cost model are deterministic NumPy: Greedy's and
Heuristic's costs and plans must equal the reference's at rtol 1e-12
(R2: never bit for bit).  The RL searches draw from different
generators, so each RL cost is held to the cost model of its own plan,
the port's and the reference's.  Quickstart's training leg must lower
the loss, as the reference's does (7.532 → 4.414 over 20 steps); its
numbers are not compared, since ``train`` draws its own weights
(``tests/test_torch_train.py`` holds ``train`` against the reference).
"""

from __future__ import annotations

import contextlib
import io
import math
import re

import pytest

from _torch_examples import (load_chip_smoke, load_reference, one_thread,
                             patch_r1, record_calls, record_instances)
from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.core import SchedulingPlan as JPlan
from repro.core import TrainingJob as JJob
from repro.core import build_stages as jbuild_stages
from repro.core import default_fleet as jdefault_fleet
from repro.core import make_fleet as jmake_fleet
from repro.core import paper_model_profiles as jpaper_profiles
from repro.core import pipeline_throughput as jthroughput
from repro.core import plan_cost as jplan_cost
from repro.core.schedulers import GreedyScheduler as JGreedy
from repro.core.schedulers import HeuristicScheduler as JHeuristic
from repro.models.profile import profile_arch as jprofile_arch
from repro_torch.core import (SchedulingPlan, TrainingJob, default_fleet,
                              make_fleet, paper_model_profiles, plan_cost)
from repro_torch.examples import quickstart as tqs
from repro_torch.examples import schedule_all_archs as tsa
from repro_torch.models.profile import profile_arch

ROUNDS = 12
ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "jamba-v0.1-52b")
SCHEDULERS = ("RLScheduler", "GreedyScheduler", "HeuristicScheduler")
BASELINES = {"Greedy": "greedy", "Heuristic": "heuristic"}
ALL_ARCHS_JOB = dict(batch_size=256, throughput_limit=2_000.0,
                     num_examples=50_000_000)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from one_thread()


def _run(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def _close(got: float, want: float, rtol: float = 1e-12) -> bool:
    """Equal where infinite, within ``rtol`` elsewhere."""
    if math.isinf(want):
        return got == want
    return math.isclose(got, want, rel_tol=rtol, abs_tol=0.0)


def _scheduler_recorders(mp, mod):
    return {name: record_instances(
        mp, mod, name, **({"rounds": ROUNDS} if name == "RLScheduler"
                          else {})) for name in SCHEDULERS}


# --------------------------------------------------------------------------
# quickstart
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quickstart_ref():
    import repro.launch.train as jtrain

    ref = load_reference("quickstart")
    with pytest.MonkeyPatch.context() as mp:
        patch_r1(mp)
        made = _scheduler_recorders(mp, ref)
        trained = record_calls(mp, jtrain, "train")
        _, lines = _run(ref.main)
    results = {inst.name: r for rec in made.values()
               for inst, r in rec.results}
    return {"results": results, "train": trained[0], "lines": lines}


@pytest.fixture(scope="module")
def quickstart_port():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tqs, "RL_ROUNDS", ROUNDS)
        out, lines = _run(lambda: tqs.main(["--device", "cpu"]))
    return {"out": out, "lines": lines}


@pytest.mark.parametrize("name", BASELINES)
def test_quickstart_baselines_equal_the_reference(quickstart_ref,
                                                  quickstart_port, name):
    ref = quickstart_ref["results"][name]
    got = quickstart_port["out"]["schedulers"][name]
    assert got["plan"] == list(ref.plan.assignment)
    assert _close(got["cost"], ref.cost)


def test_quickstart_rl_cost_is_its_plans_cost(quickstart_ref,
                                              quickstart_port):
    """The port's RL plan priced by both packages' cost models, and its
    stages, provisioning and throughput as the reference computes them
    for that plan."""
    out = quickstart_port["out"]
    got = out["schedulers"]["RL-LSTM"]
    fleet, job = default_fleet(), TrainingJob()
    cost, prov = plan_cost(SchedulingPlan(tuple(got["plan"])),
                           paper_model_profiles(tqs.MODEL, fleet), fleet, job)
    jfleet, jjob = jdefault_fleet(), JJob()
    jprofiles = jpaper_profiles(tqs.MODEL, jfleet)
    jplan = JPlan(tuple(got["plan"]))
    jcost, jprov = jplan_cost(jplan, jprofiles, jfleet, jjob)
    assert _close(got["cost"], cost, rtol=1e-9)
    assert _close(got["cost"], jcost, rtol=1e-9)
    assert out["k"] == list(prov.k) == list(jprov.k)
    assert out["ps_cores"] == prov.ps_cores == jprov.ps_cores
    jstages = jbuild_stages(jplan, jprofiles, jfleet)
    assert out["stages"] == len(jstages)
    assert _close(out["throughput"],
                  jthroughput(jstages, jprov, jjob.batch_size))
    ref = quickstart_ref["results"]["RL-LSTM"]
    assert _close(ref.cost, jplan_cost(ref.plan, jprofiles, jfleet,
                                       jjob)[0], rtol=1e-9)


def test_quickstart_training_lowers_the_loss(quickstart_ref,
                                             quickstart_port):
    got, ref = quickstart_port["out"]["train"], quickstart_ref["train"]
    assert got["steps"] == ref["steps"] == tqs.TRAIN_STEPS
    assert ref["loss_decreased"] and got["loss_decreased"]
    assert got["last_loss"] < got["first_loss"]


def _skeleton(line: str) -> str:
    """``line`` with its numbers masked and its runs of spaces made one
    (a measured column's width follows its digits)."""
    return " ".join(re.sub(r"[0-9]+(\.[0-9]+)?", "#", line).split())


def test_quickstart_prints_the_reference_lines(quickstart_ref,
                                               quickstart_port):
    assert ([_skeleton(s) for s in quickstart_port["lines"]]
            == [_skeleton(s) for s in quickstart_ref["lines"]])


# --------------------------------------------------------------------------
# schedule_all_archs
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def all_archs_ref():
    ref = load_reference("schedule_all_archs")
    with pytest.MonkeyPatch.context() as mp:
        patch_r1(mp)
        mp.setattr(ref, "ARCH_IDS", ARCHS)
        made = _scheduler_recorders(mp, ref)
        _, lines = _run(ref.main)
    by_arch = {}
    for name, rec in made.items():
        for arch, (_, r) in zip(ARCHS, rec.results):
            by_arch.setdefault(arch, {})[name] = r
    return {"results": by_arch, "lines": lines}


@pytest.fixture(scope="module")
def all_archs_port():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsa, "ARCHS", ARCHS)
        mp.setattr(tsa, "RL_ROUNDS", ROUNDS)
        out, lines = _run(lambda: tsa.main(["--device", "cpu"]))
    return {"out": out, "lines": lines}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", BASELINES)
def test_all_archs_baselines_equal_the_reference(all_archs_ref,
                                                 all_archs_port, arch, name):
    ref = all_archs_ref["results"][arch][f"{name}Scheduler"]
    row = all_archs_port["out"]["archs"][arch]
    key = BASELINES[name]
    assert row[f"{key}_plan"] == list(ref.plan.assignment)
    assert _close(row[f"{key}_cost"], ref.cost)


@pytest.mark.parametrize("arch", ARCHS)
def test_all_archs_rl_cost_is_its_plans_cost(all_archs_ref, all_archs_port,
                                             arch):
    row = all_archs_port["out"]["archs"][arch]
    fleet = make_fleet(tsa.FLEET_TYPES)
    cost, _ = plan_cost(SchedulingPlan(tuple(row["rl_plan"])),
                        profile_arch(arch, fleet), fleet,
                        TrainingJob(**tsa.JOB))
    assert _close(row["rl_cost"], cost, rtol=1e-9)
    assert math.isfinite(row["rl_cost"])
    jfleet = jmake_fleet(tsa.FLEET_TYPES)
    jprofiles = jprofile_arch(arch, jfleet)
    assert row["layers"] == len(jprofiles)
    ref = all_archs_ref["results"][arch]["RLScheduler"]
    assert _close(ref.cost, jplan_cost(ref.plan, jprofiles, jfleet,
                                       JJob(**ALL_ARCHS_JOB))[0], rtol=1e-9)


def test_all_archs_prints_the_reference_lines(all_archs_ref, all_archs_port):
    port, ref = all_archs_port["lines"], all_archs_ref["lines"]
    assert port[:3] == ref[:3]
    assert [s.split()[0] for s in port[3:]] == [s.split()[0] for s in ref[3:]]
    assert len(port) == len(ref) == 3 + len(ARCHS)


def test_all_archs_job_is_the_reference_job():
    assert tsa.JOB == ALL_ARCHS_JOB


# --------------------------------------------------------------------------
# the numbers phase 19 of chip_smoke.py holds the examples to on the card
# --------------------------------------------------------------------------


def test_chip_smoke_baselines_are_the_reference_baselines():
    """``REF_ALL_ARCHS`` and ``REF_QUICKSTART`` are the reference's
    Greedy and Heuristic results at the examples' defaults: all ten
    archs on ``make_fleet(4)``, and CTRDNN on the paper's fleet."""
    cs = load_chip_smoke()
    fleet, job = jmake_fleet(tsa.FLEET_TYPES), JJob(**ALL_ARCHS_JOB)
    assert set(cs.REF_ALL_ARCHS) == set(J_ARCH_IDS)
    for arch in J_ARCH_IDS:
        profiles = jprofile_arch(arch, fleet)
        got = cs.REF_ALL_ARCHS[arch]
        for want, sched in zip(got, (JGreedy(), JHeuristic())):
            assert _close(want, sched.schedule(profiles, fleet, job).cost)
    fleet, job = jdefault_fleet(), JJob()
    profiles = jpaper_profiles("CTRDNN", fleet)
    for sched in (JGreedy(), JHeuristic()):
        r = sched.schedule(profiles, fleet, job)
        assert list(r.plan.assignment) == cs.REF_QUICKSTART["plan"]
        assert _close(cs.REF_QUICKSTART["cost"], r.cost)
        assert list(r.prov.k) == cs.REF_QUICKSTART["k"]
        assert r.prov.ps_cores == cs.REF_QUICKSTART["ps_cores"]
