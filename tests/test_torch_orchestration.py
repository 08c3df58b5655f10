"""The port's task orchestration (``quantum/`` planner, scheduler, optimizer,
safety and distributed) against the JAX package's, on the CPU.

Both draw from ``random.Random`` / numpy generators seeded alike and make
their draws in one order, so plans, trials and placements are equal, not
close. Every manager with a thread is closed in a ``with`` block or a
``finally``.
"""

import time

import numpy as np
import pytest

from dgdm_histopath_tpu.quantum import distributed as jdist
from dgdm_histopath_tpu.quantum import optimizer as jopt
from dgdm_histopath_tpu.quantum import planner as jplan
from dgdm_histopath_tpu.quantum import safety as jsafe
from dgdm_histopath_tpu.quantum import scheduler as jsched
from dgdm_histopath_tpu.utils.exceptions import QuantumPlannerError as JaxPlannerError
from dgdm_histopath_torch.quantum import distributed as tdist
from dgdm_histopath_torch.quantum import optimizer as topt
from dgdm_histopath_torch.quantum import planner as tplan
from dgdm_histopath_torch.quantum import safety as tsafe
from dgdm_histopath_torch.quantum import scheduler as tsched
from dgdm_histopath_torch.utils.exceptions import QuantumPlannerError, SecurityError

PACKAGES = {"jax": (jplan, jsched, jopt, jsafe, jdist), "port": (tplan, tsched, topt, tsafe,
                                                                 tdist)}
# (id, priority, dependencies, estimated duration)
TASKS = [("t0", "LOW", [], 3.0), ("t1", "CRITICAL", [], 1.0), ("t2", "MEDIUM", ["t0"], 2.0),
         ("t3", "HIGH", ["t1"], 4.0), ("t4", "BACKGROUND", [], 0.5),
         ("t5", "HIGH", ["t2", "t3"], 1.5), ("t6", "MEDIUM", [], 2.5), ("t7", "LOW", ["t6"], 1.0)]


def _planner(plan_mod, seed, fail=()):
    p = plan_mod.QuantumTaskPlanner(max_workers=2, anneal_iterations=120, seed=seed)

    def boom():
        raise RuntimeError("boom")
    for tid, prio, deps, dur in TASKS:
        p.add_task(tid, fn=boom if tid in fail else (lambda t=tid: t), priority=prio,
                   dependencies=deps, estimated_duration=dur, task_id=tid)
    return p


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_plan_order_equals_jax(seed):
    orders = {k: _planner(m[0], seed).plan() for k, m in PACKAGES.items()}
    assert orders["port"] == orders["jax"]
    assert sorted(orders["port"]) == sorted(t[0] for t in TASKS)


def test_execute_statuses_equal_jax():
    """t2 fails: t5 (after t2) is cancelled, the rest complete, in both."""
    statuses = {}
    for k, m in PACKAGES.items():
        tasks = _planner(m[0], 0, fail=("t2",)).execute(timeout=30)
        statuses[k] = {tid: (t.status.value, t.result, t.error) for tid, t in tasks.items()}
    assert statuses["port"] == statuses["jax"]
    assert statuses["port"]["t5"][0] == "cancelled"
    assert statuses["port"]["t7"] == ("completed", "t7", None)


def test_a_cycle_raises_in_both():
    for mod, err in ((jplan, JaxPlannerError), (tplan, QuantumPlannerError)):
        p = mod.QuantumTaskPlanner()
        a = p.add_task("a", task_id="a")
        p.add_task("b", dependencies=[a], task_id="b")
        p.tasks["a"].dependencies.append("b")
        with pytest.raises(err, match="cycle"):
            p.plan()
        with pytest.raises(err, match="unknown dependency"):
            p.add_task("c", dependencies=["nope"])


@pytest.mark.parametrize("strategy", ["fifo", "priority", "resource_aware", "annealed"])
def test_scheduler_order_and_gating_equal_jax(strategy):
    """Each strategy runs the same jobs in the same order; under
    resource_aware a job asking for more free memory than the injected
    snapshot shows is deferred."""
    runs = {}
    for k, m in PACKAGES.items():
        sched_mod = m[1]
        s = sched_mod.QuantumScheduler(max_workers=1, strategy=strategy)
        s.resource_history.append(sched_mod.ResourceSnapshot(
            time.time(), cpu_load_1m=0.5, mem_available_mb=1000.0, mem_total_mb=4000.0))
        ran = []
        for name, prio, need in (("a", "LOW", 0), ("b", "CRITICAL", 0), ("c", "MEDIUM", 5000),
                                 ("d", "HIGH", 0)):
            s.submit(name, lambda n=name: ran.append(n) or n, priority=prio,
                     min_free_mem_mb=need)
        jobs = s.run_pending()
        runs[k] = (ran, sorted((j.name, j.status, j.result) for j in jobs.values()),
                   s.status_summary())
    assert runs["port"] == runs["jax"]
    assert ("c", "deferred", None) in runs["port"][1] if strategy == "resource_aware" \
        else len(runs["port"][0]) == 4


def test_read_resources_and_monitor():
    snap = tsched.read_resources()
    assert snap.device_mem_used_mb == 0.0 and snap.device_mem_total_mb == 0.0
    assert snap.mem_total_mb > 0 and 0.0 <= snap.mem_used_fraction <= 1.0
    with tsched.QuantumScheduler(monitor_interval=0.02) as s:
        deadline = time.time() + 5
        while not s.resource_history and time.time() < deadline:
            time.sleep(0.01)
    assert s._monitor_thread is None and s.resource_history
    assert s.current_resources() is s.resource_history[-1]


def _objective(cfg):
    return (np.log10(cfg["learning_rate"]) + 4) ** 2 + cfg["dropout"] + 0.01 * \
        cfg["num_diffusion_steps"] + (0.5 if cfg["pooling"] == "set2set" else 0.0) + \
        len(cfg["hidden_dims"]) * 0.1


@pytest.mark.parametrize("mode", ["min", "max"])
def test_optimizer_trials_equal_jax(mode):
    res = {}
    for k, m in PACKAGES.items():
        opt = m[2].QuantumOptimizer(m[2].dgdm_search_space(), _objective, mode=mode,
                                    population=3, seed=5)
        best = opt.optimize(n_trials=12, early_stop_patience=6)
        res[k] = (best, [(t.trial_id, t.config, t.value) for t in opt.history], opt.convergence)
    assert res["port"] == res["jax"]


def test_optimizer_failing_trial_scores_worst():
    def objective(cfg):
        if cfg["x"] > 0.2:
            raise ValueError("bad region")
        return cfg["x"]
    res = {}
    for k, m in PACKAGES.items():
        opt = m[2].QuantumOptimizer(m[2].OptimizationSpace().add_float("x", 0.0, 1.0),
                                    objective, seed=3, population=2)
        res[k] = (opt.optimize(n_trials=8), [t.value for t in opt.history])
    assert res["port"] == res["jax"] and np.inf in res["port"][1]


def _safety_outcomes(safe_mod, sched_mod):
    """register, authenticate, lockout, roles and the guarded scheduler."""
    out = []
    man = safe_mod.QuantumSafetyManager(max_failed_attempts=2, lockout_seconds=60.0)
    man.register_user("alice", "correct-horse")
    man.register_user("root", "admin-password", role="admin")
    for call in (lambda: man.register_user("alice", "another-pass"),
                 lambda: man.register_user("bob", "short"),
                 lambda: man.authenticate("mallory", "whatever1")):
        with pytest.raises(Exception) as info:
            call()
        out.append(type(info.value).__name__)
    token = man.authenticate("alice", "correct-horse")
    out.append(man.verify_session(token))
    for _ in range(2):
        with pytest.raises(Exception) as info:
            man.authenticate("alice", "wrong-password")
        out.append(str(info.value).split(" (context")[0])
    with pytest.raises(Exception) as info:
        man.authenticate("alice", "correct-horse")         # locked
    out.append(str(info.value).split(" (context")[0])
    out.append(man.authorize_submission(token, "job", "HIGH"))
    with pytest.raises(Exception) as info:
        man.authorize_submission(token, "job", "CRITICAL")
    out.append(str(info.value))
    admin = man.authenticate("root", "admin-password")
    out.append((man.role_of("root"), man.authorize_submission(admin, "job", "CRITICAL")))
    with pytest.raises(Exception):
        man.verify_session(token + "x")
    safe = safe_mod.SafeScheduler(scheduler=sched_mod.QuantumScheduler(max_workers=1),
                                  safety=man)
    jid = safe.submit(token, "predict", lambda: 42)
    out.append(safe.run_pending(token)[jid].result)
    with pytest.raises(Exception):
        safe.submit("forged", "predict", lambda: 0)
    out.append(sorted(man.audit_summary().items()))
    return out


def test_safety_outcomes_equal_jax():
    port = _safety_outcomes(tsafe, tsched)
    assert port == _safety_outcomes(jsafe, jsched)
    assert port[:3] == ["SecurityError"] * 3 and port[6] == "account locked"
    with pytest.raises(SecurityError):
        tsafe.QuantumSafetyManager().verify_session("not-a-token")


def test_cluster_kv_ttl_and_prefix():
    for mod in (jdist, tdist):
        kv = mod.ClusterKV()
        kv.set("nodes/a", 1, ttl_s=0.05)
        kv.set("nodes/b", 2)
        kv.set("tasks/c", 3, ttl_s=60)
        assert sorted(kv.keys("nodes/")) == ["nodes/a", "nodes/b"]
        time.sleep(0.08)
        assert kv.get("nodes/a", "gone") == "gone" and kv.keys("nodes/") == ["nodes/b"]
        kv.set("nodes/b", 4, ttl_s=None)
        kv.delete("tasks/c")
        assert kv.get("nodes/b") == 4 and kv.keys() == ["nodes/b"]


PEERS = [("node-a", 0.2, 1.0, ["cpu", "cuda"]), ("node-b", 0.7, 2.0, ["cpu"]),
         ("node-c", 0.0, 0.5, ["cpu", "cuda"]), ("node-d", 0.4, 1.5, ["cpu", "cuda"])]


@pytest.mark.parametrize("strategy", ["round_robin", "least_loaded", "capability_match",
                                      "quantum_annealing"])
def test_placement_equals_jax(strategy):
    placed = {}
    for k, m in PACKAGES.items():
        mod = m[4]
        with mod.QuantumDistributedManager(
                strategy=mod.TaskDistributionStrategy(strategy), num_workers=2,
                heartbeat_interval_s=600, seed=11, capabilities=["cpu"]) as man:
            man.kv.delete(f"nodes/{man.local_node.node_id}")
            for nid, load, score, caps in PEERS:
                man.register_node(mod.ComputeNode(nid, current_load=load,
                                                  performance_score=score, capabilities=caps))
            ids = []
            for i in range(12):
                caps = ["cuda"] if i % 3 == 0 else []
                tid = man.submit_task(lambda i=i: i * i, required_capabilities=caps)
                ids.append((man._tasks[tid].assigned_node, man.get_result(tid, timeout=10)))
            with pytest.raises(RuntimeError, match="capabilities"):
                man.submit_task(lambda: 0, required_capabilities=["tpu"])
        placed[k] = ids
    assert placed["port"] == placed["jax"]


def test_dependencies_equal_jax():
    res = {}
    for k, m in PACKAGES.items():
        mod = m[4]
        with mod.QuantumDistributedManager(num_workers=2, heartbeat_interval_s=600) as man:
            order = []
            a = man.submit_task(lambda: order.append("a") or 1, priority=1)
            b = man.submit_task(lambda: order.append("b") or 2, priority=9, dependencies=[a])

            def boom():
                raise RuntimeError("boom")
            bad = man.submit_task(boom)
            after = man.submit_task(lambda: 3, dependencies=[bad])
            with pytest.raises(ValueError, match="unknown dependency"):
                man.submit_task(lambda: 0, dependencies=["task-missing"])
            got = [man.get_result(b, timeout=10)]
            for tid in (bad, after):
                with pytest.raises(RuntimeError) as info:
                    man.get_result(tid, timeout=10)
                got.append(str(info.value).split(":")[-1].strip())
            man.wait_all(timeout=10)
            status = man.get_cluster_status()["tasks"]
            res[k] = (order, got, status)
        assert not man._scheduler._workers[0].is_alive()
    assert res["port"] == res["jax"]
    assert res["port"][0] == ["a", "b"] and res["port"][2]["failed"] == 2


def test_local_node_reports_the_card_or_cpu():
    with tdist.QuantumDistributedManager(num_workers=1, heartbeat_interval_s=0.02) as man:
        caps, beat = man.local_node.capabilities, man.local_node.last_heartbeat
        deadline = time.time() + 5
        while man.local_node.last_heartbeat == beat and time.time() < deadline:
            time.sleep(0.01)
        assert man.local_node.last_heartbeat > beat
    assert not man._hb_thread.is_alive()
    import torch
    assert caps == (["cpu", "cuda"] if torch.cuda.is_available() else ["cpu"])
