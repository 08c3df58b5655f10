"""The port's tenants (``enterprise/``), production orchestration
(``deployment/production.py``) and top-level report against the JAX
package's, on the CPU; that every public name of the JAX ``quantum``,
``enterprise``, ``clinical`` and ``deployment`` packages exists in the port;
and that no module of the port (nor ``chip_smoke.py``) imports JAX, flax,
optax or the JAX package, read with ``ast``.
"""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import yaml

import dgdm_histopath_torch
import dgdm_histopath_tpu
from dgdm_histopath_tpu.deployment import production as jprod
from dgdm_histopath_tpu.enterprise import multi_tenant as jmt
from dgdm_histopath_torch.deployment import production as tprod
from dgdm_histopath_torch.enterprise import multi_tenant as tmt
from dgdm_histopath_torch.utils.exceptions import ResourceError, SecurityError

REPO = Path(__file__).resolve().parents[1]


def _tenant_outcomes(mod, root):
    """Quotas, the job slot, isolation, keys, roles, revoke and deactivate:
    each call's result or the name and message of what it raised."""
    out = []

    def rec(fn):
        try:
            out.append(("ok", fn()))
        except Exception as exc:  # noqa: BLE001 - the outcome is what is compared
            out.append((type(exc).__name__, str(exc).split(" (context")[0]))

    man = mod.MultiTenantManager(root)
    t = man.create_tenant("clinic", mod.TenantQuota(max_slides_per_day=3,
                                                    max_concurrent_jobs=1, max_storage_gb=1.0))
    other = man.create_tenant("lab")
    rec(lambda: man.resources.charge_slide(t, 2))
    rec(lambda: man.resources.charge_slide(t, 2))
    rec(lambda: man.resources.charge_storage(t, 0.75))
    rec(lambda: man.resources.charge_storage(t, 0.5))
    slot = man.resources.acquire_job_slot(t)
    rec(lambda: man.resources.acquire_job_slot(t))
    with slot:
        pass
    rec(lambda: man.resources.usage(t.tenant_id))
    rec(lambda: man.isolation.resolve(t.tenant_id, "a/b.npz").relative_to(
        Path(root).resolve()).parts[1:])
    rec(lambda: man.isolation.resolve(t.tenant_id, "../" + other.tenant_id + "/x"))
    rec(lambda: man.isolation.tenant_dir("../.."))
    analyst = man.auth.issue_key(t.tenant_id)
    viewer = man.auth.issue_key(other.tenant_id, role="viewer")
    rec(lambda: man.auth.issue_key(t.tenant_id, role="owner"))
    rec(lambda: man.run_job(analyst, lambda a, b: a + b, 2, b=3))
    rec(lambda: man.run_job(viewer, lambda: 0))

    def nested():
        return man.run_job(analyst, lambda: man.run_job(analyst, lambda: 1))
    rec(nested)
    rec(lambda: man.resources.usage(t.tenant_id)["running_jobs"])
    rec(lambda: man.auth.authorize(viewer, "predict:read")["role"])
    man.deactivate_tenant(t.tenant_id)
    rec(lambda: man.run_job(analyst, lambda: 0))
    rec(lambda: man.auth.revoke_tenant(other.tenant_id))
    rec(lambda: sorted((s["name"], s["active"]) for s in man.status().values()))
    return out


def test_tenants_equal_jax(tmp_path):
    port = _tenant_outcomes(tmt, tmp_path / "port")
    assert port == _tenant_outcomes(jmt, tmp_path / "jax")
    kinds = [o[0] for o in port]
    assert kinds.count("ResourceError") == 4 and kinds.count("SecurityError") == 5
    assert tmt.ROLE_PERMISSIONS == jmt.ROLE_PERMISSIONS and tmt.ROLES == jmt.ROLES


def test_run_job_releases_its_slot_when_the_job_raises(tmp_path):
    man = tmt.MultiTenantManager(tmp_path)
    t = man.create_tenant("clinic", tmt.TenantQuota(max_concurrent_jobs=1))
    key = man.auth.issue_key(t.tenant_id)

    def boom():
        raise RuntimeError("job failed")
    with pytest.raises(RuntimeError):
        man.run_job(key, boom)
    assert man.run_job(key, lambda: 7) == 7
    with pytest.raises(SecurityError):
        man.auth.authenticate("dgdm_forged")
    with pytest.raises(ResourceError):
        man.resources.charge_slide(t, 1001)


@pytest.mark.parametrize("which", ["deployment", "service", "hpa"])
def test_manifests_equal_jax_but_for_the_accelerator_and_image(tmp_path, which):
    ours = tprod.KubernetesOrchestrator()
    theirs = jprod.KubernetesOrchestrator()
    paths = ours.write_manifests(tmp_path / "port")
    jpaths = theirs.write_manifests(tmp_path / "jax")
    assert [p.name for p in paths] == [p.name for p in jpaths]
    got = yaml.safe_load((tmp_path / "port" / f"{which}.yaml").read_text())
    want = yaml.safe_load((tmp_path / "jax" / f"{which}.yaml").read_text())
    assert got == getattr(ours, f"{which}_manifest")()
    if which == "deployment":
        c = got["spec"]["template"]["spec"]["containers"][0]
        jc = want["spec"]["template"]["spec"]["containers"][0]
        assert c["resources"]["requests"]["nvidia.com/gpu"] == 1
        assert c["resources"]["limits"]["nvidia.com/gpu"] == 1
        assert jc["resources"]["requests"]["google.com/tpu"] == 1
        assert (c["image"], jc["image"]) == ("dgdm-histopath-torch:latest",
                                            "dgdm-histopath-tpu:latest")
        for res in (c, jc):
            for side in ("requests", "limits"):
                res["resources"][side].pop("nvidia.com/gpu", None)
                res["resources"][side].pop("google.com/tpu", None)
            res.pop("image")
    assert got == want


@pytest.mark.parametrize("seed,cooldown", [(0, 0.0), (1, 3.0), (2, 10.0)])
def test_autoscaler_decisions_equal_jax(seed, cooldown):
    rs = np.random.RandomState(seed)
    trace = rs.rand(80)
    kw = dict(min_replicas=1, max_replicas=6, cooldown_s=cooldown)
    ours, theirs = tprod.AutoScaler(**kw), jprod.AutoScaler(**kw)
    got = [ours.decide(float(u), now=float(i)) for i, u in enumerate(trace)]
    assert got == [theirs.decide(float(u), now=float(i)) for i, u in enumerate(trace)]
    assert ours.history == theirs.history and len(set(got)) > 1


def test_rollback_runs_in_reverse_order():
    runs = {}
    for mod in (tprod, jprod):
        order = []
        orch = mod.ProductionOrchestrator()
        for name in ("load", "health", "canary"):
            orch.add_stage(name, lambda n=name: order.append(n) or True,
                           rollback=lambda n=name: order.append("undo " + n))
        orch.add_stage("bad rollback", lambda: True, rollback=lambda: 1 / 0)
        orch.add_stage("promote", lambda: 1 / 0)
        orch.add_stage("never", lambda: order.append("never") or True)
        res = orch.deploy_to_production()
        runs[mod.__name__.split(".")[0]] = (order, res["success"], res["failed_stage"],
                                            [(e["stage"], e["ok"]) for e in res["log"]])
    assert runs["dgdm_histopath_torch"] == runs["dgdm_histopath_tpu"]
    assert runs["dgdm_histopath_torch"][0] == ["load", "health", "canary", "undo canary",
                                               "undo health", "undo load"]
    assert tprod.ProductionOrchestrator().deploy_to_production() == {
        "success": True, "stages": 0, "log": []}


def test_check_installation_reports_the_jax_keys_and_the_torch_build():
    report = dgdm_histopath_torch.check_installation()
    assert set(dgdm_histopath_tpu.check_installation()) - {"devices_error"} <= set(report)
    assert report["core_available"] and report["full_available"] and report["quantum_available"]
    import torch
    assert report["torch_version"] == torch.__version__
    assert report["devices"] == [torch.cuda.get_device_name(i)
                                 for i in range(torch.cuda.device_count())]
    info = dgdm_histopath_torch.get_build_info()
    assert info["version"] == dgdm_histopath_tpu.__version__ and "torch_version" in info


@pytest.mark.parametrize("package", ["quantum", "enterprise", "clinical", "deployment", ""])
def test_every_jax_public_name_exists_in_the_port(package):
    jax_mod = importlib.import_module("dgdm_histopath_tpu" + (f".{package}" if package else ""))
    port = importlib.import_module("dgdm_histopath_torch" + (f".{package}" if package else ""))
    missing = [n for n in jax_mod.__all__ if not hasattr(port, n)]
    assert not missing
    if package:
        assert set(jax_mod.__all__) <= set(port.__all__)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.fixture(scope="module")
def port_imports():
    """(file, imported module) of every import in the port and chip_smoke.py."""
    files = sorted((REPO / "dgdm_histopath_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 100
    return [(f.relative_to(REPO), name) for f in files for name in _imports(f)]


@pytest.mark.parametrize("banned", ["jax", "flax", "optax", "dgdm_histopath_tpu"])
def test_the_port_imports_no_jax(port_imports, banned):
    offenders = [f"{f}: {name}" for f, name in port_imports
                 if name == banned or name.startswith(banned + ".")]
    assert not offenders
