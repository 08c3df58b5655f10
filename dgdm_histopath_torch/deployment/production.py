"""Production orchestration: Kubernetes manifests, an autoscaling policy,
a staged deploy with rollback and the server's health report (counterpart
of the JAX package's ``deployment/production.py``).

The manifests ask for ``nvidia.com/gpu`` (the JAX package asks for
``google.com/tpu``) and name the port's image; the accelerator fields are
``gpu_resource`` / ``gpu_count``. Everything else in them is the JAX
package's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import yaml

from ..utils.dependency_check import check_dependencies
from ..utils.logging import get_logger
from ..utils.monitoring import GLOBAL_HEALTH

logger = get_logger("deployment")


@dataclass
class K8sConfig:
    name: str = "dgdm-histopath"
    namespace: str = "dgdm"
    image: str = "dgdm-histopath-torch:latest"
    replicas: int = 2
    port: int = 8080
    gpu_resource: str = "nvidia.com/gpu"
    gpu_count: int = 1
    memory: str = "16Gi"
    cpu: str = "8"
    min_replicas: int = 1
    max_replicas: int = 8
    target_cpu_percent: int = 70


class KubernetesOrchestrator:
    """The deployment, service and HPA manifests of one server; written as
    YAML, applied by whoever deploys them."""

    def __init__(self, config: Optional[K8sConfig] = None):
        self.config = config or K8sConfig()

    def deployment_manifest(self) -> dict:
        c = self.config
        return {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": c.name, "namespace": c.namespace, "labels": {"app": c.name}},
            "spec": {
                "replicas": c.replicas,
                "selector": {"matchLabels": {"app": c.name}},
                "strategy": {"type": "RollingUpdate",
                             "rollingUpdate": {"maxUnavailable": 0, "maxSurge": 1}},
                "template": {
                    "metadata": {"labels": {"app": c.name}},
                    "spec": {
                        "securityContext": {"runAsNonRoot": True, "runAsUser": 1000},
                        "containers": [{
                            "name": c.name,
                            "image": c.image,
                            "ports": [{"containerPort": c.port}],
                            "resources": {
                                "requests": {"memory": c.memory, "cpu": c.cpu,
                                             c.gpu_resource: c.gpu_count},
                                "limits": {"memory": c.memory, c.gpu_resource: c.gpu_count},
                            },
                            "livenessProbe": {"httpGet": {"path": "/healthz", "port": c.port},
                                              "initialDelaySeconds": 60, "periodSeconds": 15},
                            "readinessProbe": {"httpGet": {"path": "/readyz", "port": c.port},
                                               "initialDelaySeconds": 30, "periodSeconds": 10},
                        }],
                    },
                },
            },
        }

    def service_manifest(self) -> dict:
        c = self.config
        return {"apiVersion": "v1", "kind": "Service",
                "metadata": {"name": c.name, "namespace": c.namespace},
                "spec": {"selector": {"app": c.name},
                         "ports": [{"port": 80, "targetPort": c.port}]}}

    def hpa_manifest(self) -> dict:
        c = self.config
        return {
            "apiVersion": "autoscaling/v2", "kind": "HorizontalPodAutoscaler",
            "metadata": {"name": c.name, "namespace": c.namespace},
            "spec": {
                "scaleTargetRef": {"apiVersion": "apps/v1", "kind": "Deployment",
                                   "name": c.name},
                "minReplicas": c.min_replicas,
                "maxReplicas": c.max_replicas,
                "metrics": [{"type": "Resource",
                             "resource": {"name": "cpu",
                                          "target": {"type": "Utilization",
                                                     "averageUtilization":
                                                         c.target_cpu_percent}}}],
            },
        }

    def write_manifests(self, directory) -> List[Path]:
        """``deployment.yaml``, ``service.yaml`` and ``hpa.yaml`` in ``directory``."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        out = []
        for name, manifest in [("deployment", self.deployment_manifest()),
                               ("service", self.service_manifest()),
                               ("hpa", self.hpa_manifest())]:
            p = directory / f"{name}.yaml"
            p.write_text(yaml.safe_dump(manifest, sort_keys=False))
            out.append(p)
        return out


class AutoScaler:
    """Replica count from utilization: doubled above ``scale_up_threshold``,
    one fewer below ``scale_down_threshold``, within the bounds, and no
    change until ``cooldown_s`` after the last one."""

    def __init__(self, min_replicas: int = 1, max_replicas: int = 8,
                 scale_up_threshold: float = 0.75, scale_down_threshold: float = 0.3,
                 cooldown_s: float = 60.0):
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.scale_up_threshold = scale_up_threshold
        self.scale_down_threshold = scale_down_threshold
        self.cooldown_s = cooldown_s
        self.current = min_replicas
        self._last_change = float("-inf")
        self.history: List[Dict[str, float]] = []

    def decide(self, utilization: float, now: Optional[float] = None) -> int:
        now = now if now is not None else time.monotonic()
        target = self.current
        if now - self._last_change >= self.cooldown_s:
            if utilization > self.scale_up_threshold:
                target = min(self.current * 2, self.max_replicas)
            elif utilization < self.scale_down_threshold:
                target = max(self.current - 1, self.min_replicas)
        if target != self.current:
            self._last_change = now
            logger.info("autoscale: %d -> %d (util %.2f)", self.current, target, utilization)
            self.current = target
        self.history.append({"ts": now, "utilization": utilization, "replicas": self.current})
        return self.current


@dataclass
class DeploymentStage:
    name: str
    action: Callable[[], bool]
    rollback: Optional[Callable[[], None]] = None


class ProductionOrchestrator:
    """Stages run in order; the first that returns false or raises stops the
    deploy, and the completed stages' rollbacks run in reverse order."""

    def __init__(self):
        self.stages: List[DeploymentStage] = []
        self.log: List[Dict[str, Any]] = []

    def add_stage(self, name: str, action: Callable[[], bool],
                  rollback: Optional[Callable[[], None]] = None) -> None:
        self.stages.append(DeploymentStage(name, action, rollback))

    def deploy_to_production(self) -> Dict[str, Any]:
        completed: List[DeploymentStage] = []
        for stage in self.stages:
            t0 = time.perf_counter()
            try:
                ok = bool(stage.action())
            except Exception as exc:  # noqa: BLE001 - a raising stage is a failed stage
                ok = False
                logger.error("stage %s raised: %s", stage.name, exc)
            self.log.append({"stage": stage.name, "ok": ok,
                             "duration_s": time.perf_counter() - t0})
            if not ok:
                logger.error("deployment failed at stage %s; rolling back", stage.name)
                for done in reversed(completed):
                    if done.rollback is not None:
                        try:
                            done.rollback()
                        except Exception as exc:  # noqa: BLE001 - the other rollbacks still run
                            logger.error("rollback %s failed: %s", done.name, exc)
                return {"success": False, "failed_stage": stage.name, "log": self.log}
            completed.append(stage)
        return {"success": True, "stages": len(completed), "log": self.log}


class ProductionHealthChecker:
    """The global checks (host memory, devices) plus ``model_loaded`` (the
    predictor's model has parameters) and ``dependencies`` (every required
    module importable)."""

    def __init__(self, predictor=None):
        self.predictor = predictor

    def check(self) -> Dict[str, Any]:
        report = GLOBAL_HEALTH.check()
        checks = dict(report["checks"])
        if self.predictor is not None:
            try:
                info = self.predictor.get_model_info()
                checks["model_loaded"] = info["num_parameters"] > 0
            except Exception:  # noqa: BLE001 - a broken predictor reports unhealthy
                checks["model_loaded"] = False
        checks["dependencies"] = check_dependencies()["healthy"]
        return {"healthy": all(checks.values()), "checks": checks, "timestamp": time.time()}
