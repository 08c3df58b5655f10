"""Tenants: quotas and usage, isolated storage, API keys and roles
(counterpart of the JAX package's ``enterprise/multi_tenant.py``).

``MultiTenantManager.run_job(key, fn, ...)`` authorizes the key for
``train:run``, refuses a deactivated tenant, holds one of the tenant's
concurrent-job slots while ``fn`` runs and releases it after, whether ``fn``
returned or raised. Keys are stored as PBKDF2 hashes
(``utils.security.hash_password``).
"""

from __future__ import annotations

import secrets
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

from ..utils.exceptions import ResourceError, SecurityError
from ..utils.logging import get_logger
from ..utils.security import hash_password, verify_password

logger = get_logger("enterprise")


@dataclass
class TenantQuota:
    max_slides_per_day: int = 1000
    max_concurrent_jobs: int = 4
    max_storage_gb: float = 100.0
    priority: int = 1                 # higher = more scheduler weight


@dataclass
class Tenant:
    tenant_id: str
    name: str
    quota: TenantQuota = field(default_factory=TenantQuota)
    created_at: float = field(default_factory=time.time)
    active: bool = True


class TenantResourceManager:
    """Quota checks and usage accounting per tenant; the daily slide count
    starts over each UTC day."""

    def __init__(self):
        self._usage: Dict[str, Dict[str, float]] = {}
        self._day: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _roll_day(self, tenant_id: str) -> None:
        today = int(time.time() // 86400)
        if self._day.get(tenant_id) != today:
            self._day[tenant_id] = today
            self._usage.setdefault(tenant_id, {})["slides_today"] = 0.0

    def charge_slide(self, tenant: Tenant, count: int = 1) -> None:
        with self._lock:
            self._roll_day(tenant.tenant_id)
            usage = self._usage.setdefault(tenant.tenant_id, {})
            used = usage.get("slides_today", 0.0) + count
            if used > tenant.quota.max_slides_per_day:
                raise ResourceError("daily slide quota exceeded",
                                    {"tenant": tenant.tenant_id,
                                     "quota": tenant.quota.max_slides_per_day})
            usage["slides_today"] = used

    def acquire_job_slot(self, tenant: Tenant) -> "JobSlot":
        with self._lock:
            usage = self._usage.setdefault(tenant.tenant_id, {})
            running = usage.get("running_jobs", 0.0)
            if running >= tenant.quota.max_concurrent_jobs:
                raise ResourceError("concurrent job quota exceeded", {"tenant": tenant.tenant_id})
            usage["running_jobs"] = running + 1
        return JobSlot(self, tenant.tenant_id)

    def _release_job(self, tenant_id: str) -> None:
        with self._lock:
            usage = self._usage.setdefault(tenant_id, {})
            usage["running_jobs"] = max(0.0, usage.get("running_jobs", 0.0) - 1)

    def charge_storage(self, tenant: Tenant, gb: float) -> None:
        with self._lock:
            usage = self._usage.setdefault(tenant.tenant_id, {})
            total = usage.get("storage_gb", 0.0) + gb
            if total > tenant.quota.max_storage_gb:
                raise ResourceError("storage quota exceeded", {"tenant": tenant.tenant_id})
            usage["storage_gb"] = total

    def usage(self, tenant_id: str) -> Dict[str, float]:
        with self._lock:
            return dict(self._usage.get(tenant_id, {}))


class JobSlot:
    """One held concurrent-job slot; leaving the ``with`` block frees it."""

    def __init__(self, manager: TenantResourceManager, tenant_id: str):
        self._manager = manager
        self._tenant_id = tenant_id

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._manager._release_job(self._tenant_id)
        return False


class TenantIsolationManager:
    """A directory per tenant under ``root``; a path that resolves outside
    the tenant's directory is refused."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def tenant_dir(self, tenant_id: str) -> Path:
        safe = "".join(c for c in tenant_id if c.isalnum() or c in "-_")
        if not safe:
            raise SecurityError("invalid tenant id", {"tenant": tenant_id})
        d = self.root / safe
        d.mkdir(parents=True, exist_ok=True)
        return d

    def resolve(self, tenant_id: str, relative: str) -> Path:
        base = self.tenant_dir(tenant_id).resolve()
        target = (base / relative).resolve()
        if not str(target).startswith(str(base)):
            raise SecurityError("cross-tenant path access denied",
                                {"tenant": tenant_id, "path": relative})
        return target


ROLES = ("viewer", "analyst", "admin")
ROLE_PERMISSIONS = {
    "viewer": {"predict:read"},
    "analyst": {"predict:read", "predict:write", "train:run"},
    "admin": {"predict:read", "predict:write", "train:run", "tenant:manage"},
}


class TenantAuthenticationManager:
    """API keys (stored hashed) bound to a tenant and a role."""

    def __init__(self):
        self._keys: Dict[str, Dict[str, str]] = {}   # key hash -> {tenant, role}
        self._lock = threading.Lock()

    def issue_key(self, tenant_id: str, role: str = "analyst") -> str:
        if role not in ROLES:
            raise SecurityError("unknown role", {"role": role})
        key = f"dgdm_{secrets.token_urlsafe(24)}"
        with self._lock:
            self._keys[hash_password(key)] = {"tenant": tenant_id, "role": role}
        return key

    def authenticate(self, key: str) -> Dict[str, str]:
        with self._lock:
            for key_hash, info in self._keys.items():
                if verify_password(key, key_hash):
                    return dict(info)
        raise SecurityError("invalid API key")

    def authorize(self, key: str, permission: str) -> Dict[str, str]:
        info = self.authenticate(key)
        if permission not in ROLE_PERMISSIONS[info["role"]]:
            raise SecurityError("permission denied",
                                {"role": info["role"], "permission": permission})
        return info

    def revoke_tenant(self, tenant_id: str) -> int:
        with self._lock:
            before = len(self._keys)
            self._keys = {k: v for k, v in self._keys.items() if v["tenant"] != tenant_id}
            return before - len(self._keys)


class MultiTenantManager:
    """The tenant registry with its quotas, storage and keys."""

    def __init__(self, storage_root="./tenants"):
        self.tenants: Dict[str, Tenant] = {}
        self.resources = TenantResourceManager()
        self.isolation = TenantIsolationManager(storage_root)
        self.auth = TenantAuthenticationManager()

    def create_tenant(self, name: str, quota: Optional[TenantQuota] = None) -> Tenant:
        tid = f"t_{secrets.token_hex(6)}"
        tenant = Tenant(tid, name, quota or TenantQuota())
        self.tenants[tid] = tenant
        self.isolation.tenant_dir(tid)
        logger.info("created tenant %s (%s)", tid, name)
        return tenant

    def deactivate_tenant(self, tenant_id: str) -> None:
        self.tenants[tenant_id].active = False
        self.auth.revoke_tenant(tenant_id)

    def run_job(self, api_key: str, job_fn, *args, **kwargs):
        """``job_fn(*args, **kwargs)`` for an authorized, active tenant
        inside one of its job slots."""
        info = self.auth.authorize(api_key, "train:run")
        tenant = self.tenants[info["tenant"]]
        if not tenant.active:
            raise SecurityError("tenant deactivated", {"tenant": tenant.tenant_id})
        with self.resources.acquire_job_slot(tenant):
            return job_fn(*args, **kwargs)

    def status(self) -> Dict[str, Any]:
        return {tid: {"name": t.name, "active": t.active, "usage": self.resources.usage(tid)}
                for tid, t in self.tenants.items()}
