"""Multi-tenant serving (counterpart of the JAX package's ``enterprise/``)."""

from .multi_tenant import (
    ROLE_PERMISSIONS,
    ROLES,
    JobSlot,
    MultiTenantManager,
    Tenant,
    TenantAuthenticationManager,
    TenantIsolationManager,
    TenantQuota,
    TenantResourceManager,
)

__all__ = [
    "Tenant", "TenantQuota", "TenantResourceManager", "TenantIsolationManager",
    "TenantAuthenticationManager", "MultiTenantManager", "ROLES", "ROLE_PERMISSIONS",
    "JobSlot",
]
