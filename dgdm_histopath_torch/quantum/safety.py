"""Authentication, lockout, rate limit and audit in front of the scheduler
(counterpart of the JAX package's ``quantum/safety.py``).

``QuantumSafetyManager`` holds users (PBKDF2 hashes from
``utils.security.hash_password``), locks an account for ``lockout_seconds``
after ``max_failed_attempts`` failures, issues session tokens and records
every decision with a ``SecurityAuditor``. ``SafeScheduler`` puts it in
front of a ``QuantumScheduler``: every ``submit`` and ``run_pending`` needs a
valid token, and a CRITICAL job needs the admin role.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from ..utils.exceptions import SecurityError
from ..utils.logging import get_logger
from ..utils.security import (
    InputSanitizer,
    RateLimiter,
    SecurityAuditor,
    SessionTokenManager,
    hash_password,
    verify_password,
)
from .planner import TaskPriority
from .scheduler import QuantumScheduler

logger = get_logger("quantum.safety")


@dataclass
class UserRecord:
    username: str
    password_hash: str
    role: str = "user"            # user | admin
    failed_attempts: int = 0
    locked_until: float = 0.0
    created: float = field(default_factory=time.time)


class QuantumSafetyManager:
    """Users, sessions, lockout, a submission rate limit and the audit trail."""

    def __init__(self, max_failed_attempts: int = 5, lockout_seconds: float = 300.0,
                 session_ttl_s: float = 3600.0, submissions_per_minute: int = 120,
                 auditor: Optional[SecurityAuditor] = None):
        self.max_failed_attempts = max_failed_attempts
        self.lockout_seconds = lockout_seconds
        self._users: Dict[str, UserRecord] = {}
        self._tokens = SessionTokenManager(ttl_s=session_ttl_s)
        # a sustained burst of submissions_per_minute empties the bucket in a minute
        self._rate = RateLimiter(rate=submissions_per_minute / 60.0,
                                 burst=submissions_per_minute)
        self.auditor = auditor or SecurityAuditor()
        self._lock = threading.RLock()

    def register_user(self, username: str, password: str, role: str = "user") -> None:
        username = InputSanitizer.sanitize_identifier(username)
        if role not in ("user", "admin"):
            raise SecurityError("role must be user|admin", {"role": role})
        if len(password) < 8:
            raise SecurityError("password too short (min 8 chars)")
        with self._lock:
            if username in self._users:
                raise SecurityError("user already exists", {"user": username})
            self._users[username] = UserRecord(username, hash_password(password), role=role)
        self.auditor.record("user_registered", username)

    def authenticate(self, username: str, password: str) -> str:
        """Credentials -> a session token; ``max_failed_attempts`` failures
        in a row lock the account for ``lockout_seconds``."""
        with self._lock:
            rec = self._users.get(username)
            now = time.time()
            if rec is None:
                self.auditor.record("auth_failed", f"unknown user {username}",
                                    severity="warning")
                raise SecurityError("authentication failed")
            if now < rec.locked_until:
                self.auditor.record("auth_locked", username, severity="warning")
                raise SecurityError("account locked",
                                    {"retry_in_s": round(rec.locked_until - now, 1)})
            if not verify_password(password, rec.password_hash):
                rec.failed_attempts += 1
                if rec.failed_attempts >= self.max_failed_attempts:
                    rec.locked_until = now + self.lockout_seconds
                    rec.failed_attempts = 0
                    self.auditor.record("account_lockout", username, severity="critical")
                else:
                    self.auditor.record("auth_failed", username, severity="warning")
                raise SecurityError("authentication failed")
            rec.failed_attempts = 0
        token = self._tokens.issue(username)
        self.auditor.record("auth_success", username)
        return token

    def verify_session(self, token: str) -> str:
        """Token -> username; raises on an invalid or expired token."""
        try:
            username = self._tokens.verify(token)
        except SecurityError:
            self.auditor.record("invalid_token", severity="warning")
            raise
        with self._lock:
            if username not in self._users:
                raise SecurityError("unknown session subject")
        return username

    def role_of(self, username: str) -> str:
        with self._lock:
            rec = self._users.get(username)
        if rec is None:
            raise SecurityError("unknown user", {"user": username})
        return rec.role

    def authorize_submission(self, token: str, job_name: str,
                             priority: TaskPriority | str = TaskPriority.MEDIUM) -> str:
        """Session, rate limit and privilege (CRITICAL needs admin) -> the
        username."""
        username = self.verify_session(token)
        if not self._rate.allow(username):
            self.auditor.record("rate_limited", username, severity="warning")
            raise SecurityError("submission rate limit exceeded", {"user": username})
        if isinstance(priority, str):
            priority = TaskPriority[priority.upper()]
        if priority == TaskPriority.CRITICAL and self.role_of(username) != "admin":
            self.auditor.record("privilege_denied", f"{username}:{job_name}",
                                severity="warning")
            raise SecurityError("CRITICAL priority requires admin role")
        self.auditor.record("job_authorized", f"{username}:{job_name}")
        return username

    def audit_summary(self) -> Dict[str, int]:
        return self.auditor.summary()


class SafeScheduler:
    """A ``QuantumScheduler`` whose ``submit`` and ``run_pending`` take a
    session token; every other attribute reads through to the scheduler."""

    def __init__(self, scheduler: Optional[QuantumScheduler] = None,
                 safety: Optional[QuantumSafetyManager] = None, **sched_kwargs):
        self.scheduler = scheduler or QuantumScheduler(**sched_kwargs)
        self.safety = safety or QuantumSafetyManager()

    def submit(self, token: str, name: str, fn: Callable, *args,
               priority: TaskPriority | str = TaskPriority.MEDIUM, **kwargs) -> str:
        user = self.safety.authorize_submission(token, name, priority)
        name = InputSanitizer.sanitize_identifier(name)
        jid = self.scheduler.submit(name, fn, *args, priority=priority, **kwargs)
        logger.info("job %s (%s) submitted by %s", jid, name, user)
        return jid

    def run_pending(self, token: str, timeout: Optional[float] = None) -> Dict[str, Any]:
        user = self.safety.verify_session(token)
        self.safety.auditor.record("run_pending", user)
        return self.scheduler.run_pending(timeout=timeout)

    def __getattr__(self, item):
        if item in ("submit", "run_pending"):
            raise AttributeError(item)
        return getattr(self.scheduler, item)
