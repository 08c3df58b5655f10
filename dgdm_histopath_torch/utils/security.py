"""Security utilities (counterpart of the JAX package's ``utils/security.py``):
a per-caller rate limiter (the inference server's), input sanitizing, PHI
detection and redaction, PBKDF2 password hashes, HMAC session tokens,
Fernet encryption where the ``cryptography`` package is installed, an
HMAC-checked JSON store, a security audit log and an offline vulnerability
scanner (inputs, file permissions, committed secrets, installed versions
against an in-repo advisory table, configuration hygiene).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import re
import secrets
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .exceptions import SecurityError
from .logging import get_logger

logger = get_logger("security")


class RateLimiter:
    """Token bucket per caller: ``rate`` tokens a second, at most ``burst``
    held; a request takes one token."""

    def __init__(self, rate: float = 10.0, burst: int = 20):
        self.rate = rate
        self.burst = burst
        self._buckets: Dict[str, Tuple[float, float]] = {}
        self._lock = threading.Lock()

    def allow(self, key: str = "default") -> bool:
        now = time.monotonic()
        with self._lock:
            tokens, last = self._buckets.get(key, (float(self.burst), now))
            tokens = min(self.burst, tokens + (now - last) * self.rate)
            if tokens >= 1.0:
                self._buckets[key] = (tokens - 1.0, now)
                return True
            self._buckets[key] = (tokens, now)
            return False

    def check(self, key: str = "default") -> None:
        if not self.allow(key):
            raise SecurityError("rate limit exceeded", {"key": key})


class InputSanitizer:
    """String sanitization against injection patterns."""

    _SQL_PAT = re.compile(r"(;|--|\b(drop|delete|insert|update|union|exec)\b)",
                          re.IGNORECASE)
    _PATH_PAT = re.compile(r"\.\.[/\\]")
    _SHELL_PAT = re.compile(r"[;&|`$<>]")
    _HTML_PAT = re.compile(r"<[^>]*>")

    @classmethod
    def sanitize_string(cls, value: str, max_length: int = 1024) -> str:
        if len(value) > max_length:
            raise SecurityError("input exceeds max length", {"len": len(value)})
        return cls._HTML_PAT.sub("", value)

    @classmethod
    def check_sql_injection(cls, value: str) -> None:
        if cls._SQL_PAT.search(value):
            raise SecurityError("possible SQL injection", {"value": value[:64]})

    @classmethod
    def check_path_traversal(cls, value: str) -> None:
        if cls._PATH_PAT.search(value):
            raise SecurityError("path traversal attempt", {"value": value[:64]})

    @classmethod
    def check_shell_injection(cls, value: str) -> None:
        if cls._SHELL_PAT.search(value):
            raise SecurityError("possible shell injection", {"value": value[:64]})

    @classmethod
    def sanitize_filename(cls, name: str) -> str:
        cleaned = re.sub(r"[^A-Za-z0-9._\-]", "_", name)
        if not cleaned or cleaned.startswith("."):
            raise SecurityError("invalid filename", {"name": name})
        return cleaned[:255]

    @classmethod
    def sanitize_identifier(cls, name: str) -> str:
        """Usernames / job names: alnum plus ``-_.``, must start alnum."""
        cleaned = re.sub(r"[^A-Za-z0-9._\-]", "_", str(name))
        if not cleaned or not cleaned[0].isalnum():
            raise SecurityError("invalid identifier", {"name": str(name)[:64]})
        return cleaned[:64]


class PHIDetector:
    """Heuristic protected-health-information detector."""

    PATTERNS = {
        "ssn": re.compile(r"\b\d{3}-\d{2}-\d{4}\b"),
        "mrn": re.compile(r"\b(mrn|medical record)[:#\s]*\d{6,10}\b", re.IGNORECASE),
        "phone": re.compile(r"\b(\+?1[-.\s]?)?\(?\d{3}\)?[-.\s]\d{3}[-.\s]\d{4}\b"),
        "email": re.compile(r"\b[\w.+-]+@[\w-]+\.[\w.]+\b"),
        "date_of_birth": re.compile(r"\b(dob|date of birth)[:\s]*\d{1,2}[/-]\d{1,2}[/-]\d{2,4}\b",
                                    re.IGNORECASE),
    }

    @classmethod
    def scan(cls, text: str) -> List[Dict[str, str]]:
        findings = []
        for kind, pat in cls.PATTERNS.items():
            for m in pat.finditer(text):
                findings.append({"type": kind, "match": m.group(0)[:32],
                                 "position": m.start()})
        return findings

    @classmethod
    def redact(cls, text: str) -> str:
        for pat in cls.PATTERNS.values():
            text = pat.sub("[REDACTED]", text)
        return text

    @classmethod
    def contains_phi(cls, text: str) -> bool:
        return bool(cls.scan(text))


def hash_password(password: str, salt: Optional[bytes] = None,
                  iterations: int = 200_000) -> str:
    """PBKDF2-HMAC-SHA256 password hash: ``pbkdf2$<iterations>$<salt hex>$<key hex>``."""
    salt = salt or secrets.token_bytes(16)
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iterations)
    return f"pbkdf2${iterations}${salt.hex()}${dk.hex()}"


def verify_password(password: str, stored: str) -> bool:
    try:
        _, iters, salt_hex, dk_hex = stored.split("$")
        dk = hashlib.pbkdf2_hmac("sha256", password.encode(),
                                 bytes.fromhex(salt_hex), int(iters))
        return hmac.compare_digest(dk.hex(), dk_hex)
    except (ValueError, TypeError):
        return False


class SessionTokenManager:
    """HMAC-signed expiring session tokens."""

    def __init__(self, secret: Optional[bytes] = None, ttl_s: float = 3600.0):
        self._secret = secret or secrets.token_bytes(32)
        self.ttl_s = ttl_s

    def issue(self, subject: str) -> str:
        payload = f"{subject}|{time.time() + self.ttl_s:.0f}|{secrets.token_hex(8)}"
        sig = hmac.new(self._secret, payload.encode(), hashlib.sha256).hexdigest()
        return f"{payload}|{sig}"

    def verify(self, token: str) -> str:
        try:
            payload, sig = token.rsplit("|", 1)
            expect = hmac.new(self._secret, payload.encode(), hashlib.sha256).hexdigest()
            if not hmac.compare_digest(sig, expect):
                raise SecurityError("invalid token signature")
            subject, expiry, _ = payload.split("|")
            if time.time() > float(expiry):
                raise SecurityError("token expired")
            return subject
        except (ValueError, IndexError) as exc:
            raise SecurityError("malformed token") from exc


class DataEncryption:
    """Fernet encryption from the ``cryptography`` package; without the
    package it raises ``SecurityError``."""

    def __init__(self, key: Optional[bytes] = None):
        try:
            from cryptography.fernet import Fernet
        except ImportError as exc:  # pragma: no cover
            raise SecurityError("cryptography package not installed") from exc
        self._fernet = Fernet(key or Fernet.generate_key())

    def encrypt(self, data: bytes) -> bytes:
        return self._fernet.encrypt(data)

    def decrypt(self, data: bytes) -> bytes:
        return self._fernet.decrypt(data)


class SecureStorage:
    """Integrity-protected JSON store: HMAC over content."""

    def __init__(self, directory: str | Path, secret: Optional[bytes] = None):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._secret = secret or secrets.token_bytes(32)

    def _path(self, key: str) -> Path:
        return self.directory / f"{InputSanitizer.sanitize_filename(key)}.json"

    def put(self, key: str, value: dict) -> None:
        blob = json.dumps(value, sort_keys=True)
        sig = hmac.new(self._secret, blob.encode(), hashlib.sha256).hexdigest()
        self._path(key).write_text(json.dumps({"data": blob, "sig": sig}))

    def get(self, key: str) -> dict:
        raw = json.loads(self._path(key).read_text())
        expect = hmac.new(self._secret, raw["data"].encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(raw["sig"], expect):
            raise SecurityError("storage integrity check failed", {"key": key})
        return json.loads(raw["data"])


class SecurityAuditor:
    """Rolling audit log of security events (details PHI-redacted)."""

    def __init__(self, max_events: int = 10_000):
        self.events: List[dict] = []
        self.max_events = max_events
        self._lock = threading.Lock()

    def record(self, kind: str, detail: str = "", severity: str = "info") -> None:
        with self._lock:
            self.events.append({"ts": time.time(), "kind": kind,
                                "detail": PHIDetector.redact(detail)[:256],
                                "severity": severity})
            if len(self.events) > self.max_events:
                self.events = self.events[-self.max_events:]

    def summary(self) -> Dict[str, int]:
        from collections import Counter
        with self._lock:
            return dict(Counter(e["kind"] for e in self.events))


GLOBAL_AUDITOR = SecurityAuditor()


class VulnerabilityScanner:
    """Offline vulnerability scanner: inputs, file permissions, secrets,
    dependencies, and config hygiene. It needs no network: the advisory
    table ships in the package and is small."""

    VULN_PATTERNS: Dict[str, List[str]] = {
        "sql_injection": [r"'\s*or\s*'1'\s*=\s*'1", r"'\s*;\s*drop\s+table",
                          r"union\s+select"],
        "command_injection": [r";\s*rm\s+-rf", r"\|\s*cat\s+/etc/passwd",
                              r"&&\s*curl", r"\$\(.*\)"],
        "path_traversal": [r"\.\./.*\.\./", r"/etc/passwd",
                           r"/proc/self/environ"],
        "code_injection": [r"__import__\s*\(", r"\bexec\s*\(",
                           r"\beval\s*\(", r"pickle\.loads\s*\("],
    }

    # secrets-in-files sweep (scan_tree)
    SECRET_PATTERNS: Dict[str, str] = {
        "private_key": r"-----BEGIN (?:RSA |EC |OPENSSH )?PRIVATE KEY-----",
        "aws_access_key": r"\bAKIA[0-9A-Z]{16}\b",
        "generic_api_key": r"(?i)\b(?:api[_-]?key|secret[_-]?key|auth[_-]?"
                           r"token)\b\s*[:=]\s*['\"][A-Za-z0-9_\-/+]{16,}['\"]",
        "password_literal": r"(?i)\bpassword\s*[:=]\s*['\"][^'\"]{4,}['\"]",
    }

    # minimal offline advisory table: package -> (max_vulnerable_version,
    # advisory). Checked against importlib.metadata at scan time.
    KNOWN_ADVISORIES: Dict[str, Tuple[str, str]] = {
        "pyyaml": ("5.3.1", "CVE-2020-14343 unsafe load RCE"),
        "pillow": ("9.0.0", "CVE-2022-22817 eval in ImageMath"),
        "requests": ("2.31.0", "CVE-2023-32681 Proxy-Authorization leak"),
        "urllib3": ("1.26.17", "CVE-2023-43804 cookie header leak"),
        "cryptography": ("41.0.0", "multiple OpenSSL advisories"),
    }

    INSECURE_CONFIG_RULES = (
        ("debug", lambda v: v in (True, "true", "True", "1"),
         "debug mode enabled in deployment config"),
        ("host", lambda v: v == "0.0.0.0",
         "service binds all interfaces; restrict or front with a proxy"),
        ("ssl", lambda v: v in (False, "false", "False", "0"),
         "TLS disabled"),
        ("verify", lambda v: v in (False, "false", "False", "0"),
         "certificate verification disabled"),
    )

    def __init__(self):
        self._compiled = {
            kind: [re.compile(p, re.IGNORECASE) for p in pats]
            for kind, pats in self.VULN_PATTERNS.items()}
        self._secret_res = {k: re.compile(p)
                            for k, p in self.SECRET_PATTERNS.items()}

    # -- inputs and permissions -------------------------------------------
    def scan_input(self, input_data: str) -> Dict:
        """Pattern-scan one untrusted string."""
        vulnerabilities = []
        for kind, pats in self._compiled.items():
            for pat in pats:
                if pat.search(input_data):
                    vulnerabilities.append({"type": kind,
                                            "pattern": pat.pattern,
                                            "severity": "high"})
        return {"vulnerabilities": vulnerabilities,
                "risk_score": min(10 * len(vulnerabilities), 100),
                "safe": not vulnerabilities}

    def scan_file_permissions(self, directory: Path | str) -> Dict:
        """World-writable files + world-readable secrets."""
        issues = []
        sensitive = ("key", "secret", "password", "token", "private")
        for p in Path(directory).rglob("*"):
            try:
                if not p.is_file():
                    continue
                mode = p.stat().st_mode
            except OSError:
                continue
            if mode & 0o002:
                issues.append({"file": str(p), "issue": "world_writable",
                               "severity": "high",
                               "permissions": oct(mode)[-3:]})
            if mode & 0o004 and any(s in p.name.lower() for s in sensitive):
                issues.append({"file": str(p),
                               "issue": "sensitive_world_readable",
                               "severity": "medium",
                               "permissions": oct(mode)[-3:]})
        return {"issues_found": len(issues), "issues": issues}

    # -- dependencies, configuration, committed secrets ------------------
    def scan_dependencies(self) -> Dict:
        """Compare installed package versions against the in-repo advisory
        table (zero-egress CVE check)."""
        from importlib import metadata

        def parse(v: str) -> tuple:
            return tuple(int(x) for x in re.findall(r"\d+", v)[:3] or [0])

        findings = []
        for pkg, (max_vuln, advisory) in self.KNOWN_ADVISORIES.items():
            try:
                installed = metadata.version(pkg)
            except metadata.PackageNotFoundError:
                continue
            if parse(installed) <= parse(max_vuln):
                findings.append({"package": pkg, "installed": installed,
                                 "fixed_after": max_vuln,
                                 "advisory": advisory, "severity": "high"})
        return {"issues_found": len(findings), "issues": findings}

    def scan_config(self, config: Dict) -> Dict:
        """Flag insecure configuration values (flattened dotted keys)."""
        issues = []

        def walk(d: Dict, prefix: str = ""):
            for k, v in d.items():
                dotted = f"{prefix}{k}"
                if isinstance(v, dict):
                    walk(v, dotted + ".")
                    continue
                for rule_key, bad, msg in self.INSECURE_CONFIG_RULES:
                    if k.lower().endswith(rule_key) and bad(v):
                        issues.append({"key": dotted, "value": str(v)[:64],
                                       "issue": msg, "severity": "medium"})
                if isinstance(v, str) and re.search(
                        r"(?i)(secret|token|password|key)$", k) and v:
                    issues.append({"key": dotted, "value": "<redacted>",
                                   "issue": "secret stored in plain config; "
                                            "use SecureStorage or env",
                                   "severity": "medium"})

        walk(config or {})
        return {"issues_found": len(issues), "issues": issues}

    def scan_tree(self, directory: Path | str,
                  max_bytes: int = 262_144,
                  suffixes: Tuple[str, ...] = (".py", ".yaml", ".yml",
                                               ".json", ".toml", ".cfg",
                                               ".ini", ".env", ".sh")) -> Dict:
        """Sweep a source/config tree for committed secrets."""
        findings = []
        for p in Path(directory).rglob("*"):
            if not p.is_file() or p.suffix.lower() not in suffixes:
                continue
            try:
                text = p.read_text(errors="ignore")[:max_bytes]
            except OSError:
                continue
            for kind, pat in self._secret_res.items():
                for m in pat.finditer(text):
                    findings.append({
                        "file": str(p), "type": kind, "severity": "high",
                        "line": text.count("\n", 0, m.start()) + 1})
        return {"issues_found": len(findings), "issues": findings}

    def full_scan(self, directory: Path | str,
                  config: Optional[Dict] = None) -> Dict:
        """Aggregate report across all scan families."""
        report = {
            "file_permissions": self.scan_file_permissions(directory),
            "secrets": self.scan_tree(directory),
            "dependencies": self.scan_dependencies(),
            "config": self.scan_config(config or {}),
        }
        report["issues_found"] = sum(r["issues_found"]
                                     for r in report.values()
                                     if isinstance(r, dict))
        report["safe"] = report["issues_found"] == 0
        GLOBAL_AUDITOR.record("vulnerability_scan",
                              f"issues={report['issues_found']}",
                              "warning" if report["issues_found"] else "info")
        return report
