"""In-package self-testing: quality gates, their cache and parallel runner,
and the autonomous test runner (the JAX package's ``testing`` exports)."""

from .autonomous import AutonomousTestRunner, DGDMTestSuite
from .quality_gates import GATES, LEVEL_REQUIREMENTS, QualityGateRunner
from .scalable_gates import GateResultCache, ScalableQualityGateRunner, package_fingerprint

__all__ = ["QualityGateRunner", "GATES", "LEVEL_REQUIREMENTS",
           "GateResultCache", "ScalableQualityGateRunner",
           "package_fingerprint",
           "AutonomousTestRunner", "DGDMTestSuite"]
