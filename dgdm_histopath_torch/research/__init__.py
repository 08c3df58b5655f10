"""Research layer: adversarial robustness, comparative statistics,
experiments, interpretability, multimodal fusion and experimental graph
modules (counterpart of the JAX package's ``research/``)."""

from .adversarial_robustness import (
    ClinicalAdversarialDefense,
    MedicalAdversarialAttack,
    RobustnessAnalyzer,
)
from .comparative_studies import (
    BenchmarkResult,
    BenchmarkSuite,
    ModelComparator,
    StatisticalValidator,
    bootstrap_diff_ci,
    cohens_d,
    paired_t_test,
    wilcoxon_signed_rank,
)
from .experiment_framework import (
    ExperimentConfig,
    ExperimentRunner,
    PublicationPreparer,
    ResultsAnalyzer,
    RunRecord,
)
from .interpretability import (
    ClinicalReportGenerator,
    ClinicalSaliencyAnalyzer,
    PathologyFeatureExtractor,
)
from .multimodal_fusion import (
    AdaptiveModalityEncoder,
    CrossModalAttentionFusion,
    HierarchicalModalityFusion,
    UncertaintyAwareFusion,
    benchmark_fusion_strategies,
)
from .novel_algorithms import (
    AdaptiveGraphTopology,
    HierarchicalAttentionFusion,
    PhaseModulatedGraphDiffusion,
    QuantumGraphDiffusion,
)

__all__ = [
    "MedicalAdversarialAttack", "ClinicalAdversarialDefense", "RobustnessAnalyzer",
    "BenchmarkSuite", "ModelComparator", "StatisticalValidator", "BenchmarkResult",
    "paired_t_test", "wilcoxon_signed_rank", "cohens_d", "bootstrap_diff_ci",
    "ExperimentRunner", "ExperimentConfig", "RunRecord", "ResultsAnalyzer",
    "PublicationPreparer",
    "ClinicalSaliencyAnalyzer", "PathologyFeatureExtractor", "ClinicalReportGenerator",
    "AdaptiveModalityEncoder", "CrossModalAttentionFusion", "UncertaintyAwareFusion",
    "HierarchicalModalityFusion", "benchmark_fusion_strategies",
    "PhaseModulatedGraphDiffusion", "QuantumGraphDiffusion",
    "HierarchicalAttentionFusion", "AdaptiveGraphTopology",
]
