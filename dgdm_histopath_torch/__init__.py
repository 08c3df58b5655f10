"""PyTorch/CUDA port of DGDM: whole-slide and graph-level inference and
two-phase training on an NVIDIA GPU.

The JAX package ``dgdm_histopath_tpu`` is the reference this port is tested
against; this package imports neither it nor JAX. Its neighbor-gather hot
loops, forward and backward, are hand-written CUDA kernels (``csrc/``) built
with nvcc at first use.

Entry points run on the card unless the caller passes ``device="cpu"``:

    from dgdm_histopath_torch import create_model, DGDMPredictor
    model = create_model("dgdm-base", num_classes=2)        # on "cuda"
    predictor = DGDMPredictor(model=model)
    result = predictor.predict_slide("slide.svs")            # or predict_graph(graph)
    trainer = DGDMTrainer(model, TrainerConfig(pretrain_epochs=1))
    trainer.init_state(seed=0)
    metrics = trainer.training_step(batch, epoch=0)         # batch: PaddedGraph
"""

from .data import HistopathDataModule, HistopathDataset, SlideDataset
from .evaluation import AttentionVisualizer, DGDMPredictor, load_model_checkpoint
from .models.dgdm import DGDMModel
from .models.presets import PRESETS, create_model
from .ops.graph import PaddedGraph, batch_graphs, build_padded_graph, from_edge_index
from .preprocessing.slide_processor import SlideProcessor
from .preprocessing.stain_normalization import StainNormalizer
from .preprocessing.tissue_detection import TissueDetector
from .preprocessing.tissue_graph_builder import TissueGraphBuilder
from .training.trainer import DGDMTrainer, TrainerConfig
from .utils.logging import get_logger, setup_logging

__version__ = "0.1.0"

__all__ = [
    "AttentionVisualizer", "DGDMModel", "DGDMPredictor", "DGDMTrainer",
    "HistopathDataModule", "HistopathDataset", "PRESETS", "PaddedGraph", "SlideDataset",
    "SlideProcessor", "StainNormalizer", "TissueDetector", "TissueGraphBuilder",
    "TrainerConfig", "batch_graphs", "build_padded_graph", "create_model",
    "from_edge_index", "get_logger", "load_model_checkpoint", "setup_logging",
]
