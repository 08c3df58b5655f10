"""PyTorch/CUDA port of DGDM: graph-level inference and two-phase training
on an NVIDIA GPU.

The JAX package ``dgdm_histopath_tpu`` is the reference this port is tested
against; this package imports neither it nor JAX. Its neighbor-gather hot
loops, forward and backward, are hand-written CUDA kernels (``csrc/``) built
with nvcc at first use.

Entry points run on the card unless the caller passes ``device="cpu"``:

    from dgdm_histopath_torch import create_model, DGDMPredictor
    model = create_model("dgdm-base", num_classes=2)        # on "cuda"
    predictor = DGDMPredictor(model=model)
    trainer = DGDMTrainer(model, TrainerConfig(pretrain_epochs=1))
    trainer.init_state(seed=0)
    metrics = trainer.training_step(batch, epoch=0)         # batch: PaddedGraph
"""

from .evaluation.predictor import DGDMPredictor, load_model_checkpoint
from .models.dgdm import DGDMModel
from .models.presets import PRESETS, create_model
from .ops.graph import PaddedGraph, batch_graphs, build_padded_graph
from .training.trainer import DGDMTrainer, TrainerConfig

__version__ = "0.1.0"

__all__ = [
    "DGDMModel", "DGDMPredictor", "DGDMTrainer", "PRESETS", "PaddedGraph",
    "TrainerConfig", "batch_graphs", "build_padded_graph", "create_model",
    "load_model_checkpoint",
]
