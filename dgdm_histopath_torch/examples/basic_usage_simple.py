"""Dependency-light demo: synthetic graphs only (no slides).

Synthetic 50-node x 768-d graphs through DGDM-Base: three self-supervised
pretrain steps, three finetune steps and a prediction::

    python -m dgdm_histopath_torch.examples.basic_usage_simple [--cpu]
"""

import numpy as np
import torch

from ..models import create_model
from ..ops.graph import PaddedGraph, batch_graphs
from ..ops.knn import knn_euclidean
from ..training import DGDMTrainer, TrainerConfig
from ._common import device_from_args


def synthetic_graph(seed: int, n_nodes: int = 64, n_real: int = 50,
                    feat_dim: int = 768) -> PaddedGraph:
    """Synthetic tissue graph: random 768-d features + spatial kNN edges."""
    rs = np.random.RandomState(seed)
    x = np.zeros((n_nodes, feat_dim), np.float32)
    x[:n_real] = rs.randn(n_real, feat_dim)
    pos = np.zeros((n_nodes, 2), np.float32)
    pos[:n_real] = rs.rand(n_real, 2)
    mask = np.zeros((n_nodes,), bool)
    mask[:n_real] = True
    pos_t, mask_t = torch.from_numpy(pos), torch.from_numpy(mask)
    idx, dist, valid = knn_euclidean(pos_t, mask_t, 8)
    return PaddedGraph(
        x=torch.from_numpy(x), pos=pos_t, nbr_idx=idx, nbr_mask=valid,
        edge_attr=torch.stack([dist, torch.exp(-10 * dist), torch.zeros_like(dist)], -1),
        node_mask=mask_t, y=torch.tensor(seed % 2, dtype=torch.int32))


def main(argv=None):
    device = device_from_args(__doc__.splitlines()[0], argv)
    print("=== DGDM Histopath (PyTorch) — synthetic-graph demo ===")
    batch = batch_graphs([synthetic_graph(i) for i in range(4)])
    print(f"batch: {batch.x.shape[0]} graphs × {batch.num_nodes} nodes "
          f"({int(batch.n_real_nodes[0])} real) × {batch.feature_dim} features")

    model = create_model("dgdm-base", num_classes=2, device=device)
    trainer = DGDMTrainer(model, TrainerConfig(
        learning_rate=1e-4, warmup_steps=10, pretrain_epochs=1, steps_per_epoch=5),
        device=device)
    trainer.init_state(0, batch)

    print("-- self-supervised pretrain steps (diffusion + contrastive) --")
    for step in range(3):
        m = trainer.training_step(batch, epoch=0)
        print(f"  step {step}: loss={float(m['loss']):.4f} "
              f"(diffusion={float(m['diffusion_loss']):.4f})")

    print("-- supervised finetune steps (classification) --")
    for step in range(3):
        m = trainer.training_step(batch, epoch=1)
        print(f"  step {step}: loss={float(m['loss']):.4f} acc={float(m['accuracy']):.2f}")

    out = trainer.predict_step(batch)
    probs = torch.softmax(out["classification_logits"].float(), -1)
    print("predictions:", probs.argmax(-1).cpu().numpy())
    print("attention over nodes available:", "attention_weights" in out)
    print("done.")
    return out


if __name__ == "__main__":
    main()
