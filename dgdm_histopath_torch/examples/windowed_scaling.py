"""Windowed scaling configuration: the setup for big buckets.

The whole windowed stack:

  * ``TissueGraphBuilder(spatial_sort=True, knn_window=W)``: nodes in
    Morton order, both kNN searches restricted to the ±1-block band, so
    every edge is one banded compute addresses (exact by construction);
  * ``DGDMModel(spatial_window=W, graph_window=W)``: block-local spatial
    attention + banded message passing (attention and message-passing work
    scale as 3W/N of the dense formulation);
  * ``DGDMPredictor`` deriving the matching graph-build config from the
    model.

The equivalent config-file setup is ``configs/dgdm_large_windowed.yaml``;
the port's times of DGDM-Large (windowed, banded) on the card are in
``PERF.md``::

    python -m dgdm_histopath_torch.examples.windowed_scaling [--cpu]
"""

import torch

from ..evaluation import DGDMPredictor
from ..models import DGDMModel
from ..nn.layers import init_parameters
from ..ops.graph import batch_graphs, in_band_fraction
from ..preprocessing import SlideProcessor, TissueGraphBuilder, synthetic_slide
from ._common import device_from_args

WINDOW = 32  # production Large uses 128 on 2048-node buckets


def main(argv=None):
    device = device_from_args(__doc__.splitlines()[0], argv)
    print("=== windowed scaling configuration ===")
    slide, _ = synthetic_slide(1024, 1024, num_levels=3, seed=0, objective_power=20.0)
    processor = SlideProcessor(patch_size=64, tissue_threshold=0.4, max_patches=200,
                               stain_normalize=False, device=device)
    slide_data = processor.process_slide(slide, slide_id="demo")

    # band-built graph: Morton-sorted, every edge within the ±1-block band
    builder = TissueGraphBuilder(feature_extractor="none", node_buckets=[128, 256],
                                 spatial_sort=True, knn_window=WINDOW, device=device)
    graph = builder.build_graph(slide_data)
    frac = in_band_fraction(graph.nbr_idx, graph.nbr_mask, WINDOW)
    print(f"graph: {int(graph.n_real_nodes)} nodes, in-band edge fraction "
          f"= {frac:.3f} (1.0 -> banded compute is exact)")

    model = DGDMModel(node_features=graph.feature_dim, hidden_dims=(64, 32),
                      num_diffusion_steps=5, attention_heads=4, graph_layers=2,
                      num_classes=2, compute_dtype="float32",
                      spatial_window=WINDOW, graph_window=WINDOW)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    with torch.no_grad():
        logits = model(batch_graphs([graph]), mode="inference")["classification_logits"]
    print(f"windowed forward OK: logits {tuple(logits.shape)}")

    # the predictor derives spatial_sort / knn_window from the model
    predictor = DGDMPredictor(model=model, device=device, patch_size=64, max_patches=200,
                              feature_extractor="none", tissue_threshold=0.4,
                              stain_normalize=False, node_buckets=[128, 256])
    assert predictor.graph_builder.knn_window == WINDOW
    result = predictor.predict_slide(slide, slide_id="demo")
    print(f"prediction: class {result['predicted_class']} "
          f"(confidence {result['confidence']:.2f})")
    predictor.close()
    print("done.")
    return result


if __name__ == "__main__":
    main()
