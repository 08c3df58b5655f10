"""Basic usage: synthetic slide -> graph -> model -> prediction.

A dependency-free demo on synthetic data that runs end to end without any
external file::

    python -m dgdm_histopath_torch.examples.basic_usage [--cpu]
"""

import torch

from ..evaluation import DGDMPredictor
from ..models import DGDMModel
from ..nn.layers import init_parameters
from ..preprocessing import SlideProcessor, TissueGraphBuilder, synthetic_slide
from ._common import device_from_args


def main(argv=None):
    device = device_from_args(__doc__.splitlines()[0], argv)
    print("=== DGDM Histopath (PyTorch) — basic usage ===")
    print(f"device: {device}")

    # 1. synthetic whole-slide image (no external data needed)
    slide, _ = synthetic_slide(1024, 1024, num_levels=3, seed=0, objective_power=20.0)
    print("created synthetic 1024x1024 H&E pyramid")

    # 2. preprocess: tissue detection + tiling (stain normalization off for speed here)
    processor = SlideProcessor(patch_size=64, tissue_threshold=0.4, max_patches=100,
                               stain_normalize=False, device=device)
    slide_data = processor.process_slide(slide, slide_id="demo")
    print(f"extracted {slide_data.num_patches} tissue patches "
          f"(tissue fraction {slide_data.metadata['tissue_fraction']:.2f})")

    # 3. build the tissue graph (placeholder features keep the demo light;
    #    feature_extractor='dinov2' takes the ViT path)
    builder = TissueGraphBuilder(feature_extractor="none", node_buckets=[128, 256],
                                 device=device)
    graph = builder.build_graph(slide_data)
    print(f"graph: {int(graph.n_real_nodes)} nodes in a {graph.num_nodes}-node "
          f"bucket, {graph.max_neighbors} neighbor slots")

    # 4. a small DGDM model, parameters drawn from a seed
    model = DGDMModel(node_features=graph.feature_dim, hidden_dims=(64, 32),
                      num_diffusion_steps=5, attention_heads=4, graph_layers=2,
                      num_classes=2, compute_dtype="float32")
    init_parameters(model, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e3:.1f}k parameters")

    # 5. end-to-end prediction through the predictor
    predictor = DGDMPredictor(model=model, device=device, patch_size=64, max_patches=100,
                              feature_extractor="none", tissue_threshold=0.4,
                              stain_normalize=False, node_buckets=[128, 256])
    result = predictor.predict_slide(slide, slide_id="demo")
    print(f"prediction: class {result['predicted_class']} "
          f"(confidence {result['confidence']:.2f}, "
          f"entropy {result['uncertainty']['entropy']:.3f})")
    print(f"top biomarker region: {result['biomarkers'][0]['position']}")
    predictor.close()
    print("done.")
    return result


if __name__ == "__main__":
    main()
