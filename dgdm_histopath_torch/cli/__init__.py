"""Command-line entry points: ``python -m dgdm_histopath_torch.cli.train``
(training, resume, validation), ``python -m dgdm_histopath_torch.cli.predict``
(inference over graphs and slides) and ``python -m
dgdm_histopath_torch.cli.serve`` (the inference server). Each runs on the card
unless given ``--device cpu``."""

__all__ = ["train", "predict", "serve"]
