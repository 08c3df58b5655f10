"""Command-line entry points: ``python -m dgdm_histopath_torch.cli.train``
(training, resume, validation) and ``python -m dgdm_histopath_torch.cli.predict``
(inference over graphs and slides). Both run on the card unless given
``--device cpu``."""

__all__ = ["train", "predict"]
