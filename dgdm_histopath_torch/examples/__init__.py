"""Runnable demos of the port (counterparts of the repository's
``examples/``), each run as ``python -m dgdm_histopath_torch.examples.<name>``
on the card, or with ``--cpu`` on the CPU."""
