"""The port's accuracy entry points and weight converter (counterparts of the
repository's ``scripts/``), each run as
``python -m dgdm_histopath_torch.scripts.<name>``: the staged accuracy gates
(``eval_camelyon16``, ``eval_tcga``, ``eval_panda`` over the shared
``gate_harness``), the seed pooling (``aggregate_hard_seeds``), one gate
run held to another seed by seed (``compare_gate_runs``), the TCGA
training driver (``train_tcga``) and the timm DINOv2 converter
(``convert_timm_vit``). They run on the card unless ``--cpu`` is given."""


def resolve(ap, cpu: bool):
    """The run's device: the card unless ``cpu``; no card and no ``--cpu``
    is a usage error of ``ap`` (exit 2)."""
    from ..utils.device import resolve_device
    try:
        return resolve_device("cpu" if cpu else None)
    except RuntimeError as exc:
        ap.error(f"{exc} (--cpu)")
