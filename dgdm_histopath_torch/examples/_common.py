"""The examples' shared command line: the card unless ``--cpu``."""

import argparse

from ..scripts import resolve


def device_from_args(description: str, argv=None):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return resolve(ap, ap.parse_args(argv).cpu)
