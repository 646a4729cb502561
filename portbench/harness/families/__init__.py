"""One module per kind of traffic (a cell's ``family``): each makes the
cell's inputs from the seed, builds its path through the program's entry
points, warms it up, runs the measured window and follows the check's steps
with the reference. A cell names its family in its traffic file; a new
cell of a family is a new data file."""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"portbench.harness.families.{name}").Family


def import_program(name: str) -> None:
    """Import the program's modules the family ``name`` drives."""
    importlib.import_module(f"portbench.harness.families.{name}").import_program()
