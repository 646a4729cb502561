"""The benchmark's tests run from any directory: the repository's root goes
on the import path, so ``portbench`` and the program import as a run
imports them."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
