"""The benchmark's plain reference: float32 PyTorch and NumPy only.

Nothing here imports the program (``grl_torch``), JAX or ``grl_tpu``. The
modules are frozen copies of what the benchmark needs to make its inputs
(the SBM graph, the sumi-style pages) and to work out again, from those
inputs and the run's seed, everything the program derives: the node order,
the DropEdge and dropout masks, the forward pass, the loss, the clip and
Adam.
"""
