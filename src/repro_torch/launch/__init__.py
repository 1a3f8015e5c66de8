"""Launchers of the port (counterpart of ``repro.launch``): the mesh
helpers, the sharded train-step builder and the training launcher."""
