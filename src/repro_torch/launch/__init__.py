"""Launchers of the port (counterpart of ``repro.launch``); only the
training launcher is ported so far."""
