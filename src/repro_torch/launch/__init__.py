"""Command-line launchers of the port (port of ``repro.launch``)."""
