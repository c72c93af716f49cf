"""Command-line drivers of the port (mirrors ``repro.launch``)."""
