"""Launcher: roofline terms and parameter counts (``roofline``), and the
shape-only parameter tree (``steps.params_sds``)."""
