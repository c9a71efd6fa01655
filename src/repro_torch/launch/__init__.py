"""Launcher: roofline terms and parameter counts (``roofline``), the
shape-only parameter tree and the train step (``steps``), and the
one-device mesh (``mesh``)."""
